"""GatedDeltaNet primitives (counterpart of ``llm_quest_tpu/ops/gdn.py``).

- ``compute_alpha_factor``: α = exp(−exp(log_A)·softplus(a + dt_bias)), fp32.
- ``gated_delta_rule``: per-timestep fp32 recurrence
      S_t = α_t·S_{t−1} + β_t·(v_t − α_t·S_{t−1}k_t) k_tᵀ,  o_t = S_t q_t
  with state S: (b, heads, v_dim, qk_dim) and q scaled by qk_dim^-0.5.
- ``gated_delta_rule_chunked``: the exact chunked-parallel form of the same
  recurrence (derivation in the JAX module). A triangular solve replaces the
  JAX package's Newton–Schulz inverse, which exists only because XLA's
  TriangularSolve is slow on a TPU.
- depthwise causal conv1d with a rolling (b, kernel_size-1, c) state, oldest
  tap first.

Speculative windows over a hybrid cache (inference/spec_decoding.py): a
model's GDN layers read two optional cache leaves. Under ``WINDOW`` each
layer records the state inputs of every call (``window_recorder``), and a
multi-token call leaves the layer's state and taps as they were;
``roll_window`` then advances them from the state before the window over
each row's committed tokens only. ``STATE_MASK`` narrows the mask of the
tokens a call takes into the state (an admission leaves out the token the
first window re-feeds).

The chunked form and the step are the plain versions of the CUDA kernels
(kernels/gdn.py); the ``*_auto`` / ``*_dispatch`` functions route to them:
the prefill (K1), the stacked decode step (K2) and the single-layer decode
step (K3, ``gated_delta_rule_step_auto``). The context-parallel (LASP) form
is not ported: ``gated_delta_rule_dispatch`` refuses ``cfg["context_parallel"]``.
``cfg["use_gdn_kernel"] = False`` (JAX's switch) takes those plain versions,
the counterparts of JAX's XLA forms, as ``cfg["use_kernels"] = False`` does.
"""

import torch
import torch.nn.functional as F


def l2_norm_clamp(x):
    """x / max(‖x‖₂, 1e-6), in fp32, cast back."""
    x32 = x.float()
    return (x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True).clamp_min(1e-6)).to(x.dtype)


def compute_alpha_factor(log_A, a, dt_bias):
    """α ∈ (0, 1), fp32. log_A/dt_bias: (num_v_heads,); a: (b, s, num_v_heads)."""
    return torch.exp(-torch.exp(log_A.float()) * F.softplus(a.float() + dt_bias.float()))


def gated_delta_rule(q, k, v, beta, alpha, prev_state=None):
    """Recurrent gated delta rule over a sequence (fp32).

    q/k: (b, h, s, dk) heads already repeated to v's; v: (b, h, s, dv);
    beta/alpha: (b, h, s); prev_state: (b, h, dv, dk) or None (zeros).
    Returns (out (b, h, s, dv) in q's dtype, final_state fp32).
    """
    b, h, s, dk = k.shape
    state = _zero_state(q, k, v) if prev_state is None else prev_state.float()
    outs = []
    for t in range(s):
        o_t, state = gated_delta_rule_step(q[:, :, t], k[:, :, t], v[:, :, t], beta[:, :, t], alpha[:, :, t], state)
        outs.append(o_t)
    return torch.stack(outs, dim=2), state


def gated_delta_rule_step(q_t, k_t, v_t, beta_t, alpha_t, state):
    """Single decode step. q_t/k_t: (b, h, dk); v_t: (b, h, dv);
    beta_t/alpha_t: (b, h); state: (b, h, dv, dk) fp32.
    Returns (out (b, h, dv) in q's dtype, new_state)."""
    dk = k_t.shape[-1]
    q32 = q_t.float() * dk**-0.5
    k32 = k_t.float()
    gated = alpha_t.float()[..., None, None] * state
    v_old = torch.einsum("bhvk,bhk->bhv", gated, k32)
    delta = beta_t.float()[..., None] * (v_t.float() - v_old)
    state = gated + delta[..., :, None] * k32[..., None, :]
    out = torch.einsum("bhvk,bhk->bhv", state, q32)
    return out.to(q_t.dtype), state


def gated_delta_rule_step_auto(cfg, q_t, k_t, v_t, beta_t, alpha_t, state):
    """Decode step on a SINGLE layer's (b, h, dv, dk) state, updated IN
    PLACE: the step kernel (kernels/gdn.py, K3) unless
    ``cfg["use_gdn_kernel"]`` is False. q_t/k_t at h_qk heads (h % h_qk ==
    0) or already repeated to h. Models with a stacked per-layer cache call
    ``gated_delta_rule_step_stacked_auto``. Returns (out (b, h, dv), state)."""
    from llm_quest_tpu_torch.kernels.gdn import gated_delta_rule_step

    return gated_delta_rule_step(q_t, k_t, v_t, beta_t, alpha_t, state, plain=not _use_gdn_kernel(cfg))


def gated_delta_rule_step_stacked_auto(cfg, q_t, k_t, v_t, beta_t, alpha_t, stacked, layer):
    """Decode step on the stacked (L, b, h, dv, dk) recurrent cache, updated
    IN PLACE at ``layer``: the step kernel (kernels/gdn.py, K2) at every
    batch size (the JAX package's b·h > 16 gate was a TPU measurement). q_t/k_t
    at h_qk heads (h % h_qk == 0; the models pass them unrepeated) or already
    repeated to h. Returns (out (b, h, dv), stacked)."""
    from llm_quest_tpu_torch.kernels.gdn import gated_delta_rule_step_stacked

    return gated_delta_rule_step_stacked(
        q_t, k_t, v_t, beta_t, alpha_t, stacked, layer, plain=not _use_gdn_kernel(cfg)
    )


def gated_delta_rule_auto(q, k, v, beta, alpha, prev_state=None, *, chunk_size=64, use_kernel=True):
    """Full-sequence dispatch: every s ≥ 2 goes to the prefill kernel
    (kernels/gdn.py, K1; the JAX thresholds were TPU measurements), whose
    plain version is the chunked form with c = min(chunk_size, s); s = 1
    takes the scan. ``use_kernel=False`` runs the plain version on any device."""
    if q.shape[2] >= 2:
        from llm_quest_tpu_torch.kernels.gdn import gated_delta_rule_fwd

        return gated_delta_rule_fwd(q, k, v, beta, alpha, prev_state, chunk_size=chunk_size, plain=not use_kernel)
    return gated_delta_rule(q, k, v, beta, alpha, prev_state)


def gated_delta_rule_dispatch(cfg, q, k, v, beta, alpha, prev_state=None):
    """Model-level dispatch: ``gated_delta_rule_auto`` at the config's chunk
    and kernel switch. JAX's context-parallel branch (the LASP form,
    ``parallel/sequence.py::gdn_sequence_parallel``) is not ported: under
    ``cfg["context_parallel"]`` this raises rather than run the
    single-device form on a rank's slice of the sequence."""
    refuse_context_parallel(cfg, "the gated delta rule")
    return gated_delta_rule_auto(
        q, k, v, beta, alpha, prev_state,
        chunk_size=cfg.get("gdn_chunk_size", 64), use_kernel=_use_gdn_kernel(cfg),
    )


def refuse_context_parallel(cfg, what):
    """Raise ``NotImplementedError`` when ``cfg`` asks for context parallelism,
    which ``what`` does not have in the port."""
    if cfg is not None and cfg.get("context_parallel") is not None:
        raise NotImplementedError(
            f"{what}: context parallelism (the LASP form of the gated delta rule) is not ported; "
            "only the dense Qwen3 (models/qwen3.py) trains under cfg['context_parallel']"
        )


def _use_gdn_kernel(cfg):
    return cfg.get("use_kernels", True) and cfg.get("use_gdn_kernel", True)


def causal_conv1d(w, x):
    """Depthwise causal temporal convolution, computed in the weight's dtype.

    w: (c, kernel_size); x: (b, s, c) → (b, s, c). Output t sees inputs ≤ t
    (kernel_size-1 implicit left zeros).
    """
    c, ksz = w.shape
    s = x.shape[1]
    xw = x.to(w.dtype)
    out = xw * w[:, ksz - 1]
    for j in range(ksz - 1):
        shift = ksz - 1 - j
        out = out + F.pad(xw, (0, 0, shift, 0))[:, :s] * w[:, j]
    return out.to(x.dtype)


def causal_conv1d_seeded(w, x, conv_state):
    """``causal_conv1d`` continuing from rolling taps conv_state:
    (b, kernel_size-1, c), oldest first. Returns (out (b, s, c),
    ext (b, k-1+s, c)) — ``ext`` feeds ``conv_state_from_prefill`` so the
    next state can reach back into the seeded taps when s < k-1."""
    k1 = w.shape[1] - 1
    ext = torch.cat([conv_state.to(x.dtype), x], dim=1)
    return causal_conv1d(w, ext)[:, k1:], ext


def causal_conv1d_update(w, x_t, conv_state):
    """Single-step conv with rolling state. x_t: (b, c); conv_state:
    (b, kernel_size-1, c). Returns (out (b, c), new_conv_state)."""
    ksz = w.shape[1]
    out = x_t.to(w.dtype) * w[:, ksz - 1]
    for j in range(ksz - 1):
        out = out + conv_state[:, j].to(w.dtype) * w[:, j]
    new_state = torch.cat([conv_state[:, 1:], x_t[:, None, :].to(conv_state.dtype)], dim=1)
    return out.to(x_t.dtype), new_state


def conv_state_from_prefill(x, kernel_size, mask=None):
    """Rolling conv state after a prefill: the last kernel_size-1 inputs,
    zero-padded on the left if the sequence is shorter. x: (b, s, c).

    ``mask``: optional (b, s) bool of REAL tokens; the state then ends at each
    row's last real token, with pad/out-of-range taps zero.
    """
    b, s, c = x.shape
    k1 = kernel_size - 1
    if mask is not None:
        any_real = mask.any(dim=1)
        end = s - mask.flip(1).int().argmax(dim=1) - torch.where(any_real, 0, s)
        idx_raw = end[:, None] - k1 + torch.arange(k1, device=x.device)[None, :]
        idx = idx_raw.clamp(0, s - 1)
        tail = torch.gather(x, 1, idx[:, :, None].expand(b, k1, c))
        valid = (idx_raw >= 0) & torch.gather(mask, 1, idx)
        return tail * valid[:, :, None].to(x.dtype)
    tail = x[:, max(s - k1, 0):]
    if s < k1:
        tail = torch.cat([tail.new_zeros(b, k1 - s, c), tail], dim=1)
    return tail


WINDOW = "gdn_window"  # cache leaf: {GDN layer: [(k, v, beta, alpha, {tap leaf: conv input}) a call]}
STATE_MASK = "gdn_state_mask"  # cache leaf: (b, max_len) bool, the columns whose tokens enter the GDN state


def has_gdn_state(cache):
    """Whether ``cache`` (a model's ``init_cache``) holds GDN states and conv taps."""
    return "recurrent" in cache


def state_leaves(cache):
    """The names of the leaves a window advances: the recurrent states and every conv-tap leaf."""
    return [name for name in cache if name == "recurrent" or name.startswith("conv")]


def state_mask(cache, attn_mask):
    """The (b, ·) mask of the tokens the GDN layers take into their state:
    the cache's ``STATE_MASK`` where it has one, else ``attn_mask``."""
    return attn_mask if cache is None or STATE_MASK not in cache else cache[STATE_MASK]


def window_recorder(cache, layer):
    """The ``record`` callable of GDN layer ``layer`` while ``cache`` carries
    a ``WINDOW`` leaf, else None: it keeps the call's state inputs, k (b,
    h_qk, s, dk), v (b, h, s, dv), beta and alpha (b, h, s, after the pad
    freeze) and each tap leaf's conv input (b, s, c), in call order."""
    if cache is None or WINDOW not in cache:
        return None

    def record(k, v, beta, alpha, taps):
        cache[WINDOW].setdefault(layer, []).append((k, v, beta, alpha, taps))

    return record


def roll_window(cfg, cache, counts, before=None):
    """Advance every GDN layer of ``cache`` over each row's first
    ``counts`` (b,) tokens of the window its ``WINDOW`` leaf recorded, from
    the states and taps of ``before`` (a dict of those leaves; None: the
    cache's own, which a multi-token call leaves untouched), in place; the
    ``WINDOW`` leaf is removed. The tokens past a row's count are frozen as
    pads are (``freeze_masked_updates``), and a row's taps are the k − 1
    conv inputs ending at its last kept token, [old taps ‖ window inputs]
    at [count, count + k − 1): one K1 call a layer (its output is not read,
    and k stands in for q) and one gather a tap leaf."""
    window = cache.pop(WINDOW)
    src = cache if before is None else before
    keep = tap_idx = None
    for layer, calls in window.items():
        k, v, beta, alpha = (_along_time([call[i] for call in calls], 2) for i in range(4))
        if keep is None:
            keep = torch.arange(k.shape[2], device=k.device)[None] < counts[:, None]
        beta, alpha = freeze_masked_updates(beta, alpha, keep)
        if k.shape[1] != v.shape[1]:
            k = k.repeat_interleave(v.shape[1] // k.shape[1], dim=1)
        _, state = gated_delta_rule_dispatch(cfg, k, k, v, beta, alpha, src["recurrent"][layer])
        for name in calls[0][4]:
            x = _along_time([call[4][name] for call in calls], 1)
            taps = src[name][layer]
            if tap_idx is None:
                tap_idx = counts[:, None] + torch.arange(taps.shape[1], device=counts.device)
            ext = torch.cat([taps.to(x.dtype), x], dim=1)
            cache[name][layer] = ext.gather(1, tap_idx[:, :, None].expand(-1, -1, ext.shape[2]))
        cache["recurrent"][layer] = state


def _along_time(parts, dim):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def freeze_masked_updates(beta, alpha, mask):
    """Masked (pad) time steps become state no-ops: beta=0, alpha=1.
    beta/alpha: (b, h, s); mask: (b, s) bool or None."""
    if mask is None:
        return beta, alpha
    m = mask[:, None, :]
    return beta * m.to(beta.dtype), torch.where(m, alpha, torch.ones((), dtype=alpha.dtype, device=alpha.device))


def gdn_chunk(qq, kk, vv, bb, aa, state):
    """One chunk of the chunked gated delta rule.

    qq/kk: (b, h, c, dk) fp32, q pre-scaled by dk^-0.5; vv: (b, h, c, dv);
    bb/aa: (b, h, c) fp32; state: (b, h, dv, dk) fp32 chunk-initial S₀.
    Solves (I + strict_tril(β_t·(γ_t/γ_i)·k_iᵀk_t)) D = diag(βγ)·K·S₀ᵀ − diag(β)·V
    and returns (S_C, out) with
        o_t = γ_t·S₀q_t − Σ_{i≤t} (γ_t/γ_i)(k_iᵀq_t)·d_i
        S_C = γ_C·S₀ − Σ_i (γ_C/γ_i)·d_i k_iᵀ
    """
    c = qq.shape[2]
    ones = torch.ones(c, c, dtype=torch.bool, device=qq.device)
    tril_strict, tril_incl = ones.tril(-1), ones.tril()
    eye = torch.eye(c, dtype=torch.float32, device=qq.device)

    lgamma = torch.cumsum(torch.log(aa.clamp_min(1e-30)), dim=-1)
    gamma = torch.exp(lgamma)
    lr = lgamma[..., :, None] - lgamma[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=qq.device)
    ratio = torch.where(tril_incl, torch.exp(lr.clamp_max(0.0)), zero)

    kkT = kk @ kk.transpose(-1, -2)
    m = eye + torch.where(tril_strict, bb[..., :, None] * ratio * kkT, zero)
    rhs = (bb * gamma)[..., None] * (kk @ state.transpose(-1, -2)) - bb[..., None] * vv
    d = torch.linalg.solve_triangular(m, rhs, upper=False, unitriangular=True)

    att = torch.where(tril_incl, ratio * (qq @ kk.transpose(-1, -2)), zero)
    out = gamma[..., None] * (qq @ state.transpose(-1, -2)) - att @ d

    # γ_C/γ_i in log space: γ itself can underflow fp32 over a chunk
    lgamma_c = lgamma[..., -1:]
    ratio_c = torch.exp((lgamma_c - lgamma).clamp_max(0.0))
    new_state = torch.exp(lgamma_c)[..., None] * state - (ratio_c[..., None] * d).transpose(-1, -2) @ kk
    return new_state, out


def chunk_views(q, k, v, beta, alpha, c):
    """fp32 chunk views (b, h, n, c, ·) of a sequence padded to n·c tokens
    with β=0, α=1 (a no-op), q pre-scaled by dk^-0.5; returns the five views
    and the padded length."""
    b, h, s, dk = k.shape
    s_pad = -(-s // c) * c
    pad = s_pad - s

    def prep(x, fill=0.0):
        x = x.float()
        if pad:
            x = F.pad(x, (0, 0, 0, pad) if x.ndim == 4 else (0, pad), value=fill)
        return x.reshape(b, h, s_pad // c, c, *x.shape[3:])

    return prep(q.float() * dk**-0.5), prep(k), prep(v), prep(beta), prep(alpha, fill=1.0), s_pad


def gated_delta_rule_chunked(q, k, v, beta, alpha, prev_state=None, *, chunk_size=64, return_chunk_states=False):
    """Chunked-parallel gated delta rule — exact, same args/returns as
    ``gated_delta_rule``. The tail is padded with β=0, α=1 (a no-op).
    ``return_chunk_states`` adds a third result: the state before each chunk
    of c = min(chunk_size, s) tokens, (n_chunks, b, h, dv, dk) fp32."""
    b, h, s, _ = k.shape
    dv = v.shape[-1]
    qc, kc, vc, bc, ac, s_pad = chunk_views(q, k, v, beta, alpha, min(chunk_size, s))

    state = _zero_state(q, k, v) if prev_state is None else prev_state.float()
    outs, chunk_states = [], []
    for i in range(qc.shape[2]):
        chunk_states.append(state)
        state, o = gdn_chunk(qc[:, :, i], kc[:, :, i], vc[:, :, i], bc[:, :, i], ac[:, :, i], state)
        outs.append(o)
    out = torch.stack(outs, dim=2).reshape(b, h, s_pad, dv)[:, :, :s].to(q.dtype)
    if return_chunk_states:
        return out, state, torch.stack(chunk_states)
    return out, state


def _zero_state(q, k, v):
    b, h, _, dk = k.shape
    return torch.zeros(b, h, v.shape[-1], dk, dtype=torch.float32, device=q.device)
