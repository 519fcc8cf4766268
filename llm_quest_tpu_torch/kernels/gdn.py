"""Gated-delta-rule kernels (csrc/gdn.cu) and their plain PyTorch versions.

- ``gated_delta_rule_fwd``: K1, the full-sequence forward; replaces
  ``llm_quest_tpu/kernels/gdn_pallas.py::gated_delta_rule_pallas``. Plain
  version: ``ops/gdn.py::gated_delta_rule_chunked``. Differentiable: where an
  input requires grad it is a ``torch.autograd.Function`` whose forward also
  keeps the state before every chunk of tokens (the anchors, JAX's
  ``save_chunk_states``) and whose backward is ``gated_delta_rule_bwd``.
- ``gated_delta_rule_bwd``: K1's backward (``llmq_gdn_prefill_bwd``), which
  replaces the custom VJP ``gdn_pallas.py::_gdn_bwd``: each chunk is
  replayed from its anchor and walked in reverse. Plain version: the JAX
  VJP's own form, a reverse loop of ``torch.autograd.grad`` through
  ``ops/gdn.py::gdn_chunk``, one call per chunk, from the same anchors.
- ``gated_delta_rule_step_stacked``: K2, the one-token decode step on the
  stacked (L, b, h, dv, dk) state, in place at ``layer``; replaces
  ``gdn_pallas.py::gated_delta_rule_step_stacked_pallas``, at dk 64
  (Qwen3-Next) and 128 (Qwen3.5). Plain version:
  ``ops/gdn.py::gated_delta_rule_step`` plus an indexed write. A decode step
  has no backward: on a CUDA tensor it raises ``NotImplementedError`` when
  grad mode is on and an input requires grad.

Device rule: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version (under grad, the autograd Function with both plain halves).
``plain=True`` forces the plain version on any device; only comparisons
against the kernel pass it. Each wrapper counts its launches in its
``launches`` attribute.
"""

import torch

from llm_quest_tpu_torch.kernels import build
from llm_quest_tpu_torch.ops import gdn as gdn_ops

KERNEL_DK = (64, 128)  # the q/k head dims csrc/gdn.cu's prefill and step are instantiated for
ANCHOR_CHUNK = 32  # tokens between two anchors of the CUDA path (the backward's replay window, kMaxAnchor)


def gated_delta_rule_fwd_plain(q, k, v, beta, alpha, prev_state=None, *, chunk_size=64, with_anchors=False):
    """The chunked form; ``with_anchors`` adds the state before every chunk of
    c = min(chunk_size, s) tokens, (n_chunks, b, h, dv, dk) fp32."""
    return gdn_ops.gated_delta_rule_chunked(
        q, k, v, beta, alpha, prev_state, chunk_size=chunk_size, return_chunk_states=with_anchors
    )


def _check_fwd(q, k, v, beta, alpha, prev_state):
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    build.require_cuda(q, k, v, beta, alpha, *(() if prev_state is None else (prev_state,)))
    build.require(k.shape == q.shape and v.shape == (b, h, s, dv), "q/k (b, h, s, dk), v (b, h, s, dv)")
    build.require(beta.shape == (b, h, s) and alpha.shape == (b, h, s), "beta/alpha must be (b, h, s)")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require(dk in KERNEL_DK and dv % 8 == 0, f"kernel takes dk in {KERNEL_DK} and dv % 8 == 0, got {dk}, {dv}")
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    if prev_state is not None:
        build.require(
            prev_state.shape == (b, h, dv, dk) and prev_state.dtype == torch.float32
            and prev_state.is_contiguous(),
            "prev_state must be contiguous fp32 (b, h, dv, dk)",
        )


def _launch_fwd(q, k, v, beta, alpha, prev_state, anchor_chunk=None):
    """The prefill kernel; returns (out, final state, anchors or None)."""
    _check_fwd(q, k, v, beta, alpha, prev_state)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    beta32 = beta.float().contiguous()
    alpha32 = alpha.float().contiguous()
    out = torch.empty(b, h, s, dv, dtype=q.dtype, device=q.device)
    state = torch.empty(b, h, dv, dk, dtype=torch.float32, device=q.device)
    anchors = None
    if anchor_chunk is not None:
        anchors = torch.empty(-(-s // anchor_chunk), b, h, dv, dk, dtype=torch.float32, device=q.device)
    build.launch(
        "llmq_gdn_prefill", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), beta32.data_ptr(), alpha32.data_ptr(),
        None if prev_state is None else prev_state.data_ptr(), state.data_ptr(),
        None if anchors is None else anchors.data_ptr(), out.data_ptr(),
        b, h, s, dk, dv, anchor_chunk or 1, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], dk**-0.5,
        build.stream_of(q),
    )
    gated_delta_rule_fwd.launches += 1
    return out, state, anchors


class _GatedDeltaRule(torch.autograd.Function):
    """K1 forward keeping the anchors, and its backward: the kernels on a
    CUDA tensor (anchors every ``ANCHOR_CHUNK`` tokens), the plain halves on
    the CPU (anchors every ``chunk_size`` tokens)."""

    @staticmethod
    def forward(ctx, q, k, v, beta, alpha, prev_state, chunk_size):
        chunk = min(ANCHOR_CHUNK if q.is_cuda else chunk_size, q.shape[2])
        if q.is_cuda:
            out, state, anchors = _launch_fwd(q, k, v, beta, alpha, prev_state, anchor_chunk=chunk)
        else:
            out, state, anchors = gated_delta_rule_fwd_plain(
                q, k, v, beta, alpha, prev_state, chunk_size=chunk, with_anchors=True
            )
        ctx.save_for_backward(q, k, v, beta, alpha, anchors)
        ctx.chunk, ctx.has_prev = chunk, prev_state is not None
        return out, state

    @staticmethod
    def backward(ctx, d_out, d_state):
        q, k, v, beta, alpha, anchors = ctx.saved_tensors
        dq, dk, dv, db, da, d_prev = gated_delta_rule_bwd(
            q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=ctx.chunk
        )
        return dq, dk, dv, db, da, d_prev if ctx.has_prev else None, None


def gated_delta_rule_fwd(q, k, v, beta, alpha, prev_state=None, *, chunk_size=64, plain=False):
    """Gated delta rule over a sequence, differentiable in every input.

    q/k: (b, h, s, dk) heads pre-repeated; v: (b, h, s, dv); beta/alpha:
    (b, h, s); prev_state: (b, h, dv, dk) fp32 or None (zeros). Returns
    (out (b, h, s, dv) in q's dtype, final state (b, h, dv, dk) fp32).
    ``chunk_size`` shapes only the plain chunked form; the kernel is the scan.
    """
    if plain:
        return gated_delta_rule_fwd_plain(q, k, v, beta, alpha, prev_state, chunk_size=chunk_size)
    if build.needs_grad(q, k, v, beta, alpha, prev_state):
        return _GatedDeltaRule.apply(q, k, v, beta, alpha, prev_state, chunk_size)
    if not q.is_cuda:
        return gated_delta_rule_fwd_plain(q, k, v, beta, alpha, prev_state, chunk_size=chunk_size)
    out, state, _ = _launch_fwd(q, k, v, beta, alpha, prev_state)
    return out, state


gated_delta_rule_fwd.launches = 0


def gated_delta_rule_bwd_plain(q, k, v, beta, alpha, anchors, d_out, d_state=None, *, chunk_size):
    """The JAX VJP's form (``_chunk_views`` + ``_gdn_bwd``): a reverse loop
    over chunks of c = min(chunk_size, s) tokens, each differentiated through
    ``gdn_chunk`` from its anchor, the state cotangent chained chunk to chunk."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    qc, kc, vc, bc, ac, s_pad = gdn_ops.chunk_views(q, k, v, beta, alpha, min(chunk_size, s))
    n = qc.shape[2]
    d_o = torch.nn.functional.pad(d_out.float(), (0, 0, 0, s_pad - s)).reshape(b, h, n, -1, dv)
    d_st = torch.zeros_like(anchors[0]) if d_state is None else d_state.float()
    per_chunk = []
    for i in reversed(range(n)):
        with torch.enable_grad():
            xs = [x[:, :, i].detach().requires_grad_() for x in (qc, kc, vc, bc, ac)]
            xs.append(anchors[i].detach().requires_grad_())
            new_state, out = gdn_ops.gdn_chunk(*xs)
            grads = torch.autograd.grad((new_state, out), xs, (d_st, d_o[:, :, i]))
        per_chunk.append(grads[:5])
        d_st = grads[5]
    per_chunk.reverse()

    def unchunk(j):
        g = torch.stack([c[j] for c in per_chunk], dim=2)
        return g.reshape(b, h, s_pad, *g.shape[4:])[:, :, :s]

    return (
        (unchunk(0) * dk**-0.5).to(q.dtype), unchunk(1).to(k.dtype), unchunk(2).to(v.dtype),
        unchunk(3).to(beta.dtype), unchunk(4).to(alpha.dtype), d_st,
    )


def gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, d_state=None, *, chunk_size, plain=False):
    """Gradients of ``gated_delta_rule_fwd`` from its anchors.

    anchors: (ceil(s / c), b, h, dv, dk) fp32, the state before tokens 0, c,
    2c, ... with c = min(chunk_size, s); d_out: (b, h, s, dv) cotangent of
    the output; d_state: (b, h, dv, dk) cotangent of the final state, or
    None (zeros). Returns (dq, dk, dv, dbeta, dalpha, d_prev_state), each in
    its input's dtype (d_prev_state fp32). The kernel takes c ≤ 32."""
    if plain or not q.is_cuda:
        return gated_delta_rule_bwd_plain(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=chunk_size)
    _check_fwd(q, k, v, beta, alpha, None)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk_size, s)
    build.require(1 <= c <= ANCHOR_CHUNK, f"the backward kernel takes chunks of at most {ANCHOR_CHUNK} tokens, got {c}")
    build.require(d_out.shape == v.shape and d_out.dtype == q.dtype, "d_out must be (b, h, s, dv) in q's dtype")
    build.require(
        anchors.shape == (-(-s // c), b, h, dv, dk) and anchors.dtype == torch.float32 and anchors.is_contiguous(),
        "anchors must be contiguous fp32 (ceil(s / c), b, h, dv, dk)",
    )
    if d_state is not None:
        build.require(d_state.shape == (b, h, dv, dk), "d_state must be (b, h, dv, dk)")
        d_state = d_state.float().contiguous()
    build.require_cuda(anchors, d_out, *(() if d_state is None else (d_state,)))
    lib = build.library().cdll
    n_blocks = lib.llmq_gdn_prefill_bwd_blocks(dk, dv)
    build.require(n_blocks > 0, f"the backward kernel has no block shape for dk={dk}, dv={dv}")
    q, k, v, d_out = (t.contiguous() for t in (q, k, v, d_out))
    beta32, alpha32 = beta.float().contiguous(), alpha.float().contiguous()
    part = torch.empty(n_blocks, b * h, s, 2 * dk + 4, dtype=torch.float32, device=q.device)
    dq, dk_, dv_ = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    da = torch.empty_like(db)
    d_prev = torch.empty(b, h, dv, dk, dtype=torch.float32, device=q.device)
    build.launch(
        "llmq_gdn_prefill_bwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), beta32.data_ptr(), alpha32.data_ptr(), anchors.data_ptr(),
        d_out.data_ptr(), None if d_state is None else d_state.data_ptr(), part.data_ptr(),
        dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), db.data_ptr(), da.data_ptr(), d_prev.data_ptr(),
        b, h, s, dk, dv, c, dk**-0.5, build.stream_of(q),
    )
    del part  # freed to the caching allocator: only later work on this stream reuses it
    gated_delta_rule_bwd.launches += 1
    return dq, dk_, dv_, db.to(beta.dtype), da.to(alpha.dtype), d_prev


gated_delta_rule_bwd.launches = 0


def gated_delta_rule_step_stacked_plain(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer):
    out, new = gdn_ops.gated_delta_rule_step(q_t, k_t, v_t, beta_t, alpha_t, stacked[layer])
    stacked[layer] = new
    return out, stacked


def gated_delta_rule_step_stacked(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer, *, plain=False):
    """One decode step on the stacked recurrent state, updated IN PLACE at
    ``layer`` (every other layer is left untouched).

    q_t/k_t: (b, h, dk); v_t: (b, h, dv); beta_t/alpha_t: (b, h); stacked:
    (L, b, h, dv, dk) fp32 contiguous. Returns (out (b, h, dv) in q's dtype,
    stacked).
    """
    if plain or not q_t.is_cuda:
        return gated_delta_rule_step_stacked_plain(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer)
    build.require_no_grad("gated_delta_rule_step_stacked", q_t, k_t, v_t, beta_t, alpha_t, stacked)
    b, h, dk = q_t.shape
    dv = v_t.shape[-1]
    n_layers = stacked.shape[0]
    build.require_cuda(q_t, k_t, v_t, beta_t, alpha_t, stacked)
    build.require(k_t.shape == q_t.shape and v_t.shape == (b, h, dv), "q/k (b, h, dk), v (b, h, dv)")
    build.require(beta_t.shape == (b, h) and alpha_t.shape == (b, h), "beta/alpha must be (b, h)")
    build.require(k_t.dtype == q_t.dtype and v_t.dtype == q_t.dtype, "q, k and v must share one dtype")
    build.require(dk in KERNEL_DK and dv % 8 == 0, f"kernel takes dk in {KERNEL_DK} and dv % 8 == 0, got dk={dk} dv={dv}")
    build.require(all(t.stride(-1) == 1 for t in (q_t, k_t, v_t)), "q/k/v need a contiguous last dim")
    build.require(
        stacked.shape == (n_layers, b, h, dv, dk) and stacked.dtype == torch.float32 and stacked.is_contiguous(),
        "stacked must be contiguous fp32 (L, b, h, dv, dk)",
    )
    layer = int(layer)
    build.require(0 <= layer < n_layers, f"layer {layer} out of range for {n_layers} layers")
    beta32 = beta_t.float().contiguous()
    alpha32 = alpha_t.float().contiguous()
    out = torch.empty(b, h, dv, dtype=q_t.dtype, device=q_t.device)
    build.launch(
        "llmq_gdn_step_stacked", build.dtype_code(q_t),
        q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), beta32.data_ptr(), alpha32.data_ptr(),
        stacked.data_ptr(), layer, out.data_ptr(), b, h, dk, dv,
        *q_t.stride()[:2], *k_t.stride()[:2], *v_t.stride()[:2], dk**-0.5, build.stream_of(q_t),
    )
    gated_delta_rule_step_stacked.launches += 1
    return out, stacked


gated_delta_rule_step_stacked.launches = 0
