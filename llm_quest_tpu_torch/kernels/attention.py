"""Attention kernels (csrc/attention.cu) and their plain PyTorch versions.

- ``flash_attention``: K4, blockwise online-softmax attention with causal
  masking from a static ``q_start``, a (b, sk) key-validity mask, GQA, a
  sliding window, score soft-capping and per-head sinks, and v's own head
  dim dv (the (d, dv) pairs of ``HEAD_DIMS``), differentiable: on
  a CUDA tensor it is a ``torch.autograd.Function`` whose forward launches
  ``llmq_attention_fwd`` (which also writes the row logsumexp, the sinks
  included) and whose backward is ``flash_attention_bwd``. Replaces
  ``llm_quest_tpu/kernels/flash_attention.py::flash_attention`` (forward and
  custom VJP). Plain version: ``ops/attention.py::sdpa`` on the dense mask
  (causal, window and key mask rendered into it) with the sink and softcap,
  differentiated by autograd.
- ``flash_attention_bwd``: K4's backward, the two recompute kernels of
  ``llmq_attention_bwd`` (dq; dk and dv), replacing ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``. δ = rowsum(dO ⊙ O) and the sinks' gradient
  dsink_h = −Σ_rows exp(sink_h − lse)·δ are torch reductions, as they are
  outside the Pallas kernels in JAX; ``delta_shift`` is JAX's per-row shift
  (the cotangent of the logsumexp). Plain version: autograd through the plain
  forward.
- ``packed_mha``: K7, bidirectional maskless MHA on packed (b, s, h·d)
  projections (h·d % 128 == 0, d ∈ {32, 64, 128}), the flash forward kernel
  read by packed strides; replaces
  ``llm_quest_tpu/kernels/fused_mha.py::packed_mha``. Plain version: split
  heads, ``sdpa``, merge heads. Differentiable: on a CUDA tensor that needs a
  gradient it is a ``torch.autograd.Function`` whose backward is autograd
  through the plain version, as JAX's ``_packed_bwd`` is an XLA recompute
  (``packed_mha_bwd_plain``, shared with the int8 kernels' straight-through
  backward).

Mask polarity: ``attn_mask`` here is (b, sk) with True = REAL key, as in the
JAX flash kernel; the dense masks of ``ops/masks.py`` are True = MASKED.

Device rule: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version. ``plain=True`` forces the plain version on any device; only
comparisons against the kernel pass it. Each wrapper counts its launches in
its ``launches`` attribute; the two flash wrappers also count those with a
sliding window in ``window_launches`` and those with a softcap or sinks in
``softcap_sink_launches``.
"""

import torch

from llm_quest_tpu_torch.kernels import build
from llm_quest_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from llm_quest_tpu_torch.ops.masks import causal_mask, mask_value

# the (q/k head dim d, v head dim dv) pairs K4 (flash_attention) is built for:
# dv = d, MiMo-V2-Flash's decoupled value head (d 64, dv 32) and DeepSeek-V3
# small's MLA (q/k 96: the latent-up 64 and the RoPE'd decoupled 32; v 64)
HEAD_DIMS = frozenset({(64, 64), (128, 128), (256, 256), (64, 32), (96, 64)})
PACKED_HEAD_DIMS = (32, 64, 128)  # the head dims of the packed kernels (K7, K8, K9)


def _check(q, k, v, key_mask, causal, q_start, window_size=None, softcap=None, sink=None):
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    build.require(k.shape == (b, hkv, sk, d) and v.shape == (b, hkv, sk, dv), "k/v must be (b, hkv, sk, d|dv)")
    build.require((d, dv) in HEAD_DIMS, f"kernel head dims (d, dv) are {sorted(HEAD_DIMS)}, got {(d, dv)}")
    build.require(hq % hkv == 0, "q heads must be a multiple of kv heads")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    build.require(not causal or q_start + sq <= sk, "causal queries must lie inside the key range")
    build.require(window_size is None or window_size >= 1, "window_size must be at least 1")
    build.require(softcap is None or softcap > 0, "softcap must be positive")
    if key_mask is not None:
        build.require(key_mask.shape == (b, sk), f"attn_mask must be (b, sk) = {(b, sk)}")
    if sink is not None:
        build.require(sink.shape == (hq,), f"sink must be (hq,) = {(hq,)}")
    build.require_cuda(q, k, v, *(t for t in (key_mask, sink) if t is not None))


def _mask_arg(key_mask):
    """(uint8 mask kept alive by the caller, pointer, row stride) of a (b, sk) key mask."""
    if key_mask is None:
        return None, None, 0
    m = key_mask.to(torch.uint8).contiguous()
    return m, m.data_ptr(), m.shape[1]


def _launch_fwd(q, k, v, o, lse, key_mask, *, causal, q_start, scale, qs, ks, vs, os_, dims,
                window_size=None, softcap=None, sink=None):
    """q/k/v/o strides are (batch, head, seq) triples; dims = (b, hq, hkv, sq, sk, d, dv);
    lse: contiguous fp32 (b, hq, sq) or None."""
    b, hq, hkv, sq, sk, d, dv = dims
    mask, mask_ptr, mask_sb = _mask_arg(key_mask)
    sink32 = None if sink is None else sink.float().contiguous()
    build.launch(
        "llmq_attention_fwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(), mask_ptr,
        b, hq, hkv, sq, sk, d, dv, *qs, *ks, *vs, *os_, mask_sb,
        int(causal), int(q_start), float(scale), int(window_size or 0), float(softcap or 0.0),
        None if sink32 is None else sink32.data_ptr(), build.stream_of(q),
    )
    del mask, sink32  # freed to the caching allocator: only later work on this stream reuses them


def _flash_fwd(q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap, with_lse):
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    o = torch.empty(b, hq, sq, dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device) if with_lse else None
    _launch_fwd(
        q, k, v, o, lse, key_mask, causal=causal, q_start=q_start, scale=scale,
        qs=q.stride()[:3], ks=k.stride()[:3], vs=v.stride()[:3], os_=o.stride()[:3],
        dims=(b, hq, hkv, sq, sk, d, dv), window_size=window_size, softcap=softcap, sink=sink,
    )
    flash_attention.launches += 1
    flash_attention.window_launches += int(window_size is not None)
    flash_attention.softcap_sink_launches += int(softcap is not None or sink is not None)
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """K4 forward + recompute backward; saves q, k, v, o, the fp32 lse and the sink."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap):
        o, lse = _flash_fwd(q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, key_mask, sink)
        ctx.causal, ctx.q_start, ctx.scale, ctx.window_size, ctx.softcap = causal, q_start, scale, window_size, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, key_mask, sink = ctx.saved_tensors
        want_dsink = ctx.needs_input_grad[4]
        grads = flash_attention_bwd(
            q, k, v, o, lse, do, attn_mask=key_mask, causal=ctx.causal, q_start=ctx.q_start, scale=ctx.scale,
            window_size=ctx.window_size, softcap=ctx.softcap, sink=sink if want_dsink else None,
        )
        return *grads[:3], None, grads[3] if want_dsink else None, None, None, None, None, None


def flash_attention_plain(q, k, v, *, attn_mask=None, causal=True, q_start=0, scale=None, window_size=None,
                          sink=None, softcap=None):
    mask = _dense_mask(q, k, attn_mask, causal, q_start, window_size)
    return sdpa(q, k, v, mask=mask, scale=scale, sink=sink, softcap=softcap)


def _dense_mask(q, k, attn_mask, causal, q_start, window_size=None):
    """The (b|1, 1, sq, sk) True = masked rendering of the structured mask."""
    sq, sk = q.shape[2], k.shape[2]
    if causal:
        return causal_mask(sq, sk, q_start=q_start, window_size=window_size, attn_mask=attn_mask, device=q.device)
    masked = None if attn_mask is None else ~attn_mask[:, None, None, :]
    if window_size is not None:  # a window without causality: only the keys behind it are masked
        q_pos = q_start + torch.arange(sq, device=q.device)
        outside = (torch.arange(sk, device=q.device)[None, :] <= q_pos[:, None] - window_size)[None, None]
        masked = outside if masked is None else masked | outside
    return masked


def flash_attention(
    q, k, v, *, attn_mask=None, causal=True, q_start=0, scale=None,
    window_size=None, sink=None, softcap=None, plain=False,
):
    """Attention, differentiable in q, k, v and the sink. q: (b, hq, sq, d);
    k: (b, hkv, sk, d); v: (b, hkv, sk, dv), hq % hkv == 0; the kernel takes
    the (d, dv) pairs of ``HEAD_DIMS``. ``q_start`` (int) is the absolute
    position of query row 0: key j is visible to query i iff j <= q_start + i
    (causal). attn_mask: optional (b, sk) bool, True = real key.
    window_size: optional sliding window, keys in [p - window + 1, p] for the
    query at position p. sink: optional (hq,) sink logits (one more softmax
    term per head, no value). softcap: optional cap, scores → cap·tanh(s /
    cap) before the masks. Returns (b, hq, sq, dv) in q's dtype.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return flash_attention_plain(
            q, k, v, attn_mask=attn_mask, causal=causal, q_start=q_start, scale=scale, window_size=window_size,
            sink=sink, softcap=softcap,
        )
    _check(q, k, v, attn_mask, causal, q_start, window_size, softcap, sink)
    q_start, scale = int(q_start), float(scale)
    window_size = None if window_size is None else int(window_size)
    softcap = None if softcap is None else float(softcap)
    if build.needs_grad(q, k, v, sink):
        return _FlashAttention.apply(q, k, v, attn_mask, sink, causal, q_start, scale, window_size, softcap)
    return _flash_fwd(q, k, v, attn_mask, sink, causal, q_start, scale, window_size, softcap, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.window_launches = 0
flash_attention.softcap_sink_launches = 0


def _plain_lse(q, k, attn_mask, causal, q_start, scale, window_size=None, softcap=None, sink=None):
    """Row logsumexp of the plain version's masked scores (the sink column
    included), fp32 (b, hq, sq)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    scores = (qg @ k.float()[:, :, None].transpose(-1, -2)).reshape(b, hq, sq, sk) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = _dense_mask(q, k, attn_mask, causal, q_start, window_size)
    if mask is not None:
        scores = scores.masked_fill(mask, mask_value(torch.float32))
    if sink is not None:
        scores = torch.cat([scores, sink.float()[None, :, None, None].expand(b, hq, sq, 1)], dim=-1)
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_plain(q, k, v, do, *, attn_mask=None, causal=True, q_start=0, scale=None, window_size=None,
                              softcap=None, sink=None, delta_shift=None):
    """(dq, dk, dv[, dsink]) by autograd through the plain forward;
    ``delta_shift`` is the cotangent of the row logsumexp."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v, sink) if t is not None]
        qg, kg, vg = leaves[:3]
        sg = leaves[3] if sink is not None else None
        out = flash_attention_plain(qg, kg, vg, attn_mask=attn_mask, causal=causal, q_start=q_start, scale=scale,
                                    window_size=window_size, sink=sg, softcap=softcap)
        outs, cts = [out], [do]
        if delta_shift is not None:
            outs.append(_plain_lse(qg, kg, attn_mask, causal, q_start, scale, window_size, softcap, sg))
            cts.append(delta_shift.float())
        return torch.autograd.grad(outs, leaves, cts)


def flash_attention_bwd(
    q, k, v, o, lse, do, *, attn_mask=None, causal=True, q_start=0, scale=None, window_size=None, softcap=None,
    sink=None, delta_shift=None, plain=False,
):
    """Gradients (dq, dk, dv) of attention for the output cotangent ``do``
    (b, hq, sq, dv), recomputed from q, k, v, the forward's output ``o`` and
    its fp32 row logsumexp ``lse`` (b, hq, sq; the sinks included); with ``sink`` given,
    (dq, dk, dv, dsink). ``delta_shift``: optional (b, hq, sq) cotangent of
    the logsumexp, folded in as δ − shift. dq/dk/dv come back in q's dtype,
    dsink in the sink's. The plain version ignores ``o`` and ``lse``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return flash_attention_bwd_plain(
            q, k, v, do, attn_mask=attn_mask, causal=causal, q_start=q_start, scale=scale, window_size=window_size,
            softcap=softcap, sink=sink, delta_shift=delta_shift,
        )
    _check(q, k, v, attn_mask, causal, q_start, window_size, softcap, sink)
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    build.require(do.shape == (b, hq, sq, dv) and o.shape == do.shape, "do and o must be (b, hq, sq, dv)")
    build.require(do.dtype == q.dtype, "do must have q's dtype")
    build.require(
        lse.shape == (b, hq, sq) and lse.dtype == torch.float32 and lse.is_contiguous(),
        "lse must be contiguous fp32 (b, hq, sq)",
    )
    build.require_cuda(q, o, lse, do, *(() if delta_shift is None else (delta_shift,)))
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1)  # (b, hq, sq), contiguous
    shift = None
    if delta_shift is not None:
        build.require(delta_shift.shape == (b, hq, sq), "delta_shift must be (b, hq, sq)")
        shift = delta_shift.float().contiguous()
    dq = torch.empty(b, hq, sq, d, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, hkv, sk, d, dtype=q.dtype, device=q.device)
    dv_grad = torch.empty(b, hkv, sk, dv, dtype=q.dtype, device=q.device)
    mask, mask_ptr, mask_sb = _mask_arg(attn_mask)
    build.launch(
        "llmq_attention_bwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if shift is None else shift.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv_grad.data_ptr(), mask_ptr,
        b, hq, hkv, sq, sk, d, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], mask_sb,
        int(causal), int(q_start), float(scale), int(window_size or 0), float(softcap or 0.0), build.stream_of(q),
    )
    del mask
    flash_attention_bwd.launches += 1
    flash_attention_bwd.window_launches += int(window_size is not None)
    flash_attention_bwd.softcap_sink_launches += int(softcap is not None or sink is not None)
    if sink is None:
        return dq, dk, dv_grad
    # the sink's probability exp(sink - lse) times d out / d sink = -out: a reduction over batch and rows
    shifted = delta if shift is None else delta - shift
    dsink = -(torch.exp(sink.float()[None, :, None] - lse) * shifted).sum((0, 2))
    return dq, dk, dv_grad, dsink.to(sink.dtype)


flash_attention_bwd.launches = 0
flash_attention_bwd.window_launches = 0
flash_attention_bwd.softcap_sink_launches = 0


def packed_mha_plain(q, k, v, n_heads, scale=None):
    out = sdpa(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads), scale=scale)
    return merge_heads(out)


def packed_mha_bwd_plain(q, k, v, do, n_heads, scale=None):
    """(dq, dk, dv) of ``packed_mha_plain`` for the output cotangent ``do``,
    by autograd: JAX's recompute backward of the packed kernels."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(packed_mha_plain(*leaves, n_heads, scale), leaves, do)


def check_packed(q, k, v, n_heads):
    """JAX's assertion of the packed kernels (128 % d == 0, h·d % 128 == 0),
    made on every device; raises ValueError."""
    b, s, hd = q.shape
    build.require(k.shape == q.shape and v.shape == q.shape and hd % n_heads == 0, "q/k/v must be (b, s, h·d)")
    d = hd // n_heads
    build.require(128 % d == 0 and hd % 128 == 0, f"packed kernels need 128 % d == 0 and h·d % 128 == 0, got d {d}")


def check_packed_cuda(q, k, v, n_heads):
    """What the CUDA packed kernels take besides ``check_packed``."""
    d = q.shape[2] // n_heads
    build.require(d in PACKED_HEAD_DIMS, f"packed kernel head dims are {PACKED_HEAD_DIMS}, got {d}")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require_cuda(q, k, v)


def _packed_fwd(q, k, v, n_heads, scale):
    b, s, hd = q.shape
    d = hd // n_heads
    o = torch.empty(b, s, hd, dtype=q.dtype, device=q.device)
    # (batch, head, seq) strides of the packed layout
    packed = lambda t: (t.stride(0), d, t.stride(1))  # noqa: E731
    _launch_fwd(
        q, k, v, o, None, None, causal=False, q_start=0, scale=scale,
        qs=packed(q), ks=packed(k), vs=packed(v), os_=packed(o), dims=(b, n_heads, n_heads, s, s, d, d),
    )
    packed_mha.launches += 1
    return o


class _PackedMHA(torch.autograd.Function):
    """K7 forward, recompute backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads, ctx.scale = n_heads, scale
        return _packed_fwd(q, k, v, n_heads, scale)

    @staticmethod
    def backward(ctx, do):
        return *packed_mha_bwd_plain(*ctx.saved_tensors, do, ctx.n_heads, ctx.scale), None, None


def packed_mha(q, k, v, n_heads, scale=None, *, plain=False):
    """Bidirectional maskless MHA on packed (b, s, h·d) tensors, read and
    written by stride (no head transposes). Returns (b, s, h·d);
    differentiable in q, k and v."""
    check_packed(q, k, v, n_heads)
    if scale is None:
        scale = (q.shape[2] // n_heads) ** -0.5
    if plain or not q.is_cuda:
        return packed_mha_plain(q, k, v, n_heads, scale)
    check_packed_cuda(q, k, v, n_heads)
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    if build.needs_grad(q, k, v):
        return _PackedMHA.apply(q, k, v, n_heads, float(scale))
    return _packed_fwd(q, k, v, n_heads, float(scale))


packed_mha.launches = 0
