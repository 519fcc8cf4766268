"""Attention kernels (csrc/attention.cu) and their plain PyTorch versions.

- ``flash_attention``: K4, blockwise online-softmax attention with causal
  masking from a static ``q_start``, a (b, sk) key-validity mask and GQA,
  differentiable: on a CUDA tensor it is a ``torch.autograd.Function`` whose
  forward launches ``llmq_attention_fwd`` (which also writes the row
  logsumexp) and whose backward is ``flash_attention_bwd``. Replaces
  ``llm_quest_tpu/kernels/flash_attention.py::flash_attention`` (forward and
  custom VJP). Plain version: ``ops/attention.py::sdpa`` on the dense mask,
  differentiated by autograd.
- ``flash_attention_bwd``: K4's backward, the two recompute kernels of
  ``llmq_attention_bwd`` (dq; dk and dv), replacing ``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``. δ = rowsum(dO ⊙ O) is a torch reduction, as it is
  outside the Pallas kernels in JAX; ``delta_shift`` is JAX's per-row shift
  (the cotangent of the logsumexp). Plain version: autograd through the plain
  forward.
- ``packed_mha``: K7, bidirectional maskless MHA on packed (b, s, h·d)
  projections; replaces ``llm_quest_tpu/kernels/fused_mha.py::packed_mha``.
  Plain version: split heads, ``sdpa``, merge heads. Its backward is not
  ported: on the CUDA path it raises when a gradient would be needed.

Mask polarity: ``attn_mask`` here is (b, sk) with True = REAL key, as in the
JAX flash kernel; the dense masks of ``ops/masks.py`` are True = MASKED.

Device rule: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version. ``plain=True`` forces the plain version on any device; only
comparisons against the kernel pass it. Each wrapper counts its launches in
its ``launches`` attribute.
"""

import torch

from llm_quest_tpu_torch.kernels import build
from llm_quest_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from llm_quest_tpu_torch.ops.masks import causal_mask, mask_value

HEAD_DIMS = (64, 128, 256)  # the head dims csrc/attention.cu is instantiated for


def _check(q, k, v, key_mask, causal, q_start):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    build.require(d in HEAD_DIMS, f"kernel head dims are {HEAD_DIMS}, got {d}")
    build.require(k.shape == (b, hkv, sk, d) and v.shape == (b, hkv, sk, d), "k/v must be (b, hkv, sk, d)")
    build.require(hq % hkv == 0, "q heads must be a multiple of kv heads")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    build.require(not causal or q_start + sq <= sk, "causal queries must lie inside the key range")
    if key_mask is not None:
        build.require(key_mask.shape == (b, sk), f"attn_mask must be (b, sk) = {(b, sk)}")
    build.require_cuda(q, k, v, *(() if key_mask is None else (key_mask,)))


def _mask_arg(key_mask):
    """(uint8 mask kept alive by the caller, pointer, row stride) of a (b, sk) key mask."""
    if key_mask is None:
        return None, None, 0
    m = key_mask.to(torch.uint8).contiguous()
    return m, m.data_ptr(), m.shape[1]


def _launch_fwd(q, k, v, o, lse, key_mask, *, causal, q_start, scale, qs, ks, vs, os_, dims):
    """q/k/v/o strides are (batch, head, seq) triples; dims = (b, hq, hkv, sq, sk, d);
    lse: contiguous fp32 (b, hq, sq) or None."""
    b, hq, hkv, sq, sk, d = dims
    mask, mask_ptr, mask_sb = _mask_arg(key_mask)
    build.launch(
        "llmq_attention_fwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(), mask_ptr,
        b, hq, hkv, sq, sk, d, *qs, *ks, *vs, *os_, mask_sb,
        int(causal), int(q_start), float(scale), build.stream_of(q),
    )
    del mask  # freed to the caching allocator: only later work on this stream reuses it


def _flash_fwd(q, k, v, key_mask, causal, q_start, scale, with_lse):
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    o = torch.empty(b, hq, sq, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device) if with_lse else None
    _launch_fwd(
        q, k, v, o, lse, key_mask, causal=causal, q_start=q_start, scale=scale,
        qs=q.stride()[:3], ks=k.stride()[:3], vs=v.stride()[:3], os_=o.stride()[:3],
        dims=(b, hq, hkv, sq, sk, d),
    )
    flash_attention.launches += 1
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """K4 forward + recompute backward; saves q, k, v, o and the fp32 lse."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, q_start, scale):
        o, lse = _flash_fwd(q, k, v, key_mask, causal, q_start, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse, key_mask)
        ctx.causal, ctx.q_start, ctx.scale = causal, q_start, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, key_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, attn_mask=key_mask, causal=ctx.causal, q_start=ctx.q_start, scale=ctx.scale
        )
        return dq, dk, dv, None, None, None, None


def flash_attention_plain(q, k, v, *, attn_mask=None, causal=True, q_start=0, scale=None):
    return sdpa(q, k, v, mask=_dense_mask(q, k, attn_mask, causal, q_start), scale=scale)


def _dense_mask(q, k, attn_mask, causal, q_start):
    if causal:
        return causal_mask(q.shape[2], k.shape[2], q_start=q_start, attn_mask=attn_mask, device=q.device)
    return None if attn_mask is None else ~attn_mask[:, None, None, :]


def flash_attention(
    q, k, v, *, attn_mask=None, causal=True, q_start=0, scale=None,
    window_size=None, sink=None, softcap=None, plain=False,
):
    """Attention, differentiable in q, k and v. q: (b, hq, sq, d); k/v:
    (b, hkv, sk, d), hq % hkv == 0. ``q_start`` (int) is the absolute position
    of query row 0: key j is visible to query i iff j <= q_start + i.
    attn_mask: optional (b, sk) bool, True = real key. Returns (b, hq, sq, d)
    in q's dtype.

    Sliding windows, sinks and softcapping are not ported and raise.
    """
    if window_size is not None or sink is not None or softcap is not None:
        raise NotImplementedError("flash_attention: window_size, sink and softcap are not ported")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return flash_attention_plain(q, k, v, attn_mask=attn_mask, causal=causal, q_start=q_start, scale=scale)
    _check(q, k, v, attn_mask, causal, q_start)
    q_start, scale = int(q_start), float(scale)
    if build.needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, attn_mask, causal, q_start, scale)
    return _flash_fwd(q, k, v, attn_mask, causal, q_start, scale, with_lse=False)[0]


flash_attention.launches = 0


def _plain_lse(q, k, attn_mask, causal, q_start, scale):
    """Row logsumexp of the plain version's masked scores, fp32 (b, hq, sq)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    scores = (qg @ k.float()[:, :, None].transpose(-1, -2)).reshape(b, hq, sq, sk) * scale
    mask = _dense_mask(q, k, attn_mask, causal, q_start)
    if mask is not None:
        scores = scores.masked_fill(mask, mask_value(torch.float32))
    return torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_plain(q, k, v, do, *, attn_mask=None, causal=True, q_start=0, scale=None, delta_shift=None):
    """(dq, dk, dv) by autograd through the plain forward; ``delta_shift``
    is the cotangent of the row logsumexp."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        outs = [flash_attention_plain(qg, kg, vg, attn_mask=attn_mask, causal=causal, q_start=q_start, scale=scale)]
        cts = [do]
        if delta_shift is not None:
            outs.append(_plain_lse(qg, kg, attn_mask, causal, q_start, scale))
            cts.append(delta_shift.float())
        return torch.autograd.grad(outs, (qg, kg, vg), cts)


def flash_attention_bwd(
    q, k, v, o, lse, do, *, attn_mask=None, causal=True, q_start=0, scale=None, delta_shift=None, plain=False,
):
    """Gradients (dq, dk, dv) of attention for the output cotangent ``do``,
    recomputed from q, k, v, the forward's output ``o`` and its fp32 row
    logsumexp ``lse`` (b, hq, sq). ``delta_shift``: optional (b, hq, sq)
    cotangent of the logsumexp, folded in as δ − shift. dq/dk/dv come back in
    q's dtype. The plain version ignores ``o`` and ``lse``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return flash_attention_bwd_plain(
            q, k, v, do, attn_mask=attn_mask, causal=causal, q_start=q_start, scale=scale, delta_shift=delta_shift
        )
    _check(q, k, v, attn_mask, causal, q_start)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    build.require(do.shape == q.shape and o.shape == q.shape, "do and o must be (b, hq, sq, d)")
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
    dv = torch.empty(b, hkv, sk, d, dtype=q.dtype, device=q.device)
    mask, mask_ptr, mask_sb = _mask_arg(attn_mask)
    build.launch(
        "llmq_attention_bwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if shift is None else shift.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), mask_ptr,
        b, hq, hkv, sq, sk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], mask_sb,
        int(causal), int(q_start), float(scale), build.stream_of(q),
    )
    del mask
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def packed_mha_plain(q, k, v, n_heads, scale=None):
    out = sdpa(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads), scale=scale)
    return merge_heads(out)


def packed_mha(q, k, v, n_heads, scale=None, *, plain=False):
    """Bidirectional maskless MHA on packed (b, s, h·d) tensors, read and
    written by stride (no head transposes). Returns (b, s, h·d). Forward
    only on the card: raises ``NotImplementedError`` there when an input
    requires grad."""
    b, s, hd = q.shape
    d = hd // n_heads
    if scale is None:
        scale = d**-0.5
    if plain or not q.is_cuda:
        return packed_mha_plain(q, k, v, n_heads, scale)
    build.require_no_grad("packed_mha", q, k, v)
    build.require_cuda(q, k, v)
    build.require(k.shape == q.shape and v.shape == q.shape and hd % n_heads == 0, "q/k/v must be (b, s, h·d)")
    build.require(d in HEAD_DIMS, f"kernel head dims are {HEAD_DIMS}, got {d}")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    o = torch.empty(b, s, hd, dtype=q.dtype, device=q.device)
    # (batch, head, seq) strides of the packed layout
    packed = lambda t: (t.stride(0), d, t.stride(1))  # noqa: E731
    _launch_fwd(
        q, k, v, o, None, None, causal=False, q_start=0, scale=scale,
        qs=packed(q), ks=packed(k), vs=packed(v), os_=packed(o), dims=(b, n_heads, n_heads, s, s, d),
    )
    packed_mha.launches += 1
    return o


packed_mha.launches = 0
