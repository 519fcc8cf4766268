"""Attention kernels (csrc/attention.cu) and their plain PyTorch versions.

- ``flash_attention``: K4 forward, blockwise online-softmax attention with
  causal masking from a static ``q_start``, a (b, sk) key-validity mask and
  GQA; replaces ``llm_quest_tpu/kernels/flash_attention.py::flash_attention``
  (forward). Plain version: ``ops/attention.py::sdpa`` on the dense mask.
- ``packed_mha``: K7, bidirectional maskless MHA on packed (b, s, h·d)
  projections; replaces ``llm_quest_tpu/kernels/fused_mha.py::packed_mha``.
  Plain version: split heads, ``sdpa``, merge heads.

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
from llm_quest_tpu_torch.ops.masks import causal_mask

HEAD_DIMS = (64, 128, 256)  # the head dims csrc/attention.cu is instantiated for


def _launch(q, k, v, o, key_mask, *, causal, q_start, scale, qs, ks, vs, os_, dims):
    """q/k/v/o strides are (batch, head, seq) triples; dims = (b, hq, hkv, sq, sk, d)."""
    b, hq, hkv, sq, sk, d = dims
    build.require(d in HEAD_DIMS, f"kernel head dims are {HEAD_DIMS}, got {d}")
    build.require(hq % hkv == 0, "q heads must be a multiple of kv heads")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    mask_ptr, mask_sb = None, 0
    if key_mask is not None:
        build.require(key_mask.shape == (b, sk), f"attn_mask must be (b, sk) = {(b, sk)}")
        key_mask = key_mask.to(torch.uint8).contiguous()  # kept alive through the launch below
        mask_ptr, mask_sb = key_mask.data_ptr(), sk
    build.launch(
        "llmq_attention_fwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), mask_ptr,
        b, hq, hkv, sq, sk, d, *qs, *ks, *vs, *os_, mask_sb,
        int(causal), int(q_start), float(scale), build.stream_of(q),
    )


def flash_attention_plain(q, k, v, *, attn_mask=None, causal=True, q_start=0, scale=None):
    sq, sk = q.shape[2], k.shape[2]
    if causal:
        mask = causal_mask(sq, sk, q_start=q_start, attn_mask=attn_mask, device=q.device)
    else:
        mask = None if attn_mask is None else ~attn_mask[:, None, None, :]
    return sdpa(q, k, v, mask=mask, scale=scale)


def flash_attention(
    q, k, v, *, attn_mask=None, causal=True, q_start=0, scale=None,
    window_size=None, sink=None, softcap=None, plain=False,
):
    """Attention forward. q: (b, hq, sq, d); k/v: (b, hkv, sk, d), hq % hkv
    == 0. ``q_start`` (int) is the absolute position of query row 0: key j
    is visible to query i iff j <= q_start + i. attn_mask: optional (b, sk)
    bool, True = real key. Returns (b, hq, sq, d) in q's dtype.

    Sliding windows, sinks and softcapping are not ported (Qwen3.5 uses none)
    and raise.
    """
    if window_size is not None or sink is not None or softcap is not None:
        raise NotImplementedError("flash_attention: window_size, sink and softcap are not ported")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return flash_attention_plain(q, k, v, attn_mask=attn_mask, causal=causal, q_start=q_start, scale=scale)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    build.require_cuda(q, k, v, *(() if attn_mask is None else (attn_mask,)))
    build.require(k.shape == (b, hkv, sk, d) and v.shape == (b, hkv, sk, d), "k/v must be (b, hkv, sk, d)")
    build.require(not causal or q_start + sq <= sk, "causal queries must lie inside the key range")
    o = torch.empty(b, hq, sq, d, dtype=q.dtype, device=q.device)
    _launch(
        q, k, v, o, attn_mask, causal=causal, q_start=q_start, scale=scale,
        qs=q.stride()[:3], ks=k.stride()[:3], vs=v.stride()[:3], os_=o.stride()[:3],
        dims=(b, hq, hkv, sq, sk, d),
    )
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def packed_mha_plain(q, k, v, n_heads, scale=None):
    out = sdpa(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads), scale=scale)
    return merge_heads(out)


def packed_mha(q, k, v, n_heads, scale=None, *, plain=False):
    """Bidirectional maskless MHA on packed (b, s, h·d) tensors, read and
    written by stride (no head transposes). Returns (b, s, h·d)."""
    b, s, hd = q.shape
    d = hd // n_heads
    if scale is None:
        scale = d**-0.5
    if plain or not q.is_cuda:
        return packed_mha_plain(q, k, v, n_heads, scale)
    build.require_cuda(q, k, v)
    build.require(k.shape == q.shape and v.shape == q.shape and hd % n_heads == 0, "q/k/v must be (b, s, h·d)")
    o = torch.empty(b, s, hd, dtype=q.dtype, device=q.device)
    # (batch, head, seq) strides of the packed layout
    packed = lambda t: (t.stride(0), d, t.stride(1))  # noqa: E731
    _launch(
        q, k, v, o, None, causal=False, q_start=0, scale=scale,
        qs=packed(q), ks=packed(k), vs=packed(v), os_=packed(o), dims=(b, n_heads, n_heads, s, s, d),
    )
    packed_mha.launches += 1
    return o


packed_mha.launches = 0
