"""Scaled-dot-product attention and its router (counterpart of
``llm_quest_tpu/ops/attention.py``).

- ``sdpa``: the plain attention core. GQA by reshaping q into kv-head groups
  (no materialized repeat); boolean masks (b|1, 1|hq, sq, sk), True = masked,
  filled with finfo.min/2; optional score soft-capping (Gemma) and per-head
  sink logits (MiMo-V2: one extra softmax column per head, dropped after the
  softmax); scores, softmax and the value sum in fp32, as the JAX version's
  preferred_element_type gives them.
- ``attention``: the router. k/v given as ``QuantKV`` views of the int8 KV
  cache (inference/cache.py) take JAX's int8 branch: a single-query step
  with a dense mask and 128-multiple head dims (``supports_flash_decode``)
  streams them through the flash-decode kernel (kernels/flash_decode.py,
  K10) with the mask as an additive finfo.min/2 bias, unless
  ``cfg["use_flash_decode"]`` is False or a sink or softcap is given; any
  other call dequantizes them once and routes on. Long causal or windowed
  calls (training forwards and cached prefills) go to the flash kernel
  (kernels/attention.py, K4), which is differentiable and takes the sliding
  window, softcap and sinks, and v with its own head dim dv (the (d, dv)
  pairs of ``kernels/attention.py::HEAD_DIMS``: dv = d, MiMo-V2-Flash's
  d 64 / dv 32 and DeepSeek-V3's MLA at d 96 / dv 64), unless
  ``cfg["use_flash"]`` is False;
  everything else, the bf16-cache decode step included, to ``sdpa``. The
  head-shard and context-parallel branches of the JAX router are not
  ported, and neither is its short-sequence fused-MHA kernel (K6): the JAX
  router sends that kernel only maskless calls, which the text attention of
  Qwen3.5 and Qwen3 never makes (it passes its causal mask).
- ``mha_packed``: bidirectional maskless MHA on packed (b, s, h·d)
  projections, the vision-tower path, routed by JAX's conditions: the packed
  kernel (K7) when ``cfg["use_fused_mha"]`` is not False, h·d % 128 == 0,
  d ∈ {32, 64, 128} and 2 ≤ s ≤ ``cfg["fused_mha_max_seq"]`` (512); with
  ``cfg["int8_scores"]`` the int8-score kernels instead (K8, or K9 with
  ``int8_scores_mode="inkernel"`` and calibrated scales); split-heads
  ``sdpa`` otherwise.

The per-kernel switches are JAX's keys: ``use_flash``, ``use_fused_mha`` and
(ops/gdn.py) ``use_gdn_kernel``, each defaulting to True. Divergence by
design: JAX also asks ``jax.default_backend() == "tpu"`` before a kernel; the
port routes the same way on every device, and a kernel wrapper launches its
CUDA kernel for a tensor on the card and runs its plain PyTorch version for
a tensor on the CPU. ``cfg["use_kernels"] = False`` runs the kernels' plain
versions on any device (kernel-vs-plain comparisons only).
"""

import torch

from llm_quest_tpu_torch.ops.masks import causal_mask, mask_value
from llm_quest_tpu_torch.ops.quantization import QuantKV


def sdpa(q, k, v, *, mask=None, scale=None, sink=None, softcap=None):
    """q: (b, hq, sq, d); k: (b, hkv, sk, d); v: (b, hkv, sk, dv); mask: bool
    (b|1, 1|hq, sq, sk), True = masked, or None; sink: optional (hq,) logits
    appended as one key column before the softmax and dropped after it;
    softcap: optional cap, scores → cap·tanh(scores / cap) before the mask.
    Returns (b, hq, sq, dv)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d**-0.5
    group = hq // hkv
    qg = q.float().reshape(b, hkv, group, sq, d)
    scores = (qg @ k.float()[:, :, None].transpose(-1, -2)).reshape(b, hq, sq, sk) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    if mask is not None:
        scores = scores.masked_fill(mask, mask_value(torch.float32))
    if sink is not None:
        scores = torch.cat([scores, sink.float()[None, :, None, None].expand(b, hq, sq, 1)], dim=-1)
    weights = torch.softmax(scores, dim=-1)[..., :sk].to(v.dtype)
    out = weights.float().reshape(b, hkv, group, sq, sk) @ v.float()[:, :, None]
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def attention(
    q, k, v, *, cfg=None, mask=None, causal=True, window_size=None, attn_mask=None, sink=None, softcap=None,
    scale=None, flash_ok=True, q_start=None,
):
    """Attention router: the flash kernel when legal and profitable, ``sdpa``
    otherwise.

    Flash takes full-sequence calls (sq == sk) and cached prefills (sq < sk
    against the max_len cache view) whose static query offset ``q_start`` is
    known, from ``cfg["flash_min_seq"]`` (default 256) queries up. Flash reads
    only the structured mask (causal, ``window_size``, ``attn_mask`` as (b,
    sk) True = real); ``mask`` is the dense rendering of the same for
    ``sdpa``. A dense mask with no structured counterpart (causal=False, no
    window) stays on ``sdpa``. ``sink`` (hq,) and ``softcap`` reach both
    routes. k/v may be ``QuantKV`` views of an int8 cache (module docstring).
    """
    plain = cfg is not None and not cfg.get("use_kernels", True)
    if isinstance(k, QuantKV):
        from llm_quest_tpu_torch.kernels.flash_decode import flash_decode, supports_flash_decode

        if (
            supports_flash_decode(q, k.data, sink=sink, softcap=softcap)
            and mask is not None
            and (cfg is None or cfg.get("use_flash_decode", True))
        ):
            bias = torch.where(mask[:, 0, 0, :], mask_value(torch.float32), 0.0).float()
            bias = bias.expand(q.shape[0], -1).contiguous()
            return flash_decode(q, k.data, k.scale, v.data, v.scale, bias, scale=scale, plain=plain)
        k, v = k.dequant(q.dtype), v.dequant(q.dtype)
    shape_ok = q.shape[2] == k.shape[2] or (causal and q_start is not None and q.shape[2] < k.shape[2])
    use_flash = (
        flash_ok
        and cfg is not None
        and cfg.get("use_flash", True)
        and shape_ok
        and q.shape[2] >= cfg.get("flash_min_seq", 256)
        and (mask is None or causal or window_size is not None)
    )
    if use_flash:
        from llm_quest_tpu_torch.kernels.attention import flash_attention

        return flash_attention(
            q, k, v, attn_mask=attn_mask, causal=causal, q_start=q_start or 0, scale=scale,
            window_size=window_size, sink=sink, softcap=softcap, plain=plain,
        )
    if mask is None and causal and q.shape[2] > 1:
        mask = causal_mask(
            q.shape[2], k.shape[2], q_start=k.shape[2] - q.shape[2], attn_mask=attn_mask, device=q.device
        )
    return sdpa(q, k, v, mask=mask, scale=scale, sink=sink, softcap=softcap)


def mha_packed(q, k, v, n_heads, *, cfg=None, scale=None, layer_idx=None):
    """Bidirectional maskless MHA on packed (b, s, h·d) projection outputs:
    the packed kernels where JAX's conditions hold (module docstring),
    split heads + ``sdpa`` + merge heads otherwise. ``layer_idx`` picks the
    layer's pair from per-layer ``cfg["int8_qk_scales"]``."""
    b, s, hd = q.shape
    d = hd // n_heads
    use_kernel = (
        (cfg is None or cfg.get("use_fused_mha", True))
        and hd % 128 == 0
        and d in (32, 64, 128)
        and 2 <= s <= (cfg.get("fused_mha_max_seq", 512) if cfg else 512)
    )
    if not use_kernel:
        heads = (split_heads(t, n_heads) for t in (q, k, v))
        return merge_heads(sdpa(*heads, scale=scale))
    plain = cfg is not None and not cfg.get("use_kernels", True)
    if cfg is not None and cfg.get("int8_scores", False):
        from llm_quest_tpu_torch.kernels.fused_mha import packed_mha_int8, packed_mha_int8_inkernel

        scales = cfg.get("int8_qk_scales")
        if scales is not None:
            if isinstance(scales[0], (tuple, list)):
                scales = tuple(scales[layer_idx if layer_idx is not None else 0])
            else:
                scales = tuple(scales)
        if cfg.get("int8_scores_mode") == "inkernel" and scales is not None:
            return packed_mha_int8_inkernel(q, k, v, n_heads, scales, scale=scale, plain=plain)
        return packed_mha_int8(q, k, v, n_heads, scale=scale, static_scales=scales, plain=plain)
    from llm_quest_tpu_torch.kernels.attention import packed_mha

    return packed_mha(q, k, v, n_heads, scale, plain=plain)


def merge_heads(x):
    """(b, h, s, d) → (b, s, h*d)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def split_heads(x, num_heads):
    """(b, s, h*d) → (b, h, s, d)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(1, 2)
