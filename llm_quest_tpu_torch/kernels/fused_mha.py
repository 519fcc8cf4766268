"""Int8-score packed MHA kernels (csrc/packed_mha_int8.cu) and their plain
PyTorch versions; named after ``llm_quest_tpu/kernels/fused_mha.py``.

- ``quantize_sym``: JAX's ``_quantize_sym``, per-tensor symmetric int8 with
  s = max|x| / 127 + 1e-12 (fp32) and clip(round(x / s)); rounding is half
  to even (``torch.round``, as ``jnp.round``).
- ``packed_mha_int8``: K8, bidirectional maskless MHA on packed (b, s, h·d)
  tensors with q and k quantized to int8 per tensor, dynamic scales or
  calibrated ``static_scales`` (q_s, k_s) (x · (1 / s), the reciprocal
  taken in double and cast to fp32); int32 scores times dq = q_s·k_s·scale
  in fp32, fp32 softmax, p cast to v's type for p·V, the fp32 denominator.
  Replaces ``packed_mha_int8`` (:405). Differentiable with JAX's
  straight-through backward (``_packed_int8_bwd``): autograd through the
  plain packed ``sdpa``, quantization taken as the identity.
- ``packed_mha_int8_inkernel``: K9, K8 with static scales and q/k quantized
  inside the kernel (replaces ``packed_mha_int8_inkernel`` :372); forward
  only, as JAX's: it raises where a gradient would be needed.

On a CUDA tensor the wrappers launch ``llmq_packed_mha_int8`` (one body for
both kernels, so K9 equals K8 with the same static scales bit for bit); K8's
quantization runs before it, as XLA's does before the Pallas kernel in JAX:
the max|x| reduction in torch, the quantization in ``llmq_quantize_int8``,
the scales kept on the device (no host sync). A CPU tensor runs the plain
version; ``plain=True`` forces it on any device (comparisons only). Each
wrapper counts its calls that launch the kernel in ``launches``; K8 also
counts those with static scales in ``static_launches``.
"""

import numpy as np
import torch

from llm_quest_tpu_torch.kernels import build
from llm_quest_tpu_torch.kernels.attention import (
    check_packed,
    check_packed_cuda,
    packed_mha_bwd_plain,
)
from llm_quest_tpu_torch.ops.attention import merge_heads, split_heads

MAX_SEQ = 1024  # the kernel holds a (32, s) fp32 score tile in shared memory


def _f32(x):
    """A Python float rounded to fp32, as JAX casts a weak-typed constant."""
    return float(np.float32(x))


def _round_clip(x32):
    return torch.round(x32).clamp_(-127, 127).to(torch.int8)


def dynamic_scale(x):
    """fp32 0-dim max|x| / 127 + 1e-12, on x's device (a true division, as
    JAX's; a divisor given as a Python number would be a reciprocal multiply
    on the card)."""
    amax = x.abs().amax().float()
    return amax / amax.new_full((), 127.0) + 1e-12


def quantize_sym(x):
    """Per-tensor symmetric int8 quantization; returns (int8, fp32 0-dim scale)."""
    s = dynamic_scale(x)
    return _round_clip(x.float() / s), s


def quantize_static(x, x_scale):
    """int8 of x at a calibrated scale: clip(round(x · (1 / s)))."""
    return _round_clip(x.float() * _f32(1.0 / x_scale))


def _scores_attention(qi, ki, v, n_heads, dq, out_dtype):
    """Attention from int8 q/k: int32 scores (exact in fp32: |q·k| ≤ 127²·128
    < 2²⁴) times the fp32 ``dq``, fp32 softmax with p cast to v's type for
    p·V and the fp32 denominator."""
    qh, kh, vh = (split_heads(t, n_heads).float() for t in (qi, ki, v))
    scores = (qh @ kh.transpose(-1, -2)) * dq
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    num = p.to(v.dtype).float() @ vh
    return merge_heads(num / p.sum(-1, keepdim=True)).to(out_dtype)


def packed_mha_int8_plain(q, k, v, n_heads, scale, static_scales=None):
    """The plain version of K8 (and, with static scales, of K9)."""
    if static_scales is None:
        (qi, qs), (ki, ks) = quantize_sym(q), quantize_sym(k)
        dq = qs * ks * scale
    else:
        q_s, k_s = static_scales
        qi, ki = quantize_static(q, q_s), quantize_static(k, k_s)
        dq = _f32(q_s * k_s * scale)
    return _scores_attention(qi, ki, v, n_heads, dq, q.dtype)


def _check_cuda(q, k, v, n_heads):
    check_packed_cuda(q, k, v, n_heads)
    build.require(q.shape[1] <= MAX_SEQ, f"s must be at most {MAX_SEQ}, got {q.shape[1]}")
    build.require(all(t.is_contiguous() for t in (q, k, v)), "q/k/v must be contiguous")
    build.dtype_code(q)


def _quantize(x, *, scale=None, inv=0.0):
    """int8 of x by llmq_quantize_int8: x / scale (a device fp32 0-dim) or x · inv."""
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    build.launch("llmq_quantize_int8", build.dtype_code(x), x.data_ptr(), out.data_ptr(), x.numel(),
                 None if scale is None else scale.data_ptr(), float(inv), build.stream_of(x))
    return out


def _launch(q, k, v, n_heads, *, quant_in, dyn_scales=None, dq_static=0.0, inv_q=0.0, inv_k=0.0, scale=0.0):
    b, s, hd = v.shape
    o = torch.empty_like(v)
    build.launch(
        "llmq_packed_mha_int8", build.dtype_code(v), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(quant_in), None if dyn_scales is None else dyn_scales.data_ptr(), float(dq_static), float(inv_q),
        float(inv_k), float(scale), b, s, n_heads, hd // n_heads, build.stream_of(v),
    )
    return o


def _int8_fwd(q, k, v, n_heads, scale, static_scales):
    """K8 on the card: quantize q and k, then the kernel."""
    if static_scales is None:
        scales = torch.stack((dynamic_scale(q), dynamic_scale(k)))  # (q_s, k_s) fp32, on the device
        qi, ki = _quantize(q, scale=scales[0]), _quantize(k, scale=scales[1])
        o = _launch(qi, ki, v, n_heads, quant_in=False, dyn_scales=scales, scale=_f32(scale))
        del scales  # freed to the caching allocator: only later work on this stream reuses it
    else:
        q_s, k_s = static_scales
        qi, ki = _quantize(q, inv=_f32(1.0 / q_s)), _quantize(k, inv=_f32(1.0 / k_s))
        o = _launch(qi, ki, v, n_heads, quant_in=False, dq_static=_f32(q_s * k_s * scale))
        packed_mha_int8.static_launches += 1
    packed_mha_int8.launches += 1
    return o


class _PackedMHAInt8(torch.autograd.Function):
    """K8 forward (kernel or plain), straight-through backward."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale, static_scales, on_card):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads, ctx.scale = n_heads, scale
        if on_card:
            return _int8_fwd(q, k, v, n_heads, scale, static_scales)
        return packed_mha_int8_plain(q, k, v, n_heads, scale, static_scales)

    @staticmethod
    def backward(ctx, do):
        return *packed_mha_bwd_plain(*ctx.saved_tensors, do, ctx.n_heads, ctx.scale), None, None, None, None


def packed_mha_int8(q, k, v, n_heads, scale=None, static_scales=None, *, plain=False):
    """Int8-score packed MHA (module docstring). q/k/v: packed (b, s, h·d);
    static_scales: optional calibrated (q_scale, k_scale) floats. Returns
    (b, s, h·d) in q's dtype; differentiable (straight-through)."""
    check_packed(q, k, v, n_heads)
    if scale is None:
        scale = (q.shape[2] // n_heads) ** -0.5
    scale = float(scale)
    static_scales = None if static_scales is None else tuple(float(x) for x in static_scales)
    on_card = q.is_cuda and not plain
    if on_card:
        _check_cuda(q, k, v, n_heads)
    if build.needs_grad(q, k, v):
        return _PackedMHAInt8.apply(q, k, v, n_heads, scale, static_scales, on_card)
    if on_card:
        return _int8_fwd(q, k, v, n_heads, scale, static_scales)
    return packed_mha_int8_plain(q, k, v, n_heads, scale, static_scales)


packed_mha_int8.launches = 0
packed_mha_int8.static_launches = 0


def packed_mha_int8_inkernel(q, k, v, n_heads, static_scales, scale=None, *, plain=False):
    """K9: int8-score packed MHA with calibrated ``static_scales`` (q_scale,
    k_scale), q/k quantized inside the kernel. Forward only: raises
    ``NotImplementedError`` where a gradient would be needed (JAX's has no
    VJP)."""
    check_packed(q, k, v, n_heads)
    if build.needs_grad(q, k, v):
        raise NotImplementedError("packed_mha_int8_inkernel is forward only; packed_mha_int8 has a gradient")
    if scale is None:
        scale = (q.shape[2] // n_heads) ** -0.5
    q_s, k_s = (float(x) for x in static_scales)
    if plain or not q.is_cuda:
        return packed_mha_int8_plain(q, k, v, n_heads, float(scale), (q_s, k_s))
    _check_cuda(q, k, v, n_heads)
    o = _launch(q, k, v, n_heads, quant_in=True, dq_static=_f32(q_s * k_s * float(scale)),
                inv_q=_f32(1.0 / q_s), inv_k=_f32(1.0 / k_s))
    packed_mha_int8_inkernel.launches += 1
    return o


packed_mha_int8_inkernel.launches = 0
