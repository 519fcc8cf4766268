"""Short-sequence and int8-score MHA kernels (csrc/fused_mha.cu,
csrc/fused_mha_tc.cu, csrc/packed_mha_int8.cu, csrc/packed_mha_int8_tc.cu)
and their plain PyTorch versions; named after
``llm_quest_tpu/kernels/fused_mha.py``.

- ``fused_mha``: K6, maskless attention over (b, h, s, d) heads with equal
  q and k/v head counts, 1 <= s <= ``MAX_SEQ``, optionally causal; replaces
  ``fused_mha`` (:139, kernel :41). fp32 inputs take the SIMT kernel of
  ``csrc/fused_mha.cu`` (its rows' whole score rows in shared memory, the
  exact two-pass softmax), bf16 inputs the tensor-core kernel of
  ``csrc/fused_mha_tc.cu`` (the head's K and V on chip, 128-key score chunks
  with one online rescale each; it also runs K7's bf16 forward), counted in
  ``tc_launches``; both sum the unnormalised p as p·V sees it, rounded to
  v's type, for the denominator (the TPU kernel's ones column). Differentiable: on a CUDA tensor
  that needs a gradient the forward also writes the row logsumexp and the
  backward is the flash recompute backward (``llmq_attention_bwd``: the
  exact ``sdpa`` gradient that JAX's ``_fused_diff_bwd``, :116-136, takes
  through XLA), counted in ``bwd_launches`` (``causal_bwd_launches``,
  ``tc_bwd_launches``). Plain version: ``ops/attention.py::sdpa`` with an
  optional causal mask, differentiated by autograd.
- ``quantize_sym``: JAX's ``_quantize_sym``, per-tensor symmetric int8 with
  s = max|x| / 127 + 1e-12 (fp32) and clip(round(x / s)); rounding is half
  to even (``torch.round``, as ``jnp.round``).
- ``packed_mha_int8``: K8, bidirectional maskless MHA on packed (b, s, h·d)
  tensors with q and k quantized to int8 per tensor, dynamic scales or
  calibrated ``static_scales`` (q_s, k_s) (x · (1 / s), the reciprocal
  taken in double and cast to fp32); int32 scores times dq = q_s·k_s·scale
  in fp32, fp32 softmax, p cast to v's type for p·V, the fp32 denominator.
  Replaces ``packed_mha_int8`` (:405). Differentiable with JAX's
  straight-through backward (``_packed_int8_bwd``): the exact packed
  ``sdpa`` gradient, quantization taken as the identity; on a CUDA tensor
  K7's forward recovers the softmax's output and lse and the flash
  recompute kernels take the gradients (``attention.packed_mha_bwd_launch``,
  counted in ``bwd_launches`` and ``tc_bwd_launches``), on a CPU tensor
  autograd through the plain version.
- ``packed_mha_int8_inkernel``: K9, K8 with static scales and q/k quantized
  inside the kernel (replaces ``packed_mha_int8_inkernel`` :372); forward
  only, as JAX's: it raises where a gradient would be needed.

On a CUDA tensor the int8 wrappers launch ``llmq_packed_mha_int8``, which
takes q, k and v in their own type and quantizes q and k inside the kernel
in all three modes (x / s for K8's dynamic scales, x · (1 / s) for static
ones), so K9 and K8 with the same static scales are one call and agree bit
for bit, and int8 q and k never reach device memory. bf16 inputs take the
tensor-core kernel of ``csrc/packed_mha_int8_tc.cu`` (s8 ``wgmma`` scores,
the exact two-pass softmax from each row's integer max, bf16 p·V), counted
in ``tc_launches``; fp32 inputs the SIMT kernel of ``csrc/packed_mha_int8.cu``.
q/k/v are read at their strides (a contiguous last dim; in bf16 strides
that are multiples of 8 and a 16-byte aligned start, else ValueError). K8's
dynamic scales are the one step outside the kernel, as XLA's reduction is
in JAX: one max|x| reduction each in torch, kept on the device (no host
sync). A CPU tensor runs the plain version; ``plain=True`` forces it on any
device (comparisons only). Each wrapper counts its calls that launch the
kernel in ``launches``; K8 also counts those with static scales in
``static_launches``, K6 the causal ones in ``causal_launches`` and its
backward as above.
"""

import numpy as np
import torch

from llm_quest_tpu_torch.kernels import build
from llm_quest_tpu_torch.kernels.attention import (
    MAX_SEQ,
    _bwd_launch,
    _check_tc,
    _plain_lse,
    check_packed,
    check_packed_cuda,
    launch_fused_mha,
    packed_mha_bwd_launch,
    packed_mha_bwd_plain,
    short_lse,
)
from llm_quest_tpu_torch.ops.attention import merge_heads, sdpa, split_heads
from llm_quest_tpu_torch.ops.masks import causal_mask

FUSED_HEAD_DIMS = (32, 64, 128)  # the head dims csrc/fused_mha.cu and csrc/fused_mha_tc.cu are built for


def fused_mha_plain(q, k, v, *, causal=False, scale=None):
    """``sdpa`` with an optional causal mask: K6's plain version."""
    mask = causal_mask(q.shape[2], device=q.device) if causal else None
    return sdpa(q, k, v, mask=mask, scale=scale)


def fused_mha_lse_plain(q, k, *, causal=False, scale=None):
    """The fp32 (b, h, s) row logsumexp of ``fused_mha_plain``'s scaled
    (causally masked) scores: the plain version of the lse K6's forward
    keeps for its backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _plain_lse(q, k, None, causal, 0, scale)


def _fused_fwd(q, k, v, causal, scale, with_lse):
    """K6's forward; returns (out, the fp32 row lse or None)."""
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = short_lse(o, with_lse)
    tc = launch_fused_mha(q, k, v, o, lse, causal=causal, fp32_den=False, scale=scale)
    fused_mha.launches += 1
    fused_mha.tc_launches += tc
    fused_mha.causal_launches += int(causal)
    return o, lse


class _FusedMHA(torch.autograd.Function):
    """K6 forward, keeping its lse; the flash recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _fused_fwd(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv, *_, tc = _bwd_launch(q, k, v, o, lse, do, None, ctx.causal, 0, ctx.scale, None, None, None)
        fused_mha.bwd_launches += 1
        fused_mha.tc_bwd_launches += tc
        fused_mha.causal_bwd_launches += int(ctx.causal)
        return dq, dk, dv, None, None


def fused_mha(q, k, v, *, causal=False, scale=None, plain=False):
    """Short-sequence fused MHA (K6). q/k/v: (b, h, s, d), equal head
    counts, a contiguous last dim; the kernel takes d in ``FUSED_HEAD_DIMS``
    and s <= ``MAX_SEQ``. Returns (b, h, s, d) in q's dtype; differentiable
    in q, k and v (recompute backward)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return fused_mha_plain(q, k, v, causal=causal, scale=scale)
    b, h, s, d = q.shape
    build.require(k.shape == q.shape and v.shape == q.shape, "fused_mha takes q/k/v of one (b, h, s, d) shape")
    build.require(d in FUSED_HEAD_DIMS, f"fused_mha head dims are {FUSED_HEAD_DIMS}, got {d}")
    build.require(1 <= s <= MAX_SEQ, f"fused_mha takes 1 <= s <= {MAX_SEQ}, got {s}")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    build.require_cuda(q, k, v)
    build.dtype_code(q)
    if q.dtype == torch.bfloat16:
        _check_tc(q, k, v)
    if build.needs_grad(q, k, v):
        return _FusedMHA.apply(q, k, v, bool(causal), float(scale))
    return _fused_fwd(q, k, v, bool(causal), float(scale), with_lse=False)[0]


fused_mha.launches = 0
fused_mha.causal_launches = 0  # the causal ones among them
fused_mha.tc_launches = 0  # the ones that took the tensor-core kernel
fused_mha.bwd_launches = 0  # backward launches (the flash backward kernels, counted here)
fused_mha.causal_bwd_launches = 0
fused_mha.tc_bwd_launches = 0


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
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    build.dtype_code(q)
    if q.dtype == torch.bfloat16:
        _check_tc(q, k, v)


def dynamic_scales(q, k):
    """(q_s, k_s): ``dynamic_scale`` of q and of k as one fp32 (2,) tensor on
    their device, from one max|x| reduction each (exact, as ``amax``)."""
    amax = torch.stack([torch.linalg.vector_norm(t, float("inf"), dtype=torch.float32) for t in (q, k)])
    return amax / amax.new_full((2,), 127.0) + 1e-12


def _tc_calls():
    """The library's count of calls that launched the bf16 tensor-core kernel."""
    return build.library().cdll.llmq_packed_mha_int8_tc_launches()


def _launch(q, k, v, n_heads, *, dyn_scales=None, dq_static=0.0, inv_q=0.0, inv_k=0.0, scale=0.0):
    """``llmq_packed_mha_int8`` on checked packed q/k/v: q and k quantized in
    the kernel by x / ``dyn_scales`` (a device fp32 (2,) tensor) or x · inv.
    Returns (out, 1 if the call took the tensor-core kernel else 0)."""
    b, s, hd = v.shape
    o = torch.empty(b, s, hd, dtype=v.dtype, device=v.device)
    before = _tc_calls()
    build.launch(
        "llmq_packed_mha_int8", build.dtype_code(v), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if dyn_scales is None else dyn_scales.data_ptr(), float(dq_static), float(inv_q), float(inv_k),
        float(scale), b, s, n_heads, hd // n_heads,
        *(st for t in (q, k, v, o) for st in split_heads(t, n_heads).stride()[:3]), build.stream_of(v),
    )
    return o, _tc_calls() - before


def _static_args(static_scales, scale):
    """The kernel's static-scale arguments, as JAX folds them: dq = q_s · k_s
    · scale and the reciprocals, each rounded to fp32."""
    q_s, k_s = static_scales
    return {"dq_static": _f32(q_s * k_s * scale), "inv_q": _f32(1.0 / q_s), "inv_k": _f32(1.0 / k_s)}


def _int8_fwd(q, k, v, n_heads, scale, static_scales):
    """K8 on the card: the dynamic scales reduced (no host sync), then the kernel."""
    if static_scales is None:
        scales = dynamic_scales(q, k)
        o, tc = _launch(q, k, v, n_heads, dyn_scales=scales, scale=_f32(scale))
        del scales  # freed to the caching allocator: only later work on this stream reuses it
    else:
        o, tc = _launch(q, k, v, n_heads, **_static_args(static_scales, scale))
        packed_mha_int8.static_launches += 1
    packed_mha_int8.launches += 1
    packed_mha_int8.tc_launches += tc
    return o


class _PackedMHAInt8(torch.autograd.Function):
    """K8 forward (kernel or plain), JAX's straight-through backward: the
    exact ``sdpa`` gradient, quantization taken as the identity. On the card
    K7's forward recovers the bf16 (or fp32) softmax's output and row lse,
    and the flash recompute kernels take the gradients in the packed layout."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale, static_scales, on_card):
        ctx.save_for_backward(q, k, v)
        ctx.n_heads, ctx.scale, ctx.on_card = n_heads, scale, on_card
        if on_card:
            return _int8_fwd(q, k, v, n_heads, scale, static_scales)
        return packed_mha_int8_plain(q, k, v, n_heads, scale, static_scales)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if not ctx.on_card:
            return *packed_mha_bwd_plain(q, k, v, do, ctx.n_heads, ctx.scale), None, None, None, None
        grads, tc = packed_mha_bwd_launch(q, k, v, do, ctx.n_heads, ctx.scale)
        packed_mha_int8.bwd_launches += 1
        packed_mha_int8.tc_bwd_launches += tc
        return *grads, None, None, None, None


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
packed_mha_int8.tc_launches = 0  # the launches that took the tensor-core kernel
packed_mha_int8.bwd_launches = 0  # backward launches (K7's forward and the flash backward kernels, counted here)
packed_mha_int8.tc_bwd_launches = 0  # the tensor-core ones among them


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
    static_scales = tuple(float(x) for x in static_scales)
    if plain or not q.is_cuda:
        return packed_mha_int8_plain(q, k, v, n_heads, float(scale), static_scales)
    _check_cuda(q, k, v, n_heads)
    o, tc = _launch(q, k, v, n_heads, **_static_args(static_scales, float(scale)))
    packed_mha_int8_inkernel.launches += 1
    packed_mha_int8_inkernel.tc_launches += tc
    return o


packed_mha_int8_inkernel.launches = 0
packed_mha_int8_inkernel.tc_launches = 0  # the launches that took the tensor-core kernel
