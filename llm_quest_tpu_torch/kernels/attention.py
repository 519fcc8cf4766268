"""Attention kernels (csrc/attention.cu, csrc/attention_tc.cu) and their
plain PyTorch versions.

Dtype routing, for K4, K5 and K7 alike: the C entry points
``llmq_attention_fwd`` / ``llmq_attention_bwd`` send bf16 inputs to the
tensor-core kernels of ``csrc/attention_tc.cu`` (wgmma, bf16 operands, fp32
accumulators; p and ds become bf16 operands of their products) and fp32
inputs to the SIMT kernels of ``csrc/attention.cu`` (every product in fp32).
A bf16 call the tensor-core kernels cannot take (a stride that is no
multiple of 8 elements, an unaligned start, a (d, dv) pair they are not
built for) raises before any launch; nothing falls back. Each wrapper counts
in ``tc_launches`` beside ``launches`` (K5's backward in ``tc_bwd_launches``)
the calls that the library itself counted as tensor-core launches
(``llmq_attention_tc_launches``, and ``llmq_fused_mha_tc_launches`` for the
short-sequence kernel), so a call the C side routed elsewhere does not
count.

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
  projections (h·d % 128 == 0, d ∈ {32, 64, 128}), read and written by
  stride; replaces ``llm_quest_tpu/kernels/fused_mha.py::packed_mha``. bf16
  inputs take K6's short-sequence tensor-core kernel (``csrc/fused_mha_tc.cu``
  through ``llmq_fused_mha``, with the fp32 sum of p as the denominator, as
  JAX's kernel), fp32 inputs the SIMT flash forward of ``csrc/attention.cu``.
  Plain version: split heads, ``sdpa``, merge heads. Differentiable: on a
  CUDA tensor that needs a gradient it is a ``torch.autograd.Function``
  whose forward also writes the row logsumexp and whose backward is the
  flash recompute backward (``llmq_attention_bwd``, the exact ``sdpa``
  gradient that JAX's ``_packed_bwd`` takes through XLA), its gradients
  written in the packed layout; counted in ``bwd_launches`` and
  ``tc_bwd_launches``. ``packed_mha_bwd_plain`` is the plain version of that
  backward (and of the int8 kernel's straight-through backward, which runs
  on the card through ``packed_mha_bwd_launch``).
- ``flash_attention_with_lse``: K5, K4's forward returning the fp32 row
  logsumexp beside the output, causal or not, with no mask, window, softcap
  or sinks; replaces
  ``llm_quest_tpu/kernels/flash_attention.py::flash_attention_with_lse``
  (custom VJP :593-624). Differentiable through both outputs: on a CUDA
  tensor a ``torch.autograd.Function`` whose backward is K4's recompute
  kernels with the lse cotangent as ``delta_shift`` (JAX's
  ``_flash_lse_bwd``; d lse / d s = p). No CUDA source of its own: it is K4
  at the arguments the ring of ``parallel/sequence.py`` gives it, counted
  apart (``launches`` forward, ``bwd_launches`` backward, and the causal
  ones among them in ``causal_launches`` and ``causal_bwd_launches``) so a
  run can tell the ring's launches from the local attention's. Plain
  version: the plain K4 forward and ``_plain_lse``, differentiated by
  autograd.

Where the router (``ops/attention.py``) sends a call: K4 for long causal or
windowed calls, K7 (through ``mha_packed``) for the vision towers' packed
heads, and K5 only inside the context-parallel ring, which the router takes
under ``cfg["context_parallel"] = {"group": ProcessGroup}`` (the port's
form of JAX's ``{"mesh", "axis"}``, ``parallel/mesh.py``); the maskless
short-sequence calls go to K6 (``kernels/fused_mha.py``).

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
MAX_SEQ = 1024  # the short-sequence kernels' longest sequence (K6, K8, K9, and K7 in bf16)


def _check_tc(*tensors):
    """What the bf16 tensor-core kernels add: their TMA tensor maps need
    every (batch, head, seq) stride a multiple of 16 bytes (8 elements) and
    a 16-byte aligned start. Raises ValueError."""
    for t in tensors:
        build.require(t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]),
                      "bf16 kernel operands need strides that are multiples of 8 and a 16-byte aligned start")


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
    if q.dtype == torch.bfloat16:
        _check_tc(q, k, v)


def _mask_arg(key_mask):
    """(uint8 mask kept alive by the caller, pointer, row stride) of a (b, sk) key mask."""
    if key_mask is None:
        return None, None, 0
    m = key_mask.to(torch.uint8).contiguous()
    return m, m.data_ptr(), m.shape[1]


def _tc_calls():
    """The library's count of calls that launched the bf16 tensor-core
    kernels, kept where the C entry points launch them."""
    return build.library().cdll.llmq_attention_tc_launches()


def _launch_fwd(q, k, v, o, lse, key_mask, *, causal, q_start, scale, qs, ks, vs, os_, dims,
                window_size=None, softcap=None, sink=None):
    """q/k/v/o strides are (batch, head, seq) triples; dims = (b, hq, hkv, sq, sk, d, dv);
    lse: contiguous fp32 (b, hq, sq) or None. Returns 1 if the call took the
    tensor-core kernels, else 0."""
    b, hq, hkv, sq, sk, d, dv = dims
    mask, mask_ptr, mask_sb = _mask_arg(key_mask)
    sink32 = None if sink is None else sink.float().contiguous()
    tc_before = _tc_calls()
    build.launch(
        "llmq_attention_fwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(), mask_ptr,
        b, hq, hkv, sq, sk, d, dv, *qs, *ks, *vs, *os_, mask_sb,
        int(causal), int(q_start), float(scale), int(window_size or 0), float(softcap or 0.0),
        None if sink32 is None else sink32.data_ptr(), build.stream_of(q),
    )
    del mask, sink32  # freed to the caching allocator: only later work on this stream reuses them
    return _tc_calls() - tc_before


def _flash_fwd(q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap, with_lse):
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    o = torch.empty(b, hq, sq, dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device) if with_lse else None
    tc = _launch_fwd(
        q, k, v, o, lse, key_mask, causal=causal, q_start=q_start, scale=scale,
        qs=q.stride()[:3], ks=k.stride()[:3], vs=v.stride()[:3], os_=o.stride()[:3],
        dims=(b, hq, hkv, sq, sk, d, dv), window_size=window_size, softcap=softcap, sink=sink,
    )
    return o, lse, tc


def _k4_fwd(q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap, with_lse):
    """K4's forward, counted in ``flash_attention``'s counters."""
    o, lse, tc = _flash_fwd(q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap, with_lse)
    flash_attention.launches += 1
    flash_attention.tc_launches += tc
    flash_attention.window_launches += int(window_size is not None)
    flash_attention.softcap_sink_launches += int(softcap is not None or sink is not None)
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """K4 forward + recompute backward; saves q, k, v, o, the fp32 lse and the sink."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap):
        o, lse = _k4_fwd(q, k, v, key_mask, sink, causal, q_start, scale, window_size, softcap, with_lse=True)
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
    return _k4_fwd(q, k, v, attn_mask, sink, causal, q_start, scale, window_size, softcap, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.tc_launches = 0  # the launches that took the tensor-core kernels
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


def _bwd_launch(q, k, v, o, lse, do, attn_mask, causal, q_start, scale, window_size, softcap, delta_shift,
                grads=None):
    """``llmq_attention_bwd`` on checked q/k/v; returns (dq, dk, dv, δ, the
    fp32 shift or None, 1 if the call took the tensor-core kernels else 0).
    ``o``: the forward's output (δ = rowsum(dO ⊙ O) is taken in fp32).
    ``grads``: the (dq, dk, dv) tensors to write, any (batch, head, seq)
    strides with a contiguous last dim (K7's packed views); contiguous new
    ones when None."""
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    build.require(do.shape == (b, hq, sq, dv) and o.shape == do.shape, "do and o must be (b, hq, sq, dv)")
    build.require(do.dtype == q.dtype, "do must have q's dtype")
    build.require(
        lse.shape == (b, hq, sq) and lse.dtype == torch.float32 and lse.is_contiguous(),
        "lse must be contiguous fp32 (b, hq, sq)",
    )
    build.require_cuda(q, o, lse, do, *(() if delta_shift is None else (delta_shift,)))
    if do.stride(-1) != 1 or any(st % 8 for st in do.stride()[:-1]) or do.data_ptr() % 16:
        do = do.contiguous()
    delta = (do.float() * o).sum(-1).contiguous()  # (b, hq, sq), the products in fp32
    shift = None
    if delta_shift is not None:
        build.require(delta_shift.shape == (b, hq, sq), "delta_shift must be (b, hq, sq)")
        shift = delta_shift.float().contiguous()
    if grads is None:
        grads = (torch.empty(b, hq, sq, d, dtype=q.dtype, device=q.device),
                 torch.empty(b, hkv, sk, d, dtype=q.dtype, device=q.device),
                 torch.empty(b, hkv, sk, dv, dtype=q.dtype, device=q.device))
    dq, dk, dv_grad = grads
    mask, mask_ptr, mask_sb = _mask_arg(attn_mask)
    tc_before = _tc_calls()
    build.launch(
        "llmq_attention_bwd", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if shift is None else shift.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv_grad.data_ptr(), mask_ptr,
        b, hq, hkv, sq, sk, d, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv_grad.stride()[:3], mask_sb,
        int(causal), int(q_start), float(scale), int(window_size or 0), float(softcap or 0.0), build.stream_of(q),
    )
    del mask
    return dq, dk, dv_grad, delta, shift, _tc_calls() - tc_before


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
    dq, dk, dv_grad, delta, shift, tc = _bwd_launch(q, k, v, o, lse, do, attn_mask, causal, q_start, scale,
                                                    window_size, softcap, delta_shift)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tc_launches += tc
    flash_attention_bwd.window_launches += int(window_size is not None)
    flash_attention_bwd.softcap_sink_launches += int(softcap is not None or sink is not None)
    if sink is None:
        return dq, dk, dv_grad
    # the sink's probability exp(sink - lse) times d out / d sink = -out: a reduction over batch and rows
    shifted = delta if shift is None else delta - shift
    dsink = -(torch.exp(sink.float()[None, :, None] - lse) * shifted).sum((0, 2))
    return dq, dk, dv_grad, dsink.to(sink.dtype)


flash_attention_bwd.launches = 0
flash_attention_bwd.tc_launches = 0
flash_attention_bwd.window_launches = 0
flash_attention_bwd.softcap_sink_launches = 0


def flash_attention_with_lse_plain(q, k, v, *, causal=False, scale=None):
    """(out, fp32 row logsumexp) of the plain version, differentiable in both
    by autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out = flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return out, _plain_lse(q, k, None, causal, 0, scale)


class _FlashAttentionLse(torch.autograd.Function):
    """K5: K4's forward keeping its lse as an output; the backward is K4's
    recompute kernels with the lse cotangent as the per-row shift (JAX's
    ``_flash_lse_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _lse_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv, _, _, tc = _bwd_launch(q, k, v, o, lse, do, None, ctx.causal, 0, ctx.scale, None, None, dlse)
        flash_attention_with_lse.bwd_launches += 1
        flash_attention_with_lse.tc_bwd_launches += tc
        flash_attention_with_lse.causal_bwd_launches += int(ctx.causal)
        return dq, dk, dv, None, None


def _lse_fwd(q, k, v, causal, scale):
    """K4's forward with its lse, counted in ``flash_attention_with_lse``'s counters."""
    o, lse, tc = _flash_fwd(q, k, v, None, None, causal, 0, scale, None, None, with_lse=True)
    flash_attention_with_lse.launches += 1
    flash_attention_with_lse.tc_launches += tc
    flash_attention_with_lse.causal_launches += int(causal)
    return o, lse


def flash_attention_with_lse(q, k, v, *, causal=False, scale=None, plain=False):
    """Attention that also returns its row logsumexp, differentiable through
    both (K5). q: (b, hq, s, d); k: (b, hkv, s, d); v: (b, hkv, s, dv); the
    kernel takes the (d, dv) pairs of ``HEAD_DIMS``; no mask, window, softcap
    or sinks (JAX's signature). Returns (out (b, hq, s, dv) in q's dtype, lse
    (b, hq, s) fp32): two blocks of keys combine exactly through it
    (``parallel/sequence.py::ring_flash_attention``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return flash_attention_with_lse_plain(q, k, v, causal=causal, scale=scale)
    _check(q, k, v, None, causal, 0)
    if build.needs_grad(q, k, v):
        return _FlashAttentionLse.apply(q, k, v, bool(causal), float(scale))
    return _lse_fwd(q, k, v, bool(causal), float(scale))


flash_attention_with_lse.launches = 0  # forward launches
flash_attention_with_lse.bwd_launches = 0  # backward launches (K4's backward kernels, counted here)
flash_attention_with_lse.causal_launches = 0  # the causal ones among them
flash_attention_with_lse.causal_bwd_launches = 0
flash_attention_with_lse.tc_launches = 0  # the tensor-core ones among the forward launches
flash_attention_with_lse.tc_bwd_launches = 0  # and among the backward launches


def packed_mha_plain(q, k, v, n_heads, scale=None):
    out = sdpa(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads), scale=scale)
    return merge_heads(out)


def packed_mha_lse_plain(q, k, n_heads, scale=None):
    """The fp32 (b, h, s) row logsumexp of ``packed_mha_plain``'s scaled
    scores: the plain version of the lse K7's forward keeps for its
    backward."""
    if scale is None:
        scale = (q.shape[2] // n_heads) ** -0.5
    return _plain_lse(split_heads(q, n_heads), split_heads(k, n_heads), None, False, 0, scale)


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


def launch_fused_mha(q, k, v, o, lse, *, causal, fp32_den, scale):
    """``llmq_fused_mha`` on checked (b, h, s, d) q/k/v and the output ``o``,
    any (batch, head, seq) strides with a contiguous last dim: fp32 on K6's
    SIMT kernel, bf16 on the short-sequence tensor-core kernel, whose
    denominator sums the fp32 p (``fp32_den``, K7's) or the p rounded to
    bf16 (K6's). ``lse``: contiguous fp32 (b, h, s) to write, or None.
    Returns 1 if the call took the tensor-core kernel, else 0."""
    b, h, s, d = q.shape
    lib = build.library().cdll
    before = lib.llmq_fused_mha_tc_launches()
    build.launch(
        "llmq_fused_mha", build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b, h, s, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], int(causal), int(fp32_den), float(scale),
        build.stream_of(q),
    )
    return lib.llmq_fused_mha_tc_launches() - before


def short_lse(o, with_lse):
    """The fp32 (b, h, s) row lse K6's and K7's forward write beside ``o``
    (b, h, s, d) when a gradient is needed, else None."""
    b, h, s, _ = o.shape
    return torch.empty(b, h, s, dtype=torch.float32, device=o.device) if with_lse else None


def _packed_launch(q, k, v, n_heads, scale, with_lse):
    """K7's forward on the (b, h, s, d) views of the packed tensors, not
    counted; returns (out (b, s, h·d), the fp32 (b, h, s) row lse or None,
    1 if the call took the tensor-core kernel else 0)."""
    b, s, hd = q.shape
    d = hd // n_heads
    o = torch.empty(b, s, hd, dtype=q.dtype, device=q.device)
    qh, kh, vh, oh = (split_heads(t, n_heads) for t in (q, k, v, o))
    lse = short_lse(oh, with_lse)
    if q.dtype == torch.bfloat16:
        tc = launch_fused_mha(qh, kh, vh, oh, lse, causal=False, fp32_den=True, scale=scale)
    else:
        tc = _launch_fwd(
            qh, kh, vh, oh, lse, None, causal=False, q_start=0, scale=scale,
            qs=qh.stride()[:3], ks=kh.stride()[:3], vs=vh.stride()[:3], os_=oh.stride()[:3],
            dims=(b, n_heads, n_heads, s, s, d, d),
        )
    return o, lse, tc


def _packed_fwd(q, k, v, n_heads, scale, with_lse):
    """K7's forward, counted; returns (out (b, s, h·d), the fp32 (b, h, s)
    row lse or None)."""
    o, lse, tc = _packed_launch(q, k, v, n_heads, scale, with_lse)
    packed_mha.launches += 1
    packed_mha.tc_launches += tc
    return o, lse


def packed_mha_bwd_launch(q, k, v, do, n_heads, scale, o=None, lse=None):
    """The recompute backward of packed MHA on the card (the flash backward
    kernels, gradients written in the packed layout): K7's, from its forward's
    output and lse, and, with ``o`` and ``lse`` None, K8's straight-through
    one, which first runs K7's forward (not counted in ``packed_mha``) for
    the softmax's output and lse. Returns ((dq, dk, dv), 1 if every launch
    took the tensor-core kernels else 0)."""
    tc_fwd = 1
    if o is None:
        o, lse, tc_fwd = _packed_launch(q, k, v, n_heads, scale, with_lse=True)
    grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    *_, tc = _bwd_launch(*(split_heads(t, n_heads) for t in (q, k, v, o)), lse, split_heads(do, n_heads), None,
                         False, 0, scale, None, None, None, grads=tuple(split_heads(g, n_heads) for g in grads))
    return grads, tc * tc_fwd


class _PackedMHA(torch.autograd.Function):
    """K7 forward, keeping its lse; the flash recompute backward, writing the
    gradients in the packed layout."""

    @staticmethod
    def forward(ctx, q, k, v, n_heads, scale):
        o, lse = _packed_fwd(q, k, v, n_heads, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.n_heads, ctx.scale = n_heads, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads, tc = packed_mha_bwd_launch(q, k, v, do, ctx.n_heads, ctx.scale, o, lse)
        packed_mha.bwd_launches += 1
        packed_mha.tc_bwd_launches += tc
        return *grads, None, None


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
    if q.dtype == torch.bfloat16:  # the short-sequence kernel
        build.require(q.shape[1] <= MAX_SEQ, f"packed_mha takes s <= {MAX_SEQ} in bf16, got {q.shape[1]}")
        _check_tc(q, k, v)
    if build.needs_grad(q, k, v):
        return _PackedMHA.apply(q, k, v, n_heads, float(scale))
    return _packed_fwd(q, k, v, n_heads, float(scale), with_lse=False)[0]


packed_mha.launches = 0
packed_mha.tc_launches = 0  # the forward launches that took the tensor-core kernel
packed_mha.bwd_launches = 0  # backward launches (the flash backward kernels, counted here)
packed_mha.tc_bwd_launches = 0  # the tensor-core ones among them
