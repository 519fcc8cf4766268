#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``llm_quest_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the port's
kernels from ``llm_quest_tpu_torch/csrc`` at first use. Nine main paths are
driven: the ViT-B/224 encode of bench.py's ViT cell (through K7, K8 and K9),
Qwen3.5-0.8B generation, the dense Qwen3 training step of bench.py's train
workload, the Qwen3-Next hybrid training step of
``scripts/bench_hybrid_training.py``, the Gemma-3 sliding-window training
step at Gemma-3-270M's widths, the MiMo-V2-Flash training step of
``scripts/mimo_training.py`` at ``MIMO_V2_SMALL_CONFIG``, the DeepSeek-V3
MTP training step of ``scripts/deepseek_training.py`` at
``DEEPSEEK_SMALL_CONFIG`` (and its cached generation), int8 Qwen3.5-0.8B
text generation and int8 Qwen3-Next cached decode. Phases, one JSON line
each on stdout:

1. device: the card's name and the kernels' build time;
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, fp32 and bf16, with the tolerances below, and the time of both
   versions at its main path's shape. K1's forward covers dk 64 and 128 and
   the hybrid step's shape (b 4, h 8, s 2048, dk = dv = 64, bf16). K1's
   backward is held to its plain version (the per-chunk replay) on the
   kernel's own anchors — dk 64 and 128, s 300 (a partial last chunk),
   prev_state on and off, a nonzero final-state cotangent, and in bf16 the
   hybrid step's shape — and through autograd to autograd of the plain
   chunked form; forward + backward are timed at the hybrid step's shape.
   The flash backward's dq/dk/dv are held to autograd through the plain
   ``sdpa`` (d 64/128/256, key mask on/off, GQA 16/8 and 8/2; and, in bf16,
   one layer of the dense train step at b = 4, s = 2048, output included)
   and timed forward + backward at that shape and at b = 1. K10 (int8 flash
   decode) at the int8 decode shape, a long context and Qwen3's head dim;
   K11 (int8 grouped matmul) at Qwen3-Next-small's decode and prefill
   shapes, both row tilings, and a sweep of both tilings from T 32 to 512;
   K2 also at dk 64. K4 at one Gemma-3-270M layer (b 4, q/kv heads 4/1,
   d 256, s 2048), fp32 and bf16, forward and forward + backward, each with
   window 512 and causal, and softcap 30 with sinks (dsink checked); then
   ``k4_window_ratio``: the windowed times at most 0.6x the causal ones.
   K4 with v's head dim 32 beside q/k's 64 at one MiMo-V2-Flash small layer
   (b 4, s 2048): the SWA layers' 12/4 heads with window 128 and sinks, and
   the GA layers' 12/2 heads causal, forward and forward + backward.
   K4 at DeepSeek-V3's MLA head dims (q/k 96, v 64) at one layer of its
   train step (b 4, 12/12 heads, s 2048, causal), forward and forward +
   backward.
   K7 at ViT-B's encode shape (b 128, s 197, 12 x 64) and at d 32 (b 128,
   s 65, 8 x 32), and its recompute backward (b 16 checked, b 128 timed);
   K8 with dynamic and with static scales and K9 at ViT-B's shape, K9 equal
   to K8 static bit for bit. Each record carries its bound and, where one
   PyTorch call computes the same function, that call's time (none for K8
   and K9: ``bf16_sdpa_ms`` stands beside them);
3. vit_fp32: ViT-B's widths cut to 2 layers, b 8, fp32: the logits through
   K7, K8 (dynamic, static) and K9 against the plain versions, within
   LOGIT_TOL;
4. vit_encode: ViT-B/224 at full width and depth, b 128, bf16, under
   ``torch.inference_mode``, launch counts reset first, once in each mode
   (bf16 through K7; int8 dynamic and int8 static through K8; int8 inkernel
   through K9; 12 launches each), then img/s, MFU, peak memory and the int8
   modes' logits against the bf16 encode's;
5. check_fp32: the full-width Qwen3.5-0.8B generation path (random weights
   from a seeded generator) in fp32, once through the kernels and once with
   the plain versions forced: prefill logits close, first 16 greedy tokens
   equal;
6. main_path: the same two entry points in bf16 with every launch count reset
   first — ``generate_multimodal`` (a 384 px image, the 156-token prompt of
   bench.py, 64 greedy tokens) and ``generate_kv_cache`` at b = 4 with a
   300-token prompt — and every kernel of the path must have launched, and
   K7 none (the tower's s 576 is above ``fused_mha_max_seq``: ``sdpa``);
7. timing: tok/s and TTFT of both, with the card's name and power limit;
8. train_fp32: a 2-layer Qwen3 at Qwen3-0.6B widths, b = 1, s = 2048, the
   loss and every gradient through the kernels against the plain versions;
9. train: bench.py's train configuration (16 layers, b = 4, s = 2048, bf16,
   fused-head CE) through ``make_optimizer`` → ``make_train_step``, launch
   counts reset first, 1 warm-up and 4 timed steps: the loss is finite and
   falls, flash forward and backward each launch 16 times a step, and tok/s,
   step ms and MFU are printed with the card's name and power limit;
10. hybrid_fp32: Qwen3-Next-small at full width cut to 4 layers (3 GDN + 1
    GatedAttention), b = 1, s = 512, the loss and every gradient through the
    kernels against the plain versions;
11. hybrid_train: ``QWEN3_NEXT_SMALL_CONFIG`` at full width and depth (8
    layers), b = 4, s = 2048, bf16, fused-head CE, exact (ragged) MoE
    dispatch, as phase 9: K1 forward and backward launch 6 times a step,
    flash forward and backward twice; then the same with capacity dispatch
    (factor 1.25);
12. gemma_fp32: Gemma-3-270M widths cut to 6 layers (5 SWA + 1 global),
    b 2, s 1024, the loss and every gradient through the kernels against the
    plain versions (full-logits CE: the Gemma-3 model has no fused head);
    gemma_fp32_cached: a 700-token prompt's cached prefill (``sdpa`` on the
    dense masks) against the uncached flash forward, last logits;
13. gemma_train: the 18-layer model, b 4, s 2048, bf16, as phase 9: K4
    forward and backward each launch 18 times a step, 15 with the window;
    MFU with the port's SWA FLOP count; gemma_generate: b 1, a 300-token
    prompt, 16 greedy tokens through the cache branch, tok/s and TTFT;
14. mimo_fp32: MiMo-V2-Flash small at full width cut to 6 layers (GA, 4 SWA
    with sinks, GA), b 1, s 512, fp32: the MTP loss (within 1e-5 relative)
    and every gradient (within 1e-4) through the kernels against the plain
    versions, the expert counts equal; mimo_train: 12 layers, b 4, s 2048,
    bf16, full-logits CE, through ``make_mimo_train_step`` (the bias fold
    after the optimizer step), as phase 9: K4 forward and backward launch
    14 times a step (11 windowed with sinks: 9 SWA layers and 2 MTP blocks;
    3 causal GA layers), with MFU by the port's MiMo FLOP count;
15. dsv3_fp32: DeepSeek-V3 small at full width cut to 5 layers (3 dense, 2
    MoE), b 1, s 512, MTP depth 2, a batch from the MTP collator, fp32: the
    loss (within 1e-5 relative) and every gradient (within 1e-4) through the
    kernels against the plain versions, the expert counts equal; dsv3_train:
    12 layers, b 4, s 2048, bf16, full-logits CE, through
    ``make_deepseek_train_step`` (the bias fold after the optimizer step), as
    phase 9: K4 at (96, 64) forward and backward launch 14 times a step (12
    layers, 2 MTP blocks at the full s), with MFU by the port's DeepSeek
    FLOP count and the last step's max_vio; dsv3_generate_fp32: 2 layers,
    b 1, a 300-token prompt, 16 greedy cached tokens (``sdpa`` over the
    q/k 96, v 64 cache) equal to ``generate_loop_uncached``'s (K4 at each
    step); dsv3_generate: 12 layers, bf16, the same prompt, tok/s and TTFT;
16. int8_generate_fp32, next_serve_fp32: int8 Qwen3.5-0.8B text and int8
    Qwen3-Next-small at full width cut to 4 layers, fp32, kernels against
    plain: prefill logits within INT8_LOGIT_TOL, 16 greedy tokens equal;
17. int8_generate: Qwen3.5-0.8B text, 24 layers, bf16, weights, tied table
    and KV cache int8, b = 1, prompt 32, 64 greedy tokens (K1, K2, K10);
18. next_serve: Qwen3-Next-small, 8 layers, bf16, linears and expert stacks
    int8, b = 4, 300-token prompts, 64 greedy tokens (K1, K2 at dk 64, K11).
    Phases 17 and 18 reset the counts, drive the int8 model once, then print
    tok/s, TTFT and MBU beside the bf16 model's, and the per-step cost of
    the int8 → bf16 weight copies.

Then the kernels summary line, the ``nvidia-smi`` name/power-limit line and,
last, ``{"ok": true, "device": {...}}``. Any failure exits nonzero before the
last line; there is no CPU fallback.

    python3 chip_smoke.py --profile

runs only the device phase and a ``torch.profiler`` breakdown of the train
steps of phases 9, 11, 13, 14 and 15 (2 warm-up and 2 profiled steps each) and of the
ViT-B encode through K7 and through K8 with static scales (1 warm-up, 2
profiled encodes each): the device's busy share of the profiled wall and the
device time per step by kernel group (flash forward, which is also K7's,
dq, dk/dv, GDN forward, backward and its reduction, K8/K9 and K8's
quantization, cuBLAS GEMMs, the rest), one JSON line each.
"""

import json
import statistics
from functools import partial
import subprocess
import sys
import time

# kernel-vs-plain tolerances on max |kernel - plain|, relative to max(1, max |plain|).
# fp32: both sides compute in fp32, in another summation order (the GDN kernel
# is the exact scan, its plain version the chunked form). bf16: the inputs and
# outputs are bf16 (8 bits of mantissa), so one output rounding step differs.
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# whole-path fp32 check: prefill logits, kernels vs plain, absolute
LOGIT_TOL = 2e-3
# fp32 train checks, kernels vs plain: the loss relative, each gradient's
# max |g_kernel - g_plain| relative to max |g_plain| (other summation orders
# through 2 to 4 layers and the 151,936-row head; the GDN kernels are the
# exact scan, their plain versions the chunked form)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
# fp32 serving checks at 4 layers, kernels vs plain: last prefill logits,
# absolute (the GDN kernel is the exact scan, its plain version the chunked form)
INT8_LOGIT_TOL = 1e-4
SEED = 0
DEVICE = "cuda"
# the card's published rates (H100 SXM, NVIDIA's data sheet, dense, at 700 W):
# device memory, bf16 on the tensor cores, fp32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, key, iters=20):
    """Device time per call of the kernels whose names contain ``key``, summed
    from a ``torch.profiler`` trace of ``iters`` calls (CUDA events around a
    call of a few microseconds time the host's launch work instead)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and key in e.name]
    if not events:
        raise AssertionError(f"the profiler recorded no {key} kernel")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())


def check(name, got, ref, dtype):
    err, scale = max_err(got, ref)
    tol = TOL[str(dtype).removeprefix("torch.")] * max(1.0, scale)
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, flops, dtype="bfloat16"):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of the inputs' type;
    ``simt_bound_ms`` takes the fp32 rate outside the tensor cores instead."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "simt_bound_ms": max(t_bytes, flops / PEAK_FLOPS["float32"]) * 1e3, "bytes": n_bytes, "flops": flops}


def bound_int8(n_bytes, int8_ops, bf16_flops):
    """``bound`` for the int8-score kernels: the score products at the int8
    peak and p·V at the bf16 peak, in series; ``simt_bound_ms`` takes both at
    the fp32 rate outside the tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = int8_ops / PEAK_FLOPS["int8"] + bf16_flops / PEAK_FLOPS["bfloat16"]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "simt_bound_ms": max(t_bytes, (int8_ops + bf16_flops) / PEAK_FLOPS["float32"]) * 1e3,
            "bytes": n_bytes, "flops": int8_ops + bf16_flops, "int8_ops": int8_ops}


def randn(gen, *shape, dtype=None, scale=1.0):
    import torch

    return (torch.randn(*shape, generator=gen, device=DEVICE) * scale).to(dtype or torch.float32)


# ------------------------------------------------------------------ kernels


def gdn_inputs(gen, b, h, s, dtype, dk=128, dv=128):
    import torch

    from llm_quest_tpu_torch.ops.gdn import l2_norm_clamp

    q = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    k = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    v = randn(gen, b, h, s, dv, dtype=dtype)
    beta = torch.sigmoid(randn(gen, b, h, s))
    alpha = torch.sigmoid(randn(gen, b, h, s, scale=0.3) + 2.0)
    s0 = randn(gen, b, h, dv, dk, scale=0.1)
    return q, k, v, beta, alpha, s0


def kernel_k1(gen, dtypes):
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    errs, cases = [], []
    for dtype in dtypes:
        for b, h, s, d in ((1, 16, 156, 128), (4, 16, 300, 128), (2, 8, 300, 64)):
            q, k, v, beta, alpha, s0 = gdn_inputs(gen, b, h, s, dtype, dk=d, dv=d)
            out, st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0)
            ref_out, ref_st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0, plain=True)
            torch_sync()
            e = max(check(f"K1 out b={b} s={s} dk={d} {dtype}", out, ref_out, dtype),
                    check(f"K1 state b={b} s={s} dk={d} {dtype}", st, ref_st, dtype))
            cases.append({"b": b, "h": h, "s": s, "dk": d, "dtype": str(dtype), "max_abs_err": e})
            if dtype == dtypes[0]:
                errs.append(e)
    # the hybrid train step's shape, bf16, from a zero state: checked and timed
    q, k, v, beta, alpha, _ = gdn_inputs(gen, 4, 8, 2048, dtypes[-1], dk=64, dv=64)
    out, st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha)
    ref_out, ref_st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, plain=True)
    torch_sync()
    cases.append({"shape": f"b 4, h 8, s 2048, dk = dv = 64 {dtypes[-1]}",
                  "max_abs_err": max(check("K1 out hybrid shape", out, ref_out, dtypes[-1]),
                                     check("K1 state hybrid shape", st, ref_st, dtypes[-1])),
                  "ms": cuda_ms(lambda: gdn.gated_delta_rule_fwd(q, k, v, beta, alpha), iters=5, warmup=1),
                  "plain_ms": cuda_ms(lambda: gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, plain=True),
                                      iters=5, warmup=1),
                  **bound(nbytes(q, k, v, beta, alpha, out, st), 8 * 64 * 64 * 4 * 8 * 2048)})
    del q, k, v, beta, alpha, out, st, ref_out, ref_st
    torch.cuda.empty_cache()
    # the record's time: the generation path's prefill shape
    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 1, 16, 156, dtypes[-1])
    ms = cuda_ms(lambda: gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0))
    plain_ms = cuda_ms(lambda: gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0, plain=True))
    out, st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0)
    # 4 dk·dv multiply-adds a token and head (S·k, the rank-1 update, the decay, S·q)
    extra = {**bound(nbytes(q, k, v, beta, alpha, s0, out, st), 8 * 128 * 128 * 16 * 156), "library_ms": None}
    return max(errs), ms, plain_ms, cases, extra


def kernel_k1_bwd(gen, dtypes):
    """K1's backward against its plain version (the per-chunk replay) on the
    kernel's own anchors, and the autograd Function against autograd through
    the plain chunked forward; forward + backward timed at the hybrid step's
    shape."""
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    c = gdn.ANCHOR_CHUNK
    names = ("dq", "dk", "dv", "dbeta", "dalpha", "d_prev")
    errs, cases = [], []
    for dtype in dtypes:
        for d in (64, 128):
            for with_prev in (False, True):
                q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 8, 300, dtype, dk=d, dv=d)
                prev = s0 if with_prev else None
                d_out, d_state = randn(gen, 2, 8, 300, d, dtype=dtype), randn(gen, 2, 8, d, d)
                _, _, anchors = gdn._launch_fwd(q, k, v, beta, alpha, prev, anchor_chunk=c)
                got = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=c)
                ref = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=c,
                                               plain=True)
                torch_sync()
                e = max(check(f"K1 bwd {n} dk={d} prev={with_prev} {dtype}", g, r, dtype)
                        for n, g, r in zip(names, got, ref))
                cases.append({"b": 2, "h": 8, "s": 300, "dk": d, "prev_state": with_prev, "d_state": True,
                              "dtype": str(dtype), "max_abs_err": e})
                if dtype == dtypes[0]:
                    errs.append(e)
        # through autograd, from the wrapper a model calls
        q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 8, 300, dtype, dk=64, dv=64)
        d_out, d_state = randn(gen, 2, 8, 300, 64, dtype=dtype), randn(gen, 2, 8, 64, 64)
        grads = []
        for plain in (False, True):
            args = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha, s0)]
            out, st = gdn.gated_delta_rule_fwd(*args, plain=plain)
            grads.append(torch.autograd.grad((out, st), args, (d_out, d_state)))
        torch_sync()
        e = max(check(f"K1 autograd {n} {dtype}", g, r, dtype) for n, g, r in zip(names, *grads))
        cases.append({"autograd": True, "b": 2, "h": 8, "s": 300, "dk": 64, "dtype": str(dtype), "max_abs_err": e})
    # the hybrid train step's shape, bf16: checked, then timed
    dtype = dtypes[-1]
    q, k, v, beta, alpha, _ = gdn_inputs(gen, 4, 8, 2048, dtype, dk=64, dv=64)
    d_out = randn(gen, 4, 8, 2048, 64, dtype=dtype)
    _, _, anchors = gdn._launch_fwd(q, k, v, beta, alpha, None, anchor_chunk=c)
    got = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=c)
    ref = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=c, plain=True)
    torch_sync()
    case = {"shape": f"b 4, h 8, s 2048, dk = dv = 64 {dtype}",
            "max_abs_err": {n: check(f"K1 bwd {n} hybrid shape", g, r, dtype) for n, g, r in zip(names, got, ref)},
            "max_abs_ref": {n: max_err(g, r)[1] for n, g, r in zip(names, got, ref)}}
    del got, ref
    args = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha)]

    def kernel_fwd_bwd():
        out, _ = gdn.gated_delta_rule_fwd(*args)
        return torch.autograd.grad(out, args, d_out)

    def plain_fwd_bwd():  # the plain halves at the JAX chunk of 64
        _, _, anc = gdn.gated_delta_rule_fwd_plain(q, k, v, beta, alpha, chunk_size=64, with_anchors=True)
        return gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anc, d_out, None, chunk_size=64, plain=True)

    case["fwd_bwd_ms"] = cuda_ms(kernel_fwd_bwd, iters=5, warmup=1)
    case["plain_fwd_bwd_ms"] = cuda_ms(plain_fwd_bwd, iters=3, warmup=1)
    case["fwd_anchors_ms"] = cuda_ms(lambda: gdn._launch_fwd(q, k, v, beta, alpha, None, anchor_chunk=c),
                                     iters=5, warmup=1)
    case["bwd_ms"] = cuda_ms(lambda: gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None,
                                                              chunk_size=c), iters=5, warmup=1)
    case["plain_bwd_ms"] = cuda_ms(lambda: gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None,
                                                                    chunk_size=c, plain=True), iters=3, warmup=1)
    cases.append(case)
    # forward + backward: the inputs and d_out read, out and the five gradients
    # written; 3x the forward's 4 dk·dv multiply-adds a token and head
    grads = nbytes(q, k, v) + 2 * nbytes(beta)
    extra = {**bound(nbytes(q, k, v, beta, alpha, d_out) + nbytes(d_out) + grads, 3 * 8 * 64 * 64 * 4 * 8 * 2048),
             "library_ms": None}
    del q, k, v, beta, alpha, d_out, anchors, args
    torch.cuda.empty_cache()
    return max(errs), case["fwd_bwd_ms"], case["plain_fwd_bwd_ms"], cases, extra


def kernel_k2(gen, dtypes):
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    errs, cases = [], []
    layer = 7
    for dtype in dtypes:
        for b in (1, 32):
            q, k, v, beta, alpha, _ = gdn_inputs(gen, b, 16, 1, dtype)
            q, k, v, beta, alpha = q[:, :, 0], k[:, :, 0], v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
            stacked = randn(gen, 18, b, 16, 128, 128, scale=0.1)
            before = stacked.clone()
            ref_stacked = stacked.clone()
            out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer)
            ref_out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, ref_stacked, layer, plain=True)
            torch_sync()
            others = [i for i in range(18) if i != layer]
            if not torch.equal(stacked[others], before[others]):
                raise AssertionError(f"K2 b={b} {dtype}: layers other than {layer} changed")
            e = max(check(f"K2 out b={b} {dtype}", out, ref_out, dtype),
                    check(f"K2 state b={b} {dtype}", stacked[layer], ref_stacked[layer], torch.float32))
            cases.append({"b": b, "layer": layer, "dtype": str(dtype), "max_abs_err": e, "others_bitwise_equal": True})
            if dtype == dtypes[0]:
                errs.append(e)
    # dk = dv = 64: Qwen3-Next-small's decode step (6 GDN layers, b 4, 8 v heads)
    for dtype in dtypes:
        q, k, v, beta, alpha, _ = gdn_inputs(gen, 4, 8, 1, dtype, dk=64, dv=64)
        q, k, v, beta, alpha = q[:, :, 0], k[:, :, 0], v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
        stacked = randn(gen, 6, 4, 8, 64, 64, scale=0.1)
        ref_stacked = stacked.clone()
        out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, 3)
        ref_out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, ref_stacked, 3, plain=True)
        torch_sync()
        e = max(check(f"K2 dk=64 out {dtype}", out, ref_out, dtype),
                check(f"K2 dk=64 state {dtype}", stacked[3], ref_stacked[3], torch.float32))
        case = {"L": 6, "b": 4, "h": 8, "dk": 64, "dtype": str(dtype), "max_abs_err": e}
        if dtype == dtypes[-1]:
            case["ms"] = cuda_ms(lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, 3))
            case["device_ms"] = device_ms(
                lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, 3), "gdn_step_stacked")
            case["plain_ms"] = cuda_ms(
                lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, 3, plain=True))
            case.update(bound(nbytes(q, k, v, beta, alpha, out) + 2 * nbytes(stacked[3]), 8 * 64 * 64 * 4 * 8))
        cases.append(case)
        if dtype == dtypes[0]:
            errs.append(e)
    q, k, v, beta, alpha, _ = gdn_inputs(gen, 1, 16, 1, dtypes[-1])
    q, k, v, beta, alpha = q[:, :, 0], k[:, :, 0], v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
    stacked = randn(gen, 18, 1, 16, 128, 128, scale=0.1)
    ms = cuda_ms(lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer))
    plain_ms = cuda_ms(lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer, plain=True))
    out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer)
    # one layer's fp32 state read and written in place
    extra = {**bound(nbytes(q, k, v, beta, alpha, out) + 2 * nbytes(stacked[layer]), 8 * 128 * 128 * 16),
             "library_ms": None, "device_ms": device_ms(
                 lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer), "gdn_step_stacked")}
    return max(errs), ms, plain_ms, cases, extra


def attn_inputs(gen, b, hq, hkv, sq, sk, d, dtype):
    import torch

    q = randn(gen, b, hq, sq, d, dtype=dtype)
    k = randn(gen, b, hkv, sk, d, dtype=dtype)
    v = randn(gen, b, hkv, sk, d, dtype=dtype)
    key_mask = torch.rand(b, sk, generator=gen, device=DEVICE) > 0.2
    key_mask[:, 0] = True  # every causal row sees at least one real key
    return q, k, v, key_mask


def kernel_k4(gen, dtypes):
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    errs, cases = [], []
    for dtype in dtypes:
        for q_start in (0, 32):
            q, k, v, key_mask = attn_inputs(gen, 2, 8, 2, 300, 364, 256, dtype)
            for mask in (None, key_mask):
                out = attn.flash_attention(q, k, v, attn_mask=mask, q_start=q_start)
                ref = attn.flash_attention(q, k, v, attn_mask=mask, q_start=q_start, plain=True)
                torch_sync()
                e = check(f"K4 q_start={q_start} mask={mask is not None} {dtype}", out, ref, dtype)
                cases.append({"q_start": q_start, "key_mask": mask is not None, "dtype": str(dtype), "max_abs_err": e})
                if dtype == dtypes[0]:
                    errs.append(e)
    # main-path shape: b=4 prefill of 300 tokens into a 364-column cache
    q, k, v, _ = attn_inputs(gen, 4, 8, 2, 300, 364, 256, dtypes[-1])
    key_mask = torch.zeros(4, 364, dtype=torch.bool, device=DEVICE)
    key_mask[:, :300] = True
    ms = cuda_ms(lambda: attn.flash_attention(q, k, v, attn_mask=key_mask))
    plain_ms = cuda_ms(lambda: attn.flash_attention(q, k, v, attn_mask=key_mask, plain=True))
    # the same function in one library call: keys past 299 are masked by the
    # causal rule already (q_start 0: key j is visible to query i iff j <= i)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    check("K4 vs sdpa (library)", lib(), attn.flash_attention(q, k, v, attn_mask=key_mask), dtypes[-1])
    pairs = 300 * 301 // 2  # visible (query, key) pairs of a causal 300-row block
    out = attn.flash_attention(q, k, v, attn_mask=key_mask)
    extra = {**bound(nbytes(q, k, v, key_mask, out) + 4 * 8 * 300 * 4, 4 * 256 * pairs * 4 * 8),
             "library_ms": cuda_ms(lib)}
    return max(errs), ms, plain_ms, cases, extra


def kernel_k4_bwd(gen, dtypes):
    """dq/dk/dv of the flash kernels against autograd through the plain sdpa."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    errs, cases = [], []
    for dtype in dtypes:
        for d in (64, 128, 256):
            for hq, hkv in ((16, 8), (8, 2)):
                q, k, v, key_mask = attn_inputs(gen, 2, hq, hkv, 300, 300, d, dtype)
                do = randn(gen, 2, hq, 300, d, dtype=dtype)
                for mask in (None, key_mask):
                    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                    attn.flash_attention(qg, kg, vg, attn_mask=mask).backward(do)
                    refs = attn.flash_attention_bwd(q, k, v, None, None, do, attn_mask=mask, plain=True)
                    torch_sync()
                    e = max(check(f"K4 bwd {name} d={d} {hq}/{hkv} mask={mask is not None} {dtype}", got, ref, dtype)
                            for name, got, ref in zip("qkv", (qg.grad, kg.grad, vg.grad), refs))
                    cases.append({"d": d, "heads": [hq, hkv], "key_mask": mask is not None, "dtype": str(dtype),
                                  "max_abs_err": e})
                    if dtype == dtypes[0]:
                        errs.append(e)
    # training shape: one layer of bench.py's train step (b = 4) in bf16, the
    # output and dq/dk/dv held to plain, then fwd + bwd timed on the same
    # tensors; the b = 1 layer is timed too
    for b in (4, 1):
        dtype = dtypes[-1]
        q, k, v, _ = attn_inputs(gen, b, 16, 8, 2048, 2048, 128, dtype)
        do = randn(gen, b, 16, 2048, 128, dtype=dtype)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def fwd_bwd(plain):
            out = attn.flash_attention(qg, kg, vg, plain=plain)
            return (out.detach(),) + torch.autograd.grad(out, (qg, kg, vg), do)

        case = {"shape": f"q ({b}, 16, 2048, 128), kv ({b}, 8, 2048, 128) {dtype}"}
        if b == 4:
            got, ref = fwd_bwd(False), fwd_bwd(True)
            torch_sync()
            case["max_abs_err"] = {name: check(f"K4 fwd+bwd {name} train shape {dtype}", g, r, dtype)
                                   for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref)}
            case["max_abs_ref"] = {name: max_err(g, r)[1] for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref)}
            del got, ref
        case["fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(False), iters=5, warmup=1)
        case["plain_fwd_bwd_ms"] = cuda_ms(lambda: fwd_bwd(True), iters=5, warmup=1)
        # the function's work, 3x the forward's 4·d per visible pair and head:
        # QKᵀ and PV forward, dV, dP, dQ and dK backward (the flash
        # backward's recompute of the scores is the algorithm's, not counted)
        case.update(bound(2 * nbytes(q, k, v, do), 3 * 4 * 128 * (2048 * 2049 // 2) * b * 16))
        if b == 4:
            def lib_fwd_bwd():
                out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
                return torch.autograd.grad(out, (qg, kg, vg), do)

            extra = {key: case[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops")}
            extra["library_ms"] = cuda_ms(lib_fwd_bwd, iters=5, warmup=1)
        o = attn.flash_attention(q, k, v)
        lse = attn._plain_lse(q, k, None, True, 0, 128**-0.5)
        case["bwd_ms"] = cuda_ms(lambda: attn.flash_attention_bwd(q, k, v, o, lse, do), iters=5, warmup=1)
        case["fwd_ms"] = cuda_ms(lambda: attn.flash_attention(q, k, v), iters=5, warmup=1)
        cases.append(case)
        if b == 4:
            ms, plain_ms = case["fwd_bwd_ms"], case["plain_fwd_bwd_ms"]
        del q, k, v, do, qg, kg, vg, o, lse
        torch.cuda.empty_cache()
    return max(errs), ms, plain_ms, cases, extra


# one attention layer of Gemma-3-270M's train step: b 4, q/kv heads 4/1, d 256, s 2048
GEMMA_K4 = {"b": 4, "hq": 4, "hkv": 1, "s": 2048, "d": 256}
GEMMA_WINDOW = 512
# one attention layer of MiMo-V2-Flash small's train step (b 4, s 2048, d 64,
# dv 32): the SWA layers' 12/4 heads (window 128, sinks), the GA layers' 12/2
MIMO_SWA_K4 = {"b": 4, "hq": 12, "hkv": 4, "s": 2048, "d": 64, "dv": 32}
MIMO_GA_K4 = {"b": 4, "hq": 12, "hkv": 2, "s": 2048, "d": 64, "dv": 32}
MIMO_WINDOW = 128
# one attention layer of DeepSeek-V3 small's train step: MLA's 12 heads (as
# many kv heads), q/k 96 (latent-up 64 and decoupled RoPE 32), v 64, causal
DSV3_K4 = {"b": 4, "hq": 12, "hkv": 12, "s": 2048, "d": 96, "dv": 64}


def visible_pairs(s, window=None):
    """(query, key) pairs a causal (optionally windowed) s-row block sees."""
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def k4_case(gen, dtypes, *, shape=GEMMA_K4, window=None, softcap=None, sink=False, backward=False):
    """K4 at ``shape`` (v's head dim ``dv``, default d) with the given
    features against its plain version in each dtype (the output, and with
    ``backward`` dq/dk/dv and dsink through autograd), then the kernel, the
    plain version and (without softcap or sinks) ``F.scaled_dot_product_attention``
    on the dense mask timed in bf16."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, hq, hkv, s, d = (shape[key] for key in ("b", "hq", "hkv", "s", "d"))
    dv = shape.get("dv", d)
    errs, cases = [], []
    for dtype in dtypes:
        # a softcap of 30 bends scores only where they reach its scale
        q = randn(gen, b, hq, s, d, dtype=dtype, scale=20.0 if softcap else 1.0)
        k, v = randn(gen, b, hkv, s, d, dtype=dtype), randn(gen, b, hkv, s, dv, dtype=dtype)
        do = randn(gen, b, hq, s, dv, dtype=dtype)
        # sinks near the rows' logsumexp, so their share and dsink are not negligible
        sk = randn(gen, hq, scale=0.5) + 5.0 if sink else None
        kw = {"window_size": window, "softcap": softcap}
        leaves = [t.clone().requires_grad_(backward) for t in (q, k, v) + ((sk,) if sink else ())]

        def run(plain, leaves=leaves, kw=kw, do=do):
            out = attn.flash_attention(*leaves[:3], sink=leaves[3] if sink else None, plain=plain, **kw)
            if not backward:
                return (out,)
            return (out.detach(),) + torch.autograd.grad(out, leaves, do)

        names = ("o", "dq", "dk", "dv", "dsink")[: (4 + sink) if backward else 1]
        got, ref = run(False), run(True)
        torch_sync()
        label = f"K4 {shape} window={window} softcap={softcap} sink={sink} bwd={backward} {dtype}"
        err = {n: check(f"{label} {n}", g, r, dtype) for n, g, r in zip(names, got, ref)}
        case = {"dtype": str(dtype), "max_abs_err": err, "max_abs_ref": {n: max_err(g, r)[1]
                                                                        for n, g, r in zip(names, got, ref)}}
        del got, ref
        if dtype == dtypes[0]:  # the record's error is the fp32 one, as for the other kernels
            errs.append(max(err.values()))
        if dtype == dtypes[-1]:
            iters = (5, 1) if backward else (10, 2)
            case["ms"] = cuda_ms(lambda: run(False), *iters)
            case["plain_ms"] = cuda_ms(lambda: run(True), *iters)
            pairs = visible_pairs(s, window)
            # forward 2·(d + dv) FLOPs per visible pair and head (QKᵀ, PV);
            # backward 2× that (dV and dP over dv, dQ and dK over d)
            flops = (3 if backward else 1) * 2 * (d + dv) * pairs * b * hq
            # do stands for o (both (b, hq, s, dv)); the fp32 lse
            n_bytes = 2 * nbytes(q, k, v, do) if backward else nbytes(q, k, v, do) + 4 * b * hq * s
            case.update(bound(n_bytes, flops, "bfloat16"))
            case["library_ms"] = None
            if softcap is None and not sink:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                allowed = None
                if window is not None:
                    pos = torch.arange(s, device=DEVICE)
                    allowed = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

                def lib():
                    lq, lk, lv = leaves[:3]
                    if allowed is None:
                        out = sdpa(lq, lk, lv, is_causal=True, enable_gqa=True)
                    else:
                        out = sdpa(lq, lk, lv, attn_mask=allowed, enable_gqa=True)
                    return torch.autograd.grad(out, leaves[:3], do) if backward else out

                if not backward:
                    check(f"{label} vs sdpa (library)", lib(), attn.flash_attention(q, k, v, **kw), dtype)
                case["library_ms"] = cuda_ms(lib, *iters)
        cases.append(case)
        del q, k, v, do, leaves
        torch.cuda.empty_cache()
    rec = cases[-1]
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "library_ms")}
    extra["shape"] = {**shape, "window": window, "softcap": softcap, "sink": sink, "backward": backward}
    return max(errs), rec["ms"], rec["plain_ms"], cases, extra


# ViT-B/224's encode (bench.py:297): b 128, s 197 (196 patches + CLS), 12 heads of 64
VIT_B = (128, 197, 12, 64)
# TinyViT's heads (TINY_VIT_CONFIG: 256 = 8 x 32) at s 65 (64 patches + CLS), b 128
VIT_D32 = (128, 65, 8, 32)


def packed_inputs(gen, shape, dtype):
    b, s, h, d = shape
    return tuple(randn(gen, b, s, h * d, dtype=dtype) for _ in range(3))


def packed_flops(shape):
    """QKᵀ or PV of every (image, head): 2·s²·d each."""
    b, s, h, d = shape
    return 2 * b * h * s * s * d


def split_view(t, h):
    """The (b, h, s, d) view of a packed (b, s, h·d) tensor, for the library call."""
    b, s, hd = t.shape
    return t.view(b, s, h, hd // h).transpose(1, 2)


def kernel_k7(gen, dtypes, shape=VIT_B):
    """K7 at ``shape`` (ViT-B's encode, or TinyViT's d 32), fp32 and bf16
    against plain; timed in bf16 beside ``sdpa`` on the split-head view."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    b, s, h, d = shape
    errs, cases = [], []
    for dtype in dtypes:
        q, k, v = packed_inputs(gen, shape, dtype)
        out, ref = attn.packed_mha(q, k, v, h), attn.packed_mha(q, k, v, h, plain=True)
        torch_sync()
        e = check(f"K7 {shape} {dtype}", out, ref, dtype)
        cases.append({"b": b, "s": s, "heads": h, "d": d, "dtype": str(dtype), "max_abs_err": e})
        if dtype == dtypes[0]:
            errs.append(e)
    ms = cuda_ms(lambda: attn.packed_mha(q, k, v, h))
    plain_ms = cuda_ms(lambda: attn.packed_mha(q, k, v, h, plain=True), iters=5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(split_view(q, h), split_view(k, h), split_view(v, h))  # noqa: E731
    check("K7 vs sdpa (library)", lib().transpose(1, 2).reshape(b, s, -1), attn.packed_mha(q, k, v, h), dtypes[-1])
    extra = {**bound(4 * nbytes(q), 2 * packed_flops(shape)), "library_ms": cuda_ms(lib), "shape": list(shape)}
    return max(errs), ms, plain_ms, cases, extra


def kernel_k7_bwd(gen, dtypes):
    """K7's recompute backward (autograd through the plain version, after the
    kernel's forward) against autograd of the plain version: fp32 and bf16 at
    b 16 of ViT-B's shape, then forward + backward timed at b 128 in bf16."""
    import torch

    from llm_quest_tpu_torch.kernels import attention as attn

    errs, cases = [], []
    for dtype in dtypes:
        for b in (16, VIT_B[0]) if dtype == dtypes[-1] else (16,):
            shape = (b, *VIT_B[1:])
            h = shape[2]
            q, k, v = packed_inputs(gen, shape, dtype)
            do = randn(gen, *q.shape, dtype=dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]

            def fwd_bwd(plain=False, leaves=leaves, do=do, h=h):
                out = attn.packed_mha(*leaves, h, plain=plain)
                return torch.autograd.grad(out, leaves, do)

            got, ref = fwd_bwd(), fwd_bwd(True)
            torch_sync()
            e = max(check(f"K7 bwd d{n} b={b} {dtype}", g, r, dtype) for n, g, r in zip("qkv", got, ref))
            cases.append({"b": b, "dtype": str(dtype), "max_abs_err": e})
            if dtype == dtypes[0]:
                errs.append(e)
            del got, ref
    ms = cuda_ms(fwd_bwd, iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: fwd_bwd(True), iters=5, warmup=1)

    def lib():
        out = torch.nn.functional.scaled_dot_product_attention(*(split_view(t, h) for t in leaves))
        return torch.autograd.grad(out, leaves, split_view(do, h))

    # forward and backward: the inputs and do read, out and dq/dk/dv written;
    # 3x the forward's products (QKᵀ, PV; dV, dP, dQ, dK)
    extra = {**bound(2 * nbytes(q, k, v, do), 3 * 2 * packed_flops(shape)), "library_ms": cuda_ms(lib, 5, 1)}
    del q, k, v, do, leaves
    torch.cuda.empty_cache()
    return max(errs), ms, plain_ms, cases, extra


def kernel_int8(gen, dtypes, mode):
    """K8 (``mode`` "dynamic" or "static") or K9 ("inkernel") at ViT-B's
    encode shape, fp32 and bf16 against plain; K9 also equal to K8 with the
    same static scales, bit for bit. Timed in bf16 beside bf16 ``sdpa``
    (no PyTorch call computes int8-score attention: library_ms is null)."""
    import torch

    from llm_quest_tpu_torch.kernels import fused_mha as fm

    b, s, h, d = VIT_B
    errs, cases = [], []
    for dtype in dtypes:
        q, k, v = packed_inputs(gen, VIT_B, dtype)
        ss = None
        if mode != "dynamic":
            ss = (float(q.float().abs().max()) / 127.0, float(k.float().abs().max()) / 127.0)
        if mode == "inkernel":
            call = lambda plain=False: fm.packed_mha_int8_inkernel(q, k, v, h, ss, plain=plain)  # noqa: E731
        else:
            call = lambda plain=False: fm.packed_mha_int8(q, k, v, h, static_scales=ss, plain=plain)  # noqa: E731
        out, ref = call(), call(True)
        torch_sync()
        case = {"b": b, "s": s, "heads": h, "d": d, "dtype": str(dtype), "static_scales": ss,
                "max_abs_err": check(f"K8/K9 {mode} {dtype}", out, ref, dtype)}
        if mode == "inkernel":
            if not torch.equal(out, fm.packed_mha_int8(q, k, v, h, static_scales=ss)):
                raise AssertionError(f"K9 differs from K8 with the same static scales ({dtype})")
            case["equal_to_k8_static"] = True
        cases.append(case)
        if dtype == dtypes[0]:
            errs.append(case["max_abs_err"])
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: call(True), iters=5, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    extra = {**bound_int8(4 * nbytes(q), packed_flops(VIT_B), packed_flops(VIT_B)), "library_ms": None,
             "bf16_sdpa_ms": cuda_ms(lambda: sdpa(split_view(q, h), split_view(k, h), split_view(v, h))),
             "shape": list(VIT_B)}
    return max(errs), ms, plain_ms, cases, extra


def int8_cache_inputs(gen, b, hq, hkv, s_len, d, dtype):
    """q and one layer of the int8 KV cache as the model writes it (views of
    a (2, b, hkv, S, d) buffer), and a random key mask as the bias."""
    import torch

    from llm_quest_tpu_torch.inference import cache as kv_cache
    from llm_quest_tpu_torch.ops.masks import mask_value

    cache = kv_cache.init_kv_cache(2, b, hkv, s_len, d, quant="int8", device=DEVICE)
    _, k, v = kv_cache.write_layer(cache, 1, randn(gen, b, hkv, s_len, d, dtype=dtype),
                                   randn(gen, b, hkv, s_len, d, dtype=dtype), 0)
    valid = torch.rand(b, s_len, generator=gen, device=DEVICE) > 0.1
    valid[:, 0] = True
    bias = torch.where(valid, 0.0, mask_value(torch.float32)).float()
    return randn(gen, b, hq, 1, d, dtype=dtype), k, v, bias


def kernel_k10(gen, dtypes):
    """K10 at the int8 generation path's decode shape (b 1, 8/2 heads, d 256,
    S 96: 32 prompt + 64 generated) and at a long context (b 16, S 8192),
    and at Qwen3's head dim 128."""
    from llm_quest_tpu_torch.kernels import flash_decode as fd

    errs, cases = [], []
    shapes = {"decode": (1, 8, 2, 96, 256), "long": (16, 8, 2, 8192, 256), "qwen3": (4, 16, 8, 300, 128)}
    for dtype in dtypes:
        for name, (b, hq, hkv, s_len, d) in shapes.items():
            q, k, v, bias = int8_cache_inputs(gen, b, hq, hkv, s_len, d, dtype)
            call = lambda plain=False: fd.flash_decode(q, k.data, k.scale, v.data, v.scale, bias, plain=plain)  # noqa: E731
            out, ref = call(), call(True)
            torch_sync()
            e = check(f"K10 {name} {dtype}", out, ref, dtype)
            case = {"shape": name, "b": b, "heads": [hq, hkv], "S": s_len, "d": d, "dtype": str(dtype),
                    "max_abs_err": e}
            if dtype == dtypes[-1]:
                case["ms"], case["plain_ms"] = cuda_ms(call), cuda_ms(lambda: call(True))
                case["device_ms"] = device_ms(call, "flash_decode")
                # int8 K/V, their scales, the bias and q read once, the output written once
                case.update(bound(nbytes(q, k.data, k.scale, v.data, v.scale, bias, out), 4 * b * hq * s_len * d))
            cases.append(case)
            if dtype == dtypes[0]:
                errs.append(e)
    rec = next(c for c in cases if c["shape"] == "decode" and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms")}
    return max(errs), rec["ms"], rec["plain_ms"], cases, {**extra, "library_ms": None}


def kernel_k11(gen, dtypes):
    """K11 at Qwen3-Next-small's shapes (8 experts, 896 -> 3584 for lin1 and
    gate, 3584 -> 896 for lin2) with a top-2 routing of b 4 tokens (decode,
    T = 8 rows) and of b 4 x 300 tokens (prefill, T = 2400 rows)."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    errs, cases = [], []
    e = 8
    for tokens in (4, 1200):
        logits = torch.randn(tokens, e, generator=gen, device=DEVICE)
        group_sizes = torch.bincount(logits.topk(2, dim=-1).indices.reshape(-1), minlength=e)
        t = 2 * tokens
        for mat, (k_dim, n_dim) in (("lin1", (896, 3584)), ("lin2", (3584, 896))):
            w_q = torch.randint(-127, 128, (e, k_dim, n_dim), generator=gen, device=DEVICE, dtype=torch.int8)
            scale = torch.rand(e, n_dim, generator=gen, device=DEVICE) * 0.02 + 1e-3
            for dtype in dtypes:
                x = randn(gen, t, k_dim, dtype=dtype)
                call = lambda plain=False: qg.quantized_ragged_dot(x, w_q, scale, group_sizes, plain=plain)  # noqa: E731
                out, ref = call(), call(True)
                torch_sync()
                # both row tilings (16 and 64 rows a tile) at both shapes; the
                # wrapper takes 16 up to qg._FEW_ROWS rows, 64 above (see
                # k11_tiling_sweep)
                tiles = {16 * rm: (lambda rm=rm: qg._launch(x, w_q, scale, group_sizes, rm)) for rm in (1, 4)}
                err = max(check(f"K11 T={t} {mat} {rows}-row tiles {dtype}", fn(), ref, dtype)
                          for rows, fn in tiles.items())
                err = max(err, check(f"K11 T={t} {mat} {dtype}", out, ref, dtype))
                case = {"T": t, "matrix": mat, "K": k_dim, "N": n_dim, "group_sizes": group_sizes.tolist(),
                        "dtype": str(dtype), "max_abs_err": err}
                if dtype == dtypes[-1]:
                    case["ms"], case["plain_ms"] = cuda_ms(call), cuda_ms(lambda: call(True))
                    case["device_ms"] = device_ms(call, "quantized_gmm")
                    case["tile_rows_device_ms"] = {rows: device_ms(fn, "quantized_gmm") for rows, fn in tiles.items()}
                    hit = int((group_sizes > 0).sum())  # the weights of the experts with rows are read
                    case.update(bound(nbytes(x, out, group_sizes) + hit * (k_dim * n_dim + 4 * n_dim),
                                      2 * t * k_dim * n_dim))
                cases.append(case)
                if dtype == dtypes[0]:
                    errs.append(err)
    rec = next(c for c in cases if c["T"] == 8 and c["matrix"] == "lin1" and "ms" in c)
    extra = {key: rec[key] for key in ("bound_ms", "bound_by", "simt_bound_ms", "bytes", "flops", "device_ms")}
    extra["tiling_sweep"] = k11_tiling_sweep(gen, dtypes[-1])
    return max(errs), rec["ms"], rec["plain_ms"], cases, {**extra, "library_ms": None}


def k11_tiling_sweep(gen, dtype):
    """Device ms of K11's two row tilings between the decode and prefill
    shapes (8 experts, top-2 routing), where the wrapper switches at
    qg._FEW_ROWS rows; each tiling checked against plain."""
    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    e, sweep = 8, []
    for t in (32, 64, 128, 256, 512):
        logits = torch.randn(t // 2, e, generator=gen, device=DEVICE)
        group_sizes = torch.bincount(logits.topk(2, dim=-1).indices.reshape(-1), minlength=e)
        row = {"T": t, "max_group": int(group_sizes.max())}
        for mat, (k_dim, n_dim) in (("lin1", (896, 3584)), ("lin2", (3584, 896))):
            w_q = torch.randint(-127, 128, (e, k_dim, n_dim), generator=gen, device=DEVICE, dtype=torch.int8)
            scale = torch.rand(e, n_dim, generator=gen, device=DEVICE) * 0.02 + 1e-3
            x = randn(gen, t, k_dim, dtype=dtype)
            ref = qg.quantized_ragged_dot(x, w_q, scale, group_sizes, plain=True)
            times = {}
            for rm in (1, 4):
                fn = lambda rm=rm: qg._launch(x, w_q, scale, group_sizes, rm)  # noqa: E731
                check(f"K11 sweep T={t} {mat} {16 * rm}-row tiles {dtype}", fn(), ref, dtype)
                times[16 * rm] = device_ms(fn, "quantized_gmm")
            row[mat] = times
        sweep.append(row)
    return sweep


def torch_sync():
    import torch

    torch.cuda.synchronize()  # a fault inside a kernel surfaces here, at its phase


# the main paths
GENERATE, TRAIN, HYBRID = "generate", "train", "hybrid_train"
INT8_GENERATE, NEXT_SERVE = "int8_generate", "next_serve"
GEMMA = "gemma_train"
VIT = "vit_encode"
MIMO = "mimo_train"
DSV3 = "dsv3_train"
KERNELS = [
    # name, wrapper (module, attribute[, which launches: "window" = those with a
    # sliding window, "full" = those without, "softcap_sink" = those with a
    # softcap or sinks, "static" = those with static scales, "dynamic" = those
    # without]), source, replaced TPU kernel, check, main paths that launch it
    ("gdn_prefill", ("gdn", "gated_delta_rule_fwd"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:205", kernel_k1, (GENERATE, HYBRID, INT8_GENERATE, NEXT_SERVE)),
    ("gdn_prefill_bwd", ("gdn", "gated_delta_rule_bwd"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:255", kernel_k1_bwd, (HYBRID,)),
    ("gdn_step_stacked", ("gdn", "gated_delta_rule_step_stacked"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:350", kernel_k2, (GENERATE, INT8_GENERATE, NEXT_SERVE)),
    ("flash_attention_fwd", ("attention", "flash_attention"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4, (GENERATE, TRAIN, HYBRID)),
    ("flash_attention_bwd", ("attention", "flash_attention_bwd"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/flash_attention.py:175", kernel_k4_bwd, (TRAIN, HYBRID)),
    ("packed_mha", ("attention", "packed_mha"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/fused_mha.py:422", kernel_k7, (VIT,)),
    ("packed_mha_d32", ("attention", "packed_mha"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/fused_mha.py:422", partial(kernel_k7, shape=VIT_D32), ()),
    ("packed_mha_fwd_bwd", ("attention", "packed_mha"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/fused_mha.py:442", kernel_k7_bwd, ()),
    ("packed_mha_int8", ("fused_mha", "packed_mha_int8", "dynamic"), "llm_quest_tpu_torch/csrc/packed_mha_int8.cu",
     "llm_quest_tpu/kernels/fused_mha.py:405", partial(kernel_int8, mode="dynamic"), (VIT,)),
    ("packed_mha_int8_static", ("fused_mha", "packed_mha_int8", "static"),
     "llm_quest_tpu_torch/csrc/packed_mha_int8.cu", "llm_quest_tpu/kernels/fused_mha.py:405",
     partial(kernel_int8, mode="static"), (VIT,)),
    ("packed_mha_int8_inkernel", ("fused_mha", "packed_mha_int8_inkernel"),
     "llm_quest_tpu_torch/csrc/packed_mha_int8.cu", "llm_quest_tpu/kernels/fused_mha.py:372",
     partial(kernel_int8, mode="inkernel"), (VIT,)),
    ("flash_decode", ("flash_decode", "flash_decode"), "llm_quest_tpu_torch/csrc/flash_decode.cu",
     "llm_quest_tpu/kernels/flash_decode.py:91", kernel_k10, (INT8_GENERATE,)),
    ("quantized_ragged_dot", ("quantized_gmm", "quantized_ragged_dot"), "llm_quest_tpu_torch/csrc/quantized_gmm.cu",
     "llm_quest_tpu/kernels/quantized_gmm.py:71", kernel_k11, (NEXT_SERVE,)),
    # K4 at one Gemma-3-270M layer: the SWA layers' window, the global layers'
    # causal call at the same shape, and the softcap and sinks (on no path yet)
    ("flash_attention_fwd_window", ("attention", "flash_attention", "window"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/flash_attention.py:544", partial(k4_case, window=GEMMA_WINDOW), (GEMMA,)),
    ("flash_attention_fwd_bwd_window", ("attention", "flash_attention_bwd", "window"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, window=GEMMA_WINDOW, backward=True), (GEMMA,)),
    ("flash_attention_fwd_causal_d256", ("attention", "flash_attention", "full"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:544",
     k4_case, (GEMMA,)),
    ("flash_attention_fwd_bwd_causal_d256", ("attention", "flash_attention_bwd", "full"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, backward=True), (GEMMA,)),
    # softcap and sinks at the Gemma-3 shape; MiMo-V2-Flash's sinks launch it
    ("flash_attention_softcap_sink", ("attention", "flash_attention_bwd", "softcap_sink"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, softcap=30.0, sink=True, backward=True), (MIMO,)),
    # K4 at d 64 / dv 32, one MiMo-V2-Flash small layer: the SWA layers' window
    # 128 with sinks (12/4 heads), the GA layers' causal call (12/2 heads)
    ("flash_attention_fwd_window_sink_dv32", ("attention", "flash_attention", "window"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:544",
     partial(k4_case, shape=MIMO_SWA_K4, window=MIMO_WINDOW, sink=True), (MIMO,)),
    ("flash_attention_fwd_bwd_window_sink_dv32", ("attention", "flash_attention_bwd", "window"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=MIMO_SWA_K4, window=MIMO_WINDOW, sink=True, backward=True), (MIMO,)),
    ("flash_attention_fwd_causal_dv32", ("attention", "flash_attention", "full"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:544",
     partial(k4_case, shape=MIMO_GA_K4), (MIMO,)),
    ("flash_attention_fwd_bwd_causal_dv32", ("attention", "flash_attention_bwd", "full"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=MIMO_GA_K4, backward=True), (MIMO,)),
    # K4 at DeepSeek-V3's MLA head dims (96, 64), one layer of its train step
    ("flash_attention_fwd_causal_d96_dv64", ("attention", "flash_attention", "full"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:544",
     partial(k4_case, shape=DSV3_K4), (DSV3,)),
    ("flash_attention_fwd_bwd_causal_d96_dv64", ("attention", "flash_attention_bwd", "full"),
     "llm_quest_tpu_torch/csrc/attention.cu", "llm_quest_tpu/kernels/flash_attention.py:175",
     partial(k4_case, shape=DSV3_K4, backward=True), (DSV3,)),
]


def wrapper(spec):
    import importlib

    return getattr(importlib.import_module(f"llm_quest_tpu_torch.kernels.{spec[0]}"), spec[1])


def launch_count(spec):
    """The wrapper's launches of the kind ``spec`` names (see KERNELS): all,
    those with a sliding window, those without, those with a softcap or
    sinks, those with static scales or those without."""
    w = wrapper(spec)
    kind = spec[2] if len(spec) > 2 else "all"
    if kind == "full":
        return w.launches - w.window_launches
    if kind == "dynamic":
        return w.launches - w.static_launches
    return w.launches if kind == "all" else getattr(w, f"{kind}_launches")


def kernel_phase():
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    records = []
    for name, spec, source, replaces, fn, paths in KERNELS:
        err, ms, plain_ms, cases, extra = fn(gen, (torch.float32, torch.bfloat16))
        emit({"phase": "kernel", "name": name, "cases": cases, "ms_bf16": ms, "plain_ms_bf16": plain_ms, **extra})
        records.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": extra["bound_ms"], "bound_by": extra["bound_by"],
                        "library_ms": extra["library_ms"], "simt_bound_ms": extra["simt_bound_ms"],
                        **({"bf16_sdpa_ms": extra["bf16_sdpa_ms"]} if "bf16_sdpa_ms" in extra else {}),
                        "paths": list(paths)})
        torch.cuda.empty_cache()
    return records


def reset_launches():
    for spec in KERNELS:
        w = wrapper(spec[1])
        for counter in ("launches", "window_launches", "softcap_sink_launches", "static_launches"):
            if hasattr(w, counter):
                setattr(w, counter, 0)


def read_launches(path, records, *, add=True):
    """The launch counts of the path just driven, added to ``records`` (with
    ``add``); fails if a kernel of the path never launched."""
    counts = {}
    for (name, spec, *_, paths), rec in zip(KERNELS, records):
        n = launch_count(spec)
        counts[name] = n
        if add and path in paths:
            rec["launches"] += n
    missing = [name for (name, *_, paths) in KERNELS if path in paths and counts[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {counts}")
    return counts


# ---------------------------------------------------------------- main path


def make_inputs(cfg, gen):
    """The bench.py multimodal prompt (4 text + 144 image + 8 text tokens,
    one 384 px image repeated over 2 frames) and a b = 4, 300-token text prompt."""
    import torch

    n_vis = (cfg["img_height"] // cfg["patch_size"]) ** 2 // cfg["spatial_merge_size"] ** 2
    text_a = torch.randint(1, 1000, (4,), generator=gen, device=DEVICE)
    text_b = torch.randint(1, 1000, (8,), generator=gen, device=DEVICE)
    image = torch.full((n_vis,), cfg["image_token_id"], device=DEVICE)
    mm_ids = torch.cat([text_a, image, text_b])[None]
    pixels = torch.randn(1, 3, 2, cfg["img_height"], cfg["img_width"], generator=gen, device=DEVICE)
    text_ids = torch.randint(0, 1000, (4, 300), generator=gen, device=DEVICE)
    return mm_ids, pixels, text_ids


def run_main_path(model, cfg, mm_ids, pixels, text_ids, max_gen):
    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import qwen3_5

    px = pixels.to(cfg["dtype"])
    mm = qwen3_5.generate_multimodal(model, cfg, mm_ids, px, max_gen=max_gen, eos_ids=-1, pad_id=0)
    text = gen.generate_kv_cache(qwen3_5.TextOnly, model.text, cfg, text_ids, max_gen=max_gen, eos_ids=-1, pad_id=0)
    return mm["sequences"], text["sequences"]


def prefill_logits(model, cfg, mm_ids, pixels, text_ids):
    """Last-position logits of the cached prefill of both prompts."""
    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    with torch.inference_mode():
        cache = qwen3_5.init_cache(cfg, 1, mm_ids.shape[1] + 1, device=DEVICE)
        mask = torch.ones(1, mm_ids.shape[1] + 1, dtype=torch.bool, device=DEVICE)
        mask[:, -1] = False
        mm, _, _ = qwen3_5.apply(model, cfg, mm_ids, image_pixels=pixels.to(cfg["dtype"]), attn_mask=mask, cache=cache)
        cache = qwen3_5.init_cache(cfg, text_ids.shape[0], text_ids.shape[1] + 1, device=DEVICE)
        mask = torch.ones(text_ids.shape[0], text_ids.shape[1] + 1, dtype=torch.bool, device=DEVICE)
        mask[:, -1] = False
        text, _, _ = qwen3_5.apply_text(model.text, cfg, text_ids, attn_mask=mask, cache=cache)
    return mm[:, -1].float(), text[:, -1].float()


def build_model(cfg):
    import torch

    from llm_quest_tpu_torch.models import qwen3_5

    return qwen3_5.init(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)


def check_fp32(base_cfg, inputs):
    import torch

    cfg = dict(base_cfg, dtype=torch.float32)
    model = build_model(cfg)
    plain_cfg = dict(cfg, use_kernels=False)
    lk = prefill_logits(model, cfg, *inputs)
    lp = prefill_logits(model, plain_cfg, *inputs)
    errs = [float((a - b).abs().max()) for a, b in zip(lk, lp)]
    if not all(e <= LOGIT_TOL for e in errs):
        raise AssertionError(f"fp32 prefill logits, kernels vs plain: max abs err {errs} > {LOGIT_TOL}")
    seq_k = run_main_path(model, cfg, *inputs, max_gen=16)
    seq_p = run_main_path(model, plain_cfg, *inputs, max_gen=16)
    for name, a, b in zip(("multimodal", "text_b4"), seq_k, seq_p):
        if not torch.equal(a, b):
            raise AssertionError(f"fp32 {name} greedy tokens differ, kernels vs plain:\n{a[:, -16:]}\n{b[:, -16:]}")
    emit({"phase": "check_fp32", "logit_max_abs_err": {"multimodal": errs[0], "text_b4": errs[1]},
          "logit_tol": LOGIT_TOL, "greedy_tokens_equal": 16})
    del model
    torch.cuda.empty_cache()


def timed(fn, n):
    import torch

    samples = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples), samples


def main_path(cfg, inputs, records, card):
    import torch

    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import qwen3_5

    model = build_model(cfg)
    mm_ids, pixels, text_ids = inputs
    lm, lt = prefill_logits(model, cfg, *inputs)
    if not (torch.isfinite(lm).all() and torch.isfinite(lt).all()):
        raise AssertionError("bf16 prefill logits are not finite")

    reset_launches()
    mm_seq, text_seq = run_main_path(model, cfg, *inputs, max_gen=64)
    torch.cuda.synchronize()
    launches = read_launches(GENERATE, records)
    # the 384 px tower's s 576 is above fused_mha_max_seq: split-heads sdpa, as in JAX
    if launches["packed_mha"] != 0:
        raise AssertionError(f"packed_mha launched {launches['packed_mha']} times on the {GENERATE} path")
    vocab = cfg["vocab_size"]
    expected = ((1, mm_ids.shape[1] + 64), (text_ids.shape[0], text_ids.shape[1] + 64))
    for name, seq, shape in zip(("multimodal", "text_b4"), (mm_seq, text_seq), expected):
        if tuple(seq.shape) != shape or not bool(((seq >= 0) & (seq < vocab)).all()):
            raise AssertionError(f"{name}: bad sequences {tuple(seq.shape)}")
    emit({"phase": "main_path", "dtype": "bfloat16", "launches": launches,
          "multimodal_tokens": mm_seq[0, -64:-48].tolist(), "text_b4_tokens": text_seq[0, -64:-48].tolist()})

    px = pixels.to(cfg["dtype"])
    mm = lambda n: qwen3_5.generate_multimodal(model, cfg, mm_ids, px, max_gen=n, eos_ids=-1, pad_id=0)  # noqa: E731
    tx = lambda n: gen.generate_kv_cache(  # noqa: E731
        qwen3_5.TextOnly, model.text, cfg, text_ids, max_gen=n, eos_ids=-1, pad_id=0
    )
    mm_s, mm_all = timed(lambda: mm(64), 3)
    mm_ttft, _ = timed(lambda: mm(1), 5)
    tx_s, tx_all = timed(lambda: tx(64), 3)
    tx_ttft, _ = timed(lambda: tx(1), 5)
    emit({"phase": "timing", "card": card, "dtype": "bfloat16",
          "multimodal": {"tok_s": 64 / mm_s, "ttft_ms": mm_ttft * 1e3, "run_s": mm_all},
          "text_b4": {"tok_s": 4 * 64 / tx_s, "ttft_ms": tx_ttft * 1e3, "run_s": tx_all}})


# ------------------------------------------------------------ ViT encode path


VIT_ENCODES = 4  # encodes in one timed run


def vit_cfg(n_layers, dtype):
    """bench.py:304's ViT-B/224: ``VIT_BASE_CONFIG`` without dropout (224 px,
    patch 16, emb 768, 12 heads of 64: s 197)."""
    from llm_quest_tpu_torch.config import VIT_BASE_CONFIG

    return dict(VIT_BASE_CONFIG, n_layers=n_layers, drop_rate=0.0, dtype=dtype)


def vit_mode_cfgs(cfg, scales):
    """The encode through K7, and through K8 (dynamic, then calibrated static
    scales) and K9 (the static scales, quantized inside the kernel)."""
    int8 = dict(cfg, int8_scores=True)
    return {"bf16": cfg, "int8_dynamic": int8, "int8_static": dict(int8, int8_qk_scales=scales),
            "int8_inkernel": dict(int8, int8_qk_scales=scales, int8_scores_mode="inkernel")}


def images(b, dtype):
    import torch

    return randn(torch.Generator(device=DEVICE).manual_seed(SEED + 1), b, 3, 224, 224, dtype=dtype)


def vit_fp32():
    """ViT-B's widths cut to 2 layers, b 8, fp32: the logits through each
    packed kernel against the plain versions, within LOGIT_TOL."""
    import torch

    from llm_quest_tpu_torch.models import vit

    cfg = vit_cfg(2, torch.float32)
    model = init_model(vit, cfg)
    x = images(8, torch.float32)
    scales = vit.calibrate_int8_scales(model, cfg, x)
    errs = {}
    with torch.inference_mode():
        for name, mode_cfg in vit_mode_cfgs(cfg, scales).items():
            got, ref = vit.apply(model, mode_cfg, x), vit.apply(model, dict(mode_cfg, use_kernels=False), x)
            errs[name] = float((got - ref).abs().max())
    if not all(e <= LOGIT_TOL for e in errs.values()):
        raise AssertionError(f"vit fp32 logits, kernels vs plain: {errs} > {LOGIT_TOL}")
    emit({"phase": "vit_fp32", "layers": 2, "b": 8, "logit_max_abs_err": errs, "logit_tol": LOGIT_TOL,
          "int8_qk_scales": scales})
    del model
    torch.cuda.empty_cache()


def vit_encode(records, card, b=128):
    """The ViT-B/224 encode at full width and depth, b 128, bf16, under
    ``torch.inference_mode``: once in each mode with the launch counts reset
    first (K7, K8 dynamic, K8 static, K9: 12 launches each), then img/s
    (median of 3 timed runs of VIT_ENCODES encodes), MFU, peak memory and,
    for the int8 modes, the logits' distance from the bf16 encode's."""
    import torch

    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.training import flops as F

    cfg = vit_cfg(12, torch.bfloat16)
    model = init_model(vit, cfg)
    x = images(b, torch.bfloat16)
    scales = vit.calibrate_int8_scales(model, cfg, x)  # before the reset: it runs K7
    cfgs = vit_mode_cfgs(cfg, scales)
    reset_launches()
    with torch.inference_mode():
        logits = {name: vit.apply(model, mode_cfg, x) for name, mode_cfg in cfgs.items()}
    torch.cuda.synchronize()
    launches = read_launches(VIT, records)
    per_encode = {name: launches[name] for name, *_, paths in KERNELS if VIT in paths}
    if any(n != cfg["n_layers"] for n in per_encode.values()):
        raise AssertionError(f"vit_encode launches {per_encode}, expected {cfg['n_layers']} each")
    for name, out in logits.items():
        if tuple(out.shape) != (b, cfg["num_classes"]) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"vit_encode {name}: bad logits {tuple(out.shape)}")
    ref = logits["bf16"].float()
    flops = F.vit_flops_per_image(cfg)
    modes = {}
    for name, mode_cfg in cfgs.items():
        torch.cuda.reset_peak_memory_stats()

        def encodes(mode_cfg=mode_cfg):
            with torch.inference_mode():
                for _ in range(VIT_ENCODES):
                    vit.apply(model, mode_cfg, x)

        encodes()  # warm
        run_s, runs = timed(encodes, 3)
        img_s = b * VIT_ENCODES / run_s
        modes[name] = {"img_s": img_s, "mfu": F.mfu(img_s, flops), "encode_ms": 1e3 * run_s / VIT_ENCODES,
                       "run_s": runs, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if name != "bf16":
            out = logits[name].float()
            modes[name]["max_abs_dlogits_vs_bf16"] = float((out - ref).abs().max())
            modes[name]["argmax_agreement"] = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
    emit({"phase": "vit_encode", "card": card, "dtype": "bfloat16", "layers": cfg["n_layers"], "b": b,
          "launches_per_encode": per_encode, "flops_per_image": flops, "encodes_per_run": VIT_ENCODES,
          "max_abs_logit_bf16": float(ref.abs().max()), "modes": modes})
    del model, logits
    torch.cuda.empty_cache()


def vit_paths(records, card):
    vit_fp32()
    vit_encode(records, card)


# ------------------------------------------------------------ train paths


def train_cfg(n_layers, dtype):
    """bench.py's train workload: Qwen3-0.6B widths, 16 layers at s = 2048,
    no remat (``bench.py::bench_train_step``)."""
    from llm_quest_tpu_torch.config import qwen3_config_creator

    return dict(
        qwen3_config_creator("temp_dense"), n_layers=n_layers, emb_dim=1024, n_heads=16, num_kv_groups=8,
        hidden_dim=3072, context_length=2048, dtype=dtype, gradient_checkpointing=False,
    )


def hybrid_cfg(n_layers, dtype, capacity_factor=None):
    """``scripts/bench_hybrid_training.py``'s configuration: Qwen3-Next-small
    at s = 2048, no dropout, no remat; exact MoE dispatch, or capacity
    dispatch at ``capacity_factor``."""
    from llm_quest_tpu_torch.config import QWEN3_NEXT_SMALL_CONFIG

    return dict(
        QWEN3_NEXT_SMALL_CONFIG, n_layers=n_layers, context_length=2048, dtype=dtype, p_dropout=0.0,
        gradient_checkpointing=False, moe_capacity_factor=capacity_factor,
    )


def train_batch(b, s):
    import numpy as np
    import torch

    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 32_000, (b, s)), device=DEVICE)
    return {"input_ids": ids, "targets": torch.roll(ids, -1, 1)}


def init_model(model_mod, cfg):
    import torch

    return model_mod.init(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)


def grads_check(phase, model_mod, cfg, b, s, *, fused=True, invariant=None, loss_fn=None,
                loss_rtol=TRAIN_LOSS_RTOL, grad_rtol=TRAIN_GRAD_RTOL, batch=None):
    """One fp32 step's loss and gradients, kernels vs plain, same weights;
    ``fused``: the fused-head CE (a model without it takes the full logits).
    ``loss_fn(cfg, model, batch)``, when given, is the loss instead of
    ``make_loss_fn``'s; ``batch`` (default ``train_batch(b, s)``) its
    input. ``invariant`` maps the name of a leaf whose gradient
    is zero in exact arithmetic (fp32 noise on both sides, so no relative
    bar) to the leaf that scales it: both its gradients must stay under
    ``grad_rtol`` times that leaf's (plain) gradient."""
    import torch

    from llm_quest_tpu_torch.training import engine

    model = init_model(model_mod, cfg)
    names = [n for n, _ in model.named_parameters()]
    batch = train_batch(b, s) if batch is None else batch
    results = []
    for use_kernels in (True, False):
        run_cfg = dict(cfg, use_kernels=use_kernels)
        if loss_fn is None:
            loss = engine.make_loss_fn(model_mod, run_cfg, fused_head_ce=fused)(model, batch)
        else:
            loss = loss_fn(run_cfg, model, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        results.append((float(loss.detach()), [g.detach() for g in grads]))
    (lk, gk), (lp, gp) = results
    loss_rel = abs(lk - lp) / abs(lp)
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"{phase} loss, kernels {lk} vs plain {lp}: rel {loss_rel} > {loss_rtol}")
    worst_name, worst, worst_zero = None, 0.0, 0.0
    by_name = dict(zip(names, gp))
    for name, a, r in zip(names, gk, gp):
        ref_name = invariant(name) if invariant else None
        if ref_name is not None:
            rel = max(float(a.abs().max()), float(r.abs().max())) / float(by_name[ref_name].abs().max())
            if not rel <= grad_rtol:
                raise AssertionError(f"{phase} grad {name} (zero in exact arithmetic): {rel} of {ref_name}'s")
            worst_zero = max(worst_zero, rel)
            continue
        diff, scale = float((a - r).abs().max()), float(r.abs().max())
        rel = diff / scale if scale > 0 else diff  # a leaf no token reached: both must be zero
        if not rel <= grad_rtol:
            raise AssertionError(f"{phase} grad {name}: max |kernel - plain| / max |plain| = {rel} > {grad_rtol}")
        if rel >= worst:
            worst_name, worst = name, rel
    emit({"phase": phase, "layers": cfg["n_layers"], "b": b, "s": s, "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": loss_rel, "loss_rtol": loss_rtol, "n_grads": len(names),
          "worst_grad": worst_name, "worst_grad_rel_err": worst, "grad_rtol": grad_rtol,
          **({"worst_zero_grad_ratio": worst_zero} if invariant else {})})
    del model, results
    torch.cuda.empty_cache()


def train_run(phase, model_mod, cfg, records, card, path, per_step, *, add=True, steps=4, b=4, s=2048, fused=True,
              lr=3e-4, make_step=None, batch=None):
    """A bf16 train step through the port's entry points (``make_optimizer``
    → ``make_train_step``, fused-head CE unless not ``fused``; or
    ``make_step(model_mod, cfg, optimizer)``) on ``batch`` (default
    ``train_batch(b, s)``): 1 warm-up and ``steps`` timed
    steps, each ended by a device sync; every kernel of ``per_step`` must
    launch that many times a step, and the loss must be finite and fall."""
    import math

    import torch

    from llm_quest_tpu_torch.training import engine
    from llm_quest_tpu_torch.training import flops as F

    model = init_model(model_mod, cfg)
    optimizer = engine.make_optimizer(lr)
    opt_state = optimizer.init(model)
    if make_step is None:
        step = engine.make_train_step(model_mod, cfg, optimizer, fused_head_ce=fused)
    else:
        step = make_step(model_mod, cfg, optimizer)
    batch = train_batch(b, s) if batch is None else batch

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    model, opt_state, loss0 = step(model, opt_state, batch)  # warm-up
    torch.cuda.synchronize()
    losses, step_s = [loss0], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, opt_state, loss = step(model, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
    dt = sum(step_s) / steps
    launches = read_launches(path, records, add=add)
    losses = [float(x) for x in losses]
    n_steps = steps + 1
    for name, n in per_step.items():
        if launches[name] != n * n_steps:
            raise AssertionError(f"{phase} {name}: {launches[name]} launches in {n_steps} steps, expected {n} per step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} bf16 losses not finite and falling: {losses}")
    tok_s = b * s / dt
    flops_per_token = F.text_train_flops_per_token(cfg, seq_len=s)
    emit({"phase": phase, "card": card, "dtype": "bfloat16", "layers": cfg["n_layers"], "b": b, "s": s, "lr": lr,
          "moe_capacity_factor": cfg.get("moe_capacity_factor"), "fused_head_ce": fused, "launches": launches,
          "launches_per_step": {name: n / n_steps for name, n in launches.items()}, "losses": losses,
          "step_ms": dt * 1e3, "step_ms_each": [x * 1e3 for x in step_s], "tok_s": tok_s,
          "flops_per_token": flops_per_token, "mfu": F.mfu(tok_s, flops_per_token),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del model, opt_state
    torch.cuda.empty_cache()
    return launches, losses


def train_paths(records, card):
    import torch

    from llm_quest_tpu_torch.models import qwen3, qwen3_next

    grads_check("train_fp32", qwen3, train_cfg(2, torch.float32), 1, 2048)
    train_run("train", qwen3, train_cfg(16, torch.bfloat16), records, card, TRAIN,
              {"flash_attention_fwd": 16, "flash_attention_bwd": 16})
    # 4 layers keep one GatedAttention layer (the 4th); s = 512 takes flash
    grads_check("hybrid_fp32", qwen3_next, hybrid_cfg(4, torch.float32), 1, 512)
    hybrid = {"gdn_prefill": 6, "gdn_prefill_bwd": 6, "flash_attention_fwd": 2, "flash_attention_bwd": 2}
    train_run("hybrid_train", qwen3_next, hybrid_cfg(8, torch.bfloat16), records, card, HYBRID, hybrid)
    train_run("hybrid_train", qwen3_next, hybrid_cfg(8, torch.bfloat16, 1.25), records, card, HYBRID, hybrid,
              add=False)


# ------------------------------------------------------------ Gemma-3 path


def gemma_cfg(n_layers, dtype):
    """Gemma-3-270M's published widths (google/gemma-3-270m ``config.json``,
    typed in) on the repo's Gemma-3 architecture: 18 layers, 15 of them SWA
    (window 512, every 6th global), 4/1 heads of 256, about 268 M parameters.
    The one RoPE base is Gemma's local one."""
    return {
        "vocab_size": 262_144, "context_length": 32_768, "emb_dim": 640, "n_layers": n_layers, "n_heads": 4,
        "num_kv_groups": 1, "head_dim": 256, "hidden_dim": 2048, "window_size": GEMMA_WINDOW,
        "local_global_att_ratio": 5, "rope_base": 10_000, "dtype": dtype,
    }


def k4_window_ratio(records):
    """The windowed K4 against the causal one at the same shape: skipping the
    key tiles outside the window must make it at most 0.6× as long (its
    visible work is 0.44×)."""
    ms = {rec["name"]: rec["ms"] for rec in records}
    ratios = {"fwd": ms["flash_attention_fwd_window"] / ms["flash_attention_fwd_causal_d256"],
              "fwd_bwd": ms["flash_attention_fwd_bwd_window"] / ms["flash_attention_fwd_bwd_causal_d256"]}
    work = visible_pairs(GEMMA_K4["s"], GEMMA_WINDOW) / visible_pairs(GEMMA_K4["s"])
    emit({"phase": "k4_window_ratio", "ms_ratio": ratios, "visible_work_ratio": work, "limit": 0.6})
    if not all(r <= 0.6 for r in ratios.values()):
        raise AssertionError(f"windowed K4 not faster than 0.6x causal: {ratios}")


def gemma_generate_check(model, cfg, ids):
    """fp32: the cached prefill (``sdpa`` on the dense SWA and global masks)
    against the uncached forward through the flash kernels, last-position
    logits within LOGIT_TOL."""
    import torch

    from llm_quest_tpu_torch.models import gemma3

    with torch.inference_mode():
        uncached, _, _ = gemma3.apply(model, cfg, ids)
        cache = gemma3.init_cache(cfg, ids.shape[0], ids.shape[1], device=DEVICE)
        cached, _, _ = gemma3.apply(model, cfg, ids, cache=cache)
    err = float((uncached[:, -1].float() - cached[:, -1].float()).abs().max())
    if not err <= LOGIT_TOL:
        raise AssertionError(f"gemma fp32 cached vs uncached (flash) logits: max abs err {err} > {LOGIT_TOL}")
    return err


def gemma_paths(records, card):
    """Gemma-3-270M: the fp32 check (6 layers, 5 SWA + 1 global, b 2, s 1024:
    loss and gradients kernels vs plain, cached vs flash logits), the bf16
    train step at full depth and the bf16 cached generation."""
    import torch

    from llm_quest_tpu_torch.models import gemma3

    fp32 = gemma_cfg(6, torch.float32)
    # a shift common to every key adds one constant to a row's scores, which
    # the softmax cancels: the k-norm shifts' gradients are zero but for noise
    grads_check("gemma_fp32", gemma3, fp32, 2, 1024, fused=False,
                invariant=lambda n: n.replace(".shift", ".scale") if n.endswith("k_norm.shift") else None)
    model = init_model(gemma3, fp32)
    err = gemma_generate_check(model, fp32, ids_on_card(1, 700))
    emit({"phase": "gemma_fp32_cached", "layers": 6, "prompt": 700, "logit_max_abs_err": err, "logit_tol": LOGIT_TOL})
    del model
    torch.cuda.empty_cache()

    per_step = {"flash_attention_fwd_window": 15, "flash_attention_fwd_bwd_window": 15,
                "flash_attention_fwd_causal_d256": 3, "flash_attention_fwd_bwd_causal_d256": 3,
                "flash_attention_fwd": 18, "flash_attention_bwd": 18}
    cfg = gemma_cfg(18, torch.bfloat16)
    # 1e-4: at 3e-4 Adam's first steps overshoot on the N(0, 1) tied table (loss ~120)
    train_run("gemma_train", gemma3, cfg, records, card, GEMMA, per_step, fused=False, lr=1e-4)

    # cached generation: b 1, a 300-token prompt, 16 greedy tokens (the cache
    # branch runs sdpa on the dense masks, as JAX's flash_ok=cache is None)
    model = init_model(gemma3, cfg)
    ids = ids_on_card(1, 300)
    reset_launches()
    seq = generate(gemma3, model, cfg, ids, 16)
    torch.cuda.synchronize()
    launches = {name: launch_count(spec) for name, spec, *_ in KERNELS}
    if tuple(seq.shape) != (1, ids.shape[1] + 16) or not bool(((seq >= 0) & (seq < cfg["vocab_size"])).all()):
        raise AssertionError(f"gemma generation: bad sequences {tuple(seq.shape)}")
    rates = serve_rates(gemma3, model, cfg, ids, max_gen=16)
    emit({"phase": "gemma_generate", "card": card, "dtype": "bfloat16", "layers": 18, "b": 1, "prompt": 300,
          "max_gen": 16, "tokens": seq[0, -16:].tolist(), "launches": launches, **rates})
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ MiMo-V2-Flash path


def mimo_cfg(n_layers, dtype):
    """``MIMO_V2_SMALL_CONFIG`` at full width, ``context_length`` set to the
    sequence length as ``scripts/mimo_training.py`` does (it lengthens only
    the RoPE tables)."""
    from llm_quest_tpu_torch.config import MIMO_V2_SMALL_CONFIG

    return dict(MIMO_V2_SMALL_CONFIG, n_layers=n_layers, context_length=2048, dtype=dtype)


def mimo_paths(records, card):
    """MiMo-V2-Flash small: the fp32 check (6 layers: GA, 4 SWA with sinks, GA;
    b 1, s 512: the MTP loss and every gradient through the kernels against
    the plain versions, with the same routing), then the bf16 12-layer
    train step at b 4, s 2048 through ``make_mimo_train_step``: K4 forward
    and backward 14 times a step (11 windowed with sinks: 9 SWA layers and
    2 MTP blocks; 3 causal GA layers)."""
    import torch

    from llm_quest_tpu_torch.models import mimo_v2_flash as mimo
    from llm_quest_tpu_torch.training import mtp_engine

    counts = []

    def loss_fn(cfg, model, batch):
        loss, aux = mimo.loss(model, cfg, batch["input_ids"], batch["targets"])
        counts.append(torch.stack(aux["moe_counts"]))
        return loss

    grads_check("mimo_fp32", mimo, mimo_cfg(6, torch.float32), 1, 512, loss_fn=loss_fn, loss_rtol=1e-5,
                grad_rtol=1e-4)
    if not torch.equal(counts[0], counts[1]):  # a near-tie routed one token to another expert
        raise AssertionError(f"mimo_fp32: expert counts differ, kernels vs plain:\n{counts[0]}\n{counts[1]}")

    per_step = {"flash_attention_fwd": 14, "flash_attention_bwd": 14,
                "flash_attention_fwd_window_sink_dv32": 11, "flash_attention_fwd_bwd_window_sink_dv32": 11,
                "flash_attention_fwd_causal_dv32": 3, "flash_attention_fwd_bwd_causal_dv32": 3,
                "flash_attention_softcap_sink": 11}
    cfg = mimo_cfg(12, torch.bfloat16)
    launches, losses = train_run("mimo_train", mimo, cfg, records, card, MIMO, per_step, fused=False,
                                 make_step=mtp_engine.make_mimo_train_step)
    emit({"phase": "mimo_train_launches", "k4_fwd": launches["flash_attention_fwd"],
          "k4_fwd_window_sink": launches["flash_attention_fwd_window_sink_dv32"],
          "k4_fwd_causal": launches["flash_attention_fwd_causal_dv32"], "k4_bwd": launches["flash_attention_bwd"],
          "moe_host_syncs_per_step": sum(mimo.is_moe_layer(cfg, i) for i in range(cfg["n_layers"])),
          "final_loss": losses[-1]})


# ------------------------------------------------------------ DeepSeek-V3 path


def dsv3_cfg(n_layers, dtype):
    """``DEEPSEEK_SMALL_CONFIG`` at full width (q_rank 1536, the default),
    ``context_length`` set to the sequence length as
    ``scripts/deepseek_training.py`` does (it lengthens only the RoPE
    tables); ``n_layers`` below 12 keeps the 3 dense layers first."""
    from llm_quest_tpu_torch.config import DEEPSEEK_SMALL_CONFIG

    return dict(DEEPSEEK_SMALL_CONFIG, n_layers=n_layers, context_length=2048, dtype=dtype)


def mtp_batch(b, s, seed=SEED):
    """b rows of s random ids through the MTP collator (its 1-shifted targets
    and 2 pre-shifted pairs), on the card."""
    import numpy as np

    from llm_quest_tpu_torch.data.datasets import collate_function_mtp
    from llm_quest_tpu_torch.training.engine import _as_tensors

    rows = np.random.default_rng(seed).integers(0, 50_000, (b, s)).tolist()
    return _as_tensors(collate_function_mtp(rows, 2), DEVICE)


def dsv3_paths(records, card):
    """DeepSeek-V3 small: the fp32 check (5 layers: 3 dense, 2 MoE; b 1, s
    512: the MTP loss and every gradient through the kernels against the
    plain versions, with the same routing), the bf16 12-layer train step at
    b 4, s 2048 through ``make_deepseek_train_step`` (K4 at (96, 64) forward
    and backward 14 times a step: 12 layers and 2 MTP blocks), then cached
    generation: fp32 tokens against the uncached oracle at 2 layers, and the
    bf16 12-layer model's tok/s and TTFT."""
    import types

    import torch

    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import deepseek_v3 as dsv3
    from llm_quest_tpu_torch.ops import moe as moe_ops
    from llm_quest_tpu_torch.training import mtp_engine

    counts = []

    def loss_fn(cfg, model, batch):
        loss, aux = dsv3.loss(model, cfg, batch["input_ids"], batch["targets"], batch["shifted_inputs"],
                              batch["shifted_targets"])
        counts.append(torch.stack(aux["moe_counts"]))
        return loss

    # wk_up's bias adds one vector to every key of a head, so one constant
    # to each row's scores, which the softmax cancels: its gradients are zero
    # but for noise (the decoupled key's bias is RoPE'd per position: not so)
    grads_check("dsv3_fp32", dsv3, dsv3_cfg(5, torch.float32), 1, 512, loss_fn=loss_fn, loss_rtol=1e-5,
                grad_rtol=1e-4, batch=mtp_batch(1, 512),
                invariant=lambda n: n.replace(".b", ".w") if n.endswith("att.wk_up.b") else None)
    if not torch.equal(counts[0], counts[1]):  # a near-tie routed one token to another expert
        raise AssertionError(f"dsv3_fp32: expert counts differ, kernels vs plain:\n{counts[0]}\n{counts[1]}")

    # the train step, its bias fold recording each step's max_vio (the mean
    # over the MoE layers of (max - mean) / mean of the expert counts)
    vios = []

    def fold(params, cfg, moe_counts):
        vios.append(torch.stack([moe_ops.max_violation(c) for c in moe_counts]).mean())
        return dsv3.update_moe_biases(params, cfg, moe_counts)

    step_model = types.SimpleNamespace(loss=dsv3.loss, update_moe_biases=fold)
    per_step = {"flash_attention_fwd": 14, "flash_attention_bwd": 14,
                "flash_attention_fwd_causal_d96_dv64": 14, "flash_attention_fwd_bwd_causal_d96_dv64": 14}
    cfg = dsv3_cfg(12, torch.bfloat16)
    launches, losses = train_run(
        "dsv3_train", dsv3, cfg, records, card, DSV3, per_step, fused=False, batch=mtp_batch(4, 2048),
        make_step=lambda _, cfg, opt: mtp_engine.make_deepseek_train_step(step_model, cfg, opt))
    emit({"phase": "dsv3_train_launches", "k4_fwd": launches["flash_attention_fwd"],
          "k4_bwd": launches["flash_attention_bwd"], "max_vio_last_step": float(vios[-1]),
          "max_vio_each_step": [float(v) for v in vios], "moe_host_syncs_per_step": cfg["n_layers"] - cfg["num_ffn"],
          "final_loss": losses[-1]})

    # cached generation: the cache holds k at 96 and v at 64 and the calls
    # run sdpa (JAX's flash_ok=cache is None); the uncached oracle runs K4
    fp32 = dsv3_cfg(2, torch.float32)
    model = init_model(dsv3, fp32)
    ids = ids_on_card(1, 300)
    cached = generate(dsv3, model, fp32, ids, 16)
    uncached = gen.generate_loop_uncached(dsv3, model, fp32, ids, max_gen=16)
    if not torch.equal(cached, uncached):
        raise AssertionError(f"dsv3 fp32 cached vs uncached tokens differ:\n{cached[0, -16:]}\n{uncached[0, -16:]}")
    emit({"phase": "dsv3_generate_fp32", "layers": 2, "b": 1, "prompt": 300, "greedy_tokens_equal": 16})
    del model
    torch.cuda.empty_cache()

    model = init_model(dsv3, cfg)
    reset_launches()
    seq = generate(dsv3, model, cfg, ids, 16)
    torch.cuda.synchronize()
    launches = {name: launch_count(spec) for name, spec, *_ in KERNELS}
    if tuple(seq.shape) != (1, ids.shape[1] + 16) or not bool(((seq >= 0) & (seq < cfg["vocab_size"])).all()):
        raise AssertionError(f"dsv3 generation: bad sequences {tuple(seq.shape)}")
    rates = serve_rates(dsv3, model, cfg, ids, max_gen=16)
    emit({"phase": "dsv3_generate", "card": card, "dtype": "bfloat16", "layers": 12, "b": 1, "prompt": 300,
          "max_gen": 16, "tokens": seq[0, -16:].tolist(), "launches": launches, **rates})
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ serving paths


def ids_on_card(b, s, seed=SEED):
    import numpy as np
    import torch

    return torch.as_tensor(np.random.default_rng(seed).integers(0, 32_000, (b, s)), device=DEVICE)


def text_int8_cfg(n_layers, dtype):
    """Qwen3.5-0.8B's text model (``bench.py:129``'s int8 decode cell) with
    the int8 KV cache."""
    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG

    return dict(QWEN3_5_08B_CONFIG, n_layers=n_layers, dtype=dtype, kv_quant="int8")


def next_serve_cfg(n_layers, dtype):
    """Qwen3-Next-small as published in the JAX package's config (context 512)."""
    from llm_quest_tpu_torch.config import QWEN3_NEXT_SMALL_CONFIG

    return dict(QWEN3_NEXT_SMALL_CONFIG, n_layers=n_layers, dtype=dtype, p_dropout=0.0)


def generate(entry, model, cfg, ids, max_gen):
    from llm_quest_tpu_torch.inference import generate as gen

    return gen.generate_kv_cache(entry, model, cfg, ids, max_gen=max_gen, eos_ids=-1, pad_id=0)["sequences"]


def last_prefill_logits(mod, model, cfg, ids):
    import torch

    apply = mod.apply_text if hasattr(mod, "apply_text") else mod.apply
    with torch.inference_mode():
        logits, _, _ = apply(model, cfg, ids, cache=mod.init_cache(cfg, ids.shape[0], ids.shape[1], device=DEVICE))
    return logits[:, -1].float()


def serve_check_fp32(phase, mod, entry, model, cfg, ids, max_gen=16):
    """fp32, the same int8 model through the kernels and through the plain
    versions: prefill logits within INT8_LOGIT_TOL and equal greedy tokens."""
    import torch

    plain = dict(cfg, use_kernels=False)
    err = float((last_prefill_logits(mod, model, cfg, ids) - last_prefill_logits(mod, model, plain, ids)).abs().max())
    if not err <= INT8_LOGIT_TOL:
        raise AssertionError(f"{phase}: prefill logits, kernels vs plain, max abs err {err} > {INT8_LOGIT_TOL}")
    seq_k, seq_p = generate(entry, model, cfg, ids, max_gen), generate(entry, model, plain, ids, max_gen)
    if not torch.equal(seq_k, seq_p):
        raise AssertionError(f"{phase}: greedy tokens differ, kernels vs plain:\n{seq_k[:, -max_gen:]}\n{seq_p[:, -max_gen:]}")
    emit({"phase": phase, "layers": cfg["n_layers"], "b": ids.shape[0], "prompt": ids.shape[1],
          "logit_max_abs_err": err, "logit_tol": INT8_LOGIT_TOL, "greedy_tokens_equal": max_gen})


def serve_rates(entry, model, cfg, ids, max_gen=64):
    """Generated tok/s (median of 3 whole calls) and TTFT (median of 5 calls
    generating one token), each call ended by a device sync."""
    run_s, runs = timed(lambda: generate(entry, model, cfg, ids, max_gen), 3)
    ttft_s, _ = timed(lambda: generate(entry, model, cfg, ids, 1), 5)
    return {"tok_s": ids.shape[0] * max_gen / run_s, "ttft_ms": ttft_s * 1e3, "run_s": runs}


def int8_copy_ms(model):
    """Device time of converting every int8 weight matrix that a decode step
    converts to bf16 once (the linears, the tied table, the shared expert;
    not the routed expert stacks, which K11 reads as int8)."""
    import torch

    mats = [t for n, t in model.state_dict().items() if t.dtype == torch.int8 and ".experts." not in n]
    return cuda_ms(lambda: [t.to(torch.bfloat16) for t in mats], iters=5, warmup=1), sum(map(nbytes, mats))


def serve_path(phase, path, make_model, entry, cfg_bf16, cfg_int8, ids, records, card, quant_options):
    """The bf16 model's rates, then the same weights quantized in place
    (``quantize_params_int8``) driven once with the launch counts reset, then
    timed; MBU from ``training/flops.py``'s byte count at the mean context."""
    import torch

    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8
    from llm_quest_tpu_torch.training import flops as F

    max_gen = 64
    kv_len = ids.shape[1] + max_gen // 2
    model = make_model(cfg_bf16)
    bf16 = serve_rates(entry, model, cfg_bf16, ids)
    bf16["mbu"] = F.mbu(bf16["tok_s"], F.decode_bytes_per_token(model, cfg_bf16, kv_len=kv_len, batch=ids.shape[0]))
    quantize_params_int8(model, **quant_options)
    torch.cuda.empty_cache()
    reset_launches()
    seq = generate(entry, model, cfg_int8, ids, max_gen)
    torch.cuda.synchronize()
    launches = read_launches(path, records)
    if tuple(seq.shape) != (ids.shape[0], ids.shape[1] + max_gen) or not bool(
            ((seq >= 0) & (seq < cfg_int8["vocab_size"])).all()):
        raise AssertionError(f"{phase}: bad sequences {tuple(seq.shape)}")
    int8 = serve_rates(entry, model, cfg_int8, ids)
    bytes_per_token = F.decode_bytes_per_token(model, cfg_int8, kv_len=kv_len, batch=ids.shape[0])
    int8["mbu"] = F.mbu(int8["tok_s"], bytes_per_token)
    copy_ms, int8_bytes = int8_copy_ms(model)
    emit({"phase": phase, "card": card, "dtype": "bfloat16", "layers": cfg_int8["n_layers"], "b": ids.shape[0],
          "prompt": ids.shape[1], "max_gen": max_gen, "launches": launches, "tokens": seq[0, -64:-48].tolist(),
          "int8": int8, "bf16": bf16, "decode_bytes_per_token": bytes_per_token, "mbu_kv_len": kv_len,
          "int8_weight_bytes": int8_bytes, "int8_to_bf16_copy_ms_per_step": copy_ms,
          "step_ms": 1e3 * ids.shape[0] / int8["tok_s"]})
    del model
    torch.cuda.empty_cache()


def serving_paths(records, card):
    """Qwen3.5-0.8B int8 text generation (int8 linears, tied table and KV
    cache; K1, K2, K10) and Qwen3-Next-small int8 cached decode (int8
    linears and expert stacks; K1, K2 at dk 64, K11), each first checked in
    fp32 at 4 layers, kernels against plain."""
    import torch

    from llm_quest_tpu_torch.models import qwen3_5, qwen3_next
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    # fp32 checks: the tables stay fp32 (an int8 table gathers bf16 rows,
    # which would make them bf16 checks)
    def text_model(cfg):
        return qwen3_5.init_text(cfg, generator=torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)

    text = text_int8_cfg(4, torch.float32)
    model = quantize_params_int8(text_model(text))
    serve_check_fp32("int8_generate_fp32", qwen3_5, qwen3_5.TextOnly, model, text, ids_on_card(1, 32))
    nxt = next_serve_cfg(4, torch.float32)
    model = quantize_params_int8(init_model(qwen3_next, nxt))
    serve_check_fp32("next_serve_fp32", qwen3_next, qwen3_next, model, nxt, ids_on_card(2, 64))
    del model
    torch.cuda.empty_cache()

    text_bf16 = {k: v for k, v in text_int8_cfg(24, torch.bfloat16).items() if k != "kv_quant"}
    serve_path("int8_generate", INT8_GENERATE, text_model, qwen3_5.TextOnly, text_bf16,
               text_int8_cfg(24, torch.bfloat16), ids_on_card(1, 32), records, card, {"quantize_embeddings": True})
    nxt = next_serve_cfg(8, torch.bfloat16)
    serve_path("next_serve", NEXT_SERVE, lambda cfg: init_model(qwen3_next, cfg), qwen3_next, nxt, nxt,
               ids_on_card(4, 300), records, card, {})


PROFILE_GROUPS = {  # kernel group: a substring of its kernels' names (K7 runs K4's forward kernel)
    "flash_fwd": "attention_fwd_kernel", "flash_bwd_dq": "attention_bwd_dq_kernel",
    "flash_bwd_dkv": "attention_bwd_dkv_kernel", "gdn_fwd": "gdn_prefill_kernel",
    "gdn_bwd": "gdn_prefill_bwd_kernel", "gdn_bwd_reduce": "gdn_bwd_reduce_kernel",
    "packed_mha_int8": "packed_mha_int8_kernel", "quantize_int8": "quantize_int8_kernel",
}


def profile_window(phase, card, run, steps=2):
    """``torch.profiler`` breakdown of ``steps`` calls of ``run`` (already
    warm): device busy share of the profiled wall, and device time by kernel
    group (the hand-written kernels, cuBLAS GEMMs, everything else). One
    JSON line."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:  # union of the kernel intervals
        if s > hi:
            busy_us, lo = busy_us + hi - lo, s
        hi = max(hi, e)
    busy_us += hi - lo
    by_group = dict.fromkeys([*PROFILE_GROUPS, "gemm", "other"], 0.0)
    by_name = {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        group = next((g for g, key in PROFILE_GROUPS.items() if key in e.name), None)
        if group is None:
            gemm = any(t in e.name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet"))
            group = "gemm" if gemm else "other"
        by_group[group] += ms
    total_ms = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": phase, "card": card, "steps": steps, "wall_ms": wall_ms,
          "device_kernel_ms": total_ms, "device_busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e3 / wall_ms,
          "group_ms_per_step": {g: ms / steps for g, ms in by_group.items()},
          "group_share": {g: ms / total_ms for g, ms in by_group.items()},
          "top_ms_per_step": [[name[:90], ms / steps] for name, ms in top]})


def profile_step(phase, model_mod, cfg, card, fused=True, make_step=None, batch=None):
    """The breakdown of a bf16 train step (b = 4, s = 2048) after 2 warm-up
    steps (``make_step`` and ``batch`` as in ``train_run``)."""
    import torch

    from llm_quest_tpu_torch.training import engine

    model = init_model(model_mod, cfg)
    optimizer = engine.make_optimizer(3e-4)
    state = {"model": model, "opt": optimizer.init(model)}
    if make_step is None:
        step = engine.make_train_step(model_mod, cfg, optimizer, fused_head_ce=fused)
    else:
        step = make_step(model_mod, cfg, optimizer)
    batch = train_batch(4, 2048) if batch is None else batch

    def run():
        state["model"], state["opt"], _ = step(state["model"], state["opt"], batch)

    for _ in range(2):  # warm-up: kernels built, allocator filled
        run()
    profile_window(phase, card, run)
    del model, state
    torch.cuda.empty_cache()


def profile_vit(card, b=128):
    """The breakdown of the bf16 ViT-B/224 encode at b 128, through K7 and
    through K8 with calibrated static scales, after a warm-up encode each."""
    import torch

    from llm_quest_tpu_torch.models import vit

    cfg = vit_cfg(12, torch.bfloat16)
    model = init_model(vit, cfg)
    x = images(b, torch.bfloat16)
    cfgs = vit_mode_cfgs(cfg, vit.calibrate_int8_scales(model, cfg, x))
    for name in ("bf16", "int8_static"):
        def run(mode_cfg=cfgs[name]):
            with torch.inference_mode():
                vit.apply(model, mode_cfg, x)

        run()
        profile_window(f"profile_vit_encode_{name}", card, run)
    del model
    torch.cuda.empty_cache()


def profile_paths(card):
    import torch

    from llm_quest_tpu_torch.models import deepseek_v3, gemma3, mimo_v2_flash, qwen3, qwen3_next
    from llm_quest_tpu_torch.training import mtp_engine

    profile_step("profile_train", qwen3, train_cfg(16, torch.bfloat16), card)
    profile_step("profile_hybrid_train", qwen3_next, hybrid_cfg(8, torch.bfloat16), card)
    profile_step("profile_gemma_train", gemma3, gemma_cfg(18, torch.bfloat16), card, fused=False)
    profile_step("profile_mimo_train", mimo_v2_flash, mimo_cfg(12, torch.bfloat16), card,
                 make_step=mtp_engine.make_mimo_train_step)
    profile_step("profile_dsv3_train", deepseek_v3, dsv3_cfg(12, torch.bfloat16), card,
                 make_step=mtp_engine.make_deepseek_train_step, batch=mtp_batch(4, 2048))
    profile_vit(card)


def main(argv):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="only profile the bf16 dense, hybrid, Gemma-3, MiMo-V2-Flash and DeepSeek-V3 train steps and "
                             "the ViT-B encode (torch.profiler) and print the breakdowns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    try:
        from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
        from llm_quest_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons need full-fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = build.library()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": lib.build_seconds, "load_s": time.perf_counter() - t0})
    if args.profile:
        profile_paths(smi)
        return 0

    records = kernel_phase()
    k4_window_ratio(records)
    vit_paths(records, smi)
    cfg = dict(QWEN3_5_08B_CONFIG)
    inputs = make_inputs(cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    check_fp32(cfg, inputs)
    main_path(cfg, inputs, records, smi)
    train_paths(records, smi)
    gemma_paths(records, smi)
    mimo_paths(records, smi)
    dsv3_paths(records, smi)
    serving_paths(records, smi)

    emit({"kernels": records})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
