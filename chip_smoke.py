#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``llm_quest_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the port's
kernels from ``llm_quest_tpu_torch/csrc`` at first use. Phases, one JSON line
each on stdout:

1. device: the card's name and the kernels' build time;
2. kernels: each hand-written kernel against its plain PyTorch version on the
   card, fp32 and bf16, at Qwen3.5-0.8B shapes, with the tolerances below,
   and the time of both versions at the main path's shape;
3. check_fp32: the full-width Qwen3.5-0.8B main path (random weights from a
   seeded generator) in fp32, once through the kernels and once with the
   plain versions forced: prefill logits close, first 16 greedy tokens equal;
4. main_path: the same two entry points in bf16 with every kernel's launch
   count reset first — ``generate_multimodal`` (a 384 px image, the
   156-token prompt of bench.py, 64 greedy tokens) and ``generate_kv_cache``
   at b = 4 with a 300-token prompt — and every kernel must have launched;
5. timing: tok/s and TTFT of both, with the card's name and power limit.

Then the kernels summary line, the ``nvidia-smi`` name/power-limit line and,
last, ``{"ok": true, "device": {...}}``. Any failure exits nonzero before the
last line; there is no CPU fallback.
"""

import json
import statistics
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
SEED = 0
DEVICE = "cuda"


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


def max_err(got, ref):
    return float((got.float() - ref.float()).abs().max()), float(ref.float().abs().max())


def check(name, got, ref, dtype):
    err, scale = max_err(got, ref)
    tol = TOL[str(dtype).removeprefix("torch.")] * max(1.0, scale)
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


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
    from llm_quest_tpu_torch.kernels import gdn

    errs, cases = [], []
    for dtype in dtypes:
        for b, s in ((1, 156), (4, 300)):
            q, k, v, beta, alpha, s0 = gdn_inputs(gen, b, 16, s, dtype)
            out, st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0)
            ref_out, ref_st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0, plain=True)
            torch_sync()
            e = max(check(f"K1 out b={b} s={s} {dtype}", out, ref_out, dtype),
                    check(f"K1 state b={b} s={s} {dtype}", st, ref_st, dtype))
            cases.append({"b": b, "s": s, "dtype": str(dtype), "max_abs_err": e})
            if dtype == dtypes[0]:
                errs.append(e)
    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 1, 16, 156, dtypes[-1])
    ms = cuda_ms(lambda: gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0))
    plain_ms = cuda_ms(lambda: gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0, plain=True))
    return max(errs), ms, plain_ms, cases


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
    q, k, v, beta, alpha, _ = gdn_inputs(gen, 1, 16, 1, dtypes[-1])
    q, k, v, beta, alpha = q[:, :, 0], k[:, :, 0], v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
    stacked = randn(gen, 18, 1, 16, 128, 128, scale=0.1)
    ms = cuda_ms(lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer))
    plain_ms = cuda_ms(lambda: gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer, plain=True))
    return max(errs), ms, plain_ms, cases


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
    return max(errs), ms, plain_ms, cases


def kernel_k7(gen, dtypes):
    from llm_quest_tpu_torch.kernels import attention as attn

    errs, cases = [], []
    for dtype in dtypes:
        for b, s in ((1, 576), (8, 197)):
            q, k, v = (randn(gen, b, s, 12 * 64, dtype=dtype) for _ in range(3))
            out = attn.packed_mha(q, k, v, 12)
            ref = attn.packed_mha(q, k, v, 12, plain=True)
            torch_sync()
            e = check(f"K7 b={b} s={s} {dtype}", out, ref, dtype)
            cases.append({"b": b, "s": s, "dtype": str(dtype), "max_abs_err": e})
            if dtype == dtypes[0]:
                errs.append(e)
    q, k, v = (randn(gen, 1, 576, 12 * 64, dtype=dtypes[-1]) for _ in range(3))
    ms = cuda_ms(lambda: attn.packed_mha(q, k, v, 12))
    plain_ms = cuda_ms(lambda: attn.packed_mha(q, k, v, 12, plain=True))
    return max(errs), ms, plain_ms, cases


def torch_sync():
    import torch

    torch.cuda.synchronize()  # a fault inside a kernel surfaces here, at its phase


KERNELS = [
    # name, wrapper (module, attribute), source, replaced TPU kernel, check
    ("gdn_prefill", ("gdn", "gated_delta_rule_fwd"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:205", kernel_k1),
    ("gdn_step_stacked", ("gdn", "gated_delta_rule_step_stacked"), "llm_quest_tpu_torch/csrc/gdn.cu",
     "llm_quest_tpu/kernels/gdn_pallas.py:350", kernel_k2),
    ("flash_attention_fwd", ("attention", "flash_attention"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/flash_attention.py:544", kernel_k4),
    ("packed_mha", ("attention", "packed_mha"), "llm_quest_tpu_torch/csrc/attention.cu",
     "llm_quest_tpu/kernels/fused_mha.py:422", kernel_k7),
]


def wrapper(spec):
    import importlib

    return getattr(importlib.import_module(f"llm_quest_tpu_torch.kernels.{spec[0]}"), spec[1])


def kernel_phase():
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    records = []
    for name, spec, source, replaces, fn in KERNELS:
        err, ms, plain_ms, cases = fn(gen, (torch.float32, torch.bfloat16))
        emit({"phase": "kernel", "name": name, "cases": cases, "ms_bf16": ms, "plain_ms_bf16": plain_ms})
        records.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    return records


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

    wrappers = [wrapper(spec) for _, spec, *_ in KERNELS]
    for w in wrappers:
        w.launches = 0
    mm_seq, text_seq = run_main_path(model, cfg, *inputs, max_gen=64)
    torch.cuda.synchronize()
    launches = [w.launches for w in wrappers]
    for rec, n in zip(records, launches):
        rec["launches"] = n
    if not all(launches):
        counts = dict(zip([r["name"] for r in records], launches))
        raise AssertionError(f"kernels not launched on the main path: {counts}")
    vocab = cfg["vocab_size"]
    expected = ((1, mm_ids.shape[1] + 64), (text_ids.shape[0], text_ids.shape[1] + 64))
    for name, seq, shape in zip(("multimodal", "text_b4"), (mm_seq, text_seq), expected):
        if tuple(seq.shape) != shape or not bool(((seq >= 0) & (seq < vocab)).all()):
            raise AssertionError(f"{name}: bad sequences {tuple(seq.shape)}")
    emit({"phase": "main_path", "dtype": "bfloat16", "launches": dict(zip([r["name"] for r in records], launches)),
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


def main():
    import torch

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

    records = kernel_phase()
    cfg = dict(QWEN3_5_08B_CONFIG)
    inputs = make_inputs(cfg, torch.Generator(device=DEVICE).manual_seed(SEED))
    check_fp32(cfg, inputs)
    main_path(cfg, inputs, records, smi)

    emit({"kernels": records})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
