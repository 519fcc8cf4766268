"""K8/K9's bf16 times and the int8-score ViT-B encodes on the card, this tree beside another checkout's.

At ViT-B/224's encode shape (b 128, s 197, 12 heads of 64), bf16 inputs:
K8 with dynamic scales, K8 with static ones and K9, and K7's bf16 forward
on the same inputs; each by CUDA events (``ms``, 200 calls after 10) and by
the ``torch.profiler`` trace of 20 calls (``device_ms``: all of a call's
device work, with the per-kernel split in ``kernels``). Then the ViT-B/224
encode at full depth, b 128, bf16, under ``torch.inference_mode``, in each
mode (bf16 through K7; int8 dynamic, int8 static, int8 inkernel): ms an
encode and img/s (median of 3 runs of 4 encodes, as ``chip_smoke.py``'s
``vit_encode``), and the K7/K8/K9 launches of one encode.

    python -m tools.int8_attention_probe [--against DIR] [--variants]

from the root of the repo. With ``--against DIR`` the package under DIR
(another checkout's root, e.g. the parent commit unpacked by ``git
archive``) is measured too; each tree runs in its own process, in turns
(A B B A), one JSON line each. Needs the card and nvcc; each tree builds its
kernels into its own ``_build``.

With ``--variants``, one more line: the bf16 kernel of K9 and of K8 with
dynamic scales (``csrc/packed_mha_int8.cu`` and ``csrc/packed_mha_int8_tc.cu``
alone, built into a small library under
``llm_quest_tpu_torch/_build/int8_variants/``, called through its C entry)
as the tree has it and in copies each with one change (``VARIANTS``), timed
on the same inputs at ViT-B's shape (CUDA events, 200 launches, 3 repeats,
twice in turn), each copy's outputs against the tree's (max |diff|; the
copies that leave out a piece of work give wrong outputs and say what the
piece costs).
"""

import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))  # the harness, also where a measuring process runs this file
import probe_harness as ph  # noqa: E402

VIT_B = (128, 197, 12, 64)  # b, s, heads, d
ENCODES = 4  # encodes in one timed run
TC_SRC = "packed_mha_int8_tc.cu"
# name: [(text in csrc/packed_mha_int8_tc.cu, its replacement), ...]
VARIANTS = {
    "consumers1": [("constexpr int kConsumers = 2;", "constexpr int kConsumers = 1;")],
    "expf": [("exp_approx(__fsub_rn(", "expf(__fsub_rn(")],
    "no_pass1": [("for (int it = 0; it < 2 * n_chunks; ++it) {", "for (int it = n_chunks; it < 2 * n_chunks; ++it) {")],
    "no_exp": [("exp_approx(__fsub_rn(__fmul_rn((float)s[pp][e], dq), m[(e / 2) & 1]))",
                "__fsub_rn(__fmul_rn((float)s[pp][e], dq), m[(e / 2) & 1])")],
    "div_exact": [("return fabsf(__fsub_rn(fabsf(__fsub_rn(y, n)), 0.5f)) < 6.103515625e-05f ? __fdiv_rn(x, s) : y;",
                   "return __fdiv_rn(x, s);")],
    "no_q_quant": [("quantize_q<D>(div, q_s, q_stage, sq, rq, tid);", "")],
    "no_k_quant": [("quantize_k<D>(div, k_s, kx, a.k_ss, n16_all * 16, S, sk, rk, threadIdx.x, NWG * kWG);", "")],
    "no_pv": [("mma_rs<BW>(o[nb], af, ", "if (S < 0) mma_rs<BW>(o[nb], af, ")],
}


def measure():
    """One JSON line of this process's package (``llm_quest_tpu_torch`` as imported)."""
    import torch

    import llm_quest_tpu_torch
    from llm_quest_tpu_torch.config import VIT_BASE_CONFIG
    from llm_quest_tpu_torch.kernels import attention, build, fused_mha
    from llm_quest_tpu_torch.models import vit

    lib = build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def device(fn, iters=20):
        split = ph.device_split(fn, iters)
        return (sum(split.values()) if split else None), split

    b, s, h, d = VIT_B
    q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    ss = (float(q.float().abs().max()) / 127.0, float(k.float().abs().max()) / 127.0)
    calls = {
        "k8_dynamic": lambda: fused_mha.packed_mha_int8(q, k, v, h),
        "k8_static": lambda: fused_mha.packed_mha_int8(q, k, v, h, static_scales=ss),
        "k9": lambda: fused_mha.packed_mha_int8_inkernel(q, k, v, h, ss),
        "k7": lambda: attention.packed_mha(q, k, v, h),
    }
    result = {"package": str(Path(llm_quest_tpu_torch.__file__).parent), "card": torch.cuda.get_device_name(0),
              "build_s": lib.build_seconds, "shape": list(VIT_B)}
    for name, fn in calls.items():
        dev, split = device(fn)
        result[name] = {"ms": ph.events_ms(fn), "device_ms": dev, "kernels": split}
    del q, k, v

    cfg = dict(VIT_BASE_CONFIG, n_layers=12, drop_rate=0.0, dtype=torch.bfloat16)
    model = vit.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    x = torch.randn(b, 3, 224, 224, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    x = x.bfloat16()
    scales = vit.calibrate_int8_scales(model, cfg, x)
    int8 = dict(cfg, int8_scores=True)
    modes = {"bf16": cfg, "int8_dynamic": int8, "int8_static": dict(int8, int8_qk_scales=scales),
             "int8_inkernel": dict(int8, int8_qk_scales=scales, int8_scores_mode="inkernel")}
    counters = (attention.packed_mha, fused_mha.packed_mha_int8, fused_mha.packed_mha_int8_inkernel)
    encodes = {}
    for name, mode_cfg in modes.items():
        def run(mode_cfg=mode_cfg, n=ENCODES):
            with torch.inference_mode():
                for _ in range(n):
                    vit.apply(model, mode_cfg, x)

        before = [w.launches for w in counters]
        run(n=1)
        launches = {w.__name__: w.launches - n0 for w, n0 in zip(counters, before)}
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3 / ENCODES)
        encode_ms = statistics.median(samples)
        encodes[name] = {"encode_ms": encode_ms, "img_s": b / encode_ms * 1e3, "samples_ms": samples,
                         "launches": launches}
    result["encodes"] = encodes
    print(json.dumps(result), flush=True)


def time_variants():
    """One JSON line: K9's bf16 kernel as the tree has it and in each VARIANTS copy."""
    import ctypes

    import numpy as np
    import torch

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, s, h, d = VIT_B
    q, k, v = (torch.randn(b, s, h * d, generator=gen, device="cuda").bfloat16() for _ in range(3))
    q_s, k_s = (float(t.float().abs().max()) / 127.0 for t in (q, k))
    consts = [F(float(np.float32(q_s * k_s * d**-0.5))), F(float(np.float32(1.0 / q_s))),
              F(float(np.float32(1.0 / k_s))), F(0.0)]
    amax = torch.stack([t.float().abs().amax() for t in (q, k)])
    dyn = amax / amax.new_full((2,), 127.0) + 1e-12  # K8's dynamic scales, on the device
    dyn_consts = [F(0.0), F(0.0), F(0.0), F(float(np.float32(d**-0.5)))]
    strides = [L(x) for _ in range(4) for x in (s * h * d, d, h * d)]
    stream = torch.cuda.current_stream().cuda_stream
    libs, outs, calls = {}, {}, {}
    copies = {"tree": ([], []), **{name: ([], edits) for name, edits in VARIANTS.items()}}
    for name, path in ph.variant_libraries("int8_variants", ["packed_mha_int8.cu", TC_SRC], copies, TC_SRC).items():
        lib = ctypes.CDLL(str(path))
        fn = lib.llmq_packed_mha_int8
        fn.argtypes = [I] + [P] * 5 + [F] * 4 + [I] * 4 + [L] * 12 + [P]
        fn.restype = I
        libs[name] = lib
        for mode, scales, cs in (("k9", None, consts), ("k8_dynamic", dyn.data_ptr(), dyn_consts)):
            o = torch.empty_like(q)
            args = [I(1), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), scales, *cs, I(b), I(s), I(h),
                    I(d), *strides, stream]
            calls[name, mode] = lambda fn=fn, args=args: fn(*args)
            if calls[name, mode]() != 0:
                raise RuntimeError(f"variant {name}: the {mode} launch failed")
            outs[name, mode] = o
    torch.cuda.synchronize()
    ms = ph.time_in_turns(calls)
    variants = {}
    for (name, mode), v in ms.items():
        diff = float((outs[name, mode].float() - outs["tree", mode].float()).abs().max())
        variants.setdefault(name, {})[mode] = {"ms": v, "median_ms": statistics.median(v), "max_abs_diff": diff}
    print(json.dumps({"variants": variants, "card": torch.cuda.get_device_name(0), "shape": list(VIT_B)}),
          flush=True)


def main(argv):
    return ph.main(argv, script=__file__, doc=__doc__, measure=lambda args: measure(),
                   variants=lambda args: time_variants())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
