"""K11's bf16 times and int8 Qwen3-Next's time to first token on the card, this tree beside another checkout's.

At Qwen3-Next-small's widths (8 experts; lin1/gate 896 -> 3584, lin2 3584
-> 896), bf16 rows of a top-2 routing of 4 tokens (decode, T 8) and of 1200
(prefill, T 2400), seeded as ``chip_smoke.py``'s kernel phase seeds them:
K11 by CUDA events (``ms``, 200 calls after 10) and by a ``torch.profiler``
trace of 20 calls (``device_ms``: the K11 kernels; ``call_device_ms``: all
of a call's device work), and its max |error| against the plain version.
Then Qwen3-Next-small at 8 layers, bf16, b 4, 300-token prompts
(``chip_smoke.py``'s ``next_serve``): the bf16 model's TTFT, then the same
weights quantized int8 (linears and expert stacks): TTFT (median of 5
calls generating one token), that call's device time and K11's share of it
(profiler, 3 calls), and K11's device time per decode step (a 17-token call
less the 1-token call, over 16 steps).

    python -m tools.qgmm_probe [--against DIR] [--variants]

from the root of the repo. With ``--against DIR`` the package under DIR
(another checkout's root, e.g. the parent commit unpacked by ``git
archive``) is measured too; each tree runs in its own process, in turns
(A B B A), one JSON line each. Needs the card and nvcc; each tree builds its
kernels into its own ``_build``.

With ``--variants``, one more line: the tensor-core kernel
(``csrc/quantized_gmm.cu`` and ``csrc/quantized_gmm_tc.cu`` alone, built
into small libraries under ``llm_quest_tpu_torch/_build/qgmm_variants/``
and called through their C entry) at the four cases, as the tree plans them
and with one choice undone (``VARIANTS``: no K split, 2 or 4 stages at
most, the ring sized for one block an SM, other row tiles), each by CUDA
events (200 launches, 3 repeats, twice in turn) and against the tree's
output.
"""

import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))  # the harness, also where a measuring process runs this file
import probe_harness as ph  # noqa: E402

E = 8
MATS = {"lin1": (896, 3584), "lin2": (3584, 896)}
TOKENS = {"decode": 4, "prefill": 1200}  # top-2: T 8 and T 2400
# name: (nvcc -D flags, {case: (row tile, K parts)} replacing the plan's; None keeps the plan's)
VARIANTS = {
    "tree": ([], {}),
    "no_split": ([], {"decode_lin1": (None, 1), "decode_lin2": (None, 1), "prefill_lin1": (None, 1),
                      "prefill_lin2": (None, 1)}),
    "stages2": (["-DLLMQ_QGMM_STAGES=2"], {}),
    "stages4": (["-DLLMQ_QGMM_STAGES=4"], {}),
    "one_block_per_sm": (["-DLLMQ_QGMM_BLOCKS_PER_SM=1"], {}),
    "rows16": ([], {"decode_lin1": (16, None), "decode_lin2": (16, None)}),
    "rows64": ([], {"prefill_lin1": (64, None), "prefill_lin2": (64, None)}),
    "split2": ([], {"decode_lin1": (None, 2), "decode_lin2": (None, 2), "prefill_lin2": (None, 2)}),
    "split8": ([], {"decode_lin2": (None, 8)}),
}


def k11_ms(split):
    return sum(ms for name, ms in split.items() if "quantized_gmm" in name)


def cases():
    """{case: (x, w_q, scale, group_sizes)} on the card, seeded (the same tensors in every tree)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for regime, tokens in TOKENS.items():
        logits = torch.randn(tokens, E, generator=gen, device="cuda")
        gs = torch.bincount(logits.topk(2, dim=-1).indices.reshape(-1), minlength=E)
        for mat, (k, n) in MATS.items():
            w_q = torch.randint(-127, 128, (E, k, n), generator=gen, device="cuda", dtype=torch.int8)
            scale = torch.rand(E, n, generator=gen, device="cuda") * 0.02 + 1e-3
            x = torch.randn(2 * tokens, k, generator=gen, device="cuda").bfloat16()
            out[f"{regime}_{mat}"] = (x, w_q, scale, gs)
    return out


def serve(result):
    """Qwen3-Next-small's int8 TTFT beside bf16's, its device time, K11's
    share, and K11 per decode step; into ``result["next_serve"]``."""
    import numpy as np
    import torch

    from llm_quest_tpu_torch.config import QWEN3_NEXT_SMALL_CONFIG
    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import qwen3_next
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    cfg = dict(QWEN3_NEXT_SMALL_CONFIG, n_layers=8, dtype=torch.bfloat16, p_dropout=0.0)
    model = qwen3_next.init(cfg, generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 32_000, (4, 300)), device="cuda")

    def run(n):
        return gen.generate_kv_cache(qwen3_next, model, cfg, ids, max_gen=n, eos_ids=-1, pad_id=0)["sequences"]

    def ttft_ms():
        samples = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(1)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples[1:]), samples[1:]

    out = {"bf16_ttft_ms": ttft_ms()[0]}
    quantize_params_int8(model)
    torch.cuda.empty_cache()
    out["ttft_ms"], out["ttft_samples_ms"] = ttft_ms()
    first = ph.device_split(lambda: run(1), iters=3)
    out["ttft_device_ms"], out["k11_device_ms"] = sum(first.values()), k11_ms(first)
    more = ph.device_split(lambda: run(17), iters=1)
    out["k11_device_ms_per_step"] = (k11_ms(more) - out["k11_device_ms"]) / 16
    out["device_ms_per_step"] = (sum(more.values()) - out["ttft_device_ms"]) / 16
    result["next_serve"] = out


def measure():
    """One JSON line of this process's package (``llm_quest_tpu_torch`` as imported)."""
    import torch

    import llm_quest_tpu_torch
    from llm_quest_tpu_torch.kernels import build
    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    lib = build.library()
    result = {"package": str(Path(llm_quest_tpu_torch.__file__).parent), "card": torch.cuda.get_device_name(0),
              "build_s": lib.build_seconds}
    w = qg.quantized_ragged_dot
    for name, (x, w_q, scale, gs) in cases().items():
        fn = lambda x=x, w_q=w_q, scale=scale, gs=gs: w(x, w_q, scale, gs)  # noqa: E731
        tc = getattr(w, "tc_launches", None)
        err = float((fn().float() - w(x, w_q, scale, gs, plain=True).float()).abs().max())
        split = ph.device_split(fn)
        result[name] = {"ms": ph.events_ms(fn), "device_ms": k11_ms(split), "call_device_ms": sum(split.values()),
                        "kernels": split, "max_abs_err": err, "group_sizes": gs.tolist(),
                        "tc_launch": None if tc is None else w.tc_launches - tc > 0}
    serve(result)
    print(json.dumps(result), flush=True)


def time_variants():
    """One JSON line: the tensor-core kernel at the four cases as the tree
    plans them and in each VARIANTS copy or choice."""
    import ctypes

    import torch

    from llm_quest_tpu_torch.kernels import quantized_gmm as qg

    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    built = {name: (flags, []) for name, (flags, _) in VARIANTS.items() if flags or name == "tree"}
    for name, path in ph.variant_libraries("qgmm_variants", ["quantized_gmm.cu", "quantized_gmm_tc.cu"],
                                           built).items():
        lib = ctypes.CDLL(str(path))
        lib.llmq_quantized_gmm.argtypes = [I] + [P] * 4 + [I, P] + [I] * 8 + [P]
        lib.llmq_quantized_gmm.restype = I
        libs[name] = lib
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    calls, outs, chosen = {}, {}, {}
    for case, (x, w_q, scale, gs) in cases().items():
        (t, k), (e, _, n) = x.shape, w_q.shape
        planned = qg.plan(t, k, n, e, sms)
        for name, (flags, overrides) in VARIANTS.items():
            over = overrides.get(case, (None, None))
            if not flags and name != "tree" and case not in overrides:
                continue
            rows, split = (o if o is not None else p for o, p in zip(over, planned))
            lib = libs[name if flags else "tree"]
            y = torch.empty(t, n, dtype=x.dtype, device="cuda")
            args = [I(1), x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), gs.data_ptr(), I(1), y.data_ptr(), I(t),
                    I(e), I(k), I(n), I(8), I(1), I(rows), I(split), stream]
            call = lambda fn=lib.llmq_quantized_gmm, args=args: fn(*args)  # noqa: E731
            if call() != 0:
                raise RuntimeError(f"variant {name}: the {case} launch failed")
            calls[name, case], outs[name, case], chosen[name, case] = call, y, (rows, split)
    torch.cuda.synchronize()
    ms = ph.time_in_turns(calls)
    variants = {}
    for (name, case), v in ms.items():
        diff = float((outs[name, case].float() - outs["tree", case].float()).abs().max())
        variants.setdefault(name, {})[case] = {"rows": chosen[name, case][0], "split": chosen[name, case][1],
                                               "ms": v, "median_ms": statistics.median(v), "max_abs_diff": diff}
    print(json.dumps({"variants": variants, "card": torch.cuda.get_device_name(0)}), flush=True)


def main(argv):
    return ph.main(argv, script=__file__, doc=__doc__, measure=lambda args: measure(),
                   variants=lambda args: time_variants())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
