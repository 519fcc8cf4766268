"""K2's (the GDN decode step's) times on the card with the L2 cold, this tree beside another checkout's.

Four shapes (``SHAPES``), bf16 q/k/v, beta in bf16 (as the models' sigmoid
gives it) and alpha in fp32, the fp32 state from a seed: ``b1``
(Qwen3.5-0.8B generation: b 1, h 16, dk = dv = 128), ``next``
(Qwen3-Next-small serving: b 4, 8 v heads, dk = dv = 64, q and k repeated
to the 8 heads, which every tree takes; ``next_hqk4`` the same at their own
4 heads, which only a tree whose kernel reads q/k at their own head count
takes, else skipped), ``b32`` and ``b128`` (``bench.py``'s decode sweep: h
16, dk = dv = 128). Each shape:

- ``device_ms``: the step kernel's device time a launch (the kernels whose
  names hold ``gdn_step``) with the L2 cold: a ``torch.profiler`` trace of
  launches back to back, each on the next layer of a stack of distinct
  states that total at least ROTATE_BYTES (128 MB, 2.5 times the H100's
  50 MB L2), so that no launch finds its state in the L2 and the dirty
  lines each launch leaves there are written back inside later launches'
  time, as in a decode step; ``call_device_ms``: all of the call's kernels
  in the same trace (a cast before the step included);
  ``device_ms_beta32``: the step kernel the same way with beta given in
  fp32, so that no tree launches a cast between two steps; ``warm_device_ms``:
  the same kernel launched back to back on one state (a state that fits
  the L2 stays there);
- ``events_ms``: CUDA events around 200 calls back to back (the median of
  3); ``host_us``: the host's clock around 50 calls not waited for (the
  wrapper's work; the median of 5);
- ``inplace_mul_ms``: ``x.mul_(1.0)`` over the same states by the same
  rotation, which reads and writes the same bytes: what one PyTorch kernel
  streams them at (no PyTorch call computes the step);
- ``bound_ms`` (bytes over 3.35 TB/s) and ``max_abs_err`` against the
  plain version.

Then two decode steps by ``generate_kv_cache``, random weights from a seed,
bf16, prompt 32: ``qwen35_b128`` (Qwen3.5-0.8B text, 24 layers, b 128,
``bench.py``'s decode sweep) and ``next_b4`` (Qwen3-Next-small, 8 layers,
b 4): the device ms a decode step, K2's part of it and the kernels launched
a step, from profiler traces of a 1-token and a 9-token call (their
difference over 8 steps).

    python -m tools.gdn_step_probe [--against DIR] [--variants]

from the root of the repo (``tools/probe_harness.py``: with ``--against
DIR`` the package under DIR is measured too, in turns A B B A, one JSON line
each).

With ``--variants``, one more line: ``csrc/gdn.cu`` alone built into small
libraries under ``llm_quest_tpu_torch/_build/gdn_step_variants/``, each copy
with one source edit (``VARIANTS``: 4 or 16 warps, so state rows, a block
in place of 8; the state row loaded after the small loads; the qk head
index taken out), called through
the C entry at ``b1``, ``next``, ``b32`` and ``b128`` with q/k at v's heads
(so that every copy's result is right), each cold as above, twice in
turns, with its output and state against the tree's, and the registers and
spills ptxas reports.
"""

import ctypes
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))  # the harness, also where a measuring process runs this file
import probe_harness as ph  # noqa: E402

# name: (b, h, h_qk, dk = dv)
SHAPES = {"b1": (1, 16, 16, 128), "next": (4, 8, 8, 64), "next_hqk4": (4, 8, 4, 64), "b32": (32, 16, 16, 128),
          "b128": (128, 16, 16, 128)}
KEY = "gdn_step"  # the step kernel's name stem, in every tree
ROTATE_BYTES = 128 * 2**20
HBM_BYTES_PER_S = 3.35e12
SRC = "gdn.cu"
SOURCES = ["gdn.cu", "gdn_tc.cu"]  # gdn.cu's entries call into gdn_tc.cu's bf16 routes
ROWS = "constexpr int kStepRows = 8;"
STEP = "  const float o = row_step(st, kv, qv, al, bt, vi, a.scale);\n"
VARIANTS = {
    "tree": [],
    "rows4": [(ROWS, "constexpr int kStepRows = 4;")],
    "rows16": [(ROWS, "constexpr int kStepRows = 16;")],
    # the state row loaded after the small loads
    "state_last": [("  load_row(st, st_ptr);\n\n", "\n"),
                   (STEP, "  load_row(st, st_ptr);\n" + STEP)],
    # without the qk head index, which the parent's kernel did not have (right where h_qk = h, as here)
    "no_qk_index": [("const int hq = (int)((hi * a.rep_magic) >> 32);", "const int hq = hi;")],
}


def rotated_split(calls):
    """{kernel: device ms a call} from a trace of ``calls`` made in turn, back to back (twice over, 20 at least)."""
    turn = iter(range(10**9))
    return ph.device_split(lambda: calls[next(turn) % len(calls)](), iters=max(20, 2 * len(calls)))


def step_inputs(shape, seed=0):
    """q, k (b, h_qk, dk) and v (b, h, dv) bf16, beta (b, h) bf16, alpha (b, h) fp32, and a stack of fp32
    states (n, b, h, dv, dk) of at least ROTATE_BYTES and two layers."""
    import torch

    b, h, h_qk, d = SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def unit(*s):
        x = torch.randn(*s, generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).bfloat16()

    q, k, v = unit(b, h_qk, d), unit(b, h_qk, d), torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
    beta = torch.sigmoid(torch.randn(b, h, generator=gen, device="cuda")).bfloat16()
    alpha = torch.sigmoid(torch.randn(b, h, generator=gen, device="cuda") * 0.3 + 2.0)
    n = max(2, -(-ROTATE_BYTES // (4 * b * h * d * d)))
    stacked = torch.randn(n, b, h, d, d, generator=gen, device="cuda") * 0.1
    return q, k, v, beta, alpha, stacked


def state_bytes(shape):
    """What a launch must move: one layer's fp32 state read and written, q/k/v/beta/alpha read, out written."""
    b, h, h_qk, d = SHAPES[shape]
    return 8 * b * h * d * d + 2 * 2 * b * h_qk * d + 2 * b * h * d + 6 * b * h + 2 * b * h * d


def measure_step(shape):
    import torch

    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha, stacked = step_inputs(shape)
    ref_state = stacked[0].clone()

    def call(layer=0):
        return gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, layer)

    try:
        out, _ = call()
    except ValueError as e:  # a tree whose kernel takes only repeated q/k heads
        return {"skipped": str(e)}
    ref_out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, ref_state[None], 0, plain=True)
    err = max(float((out.float() - ref_out.float()).abs().max()), float((stacked[0] - ref_state).abs().max()))
    layers = range(stacked.shape[0])
    split = rotated_split([lambda i=i: call(i) for i in layers])
    beta32 = beta.float()
    split32 = rotated_split([lambda i=i: gdn.gated_delta_rule_step_stacked(q, k, v, beta32, alpha, stacked, i)
                             for i in layers])
    warm = ph.device_split(call)
    mul = rotated_split([lambda i=i: stacked[i].mul_(1.0) for i in layers])
    rec = {"device_ms": sum(t for n, t in split.items() if KEY in n), "call_device_ms": sum(split.values()),
           "kernels": split, "device_ms_beta32": sum(t for n, t in split32.items() if KEY in n),
           "states": len(layers), "warm_device_ms": sum(t for n, t in warm.items() if KEY in n),
           "events_ms": statistics.median(ph.events_ms(call) for _ in range(3)),
           "host_us": statistics.median(ph.host_ms(call, iters=50) for _ in range(5)) * 1e3,
           "inplace_mul_ms": sum(mul.values()),
           "bound_ms": state_bytes(shape) / HBM_BYTES_PER_S * 1e3, "max_abs_err": err}
    rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"] if rec["device_ms"] else None
    del stacked
    torch.cuda.empty_cache()
    return rec


def decode_step(name):
    """Device ms, K2's ms and kernels a decode step of model ``name``, from a 1-token and a 9-token call."""
    import torch
    from torch.autograd import DeviceType

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG, QWEN3_NEXT_SMALL_CONFIG
    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import qwen3_5, qwen3_next

    g = torch.Generator(device="cuda").manual_seed(0)
    if name == "qwen35_b128":
        cfg, b = dict(QWEN3_5_08B_CONFIG, dtype=torch.bfloat16), 128
        model, entry = qwen3_5.init_text(cfg, generator=g, device="cuda"), qwen3_5.TextOnly
    else:
        cfg, b = dict(QWEN3_NEXT_SMALL_CONFIG, n_layers=8, dtype=torch.bfloat16, p_dropout=0.0), 4
        model, entry = qwen3_next.init(cfg, generator=g, device="cuda"), qwen3_next
    ids = torch.randint(0, 32_000, (b, 32), generator=g, device="cuda")

    def run(n):
        return gen.generate_kv_cache(entry, model, cfg, ids, max_gen=n, eos_ids=-1, pad_id=0)["sequences"]

    totals = {}
    for n in (1, 9):
        run(n)
        torch.cuda.synchronize()
        for _ in range(3):  # a trace without the card's activity is taken again
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                run(n)
                torch.cuda.synchronize()
            events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if events:
                break
        kernels = [e for e in events if not e.name.startswith("Memcpy") and not e.name.startswith("Memset")]
        totals[n] = (sum(e.time_range.elapsed_us() for e in events) / 1e3, len(kernels),
                     sum(e.time_range.elapsed_us() for e in events if KEY in e.name) / 1e3)
    steps = 8
    rec = {"b": b, "layers": cfg["n_layers"], "prompt": 32,
           "device_ms_per_step": (totals[9][0] - totals[1][0]) / steps,
           "kernels_per_step": (totals[9][1] - totals[1][1]) / steps,
           "k2_device_ms_per_step": (totals[9][2] - totals[1][2]) / steps}
    rec["k2_share"] = rec["k2_device_ms_per_step"] / rec["device_ms_per_step"] if rec["device_ms_per_step"] else None
    del model
    torch.cuda.empty_cache()
    return rec


def measure(args):
    """One JSON line of this process's package (``llm_quest_tpu_torch`` as imported)."""
    import llm_quest_tpu_torch
    from llm_quest_tpu_torch.kernels import build

    lib = build.library()
    result = {"package": str(Path(llm_quest_tpu_torch.__file__).parent), "card": ph.card(),
              "build_s": lib.build_seconds}
    for shape in SHAPES:
        result[shape] = measure_step(shape)
    for name in ("qwen35_b128", "next_b4"):
        result[name] = decode_step(name)
    print(json.dumps(result), flush=True)


def time_variants(args):
    """One JSON line: the step kernel in each VARIANTS copy at the four shapes, cold."""
    import torch

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for name, path in ph.variant_libraries("gdn_step_variants", SOURCES, {n: ([], e) for n, e in VARIANTS.items()},
                                           SRC).items():
        fn = ctypes.CDLL(str(path)).llmq_gdn_step_stacked
        fn.argtypes, fn.restype = [I] * 3 + [P] * 6 + [I, P] + [I] * 15 + [F, P], I
        libs[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for shape in ("b1", "next", "b32", "b128"):
        b, h, h_qk, d = SHAPES[shape]
        q, k, v, beta, alpha, stacked = step_inputs(shape)
        start = stacked[0].clone()
        out = torch.empty(b, h, d, dtype=q.dtype, device="cuda")

        def args(layer):
            return [I(1), I(1), I(0), q.data_ptr(), k.data_ptr(), v.data_ptr(), beta.data_ptr(), alpha.data_ptr(),
                    stacked.data_ptr(), I(layer), out.data_ptr(), I(b), I(h), I(h_qk), I(d), I(d),
                    *(I(x) for x in (*q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *beta.stride(),
                                     *alpha.stride())), F(d**-0.5), stream]

        outs, rec = {}, {}
        for name in list(VARIANTS) + list(VARIANTS)[::-1]:  # each twice, in turns
            stacked[0].copy_(start)
            err = libs[name](*args(0))
            if err != 0:
                rec[name] = {"refused": err}
                continue
            outs[name] = (out.clone(), stacked[0].clone())
            calls = [lambda fn=libs[name], a=args(i): fn(*a) for i in range(stacked.shape[0])]
            rec.setdefault(name, {"device_ms": []})["device_ms"].append(
                sum(t for n, t in rotated_split(calls).items() if KEY in n))
        ref = outs["tree"]
        for name, (o, st) in outs.items():
            rec[name]["max_abs_diff"] = max(float((o.float() - ref[0].float()).abs().max()),
                                            float((st - ref[1]).abs().max()))
        result[shape] = rec
        del stacked, start, outs
        torch.cuda.empty_cache()
    print(json.dumps({"variants": result, "registers": ph.ptxas_registers(SRC), "card": ph.card()}), flush=True)


def main(argv):
    return ph.main(argv, script=__file__, doc=__doc__, measure=measure, variants=time_variants)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
