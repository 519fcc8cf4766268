"""K12's and K10's bf16 times on the card, this tree beside another checkout's.

K12 (the int8-score ablation's attention core) at the ablation's shapes
(bf16 scores: G 1536, M 208, D 64; int8 scores: M 224, D 128), with the
script's seeded inputs; K10 (flash decode over the int8 KV cache) with bf16
q at four shapes: ``decode`` (b 1, 8/2 heads, d 256, S 96: the int8
Qwen3.5 generation path), ``long`` (b 16, S 8192), ``long_b1`` (b 1, S
8192) and ``qwen3`` (b 4, 16/8 heads, d 128, S 300), the cache written as
the model writes it, a random key mask as the bias. Each call by CUDA
events (``ms``, 200 calls after 10), by the ``torch.profiler`` trace of 20
calls (``device_ms``: the kernel's device time; ``kernels``: every kernel
of the call), by the host's clock around 20 calls that are not waited for
(``host_us``: the time a call takes to return), and against its plain
version (max |error|; K12 also whether every output is within
``k12_tolerance``).

    python -m tools.k10_k12_probe [--against DIR] [--variants]

from the root of the repo (``tools/probe_harness.py``: with ``--against
DIR`` the package under DIR is measured too, in turns A B B A, one JSON line
each).

With ``--variants``, one more line: the two tensor-core kernels alone
(``csrc/attn_core_tc.cu``; ``csrc/flash_decode.cu`` with
``csrc/flash_decode_tc.cu``), built into small libraries under
``llm_quest_tpu_torch/_build/k10_k12_variants/``, each copy with one
source edit (``VARIANTS``: K12 with half the persistent grid; K10's ring
at 6 stages in place of 4, four consumer warps a block with 3 stages, so
that two blocks share an SM, and a copy that only streams the tiles, which
gives wrong outputs and says what the products cost), called through their
C entries at the shapes above (K10 at ``plan``'s split: ``chip_smoke.py``
sweeps the split); each by CUDA events (200 launches, 3 repeats, twice in
turn) and against the tree's output; with the registers and spills ptxas
reports for the two sources.
"""

import ctypes
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))  # the harness, also where a measuring process runs this file
import probe_harness as ph  # noqa: E402

K10_SHAPES = {"decode": (1, 8, 2, 96, 256), "long": (16, 8, 2, 8192, 256), "long_b1": (1, 8, 2, 8192, 256),
              "qwen3": (4, 16, 8, 300, 128)}  # b, hq, hkv, S, d
# name: (the kernel it changes, [(old, new) edits of its tensor-core source])
FD_TC = "flash_decode_tc.cu"
STAGES = "constexpr int kStages = 4;"
VARIANTS = {
    "tree": ("both", []),
    "k12_half_grid": ("k12", [("const int blocks = sms * (per_sm > 0 ? per_sm : 1);",
                               "const int blocks = sms * (per_sm > 0 ? per_sm : 1) / 2;")]),
    "k10_stages6": ("k10", [(STAGES, "constexpr int kStages = 6;")]),
    # four consumer warps and 3 stages: two blocks an SM
    "k10_warps4": ("k10", [("constexpr int kNW = 8;", "constexpr int kNW = 4;"),
                           (STAGES, "constexpr int kStages = 3;"),
                           ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")]),
    # the loads alone (wrong outputs): what the pipeline streams without the products
    "k10_no_math": ("k10", [("if (key0 < key_end) {", "if (key0 < 0) {")]),
}
SOURCES = {"k12": ["attn_core_tc.cu"], "k10": ["flash_decode.cu", FD_TC]}
TARGETS = {"k12": "attn_core_tc.cu", "k10": FD_TC}


def k12_inputs():
    """{variant: (t, q, k, v)} at the ablation's shapes, the script's seeded inputs."""
    import torch

    from llm_quest_tpu_torch.scripts import ablate_int8_scores as ab

    bf16, int8 = ab.inputs()
    t = torch.full((1, 1, ab.K), 0.01, dtype=torch.bfloat16, device="cuda")
    return {"bf16": (t, *bf16), "int8": (t, *int8)}


def k10_inputs():
    """{shape: (q, k_q, k_s, v_q, v_s, bias)}: bf16 q and one int8 cache layer as the model writes it."""
    import torch

    from llm_quest_tpu_torch.inference import cache as kv_cache
    from llm_quest_tpu_torch.ops.masks import mask_value

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (b, hq, hkv, s_len, d) in K10_SHAPES.items():
        cache = kv_cache.init_kv_cache(2, b, hkv, s_len, d, quant="int8", device="cuda")
        kv = [torch.randn(b, hkv, s_len, d, generator=gen, device="cuda").bfloat16() for _ in range(2)]
        _, k, v = kv_cache.write_layer(cache, 1, *kv, 0)
        valid = torch.rand(b, s_len, generator=gen, device="cuda") > 0.1
        valid[:, 0] = True
        bias = torch.where(valid, 0.0, mask_value(torch.float32)).float()
        q = torch.randn(b, hq, 1, d, generator=gen, device="cuda").bfloat16()
        out[name] = (q, k.data, k.scale, v.data, v.scale, bias)
    return out


def record(fn, ref, key):
    split = ph.device_split(fn)
    err = float((fn().float() - ref.float()).abs().max())
    return {"ms": ph.events_ms(fn), "device_ms": sum(t for n, t in split.items() if key in n), "kernels": split,
            "host_us": ph.host_ms(fn) * 1e3, "max_abs_err": err}


def measure(args):
    """One JSON line of this process's package (``llm_quest_tpu_torch`` as imported)."""
    import torch

    import llm_quest_tpu_torch
    from llm_quest_tpu_torch.kernels import attn_core as ac
    from llm_quest_tpu_torch.kernels import build
    from llm_quest_tpu_torch.kernels import flash_decode as fd

    lib = build.library()
    result = {"package": str(Path(llm_quest_tpu_torch.__file__).parent), "card": ph.card(),
              "build_s": lib.build_seconds}
    for name, (t, q, k, v) in k12_inputs().items():
        ref = ac.attn_core(t, q, k, v, plain=True)
        fn = lambda t=t, q=q, k=k, v=v: ac.attn_core(t, q, k, v)  # noqa: E731
        rec = record(fn, ref, "attn_core")
        err = (fn().float() - ref.float()).abs()
        rec["within_tolerance"] = bool((err <= ac.k12_tolerance(t, q, k, v, ref)).all())
        tc = getattr(ac.attn_core, "tc_launches", None)
        fn()
        rec["tc_launch"] = None if tc is None else ac.attn_core.tc_launches > tc
        result[f"k12_{name}"] = rec
        del ref, err
    torch.cuda.empty_cache()
    for name, inputs in k10_inputs().items():
        fn = lambda inputs=inputs: fd.flash_decode(*inputs)  # noqa: E731
        rec = record(fn, fd.flash_decode(*inputs, plain=True), "flash_decode")
        tc = getattr(fd.flash_decode, "tc_launches", None)
        fn()
        rec["tc_launch"] = None if tc is None else fd.flash_decode.tc_launches > tc
        result[f"k10_{name}"] = rec
    print(json.dumps(result), flush=True)


def time_variants(args):
    """One JSON line: the two kernels in each VARIANTS copy."""
    import torch

    from llm_quest_tpu_torch.kernels import flash_decode as fd

    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    libs = {}
    for part in ("k12", "k10"):
        copies = {name: ([], edits) for name, (which, edits) in VARIANTS.items() if which in (part, "both")}
        for name, path in ph.variant_libraries(f"k10_k12_variants/{part}", SOURCES[part], copies,
                                               TARGETS[part]).items():
            libs[part, name] = ctypes.CDLL(str(path))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    calls, outs = {}, {}
    for case, (t, q, k, v) in k12_inputs().items():
        g, m, _ = q.shape
        for (part, name), lib in libs.items():
            if part != "k12":
                continue
            fn = lib.llmq_attn_core
            fn.argtypes, fn.restype = [I] + [P] * 5 + [I] * 2 + [P], I
            o = torch.empty(g, m, 64, dtype=torch.bfloat16, device="cuda")
            a = [I(int(q.dtype == torch.int8)), t.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), I(g), I(m), stream]
            calls[f"k12_{case}", name], outs[f"k12_{case}", name] = (lambda fn=fn, a=a: fn(*a)), o
    for case, (q, k_q, k_s, v_q, v_s, bias) in k10_inputs().items():
        b, hq, _, d = q.shape
        hkv, s_len = k_q.shape[1], k_q.shape[2]
        planned = fd.plan(b, hkv, s_len, sms)
        for (part, name), lib in libs.items():
            if part != "k10":
                continue
            fn = lib.llmq_flash_decode
            fn.argtypes, fn.restype = [I] + [P] * 9 + [I] * 7 + [L] * 13 + [F, P], I
            o = torch.empty_like(q)
            a = [I(1), q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(),
                 bias.data_ptr(), None, None, o.data_ptr(), I(b), I(hq), I(hkv), I(s_len), I(d), I(planned), I(0),
                 *(L(x) for x in (q.stride(0), q.stride(1), *k_q.stride()[:3], *k_s.stride()[:2],
                                  *v_q.stride()[:3], *v_s.stride()[:2], bias.stride(0))),
                 F(d**-0.5), stream]
            calls[f"k10_{case}", name], outs[f"k10_{case}", name] = (lambda fn=fn, a=a: fn(*a)), o
    for key, call in calls.items():
        if call() != 0:
            raise RuntimeError(f"variant {key}: the launch failed")
    torch.cuda.synchronize()
    ms = ph.time_in_turns(calls)
    variants = {}
    for (case, name), v in ms.items():
        diff = float((outs[case, name].float() - outs[case, "tree"].float()).abs().max())
        variants.setdefault(case, {})[name] = {**ph.summary(v), "max_abs_diff": diff}
    for case in variants:
        if case.startswith("k10_"):
            variants[case]["split"] = fd.plan(*_shape(case), sms)
    registers = {src: ph.ptxas_registers(src) for src in ("attn_core_tc.cu", FD_TC)}
    print(json.dumps({"variants": variants, "registers": registers, "card": ph.card()}), flush=True)


def _shape(case):
    """(b, hkv, S) of a K10 case: ``plan``'s arguments but the SM count."""
    b, _, hkv, s_len, _ = K10_SHAPES[case.removeprefix("k10_")]
    return b, hkv, s_len


def main(argv):
    return ph.main(argv, script=__file__, doc=__doc__, measure=measure, variants=time_variants)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
