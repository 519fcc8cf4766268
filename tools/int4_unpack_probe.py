"""Time the unpacking of packed int4 weights into bf16 on the card.

    python3 -m tools.int4_unpack_probe

from the root of the repo. For each shape (Qwen3-30B-A3B's untied head and
its q projection, Qwen3.5-0.8B's tied table; (out, in) as the port stores
them), CUDA events time ``ops/int4.py::unpack_int4`` (6 half-width passes
in place), the earlier 7-pass in-place form kept here for comparison, and
the int8 weight's ``.to(bfloat16)`` of the same shape (one pass, the
conversion an int8 linear makes). Each is checked equal to the int8 values'
conversion first. One JSON line a shape, then the card's name and power
limit as nvidia-smi gives them.
"""

import json
import subprocess

import torch

from llm_quest_tpu_torch.ops.int4 import pack_int4, unpack_int4

SHAPES = {"qwen3_30b_head": (151936, 2048), "qwen3_30b_wq": (4096, 2048), "qwen3_5_table": (248320, 1024)}
REPS = 20


def unpack_seven_passes(packed, width, dtype):
    """The earlier form: 7 half-width passes in place in ``dtype``."""
    s = packed.view(torch.int8)
    out = torch.empty(s.shape[0], 2 * s.shape[1], dtype=dtype, device=s.device)
    lo, hi = out[:, 0::2], out[:, 1::2]
    hi.copy_(s)
    hi.div_(16, rounding_mode="floor")
    lo.copy_(s)
    lo.add_(hi, alpha=-16)
    lo.add_(8).remainder_(16).sub_(8)
    return out[:, :width]


def event_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main():
    if not torch.cuda.is_available():
        raise SystemExit("int4_unpack_probe: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (d_out, d_in) in SHAPES.items():
        q = torch.randint(-7, 8, (d_out, d_in), generator=gen, device="cuda", dtype=torch.int8)
        packed, ref = pack_int4(q), q.to(torch.bfloat16)
        forms = {"unpack_int4": lambda: unpack_int4(packed, d_in, dtype=torch.bfloat16),
                 "seven_passes": lambda: unpack_seven_passes(packed, d_in, torch.bfloat16),
                 "int8_to_bf16": lambda: q.to(torch.bfloat16)}
        for form, fn in forms.items():
            if not torch.equal(fn(), ref):
                raise AssertionError(f"{name}: {form} differs from the int8 values' conversion")
        times = {form: event_ms(fn) for form, fn in forms.items()}
        bf16_gb = d_out * d_in * 2 / 1e9
        print(json.dumps({"shape": name, "out_in": [d_out, d_in], "bf16_gb": bf16_gb,
                          **{f"{form}_ms": t for form, t in times.items()},
                          "bound_ms": (packed.numel() + 2 * d_out * d_in) / 3.35e12 * 1e3}), flush=True)
        del q, packed, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
