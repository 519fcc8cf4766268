"""Run named kernel records and phases of ``chip_smoke.py`` on the card, alone.

    python3 -m tools.smoke_phases NAME [NAME ...]

from the root of the repo. Builds the kernels, then runs each NAME that is a
kernel record of ``chip_smoke.KERNELS`` (its check against the plain version
and its timing, one JSON line each) and then each NAME that is a phase
function of ``chip_smoke.py`` taking ``(records, card)`` (``gpt2_train``,
``engine_llama``, ``engine_families``, ...), through ``chip_smoke.phase``
with the plain-version sentinels installed, as the whole script runs it;
last the ``phase_seconds`` line and the card's name and power limit. A
quick way to try a record or a path without the whole script's 15 minutes.
"""

import subprocess
import sys
import time

import torch

import chip_smoke as cs
from llm_quest_tpu_torch.kernels import build


def main(names):
    records = {spec[0]: spec for spec in cs.KERNELS}
    phases = [n for n in names if n not in records]
    unknown = [n for n in phases if not callable(getattr(cs, n, None))]
    if unknown or not names:
        raise SystemExit(f"smoke_phases: not a kernel record or phase of chip_smoke.py: {unknown or '(none given)'}")
    if not torch.cuda.is_available():
        raise SystemExit("smoke_phases: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons need full-fp32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = build.library()
    cs.emit({"phase": "device", "nvidia_smi": smi, "build_s": lib.build_seconds, "torch": torch.__version__})
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    for name in names:
        if name in records:
            fn = records[name][4]
            t1 = time.perf_counter()
            err, ms, plain_ms, cases, extra = fn(gen, (torch.float32, torch.bfloat16))
            cs.emit({"phase": "kernel", "name": name, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "cases": cases, **{k: extra.get(k) for k in ("bound_ms", "bound_by", "library_ms", "device_ms",
                                                                   "tile_err_bf16", "max_abs_err_bf16")},
                     "seconds": time.perf_counter() - t1})
            torch.cuda.empty_cache()
    cs.install_plain_sentinels()
    path_records = [{"launches": 0} for _ in cs.KERNELS]
    for name in phases:
        cs.phase(getattr(cs, name), path_records, smi)
    cs.emit({"phase": "phase_seconds", **cs.PHASE_SECONDS, "total_s": time.perf_counter() - t0})
    print(smi)


if __name__ == "__main__":
    main(sys.argv[1:])
