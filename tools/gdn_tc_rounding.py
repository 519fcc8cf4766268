"""How far the operand rounding of K1's bf16 tensor-core kernels moves their results, on the CPU.

``tests/test_torch_gdn_chunked.py`` transcribes the kernels' phases in fp64
with their rounding points. At the hybrid train step's shape (b 4, h 8,
s 2048, dk = dv = 64, bf16 inputs) this prints, for several choices of the
rounding of the fp32 operands of the products, each output's and gradient's
error against the exact transcription, over the card's bf16 bar of 2e-2
(``chip_smoke.py``'s TOL and TILE_TOL): the largest absolute error over
max(1, max |exact|) and the largest 64-token tile error. The choices:

- ``split``: bf16 hi + bf16 lo everywhere (the kernels' choice);
- ``bf16``: bf16 alone everywhere (``LLMQ_GDN_TC_SPLIT 0``);
- ``bf16 in F1`` (and F2, F3, B1, B2): bf16 alone in that phase, the split
  in the others.

Each at three decays: α = sigmoid(N(μ, 0.3)) with μ 2 (about 0.88, as
``chip_smoke.py``'s inputs), 5 and 8 (about 0.993 and 0.9997: long-memory
heads, whose state carries its rounding over many chunks).

    python -m tools.gdn_tc_rounding

from the root of the repo (about a minute on a few CPU cores; needs JAX for
the test module's imports).
"""

import importlib.util
import json
from pathlib import Path

import torch

TEST = Path(__file__).resolve().parent.parent / "tests" / "test_torch_gdn_chunked.py"


def main():
    spec = importlib.util.spec_from_file_location("test_torch_gdn_chunked", TEST)
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    split, bf16 = oracle.split_round, oracle.bf16_round
    choices = {"split": split, "bf16": bf16}
    for phase in oracle.PHASES:
        choices[f"bf16 in {phase}"] = {p: bf16 if p == phase else split for p in oracle.PHASES}
    for mu in (2.0, 5.0, 8.0):
        for name, rnd in choices.items():
            readings = oracle.hybrid_readings(rnd, decay=mu)
            print(json.dumps({"rounding": name, "alpha_logit_mean": mu, "bar": oracle.BF16_TOL,
                              "max_abs_over_bar": {n: e / oracle.BF16_TOL for n, (e, _) in readings.items()},
                              "tile_over_bar": {n: t / oracle.BF16_TOL for n, (_, t) in readings.items()}}),
                  flush=True)


if __name__ == "__main__":
    main()
