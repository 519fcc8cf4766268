"""Where the time and the error of K6/K7's bf16 kernels go, on the card.

Five measurements, one JSON line each, at ViT-B/224's attention (b 128, 12
heads, s 197, d 64) unless said otherwise:

1. ``errors``: K6 at b 2, 3 heads, s 257, causal, d 64: the largest per
   64-row tile error, ‖x − ref‖ / ‖ref‖, of the kernel's output and
   gradients (the backward's δ from the kernel's bf16 output) and of the
   plain version's run in bf16 and in fp32, against the same attention
   computed in fp64.
2. ``backward_ms``: the device time of K7's bf16 forward + backward by
   kernel (``torch.profiler``, 10 calls).
3. ``delta_ms``: the backward's δ = rowsum(dO ⊙ O) in three torch forms
   (CUDA events, 100 calls).
4. ``registers``: ptxas's registers and spills for each instance of the
   tensor-core kernel of ``csrc/fused_mha_tc.cu``.
5. ``variants``: copies of the port, each built with a change to
   ``csrc/fused_mha_tc.cu``, time K7's bf16 forward (CUDA events, 200
   launches, 3 repeats, twice in turn) beside the tree as it is. The
   design choices: one consumer warpgroup a block in place of two
   (``consumers1``), and 256-key score chunks in place of 128 with one
   warpgroup, so that a tile's whole score row is one chunk
   (``chunk256``). Copies without one piece of work (the score
   product, the exp, P·V, the output stores) say what each costs; they
   give wrong outputs, so every copy is timed, never checked. With
   ``--against DIR``, the package under DIR (another checkout's root) is
   timed beside them as ``against``.

    python -m tools.short_attention_probe [--against DIR]

from the root of the repo. Needs the card and nvcc; the copies are built
under ``llm_quest_tpu_torch/_build/probe/``.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
import probe_harness as ph  # noqa: E402

from llm_quest_tpu_torch.kernels import attention, build, fused_mha  # noqa: E402

B, S, H, D = 128, 197, 12, 64
KERNEL_SRC = build.CSRC_DIR / "fused_mha_tc.cu"

# name: [(text in csrc/fused_mha_tc.cu, its replacement), ...]
ONE_WG = ("constexpr int kConsumers = 2;", "constexpr int kConsumers = 1;")
VARIANTS = {
    "consumers1": [ONE_WG],
    "chunk256": [ONE_WG, ("constexpr int kChunk = 128;", "constexpr int kChunk = 256;")],
    "no_s_mma": [("mma_ss<N>(s, QT::kmajor", "if (key0 < 0) mma_ss<N>(s, QT::kmajor")],
    "no_exp": [("s[pc4][e] = exp2f(s[pc4][e] - m[(e / 2) & 1]);", "s[pc4][e] = s[pc4][e] - m[(e / 2) & 1];")],
    "no_pv": [("mma_rs<BW>(o[nb], af, ", "if (a.S < 0) mma_rs<BW>(o[nb], af, ")],
    "no_store": [("*reinterpret_cast<__nv_bfloat162*>(orow", "if (a.S < 0) *reinterpret_cast<__nv_bfloat162*>(orow")],
}

TIMER = f"""
import json, sys, torch
from llm_quest_tpu_torch.kernels import attention
g = torch.Generator(device="cuda").manual_seed(0)
q, k, v = (torch.randn({B}, {S}, {H * D}, generator=g, device="cuda").bfloat16() for _ in range(3))
for _ in range(20):
    attention.packed_mha(q, k, v, {H})
torch.cuda.synchronize()
ms = []
for _ in range(3):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(200):
        attention.packed_mha(q, k, v, {H})
    b.record()
    b.synchronize()
    ms.append(a.elapsed_time(b) / 200)
print(json.dumps(ms))
"""


def _env(root):
    """The environment of a process that imports the copy at ``root``."""
    return {**os.environ, "PYTHONPATH": str(root)}


def build_variants(against=None):
    """A copy of the package for each variant (and "tree", unchanged, and
    "against", the package under ``against``), each with its library built;
    returns {name: the copy's root}."""
    root = build.BUILD_DIR / "probe"
    copies = {}
    for name in ("tree", *VARIANTS, *(("against",) if against else ())):
        dst = root / name
        shutil.rmtree(dst, ignore_errors=True)
        package = os.path.join(against, "llm_quest_tpu_torch") if name == "against" else build.PACKAGE_DIR
        shutil.copytree(package, dst / "llm_quest_tpu_torch", ignore=shutil.ignore_patterns("_build", "__pycache__"))
        if name in VARIANTS:
            src = dst / "llm_quest_tpu_torch" / "csrc" / KERNEL_SRC.name
            src.write_text(ph.apply_edits(src.read_text(), VARIANTS[name], f"variant {name}"))
        copies[name] = dst
    procs = {name: subprocess.Popen([sys.executable, "-c", "from llm_quest_tpu_torch.kernels import build; "
                                     "build.library()"], cwd=dst, env=_env(dst))
             for name, dst in copies.items()}
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"variant {name} did not build")
    return copies


def time_variants(copies):
    ms = {name: [] for name in copies}
    for _ in range(2):
        for name, dst in copies.items():
            out = subprocess.run([sys.executable, "-c", TIMER], cwd=dst, env=_env(dst), capture_output=True,
                                 text=True, check=True).stdout
            ms[name].extend(json.loads(out.strip().splitlines()[-1]))
    return {name: {"ms": v, "median_ms": sorted(v)[len(v) // 2]} for name, v in ms.items()}


def registers():
    """{kernel instance: registers and spills} from ptxas."""
    def label(name):
        inst = re.search(r"fused_mha_tc_kernelILi(\d+)ELi(\d+)E", name)
        return f"D {inst.group(1)}, NWG {inst.group(2)}" if inst else name

    return ph.ptxas_registers(KERNEL_SRC.name, label)


def backward_breakdown(gen):
    q, k, v, do = (torch.randn(B, S, H * D, generator=gen, device="cuda").bfloat16() for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def run():
        return torch.autograd.grad(attention.packed_mha(*leaves, H), leaves, do)

    for _ in range(5):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = ph.kernel_name(e.name)
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / 10
    return sorted(by_name.items(), key=lambda kv: -kv[1])


def delta_forms(gen):
    """δ = rowsum(dO ⊙ O) of K7's backward as torch reductions on the
    (b, h, s, d) views of packed bf16 dO and O (CUDA events, 100 calls)."""
    do, o = (attention.split_heads(torch.randn(B, S, H * D, generator=gen, device="cuda").bfloat16(), H)
             for _ in range(2))
    forms = {
        "both_cast": lambda: (do.float() * o.float()).sum(-1).contiguous(),
        "do_cast": lambda: (do.float() * o).sum(-1).contiguous(),
        "bf16_products": lambda: (do * o).sum(-1, dtype=torch.float32).contiguous(),
    }
    return {name: ph.events_ms(fn, 100) for name, fn in forms.items()}


def fp64_attention(q, k, v, causal):
    s = q.shape[2]
    scores = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
    return torch.softmax(scores, -1) @ v


def tile_err(got, ref):
    diff = got.double() - ref
    pad = (-ref.shape[-2]) % 64
    tiles = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad)).unflatten(-2, (-1, 64)).square().sum((-2, -1))  # noqa: E731
    return float((tiles(diff) / tiles(ref).clamp_min(1e-300)).sqrt().max())


def errors(gen, s=257, d=64):
    q, k, v, do = (torch.randn(2, 3, s, d, generator=gen, device="cuda").bfloat16() for _ in range(4))

    def grads(fn, dtype):
        leaves = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return [out.detach(), *torch.autograd.grad(out, leaves, do.to(out.dtype))]

    ref = grads(lambda *a: fp64_attention(*a, True), torch.float64)
    runs = {
        "kernel": grads(lambda *a: fused_mha.fused_mha(*a, causal=True), torch.bfloat16),
        "plain_bf16": grads(lambda *a: fused_mha.fused_mha(*a, causal=True, plain=True), torch.bfloat16),
        "plain_fp32": grads(lambda *a: fused_mha.fused_mha(*a, causal=True, plain=True), torch.float32),
    }
    return {name: dict(zip(("o", "dq", "dk", "dv"), (tile_err(g, r) for g, r in zip(got, ref))))
            for name, got in runs.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="the root of another checkout, whose K7 forward is timed beside the tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("short_attention_probe runs on the card")
    smi = ph.card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps({"card": smi, "errors": errors(gen)}), flush=True)
    print(json.dumps({"card": smi, "backward_ms": backward_breakdown(gen)[:8]}), flush=True)
    print(json.dumps({"card": smi, "delta_ms": delta_forms(gen)}), flush=True)
    print(json.dumps({"card": smi, "registers": registers()}), flush=True)
    print(json.dumps({"card": smi, "variants": time_variants(build_variants(args.against))}), flush=True)


if __name__ == "__main__":
    main()
