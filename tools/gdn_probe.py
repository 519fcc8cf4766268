"""K1's bf16 times on the card, this tree beside another checkout's.

At the hybrid train step's GDN shape (b 4, h 8, s 2048, dk = dv = 64) and
the Qwen3.5-0.8B prefill's (b 1, h 16, s 156, dk = dv = 128, with a prior
state), in bf16: the forward without a gradient, the forward keeping its
anchors, the backward from those anchors, and forward + backward through
autograd; each by CUDA events (``ms``, 20 calls after 3), by the host's
clock around 20 calls that are not waited for (``host_ms``: the time a
call takes to return, its launch work), and by the ``torch.profiler``
trace of 10 calls (``device_ms``: the device time of all of a call's
kernels, with the per-kernel split in ``kernels``). Also: the host µs a
call spends inside the C entry points (``c_entry_us``: ctypes, the
tensor-map encodes, the launches), at the prefill shape also for a forward
whose q, k and v are new tensors at every call (``fwd_new_inputs``: 80 sets
in turn, as a model's layers hand it new tensors: what a cache of tensor
maps by address would not save); two backward runs from the same anchors
compared bit for bit; and, at the hybrid shape, the kernels against their
plain version (``accuracy``: the largest 64-token tile error and the largest
absolute error over max(1, max |plain|), each over the bf16 bar of 2e-2,
for the output, the final state and the five gradients), once with the
decay of ``chip_smoke.py``'s inputs (alpha = sigmoid(N(2, 0.3)), about 0.88)
and once with a slow one (sigmoid(N(5, 0.3)), about 0.993: long-memory
heads).

    python -m tools.gdn_probe [--against DIR] [--bf16-alone] [--ttft]

from the root of the repo. With ``--against DIR`` the package under DIR
(another checkout's root, e.g. the parent commit unpacked by ``git
archive``) is measured too; with ``--bf16-alone`` a copy of this tree's
package built with ``LLMQ_GDN_TC_SPLIT 0`` (``csrc/gdn_tc.cu``: every fp32
operand of a product rounded to bf16 alone instead of split into bf16 hi +
lo), made under ``_proof/gdn_bf16_alone``. Each tree runs in its own
process, in turns (A B C C B A), one JSON line each. ``--ttft`` adds the
generation path's time to the first token (``chip_smoke.py``'s prompts:
Qwen3.5-0.8B at full width with random weights, the multimodal b 1 prompt
and the b 4 text prompts of 300 tokens; median of 9) and the device time of
its K1 kernels in one such call. Needs the card and nvcc; each tree builds
its kernels into its own ``_build``.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"hybrid": (4, 8, 2048, 64, 64, False), "prefill": (1, 16, 156, 128, 128, True)}
BAR = 2e-2  # chip_smoke.py's TOL["bfloat16"] and TILE_TOL
DECAYS = {"fast": 2.0, "slow": 5.0}  # the mean of alpha's logit


def kernel_name(name):
    """A profiler event's kernel function, without namespaces and template arguments."""
    m = re.search(r"(\w+)(?:<|\()", name)
    return m.group(1) if m else name[:60]


def measure(with_ttft):
    """One JSON line of this process's package (``llm_quest_tpu_torch`` as imported)."""
    import torch
    from torch.autograd import DeviceType

    import llm_quest_tpu_torch
    from llm_quest_tpu_torch.kernels import build, gdn
    from llm_quest_tpu_torch.ops.gdn import l2_norm_clamp

    lib = build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    chunk = gdn.anchor_chunk(torch.bfloat16) if hasattr(gdn, "anchor_chunk") else gdn.ANCHOR_CHUNK

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    def events_ms(fn, iters=20, warmup=3):
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

    def host_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / iters

    def c_entry_us(fn, iters=20):
        spent, launch = 0.0, build.launch

        def timed_launch(*args):
            nonlocal spent
            t = time.perf_counter()
            launch(*args)
            spent += time.perf_counter() - t

        fn()
        torch.cuda.synchronize()
        build.launch = timed_launch
        try:
            for _ in range(iters):
                fn()
        finally:
            build.launch = launch
        torch.cuda.synchronize()
        return spent * 1e6 / iters

    def device(fn, iters=10, key=None):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for _ in range(3):
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            if events:
                by_name = {}
                for e in events:
                    name = kernel_name(e.name)
                    by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
                if key is not None:
                    by_name = {n: t for n, t in by_name.items() if key(n)}
                return sum(by_name.values()), by_name
        return None, {}

    def inputs(b, h, s, dk, dv, with_prev, decay=DECAYS["fast"]):
        q = l2_norm_clamp(randn(b, h, s, dk)).bfloat16()
        k = l2_norm_clamp(randn(b, h, s, dk)).bfloat16()
        v = randn(b, h, s, dv).bfloat16()
        beta, alpha = torch.sigmoid(randn(b, h, s)), torch.sigmoid(randn(b, h, s, scale=0.3) + decay)
        prev = randn(b, h, dv, dk, scale=0.1) if with_prev else None
        return q, k, v, beta, alpha, prev, randn(b, h, s, dv).bfloat16()

    def errors(got, ref):
        """(tile error, max abs error over max(1, max |ref|)), each over the bar."""
        got, ref = got.float(), ref.float()
        if ref.dim() == 3:
            got, ref = got[..., None], ref[..., None]
        pad = (-ref.shape[-2]) % 64

        def sq(x):
            return torch.nn.functional.pad(x, (0, 0, 0, pad)).unflatten(-2, (-1, 64)).square().sum((-2, -1))

        tile = float((sq(got - ref) / sq(ref).clamp_min(1e-30)).sqrt().max())
        return tile / BAR, float((got - ref).abs().max()) / max(1.0, float(ref.abs().max())) / BAR

    result = {"package": str(Path(llm_quest_tpu_torch.__file__).parent), "anchor_chunk": chunk,
              "card": torch.cuda.get_device_name(0), "build_s": lib.build_seconds}
    for name, (b, h, s, dk, dv, with_prev) in SHAPES.items():
        q, k, v, beta, alpha, prev, d_out = inputs(b, h, s, dk, dv, with_prev)
        _, _, anchors = gdn._launch_fwd(q, k, v, beta, alpha, prev, anchor_chunk=chunk)
        leaves = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha)]

        def fwd_bwd():
            out, _ = gdn.gated_delta_rule_fwd(*leaves, prev)
            return torch.autograd.grad(out, leaves, d_out)

        sets = [tuple(t.clone() for t in (q, k, v)) for _ in range(80)] if name == "prefill" else []
        turn = iter(range(10**9))

        def fwd_new_inputs():
            qn, kn, vn = sets[next(turn) % len(sets)]
            return gdn.gated_delta_rule_fwd(qn, kn, vn, beta, alpha, prev)

        calls = {
            "fwd": lambda: gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, prev),
            **({"fwd_new_inputs": fwd_new_inputs} if sets else {}),
            "fwd_anchors": lambda: gdn._launch_fwd(q, k, v, beta, alpha, prev, anchor_chunk=chunk),
            "bwd": lambda: gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=chunk),
            "fwd_bwd": fwd_bwd,
        }
        rec = {}
        for call, fn in calls.items():
            dev, split = device(fn)
            rec[call] = {"ms": events_ms(fn), "host_ms": host_ms(fn), "c_entry_us": c_entry_us(fn),
                         "device_ms": dev, "kernels": split}
        g1 = calls["bwd"]()
        g2 = calls["bwd"]()
        torch.cuda.synchronize()
        rec["bwd_bitwise_equal"] = all(torch.equal(x, y) for x, y in zip(g1, g2))
        result[name] = rec
        del q, k, v, beta, alpha, prev, d_out, anchors, leaves, g1, g2, sets

    accuracy = {}
    b, h, s, dk, dv, _ = SHAPES["hybrid"]
    for decay_name, decay in DECAYS.items():
        q, k, v, beta, alpha, _, d_out = inputs(b, h, s, dk, dv, False, decay)
        out, state, anchors = gdn._launch_fwd(q, k, v, beta, alpha, None, anchor_chunk=chunk)
        grads = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=chunk)
        ref_out, ref_state, ref_anchors = gdn.gated_delta_rule_fwd_plain(q, k, v, beta, alpha, chunk_size=64,
                                                                         with_anchors=True)
        ref_grads = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, ref_anchors, d_out, None, chunk_size=64,
                                             plain=True)
        names = ("out", "state", "dq", "dk", "dv", "dbeta", "dalpha")
        pairs = zip(names, (out, state, *grads[:5]), (ref_out, ref_state, *ref_grads[:5]))
        accuracy[decay_name] = {n: dict(zip(("tile_over_bar", "max_abs_over_bar"), errors(g, r))) for n, g, r in pairs}
        del q, k, v, beta, alpha, d_out, out, state, anchors, grads, ref_out, ref_state, ref_anchors, ref_grads
    result["accuracy"] = accuracy
    if with_ttft:
        result["ttft"] = ttft(device)
    print(json.dumps(result), flush=True)


def ttft(device, repeats=9):
    """The generation path's time to the first token, as ``chip_smoke.py``'s
    main path makes its prompts and model, and the device time of K1's kernels
    in one such call."""
    import torch

    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG
    from llm_quest_tpu_torch.inference import generate as gen
    from llm_quest_tpu_torch.models import qwen3_5

    cfg = dict(QWEN3_5_08B_CONFIG)
    g = torch.Generator(device="cuda").manual_seed(0)
    model = qwen3_5.init(cfg, generator=g, device="cuda")
    n_vis = (cfg["img_height"] // cfg["patch_size"]) ** 2 // cfg["spatial_merge_size"] ** 2
    text_a = torch.randint(1, 1000, (4,), generator=g, device="cuda")
    text_b = torch.randint(1, 1000, (8,), generator=g, device="cuda")
    mm_ids = torch.cat([text_a, torch.full((n_vis,), cfg["image_token_id"], device="cuda"), text_b])[None]
    pixels = torch.randn(1, 3, 2, cfg["img_height"], cfg["img_width"], generator=g, device="cuda").to(cfg["dtype"])
    text_ids = torch.randint(0, 1000, (4, 300), generator=g, device="cuda")
    calls = {
        "multimodal": lambda: qwen3_5.generate_multimodal(model, cfg, mm_ids, pixels, max_gen=1, eos_ids=-1,
                                                          pad_id=0),
        "text_b4": lambda: gen.generate_kv_cache(qwen3_5.TextOnly, model.text, cfg, text_ids, max_gen=1, eos_ids=-1,
                                                 pad_id=0),
    }
    out = {}
    for name, fn in calls.items():
        fn()
        samples = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        k1_ms, k1 = device(fn, iters=1, key=lambda n: n.startswith(("gdn_tc_", "gdn_prefill")))
        out[name] = {"ttft_ms": statistics.median(samples), "samples_ms": samples, "k1_device_ms": k1_ms,
                     "k1_kernels": k1}
    return out


def bf16_alone_tree():
    """A copy of this tree's package whose csrc/gdn_tc.cu is built with LLMQ_GDN_TC_SPLIT 0."""
    tree = ROOT / "_proof" / "gdn_bf16_alone"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "llm_quest_tpu_torch", tree / "llm_quest_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = tree / "llm_quest_tpu_torch" / "csrc" / "gdn_tc.cu"
    cu.write_text("#define LLMQ_GDN_TC_SPLIT 0\n" + cu.read_text())
    return tree


def run_tree(tree, with_ttft):
    """``measure`` in a process that imports the package under ``tree``."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--measure"] + (["--ttft"] if with_ttft else [])
    out = subprocess.run(cmd, env=env, cwd=str(tree), capture_output=True, text=True, check=True).stdout
    line = out.strip().splitlines()[-1]
    print(json.dumps({"tree": str(tree), **json.loads(line)}), flush=True)


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="root of another checkout whose package is measured beside this one")
    parser.add_argument("--bf16-alone", action="store_true",
                        help="also measure this tree built with every fp32 operand rounded to bf16 alone")
    parser.add_argument("--ttft", action="store_true", help="also time the generation path's first token")
    parser.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.measure:
        measure(args.ttft)
        return 0
    trees = [ROOT]
    if args.against is not None:
        trees.insert(0, Path(args.against).resolve())
    if args.bf16_alone:
        trees.append(bf16_alone_tree())
    for tree in trees + trees[::-1] if len(trees) > 1 else trees:
        run_tree(tree, args.ttft)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
