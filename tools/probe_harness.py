"""What the card probes under ``tools/`` share: timing, profiler splits,
copies of kernel sources built with one change, ptxas's registers, and the
command line that measures this tree beside another checkout's, in turns.

A probe is run from the root of the repo (``python -m tools.<probe>``). With
``--against DIR`` the package under DIR (another checkout's root, e.g. the
parent commit unpacked by ``git archive``) is measured too: each tree runs
the probe's ``measure`` in a process of its own that imports that tree's
package (``run_tree``), in turns (A B B A), one JSON line each. Each tree
builds its kernels into its own ``_build``. Nothing here runs at import, and
nothing needs the card until a probe measures.
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
CSRC = ROOT / "llm_quest_tpu_torch" / "csrc"
VARIANT_DIR = ROOT / "llm_quest_tpu_torch" / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def kernel_name(name):
    """A profiler event's kernel function, without namespaces and template arguments."""
    m = re.search(r"(\w+)(?:<|\()", name)
    return m.group(1) if m else name[:60]


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def events_ms(fn, iters=200, warmup=10):
    """ms a call by CUDA events around ``iters`` calls after ``warmup``."""
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


def host_ms(fn, iters=20):
    """ms a call takes to return (its launch work) over ``iters`` calls that are not waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def device_split(fn, iters=20):
    """{kernel: device ms a call} from a ``torch.profiler`` trace of ``iters``
    calls after one; taken up to three times where a trace comes back
    without the card's activity ({} after three)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = kernel_name(e.name)
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        if by_name:
            return by_name
    return {}


def apply_edits(text, edits, what):
    """``text`` with each (old, new) of ``edits`` replaced; raises where an old text is missing."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{what}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def variant_libraries(out_name, sources, variants, target=None):
    """{name: the built library} of the kernel ``sources`` (file names under
    csrc/) for each of ``variants``, {name: (nvcc -D flags, [(old, new)
    edits of the ``target`` source])}, built in parallel under
    ``_build/<out_name>/<name>/``. Every copy's source is made first, so a
    stale edit fails before any build."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    texts = {name: apply_edits((CSRC / target).read_text(), edits, f"variant {name}") if edits else None
             for name, (_, edits) in variants.items()}
    procs = {}
    for name, (flags, _) in variants.items():
        d = VARIANT_DIR / out_name / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in (*CSRC.glob("*.cuh"), *(CSRC / s for s in sources)):
            shutil.copy(f, d / f.name)
        if texts[name] is not None:
            (d / target).write_text(texts[name])
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-shared", "-o", str(d / "lib.so"), *(str(d / s) for s in sources)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}  # all of them end before any raise
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{logs[name][-3000:]}")
    return {name: VARIANT_DIR / out_name / name / "lib.so" for name in procs}


def time_in_turns(calls, rounds=2, repeats=3, iters=200, warmup=10):
    """{key: [ms, ...]}: each of ``calls`` ({key: fn}) timed by CUDA events
    ``repeats`` times, all of them in turn, ``rounds`` times over."""
    ms = {key: [] for key in calls}
    for _ in range(rounds):
        for key, call in calls.items():
            for _ in range(repeats):
                ms[key].append(events_ms(call, iters=iters, warmup=warmup))
    return ms


def summary(samples):
    return {"ms": samples, "median_ms": statistics.median(samples)}


def ptxas_registers(src, label=lambda name: name, flags=()):
    """{kernel instance: registers and spills} as ptxas reports them for
    csrc/``src`` built with the nvcc ``flags``; ``label`` names an instance
    from its mangled name."""
    out_dir = VARIANT_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cmd = [nvcc, *NVCC_FLAGS, *flags, "-Xptxas", "-v", "-c", "-o", str(out_dir / f"{Path(src).stem}.o"),
           str(CSRC / src)]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    found, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            found[label(name)] = {"registers": int(m.group(1)), "spill_stores": spills[0], "spill_loads": spills[1]}
    return found


def in_turns(items):
    """A B ... then ... B A, where there is more than one."""
    return items + items[::-1] if len(items) > 1 else items


def run_tree(script, tree, args=()):
    """``script --measure args`` in a process that imports the package under
    ``tree``; prints its last line as JSON with the tree beside it."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    done = subprocess.run([sys.executable, str(script), "--measure", *args], env=env, cwd=str(tree),
                          capture_output=True, text=True)
    if done.returncode != 0:
        sys.stderr.write(done.stderr[-4000:])
        raise SystemExit(f"{tree}: the measurement failed ({done.returncode})")
    line = done.stdout.strip().splitlines()[-1]
    print(json.dumps({"tree": str(tree), **json.loads(line)}), flush=True)


def main(argv, *, script, doc, measure, variants=None, options=(), more_trees=None):
    """A probe's command line. ``measure(args)`` prints one JSON line of the
    package the process imports; it runs for this tree and, with
    ``--against DIR``, for DIR's, in turns. ``options``: (flag, help) of
    store_true flags, which the measuring processes are given too;
    ``more_trees(args)``: more trees measured after this one; ``variants(args)``
    runs after the trees where ``--variants`` is given."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--against", help="root of another checkout whose package is measured beside this one")
    if variants is not None:
        parser.add_argument("--variants", action="store_true",
                            help="also time this tree's kernels in copies and choices each with one change")
    for flag, help_text in options:
        parser.add_argument(flag, action="store_true", help=help_text)
    parser.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.measure:
        measure(args)
        return 0
    passed = [flag for flag, _ in options if getattr(args, flag.lstrip("-").replace("-", "_"))]
    trees = [ROOT] if args.against is None else [Path(args.against).resolve(), ROOT]
    if more_trees is not None:
        trees += more_trees(args)
    for tree in in_turns(trees):
        run_tree(script, tree, passed)
    if variants is not None and args.variants:
        variants(args)
    return 0
