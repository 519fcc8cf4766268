"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
of them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens at first use,
into ``llm_quest_tpu_torch/_build/``, under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads the
library already built. Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# element-type codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # dtype, q, k, v, beta, alpha, s0, s_out, anchors, saved_d, out, work, B, H, S, DK, DV, chunk, 9 strides,
    # scale, stream
    "llmq_gdn_prefill": [_I] + [_P] * 11 + [_I] * 6 + [_L] * 9 + [_F, _P],
    # dtype, B, H, S, DK, DV, saved
    "llmq_gdn_prefill_work_bytes": [_I] * 7,
    # dtype, q, k, v, beta, alpha, anchors, saved_d, dout, dstate, work, dq, dk, dv, dbeta, dalpha, dprev,
    # B, H, S, DK, DV, chunk, scale, stream
    "llmq_gdn_prefill_bwd": [_I] + [_P] * 16 + [_I] * 6 + [_F, _P],
    # dtype, B, H, S, DK, DV
    "llmq_gdn_prefill_bwd_work_bytes": [_I] * 6,
    # dtypes of q/k/v, beta and alpha, q, k, v, beta, alpha, stacked, layer, out, B, H, HQK, DK, DV,
    # 10 strides (int), scale, stream
    "llmq_gdn_step_stacked": [_I] * 3 + [_P] * 6 + [_I, _P] + [_I] * 15 + [_F, _P],
    # dtype, q, k, v, o, lse, key_mask, B, HQ, HKV, SQ, SK, D, DV, 13 strides, causal, q_start, scale,
    # window, softcap, sink, stream
    "llmq_attention_fwd": [_I] + [_P] * 6 + [_I] * 7 + [_L] * 13 + [_I, _I, _F, _I, _F, _P, _P],
    # dtype, q, k, v, dout, lse, delta, delta_shift, dq, dk, dv, key_mask, B, HQ, HKV, SQ, SK, D, DV,
    # 12 input and 9 output strides, mask stride, causal, q_start, scale, window, softcap, stream
    "llmq_attention_bwd": [_I] + [_P] * 11 + [_I] * 7 + [_L] * 22 + [_I, _I, _F, _I, _F, _P],
    # the calls of the two above that launched the bf16 tensor-core kernels
    "llmq_attention_tc_launches": [],
    # dtype, q, k_q, k_s, v_q, v_s, bias, part_acc, part_ml, out, B, HQ, HKV, S, D, n_splits, split_len,
    # 13 strides, scale, stream
    "llmq_flash_decode": [_I] + [_P] * 9 + [_I] * 7 + [_L] * 13 + [_F, _P],
    # dtype, x, w_q, scale, group_sizes, group sizes int64, y, T, E, K, N, bits (8 or 4), rows per thread
    # (fp32), row tile and K splits (bf16), stream
    "llmq_quantized_gmm": [_I] + [_P] * 4 + [_I, _P] + [_I] * 8 + [_P],
    # dtype, q, k, v, o, dyn_scales, dq_static, inv_q, inv_k, scale, B, S, H, D, 12 strides, stream
    "llmq_packed_mha_int8": [_I] + [_P] * 5 + [_F] * 4 + [_I] * 4 + [_L] * 12 + [_P],
    # the calls of the above that launched the bf16 tensor-core kernel
    "llmq_packed_mha_int8_tc_launches": [],
    # dtype, q, k, v, o, lse, B, H, S, D, 12 strides, causal, fp32_den, scale, stream
    "llmq_fused_mha": [_I] + [_P] * 5 + [_I] * 4 + [_L] * 12 + [_I, _I, _F, _P],
    # the calls of the above that launched the bf16 tensor-core kernel
    "llmq_fused_mha_tc_launches": [],
    # int8, t, q, k, v, o, G, M, stream
    "llmq_attn_core": [_I] + [_P] * 5 + [_I] * 2 + [_P],
}
# entries returning other than an int (a CUDA error code or a count)
_RESTYPES = {"llmq_gdn_prefill_work_bytes": ctypes.c_longlong, "llmq_gdn_prefill_bwd_work_bytes": ctypes.c_longlong}


class _Library:
    """The loaded kernels library and the seconds its build took (0.0 when
    an existing build was loaded)."""

    def __init__(self, cdll, build_seconds):
        self.cdll = cdll
        self.build_seconds = build_seconds


_loaded = None


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return nvcc


def _source_digest(sources):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(commands):
    """Start every command at once, wait for all; raise with the output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in commands]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(commands, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")


def _compile_and_link(sources, so_path):
    """One nvcc per source in parallel, then one link; the library appears atomically."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objects = [Path(tmp_dir) / f"{src.stem}.o" for src in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(sources, objects)])
        tmp = Path(tmp_dir) / so_path.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, so_path)  # atomic: a concurrent loader never sees a partial file


def library():
    """Build (if needed) and load the kernels library; returns ``_Library``.
    Raises ``RuntimeError`` with the compiler's output when the build fails."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    so_path = BUILD_DIR / f"libllmq_kernels_{_source_digest(sources + headers)}.so"
    build_seconds = 0.0
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _compile_and_link(sources, so_path)
        build_seconds = time.perf_counter() - t0
    cdll = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    cdll.llmq_error_string.argtypes = [ctypes.c_int]
    cdll.llmq_error_string.restype = ctypes.c_char_p
    _loaded = _Library(cdll, build_seconds)
    return _loaded


def launch(name, *args):
    """Call C entry ``name`` and raise if it reports a CUDA error."""
    cdll = library().cdll
    err = getattr(cdll, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err} ({cdll.llmq_error_string(err).decode()})")


def stream_of(t):
    """The current CUDA stream of ``t``'s device, as the C interface takes it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t):
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16 tensors, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def require(cond, msg):
    """Validate a kernel argument; raises ValueError (never falls back)."""
    if not cond:
        raise ValueError(msg)


def require_cuda(*tensors):
    dev = tensors[0].device
    for t in tensors:
        require(t.is_cuda and t.device == dev, "kernel operands must all lie on one CUDA device")


def needs_grad(*tensors):
    """True when autograd would record a gradient through one of ``tensors`` (None is skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def require_no_grad(name, *tensors):
    """A kernel whose backward is not ported refuses to run where a gradient
    would be needed; raises ``NotImplementedError`` (never drops the gradient)."""
    if needs_grad(*tensors):
        raise NotImplementedError(f"{name}: the kernel's backward is not ported")
