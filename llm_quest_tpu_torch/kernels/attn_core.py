"""The attention core of the int8-score ablation (csrc/attn_core_tc.cu, K12)
and its plain PyTorch version; replaces ``scripts/ablate_int8_scores.py::
make_attn_core`` (kernel ``_attn_kernel`` :41, ``pallas_call`` :63).

``attn_core(t, q, k, v)`` computes, for every group g of G:

- ``s = q[g] · k[g]ᵀ``, accumulated in fp32 for bf16 q/k and in int32 for
  int8 q/k;
- ``p = s`` rounded to bf16 (nearest, ties to even; int32 through fp32);
- ``o[g] = p · (v[g] + t[0])``, ``v + t`` a bf16 add rounded to bf16, the
  product accumulated in fp32 and stored as bf16.

t: (1, 1, Kv) bf16; q/k: (G, M, D) bf16 or int8; v: (G, M, Kv) bf16; out
(G, M, Kv) bf16. No softmax and no scale. The kernel takes Kv 64, rows of 128
bytes (D 64 in bf16, D 128 in int8) and M a multiple of 16 up to 256: the
ablation's two shapes, (1536, 208, 64) bf16 and (1536, 224, 128) int8
zero-padded from 208 × 64.

On a CUDA tensor the wrapper launches ``llmq_attn_core``, both variants on
the tensor cores (``wgmma``: bf16 → fp32 or s8 → s32 scores in 64-key
chunks, each rounded to bf16 in registers and fed to bf16 p·(v + t);
persistent blocks that walk the groups with the next group's tiles in
flight by TMA), and raises on a shape the kernel does not take; a CPU
tensor runs the plain version; ``plain=True`` forces it on any device
(comparisons only). The plain version is einsum in fp32, the int8 scores in
int32 on the CPU and in fp32 on the card (exact: |s| ≤ 128·127² < 2²⁴), with
TF32 off. ``attn_core.launches`` counts the kernel's launches,
``attn_core.int8_launches`` the int8 ones among them and
``attn_core.tc_launches`` those the library counts as launched on the
tensor cores (``llmq_attn_core_tc_launches``). ``CHUNK`` is the keys a
score product covers, whose order the CPU tests hold to the Pallas kernel.
The kernel has no backward (JAX's has none either): it
raises where a gradient would be needed. ``k12_tolerance`` is how far the
kernel may lie from the plain version.
"""

import contextlib
import ctypes
import functools

import torch

from llm_quest_tpu_torch.kernels import build

KV = 64  # v/o columns the kernel is built for
ROW_BYTES = 128  # one q/k row: D 64 in bf16, D 128 in int8
MAX_ROWS = 256  # M at most: one TMA box, four 64-row q tiles
CHUNK = 64  # keys a score product covers (the last chunk: the keys left)


@contextlib.contextmanager
def _full_fp32(device):
    """fp32 products in full fp32 on the card (TF32 would round the operands)."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def attn_core_plain(t, q, k, v):
    """K12's plain version: the scores by einsum (int32 on the CPU, fp32 on
    the card for int8 q/k; fp32 for bf16), rounded to bf16, times the bf16
    ``v + t[0]`` in fp32, stored as bf16."""
    with _full_fp32(q.device):
        if q.dtype == torch.int8 and not q.is_cuda:
            s = torch.einsum("gmd,gnd->gmn", q.int(), k.int()).float()
        else:
            s = torch.einsum("gmd,gnd->gmn", q.float(), k.float())
        p = s.to(torch.bfloat16)
        vt = v + t[0]
        return torch.einsum("gmn,gnk->gmk", p.float(), vt.float()).to(torch.bfloat16)


def bf16_unit(x):
    """The spacing of bf16 numbers at |x|, elementwise (8 bits of significand)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def k12_tolerance(t, q, k, v, ref):
    """How far K12's output may lie from its plain version ``ref``. bf16
    scores: one bf16 unit of max |ref| (the fp32 score sums may round to
    neighbouring bf16 values). int8 scores, exact on both sides: each output
    within one bf16 unit of its plain value plus the fp32 summation bound of
    p·(v + t), M·2⁻²⁴·(|p|·|v + t|), since the two sum in other orders
    (which moves an output near zero, by cancellation, by more than its own
    unit). Elementwise fp32, ``ref``'s shape."""
    if q.dtype != torch.int8:
        return bf16_unit(ref.float().abs().max()).expand(ref.shape)
    with torch.no_grad(), _full_fp32(q.device):
        p = torch.einsum("gmd,gnd->gmn", q.float(), k.float()).to(torch.bfloat16).float().abs()
        sums = torch.einsum("gmn,gnk->gmk", p, (v + t[0]).float().abs())
    return bf16_unit(ref) + q.shape[1] * 2.0**-24 * sums


def _check_cuda(t, q, k, v):
    g, m, d = q.shape
    build.require(q.dtype in (torch.bfloat16, torch.int8) and k.dtype == q.dtype,
                  f"attn_core takes bf16 or int8 q and k of one dtype, got {q.dtype} and {k.dtype}")
    build.require(t.dtype == torch.bfloat16 and v.dtype == torch.bfloat16, "attn_core takes bf16 t and v")
    build.require(k.shape == q.shape, f"q and k must share one (G, M, D) shape, got {tuple(q.shape)}, {tuple(k.shape)}")
    build.require(d * q.element_size() == ROW_BYTES,
                  f"attn_core's rows are {ROW_BYTES} bytes (D 64 bf16, D 128 int8), got D {d} {q.dtype}")
    build.require(tuple(v.shape) == (g, m, KV) and tuple(t.shape) == (1, 1, KV),
                  f"attn_core takes v (G, M, {KV}) and t (1, 1, {KV}), got {tuple(v.shape)}, {tuple(t.shape)}")
    build.require(m % 16 == 0 and 16 <= m <= MAX_ROWS, f"attn_core takes M a multiple of 16 up to {MAX_ROWS}, got {m}")
    build.require(all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in (t, q, k, v)),
                  "attn_core takes contiguous, 16-byte aligned tensors")
    build.require_cuda(t, q, k, v)
    build.require_no_grad("attn_core", t, v)


@functools.cache
def _tc_count():
    """The library's count of calls that launched the kernel, read in place
    (no call into it)."""
    return ctypes.c_int.in_dll(build.library().cdll, "llmq_attn_core_tc_launches")


def attn_core(t, q, k, v, *, plain=False):
    """The ablation's attention core (K12): (G, M, Kv) bf16 out (module docstring)."""
    if plain or not q.is_cuda:
        return attn_core_plain(t, q, k, v)
    _check_cuda(t, q, k, v)
    g, m, _ = q.shape
    o = torch.empty(g, m, KV, dtype=torch.bfloat16, device=q.device)
    int8 = q.dtype == torch.int8
    count = _tc_count()
    before = count.value
    build.launch("llmq_attn_core", int(int8), t.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 g, m, build.stream_of(q))
    attn_core.launches += 1
    attn_core.int8_launches += int(int8)
    attn_core.tc_launches += count.value - before
    return o


attn_core.launches = 0
attn_core.int8_launches = 0  # the int8 ones among them
attn_core.tc_launches = 0  # the launches on the tensor cores (all, since the kernel has no other form)
