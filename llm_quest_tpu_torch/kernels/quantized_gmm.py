"""Grouped matmul over int8 and int4 expert stacks (csrc/quantized_gmm.cu,
csrc/quantized_gmm_tc.cu) and its plain PyTorch version.

``quantized_ragged_dot``: K11, ``ragged_dot`` over an int8 or int4 expert
stack with the dequantization fused; replaces
``llm_quest_tpu/kernels/quantized_gmm.py::quantized_ragged_dot``. Rows come
sorted by expert (``ops/moe.py::dispatch``); row r of expert e gives
``(x[r] @ w_q[e]) * scale[e]``. The kernels read the group sizes on the
device (no host sync, one launch a call), skip the experts with no row,
stream the weights as stored and apply the scale before their single
rounding to the rows' type. Divergence by design: with bf16 rows the TPU
kernel rounds the product to bf16 before the scale multiplies; the port
rounds once, after it.

int4 stacks (``ops/int4.py::pack_int4``: (E, ⌈K/2⌉, N) ``uint8``,
rows 2i and 2i + 1 of K in the low and high nibbles of byte row i) stream
packed, half a byte a weight, and widen in shared memory (the tensor-core
kernel) or in registers (the SIMT one). Divergence by design: JAX's kernel
takes int8 alone (``supports_qgmm``) and sends int4 stacks to
``jax.lax.ragged_dot`` on a converted stack, which XLA fuses; torch has
neither an int4 type nor that fusion, so K11 takes int4 too. Such calls
also count in ``quantized_ragged_dot.int4_launches``.

Routes (``tc_route``): bf16 rows take the tensor-core kernel
(``quantized_gmm_tc.cu``; counted in ``quantized_ragged_dot.tc_launches``),
with a row tile and a K split that ``plan`` picks from the shapes alone;
fp32 rows the SIMT kernel (``quantized_gmm.cu``) with 16- or 64-row tiles.
The tensor-core kernel loads x and the weights by TMA, whose row strides
must be multiples of 16 bytes: bf16 rows with K % 8 != 0 or a stack with
N % 16 != 0 take the SIMT kernel too (no shipped configuration has such
widths: K and N are 896 or 3584), counted in ``launches`` but not in
``tc_launches``, so a bf16 path that takes it shows in ``chip_smoke.py``.
Like JAX's kernel, K11 takes every width.

``plan`` makes the tensor-core kernel's host-side choices (its row tile
and K split); ``tests/test_torch_quantized_gmm.py`` holds the kernel's
schedule in Python.

Plain version: ``quantized_ragged_dot_plain``, one matmul per expert group in
fp32 (it reads the group sizes on the host). Device rule: a CUDA tensor
launches a kernel (or raises), a CPU tensor runs the plain version;
``plain=True`` forces the plain version (comparisons only).
``quantized_ragged_dot.launches`` counts launches.
"""

import ctypes
import functools
import math

import torch

from llm_quest_tpu_torch.kernels import build
from llm_quest_tpu_torch.ops.int4 import integer_weight, is_int4

# fp32 rows (the SIMT kernel): up to this many rows 16-row tiles, above it
# 64-row tiles. A block walks K once per row tile, so 16-row tiles win while
# an expert's rows fit one tile (on an H100 up to T = 64 with 8 experts, top-2).
_FEW_ROWS = 64

# the tensor-core kernel's schedule (csrc/quantized_gmm_tc.cu)
ROW_TILES = (8, 16, 32, 64, 128)  # rows a tile (wgmma's N)
BLOCK_CHANNELS = 128  # output channels a block (two warpgroups of 64)
K_STAGE = 64  # K rows a stage
MAX_SPLIT = 8  # K parts a cluster sums
MIN_STAGES = 4  # K stages a part keeps at least
BLOCKS_PER_SM = 2  # blocks an SM the kernel's ring leaves room for (kBlocksPerSM)
# tiles of up to this many rows stream the weights; larger ones are bound
# by the products
STREAM_ROWS = 32


def quantized_ragged_dot_plain(x, w_q, scale, group_sizes):
    outs = [
        (xg.float() @ integer_weight(w_q[e:e + 1], x.shape[1], torch.float32)[0]) * scale[e].float()
        for e, xg in enumerate(torch.split(x, group_sizes.tolist()))
        if xg.shape[0]
    ]
    if not outs:
        return x.new_zeros(0, w_q.shape[-1])
    return torch.cat(outs).to(x.dtype)


def tc_route(dtype, k, n):
    """True where rows of ``dtype`` over a (E, ``k``, ``n``) stack take the
    tensor-core kernel: bf16 rows at widths its TMA addresses (16-byte row
    strides: K % 8 == 0, N % 16 == 0); else the SIMT kernel."""
    return dtype == torch.bfloat16 and k % 8 == 0 and n % 16 == 0


@functools.lru_cache(maxsize=256)
def plan(t, k, n, e, sms, bits=8):
    """(rows a tile, K parts) of the tensor-core kernel for T = ``t`` rows
    over ``e`` experts of ``bits``-bit weights, from the shapes alone (no
    host sync; chip_smoke.py's ``k11_tiling_sweep`` times the choices around
    it). A part keeps at least MIN_STAGES stages' worth of int8 bytes: an
    int4 stage holds half of them, so an int4 part keeps twice the K
    stages (and the kernel's ring holds more stages). Rows spread evenly:
    e·(1 - (1 - 1/e)^t) experts hold rows, m = t / hit each, and a busy
    expert m + sqrt(m) (one standard deviation more). The row tile is the
    smallest that holds a busy expert's rows (at most 128); the blocks
    expected with work are the channel tiles times hit times a busy
    expert's row tiles. Tiles of up to STREAM_ROWS rows stream the weights:
    K is split until the blocks cover the ``sms`` SMs. Larger tiles are
    bound by the products: K is split in two where that cuts the waves (of
    BLOCKS_PER_SM blocks an SM) a unit of work takes by a fifth or more."""
    hit = e * (1.0 - (1.0 - 1.0 / e) ** t)
    busy = t / hit + math.sqrt(t / hit)
    rows = next((b for b in ROW_TILES if b >= busy), ROW_TILES[-1])
    blocks = math.ceil(n / BLOCK_CHANNELS) * hit * math.ceil(busy / rows)
    most = min(MAX_SPLIT, math.ceil(k / K_STAGE) * bits // 8 // MIN_STAGES)
    if rows <= STREAM_ROWS:
        split = min(most, math.ceil(sms / blocks)) if blocks < sms else 1
    else:
        slots = BLOCKS_PER_SM * sms
        split = 2 if most >= 2 and math.ceil(2 * blocks / slots) / 2 <= 0.8 * math.ceil(blocks / slots) else 1
    return rows, max(1, split)


@functools.cache
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _tc_count():
    """The library's count of calls that launched the tensor-core kernel,
    read in place (no call into it)."""
    return ctypes.c_int.in_dll(build.library().cdll, "llmq_quantized_gmm_tc_launches")


def quantized_ragged_dot(x, w_q, scale, group_sizes, *, plain=False):
    """``ragged_dot`` over an int8 or int4 expert stack with fused dequantization.

    x: (T, K) rows sorted by expert; w_q: (E, K, N) int8, or (E, ⌈K/2⌉, N)
    packed int4 (``uint8``); scale: (E, N) fp32; group_sizes: (E,) int rows
    per expert, summing to T. Returns (T, N) in x's dtype. Any K and N
    (``tc_route`` picks the kernel)."""
    if plain or not x.is_cuda:
        return quantized_ragged_dot_plain(x, w_q, scale, group_sizes)
    build.require_no_grad("quantized_ragged_dot", x)
    t, k = x.shape
    e, k2, n = w_q.shape
    bits = 4 if is_int4(w_q) else 8
    build.require_cuda(x, w_q, scale, group_sizes)
    build.require(k2 == (k + 1) // 2 if bits == 4 else k2 == k,
                  f"x (T, {k}) does not match w_q (E, {k2}, N) of {bits}-bit weights")
    build.require(w_q.dtype in (torch.int8, torch.uint8) and w_q.is_contiguous(),
                  "w_q must be contiguous int8 (E, K, N) or packed int4 uint8 (E, ceil(K / 2), N)")
    build.require(scale.shape == (e, n) and scale.dtype == torch.float32, "scale must be fp32 (E, N)")
    build.require(group_sizes.shape == (e,) and group_sizes.dtype in (torch.int32, torch.int64),
                  "group_sizes must be int32 or int64 (E,)")
    build.require(w_q.data_ptr() % 16 == 0, "w_q must start 16-byte aligned")
    if t == 0:
        return x.new_zeros(0, n)
    if not tc_route(x.dtype, k, n):
        return _launch(x, w_q, scale, group_sizes, rows_per_thread=1 if t <= _FEW_ROWS else 4)
    rows, split = plan(t, k, n, e, _sms(x.device.index), bits)
    return _launch(x, w_q, scale, group_sizes, row_tile=rows, split=split)


def _launch(x, w_q, scale, group_sizes, *, rows_per_thread=1, row_tile=0, split=1):
    """A kernel on checked inputs: ``row_tile`` 0, the SIMT kernel with 16 *
    ``rows_per_thread`` rows a tile (1 or 4); else bf16 rows on the
    tensor-core kernel with ``row_tile`` rows a tile (ROW_TILES) and K in
    ``split`` parts (at most MAX_SPLIT and K's stages), which raises where
    ``tc_route`` is false. ``w_q`` int8 or packed int4 (``uint8``)."""
    (t, k), (e, _, n) = x.shape, w_q.shape
    bits = 4 if is_int4(w_q) else 8
    x, scale, group_sizes = x.contiguous(), scale.contiguous(), group_sizes.contiguous()
    build.require(x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0, "x and scale must start 16-byte aligned")
    y = torch.empty(t, n, dtype=x.dtype, device=x.device)
    count = _tc_count()
    before = count.value
    build.launch(
        "llmq_quantized_gmm", build.dtype_code(x), x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        group_sizes.data_ptr(), int(group_sizes.dtype == torch.int64), y.data_ptr(), t, e, k, n, bits,
        rows_per_thread, row_tile, split, build.stream_of(x),
    )
    quantized_ragged_dot.launches += 1
    quantized_ragged_dot.tc_launches += count.value - before
    quantized_ragged_dot.int4_launches += bits == 4
    return y


quantized_ragged_dot.launches = 0
quantized_ragged_dot.tc_launches = 0  # the launches that took the tensor-core kernel
quantized_ragged_dot.int4_launches = 0  # the launches over int4 stacks (either kernel)
