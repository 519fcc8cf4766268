"""Grouped matmul over int8 expert stacks (csrc/quantized_gmm.cu) and its
plain PyTorch version.

``quantized_ragged_dot``: K11, ``ragged_dot`` over an int8 expert stack with
the dequantization fused; replaces
``llm_quest_tpu/kernels/quantized_gmm.py::quantized_ragged_dot``. Rows come
sorted by expert (``ops/moe.py::dispatch``); row r of expert e gives
``(x[r] @ w_q[e]) * scale[e]``. The kernel reads the group offsets on the
device (a ``cumsum`` of the group sizes, no host sync), skips the experts
with no row, streams the int8 weights and applies the scale before its single
rounding to the rows' type. Divergence by design: with bf16 rows the TPU
kernel rounds the product to bf16 before the scale multiplies; the port
rounds once, after it.

Plain version: ``quantized_ragged_dot_plain``, one matmul per expert group in
fp32 (it reads the group sizes on the host). Device rule: a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version;
``plain=True`` forces the plain version (comparisons only).
``quantized_ragged_dot.launches`` counts launches.
"""

import torch

from llm_quest_tpu_torch.kernels import build

# up to this many rows the kernel takes 16-row tiles, above it 64-row tiles.
# A block walks K once per row tile, so 16-row tiles win while an expert's
# rows fit one tile. chip_smoke.py's k11_tiling_sweep times both (8 experts,
# top-2): on an H100 16-row tiles win up to T = 64 and lose from T = 128 on.
_FEW_ROWS = 64


def quantized_ragged_dot_plain(x, w_q, scale, group_sizes):
    outs = [
        (xg.float() @ w_q[e].float()) * scale[e].float()
        for e, xg in enumerate(torch.split(x, group_sizes.tolist()))
        if xg.shape[0]
    ]
    if not outs:
        return x.new_zeros(0, w_q.shape[-1])
    return torch.cat(outs).to(x.dtype)


def quantized_ragged_dot(x, w_q, scale, group_sizes, *, plain=False):
    """``ragged_dot`` over an int8 expert stack with fused dequantization.

    x: (T, K) rows sorted by expert; w_q: (E, K, N) int8; scale: (E, N) fp32;
    group_sizes: (E,) int rows per expert, summing to T. Returns (T, N) in
    x's dtype. The kernel takes N % 16 == 0."""
    if plain or not x.is_cuda:
        return quantized_ragged_dot_plain(x, w_q, scale, group_sizes)
    build.require_no_grad("quantized_ragged_dot", x)
    t, k = x.shape
    e, k2, n = w_q.shape
    build.require_cuda(x, w_q, scale, group_sizes)
    build.require(k == k2, f"x (T, {k}) does not match w_q (E, {k2}, N)")
    build.require(w_q.dtype == torch.int8 and w_q.is_contiguous(), "w_q must be contiguous int8 (E, K, N)")
    build.require(scale.shape == (e, n) and scale.dtype == torch.float32, "scale must be fp32 (E, N)")
    build.require(group_sizes.shape == (e,), "group_sizes must be (E,)")
    build.require(n % 16 == 0 and w_q.data_ptr() % 16 == 0, f"the kernel takes N % 16 == 0 (16-byte rows), got {n}")
    if t == 0:
        return x.new_zeros(0, n)
    return _launch(x, w_q, scale, group_sizes, 1 if t <= _FEW_ROWS else 4)


def _launch(x, w_q, scale, group_sizes, rows_per_thread):
    """The kernel on checked inputs, with 16 * ``rows_per_thread`` rows a
    tile (1 or 4)."""
    (t, k), (e, _, n) = x.shape, w_q.shape
    x = x.contiguous()
    scale = scale.contiguous()
    offsets = torch.zeros(e + 1, dtype=torch.int32, device=x.device)
    torch.cumsum(group_sizes, 0, dtype=torch.int32, out=offsets[1:])
    y = torch.empty(t, n, dtype=x.dtype, device=x.device)
    build.launch(
        "llmq_quantized_gmm", build.dtype_code(x),
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), offsets.data_ptr(), y.data_ptr(),
        t, e, k, n, rows_per_thread, build.stream_of(x),
    )
    quantized_ragged_dot.launches += 1
    return y


quantized_ragged_dot.launches = 0
