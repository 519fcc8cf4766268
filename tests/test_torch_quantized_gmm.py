"""K11 (the grouped matmul over int8 expert stacks) and the int8 Qwen3-MoE
layer against the JAX package, on the CPU.

The plain version of ``kernels/quantized_gmm.py`` is held to the Pallas
kernel run as ``tests/test_quantized_gmm.py`` runs it (``interpret=True``):
fp32 rows within 1e-5 (sums in another order); bf16 rows within 2e-2 ×
max |ref|, because the TPU kernel rounds the product to bf16 before the scale
multiplies and the port rounds once, after it (a documented divergence).
``qwen3_moe`` with int8 stacks (the shared expert included) is held to JAX's
``qwen3_moe`` on the same quantized tree within 1e-5, also at a hidden
width (N 40) that the tensor-core kernel's TMA cannot address and K11's
SIMT kernel takes on the card (``tc_route``).

The bf16 tensor-core kernel (``csrc/quantized_gmm_tc.cu``) runs only on the
card; here its schedule and its arithmetic are held in Python. Its tile
walk (``tile_walk``, the kernel's map from a block's row-tile index to
(expert, first row), ``find_tile``) must store every row exactly once and schedule no
block of an expert without rows, for every row tile, over empty experts,
one expert holding every row, T below one tile, 12 experts, and a decode
(T 8, E 8, top-2) and a prefill routing. ``emulate_tc`` repeats the
kernel's arithmetic in numpy (int8 widened exactly to bf16, fp32 sums per
64-row K stage within each of the cluster's K parts, the parts summed in
rank order, the scale, then one rounding to bf16) and is held to the Pallas
kernel in interpret mode: fp32 rows within 1e-5 × max(1, max |ref|) (sums in
another order), bf16 rows within 2e-2 × max |ref| (the TPU kernel rounds to
bf16 before the scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.kernels.quantized_gmm import quantized_ragged_dot as jqrd
from llm_quest_tpu.ops import moe as jmoe
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.kernels import quantized_gmm as kq
from llm_quest_tpu_torch.ops import moe as tmoe
from llm_quest_tpu_torch.ops.linear import params as tparams

SIZES = {
    "empty groups": [0, 7, 0, 9],
    "one expert": [16, 0, 0, 0],
    "unaligned": [1, 1, 1, 13],
    "eight experts": [3, 0, 5, 1, 0, 2, 4, 1],
    "twelve experts": [2, 1, 0, 4, 3, 0, 0, 2, 1, 1, 1, 1],
}


def T(x):
    return torch.from_numpy(np.array(x))


def make(sizes, d=64, n=96, seed=0):
    rng = np.random.default_rng(seed)
    t, e = sum(sizes), len(sizes)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w_q = rng.integers(-127, 128, (e, d, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, (e, n)).astype(np.float32)
    return x, w_q, scale, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("sizes", list(SIZES.values()), ids=list(SIZES))
def test_plain_matches_pallas_interpret_fp32(sizes):
    x, w_q, scale, gs = make(sizes, seed=len(sizes))
    ref = jqrd(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), jnp.asarray(gs), tile_m=8, interpret=True)
    got = kq.quantized_ragged_dot(T(x), T(w_q), T(scale), T(gs).long())
    err = float(np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())
    assert got.shape == ref.shape and err <= 1e-5, err


def test_plain_matches_pallas_interpret_bf16_rows():
    x, w_q, scale, gs = make([5, 0, 11, 16], seed=3)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jqrd(jx, jnp.asarray(w_q), jnp.asarray(scale), jnp.asarray(gs), tile_m=16, interpret=True),
                     np.float32)
    got = kq.quantized_ragged_dot(T(np.asarray(jx, np.float32)).bfloat16(), T(w_q), T(scale), T(gs).long())
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= 2e-2 * float(np.abs(ref).max()), err


TINY = {k: v for k, v in jconfig.QWEN3_NEXT_SMALL_CONFIG.items() if k != "dtype"}
TINY.update(emb_dim=64, moe_hidden_dim=96, shared_expert_hidden_dim=96, num_experts=8, top_k=2)


def to_port(jtree):
    """A quantized JAX ``qwen3_moe`` parameter tree as the port's module
    (every leaf keeps its layout: expert stacks are (E, in, out) in both)."""
    flat = {k: torch.from_numpy(np.array(v)) for k, v in flatten_params(jtree).items()}
    module = torch.nn.Module()
    for group in ("experts", "shared"):
        module.add_module(group, tparams(**{k.split("/")[1]: v for k, v in flat.items() if k.startswith(group + "/")}))
    module.gate_w = torch.nn.Parameter(flat["gate_w"], requires_grad=False)
    module.shared_gate_w = torch.nn.Parameter(flat["shared_gate_w"], requires_grad=False)
    return module


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_int8_qwen3_moe_matches_jax(capacity_factor):
    """Exact dispatch through K11's plain version; a capacity factor is
    ignored for int8 stacks in both packages (they keep the exact path)."""
    jparams = jmoe.init_qwen3_moe(jax.random.PRNGKey(0), TINY)
    jq = jquant.quantize_params_int8(jparams, min_size=0)
    assert "lin1_q" in jq["experts"] and "lin1_q" in jq["shared"]
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32)
    ref, raux = jmoe.qwen3_moe(jq, jnp.asarray(x), top_k=2, load_coeff=0.001, training=False,
                               capacity_factor=capacity_factor)
    got, aux = tmoe.qwen3_moe(to_port(jq), T(x), top_k=2, load_coeff=0.001, training=False,
                              capacity_factor=capacity_factor)
    err = float(np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())
    assert err <= 1e-5, err
    assert float(np.abs(aux["gate_probas"].numpy() - np.asarray(raux["gate_probas"])).max()) <= 1e-6


# Widths the tensor-core kernel's TMA cannot address (N % 16 != 0; bf16 rows
# with K % 8 != 0): on the card K11's SIMT kernel takes them (``tc_route``),
# and the port's ``ops/moe.py::_ragged`` sends them to K11 as any other
# stack. Held to JAX's ``_ragged`` (on the CPU its dequantized ragged_dot)
# and to its Pallas kernel in interpret mode (what a TPU runs at these
# widths): fp32 within 1e-5 × max(1, max |ref|), bf16 within 2e-2 × max |ref|
# (JAX rounds to bf16 before the scale, the port once after it).
TAILS = {"n40_fp32": (64, 40, jnp.float32), "k36_bf16": (36, 64, jnp.bfloat16), "n40_bf16": (64, 40, jnp.bfloat16)}


@pytest.mark.parametrize("case", list(TAILS))
def test_tail_stacks_match_jax_ragged(case):
    k, n, jdtype = TAILS[case]
    x, w_q, scale, gs = make([3, 0, 5, 4], d=k, n=n, seed=11)
    jx = jnp.asarray(x, jdtype)
    refs = [jmoe._ragged({"lin1_q": jnp.asarray(w_q), "lin1_scale": jnp.asarray(scale)}, "lin1", jx,
                         jnp.asarray(gs), jnp.asarray(np.repeat(np.arange(len(gs)), gs))),
            jqrd(jx, jnp.asarray(w_q), jnp.asarray(scale), jnp.asarray(gs), tile_m=8, interpret=True)]
    tx = T(np.asarray(jx.astype(jnp.float32)))
    if jdtype == jnp.bfloat16:
        tx = tx.bfloat16()
    assert not kq.tc_route(tx.dtype, k, n)
    got = tmoe._ragged({"lin1_q": T(w_q), "lin1_scale": T(scale)}, "lin1", tx, T(gs).long(), False)
    assert got.dtype == tx.dtype
    for ref in refs:
        ref = np.asarray(ref.astype(jnp.float32), np.float64)
        assert got.shape == ref.shape
        err, top = float(np.abs(got.float().numpy().astype(np.float64) - ref).max()), float(np.abs(ref).max())
        assert err <= (1e-5 * max(1.0, top) if jdtype == jnp.float32 else 2e-2 * top), err


def test_tc_route_is_the_tma_widths():
    """bf16 rows take the tensor-core kernel where its TMA addresses the rows
    and the weights (K % 8 == 0, N % 16 == 0); fp32 rows and other widths
    the SIMT kernel."""
    assert kq.tc_route(torch.bfloat16, 64, 64) and kq.tc_route(torch.bfloat16, 896, 3584)
    assert kq.tc_route(torch.bfloat16, 1000, 272)
    assert not kq.tc_route(torch.bfloat16, 36, 64) and not kq.tc_route(torch.bfloat16, 64, 40)
    assert not kq.tc_route(torch.float32, 64, 64) and not kq.tc_route(torch.float32, 36, 40)


def test_int8_qwen3_moe_at_refused_width_matches_jax():
    """A hidden width of 40, which the tensor-core kernel's TMA cannot
    address (lin1 and gate N 40; lin2 K 40, N 64): K11 (its plain version
    here) at every stack; the whole layer against JAX's."""
    cfg = {**TINY, "moe_hidden_dim": 40}
    jq = jquant.quantize_params_int8(jmoe.init_qwen3_moe(jax.random.PRNGKey(2), cfg), min_size=0)
    assert jq["experts"]["lin1_q"].shape[-1] == 40
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    ref, _ = jmoe.qwen3_moe(jq, jnp.asarray(x), top_k=2, load_coeff=0.001, training=False)
    got, _ = tmoe.qwen3_moe(to_port(jq), T(x), top_k=2, load_coeff=0.001, training=False)
    err = float(np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())
    assert err <= 1e-5, err


def test_cpu_tensors_take_the_plain_version():
    x, w_q, scale, gs = make([2, 2], seed=9)
    n = kq.quantized_ragged_dot.launches
    kq.quantized_ragged_dot(T(x), T(w_q), T(scale), T(gs).long())
    assert kq.quantized_ragged_dot.launches == n


# ------------------------------------------- the tensor-core kernel's schedule


def routing(tokens, e, top_k, seed):
    """The group sizes of a top-k routing of ``tokens`` tokens by seeded logits."""
    logits = np.random.default_rng(seed).standard_normal((tokens, e))
    return np.bincount(np.argsort(-logits, axis=1)[:, :top_k].reshape(-1), minlength=e)


def grid_row_tiles(t, e, rows):
    """Row tiles the kernel's grid covers: T / rows, plus one partial tile
    for each expert that may hold rows."""
    return (t + min(e, t) * (rows - 1)) // rows


def tile_walk(group_sizes, t, rows):
    """The kernel's map from its row-tile index j (``grid_row_tiles``) to
    (expert, first row, the expert's end row), or None for a block with no
    work: each expert's ceil(g / rows) tiles in expert order
    (``find_tile``)."""
    jobs, start = [], 0
    for e, g in enumerate(max(int(g), 0) for g in group_sizes):
        jobs += [(e, start + i * rows, start + g) for i in range(-(-g // rows))]
        start += g
    n = grid_row_tiles(t, len(group_sizes), rows)
    return [jobs[j] if j < len(jobs) else None for j in range(n)]


def k_ranges(k, split):
    """The K stages [begin, end) of each of the ``split`` blocks of a cluster."""
    n_k = -(-k // kq.K_STAGE)
    return [(n_k * q // split, n_k * (q + 1) // split) for q in range(split)]


WALKS = {
    "empty experts": [0, 7, 0, 9, 0],
    "one expert": [0, 0, 300, 0],
    "below one tile": [1, 0, 2],
    "twelve experts": [2, 1, 0, 4, 3, 0, 0, 2, 1, 1, 1, 1],
    "decode": routing(4, 8, 2, seed=0).tolist(),
    "prefill": routing(1200, 8, 2, seed=1).tolist(),
}


@pytest.mark.parametrize("rows", kq.ROW_TILES)
@pytest.mark.parametrize("sizes", list(WALKS.values()), ids=list(WALKS))
def test_tile_walk_stores_every_row_once(sizes, rows):
    t = sum(sizes)
    walk = tile_walk(sizes, t, rows)
    assert len(walk) == grid_row_tiles(t, len(sizes), rows)
    stored = np.zeros(t, np.int64)
    expert_of = np.repeat(np.arange(len(sizes)), sizes)
    for job in walk:
        if job is None:
            continue
        e, row0, end = job
        assert sizes[e] > 0, f"a block of expert {e}, which has no row"
        lo, hi = row0, min(row0 + rows, end, t)
        assert lo < hi and (expert_of[lo:hi] == e).all()
        stored[lo:hi] += 1
    assert (stored == 1).all()
    jobs = [j for j in walk if j is not None]
    assert len(jobs) == sum(-(-g // rows) for g in sizes)
    assert walk[: len(jobs)] == jobs  # the blocks past the last tile are the ones without work


@pytest.mark.parametrize("k", [64, 96, 896, 3584])
def test_k_ranges_cover_k_once(k):
    n_k = -(-k // kq.K_STAGE)
    for split in range(1, min(kq.MAX_SPLIT, n_k) + 1):
        ranges = k_ranges(k, split)
        assert ranges[0][0] == 0 and ranges[-1][1] == n_k
        assert all(b < e for b, e in ranges) and all(ranges[i][1] == ranges[i + 1][0] for i in range(split - 1))


QWEN3_NEXT = {"lin1": (896, 3584), "lin2": (3584, 896)}


@pytest.mark.parametrize("t", [1, 8, 64, 512, 2400])
@pytest.mark.parametrize("mat", list(QWEN3_NEXT))
def test_plan_at_qwen3_next_widths(mat, t):
    """The host's row tile and K split at Qwen3-Next-small's widths (E 8) on
    an H100's 132 SMs: a row tile in ROW_TILES that holds a busy expert's
    rows (up to the largest), K parts of at least MIN_STAGES stages, and
    the choices the card's sweep picked at decode and prefill."""
    k, n = QWEN3_NEXT[mat]
    rows, split = kq.plan(t, k, n, 8, 132)
    assert rows in kq.ROW_TILES and 1 <= split <= kq.MAX_SPLIT
    m = t / (8 * (1 - (1 - 1 / 8) ** t))
    busy = m + m**0.5
    assert rows >= min(busy, kq.ROW_TILES[-1]) and (rows == kq.ROW_TILES[0] or rows / 2 < busy)
    assert split == 1 or min(e - b for b, e in k_ranges(k, split)) >= kq.MIN_STAGES
    if t in (8, 512, 2400):  # lin1's channel tiles fill the card; lin2's 7 need K parts below T 2400
        assert (rows, split) == {(8, "lin1"): (8, 1), (8, "lin2"): (8, 4), (512, "lin1"): (128, 1),
                                 (512, "lin2"): (128, 2), (2400, "lin1"): (128, 1),
                                 (2400, "lin2"): (128, 1)}[t, mat]


def widen_s8(w):
    """The kernel's int8 -> float widening: the sign bit flipped, the byte
    under the exponent of 2^23 (0x4B0000uu = 2^23 + uu), less 2^23 + 128."""
    u = (w.astype(np.int32) ^ 0x80) & 0xFF
    return ((u | 0x4B000000).astype(np.uint32).view(np.float32) - np.float32(8388736.0)).astype(np.float32)


def test_int8_widens_to_bf16_exactly():
    w = np.arange(-128, 128).astype(np.int8)
    f = widen_s8(w)
    assert (f == w.astype(np.float32)).all()
    assert torch.equal(torch.from_numpy(f).bfloat16().float(), torch.from_numpy(f))


def emulate_tc(x, w_q, scale, sizes, rows, split, bf16):
    """The tensor-core kernel's arithmetic on numpy inputs (x fp32, its
    values bf16 already where ``bf16``): per block of the tile walk and of
    BLOCK_CHANNELS channels, each K part's fp32 sum stage by stage, the
    parts summed in rank order, times the scale, rounded once (bf16)."""
    t, k = x.shape
    n = w_q.shape[-1]
    n_k = -(-k // kq.K_STAGE)
    kp, n_pad = n_k * kq.K_STAGE, -(-n // kq.BLOCK_CHANNELS) * kq.BLOCK_CHANNELS
    w = np.zeros((w_q.shape[0], kp, n_pad), np.float32)
    w[:, :k, :n] = widen_s8(w_q)
    xp = np.zeros((t + rows, kp), np.float32)  # rows past T and columns past K arrive as zeros
    xp[:t, :k] = x
    s = np.zeros((scale.shape[0], n_pad), np.float32)
    s[:, :n] = scale
    y = np.full((t, n), np.nan, np.float32)
    for job in tile_walk(sizes, t, rows):
        if job is None:
            continue
        e, row0, end = job
        xt = xp[row0 : row0 + rows]
        for n0 in range(0, n_pad, kq.BLOCK_CHANNELS):
            parts = []
            for b, f in k_ranges(k, split):
                acc = np.zeros((rows, kq.BLOCK_CHANNELS), np.float32)
                for st in range(b, f):
                    ks = slice(st * kq.K_STAGE, (st + 1) * kq.K_STAGE)
                    acc = acc + xt[:, ks] @ w[e, ks, n0 : n0 + kq.BLOCK_CHANNELS]
                parts.append(acc)
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            out = total * s[e, n0 : n0 + kq.BLOCK_CHANNELS]
            hi, nh = min(row0 + rows, end, t), min(n0 + kq.BLOCK_CHANNELS, n)
            y[row0:hi, n0:nh] = out[: hi - row0, : nh - n0]
    assert not np.isnan(y).any()
    return torch.from_numpy(y).bfloat16().float().numpy() if bf16 else y


EMULATED = {"decode": (routing(4, 8, 2, seed=2).tolist(), 8, 3),
            "prefill": (routing(100, 8, 2, seed=3).tolist(), 32, 1),
            "prefill split": (routing(100, 8, 2, seed=4).tolist(), 16, 2)}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(EMULATED))
def test_tc_emulation_matches_pallas(case, bf16):
    """At narrow widths (K 256: four stages; N 160: a partial channel
    block), both routings, with the cluster's K split."""
    sizes, rows, split = EMULATED[case]
    x, w_q, scale, gs = make(sizes, d=256, n=160, seed=len(case))
    jx = jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)
    ref = np.asarray(jqrd(jx, jnp.asarray(w_q), jnp.asarray(scale), jnp.asarray(gs), tile_m=8, interpret=True),
                     np.float32)
    got = emulate_tc(np.asarray(jx, np.float32), w_q, scale, sizes, rows, split, bf16)
    err, top = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= (2e-2 * top if bf16 else 1e-5 * max(1.0, top)), err
