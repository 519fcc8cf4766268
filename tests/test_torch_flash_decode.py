"""K10 (flash decode over an int8 KV cache), the int8 cache and the
attention router's int8 branch against the JAX package, on the CPU.

The plain version of ``kernels/flash_decode.py`` is held to the Pallas
kernel run as ``tests/test_flash_decode.py`` runs it (``interpret=True``),
within 1e-5 in fp32: both reassociate the dequantization the same way and
differ only in the order of fp32 sums. The int8 cache writes must equal
JAX's ``write_layer`` bit for bit (the same fp32 division and round half to
even), and the router's two int8 routes (K10, and dequantize-then-``sdpa``)
must agree with JAX's ``attention`` within 1e-5.

The bf16 tensor-core kernel (``csrc/flash_decode_tc.cu``) runs only on the
card; ``emulate_tc`` repeats its arithmetic in torch (the 64-key tiles of
each block of a cluster, ``block_tiles``, the 16-key units of each warp
with an online softmax of its own, p·v_s rounded to q's type as the value
product's operand, the warps' partials combined in warp order and the
blocks' in rank order) and is held to the Pallas kernel in interpret mode at
head dims 128 and 256, q-head groups 1 to 8, S no multiple of the tile and
1 to 3 blocks a cluster: fp32 within 1e-5 × max(1, max |ref|) (sums in
another order), bf16 within 2e-2 × max |ref| (p·v_s rounds against each
warp's running max, the TPU kernel's against its block's). ``plan`` and
``block_tiles`` are held to the schedule: every tile in one block, within
the cluster limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import cache as jcache
from llm_quest_tpu.kernels.flash_attention import NEG_INF
from llm_quest_tpu.kernels.flash_decode import flash_decode as jflash_decode
from llm_quest_tpu.ops import attention as jattn
from llm_quest_tpu.ops.masks import causal_mask as jcausal
from llm_quest_tpu.ops.quantization import QuantKV as JQuantKV
from llm_quest_tpu_torch.inference import cache as tcache
from llm_quest_tpu_torch.kernels import flash_decode as kfd
from llm_quest_tpu_torch.ops import attention as tattn
from llm_quest_tpu_torch.ops.masks import causal_mask, mask_value
from llm_quest_tpu_torch.ops.quantization import QuantKV

TOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    return float(np.abs(got.detach().numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


def inputs(b, hq, hkv, s_len, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k_q = rng.integers(-127, 128, (b, hkv, s_len, d)).astype(np.int8)
    v_q = rng.integers(-127, 128, (b, hkv, s_len, d)).astype(np.int8)
    k_s = rng.uniform(0.005, 0.02, (b, hkv, s_len)).astype(np.float32)
    v_s = rng.uniform(0.005, 0.02, (b, hkv, s_len)).astype(np.float32)
    valid = rng.random((b, s_len)) > 0.3
    valid[:, 0] = True
    bias = np.where(valid, 0.0, NEG_INF).astype(np.float32)
    return q, k_q, k_s, v_q, v_s, bias


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("hq, hkv", [(4, 4), (8, 2)])
def test_plain_matches_pallas_interpret(hq, hkv, d):
    """S = 75 (not a multiple of 32: the Pallas wrapper pads to block_k) with
    a random key mask."""
    args = inputs(2, hq, hkv, 75, d, seed=hq + d)
    ref = jflash_decode(*map(jnp.asarray, args), block_k=32, interpret=True)
    got = kfd.flash_decode(*map(T, args))
    assert got.shape == ref.shape
    assert max_err(got, ref) <= TOL
    assert kfd.supports_flash_decode(T(args[0]), T(args[1]))


def test_guard_and_refusals():
    q, k_q, *_ = map(T, inputs(1, 4, 2, 8, 128, seed=0))
    assert not kfd.supports_flash_decode(q[..., :64], k_q[..., :64])  # d % 128 != 0
    assert not kfd.supports_flash_decode(torch.cat([q, q], 2), k_q)  # more than one query
    assert not kfd.supports_flash_decode(q, k_q, softcap=30.0)
    assert not kfd.supports_flash_decode(q[:, :3], k_q)  # 3 q heads over 2 kv heads
    with pytest.raises(NotImplementedError, match="sinks"):
        kfd.flash_decode(q, k_q, None, k_q, None, None, softcap=30.0)


def test_int8_cache_write_matches_jax():
    rng = np.random.default_rng(3)
    k_new = rng.standard_normal((3, 2, 4, 128)).astype(np.float32)
    v_new = rng.standard_normal((3, 2, 4, 128)).astype(np.float32)
    jc = jcache.init_kv_cache(2, 3, 2, 16, 128, quant="int8")
    tc = tcache.init_kv_cache(2, 3, 2, 16, 128, quant="int8")
    assert set(tc) == set(jc) and tcache.max_len(tc) == jcache.max_len(jc) == 16
    for pos in (0, 4):
        jc, jk, jv = jcache.write_layer(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new), pos)
        tc, tk, tv = tcache.write_layer(tc, 1, T(k_new), T(v_new), pos)
        k_new, v_new = v_new * 0.5, k_new * 2.0
    for name in ("k_q", "k_s", "v_q", "v_s"):
        assert tc[name].shape == jc[name].shape and str(tc[name].dtype).endswith(str(jc[name].dtype)), name
        assert np.array_equal(tc[name].numpy(), np.asarray(jc[name])), name
    assert isinstance(tk, QuantKV) and tk.data.shape == (3, 2, 16, 128) and tk.scale.shape == (3, 2, 16)
    assert max_err(tv.dequant(torch.float32), jv.dequant(jnp.float32)) == 0.0
    with pytest.raises(ValueError, match="quant"):
        tcache.init_kv_cache(1, 1, 1, 4, 128, quant="int4")


@pytest.mark.parametrize("use_flash_decode", [True, False])
@pytest.mark.parametrize("d", [128, 64])
def test_router_int8_branch_matches_jax(d, use_flash_decode):
    """A decode step against an int8 cache at position 9 of 20, row 1 with
    two padded keys: K10's route (d 128) and the dequantize route (d 64, or
    ``use_flash_decode=False``), JAX's NEG_INF bias against the port's."""
    rng = np.random.default_rng(d)
    b, hq, hkv, s_max, pos = 2, 8, 2, 20, 9
    k = rng.standard_normal((b, hkv, pos + 1, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, pos + 1, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    attn_mask = np.ones((b, s_max), bool)
    attn_mask[1, 3:5] = False
    jc, _, _ = jcache.write_layer(jcache.init_kv_cache(1, b, hkv, s_max, d, quant="int8"), 0,
                                  jnp.asarray(k), jnp.asarray(v), 0)
    tc, tk, tv = tcache.write_layer(tcache.init_kv_cache(1, b, hkv, s_max, d, quant="int8"), 0, T(k), T(v), 0)
    jk = JQuantKV(jc["k_q"][0], jc["k_s"][0, ..., 0])
    jv = JQuantKV(jc["v_q"][0], jc["v_s"][0, ..., 0])
    cfg = {"use_flash_decode": use_flash_decode}
    ref = jattn.attention(jnp.asarray(q), jk, jv, cfg=cfg,
                          mask=jcausal(1, s_max, q_start=pos, attn_mask=jnp.asarray(attn_mask)))
    got = tattn.attention(T(q), tk, tv, cfg=cfg,
                          mask=causal_mask(1, s_max, q_start=pos, attn_mask=T(attn_mask)))
    assert max_err(got, ref) <= TOL
    assert mask_value(torch.float32) == NEG_INF


def test_cpu_tensors_take_the_plain_version():
    args = list(map(T, inputs(1, 8, 2, 40, 256, seed=5)))
    n = kfd.flash_decode.launches
    kfd.flash_decode(*args)
    assert kfd.flash_decode.launches == n


# ------------------------------------------------ the tensor-core kernel's arithmetic


UNIT = 16  # keys a warp takes of a tile (csrc/flash_decode_tc.cu's kUnit)
WARPS = 8  # consumer warps: 4 units x 2 tile parities (kNW)


def block_tiles(s_len, split):
    """The 64-key tiles [lo, hi) of each block (rank) of a cluster of ``split``, as the kernel takes them."""
    n = -(-s_len // kfd.TILE)
    return [(n * r // split, n * (r + 1) // split) for r in range(split)]


def _combine(parts):
    """(max, sum, output) partials combined in their order, as the kernel does:
    a part with no key (max -inf) weighs nothing."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    out_l, out_acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
    for mp, lp, ap in parts:
        e = torch.where(mp == -torch.inf, torch.zeros_like(mp), torch.exp(mp - m))
        out_l = out_l + e * lp
        out_acc = out_acc + e[:, None] * ap
    return m, out_l, out_acc


def emulate_tc(q, k_q, k_s, v_q, v_s, bias, *, scale, split):
    """The tensor-core kernel's arithmetic in fp32 (p·v_s rounded to q's
    type), by (batch, kv head): each block's tiles, each warp's units, then
    the warps' and the blocks' partials in order."""
    b, hq, _, d = q.shape
    hkv, s_len = k_q.shape[1], k_q.shape[2]
    g = hq // hkv
    out = torch.empty(b, hq, 1, d, dtype=torch.float32)
    for bi in range(b):
        for hk in range(hkv):
            qg = q[bi, hk * g:(hk + 1) * g, 0].float()  # (g, d)
            blocks = []
            for lo, hi in block_tiles(s_len, split):
                key_end = min(s_len, hi * kfd.TILE)
                warps = []
                for w in range(WARPS):
                    m = torch.full((g,), -torch.inf)
                    l_sum, acc = torch.zeros(g), torch.zeros(g, d)
                    for tile in range(lo + w // 4, hi, WARPS // 4):
                        k0 = tile * kfd.TILE + UNIT * (w % 4)
                        if k0 >= key_end:
                            continue
                        keys = torch.arange(k0, k0 + UNIT)
                        valid = keys < key_end
                        kk = keys.clamp_max(s_len - 1)
                        s = qg @ k_q[bi, hk, kk].float().T
                        x = s * (k_s[bi, hk, kk].float() * scale) + bias[bi, kk].float()
                        x = torch.where(valid, x, torch.full_like(x, -torch.inf))
                        m_new = torch.maximum(m, x.amax(1))
                        m_use = torch.where(m_new == -torch.inf, torch.zeros_like(m_new), m_new)
                        alpha = torch.exp(m - m_use)
                        p = torch.exp(x - m_use[:, None])
                        l_sum = l_sum * alpha + p.sum(1)
                        pv = (p * v_s[bi, hk, kk].float()).to(q.dtype).float()
                        acc = acc * alpha[:, None] + pv @ v_q[bi, hk, kk].float()
                        m = m_new
                    warps.append((m, l_sum, acc))
                blocks.append(_combine(warps))
            _, l_sum, acc = _combine(blocks)
            out[bi, hk * g:(hk + 1) * g, 0] = acc / l_sum.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d, g, s_len, split", [(128, 1, 75, 1), (256, 2, 200, 2), (128, 4, 300, 3),
                                                (256, 8, 130, 2)])
def test_tc_emulation_matches_pallas(d, g, s_len, split, bf16):
    args = inputs(2, 2 * g, 2, s_len, d, seed=d + g + s_len)
    jargs = list(map(jnp.asarray, args))
    targs = list(map(T, args))
    if bf16:
        jargs[0] = jargs[0].astype(jnp.bfloat16)
        targs[0] = T(np.asarray(jargs[0].astype(jnp.float32))).bfloat16()
    ref = np.asarray(jflash_decode(*jargs, block_k=32, interpret=True).astype(jnp.float32), np.float64)
    got = emulate_tc(*targs, scale=d**-0.5, split=split)
    assert got.dtype == targs[0].dtype and got.shape == ref.shape
    err = max_err(got.float(), ref)
    bar = 2e-2 * float(np.abs(ref).max()) if bf16 else TOL * max(1.0, float(np.abs(ref).max()))
    assert err <= bar, err


@pytest.mark.parametrize("s_len", [1, 64, 96, 1000, 8192])
@pytest.mark.parametrize("split", [1, 2, 3, 16])
def test_block_tiles_cover_every_tile_once(s_len, split):
    ranges = block_tiles(s_len, split)
    tiles = [t for lo, hi in ranges for t in range(lo, hi)]
    assert len(ranges) == split and tiles == list(range(-(-s_len // kfd.TILE)))


@pytest.mark.parametrize("b, hkv, s_len", [(1, 2, 96), (16, 2, 8192), (1, 2, 8192), (4, 8, 300), (1, 1, 1)])
def test_plan_stays_within_the_cluster_and_the_tiles(b, hkv, s_len):
    split = kfd.plan(b, hkv, s_len, 132)
    assert split in (1, 2, 4, 8, 16)
    assert split == 1 or -(-s_len // kfd.TILE) >= 2 * split * kfd.MIN_TILES
