"""The port's attention kernels' plain versions against the JAX package.

On the CPU the wrappers in ``llm_quest_tpu_torch/kernels/attention.py`` run
their plain PyTorch versions (``sdpa`` on the dense mask). They are held to
the Pallas kernels in interpret mode, run as the JAX package's own tests run
them, within 1e-4 fp32:

- K4: ``flash_attention(..., interpret=True, block_q=128, block_k=128)`` with
  GQA 8/2, d = 256, a static query offset into a longer key range and a
  (b, sk) key mask (True = real key);
- K4's backward: the plain version's dq/dk/dv (autograd through ``sdpa``)
  against ``jax.grad`` of the same interpret-mode kernel (its custom VJP),
  with causal masking, a static ``q_start``, a key mask and GQA; and the
  plain backward's ``delta_shift`` against the logsumexp cotangent of
  ``flash_attention_with_lse``;
- K7: ``packed_mha(q, k, v, n_heads, None, True)`` at d = 64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from llm_quest_tpu.kernels.flash_attention import flash_attention as jflash
from llm_quest_tpu.kernels.flash_attention import flash_attention_with_lse as jflash_lse
from llm_quest_tpu.kernels.fused_mha import packed_mha as jpacked
from llm_quest_tpu.ops import attention as jattn
from llm_quest_tpu.ops.masks import causal_mask as jcausal
from llm_quest_tpu_torch.kernels import attention as kattn
from llm_quest_tpu_torch.ops import attention as tattn

TOL = 1e-4


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def assert_close(got, ref, tol=TOL):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max())
    assert err <= tol, err


@pytest.mark.parametrize("q_start", [0, 40])
@pytest.mark.parametrize("with_mask", [False, True])
def test_k4_plain_matches_pallas(q_start, with_mask):
    b, hq, hkv, sq, sk, d = 2, 8, 2, 150, 260, 256
    q, k, v = rand(b, hq, sq, d), rand(b, hkv, sk, d, seed=1), rand(b, hkv, sk, d, seed=2)
    mask = None
    if with_mask:
        mask = np.random.default_rng(3).random((b, sk)) > 0.25
        mask[:, 0] = True  # every row keeps a visible key (fully masked rows are unspecified)
    got = kattn.flash_attention(T(q), T(k), T(v), attn_mask=None if mask is None else T(mask), q_start=q_start)
    ref = jflash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), attn_mask=None if mask is None else jnp.asarray(mask),
        causal=True, q_start=q_start, interpret=True, block_q=128, block_k=128,
    )
    assert_close(got, ref)


@pytest.mark.parametrize("q_start", [0, 40])
@pytest.mark.parametrize("with_mask", [False, True])
def test_k4_plain_gradients_match_pallas_vjp(q_start, with_mask):
    b, hq, hkv, sq, sk, d = 2, 4, 2, 100, 140, 64
    q, k, v = rand(b, hq, sq, d), rand(b, hkv, sk, d, seed=1), rand(b, hkv, sk, d, seed=2)
    do = rand(b, hq, sq, d, seed=4)
    mask = None
    if with_mask:
        mask = np.random.default_rng(3).random((b, sk)) > 0.25
        mask[:, 0] = True

    def jloss(q, k, v):
        out = jflash(q, k, v, attn_mask=None if mask is None else jnp.asarray(mask), causal=True,
                     q_start=q_start, interpret=True, block_q=128, block_k=128)
        return jnp.sum(out * jnp.asarray(do))

    refs = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    out = kattn.flash_attention(qt, kt, vt, attn_mask=None if mask is None else T(mask), q_start=q_start)
    grads = torch.autograd.grad(out, (qt, kt, vt), T(do))
    for got, ref in zip(grads, refs):
        assert_close(got, ref)
    plain = kattn.flash_attention_bwd(
        T(q), T(k), T(v), None, None, T(do), attn_mask=None if mask is None else T(mask), q_start=q_start
    )
    for got, ref in zip(plain, refs):
        assert_close(got, ref)


def test_k4_plain_delta_shift_matches_lse_cotangent():
    """delta_shift is the cotangent of the row logsumexp (JAX's
    flash_attention_with_lse folds it into the same backward)."""
    b, h, s, d = 1, 2, 130, 64
    q, k, v, do = (rand(b, h, s, d, seed=i) for i in range(4))
    g_lse = rand(b, h, s, seed=5)

    def jloss(q, k, v):
        out, lse = jflash_lse(q, k, v, causal=False, interpret=True, block_q=128, block_k=128)
        return jnp.sum(out * jnp.asarray(do)) + jnp.sum(lse * jnp.asarray(g_lse))

    refs = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = kattn.flash_attention_bwd(T(q), T(k), T(v), None, None, T(do), causal=False, delta_shift=T(g_lse))
    for g, r in zip(got, refs):
        assert_close(g, r)


@pytest.mark.parametrize("s", [20, 576])
def test_k7_plain_matches_pallas(s):
    b, h, d = 1, 2, 64
    q, k, v = (rand(b, s, h * d, seed=i) for i in range(3))
    got = kattn.packed_mha(T(q), T(k), T(v), h)
    ref = jpacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, None, True)
    assert_close(got, ref)


def test_router_flash_prefill_matches_jax_sdpa():
    """The router sends a cached prefill with a static offset to the flash
    wrapper (here its plain version); JAX's CPU router answers with sdpa on
    the dense mask. Both must agree."""
    b, hq, hkv, sq, sk, d = 2, 4, 2, 12, 20, 16
    q, k, v = rand(b, hq, sq, d), rand(b, hkv, sk, d, seed=1), rand(b, hkv, sk, d, seed=2)
    pad = np.ones((b, sk), bool)
    pad[1, :3] = False
    pad[:, 0] = True
    cfg = {"flash_min_seq": 8}
    dense = jcausal(sq, sk, q_start=4, attn_mask=jnp.asarray(pad))
    ref = jattn.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=cfg, mask=dense, attn_mask=jnp.asarray(pad), q_start=4
    )
    got = tattn.attention(T(q), T(k), T(v), cfg=cfg, mask=T(dense), attn_mask=T(pad), q_start=4)
    assert_close(got, ref)


def test_router_flash_route_carries_gradients():
    """A full-sequence call from flash_min_seq up takes the router's flash
    route; its gradients match JAX's router on the interpret-mode kernel."""
    b, hq, hkv, s, d = 1, 4, 2, 40, 64
    q, k, v, do = rand(b, hq, s, d), rand(b, hkv, s, d, seed=1), rand(b, hkv, s, d, seed=2), rand(b, hq, s, d, seed=3)
    jcfg = {"flash_min_seq": 32, "use_flash": True}

    def jloss(q, k, v):
        return jnp.sum(jattn.attention(q, k, v, cfg=jcfg, causal=True) * jnp.asarray(do))

    refs = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    out = tattn.attention(qt, kt, vt, cfg={"flash_min_seq": 32}, causal=True)
    for got, ref in zip(torch.autograd.grad(out, (qt, kt, vt), T(do)), refs):
        assert_close(got, ref)


def test_flash_wrapper_rejects_unported_features():
    q = torch.zeros(1, 2, 4, 64)
    for kw in ({"window_size": 8}, {"sink": torch.zeros(2)}, {"softcap": 30.0}):
        with pytest.raises(NotImplementedError):
            kattn.flash_attention(q, q, q, **kw)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (T(rand(1, 8, 128, seed=i)) for i in range(3))
    before = kattn.packed_mha.launches, kattn.flash_attention.launches
    assert torch.equal(kattn.packed_mha(q, k, v, 2), kattn.packed_mha_plain(q, k, v, 2))
    qh = q.reshape(1, 8, 2, 64).transpose(1, 2)
    assert torch.equal(kattn.flash_attention(qh, qh, qh), kattn.flash_attention_plain(qh, qh, qh, scale=64**-0.5))
    assert (kattn.packed_mha.launches, kattn.flash_attention.launches) == before
