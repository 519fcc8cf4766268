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
- K4's sliding window, softcap and sinks: the plain version and its
  dq/dk/dv/dsink against the interpret-mode kernel and ``jax.grad`` of it at
  the shapes of ``tests/test_flash_attention.py`` (b 2, 4/2 heads, s 200,
  d 64), within that file's bars: 2e-5 forward, 5e-5 gradients;
- K4 with v's own head dim (d 64, dv 32, MiMo-V2-Flash's; d 96, dv 64,
  DeepSeek-V3's MLA): the plain version and its dq/dk/dv/dsink against the
  interpret-mode kernel and ``jax.grad`` of it, windowed with sinks (GQA 3),
  causal (GQA 6) and causal MHA at (96, 64), at the same bars;
- K7: ``packed_mha(q, k, v, n_heads, None, True)`` at d = 64;
- K5: ``flash_attention_with_lse``'s plain version, its output and lse, and
  its dq/dk/dv for an output and an lse cotangent, against the
  interpret-mode kernel and ``jax.vjp`` of it (causal and not, GQA, dv ≠ d),
  within 1e-5;
- K6: ``fused_mha``'s plain version and its gradients against JAX's
  ``fused_mha(interpret=True)`` and ``jax.grad`` of it (its recompute VJP),
  causal and not, within 1e-5; and the router's K6 branch by JAX's
  conditions (maskless, equal heads, 2 ≤ s ≤ ``fused_mha_max_seq``);
- K6's backward on the card (the flash recompute fed its lse): the plain
  lse against ``jax.nn.logsumexp`` of JAX's scores, the lse-fed recompute
  against ``jax.grad`` of the interpret-mode kernel, within 1e-5, and its
  bf16 operand rounding (K6's denominator included) within the card's bf16
  bar (K7's cases are in ``tests/test_torch_vit.py``).

``causal_mask(window_size=)`` is held to ``swa_causal_mask_table`` and to
JAX's ``causal_mask``, and ``sdpa``'s sink and softcap to JAX's ``sdpa``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from llm_quest_tpu.kernels.flash_attention import flash_attention as jflash
from llm_quest_tpu.kernels.flash_attention import flash_attention_with_lse as jflash_lse
from llm_quest_tpu.kernels.fused_mha import fused_mha as jfused
from llm_quest_tpu.kernels.fused_mha import packed_mha as jpacked
from llm_quest_tpu.ops import attention as jattn
from llm_quest_tpu.ops.masks import causal_mask as jcausal
from llm_quest_tpu.ops.masks import swa_causal_mask_table
from llm_quest_tpu_torch.kernels import attention as kattn
from llm_quest_tpu_torch.ops import attention as tattn
from llm_quest_tpu_torch.ops.masks import causal_mask as tcausal

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
    """The kernel's argument check refuses, before any launch, what the CUDA
    kernels do not take: (d, dv) pairs other than (64, 64), (128, 128),
    (256, 256), (64, 32) and (96, 64) (the window, softcap and sinks are
    ported), k/v of another shape than q's batch and head dim, and malformed
    feature arguments. DeepSeek-V3's MLA pair (96, 64) passes the head-dim
    check and is refused here only for lying on the CPU."""
    q = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="k/v must be"):
        kattn._check(q, torch.zeros(1, 2, 4, 32), q, None, True, 0)
    for d, dv in ((96, 96), (64, 48), (128, 32), (192, 128)):
        qd, vd = torch.zeros(1, 2, 4, d), torch.zeros(1, 2, 4, dv)
        with pytest.raises(ValueError, match="head dims"):
            kattn._check(qd, qd, vd, None, True, 0)
    qd, vd = torch.zeros(1, 2, 4, 96), torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="one CUDA device"):
        kattn._check(qd, qd, vd, None, True, 0)
    with pytest.raises(ValueError, match="window_size"):
        kattn._check(q, q, q, None, True, 0, window_size=0)
    with pytest.raises(ValueError, match="softcap"):
        kattn._check(q, q, q, None, True, 0, softcap=-1.0)
    with pytest.raises(ValueError, match="sink"):
        kattn._check(q, q, q, None, True, 0, sink=torch.zeros(3))


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (T(rand(1, 8, 128, seed=i)) for i in range(3))
    before = kattn.packed_mha.launches, kattn.flash_attention.launches
    assert torch.equal(kattn.packed_mha(q, k, v, 2), kattn.packed_mha_plain(q, k, v, 2))
    qh = q.reshape(1, 8, 2, 64).transpose(1, 2)
    assert torch.equal(kattn.flash_attention(qh, qh, qh), kattn.flash_attention_plain(qh, qh, qh, scale=64**-0.5))
    assert (kattn.packed_mha.launches, kattn.flash_attention.launches) == before


# ------------------------------------------------ K4: window, softcap, sinks

# the feature sets of tests/test_flash_attention.py
FEATURES = {
    "window": {"window_size": 32},
    "softcap": {"softcap": 30.0},
    "sink": {"sink": True},
    "window_softcap_padding": {"window_size": 64, "softcap": 20.0, "padding": True},
    "window_noncausal": {"window_size": 48, "causal": False},
}
FWD_TOL, GRAD_TOL = 2e-5, 5e-5  # tests/test_flash_attention.py:21-22, interpret mode


def feature_case(name):
    """q, k, v, do (b 2, 4/2 heads, s 200, d 64) and the feature kwargs as numpy."""
    b, hq, hkv, s, d = 2, 4, 2, 200, 64
    q, k, v = rand(b, hq, s, d), rand(b, hkv, s, d, seed=1), rand(b, hkv, s, d, seed=2)
    do = rand(b, hq, s, d, seed=3)
    kw = {key: val for key, val in FEATURES[name].items() if key not in ("sink", "padding")}
    if FEATURES[name].get("sink"):
        kw["sink"] = rand(hq, seed=5)
    if FEATURES[name].get("padding"):
        pad = np.random.default_rng(1).random((b, s)) > 0.2
        pad[:, 0] = True  # every row keeps a visible key (fully masked rows are unspecified)
        kw["attn_mask"] = pad
    return q, k, v, do, kw


def as_jax(kw):
    return {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}


def as_torch(kw):
    return {key: T(val) if isinstance(val, np.ndarray) else val for key, val in kw.items()}


@pytest.mark.parametrize("name", FEATURES)
def test_k4_plain_window_softcap_sink_match_pallas(name):
    q, k, v, _, kw = feature_case(name)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, block_q=128, block_k=128,
                 **{"causal": True, **as_jax(kw)})
    got = kattn.flash_attention(T(q), T(k), T(v), **as_torch(kw))
    assert_close(got, ref, FWD_TOL)


@pytest.mark.parametrize("name", FEATURES)
def test_k4_plain_window_softcap_sink_gradients_match_pallas_vjp(name):
    """dq/dk/dv (and dsink) of the wrapper's autograd and of the plain
    backward against jax.grad of the interpret-mode kernel (its custom VJP)."""
    q, k, v, do, kw = feature_case(name)
    sink = kw.pop("sink", None)
    jkw = {"causal": True, **as_jax(kw)}

    def jloss(q, k, v, *sink_arg):
        out = jflash(q, k, v, interpret=True, block_q=128, block_k=128, sink=sink_arg[0] if sink_arg else None,
                     **jkw)
        return jnp.sum(out * jnp.asarray(do))

    args = [jnp.asarray(x) for x in (q, k, v)] + ([] if sink is None else [jnp.asarray(sink)])
    refs = jax.grad(jloss, argnums=tuple(range(len(args))))(*args)
    leaves = [T(x).requires_grad_() for x in (q, k, v) + (() if sink is None else (sink,))]
    tkw = as_torch(kw)
    out = kattn.flash_attention(*leaves[:3], sink=leaves[3] if sink is not None else None, **tkw)
    grads = torch.autograd.grad(out, leaves, T(do))
    plain = kattn.flash_attention_bwd(T(q), T(k), T(v), None, None, T(do), sink=None if sink is None else T(sink),
                                      **tkw)
    assert len(grads) == len(plain) == len(refs) == (3 if sink is None else 4)
    for got, got_plain, ref in zip(grads, plain, refs):
        assert_close(got, ref, GRAD_TOL)
        assert_close(got_plain, ref, GRAD_TOL)


# The restated divergence of the bf16 tensor-core kernels (csrc/attention_tc.cu):
# p (forward and backward) and ds are rounded to bf16 before their products,
# accumulated in fp32. The card's tests hold those kernels to the plain
# version at the bf16 bar; this pins, on the CPU, that the rounding alone
# stays inside that bar at these shapes.
BF16_TOL = 2e-2  # tests/test_torch_kernels_gpu.py's TOL[bfloat16], relative to max(1, max |ref|)


def _recompute_backward(q, k, v, do, kw, round_operands):
    """dq, dk, dv of attention as the flash backward recomputes them, in
    fp32, with p and ds rounded to bf16 before dV = pᵀ dO, dQ = ds K and
    dK = dsᵀ Q when ``round_operands``."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    scale, softcap, sink = d**-0.5, kw.get("softcap"), kw.get("sink")
    kx, vx = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
    scores = q @ kx.transpose(-1, -2) * scale
    dcap = torch.ones_like(scores)
    if softcap is not None:
        th = torch.tanh(scores / softcap)
        scores, dcap = softcap * th, 1 - th * th
    hidden = kattn._dense_mask(q, k, kw.get("attn_mask"), kw.get("causal", True), 0, kw.get("window_size"))
    if hidden is not None:
        scores = scores.masked_fill(hidden, torch.finfo(torch.float32).min / 2)
    cols = scores if sink is None else torch.cat([scores, sink[None, :, None, None].expand(b, hq, s, 1)], -1)
    lse = torch.logsumexp(cols, -1, keepdim=True)
    p = torch.exp(scores - lse)
    delta = (do * (p @ vx)).sum(-1, keepdim=True)
    ds = p * (do @ vx.transpose(-1, -2) - delta) * dcap
    if hidden is not None:
        ds = ds.masked_fill(hidden, 0.0)
    if round_operands:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    group = lambda t: t.reshape(b, hkv, hq // hkv, *t.shape[2:]).sum(2)  # noqa: E731
    return ds @ kx * scale, group(ds.transpose(-1, -2) @ q) * scale, group(p.transpose(-1, -2) @ do)


@pytest.mark.parametrize("name", ["causal", *FEATURES])
def test_k4_bf16_operand_rounding_stays_within_the_bf16_bar(name):
    """The plain backward with p and ds rounded to bf16 (the tensor-core
    kernels' operands) against the fp32 plain backward, at the window,
    softcap and sink cases' shapes (b 2, 4/2 heads, s 200, d 64): within
    the card's bf16 bar, and not equal (the rounding is real)."""
    q, k, v, do, kw = feature_case(name) if name != "causal" else (*feature_case("window")[:4], {})
    kw = as_torch(kw)
    q, k, v, do = (T(x) for x in (q, k, v, do))
    ref = kattn.flash_attention_bwd_plain(q, k, v, do, **kw)[:3]
    exact = _recompute_backward(q, k, v, do, kw, round_operands=False)
    rounded = _recompute_backward(q, k, v, do, kw, round_operands=True)
    for r, e, g in zip(ref, exact, rounded):
        scale = max(1.0, float(r.abs().max()))
        assert_close(e, r, TOL * scale)  # the recompute is the plain backward
        err = float((g - r).abs().max())
        assert 0 < err <= BF16_TOL * scale, err


# MiMo-V2-Flash's heads: d 64, dv 32; SWA layers window + sinks with 3 q heads
# per kv head, GA layers causal with 6. DeepSeek-V3's MLA: d 96, dv 64,
# causal, as many kv heads as q heads (MLA's scale is q's width^-0.5, the default)
DV_CASES = {
    "window_sink": {"hq": 6, "hkv": 2, "window_size": 32, "sink": True},
    "causal_gqa6": {"hq": 6, "hkv": 1},
    "mla_96_64": {"hq": 4, "hkv": 4, "d": 96, "dv": 64},
}


@pytest.mark.parametrize("name", DV_CASES)
def test_k4_plain_dv_matches_pallas(name):
    """K4 at d 64 / dv 32 and at d 96 / dv 64: the plain version, its
    autograd dq/dk/dv(/dsink) and the plain backward against the
    interpret-mode kernel and jax.grad of it; s 200 ends inside a key tile."""
    case = DV_CASES[name]
    b, s, d, dv = 2, 200, case.get("d", 64), case.get("dv", 32)
    q, k = rand(b, case["hq"], s, d), rand(b, case["hkv"], s, d, seed=1)
    v, do = rand(b, case["hkv"], s, dv, seed=2), rand(b, case["hq"], s, dv, seed=3)
    sink = rand(case["hq"], seed=5) if case.get("sink") else None
    kw = {"window_size": case.get("window_size")}

    def jout(q, k, v, *sink_arg):
        return jflash(q, k, v, causal=True, interpret=True, block_q=128, block_k=128,
                      sink=sink_arg[0] if sink_arg else None, **kw)

    args = [jnp.asarray(x) for x in (q, k, v) + (() if sink is None else (sink,))]
    ref_out = jout(*args)
    assert ref_out.shape == (b, case["hq"], s, dv)
    refs = jax.grad(lambda *a: jnp.sum(jout(*a) * jnp.asarray(do)), argnums=tuple(range(len(args))))(*args)
    leaves = [T(x).requires_grad_() for x in (q, k, v) + (() if sink is None else (sink,))]
    out = kattn.flash_attention(*leaves[:3], sink=leaves[3] if sink is not None else None, **kw)
    assert_close(out.detach(), ref_out, FWD_TOL)
    grads = torch.autograd.grad(out, leaves, T(do))
    plain = kattn.flash_attention_bwd(T(q), T(k), T(v), None, None, T(do), sink=None if sink is None else T(sink),
                                      **kw)
    assert len(grads) == len(plain) == len(refs) == (3 if sink is None else 4)
    assert grads[2].shape == (b, case["hkv"], s, dv)
    for got, got_plain, ref in zip(grads, plain, refs):
        assert_close(got, ref, GRAD_TOL)
        assert_close(got_plain, ref, GRAD_TOL)


def test_k4_window_at_least_s_is_causal():
    q, k, v = rand(1, 4, 40, 64), rand(1, 2, 40, 64, seed=1), rand(1, 2, 40, 64, seed=2)
    causal = kattn.flash_attention(T(q), T(k), T(v))
    for w in (40, 41, 1000):
        assert torch.equal(kattn.flash_attention(T(q), T(k), T(v), window_size=w), causal)


@pytest.mark.parametrize("s, w", [(16, 5), (33, 8), (64, 64), (20, 1)])
def test_causal_mask_window_matches_table(s, w):
    got = tcausal(s, s, window_size=w)[0, 0].numpy()
    np.testing.assert_array_equal(got, swa_causal_mask_table(s, w))


def test_causal_mask_window_with_offset_and_padding_matches_jax():
    pad = np.random.default_rng(4).random((2, 30)) > 0.3
    for q_start, q_len in ((0, 30), (10, 6), (29, 1)):
        ref = jcausal(q_len, 30, q_start=q_start, window_size=7, attn_mask=jnp.asarray(pad))
        got = tcausal(q_len, 30, q_start=q_start, window_size=7, attn_mask=T(pad))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hq, hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_sink_and_softcap_match_jax(hq, hkv, masked):
    b, sq, sk, d = 2, 9, 13, 16
    q, k, v = rand(b, hq, sq, d) * 3, rand(b, hkv, sk, d, seed=1), rand(b, hkv, sk, d, seed=2)
    sink = rand(hq, seed=3)
    mask = np.asarray(jcausal(sq, sk, q_start=sk - sq, window_size=5)) if masked else None
    for kw in ({"sink": sink}, {"softcap": 5.0}, {"sink": sink, "softcap": 5.0}):
        ref = jattn.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=None if mask is None else jnp.asarray(mask),
                         **as_jax(kw))
        got = tattn.sdpa(T(q), T(k), T(v), mask=None if mask is None else T(mask), **as_torch(kw))
        assert_close(got, ref, 1e-5)


def test_router_window_softcap_sink_take_flash_and_carry_gradients():
    """A windowed call with a softcap and sinks takes the router's flash route
    (its plain version here) and matches JAX's router on the interpret-mode
    kernel, gradients (the sink's included) too; the dense SWA mask passed
    for ``sdpa`` is ignored there, as in JAX."""
    b, hq, hkv, s, d = 1, 4, 2, 40, 64
    q, k, v, do = rand(b, hq, s, d), rand(b, hkv, s, d, seed=1), rand(b, hkv, s, d, seed=2), rand(b, hq, s, d, seed=3)
    sink = rand(hq, seed=4)
    dense = np.asarray(jcausal(s, s, window_size=12))
    jcfg = {"flash_min_seq": 32, "use_flash": True}

    def jloss(q, k, v, sink):
        out = jattn.attention(q, k, v, cfg=jcfg, mask=jnp.asarray(dense), causal=True, window_size=12, sink=sink,
                              softcap=10.0)
        return jnp.sum(out * jnp.asarray(do))

    refs = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, sink)))
    leaves = [T(x).requires_grad_() for x in (q, k, v, sink)]
    before = kattn.flash_attention.launches
    out = tattn.attention(*leaves[:3], cfg={"flash_min_seq": 32}, mask=T(dense), causal=True, window_size=12,
                          sink=leaves[3], softcap=10.0)
    assert kattn.flash_attention.launches == before  # the CPU runs the plain version
    for got, ref in zip(torch.autograd.grad(out, leaves, T(do)), refs):
        assert_close(got, ref, GRAD_TOL)


# ------------------------------------------- routing: JAX's switches and conditions


def _spy(monkeypatch, module, name, calls):
    """Replace ``module.name`` by a wrapper that records (name, kwargs) and calls it."""
    original = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((name, kwargs))
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


# (heads, d, s, cfg, layer_idx, expected route); the kernel takes h·d % 128 == 0,
# d ∈ {32, 64, 128} and 2 ≤ s ≤ fused_mha_max_seq, as JAX's mha_packed
PACKED_ROUTES = {
    "k7_d64": (2, 64, 20, {}, None, "packed_mha"),
    "k7_d32": (4, 32, 20, {}, None, "packed_mha"),
    "k7_d128_no_cfg": (1, 128, 20, None, None, "packed_mha"),
    "k7_s512": (2, 64, 512, {}, None, "packed_mha"),
    "s576": (2, 64, 576, {}, None, "sdpa"),
    "s1": (2, 64, 1, {}, None, "sdpa"),
    "hd96": (3, 32, 20, {}, None, "sdpa"),
    "d16": (8, 16, 20, {}, None, "sdpa"),
    "fused_off": (2, 64, 20, {"use_fused_mha": False}, None, "sdpa"),
    "max_seq": (2, 64, 20, {"fused_mha_max_seq": 16}, None, "sdpa"),
    "int8_dynamic": (2, 64, 20, {"int8_scores": True}, 1, "packed_mha_int8"),
    "int8_shared_pair": (2, 64, 20, {"int8_scores": True, "int8_qk_scales": (0.02, 0.03)}, 1, "packed_mha_int8"),
    "int8_per_layer": (2, 64, 20, {"int8_scores": True, "int8_qk_scales": [(0.01, 0.02), (0.03, 0.04)]}, 1,
                       "packed_mha_int8"),
    "inkernel": (2, 64, 20, {"int8_scores": True, "int8_scores_mode": "inkernel",
                             "int8_qk_scales": [(0.01, 0.02), (0.03, 0.04)]}, 1, "packed_mha_int8_inkernel"),
    "inkernel_no_scales": (2, 64, 20, {"int8_scores": True, "int8_scores_mode": "inkernel"}, None,
                           "packed_mha_int8"),
    "int8_fused_off": (2, 64, 20, {"int8_scores": True, "use_fused_mha": False}, None, "sdpa"),
}


@pytest.mark.parametrize("name", list(PACKED_ROUTES))
def test_mha_packed_routes_by_jax_conditions(monkeypatch, name):
    from llm_quest_tpu_torch.kernels import fused_mha as kfused

    heads, d, s, cfg, layer_idx, route = PACKED_ROUTES[name]
    calls = []
    _spy(monkeypatch, kattn, "packed_mha", calls)
    _spy(monkeypatch, kfused, "packed_mha_int8", calls)
    _spy(monkeypatch, kfused, "packed_mha_int8_inkernel", calls)
    q, k, v = (rand(2, s, heads * d, seed=i) for i in range(3))
    got = tattn.mha_packed(T(q), T(k), T(v), heads, cfg=cfg, layer_idx=layer_idx)
    assert [c[0] for c in calls] == ([] if route == "sdpa" else [route])
    if route == "sdpa":  # JAX's CPU route is the same split-heads sdpa
        assert_close(got, jattn.mha_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, cfg=cfg), 1e-5)
    scales = (cfg or {}).get("int8_qk_scales")
    if route == "packed_mha_int8":
        picked = None if scales is None else tuple(scales[layer_idx] if isinstance(scales, list) else scales)
        assert calls[0][1]["static_scales"] == picked


def test_router_honours_use_flash(monkeypatch):
    """use_flash=False sends a 300-token causal call to sdpa on the dense
    mask, as JAX's router; the default takes the flash wrapper."""
    b, hq, hkv, s, d = 1, 4, 2, 300, 64
    q, k, v = rand(b, hq, s, d), rand(b, hkv, s, d, seed=1), rand(b, hkv, s, d, seed=2)
    calls = []
    _spy(monkeypatch, kattn, "flash_attention", calls)
    got = tattn.attention(T(q), T(k), T(v), cfg={"use_flash": False}, causal=True)
    assert calls == []
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg={"use_flash": False}, causal=True)
    assert_close(got, ref, 1e-5)
    tattn.attention(T(q), T(k), T(v), cfg={}, causal=True)
    assert len(calls) == 1


# ------------------------------------------------------------ K5 and K6

K56_TOL = 1e-5
K5_CASES = {"mha_d32": (2, 2, 32, 32), "gqa_d64": (4, 2, 64, 64), "dv48": (2, 2, 32, 48)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(K5_CASES))
def test_k5_plain_matches_pallas_and_its_vjp(causal, name):
    """Output, lse and the gradients for an output and an lse cotangent
    (the lse's folds into the backward as the per-row shift)."""
    hq, hkv, d, dv = K5_CASES[name]
    b, s = 2, 136
    q, k, v = rand(b, hq, s, d), rand(b, hkv, s, d, seed=1), rand(b, hkv, s, dv, seed=2)
    do, g_lse = rand(b, hq, s, dv, seed=3), rand(b, hq, s, seed=4)

    def jfn(q, k, v):
        return jflash_lse(q, k, v, causal=causal, interpret=True, block_q=128, block_k=128)

    (ref_out, ref_lse), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    refs = vjp((jnp.asarray(do), jnp.asarray(g_lse)))
    leaves = [T(x).requires_grad_() for x in (q, k, v)]
    out, lse = kattn.flash_attention_with_lse(*leaves, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    assert_close(out.detach(), ref_out, K56_TOL)
    assert_close(lse.detach(), ref_lse, K56_TOL)
    for got, ref in zip(torch.autograd.grad((out, lse), leaves, (T(do), T(g_lse))), refs):
        assert_close(got, ref, K56_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s, d", [(20, 64), (197, 64), (27, 8)])
def test_k6_plain_matches_pallas_and_its_vjp(causal, s, d):
    b, h = 2, 3
    q, k, v, do = (rand(b, h, s, d, seed=i) for i in range(4))

    def jloss(q, k, v):
        return jnp.sum(jfused(q, k, v, causal=causal, interpret=True) * jnp.asarray(do))

    ref = jfused(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    refs = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    from llm_quest_tpu_torch.kernels import fused_mha as kfused

    leaves = [T(x).requires_grad_() for x in (q, k, v)]
    out = kfused.fused_mha(*leaves, causal=causal)
    assert_close(out.detach(), ref, K56_TOL)
    for got, ref_g in zip(torch.autograd.grad(out, leaves, T(do)), refs):
        assert_close(got, ref_g, K56_TOL)


# (hq, hkv, s, cfg, router keywords, expected route): JAX's K6 branch takes
# maskless calls with equal heads, sq == sk, dv == d, no sink/softcap/window
# and 2 <= s <= fused_mha_max_seq, before the flash test
FUSED_ROUTES = {
    "causal": (4, 4, 27, {}, {}, "fused_mha"),
    "bidirectional": (4, 4, 27, {}, {"causal": False}, "fused_mha"),
    "s512": (2, 2, 512, {}, {}, "fused_mha"),
    "gqa": (4, 2, 27, {}, {}, "sdpa"),
    "s1": (4, 4, 1, {}, {}, "sdpa"),
    "s513": (2, 2, 513, {}, {}, "flash_attention"),
    "fused_off": (4, 4, 27, {"use_fused_mha": False}, {}, "sdpa"),
    "max_seq": (4, 4, 27, {"fused_mha_max_seq": 16}, {}, "sdpa"),
    "no_cfg": (4, 4, 27, None, {}, "sdpa"),
    "dense_mask": (4, 4, 27, {}, {"mask": "causal"}, "sdpa"),
    "softcap": (4, 4, 27, {}, {"softcap": 20.0}, "sdpa"),
}


@pytest.mark.parametrize("name", list(FUSED_ROUTES))
def test_router_fused_mha_branch_by_jax_conditions(monkeypatch, name):
    from llm_quest_tpu_torch.kernels import fused_mha as kfused

    hq, hkv, s, cfg, kw, route = FUSED_ROUTES[name]
    calls = []
    _spy(monkeypatch, kfused, "fused_mha", calls)
    _spy(monkeypatch, kattn, "flash_attention", calls)
    q, k, v = rand(1, hq, s, 16), rand(1, hkv, s, 16, seed=1), rand(1, hkv, s, 16, seed=2)
    kw = dict(kw)
    if kw.get("mask") == "causal":
        kw["mask"] = tcausal(s)
    got = tattn.attention(T(q), T(k), T(v), cfg=cfg, **kw)
    assert [c[0] for c in calls] == ([] if route == "sdpa" else [route])
    # JAX's CPU route (no K6 off the TPU) is sdpa on the causal mask it rebuilds
    jkw = {key: jnp.asarray(val.numpy()) if torch.is_tensor(val) else val for key, val in kw.items()}
    ref = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cfg=cfg, **jkw)
    assert_close(got, ref, K56_TOL)


# ------------------------------------------------- K6/K7's lse and backward
#
# On the card K6 and K7 keep the row lse of their forward and take the flash
# recompute backward (llmq_attention_bwd) in place of autograd through the
# plain sdpa. These cases hold, on the CPU, the plain lse to JAX's scores,
# the lse-fed recompute to jax.grad of the interpret-mode kernels, and the
# tensor-core kernels' bf16 rounding (each kernel's own denominator
# included) to the card tests' bf16 bar. tests/test_torch_vit.py holds K7's.


def short_recompute(q, k, v, do, lse, causal, scale, *, round_operands=False, fp32_den=True):
    """The short-sequence kernels' forward and recompute backward in fp32 on
    (b, h, s, d) tensors, fed the row ``lse`` (b, h, s): P = exp(S − lse),
    O = P V, δ = rowsum(dO ⊙ O), dS = P ⊙ (dP − δ), dQ = dS K·scale,
    dK = dSᵀ Q·scale, dV = Pᵀ dO. With ``round_operands``, what the
    tensor-core kernels round to bf16: the forward's unnormalised p =
    exp(S − max) before P·V, divided by the sum of the fp32 p
    (``fp32_den``, K7's) or of the rounded p (K6's ones column); the
    backward's p and dS before their products, and δ from the forward's
    bf16 output. Returns (o, dq, dk, dv)."""
    s = q.shape[2]
    scores = q @ k.transpose(-1, -2) * scale
    if causal:
        scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), float("-inf"))
    p = torch.exp(scores - lse[..., None])
    o = p @ v
    out = o
    if round_operands:
        pu = torch.exp(scores - scores.amax(-1, keepdim=True))
        pr = pu.bfloat16().float()
        out = (pr @ v) / (pu if fp32_den else pr).sum(-1, keepdim=True)
    delta = (do * (out.bfloat16().float() if round_operands else o)).sum(-1, keepdim=True)
    ds = p * (do @ v.transpose(-1, -2) - delta)
    if round_operands:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    return out, ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do


def jax_lse(q, k, scale, causal):
    """JAX's row logsumexp of the kernels' scaled scores, (b, h, s, d) numpy
    inputs; masked scores at fused_mha.py's NEG_INF, as the kernels mask."""
    from llm_quest_tpu.kernels.fused_mha import NEG_INF

    scores = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k)) * scale
    if causal:
        s = q.shape[2]
        scores = jnp.where(jnp.triu(jnp.ones((s, s), bool), 1), NEG_INF, scores)
    return jax.nn.logsumexp(scores, axis=-1)


K6_SHORT = [(causal, s) for causal in (False, True) for s in (20, 197)]


@pytest.mark.parametrize("causal, s", K6_SHORT)
def test_k6_lse_plain_matches_jax_scores(causal, s):
    from llm_quest_tpu_torch.kernels import fused_mha as kfused

    q, k = rand(2, 3, s, 64), rand(2, 3, s, 64, seed=1)
    got = kfused.fused_mha_lse_plain(T(q), T(k), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, 3, s)
    assert_close(got, jax_lse(q, k, 64**-0.5, causal), K56_TOL)


@pytest.mark.parametrize("causal, s", K6_SHORT)
def test_k6_lse_recompute_matches_jax_grad(causal, s):
    """The recompute backward fed the plain lse equals jax.grad of JAX's
    interpret-mode fused_mha (its recompute VJP), and its O the kernel's."""
    from llm_quest_tpu_torch.kernels import fused_mha as kfused

    q, k, v, do = (rand(2, 3, s, 64, seed=i) for i in range(4))
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    ref_out = jfused(*jargs, causal=causal, interpret=True)
    refs = jax.grad(lambda *a: jnp.sum(jfused(*a, causal=causal, interpret=True) * jnp.asarray(do)),
                    argnums=(0, 1, 2))(*jargs)
    lse = kfused.fused_mha_lse_plain(T(q), T(k), causal=causal)
    got = short_recompute(T(q), T(k), T(v), T(do), lse, causal, 64**-0.5)
    for g, r in zip(got, (ref_out, *refs)):
        assert_close(g, r, K56_TOL)


@pytest.mark.parametrize("causal, s", K6_SHORT)
def test_k6_bf16_operand_rounding_stays_within_the_bf16_bar(causal, s):
    """K6's tensor-core rounding (p to bf16, the rounded p's sum as the
    denominator; p and dS to bf16 in the backward) against the fp32 plain
    forward and its autograd on the same bf16-valued inputs: within the
    card's bf16 bar, and not equal (the rounding is real)."""
    from llm_quest_tpu_torch.kernels import fused_mha as kfused

    q, k, v, do = (T(rand(2, 3, s, 64, seed=i)).bfloat16().float() for i in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = kfused.fused_mha(*leaves, causal=causal)
    refs = (out.detach(), *torch.autograd.grad(out, leaves, do))
    lse = kfused.fused_mha_lse_plain(q, k, causal=causal)
    got = short_recompute(q, k, v, do, lse, causal, 64**-0.5, round_operands=True, fp32_den=False)
    for g, r in zip(got, refs):
        scale = max(1.0, float(r.abs().max()))
        err = float((g - r).abs().max())
        assert 0 < err <= BF16_TOL * scale, err
