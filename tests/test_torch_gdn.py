"""The port's gated-delta-rule kernels' plain versions against the JAX package.

On the CPU the wrappers in ``llm_quest_tpu_torch/kernels/gdn.py`` run their
plain PyTorch versions; they are held to the Pallas kernels in interpret mode
(the way the JAX package's own tests run them here) and to the JAX scan:

- K1 (prefill): outputs and final state within 1e-4 fp32, the tolerance of an
  exact scan against the exact chunked form in another summation order; the
  chunk anchors within 1e-5 of the Pallas kernel's saved chunk states;
- K1's VJP (the autograd Function, both halves plain on the CPU) against
  ``jax.vjp`` of the Pallas kernel (its custom VJP) in interpret mode: every
  gradient within 1e-5 relative to max(1, max |g|), the same chunk algebra in
  another summation order;
- K2 (stacked decode step): within 1e-5, and every other layer untouched;
  also with q and k at their own head count (the plain version repeats them
  as JAX's caller does), on strided views with beta and alpha in fp32 or
  bf16 (read as they lie, as the kernel reads them), and K3 the same; the
  decode-step dispatchers take q/k at either head count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.kernels.gdn_pallas import (
    _gdn_pallas_call,
    gated_delta_rule_pallas,
    gated_delta_rule_step_pallas,
    gated_delta_rule_step_stacked_pallas,
)
from llm_quest_tpu.ops import gdn as jgdn
from llm_quest_tpu_torch.kernels import gdn as kgdn
from llm_quest_tpu_torch.ops import gdn as tgdn

K1_TOL = 1e-4
K1_ANCHOR_TOL = 1e-5
K1_GRAD_RTOL = 1e-5
K2_TOL = 1e-5
K3_TOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def inputs(b, h, s, dk, dv, seed=0):
    """l2-normalized q/k (as the model feeds them), β ∈ (0, 1), α near 1."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    q = unit(rng.standard_normal((b, h, s, dk)))
    k = unit(rng.standard_normal((b, h, s, dk)))
    v = rng.standard_normal((b, h, s, dv)).astype(np.float32)
    beta = (1 / (1 + np.exp(-rng.standard_normal((b, h, s))))).astype(np.float32)
    alpha = (1 / (1 + np.exp(-(rng.standard_normal((b, h, s)) * 0.3 + 2.0)))).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dv, dk)) * 0.1).astype(np.float32)
    return q, k, v, beta, alpha, s0


def assert_close(got, ref, tol):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max())
    assert err <= tol, err


@pytest.mark.parametrize("s", [1, 5, 156, 300])
@pytest.mark.parametrize("with_prev", [False, True])
def test_k1_plain_matches_pallas_and_scan(s, with_prev):
    q, k, v, beta, alpha, s0 = inputs(2, 2, s, 16, 8, seed=s)
    prev = s0 if with_prev else None
    out, st = kgdn.gated_delta_rule_fwd(T(q), T(k), T(v), T(beta), T(alpha), None if prev is None else T(prev))
    ref_out, ref_st = gated_delta_rule_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(beta), jnp.asarray(alpha),
        jnp.asarray(s0 if with_prev else np.zeros_like(s0)), 64, True,
    )
    assert_close(out, ref_out, K1_TOL)
    assert_close(st, ref_st, K1_TOL)
    scan_out, scan_st = jgdn.gated_delta_rule(*map(jnp.asarray, (q, k, v, beta, alpha)), prev_state=prev)
    assert_close(out, scan_out, K1_TOL)
    assert_close(st, scan_st, K1_TOL)


def test_k1_masked_pad_row():
    """A right-padded row (β = 0, α = 1 on the pads): the pads leave the state
    alone, so the final state equals the state after the row's last real token."""
    b, s, real = 2, 40, 23
    q, k, v, beta, alpha, s0 = inputs(b, 2, s, 16, 8, seed=7)
    mask = np.ones((b, s), bool)
    mask[1, real:] = False
    fb, fa = tgdn.freeze_masked_updates(T(beta), T(alpha), T(mask))
    jb, ja = jgdn.freeze_masked_updates(jnp.asarray(beta), jnp.asarray(alpha), jnp.asarray(mask))
    out, st = kgdn.gated_delta_rule_fwd(T(q), T(k), T(v), fb, fa, T(s0))
    ref_out, ref_st = gated_delta_rule_pallas(*map(jnp.asarray, (q, k, v)), jb, ja, jnp.asarray(s0), 64, True)
    assert_close(out, ref_out, K1_TOL)
    assert_close(st, ref_st, K1_TOL)
    _, st_real = jgdn.gated_delta_rule(
        *(jnp.asarray(x[1:, :, :real]) for x in (q, k, v, beta, alpha)), prev_state=jnp.asarray(s0[1:])
    )
    assert_close(st[1:], st_real, K1_TOL)


@pytest.mark.parametrize("s", [64, 130])
def test_k1_anchors_match_pallas_chunk_states(s):
    """The forward's anchors are the state before each chunk of 64 tokens."""
    q, k, v, beta, alpha, s0 = inputs(2, 2, s, 16, 8, seed=11)
    _, _, anchors = kgdn.gated_delta_rule_fwd_plain(*map(T, (q, k, v, beta, alpha, s0)), with_anchors=True)
    _, _, ref = _gdn_pallas_call(*map(jnp.asarray, (q, k, v, beta, alpha, s0)), chunk_size=64, interpret=True,
                                 save_chunk_states=True)
    assert anchors.shape == ref.shape == (-(-s // 64), 2, 2, 8, 16)
    assert_close(anchors, ref, K1_ANCHOR_TOL)


@pytest.mark.parametrize("s, with_prev", [(130, True), (130, False), (64, True), (5, False)])
def test_k1_vjp_matches_pallas_vjp(s, with_prev):
    """A padded tail (130 = 2·64 + 2), prev_state on and off, and nonzero
    cotangents of both the output and the final state."""
    q, k, v, beta, alpha, s0 = inputs(2, 2, s, 16, 8, seed=20 + s)
    rng = np.random.default_rng(s)
    ct_out = rng.standard_normal((2, 2, s, 8)).astype(np.float32)
    ct_state = rng.standard_normal((2, 2, 8, 16)).astype(np.float32)
    prev = s0 if with_prev else np.zeros_like(s0)
    _, vjp = jax.vjp(lambda *a: gated_delta_rule_pallas(*a, 64, True), *map(jnp.asarray, (q, k, v, beta, alpha, prev)))
    ref = vjp((jnp.asarray(ct_out), jnp.asarray(ct_state)))
    args = [T(x).requires_grad_() for x in (q, k, v, beta, alpha, prev)]
    before = kgdn.gated_delta_rule_fwd.launches, kgdn.gated_delta_rule_bwd.launches
    out, state = kgdn.gated_delta_rule_fwd(*args[:5], args[5] if with_prev else None)
    grads = torch.autograd.grad((out, state), args if with_prev else args[:5], (T(ct_out), T(ct_state)))
    assert (kgdn.gated_delta_rule_fwd.launches, kgdn.gated_delta_rule_bwd.launches) == before  # plain on the CPU
    for name, got, r in zip(("q", "k", "v", "beta", "alpha", "prev_state"), grads, ref):
        assert_close(got, r, K1_GRAD_RTOL * max(1.0, float(np.abs(np.asarray(r)).max())))


def test_k1_bwd_plain_without_state_cotangent():
    """``d_state=None`` is a zero cotangent of the final state."""
    q, k, v, beta, alpha, s0 = (T(x) for x in inputs(1, 2, 40, 16, 8, seed=5))
    d_out = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 2, 40, 8)).astype(np.float32))
    _, _, anchors = kgdn.gated_delta_rule_fwd_plain(q, k, v, beta, alpha, s0, chunk_size=16, with_anchors=True)
    got = kgdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=16)
    ref = kgdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, torch.zeros_like(s0), chunk_size=16)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("s", [1, 5, 130])
def test_auto_dispatch_matches_jax(s):
    q, k, v, beta, alpha, s0 = inputs(1, 2, s, 16, 8, seed=3)
    out, st = tgdn.gated_delta_rule_auto(T(q), T(k), T(v), T(beta), T(alpha), T(s0))
    ref_out, ref_st = jgdn.gated_delta_rule_auto(*map(jnp.asarray, (q, k, v, beta, alpha, s0)))
    assert_close(out, ref_out, K1_TOL)
    assert_close(st, ref_st, K1_TOL)


@pytest.mark.parametrize("layer", [0, 2, 3])
def test_k2_plain_stacked_step_matches_pallas(layer):
    n_layers, b, h, dk, dv = 4, 2, 4, 16, 8
    q, k, v, beta, alpha, _ = inputs(b, h, 1, dk, dv, seed=layer)
    q, k, v, beta, alpha = (x[:, :, 0] for x in (q, k, v, beta, alpha))
    stacked = (np.random.default_rng(9).standard_normal((n_layers, b, h, dv, dk)) * 0.1).astype(np.float32)
    t_stacked = T(stacked)
    out, new = kgdn.gated_delta_rule_step_stacked(T(q), T(k), T(v), T(beta), T(alpha), t_stacked, layer)
    assert new is t_stacked  # updated in place
    ref_out, ref_stacked = gated_delta_rule_step_stacked_pallas(
        *map(jnp.asarray, (q, k, v, beta, alpha, stacked)), layer, interpret=True
    )
    assert_close(out, ref_out, K2_TOL)
    assert_close(new[layer], ref_stacked[layer], K2_TOL)
    for other in range(n_layers):
        if other != layer:
            assert np.array_equal(new[other].numpy(), stacked[other])


# (b, h, h_qk, dk, dv): small ones, Qwen3.5-0.8B's b 1 (16 heads of 128),
# Qwen3-Next-small's b 4 (8 v heads reading 4 qk heads of 64), odd ones
QK_SHAPES = [(2, 4, 2, 16, 8), (1, 8, 4, 64, 64), (3, 6, 2, 32, 16), (1, 16, 16, 128, 128), (4, 8, 4, 64, 64),
             (1, 3, 1, 32, 72), (2, 3, 3, 16, 72), (5, 1, 1, 8, 8)]


@pytest.mark.parametrize("b, h, h_qk, dk, dv", QK_SHAPES)
def test_k2_plain_step_at_qk_heads_matches_pallas(b, h, h_qk, dk, dv):
    """K2 with q and k at their own h_qk heads (the models' call since the
    step reads v head i's at i // (h / h_qk)) against the Pallas kernel fed
    the heads repeated, as JAX's caller repeats them."""
    n_layers, layer = 3, 1
    q, k, v, beta, alpha, _ = inputs(b, h, 1, dk, dv, seed=h_qk + dk)
    q, k = q[:, :h_qk, 0], k[:, :h_qk, 0]
    v, beta, alpha = v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
    stacked = (np.random.default_rng(5).standard_normal((n_layers, b, h, dv, dk)) * 0.1).astype(np.float32)
    t_stacked = T(stacked)
    out, new = kgdn.gated_delta_rule_step_stacked(T(q), T(k), T(v), T(beta), T(alpha), t_stacked, layer)
    r = h // h_qk
    ref_out, ref_stacked = gated_delta_rule_step_stacked_pallas(
        *map(jnp.asarray, (np.repeat(q, r, axis=1), np.repeat(k, r, axis=1), v, beta, alpha, stacked)), layer,
        interpret=True,
    )
    assert_close(out, ref_out, K2_TOL)
    assert_close(new[layer], ref_stacked[layer], K2_TOL)
    for other in (0, 2):
        assert np.array_equal(new[other].numpy(), stacked[other])


@pytest.mark.parametrize("b, h, h_qk, dk, dv", [(2, 4, 2, 16, 8), (1, 8, 4, 64, 64), (1, 3, 1, 32, 72)])
def test_k3_plain_step_at_qk_heads_matches_pallas(b, h, h_qk, dk, dv):
    """K3 with q and k at fewer heads than v against
    ``gated_delta_rule_step_pallas(interpret=True)`` fed them repeated."""
    q, k, v, beta, alpha, s0 = inputs(b, h, 1, dk, dv, seed=11)
    q, k = q[:, :h_qk, 0], k[:, :h_qk, 0]
    v, beta, alpha = v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
    state = T(s0)
    out, new = kgdn.gated_delta_rule_step(T(q), T(k), T(v), T(beta), T(alpha), state)
    assert new is state
    ref_out, ref_state = gated_delta_rule_step_pallas(
        *map(jnp.asarray, (np.repeat(q, h // h_qk, axis=1), np.repeat(k, h // h_qk, axis=1), v, beta, alpha, s0)),
        interpret=True,
    )
    assert_close(out, ref_out, K3_TOL)
    assert_close(new, ref_state, K3_TOL)


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("h_qk", [4, 2])
@pytest.mark.parametrize("alpha_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("beta_dtype", [torch.float32, torch.bfloat16])
def test_k2_plain_step_on_views_in_their_own_dtype(beta_dtype, alpha_dtype, h_qk, layer):
    """K2 as the models call it: q/k/v views of one fused projection one
    element in, q/k at their own head count, beta and alpha strided views in
    fp32 or bf16 (the kernel reads each as it lies and widens it to fp32),
    against the Pallas kernel fed the repeated heads and beta/alpha's values
    in fp32."""
    n_layers, b, h, dk, dv = 3, 2, 4, 16, 8
    q, k, v, beta, alpha, _ = inputs(b, h, 1, dk, dv, seed=h_qk + 7 * layer)
    q, k = q[:, :h_qk, 0], k[:, :h_qk, 0]
    v, beta, alpha = v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
    n = h_qk * dk
    fused = torch.cat([torch.zeros(b, 1), T(q).flatten(1), T(k).flatten(1), T(v).flatten(1)], dim=1)
    views = (fused[:, 1:1 + n].view(b, h_qk, dk), fused[:, 1 + n:1 + 2 * n].view(b, h_qk, dk),
             fused[:, 1 + 2 * n:].view(b, h, dv))
    ba = torch.stack([T(beta).to(beta_dtype).float(), T(alpha).to(alpha_dtype).float()], dim=-1)
    beta_v, alpha_v = ba[..., 0].to(beta_dtype), ba[..., 1].to(alpha_dtype)  # (b, h) views at stride 2
    stacked = (np.random.default_rng(3).standard_normal((n_layers, b, h, dv, dk)) * 0.1).astype(np.float32)
    t_stacked = T(stacked)
    out, new = kgdn.gated_delta_rule_step_stacked(*views, beta_v, alpha_v, t_stacked, layer)
    r = h // h_qk
    ref_out, ref_stacked = gated_delta_rule_step_stacked_pallas(
        *map(jnp.asarray, (np.repeat(q, r, axis=1), np.repeat(k, r, axis=1), v, ba[..., 0].numpy(),
                           ba[..., 1].numpy(), stacked)), layer, interpret=True,
    )
    assert_close(out, ref_out, K2_TOL)
    assert_close(new[layer], ref_stacked[layer], K2_TOL)
    for other in set(range(n_layers)) - {layer}:
        assert np.array_equal(new[other].numpy(), stacked[other])


@pytest.mark.parametrize("b, h, h_qk, dk, dv", [(2, 4, 2, 16, 8), (1, 8, 4, 64, 64), (3, 6, 3, 32, 16)])
@pytest.mark.parametrize("stacked", [True, False])
def test_step_dispatch_takes_qk_or_repeated_heads(b, h, h_qk, dk, dv, stacked):
    """``gated_delta_rule_step_stacked_auto`` and ``gated_delta_rule_step_auto``
    give the same output and state, bit for bit, whether q and k come at
    their own h_qk heads (the models' call) or repeated to h (JAX's)."""
    q, k, v, beta, alpha, s0 = (T(x) for x in inputs(b, h, 1, dk, dv, seed=dv + h_qk))
    q, k = q[:, :h_qk, 0], k[:, :h_qk, 0]
    v, beta, alpha = v[:, :, 0], beta[:, :, 0], alpha[:, :, 0]
    r = h // h_qk
    results = []
    for qq, kk in ((q, k), (q.repeat_interleave(r, dim=1), k.repeat_interleave(r, dim=1))):
        if stacked:
            st = torch.stack([s0, s0 + 1])
            out, st = tgdn.gated_delta_rule_step_stacked_auto({}, qq, kk, v, beta, alpha, st, 1)
        else:
            out, st = tgdn.gated_delta_rule_step_auto({}, qq, kk, v, beta, alpha, s0.clone())
        results.append((out, st))
    (out_a, st_a), (out_b, st_b) = results
    assert torch.equal(out_a, out_b) and torch.equal(st_a, st_b)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches a kernel: no launch is counted and the
    result is the plain version's, bit for bit."""
    q, k, v, beta, alpha, s0 = (T(x) for x in inputs(1, 2, 9, 16, 8))
    before = kgdn.gated_delta_rule_fwd.launches, kgdn.gated_delta_rule_step_stacked.launches
    out, st = kgdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0)
    ref_out, ref_st = kgdn.gated_delta_rule_fwd_plain(q, k, v, beta, alpha, s0)
    assert torch.equal(out, ref_out) and torch.equal(st, ref_st)
    step = (x[:, :, 0] for x in (q, k, v, beta, alpha))
    kgdn.gated_delta_rule_step_stacked(*step, s0[None].clone(), 0)
    assert (kgdn.gated_delta_rule_fwd.launches, kgdn.gated_delta_rule_step_stacked.launches) == before


def test_dispatch_honours_use_gdn_kernel(monkeypatch):
    """cfg["use_gdn_kernel"] = False (JAX's switch) reaches the plain GDN
    versions, the prefill's chunked form and the plain step, as
    ``use_kernels=False`` does; the default asks for the kernels."""
    calls = []
    for name in ("gated_delta_rule_fwd", "gated_delta_rule_step_stacked"):
        original = getattr(kgdn, name)

        def spy(*args, _original=original, _name=name, **kwargs):
            calls.append((_name, kwargs.get("plain", False)))
            return _original(*args, **kwargs)

        monkeypatch.setattr(kgdn, name, spy)
    q, k, v, beta, alpha, s0 = (T(x) for x in inputs(1, 2, 9, 16, 8))
    step = [x[:, :, 0] for x in (q, k, v, beta, alpha)]
    for cfg, plain in (({}, False), ({"use_gdn_kernel": False}, True), ({"use_kernels": False}, True)):
        calls.clear()
        tgdn.gated_delta_rule_dispatch(cfg, q, k, v, beta, alpha, s0)
        tgdn.gated_delta_rule_step_stacked_auto(cfg, *step, s0[None].clone(), 0)
        assert calls == [("gated_delta_rule_fwd", plain), ("gated_delta_rule_step_stacked", plain)], cfg


@pytest.mark.parametrize("b, h, dk, dv", [(2, 4, 16, 8), (1, 3, 32, 32), (5, 2, 8, 24)])
def test_k3_plain_step_matches_pallas(b, h, dk, dv):
    """K3 (one layer's decode step): the output and the new state against
    ``gated_delta_rule_step_pallas(interpret=True)``, the state updated in
    place and returned, as JAX aliases it."""
    q, k, v, beta, alpha, s0 = inputs(b, h, 1, dk, dv, seed=dk + b)
    q, k, v, beta, alpha = (x[:, :, 0] for x in (q, k, v, beta, alpha))
    state = T(s0)
    out, new = kgdn.gated_delta_rule_step(T(q), T(k), T(v), T(beta), T(alpha), state)
    assert new is state
    ref_out, ref_state = gated_delta_rule_step_pallas(*map(jnp.asarray, (q, k, v, beta, alpha, s0)), interpret=True)
    assert_close(out, ref_out, K3_TOL)
    assert_close(new, ref_state, K3_TOL)


def test_step_auto_honours_use_gdn_kernel(monkeypatch):
    """``gated_delta_rule_step_auto`` (JAX ops/gdn.py:108) asks for K3 unless
    ``use_gdn_kernel`` (or ``use_kernels``) is False; its result is JAX's."""
    calls = []
    original = kgdn.gated_delta_rule_step

    def spy(*args, **kwargs):
        calls.append(kwargs.get("plain", False))
        return original(*args, **kwargs)

    monkeypatch.setattr(kgdn, "gated_delta_rule_step", spy)
    q, k, v, beta, alpha, s0 = inputs(2, 2, 1, 16, 8, seed=4)
    step = [x[:, :, 0] for x in (q, k, v, beta, alpha)]
    ref_out, ref_state = jgdn.gated_delta_rule_step_auto({}, *map(jnp.asarray, step), jnp.asarray(s0))
    for cfg, plain in (({}, False), ({"use_gdn_kernel": False}, True), ({"use_kernels": False}, True)):
        calls.clear()
        out, state = tgdn.gated_delta_rule_step_auto(cfg, *map(T, step), T(s0))
        assert calls == [plain], cfg
        assert_close(out, ref_out, K3_TOL)
        assert_close(state, ref_state, K3_TOL)
