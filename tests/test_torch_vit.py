"""The ported ViT encode path and the int8-score kernels against the JAX package, on the CPU.

On the CPU the wrappers in ``llm_quest_tpu_torch/kernels/fused_mha.py`` run
their plain versions. They are held to the Pallas kernels in interpret mode:

- ``quantize_sym`` against JAX's ``_quantize_sym``: equal int8 tensors and an
  equal scale, half-way points included (round half to even);
- K8 (``packed_mha_int8``, dynamic and static scales) at b 2, s 60, 2 heads
  of 64 and 4 heads of 32, fp32 within 1e-5; in bf16 the int8 values equal
  and the output within 2e-2 relative; K9 (``packed_mha_int8_inkernel``)
  within 1e-5 and equal to K8's static plain version bit for bit;
- K8's straight-through gradient and K7's recompute gradient against
  ``jax.grad`` of the interpret-mode kernels (their custom VJPs), 1e-5;
- the bf16 tensor-core kernel of K8/K9 (``csrc/packed_mha_int8_tc.cu``):
  its pass 1 keeps each row's integer max, equal bit for bit to the max of
  the scaled row at d 32/64/128 and dq from 1e-8 to 1; its x / s, a product
  by fl(1 / s) with the exact quotient near half-integers, rounds to JAX's
  int8 values bit for bit; and its arithmetic,
  emulated in plain PyTorch (``emulate_int8_tc``), is held to JAX's
  interpret-mode kernels in the three modes at s 197 within the bf16 bar,
  its dynamic int8 values equal to ``_quantize_sym``'s.

The tiny ViT of ``tests/test_flash_attention.py`` (32 px, patch 8, emb 128,
2 heads of 64, 2 layers) and a 4-head d-32 variant are initialised in JAX,
flattened and loaded with ``from_jax_flat``: logits and hidden states within
1e-4, calibrated scales within 1e-6 relative, and the three int8 modes within
1e-4 of JAX ``vit.apply`` whose ``mha_packed`` the test points at JAX's
interpret-mode K7/K8/K9 (JAX routes to its kernels only on a TPU; the test
patches a name in the JAX module and edits no JAX file).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.kernels import fused_mha as jf
from llm_quest_tpu.models import vit as jv
from llm_quest_tpu.training import flops as jflops
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import config as tconfig
from llm_quest_tpu_torch.kernels import attention as kattn
from llm_quest_tpu_torch.kernels import fused_mha as tf
from llm_quest_tpu_torch.models import vit as tv
from llm_quest_tpu_torch.training import flops as tflops
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {"img_width": 32, "img_height": 32, "patch_size": 8, "emb_dim": 128, "n_heads": 2, "n_layers": 2,
        "hidden_dim": 256, "num_classes": 10, "num_channels": 3, "qkv_bias": True, "drop_rate": 0.0}
TINY_D32 = dict(TINY, n_heads=4)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(x)


def max_err(got, ref):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    return float(np.abs(got.astype(np.float64) - np.asarray(ref, np.float64)).max())


def qkv(b=2, s=60, hd=128, dtype=np.float32):
    return rand(b, s, hd, scale=0.7).astype(dtype), rand(b, s, hd, seed=1, scale=0.7).astype(dtype), \
        rand(b, s, hd, seed=2).astype(dtype)


def static_scales(q, k):
    return float(np.abs(q).max()) / 127.0, float(np.abs(k).max()) / 127.0


@pytest.mark.parametrize("case", ["random", "halfway"])
def test_quantize_sym_matches_jax(case):
    if case == "random":
        x = rand(3, 50, 64)
    else:  # max 127 gives s = 1 + 1e-12 = 1.0 in fp32: x / s lands on the half-way points
        x = np.array([127.0, -126.5, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -3.5, 0.0], np.float32)
    got, got_s = tf.quantize_sym(T(x))
    ref, ref_s = jf._quantize_sym(J(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int8 and float(got_s) == float(ref_s)
    if case == "halfway":
        assert got.tolist() == [127, -126, 0, 2, 2, 0, -2, -2, 4, 126, -4, 0]


@pytest.mark.parametrize("heads", [2, 4])  # d 64 and d 32, h·d 128
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_k8_plain_matches_pallas(heads, mode):
    q, k, v = qkv()
    ss = static_scales(q, k) if mode == "static" else None
    got = tf.packed_mha_int8(T(q), T(k), T(v), heads, static_scales=ss)
    ref = jf.packed_mha_int8(J(q), J(k), J(v), heads, None, True, ss)
    assert max_err(got, ref) <= 1e-5


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_k8_plain_bf16_matches_pallas(mode):
    q, k, v = qkv()
    qb, kb, vb = (T(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jvv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb))
    if mode == "dynamic":
        (qi, qs), (ji, js) = tf.quantize_sym(qb), jf._quantize_sym(jq)
        np.testing.assert_array_equal(qi.numpy(), np.asarray(ji))
        assert float(qs) == float(js)
        ss = None
    else:
        ss = static_scales(q, k)
        ref_i = jnp.clip(jnp.round(jq.astype(jnp.float32) * (1.0 / ss[0])), -127, 127).astype(jnp.int8)
        np.testing.assert_array_equal(tf.quantize_static(qb, ss[0]).numpy(), np.asarray(ref_i))
    got = tf.packed_mha_int8(qb, kb, vb, 2, static_scales=ss)
    ref = np.asarray(jf.packed_mha_int8(jq, jk, jvv, 2, None, True, ss).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert max_err(got, ref) <= 2e-2 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("heads", [2, 4])
def test_k9_plain_matches_pallas_and_k8_static(heads):
    q, k, v = qkv(s=50)
    ss = static_scales(q, k)
    got = tf.packed_mha_int8_inkernel(T(q), T(k), T(v), heads, ss)
    ref = jf.packed_mha_int8_inkernel(J(q), J(k), J(v), n_heads=heads, static_scales=ss, interpret=True)
    assert max_err(got, ref) <= 1e-5
    assert torch.equal(got, tf.packed_mha_int8(T(q), T(k), T(v), heads, static_scales=ss))
    with pytest.raises(NotImplementedError):  # forward only, as JAX's
        tf.packed_mha_int8_inkernel(T(q).requires_grad_(), T(k), T(v), heads, ss)


@pytest.mark.parametrize("kernel", ["k7", "k8_dynamic", "k8_static"])
def test_packed_gradients_match_jax_vjp(kernel):
    """K7's recompute backward and K8's straight-through backward against
    jax.grad of the interpret-mode kernels (their custom VJPs)."""
    q, k, v = qkv(s=40)
    do = rand(2, 40, 128, seed=5)
    ss = static_scales(q, k) if kernel == "k8_static" else None
    if kernel == "k7":
        jfn, tfn = (lambda *a: jf.packed_mha(*a, 2, None, True)), (lambda *a: kattn.packed_mha(*a, 2))
    else:
        jfn = lambda *a: jf.packed_mha_int8(*a, 2, None, True, ss)  # noqa: E731
        tfn = lambda *a: tf.packed_mha_int8(*a, 2, static_scales=ss)  # noqa: E731
    refs = jax.grad(lambda *a: jnp.sum(jfn(*a) * J(do)), argnums=(0, 1, 2))(J(q), J(k), J(v))
    leaves = [T(x).requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(tfn(*leaves), leaves, T(do))
    for got, ref in zip(grads, refs):
        assert max_err(got, ref) <= 1e-5


# K8/K9's tensor-core kernel (csrc/packed_mha_int8_tc.cu), emulated on the
# CPU: its row max is the largest int32 score scaled once, and its arithmetic
# step by step is held to JAX's interpret-mode kernels. Heads of 128, 64, 32
# at h·d 128.
K8_HEADS = {"d128": 1, "d64": 2, "d32": 4}


@pytest.mark.parametrize("d", [32, 64, 128])
def test_k8_integer_row_max_is_the_scaled_max(d):
    """fl(max_j s_j · dq) == max_j fl(s_j · dq), bit for bit, for int32 rows
    of int8 dot products and dq > 0: the kernel's pass 1 keeps only the
    integer max, the TPU kernel takes the max of the scaled row."""
    rng = np.random.default_rng(d)
    qi = rng.integers(-127, 128, (24, d)).astype(np.int64)
    ki = rng.integers(-127, 128, (300, d)).astype(np.int64)
    s32 = qi @ ki.T
    assert np.abs(s32).max() < 2**24  # exact in fp32
    s32f = s32.astype(np.float32)
    for dq in np.concatenate([np.geomspace(1e-8, 1.0, 61), rng.uniform(1e-8, 1.0, 40)]).astype(np.float32):
        scaled_max = (s32.max(-1).astype(np.float32) * dq).astype(np.float32)
        max_scaled = (s32f * dq).astype(np.float32).max(-1)
        np.testing.assert_array_equal(scaled_max.view(np.int32), max_scaled.view(np.int32))


def test_k8_tc_division_rule_is_exact():
    """K8's dynamic quantization on the tensor cores (``quotient`` in
    csrc/packed_mha_int8_tc.cu): y = fl(x · fl(1 / s)), and where a
    half-integer lies within 2^-14 of y the exact fl(x / s). clip(round(y))
    equals JAX's clip(round(x / s)) bit for bit, in float32, on bf16 tensors
    at their dynamic scales and on x at and beside every half-integer
    quotient, where the exact branch must be taken."""
    f32 = np.float32
    rng = np.random.default_rng(7)

    def rule(x, s):
        y = x * (f32(1) / s)
        n = (y + f32(12582912)) - f32(12582912)  # y rounded to an integer
        near = np.abs(np.abs(y - n) - f32(0.5)) < f32(2**-14)
        return np.where(near, x / s, y), near

    def int8(y):
        return np.clip(np.rint(y), -127, 127)

    exact_taken = 0
    for scale in (1e-3, 0.7, 30.0):
        x = torch.from_numpy(rng.standard_normal(200_000).astype(f32) * f32(scale)).bfloat16().float().numpy()
        s = np.abs(x).max() / f32(127) + f32(1e-12)  # dynamic_scale's fp32 arithmetic
        assert s.dtype == f32
        half = ((np.arange(-127, 127) + 0.5) * np.float64(s)).astype(f32)
        around, up, down = [half], half, half
        for _ in range(3):  # three float32 steps either side
            up, down = np.nextafter(up, f32(np.inf)), np.nextafter(down, f32(-np.inf))
            around += [up, down]
        for xs in (x, np.concatenate(around)):
            y, near = rule(xs, s)
            np.testing.assert_array_equal(int8(y), int8(xs / s))
            exact_taken += int(near.sum())
    assert exact_taken > 0


def emulate_int8_tc(q, k, v, heads, static_scales=None):
    """packed_mha_int8_tc.cu's arithmetic in plain PyTorch, on bf16 packed
    q/k/v: q and k quantized by x / s (the wrapper's ``dynamic_scales``) or
    x · fl(1 / s), exact int32 scores, each row's integer max scaled once,
    p = exp(fl(s · dq) − m) in fp32, p rounded to bf16 for p·V with fp32
    sums, the fp32 sum of the unrounded p as the denominator. Returns (out,
    int8 q, int8 k)."""
    d = q.shape[-1] // heads
    scale = np.float32(d**-0.5)
    if static_scales is None:
        s = tf.dynamic_scales(q, k)
        qi, ki = (torch.round(x.float() / s[i]).clamp(-127, 127) for i, x in enumerate((q, k)))
        dq = np.float32(np.float32(s[0]) * np.float32(s[1])) * scale
    else:
        q_s, k_s = static_scales
        qi, ki = (torch.round(x.float() * np.float32(1.0 / sc)).clamp(-127, 127) for x, sc in ((q, q_s), (k, k_s)))
        dq = np.float32(q_s * k_s * float(scale))
    qh, kh = (t.to(torch.int64).unflatten(-1, (heads, d)).transpose(1, 2) for t in (qi, ki))
    s32 = qh @ kh.transpose(-1, -2)
    m = s32.amax(-1, keepdim=True).float() * float(dq)
    p = torch.exp(s32.float() * float(dq) - m)
    num = p.bfloat16().float() @ v.float().unflatten(-1, (heads, d)).transpose(1, 2)
    out = (num / p.sum(-1, keepdim=True)).transpose(1, 2).flatten(2).bfloat16()
    return out, qi.to(torch.int8), ki.to(torch.int8)


@pytest.mark.parametrize("heads", list(K8_HEADS.values()), ids=list(K8_HEADS))
@pytest.mark.parametrize("mode", ["dynamic", "static", "inkernel"])
def test_k8_tc_emulation_matches_pallas(heads, mode):
    """The emulation against JAX's _packed_mha_int8_kernel (dynamic, static)
    and _packed_mha_int8_ik_kernel (inkernel) in interpret mode, bf16 inputs
    at s 197 (a partial last 16-key step), within the bf16 bar; dynamic
    int8 values equal to _quantize_sym's."""
    q, k, v = qkv(s=197)
    qb, kb, vb = (T(x).to(torch.bfloat16) for x in (q, k, v))
    jq, jk, jvv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb))
    ss = None if mode == "dynamic" else static_scales(qb.float().numpy(), kb.float().numpy())
    got, qi, ki = emulate_int8_tc(qb, kb, vb, heads, ss)
    if mode == "dynamic":
        for mine, x in ((qi, jq), (ki, jk)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(jf._quantize_sym(x)[0]))
        assert torch.equal(tf.dynamic_scales(qb, kb), torch.stack([tf.dynamic_scale(qb), tf.dynamic_scale(kb)]))
    if mode == "inkernel":
        ref = jf.packed_mha_int8_inkernel(jq, jk, jvv, n_heads=heads, static_scales=ss, interpret=True)
    else:
        ref = jf.packed_mha_int8(jq, jk, jvv, heads, None, True, ss)
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert max_err(got, ref) <= 2e-2 * max(1.0, float(np.abs(ref).max()))


def _models(cfg, seed=3):
    params = jv.init(jax.random.PRNGKey(seed), dict(cfg, dtype=jnp.float32))
    flat = {name: np.asarray(a) for name, a in flatten_params(params).items()}
    return params, from_jax_flat(flat, dict(cfg, dtype=torch.float32), device="cpu"), flat


@pytest.mark.parametrize("cfg", [TINY, TINY_D32], ids=["d64", "d32"])
def test_vit_logits_and_hidden_states_match_jax(cfg):
    params, model, flat = _models(cfg)
    assert isinstance(model, tv.ViT)
    # the patch conv weight keeps its conv layout; linears are transposed
    np.testing.assert_array_equal(model.patch_emb["conv_w"].detach().numpy(), flat["patch_emb/conv_w"])
    np.testing.assert_array_equal(model.blocks[0].att.wq.w.detach().numpy(), flat["blocks/0/att/wq/w"].T)
    x = rand(2, 3, 32, 32, seed=4)
    jcfg, tcfg = dict(cfg, dtype=jnp.float32), dict(cfg, dtype=torch.float32)
    with torch.no_grad():
        assert max_err(tv.apply(model, tcfg, T(x)), jv.apply(params, jcfg, J(x))) <= 1e-4
        hidden = tv.apply(model, tcfg, T(x), output_hidden_states=True)
    assert hidden.shape == (2, 17, cfg["emb_dim"])
    assert max_err(hidden, jv.apply(params, jcfg, J(x), output_hidden_states=True)) <= 1e-4


def test_vit_calibrated_scales_match_jax():
    params, model, _ = _models(TINY)
    x = rand(2, 3, 32, 32, seed=4)
    got = tv.calibrate_int8_scales(model, dict(TINY, dtype=torch.float32), T(x))
    ref = jv.calibrate_int8_scales(params, dict(TINY, dtype=jnp.float32), J(x))
    assert len(got) == len(ref) == TINY["n_layers"]
    for g, r in zip(got, ref):
        assert all(abs(a - b) <= 1e-6 * abs(b) for a, b in zip(g, r)), (g, r)


def _jax_mha_packed_interpret(q, k, v, n_heads, *, cfg=None, scale=None, layer_idx=None):
    """JAX's ``mha_packed`` kernel branch (ops/attention.py:306-333) with the
    Pallas kernels in interpret mode."""
    if cfg is not None and cfg.get("int8_scores", False):
        scales = cfg.get("int8_qk_scales")
        if scales is not None:
            scales = tuple(scales[layer_idx or 0]) if isinstance(scales[0], (tuple, list)) else tuple(scales)
        if cfg.get("int8_scores_mode") == "inkernel" and scales is not None:
            return jf.packed_mha_int8_inkernel(q, k, v, n_heads=n_heads, static_scales=scales, scale=scale,
                                               interpret=True)
        return jf.packed_mha_int8(q, k, v, n_heads, scale, True, scales)
    return jf.packed_mha(q, k, v, n_heads, scale, True)


@pytest.mark.parametrize("mode", ["k7", "dynamic", "static", "inkernel"])
@pytest.mark.parametrize("cfg", [TINY, TINY_D32], ids=["d64", "d32"])
def test_vit_kernel_modes_match_jax_interpret(monkeypatch, cfg, mode):
    params, model, _ = _models(cfg)
    x = rand(2, 3, 32, 32, seed=4)
    extra = {}
    if mode != "k7":
        extra["int8_scores"] = True
    if mode in ("static", "inkernel"):
        extra["int8_qk_scales"] = tv.calibrate_int8_scales(model, dict(cfg, dtype=torch.float32), T(x))
    if mode == "inkernel":
        extra["int8_scores_mode"] = "inkernel"
    monkeypatch.setattr(jv, "mha_packed", _jax_mha_packed_interpret)
    ref = jv.apply(params, dict(cfg, dtype=jnp.float32, **extra), J(x))
    counts = kattn.packed_mha.launches, tf.packed_mha_int8.launches, tf.packed_mha_int8_inkernel.launches
    with torch.no_grad():
        got = tv.apply(model, dict(cfg, dtype=torch.float32, **extra), T(x))
    assert max_err(got, ref) <= 1e-4
    # the plain versions ran: nothing launched on the CPU
    assert (kattn.packed_mha.launches, tf.packed_mha_int8.launches, tf.packed_mha_int8_inkernel.launches) == counts


def test_vit_dropout_and_init():
    cfg = dict(TINY, drop_rate=0.1, dtype=torch.float32)
    model = tv.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    x = T(rand(1, 3, 32, 32))
    with torch.no_grad():
        ref = tv.apply(model, cfg, x)
        assert ref.shape == (1, 10)  # deterministic: dropout is the identity
        dropped = tv.apply(model, cfg, x, deterministic=False, generator=torch.Generator().manual_seed(1))
    assert dropped.shape == (1, 10) and not torch.equal(dropped, ref)
    bound = 1.0 / (3 * 8 * 8) ** 0.5
    assert float(model.patch_emb["conv_w"].abs().max()) <= bound
    assert abs(float(model.pos_emb.std()) - 1.0) < 0.1
    w = model.blocks[0].ffn["fc"].w
    assert w.shape == (512, 128) and float(w.abs().max()) <= 128**-0.5
    assert all(p.requires_grad for p in model.parameters())  # trainable; the encode runs under no_grad


@pytest.mark.parametrize("name", ["VIT_BASE_CONFIG", "TINY_VIT_CONFIG"])
def test_vit_flop_counts_match_jax(name):
    cfg = getattr(tconfig, name)
    assert tflops.vit_flops_per_image(cfg) == jflops.vit_flops_per_image(getattr(jconfig, name))
    assert tflops.vit_train_flops_per_image(cfg) == jflops.vit_train_flops_per_image(cfg)


# K7's lse and its lse-fed recompute backward (the kernels' on the card),
# with the helpers of tests/test_torch_attention.py: (b, s, h·d) packed
# inputs, d 32 (TinyViT) and 64 (ViT-B)
K7_SHORT = {"d32": (65, 4, 32), "d64": (197, 2, 64)}


def _heads(x, h):
    return torch.from_numpy(np.asarray(x)).unflatten(-1, (h, -1)).transpose(1, 2)


@pytest.mark.parametrize("name", list(K7_SHORT))
def test_k7_lse_plain_matches_jax_scores(name):
    from tests.test_torch_attention import jax_lse

    s, h, d = K7_SHORT[name]
    q, k = rand(2, s, h * d), rand(2, s, h * d, seed=1)
    got = kattn.packed_mha_lse_plain(T(q), T(k), h)
    assert got.dtype == torch.float32 and got.shape == (2, h, s)
    # JAX's packed kernel scales q in fp32 before the product
    ref = jax_lse(_heads(q * np.float32(d**-0.5), h).numpy(), _heads(k, h).numpy(), 1.0, False)
    assert max_err(got, ref) <= 1e-5


@pytest.mark.parametrize("name", list(K7_SHORT))
def test_k7_lse_recompute_matches_jax_grad(name):
    """The recompute backward fed the plain lse, at K7's packed layout,
    equals jax.grad of JAX's interpret-mode packed_mha (its recompute VJP),
    and its O the kernel's."""
    from tests.test_torch_attention import short_recompute

    s, h, d = K7_SHORT[name]
    q, k, v, do = (rand(2, s, h * d, seed=i) for i in range(4))
    jargs = tuple(map(J, (q, k, v)))
    ref_out = jf.packed_mha(*jargs, h, None, True)
    refs = jax.grad(lambda *a: jnp.sum(jf.packed_mha(*a, h, None, True) * J(do)), argnums=(0, 1, 2))(*jargs)
    lse = kattn.packed_mha_lse_plain(T(q), T(k), h)
    got = short_recompute(*(_heads(x, h) for x in (q, k, v, do)), lse, False, d**-0.5)
    for g, r in zip(got, (ref_out, *refs)):
        assert max_err(g.transpose(1, 2).flatten(2), r) <= 1e-5


@pytest.mark.parametrize("name", list(K7_SHORT))
def test_k7_bf16_operand_rounding_stays_within_the_bf16_bar(name):
    """K7's tensor-core rounding (p to bf16 before p·V, the fp32 p's sum as
    the denominator; p and dS to bf16 in the backward) against the fp32
    plain forward and its autograd on the same bf16-valued inputs: within
    the card's bf16 bar, and not equal."""
    from tests.test_torch_attention import BF16_TOL, short_recompute

    s, h, d = K7_SHORT[name]
    q, k, v, do = (T(rand(2, s, h * d, seed=i)).bfloat16().float() for i in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = kattn.packed_mha(*leaves, h)
    refs = (out.detach(), *torch.autograd.grad(out, leaves, do))
    lse = kattn.packed_mha_lse_plain(q, k, h)
    got = short_recompute(*(t.unflatten(-1, (h, -1)).transpose(1, 2) for t in (q, k, v, do)), lse, False, d**-0.5,
                          round_operands=True, fp32_den=True)
    for g, r in zip(got, refs):
        scale = max(1.0, float(r.abs().max()))
        err = float((g.transpose(1, 2).flatten(2) - r).abs().max())
        assert 0 < err <= BF16_TOL * scale, err
