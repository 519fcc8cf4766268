"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both functions;
everything is fp32 and must agree within 1e-5 (both sides compute the same
formula in fp32; only the summation order differs).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import cache as jcache
from llm_quest_tpu.ops import activations as jact
from llm_quest_tpu.ops import attention as jattn
from llm_quest_tpu.ops import gdn as jgdn
from llm_quest_tpu.ops import masks as jmasks
from llm_quest_tpu.ops import mlp as jmlp
from llm_quest_tpu.ops import norms as jnorms
from llm_quest_tpu.ops import rope as jrope
from llm_quest_tpu.ops import sampling as jsamp
from llm_quest_tpu_torch.inference import cache as tcache
from llm_quest_tpu_torch.ops import activations as tact
from llm_quest_tpu_torch.ops import attention as tattn
from llm_quest_tpu_torch.ops import gdn as tgdn
from llm_quest_tpu_torch.ops import masks as tmasks
from llm_quest_tpu_torch.ops import mlp as tmlp
from llm_quest_tpu_torch.ops import norms as tnorms
from llm_quest_tpu_torch.ops import rope as trope
from llm_quest_tpu_torch.ops import sampling as tsamp

TOL = 1e-5


def rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got.astype(np.float64) - ref.astype(np.float64)).max()) if got.size else 0.0
    assert err <= tol, err


def T(x):
    return torch.from_numpy(np.array(x))  # a writable copy of a numpy or JAX array


J = jnp.asarray


@pytest.mark.parametrize("name", ["silu", "gelu_tanh", "gelu_erf"])
def test_activations(name):
    x = rand(4, 33) * 3
    close(getattr(tact, name)(T(x)), getattr(jact, name)(J(x)))


def test_norms():
    x, scale, shift = rand(3, 5, 24), rand(24, seed=1), rand(24, seed=2)
    close(tnorms.layer_norm_torch(T(x), T(scale), T(shift)),
          jnorms.layer_norm_torch({"scale": J(scale), "shift": J(shift)}, J(x)))
    close(tnorms.rms_norm_torch_parity(T(x), T(scale)), jnorms.rms_norm_torch_parity({"scale": J(scale)}, J(x)))
    close(tnorms.zero_centered_rms_norm(T(x), T(scale)), jnorms.zero_centered_rms_norm({"scale": J(scale)}, J(x)))


def test_gemma_norms_and_softcap():
    """The GPT-2 LayerNorm (eps outside the sqrt), the Llama RMSNorm (fp32
    mean-square, scale after the cast back) and the softcap."""
    x, scale, shift = rand(3, 5, 24) * 4, rand(24, seed=1), rand(24, seed=2)
    close(tnorms.layer_norm(T(x), T(scale), T(shift)), jnorms.layer_norm({"scale": J(scale), "shift": J(shift)}, J(x)))
    close(tnorms.rms_norm(T(x), T(scale)), jnorms.rms_norm({"scale": J(scale)}, J(x)))
    close(tact.softcap(T(x), 5.0), jact.softcap(J(x), 5.0))
    # the cast order in bf16: the normed value is rounded before the scale multiplies it
    xb = T(x).bfloat16()
    assert torch.equal(tnorms.rms_norm(xb, T(scale).bfloat16()),
                       (T(scale).bfloat16() * (xb.float() / (xb.float().square().mean(-1, keepdim=True).sqrt() + 1e-6))
                        .bfloat16()))


def test_rope_tables():
    for got, ref in zip(trope.compute_angles(10_000_000, 256, 64, rotation_factor=0.25),
                        jrope.compute_angles(10_000_000, 256, 64, rotation_factor=0.25)):
        close(got, ref)
    for got, ref in zip(trope.compute_angles_2d(10_000, 64, 6, 5), jrope.compute_angles_2d(10_000, 64, 6, 5)):
        close(got, ref)


def test_apply_packed():
    cos, sin = jrope.compute_angles_2d(10_000, 16, 3, 4)
    x = rand(2, 12, 3, 16)
    close(trope.apply_packed(T(x), T(cos), T(sin)), jrope.apply_packed(J(x), cos, sin))


@pytest.mark.parametrize("section", [[11, 11, 10], [1, 1, 0]])
def test_mrope(section):
    head_dim = 4 * 2 * sum(section)  # rotation dim = head_dim * 0.25 = 2 * sum(section)
    cos, sin = jrope.compute_angles(10_000_000, head_dim, 40, rotation_factor=0.25)
    x = rand(2, 3, 7, head_dim)
    pos = np.random.default_rng(3).integers(0, 40, (3, 2, 7))
    half = cos.shape[-1] // 2
    cos3, sin3 = np.asarray(cos)[:, :half][pos], np.asarray(sin)[:, :half][pos]
    for got, ref in zip(trope.interleave_mrope_coeffs(T(cos3), T(sin3), section),
                        jrope.interleave_mrope_coeffs(J(cos3), J(sin3), section)):
        close(got, ref)
    close(trope.apply_mrope(T(x), T(cos), T(sin), T(pos), section),
          jrope.apply_mrope(J(x), cos, sin, J(pos), section))


@pytest.mark.parametrize("q_len,k_len,q_start,with_mask", [(5, None, 0, False), (4, 12, 3, True), (1, 9, 8, True)])
def test_causal_mask(q_len, k_len, q_start, with_mask):
    pad = np.random.default_rng(0).random((2, k_len or q_len)) > 0.3 if with_mask else None
    got = tmasks.causal_mask(q_len, k_len, q_start=q_start, attn_mask=None if pad is None else T(pad))
    ref = jmasks.causal_mask(q_len, k_len, q_start=q_start, attn_mask=None if pad is None else J(pad))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_alpha_and_l2_norm():
    log_a, a, dt = rand(6), rand(2, 5, 6, seed=1), rand(6, seed=2)
    close(tgdn.compute_alpha_factor(T(log_a), T(a), T(dt)), jgdn.compute_alpha_factor(J(log_a), J(a), J(dt)))
    x = rand(2, 3, 5, 8, seed=3)
    x[0, 0, 0] = 0.0  # the clamp branch
    close(tgdn.l2_norm_clamp(T(x)), jgdn.l2_norm_clamp(J(x)))


@pytest.mark.parametrize("s", [1, 2, 7])
def test_conv1d_family(s):
    w, x, st = rand(10, 4), rand(2, s, 10, seed=1), rand(2, 3, 10, seed=2)
    jw = {"w": J(w)}
    close(tgdn.causal_conv1d(T(w), T(x)), jgdn.causal_conv1d(jw, J(x)))
    (out, ext), (jout, jext) = tgdn.causal_conv1d_seeded(T(w), T(x), T(st)), jgdn.causal_conv1d_seeded(jw, J(x), J(st))
    close(out, jout)
    close(ext, jext)
    out, new = tgdn.causal_conv1d_update(T(w), T(x[:, 0]), T(st))
    jout, jnew = jgdn.causal_conv1d_update(jw, J(x[:, 0]), J(st))
    close(out, jout)
    close(new, jnew)
    close(tgdn.conv_state_from_prefill(T(x), 4), jgdn.conv_state_from_prefill(J(x), 4))
    # mask: a right-padded row, an all-real row; seeded prefills reach back into the taps
    mask = np.ones((2, s), bool)
    mask[0, s // 2 + 1:] = False
    close(tgdn.conv_state_from_prefill(T(x), 4, mask=T(mask)), jgdn.conv_state_from_prefill(J(x), 4, mask=J(mask)))
    ext_mask = np.concatenate([np.ones((2, 3), bool), mask], axis=1)
    close(tgdn.conv_state_from_prefill(ext, 4, mask=T(ext_mask)),
          jgdn.conv_state_from_prefill(jext, 4, mask=J(ext_mask)))


def test_freeze_masked_updates():
    beta, alpha = rand(2, 3, 5), rand(2, 3, 5, seed=1)
    mask = np.random.default_rng(2).random((2, 5)) > 0.4
    for got, ref in zip(tgdn.freeze_masked_updates(T(beta), T(alpha), T(mask)),
                        jgdn.freeze_masked_updates(J(beta), J(alpha), J(mask))):
        close(got, ref)


@pytest.mark.parametrize("hq,hkv,masked", [(4, 4, False), (8, 2, True)])
def test_sdpa_and_router(hq, hkv, masked):
    q, k, v = rand(2, hq, 6, 16), rand(2, hkv, 10, 16, seed=1), rand(2, hkv, 10, 16, seed=2)
    pad = np.random.default_rng(3).random((2, 10)) > 0.3
    pad[:, 0] = True
    mask = jmasks.causal_mask(6, 10, q_start=4, attn_mask=J(pad)) if masked else None
    ref = jattn.sdpa(J(q), J(k), J(v), mask=mask)
    close(tattn.sdpa(T(q), T(k), T(v), mask=None if mask is None else T(mask)), ref)
    # the router without a dense mask builds the causal one (q at the end of the keys)
    ref = jattn.attention(J(q), J(k), J(v), cfg={}, causal=True)
    close(tattn.attention(T(q), T(k), T(v), cfg={}, causal=True), ref)


def test_split_merge_heads():
    x = rand(2, 5, 12)
    close(tattn.split_heads(T(x), 3), jattn.split_heads(J(x), 3))
    close(tattn.merge_heads(tattn.split_heads(T(x), 3)), x)


@pytest.mark.parametrize("kw", [
    {"top_k": 5}, {"top_p": 0.6}, {"top_p": 0.6, "top_k": 8}, {"min_p": 0.2}, {"min_p": 0.2, "top_k": 3}, {},
])
def test_sampling_filters(kw):
    logits = rand(3, 64) * 2
    probs = np.asarray(jnp.exp(logits) / jnp.exp(logits).sum(-1, keepdims=True))
    close(tsamp.filter_probs(T(probs), **kw), jsamp.filter_probs(J(probs), **kw))


def test_sampling_greedy_and_stochastic():
    logits = rand(4, 50)
    got = tsamp.sampling(None, T(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsamp.sampling(None, J(logits))))
    gen = torch.Generator().manual_seed(0)
    drawn = tsamp.sampling(gen, T(logits), top_k=3, temp=0.7)
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    assert all(int(t) in row for t, row in zip(drawn, top3))


def test_kv_cache_write_and_slices():
    cache = tcache.init_kv_cache(2, 2, 3, 8, 4)
    jc = jcache.init_kv_cache(2, 2, 3, 8, 4)
    new_k, new_v = rand(2, 3, 3, 4), rand(2, 3, 3, 4, seed=1)
    cache, kc, vc = tcache.write_layer(cache, 1, T(new_k), T(new_v), 2)
    jc, jkc, jvc = jcache.write_layer(jc, 1, J(new_k), J(new_v), 2)
    close(kc, jkc)
    close(vc, jvc)
    close(cache["k"], jc["k"])
    assert tcache.max_len(cache) == jcache.max_len(jc) == 8
    mask = np.random.default_rng(0).random((2, 8)) > 0.5
    got, ref = tcache.cur_token_mask(T(mask), 3, 2), jcache.cur_token_mask(J(mask), 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_port_imports_no_jax():
    """Every module of the port imports without jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import llm_quest_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m in ('jax', 'llm_quest_tpu') or m.startswith(('jax.', 'llm_quest_tpu.')))\n"
        "assert len(mods) >= 15, mods\n"
        "assert {'llm_quest_tpu_torch.models.vit', 'llm_quest_tpu_torch.kernels.fused_mha'} <= set(mods), mods\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_config_matches_jax():
    from llm_quest_tpu import config as jconfig
    from llm_quest_tpu_torch import config as tconfig

    for name in ("QWEN3_5_08B_CONFIG", "VIT_BASE_CONFIG", "TINY_VIT_CONFIG"):
        jax_cfg, torch_cfg = getattr(jconfig, name), getattr(tconfig, name)
        assert set(torch_cfg) == set(jax_cfg), name
        for key, value in jax_cfg.items():
            if key == "dtype":
                assert str(torch_cfg[key]).removeprefix("torch.") == jnp.dtype(value).name
            else:
                assert torch_cfg[key] == value, (name, key)
    # a config without a dtype (the ViTs, as in JAX) runs in fp32
    assert tconfig.model_dtype(tconfig.VIT_BASE_CONFIG) == torch.float32


@pytest.mark.parametrize("tanh_approx", [False, True])
def test_mlp_gelu_matches_jax(tanh_approx):
    import jax

    params = jmlp.init_mlp_gelu(jax.random.PRNGKey(0), 32, 64, bias=True)
    ffn = tmlp.init_mlp_gelu(32, 64, bias=True, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name in ("fc", "proj"):
            ffn[name].w.copy_(T(params[name]["w"]).T)
            ffn[name].b.copy_(T(params[name]["b"]))
    x = rand(3, 5, 32)
    close(tmlp.mlp_gelu(ffn, T(x), tanh_approx=tanh_approx),
          jmlp.mlp_gelu(params, jnp.asarray(x), tanh_approx=tanh_approx))
