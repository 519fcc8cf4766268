"""The ported Llama-3.2 and the YaRN RoPE tables against the JAX package, on
the CPU in fp32.

The tiny Llama of ``tests/test_llama_gemma.py`` (2 layers, 4 q / 2 kv heads
of 16, vocabulary 128) is initialised in JAX and loaded into the port with
``from_jax_flat``; both run the same numpy-seeded batches of 24 tokens, JAX
through its flash-attention Pallas kernel in interpret mode (``use_flash``,
``flash_min_seq`` 16). Cases: logits padded and unpadded, with the scaled
tables and the per-head max logits; cached generation against JAX's and
the uncached loop; the loss and every gradient; JAX's train-step test and
two steps against JAX's; the YaRN tables (``ops/rope.py``) within 1e-6 of
JAX's for ``LLAMA32_SMALL_CONFIG`` and Gemma-3's ``scaled=True``, and the
1B config's refusal in both packages; ``from_jax_flat``'s routing of every
family; the int8 tree (tied table included) leaf by leaf. Tolerances:
logits within 1e-4 (the N(0, 1) tied table gives logits near 30); the loss
within 1e-5 relative, gradients within 1e-4 relative to max(1, max |g|);
parameters after 6 steps within 3e-4; tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import gemma3 as jgemma
from llm_quest_tpu.models import gpt2 as jgpt2
from llm_quest_tpu.models import hyper_qwen3 as jhyper
from llm_quest_tpu.models import llama3 as jl
from llm_quest_tpu.models import qwen3 as jqwen3
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.ops import rope as jrope
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import config as tconfig
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.models import gemma3 as tgemma
from llm_quest_tpu_torch.models import gpt2, hyper_qwen3, qwen3
from llm_quest_tpu_torch.models import llama3 as tl
from llm_quest_tpu_torch.ops import quantization as tquant
from llm_quest_tpu_torch.ops import rope as trope
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {
    "vocab_size": 128,
    "context_length": 64,
    "emb_dim": 64,
    "n_heads": 4,
    "n_layers": 2,
    "num_kv_groups": 2,
    "hidden_dim": 128,
    "rope_base": 10_000,
    "flash_min_seq": 16,
    "rope_freq": {"factor": 8.0, "alpha": 1.0, "beta": 4.0, "og_ctx_len": 16, "ctx_len": 64},
}
JCFG = dict(TINY, dtype=jnp.float32, use_flash=True)  # the Pallas kernel, interpret mode
TCFG = dict(TINY, dtype=torch.float32)
B, S = 2, 24


def T(x):
    return torch.from_numpy(np.array(x))


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def arr(x):
    return x.detach().float().numpy().astype(np.float64) if torch.is_tensor(x) else np.asarray(x, np.float64)


def max_err(got, ref):
    return float(np.abs(arr(got) - arr(ref)).max())


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(arr(ref)).max()))


def batch_np(seed, padded=False):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S + 1)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}
    if padded:
        mask = np.ones((B, S), bool)
        mask[1, -7:] = False
        batch["attn_mask"] = mask
        batch["targets"] = np.where(mask, batch["targets"], -100).astype(np.int32)
    return batch


def port_layout(model, name, a):
    owner = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(owner), Linear):
        return np.asarray(a).T
    return np.asarray(a)


@pytest.fixture(scope="module")
def jparams():
    return jl.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture
def model(jparams):
    return from_jax_flat(flat(jparams), TCFG, device="cpu")


# ------------------------------------------------------------------ RoPE tables


def test_configs_match_jax():
    for name in ("LLAMA32_SMALL_CONFIG_1B", "LLAMA32_SMALL_CONFIG"):
        mine, ref = getattr(tconfig, name), getattr(jconfig, name)
        assert {k: v for k, v in mine.items() if k != "dtype"} == {k: v for k, v in ref.items() if k != "dtype"}
        assert str(mine["dtype"]).removeprefix("torch.") == jnp.dtype(ref["dtype"]).name


@pytest.mark.parametrize("ntk_aware", [True, False])
def test_yarn_tables_match_jax(ntk_aware):
    cfg = tconfig.LLAMA32_SMALL_CONFIG
    freq = cfg["rope_freq"]
    assert trope.ntk_aware_base_scaling(10_000, 64, 8192, 4096) == jrope.ntk_aware_base_scaling(10_000, 64, 8192, 4096)
    theta = trope.wavelength_scaling(cfg["rope_base"], 64, freq, ntk_aware)
    assert np.array_equal(theta, np.asarray(jrope.wavelength_scaling(cfg["rope_base"], 64, freq, ntk_aware)))
    cos, sin = trope.compute_angles(cfg["rope_base"], 64, cfg["context_length"], smooth_scaling_cfg=freq,
                                    ntk_aware=ntk_aware)
    jcos, jsin = jrope.compute_angles(cfg["rope_base"], 64, cfg["context_length"], smooth_scaling_cfg=freq,
                                      ntk_aware=ntk_aware)
    assert cos.dtype == torch.float32 and max_err(cos, jcos) <= 1e-6 and max_err(sin, jsin) <= 1e-6
    plain, _ = trope.compute_angles(cfg["rope_base"], 64, cfg["context_length"])
    assert max_err(cos, plain) > 0.1  # the scaling moves the low frequencies


@pytest.mark.parametrize("which", ["llama", "gemma"])
def test_model_rope_tables_scaled_match_jax(which):
    if which == "llama":
        cfg = tconfig.LLAMA32_SMALL_CONFIG
        got, ref = tl.rope_tables(cfg, scaled=True, device="cpu"), jl.rope_tables(jconfig.LLAMA32_SMALL_CONFIG,
                                                                                   scaled=True)
    else:
        cfg = tconfig.GEMMA3_SMALL_CONFIG
        got = tgemma.rope_tables(cfg, scaled=True, device="cpu")
        ref = jgemma.rope_tables(jconfig.GEMMA3_SMALL_CONFIG, scaled=True)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and max_err(g, r) <= 1e-6


def test_1b_rope_freq_refused_in_both_packages():
    """The 1B config's "rope_freq" names "original_context_length": JAX
    raises a bare KeyError, the port a ValueError naming the missing keys
    (ROADMAP Queue 3)."""
    with pytest.raises(KeyError):
        jl.rope_tables(jconfig.LLAMA32_SMALL_CONFIG_1B, scaled=True)
    with pytest.raises(ValueError, match=r"lacks \['og_ctx_len', 'ctx_len'\]"):
        tl.rope_tables(tconfig.LLAMA32_SMALL_CONFIG_1B, scaled=True, device="cpu")
    cos, _ = tl.rope_tables(dict(tconfig.LLAMA32_SMALL_CONFIG_1B, context_length=128), device="cpu")
    assert cos.shape == (128, 64)  # the unscaled tables, which the model uses by default


# ------------------------------------------------------------------ routing


def test_from_jax_flat_routes_every_family():
    small = {"vocab_size": 64, "context_length": 32, "emb_dim": 24, "n_layers": 1, "n_heads": 2,
             "num_kv_groups": 1, "head_dim": 12, "hidden_dim": 48, "rope_base": 10_000, "tie_embeddings": True,
             "dtype": jnp.float32}
    tsmall = dict(small, dtype=torch.float32)
    key = jax.random.PRNGKey(0)
    g_cfg = {"vocab_size": 64, "context_length": 32, "emb_dim": 24, "n_heads": 2, "n_layers": 1, "qkv_bias": False}
    cases = [(flat(jqwen3.init(key, small)), tsmall, qwen3.Qwen3, None),
             (flat(jl.init(key, small)), tsmall, tl.Llama3, None),
             (flat(jgemma.init(key, dict(small, window_size=4, local_global_att_ratio=1))),
              dict(tsmall, window_size=4, local_global_att_ratio=1), tgemma.Gemma3, None),
             (flat(jgpt2.init(key, g_cfg)), g_cfg, gpt2.GPT2, None)]
    for hc_type, n in (("hc", 3), ("mhc", 2), ("mhc-lite", 3)):
        cases.append((flat(jhyper.init(key, small, hc_type=hc_type, expansion_rate=n)), tsmall,
                      hyper_qwen3.HyperQwen3, (hc_type, n)))
    for tree, cfg, cls, hc in cases:
        model = from_jax_flat(tree, cfg, device="cpu")
        assert type(model) is cls
        if hc is not None:
            assert (model.hc_type, model.expansion_rate) == hc


# ------------------------------------------------------------------ forward, generation


def test_weights_tied_named_and_drawn_like_jax(jparams, model):
    assert {n.replace(".", "/") for n, _ in model.named_parameters()} == set(flatten_params(jparams))
    assert "out" not in jparams and not hasattr(model, "out") and model.blocks[0].att.out_proj.b is not None
    fresh = tl.init(dict(TCFG, vocab_size=4096), generator=torch.Generator().manual_seed(0), device="cpu")
    w = fresh.tok_emb["w"].detach()
    assert abs(float(w.mean())) < 0.02 and abs(float(w.std()) - 1.0) < 0.02  # N(0, 1), as JAX draws it
    assert tl.head_dim(TCFG) == jl.head_dim(JCFG) == 16


@pytest.mark.parametrize("padded", [False, True])
def test_apply_matches_jax(jparams, model, padded):
    b = batch_np(0, padded)
    mask = b.get("attn_mask")
    ref, _, jaux = jl.apply(jparams, JCFG, jnp.asarray(b["input_ids"]), collect_max_logits=True,
                            attn_mask=None if mask is None else jnp.asarray(mask))
    got, cache, aux = tl.apply(model, TCFG, T(b["input_ids"]).long(), collect_max_logits=True,
                               attn_mask=None if mask is None else T(mask))
    assert cache is None and max_err(got, ref) <= 1e-4
    assert len(aux["max_attn_logits"]) == TINY["n_layers"]
    for a, r in zip(aux["max_attn_logits"], jaux["max_attn_logits"]):
        assert a.shape == (TINY["n_heads"],) and not a.requires_grad and max_err(a, r) <= 1e-5


def test_scaled_tables_through_apply_match_jax(jparams, model):
    ids = batch_np(1)["input_ids"]
    ref, _, _ = jl.apply(jparams, JCFG, jnp.asarray(ids), rope_cos_sin=jl.rope_tables(JCFG, scaled=True))
    got, _, _ = tl.apply(model, TCFG, T(ids).long(), rope_cos_sin=tl.rope_tables(TCFG, scaled=True, device="cpu"))
    plain, _, _ = tl.apply(model, TCFG, T(ids).long())
    assert max_err(got, ref) <= 1e-4 < max_err(got, plain)


def test_generate_kv_cache_matches_jax_and_the_uncached_loop(jparams, model):
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], (2, 6)).astype(np.int32)
    ref = jgen.generate_kv_cache(jl, jparams, JCFG, jnp.asarray(ids), max_gen=8, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tl, model, TCFG, T(ids).long(), max_gen=8, temp=0.0, eos_ids=-1, pad_id=0)
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(ref["sequences"]))
    uncached = tgen.generate_loop_uncached(tl, model, TCFG, T(ids).long(), max_gen=8)
    assert torch.equal(got["sequences"], uncached)


# ------------------------------------------------------------------ loss, gradients, train step


@pytest.mark.parametrize("padded", [False, True])
def test_loss_and_gradients_match_jax(jparams, model, padded):
    b = batch_np(2, padded)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        logits, _, aux = jl.apply(p, JCFG, jb["input_ids"], attn_mask=jb.get("attn_mask"))
        return jengine.global_loss(logits, jb["targets"], aux)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    loss = tengine.make_loss_fn(tl, TCFG)(model, tengine.as_tensors(b, "cpu"))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = {k.replace("/", "."): v for k, v in flat(ref_grads).items()}
    for (name, _), g in zip(model.named_parameters(), grads):
        assert rel_err(g, port_layout(model, name, ref[name])) <= 1e-4, name


def test_train_step_matches_jax_and_reduces_loss(jparams, model):
    """JAX's ``test_llama_train_step_reduces_loss`` (b 4, s 16, rolled
    targets) on both packages: 6 steps at lr 1e-3, the port with the fused
    head CE, the losses within 1e-5 relative, falling, and the parameters
    within 3e-4 after them."""
    x = np.random.default_rng(3).integers(0, TINY["vocab_size"], (4, 16)).astype(np.int32)
    batch = {"input_ids": x, "targets": np.roll(x, -1, axis=-1)}
    jstep = jengine.make_train_step(jl, JCFG, jengine.make_optimizer(1e-3))
    tstep = tengine.make_train_step(tl, TCFG, tengine.make_optimizer(1e-3), fused_head_ce=True)
    jp = jax.tree.map(jnp.copy, jparams)
    jstate, tstate = jengine.make_optimizer(1e-3).init(jp), tengine.make_optimizer(1e-3).init(model)
    losses = []
    for i in range(6):
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        model, tstate, tloss = tstep(model, tstate, batch)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
        losses.append(float(tloss))
    assert losses[-1] < losses[0]
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert max_err(p, port_layout(model, name, ref[name.replace(".", "/")])) <= 3e-4, name


# ------------------------------------------------------------------ int8


@pytest.mark.parametrize("options", [{}, {"quantize_embeddings": True}], ids=["linears", "tied_table"])
def test_int8_tree_matches_jax_leaf_by_leaf_and_loads(jparams, options):
    jq = jquant.quantize_params_int8(jparams, min_size=0, **options)
    tq = tquant.quantize_params_int8(from_jax_flat(flat(jparams), TCFG, device="cpu"), min_size=0, **options)
    ref, state = flat(jq), tq.state_dict()
    assert set(ref) == {k.replace(".", "/") for k in state}
    for name, a in ref.items():
        got = state[name.replace("/", ".")]
        got = got.T if name.endswith("/w_q") and not name.startswith("tok_emb") else got
        assert np.array_equal(got.numpy(), a), name
    loaded = from_jax_flat(ref, TCFG, device="cpu")
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in state.items())
    if not options:  # fp32 activations through int8 linears: JAX's logits
        ids = batch_np(4)["input_ids"]
        want, _, _ = jl.apply(jq, JCFG, jnp.asarray(ids))
        got, _, _ = tl.apply(loaded, TCFG, T(ids).long())
        assert rel_err(got, want) <= 1e-5
