"""The ported serving engine on Gemma-3, DeepSeek-V3 and MiMo-V2-Flash, and
MiMo-V2-Flash's cached generation, against the JAX package, on the CPU in
fp32.

``tests/test_serving.py::test_serving_every_model_family``'s tiny configs
(``_GEMMA_TINY``: window 8, every layer SWA and global in turn;
``_DSV3_TINY``: MLA with q/k 18 and v 12 in one cache; ``_MIMO_TINY``: SWA
with sinks and GA layers with 4 and 2 kv groups in one cache padded to 4,
head dim 12, value head dim 8) and its traffic (five prompts of 3 to 12
tokens, budgets 4 to 11, 2 slots, buckets 8 and 16, chunk 3), each model
initialised in JAX and loaded into the port: every request's greedy tokens
equal JAX's ``generate_kv_cache`` for its prompt alone.

MiMo-V2-Flash's cache on its own: ``init_cache`` against JAX's (shapes and
dtypes), a right-padded cached prefill and three decode steps at per-row
positions with logits within 1e-4 and the cache leaves within 1e-5 of JAX's
(the GA layers' rows past their 2 kv groups stay zero in both), and the
cached prefill against the uncached forward (the same logits within 1e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import mimo_v2_flash as jmimo
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
from llm_quest_tpu_torch.models import mimo_v2_flash as tmimo
from llm_quest_tpu_torch.weights.interop import from_jax_flat

# tests/test_serving.py's configs
_LLAMA_TINY = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 64, "n_heads": 4,
    "n_layers": 2, "num_kv_groups": 2, "hidden_dim": 128, "rope_base": 10_000,
}
_GEMMA_TINY = {**_LLAMA_TINY, "window_size": 8, "local_global_att_ratio": 1}
_DSV3_TINY = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 48, "n_heads": 4,
    "n_layers": 4, "hidden_dim": 96, "num_ffn": 2, "num_experts": 4,
    "num_shared_experts": 1, "top_k": 1, "moe_scaling_factor": 1,
    "moe_bias_update_rate": 1e-3, "mtp_depth": 2, "mtp_loss_coeff": 0.2,
    "rope_base": 10_000, "q_rank": 64,
}
_MIMO_TINY = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 32, "n_layers": 6,
    "n_heads": 4, "num_swa_kv_groups": 4, "num_ga_kv_groups": 2, "head_dim": 12,
    "value_head_dim": 8, "hidden_dim": 64, "window_size": 4, "hybrid_ratio": 3,
    "rope_base": 10_000, "rope_base_ga": 640_000, "partial_rope_factor": 0.33,
    "mtp_depth": 2, "mtp_loss_coeff": 0.3, "num_experts": 4, "top_k": 2,
    "num_shared_experts": 0, "moe_scaling_factor": 1,
    "moe_bias_update_rate": 1e-3,
}
FAMILIES = {"gemma3": _GEMMA_TINY, "deepseek_v3": _DSV3_TINY, "mimo_v2_flash": _MIMO_TINY}
_rng = np.random.default_rng(3)
PROMPTS = [_rng.integers(1, 128, size=n).tolist() for n in (5, 9, 3, 12, 7)]
GENS = [8, 5, 11, 4, 9]


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    return float(np.abs(got.detach().float().numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


def load(family, cfg, seed=0):
    jmod = importlib.import_module(f"llm_quest_tpu.models.{family}")
    jparams = jmod.init(jax.random.PRNGKey(seed), dict(cfg, dtype=jnp.float32))
    model = from_jax_flat({k: np.asarray(v) for k, v in flatten_params(jparams).items()},
                          dict(cfg, dtype=torch.float32), device="cpu")
    return jmod, jparams, model


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_tokens_equal_jax_generate_kv_cache(family):
    cfg = FAMILIES[family]
    jmod, jparams, model = load(family, cfg)
    tmod = importlib.import_module(f"llm_quest_tpu_torch.models.{family}")
    engine = ContinuousBatchingEngine(
        tmod, model, dict(cfg, dtype=torch.float32), n_slots=2, max_len=48, decode_chunk=3,
        prefill_buckets=(8, 16), temp=0.0, eos_ids=-1, pad_id=0, device="cpu",
    )
    outs = engine.serve(list(zip(PROMPTS, GENS)))
    for ids, n, got in zip(PROMPTS, GENS, outs):
        ref = jgen.generate_kv_cache(
            jmod, jparams, dict(cfg, dtype=jnp.float32), jnp.asarray([ids], jnp.int32),
            max_gen=n, temp=0.0, eos_ids=-1, pad_id=0,
        )["sequences"][0, len(ids):].tolist()
        assert got == ref, (family, ids, got, ref)
    assert engine.stats()["admit_waves"] >= 3  # five requests through two slots


# ------------------------------------------------------------------ MiMo-V2-Flash's cache


@pytest.fixture(scope="module")
def mimo():
    return load("mimo_v2_flash", _MIMO_TINY, seed=1)


JCFG, TCFG = dict(_MIMO_TINY, dtype=jnp.float32), dict(_MIMO_TINY, dtype=torch.float32)
B, S = 2, 10
# JAX's cached calls, jitted once (a prefill, then one program for every decode step)
_jprefill = jax.jit(lambda p, x, m, c: jmimo.apply(p, JCFG, x, attn_mask=m, cache=c))
_jstep = jax.jit(lambda p, x, m, c, pos: jmimo.apply(p, JCFG, x, attn_mask=m, cache=c, position_ids=pos))


def test_mimo_init_cache_matches_jax():
    jc, tc = jmimo.init_cache(JCFG, B, 16), tmimo.init_cache(TCFG, B, 16, device="cpu")
    assert set(tc) == set(jc) and tc["pos"] == int(jc["pos"]) == 0
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape and tc[name].dtype == torch.float32 and not tc[name].any()
    assert tc["k"].shape[2] == 4 and tc["k"].shape[-1] == 12 and tc["v"].shape[-1] == 8


def test_mimo_cached_prefill_and_decode_match_jax(mimo):
    _, jparams, model = mimo
    ids = np.random.default_rng(4).integers(1, 128, (B, S)).astype(np.int32)
    max_len = S + 4
    mask = np.zeros((B, max_len), bool)
    mask[:, :S] = True
    mask[1, S - 3:S] = False
    jc, tc = jmimo.init_cache(JCFG, B, max_len), tmimo.init_cache(TCFG, B, max_len, device="cpu")
    jl, jc, _ = _jprefill(jparams, jnp.asarray(ids), jnp.asarray(mask), jc)
    with torch.no_grad():
        tl, tc, _ = tmimo.apply(model, TCFG, T(ids).long(), attn_mask=T(mask), cache=tc)
    steps = [(jl, tl)]
    pos = np.asarray([[S], [S - 3]])
    for i in range(3):
        tok = np.asarray(jnp.argmax(steps[-1][0][:, -1], -1), np.int32)[:, None]
        mask[:, S + i] = True
        jl, jc, _ = _jstep(jparams, jnp.asarray(tok), jnp.asarray(mask), jc, jnp.asarray(pos + i))
        with torch.no_grad():
            tl, tc, _ = tmimo.apply(model, TCFG, T(tok).long(), attn_mask=T(mask), cache=tc,
                                    position_ids=T(pos + i).long())
        steps.append((jl, tl))
        assert tc["pos"] == int(jc["pos"]) == S + i + 1
        for name in ("k", "v"):
            assert max_err(tc[name], jc[name]) <= 1e-5, (name, i)
    for jl, tl in steps:
        assert max_err(tl, jl) <= 1e-4
    ga = [i for i in range(_MIMO_TINY["n_layers"]) if not tmimo.is_swa_layer(_MIMO_TINY, i)]
    assert not tc["k"][ga, :, _MIMO_TINY["num_ga_kv_groups"]:].any()  # the GA layers' padding rows


def test_mimo_cached_prefill_equals_uncached_forward(mimo):
    _, _, model = mimo
    ids = T(np.random.default_rng(5).integers(1, 128, (B, S))).long()
    with torch.no_grad():
        ref, none, _ = tmimo.apply(model, TCFG, ids)
        got, cache, _ = tmimo.apply(model, TCFG, ids, cache=tmimo.init_cache(TCFG, B, S + 6, device="cpu"))
    assert none is None and cache["pos"] == S
    assert max_err(got, ref.numpy()) <= 1e-5

