"""The ported Qwen3-Next cached (serving) path against the JAX package, on
the CPU.

The tiny configuration of ``tests/test_torch_qwen3_next.py`` (4 blocks: three
GatedDeltaNet, one GatedAttention at head dim 16; 4 experts, top-2, a shared
expert) is initialised in JAX and loaded into the port; both run in fp32 on
the same numpy-seeded prompts. Tolerances:

- prefill and decode-step logits within 1e-4 (the bar of the other port
  tests), the cache states (conv taps, recurrent states, k/v) after each step
  within 1e-5 (fp32 sums in another order);
- greedy tokens through ``generate_kv_cache`` identical;
- the same with the int8 tree of ``quantize_params_int8`` (weights and expert
  stacks) and the int8 KV cache: at head dim 16 the router dequantizes in
  both packages; the int8 codes written to the cache must be equal;
- K2 at dk = dv = 64 (Qwen3-Next-small's decode step): the plain version
  against the Pallas kernel in interpret mode within 1e-5, the other layers
  of the stacked state untouched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.kernels.gdn_pallas import gated_delta_rule_step_stacked_pallas
from llm_quest_tpu.models import qwen3_next as jq
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.kernels import gdn as kgdn
from llm_quest_tpu_torch.models import qwen3_next as tq
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {k: v for k, v in jconfig.QWEN3_NEXT_SMALL_CONFIG.items() if k != "dtype"}
TINY.update(
    n_layers=4, emb_dim=64, head_dim=16, n_heads=4, num_kv_groups=2,
    linear_num_qk_heads=2, linear_num_value_heads=4, linear_qk_head_dim=16, linear_value_head_dim=16,
    moe_hidden_dim=96, shared_expert_hidden_dim=96, num_experts=4, top_k=2,
    vocab_size=256, context_length=64, p_dropout=0.0, gradient_checkpointing=False,
)
B, S, GEN = 2, 11, 5
VARIANTS = {"bf16-cache": {}, "int8": {"kv_quant": "int8"}}


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    return float(np.abs(got.detach().float().numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


@pytest.fixture(scope="module")
def trees():
    fp = jq.init(jax.random.PRNGKey(0), dict(TINY, dtype=jnp.float32))
    q8 = jquant.quantize_params_int8(fp, min_size=0)
    return {"bf16-cache": fp, "int8": q8}


def models(trees, variant):
    jparams = trees[variant]
    jcfg = dict(TINY, dtype=jnp.float32, **VARIANTS[variant])
    tcfg = dict(TINY, dtype=torch.float32, **VARIANTS[variant])
    model = from_jax_flat({k: np.asarray(v) for k, v in flatten_params(jparams).items()}, tcfg, device="cpu")
    return jparams, jcfg, model, tcfg


def prompt(seed):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_cache_matches_jax(trees, variant):
    _, jcfg, _, tcfg = models(trees, variant)
    jc, tc = jq.init_cache(jcfg, B, 20), tq.init_cache(tcfg, B, 20, device="cpu")
    assert set(tc) == set(jc)
    for name, t in tc.items():
        if name == "pos":
            assert t == int(jc[name]) == 0
            continue
        assert tuple(t.shape) == jc[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == str(jc[name].dtype), name
        assert not t.any()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_steps_match_jax(trees, variant):
    """Right-padded prefill (row 1 has 3 pads) into a cache of S + 4, then
    decode steps; logits and every cache state compared after each call."""
    jparams, jcfg, model, tcfg = models(trees, variant)
    ids = prompt(1)
    max_len = S + 4
    mask = np.zeros((B, max_len), bool)
    mask[:, :S] = True
    mask[1, S - 3:S] = False
    jc, tc = jq.init_cache(jcfg, B, max_len), tq.init_cache(tcfg, B, max_len, device="cpu")
    jl, jc, _ = jq.apply(jparams, jcfg, jnp.asarray(ids), attn_mask=jnp.asarray(mask), cache=jc)
    with torch.no_grad():
        tl, tc, _ = tq.apply(model, tcfg, T(ids).long(), attn_mask=T(mask), cache=tc)
    steps = [(jl, tl)]
    pos = np.asarray([[S], [S - 3]])
    for i in range(3):
        tok = np.asarray(jnp.argmax(steps[-1][0][:, -1], -1), np.int32)[:, None]
        mask[:, S + i] = True
        jl, jc, _ = jq.apply(jparams, jcfg, jnp.asarray(tok), attn_mask=jnp.asarray(mask), cache=jc,
                             position_ids=jnp.asarray(pos + i))
        with torch.no_grad():
            tl, tc, _ = tq.apply(model, tcfg, T(tok).long(), attn_mask=T(mask), cache=tc,
                                 position_ids=T(pos + i).long())
        steps.append((jl, tl))
        assert tc["pos"] == int(jc["pos"]) == S + i + 1
        for name in tc:
            if name == "pos":
                continue
            if tc[name].dtype == torch.int8:
                # int8 KV codes: a k/v within 1e-5 of JAX's could round to the
                # neighbouring code at a tie; none does at these inputs
                assert np.array_equal(tc[name].numpy(), np.asarray(jc[name])), name
            else:
                assert max_err(tc[name], jc[name]) <= 1e-5, (name, i)
    for jl, tl in steps:
        assert max_err(tl, jl) <= 1e-4


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_generate_kv_cache_tokens_match_jax(trees, variant):
    jparams, jcfg, model, tcfg = models(trees, variant)
    ids = prompt(2)
    ref = jgen.generate_kv_cache(jq, jparams, jcfg, jnp.asarray(ids), max_gen=GEN, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq, model, tcfg, T(ids).long(), max_gen=GEN, eos_ids=-1, pad_id=0)
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()


def test_cached_prefill_continues_like_one_prefill(trees):
    """Two cached prefills (6 then 5 tokens, the second seeded from the first's
    conv taps and recurrent state) give the last logits of one 11-token
    prefill."""
    _, _, model, tcfg = models(trees, "bf16-cache")
    ids = T(prompt(3)).long()
    with torch.no_grad():
        one, _, _ = tq.apply(model, tcfg, ids, cache=tq.init_cache(tcfg, B, S, device="cpu"))
        cache = tq.init_cache(tcfg, B, S, device="cpu")
        _, cache, _ = tq.apply(model, tcfg, ids[:, :6], cache=cache)
        two, _, _ = tq.apply(model, tcfg, ids[:, 6:], cache=cache)
    assert max_err(two[:, -1], one[:, -1].numpy()) <= 1e-4


@pytest.mark.parametrize("b", [1, 3])
def test_k2_dk64_plain_matches_pallas(b):
    rng = np.random.default_rng(b)
    h, d, layers, layer = 8, 64, 6, 4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, h, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rng.standard_normal((b, h, d)).astype(np.float32)
    beta = rng.uniform(0.1, 0.9, (b, h)).astype(np.float32)
    alpha = rng.uniform(0.5, 1.0, (b, h)).astype(np.float32)
    stacked = (0.1 * rng.standard_normal((layers, b, h, d, d))).astype(np.float32)
    ref_out, ref_st = gated_delta_rule_step_stacked_pallas(
        *map(jnp.asarray, (q, k, v, beta, alpha, stacked)), layer, interpret=True
    )
    st = T(stacked)
    out, st = kgdn.gated_delta_rule_step_stacked(*map(T, (q, k, v, beta, alpha)), st, layer)
    assert max_err(out, ref_out) <= 1e-5
    assert max_err(st, ref_st) <= 1e-5
    others = [i for i in range(layers) if i != layer]
    assert torch.equal(st[others], T(stacked)[others])
