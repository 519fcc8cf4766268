"""The ported serving engine on the MoE families against the JAX package, on
the CPU in fp32.

``tests/test_serving.py::test_serving_qwen3_next_and_moe``'s traffic (three
prompts of 4, 9 and 6 tokens, 5 greedy tokens each, 2 slots, bucket 16,
chunk 3: slot reuse through retire and refill) on its two models, Qwen3-Next
(the GDN/attention hybrid with separate q/k/v conv states) and a Qwen3-MoE,
each initialised in JAX and loaded into the port. Every request's tokens must
equal JAX's ``generate_kv_cache`` for its prompt alone and JAX's
``ContinuousBatchingEngine`` on the same traffic. Variants: the fp32 trees;
the trees of JAX's ``quantize_params_int8`` (every linear and expert stack)
with the int8 KV cache; and for the Qwen3-MoE also head dim 128, where both
packages stream the int8 cache through K10 (the plain version here, spied;
the Pallas kernel in interpret mode in JAX). The int8 expert stacks take
K11's plain version here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.models import qwen3_next as jqn
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
from llm_quest_tpu_torch.kernels import flash_decode as kfd
from llm_quest_tpu_torch.kernels import quantized_gmm as kqg
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_next as tqn
from llm_quest_tpu_torch.weights.interop import from_jax_flat

# tests/test_serving.py::test_serving_qwen3_next_and_moe's configs
NEXT_CFG = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 32,
    "n_layers": 2, "linear_sdpa_ratio": 2, "n_heads": 4, "head_dim": 8,
    "num_kv_groups": 2, "partial_rope_factor": 0.25, "rope_base": 10_000,
    "linear_num_qk_heads": 2, "linear_num_value_heads": 4,
    "linear_qk_head_dim": 8, "linear_value_head_dim": 8,
    "linear_conv_kernel_size": 4, "moe_hidden_dim": 64,
    "shared_expert_hidden_dim": 64, "num_experts": 4, "top_k": 2,
    "aux_loss_coef": 0.001, "tie_embeddings": False, "p_dropout": 0.0,
    "gdn_chunk_size": 16,
}
MOE_CFG = {
    "model_type": "moe", "vocab_size": 128, "context_length": 64,
    "emb_dim": 32, "n_layers": 2, "n_heads": 4, "num_kv_groups": 2,
    "head_dim": 8, "moe_hidden_dim": 64, "num_experts": 4, "top_k": 2,
    "aux_loss_coef": 0.001, "rope_base": 10_000, "tie_embeddings": False,
}
# (JAX module, port module, cfg, JAX init seed, int8 tree and KV cache)
VARIANTS = {
    "next": (jqn, tqn, NEXT_CFG, 1, False),
    "next_int8": (jqn, tqn, dict(NEXT_CFG, kv_quant="int8"), 1, True),
    "moe": (jq3, tq3, MOE_CFG, 2, False),
    "moe_int8": (jq3, tq3, dict(MOE_CFG, kv_quant="int8"), 2, True),
    "moe_int8_d128": (jq3, tq3, dict(MOE_CFG, head_dim=128, kv_quant="int8"), 2, True),
}
_rng = np.random.default_rng(7)
PROMPTS = [_rng.integers(1, 128, size=n).tolist() for n in (4, 9, 6)]
GEN = 5
ENGINE_KW = dict(n_slots=2, max_len=32, decode_chunk=3, prefill_buckets=(16,), temp=0.0, eos_ids=-1, pad_id=0)


@pytest.fixture(scope="module", params=list(VARIANTS))
def runs(request):
    """One variant's tokens: JAX's generate_kv_cache a prompt, JAX's engine,
    the port's engine (with the kernel wrappers it called)."""
    jmod, tmod, cfg, seed, int8 = VARIANTS[request.param]
    jcfg, tcfg = dict(cfg, dtype=jnp.float32), dict(cfg, dtype=torch.float32)
    jparams = jmod.init(jax.random.PRNGKey(seed), jcfg)
    if int8:
        jparams = jquant.quantize_params_int8(jparams, min_size=0)
    model = from_jax_flat({k: np.asarray(v) for k, v in flatten_params(jparams).items()}, tcfg, device="cpu")
    refs = [jgen.generate_kv_cache(jmod, jparams, jcfg, jnp.asarray([ids], jnp.int32), max_gen=GEN, temp=0.0,
                                   eos_ids=-1, pad_id=0)["sequences"][0, len(ids):].tolist() for ids in PROMPTS]
    jax_engine = JaxEngine(jmod, jparams, jcfg, **ENGINE_KW).serve([(ids, GEN) for ids in PROMPTS])
    calls = {"flash_decode": 0, "quantized_ragged_dot": 0}
    wrapped = {}
    for mod, name in ((kfd, "flash_decode"), (kqg, "quantized_ragged_dot")):
        real = getattr(mod, name)
        wrapped[mod, name] = real

        def spy(*a, real=real, name=name, **k):
            calls[name] += 1
            return real(*a, **k)

        setattr(mod, name, spy)
    try:
        engine = ContinuousBatchingEngine(tmod, model, tcfg, device="cpu", **ENGINE_KW)
        port = engine.serve([(ids, GEN) for ids in PROMPTS])
    finally:
        for (mod, name), real in wrapped.items():
            setattr(mod, name, real)
    return {"name": request.param, "refs": refs, "jax_engine": jax_engine, "port": port, "calls": calls,
            "stats": engine.stats(), "cache": engine.state["cache"]}


def test_engine_tokens_equal_jax_generate_kv_cache(runs):
    assert runs["port"] == runs["refs"], runs["name"]
    assert all(len(t) == GEN for t in runs["port"])


def test_engine_tokens_equal_jax_engine(runs):
    assert runs["port"] == runs["jax_engine"], runs["name"]


def test_engine_kernels_and_pool(runs):
    """The int8 variants run their expert stacks through K11 (both
    families), and only the head-dim-128 one decodes through K10; the pool
    holds the int8 cache there, and the traffic reused a slot."""
    name, calls = runs["name"], runs["calls"]
    assert (calls["quantized_ragged_dot"] > 0) == ("int8" in name)
    assert (calls["flash_decode"] > 0) == name.endswith("d128")
    assert ("k_q" in runs["cache"]) == ("int8" in name)
    assert runs["stats"]["admit_waves"] >= 2 and runs["stats"]["requests_completed"] == len(PROMPTS)
