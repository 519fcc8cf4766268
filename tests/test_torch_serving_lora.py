"""Multi-LoRA serving in the ported engine against the JAX package, on the
CPU in fp32, on the traffic of ``tests/test_serving.py``'s six multi-LoRA
tests (plain, prefix, per-request sampling, int8 base, chunked prefill,
multimodal).

The base weights are the port's ``init`` from a seed, handed to JAX in its
layout (``jax_params``: JAX's eager ``init`` of the VLM alone took 9 s);
JAX builds the stacked adapters over them exactly as those tests do (the
same keys, the same randomized B); ``from_jax_flat`` carries the stacked
tree back.
Each request's greedy tokens must equal JAX's ``generate_kv_cache`` (or
``generate_multimodal``) on JAX's ``merge_adapter(stacked, j)`` of its
adapter (the base for none), exactly; JAX's own engine runs once, on the
plain traffic, and the port's tokens equal its too. The references are built
once per module (``refs``). Also: the refusals against JAX's messages, and
``warmup`` with adapter requests live leaving their adapters and tokens as
they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.models import qwen3_5 as jq35
from llm_quest_tpu.ops import lora as jl
from llm_quest_tpu.ops.quantization import quantize_params_int8 as jquantize
from llm_quest_tpu.weights.interop import flatten_params, unflatten_into
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine, _clone
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_5 as tq35
from llm_quest_tpu_torch.ops import lora as tl
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.weights.interop import from_jax_flat

# tests/test_serving.py's configs
CFG = {
    "model_type": "dense", "vocab_size": 128, "context_length": 64, "emb_dim": 32,
    "n_layers": 2, "n_heads": 4, "num_kv_groups": 2, "head_dim": 8, "hidden_dim": 64,
    "rope_base": 10_000, "tie_embeddings": False,
}
VLM_CFG = {
    "vocab_size": 512, "emb_dim": 64, "hidden_dim": 128, "n_layers": 4, "linear_sdpa_ratio": 2,
    "n_heads": 4, "num_kv_groups": 2, "head_dim": 16, "rope_base": 10_000_000,
    "partial_rope_factor": 0.25, "context_length": 128, "linear_num_qk_heads": 2,
    "linear_num_value_heads": 4, "linear_qk_head_dim": 8, "linear_value_head_dim": 8,
    "linear_conv_kernel_size": 4, "tie_embeddings": True, "mrope_section": [1, 1, 0],
    "vision_n_layers": 2, "vision_emb_dim": 32, "vision_hidden_dim": 64, "vision_num_heads": 2,
    "llm_d_in": 64, "in_channels": 3, "patch_size": 16, "spatial_merge_size": 2,
    "temporal_patch_size": 2, "num_position_embeddings": 256, "img_width": 64, "img_height": 64,
    "vision_rope_base": 10_000, "image_token_id": 500, "p_dropout": 0.0,
}
ATT_FFN = lambda p: "att" in p or "ffn" in p  # noqa: E731
ATT = lambda p: "att" in p  # noqa: E731
BASE = dict(temp=0.0, eos_ids=-1, pad_id=0)


class JaxVLM:
    apply = staticmethod(jq35.apply)
    init_cache = staticmethod(jq35.init_cache)


def jcfg(cfg):
    return dict(cfg, dtype=jnp.float32)


def tcfg(cfg):
    return dict(cfg, dtype=torch.float32)


def port(params, cfg):
    return from_jax_flat({k: np.asarray(v) for k, v in flatten_params(params).items()}, tcfg(cfg), device="cpu")


def jax_params(jmod, tmod, cfg, seed=0):
    """A JAX tree holding the port's seeded ``init`` of the model (each
    linear's weight transposed to JAX's (in, out)), shaped by JAX's
    ``init``."""
    model = tmod.init(tcfg(cfg), generator=torch.Generator().manual_seed(seed), device="cpu")
    flat = {}
    for name, t in model.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        t = t.T if leaf == "w" and isinstance(model.get_submodule(owner), Linear) else t
        flat[name.replace(".", "/")] = t.numpy()
    template = jax.eval_shape(lambda k: jmod.init(k, jcfg(cfg)), jax.random.PRNGKey(0))
    assert set(flatten_params(template)) == set(flat)
    return unflatten_into(template, flat)


def randomize(node, k, size=0.2):
    """tests/test_serving.py's ``randomize``: B drawn N(0, size²) by its size."""
    if isinstance(node, dict):
        if "lora" in node:
            b = node["lora"]["B"]
            noise = size * jax.random.normal(jax.random.fold_in(k, b.size), b.shape)
            return {**node, "lora": {**node["lora"], "B": noise.astype(b.dtype)}}
        return {kk: randomize(v, k, size) for kk, v in node.items()}
    if isinstance(node, list):
        return [randomize(v, k, size) for v in node]
    return node


def two_adapters(params, seed):
    """test_serving_multi_lora's and _with_prefix's two adapters (rank 4, α 8, att and ffn)."""
    key = jax.random.PRNGKey(seed)
    trees = []
    for a in range(2):
        k = jax.random.fold_in(key, a)
        trees.append(randomize(jl.replace_with_lora(k, params, 4, 8, path_filter=ATT_FFN), k))
    return jl.stack_adapters(trees)


def one_adapter(params, seed, alpha=8, path_filter=ATT, size=0.2):
    k = jax.random.PRNGKey(seed)
    return jl.stack_adapters([randomize(jl.replace_with_lora(k, params, 4, alpha, path_filter=path_filter), k, size)])


def jax_tokens(params, ids, max_gen, cfg=CFG, model=jq3):
    out = jgen.generate_kv_cache(model, params, jcfg(cfg), jnp.asarray([ids], jnp.int32), max_gen=max_gen, **BASE)
    return out["sequences"][0, len(ids):].tolist()


def jax_mm_tokens(params, ids, image, max_gen):
    out = jq35.generate_multimodal(params, jcfg(VLM_CFG), jnp.asarray([ids], jnp.int32), jnp.asarray(image[None]),
                                   max_gen=max_gen, **BASE)
    return out["sequences"][0, len(ids):].tolist()


rng = np.random.default_rng(11)
PLAIN = [rng.integers(1, 128, size=n).tolist() for n in (5, 8, 3, 6, 4)]
PLAIN_WHO = [0, 1, None, 1, 0]
PLAIN_GEN = [7, 5, 9, 4, 6]
rng = np.random.default_rng(17)
PREFIX = rng.integers(1, 128, size=6).tolist()
SUFFIXES = [rng.integers(1, 128, size=n).tolist() for n in (3, 5, 2)]
rng = np.random.default_rng(29)
SAMPLED = [rng.integers(1, 128, size=n).tolist() for n in (5, 6)]
rng = np.random.default_rng(53)
INT8 = [rng.integers(1, 128, size=n).tolist() for n in (5, 6)]
rng = np.random.default_rng(59)
LONG = rng.integers(1, 128, size=19).tolist()  # 3 chunks of 8
SHORT = rng.integers(1, 128, size=5).tolist()
N_VIS = (64 // 16) ** 2 // 2**2
rng = np.random.default_rng(71)


def mm_prompt(head, tail):
    return (rng.integers(1, 500, size=head).tolist() + [VLM_CFG["image_token_id"]] * N_VIS
            + rng.integers(1, 500, size=tail).tolist())


MM = [mm_prompt(2, 3), mm_prompt(3, 2)]
MM_IMAGES = [np.asarray(rng.standard_normal((3, 2, 64, 64)), np.float32) for _ in range(2)]
MM_TEXT = rng.integers(1, 500, size=5).tolist()


@pytest.fixture(scope="module")
def trees():
    """The JAX stacked trees of the six tests and their port models."""
    params = jax_params(jq3, tq3, CFG)
    vlm = jax_params(jq35, tq35, VLM_CFG)
    out = {
        "base": params,
        "plain": two_adapters(params, 5),
        "prefix": two_adapters(params, 6),
        "sampling": one_adapter(params, 31),
        "int8": one_adapter(jquantize(params, min_size=0), 51),
        "chunked": one_adapter(params, 61, alpha=16),
        "vlm_base": vlm,
        "vlm": one_adapter(vlm, 67, path_filter=lambda p: "/text/" in p and "att" in p, size=0.3),
    }
    return out, {name: port(tree, VLM_CFG if name.startswith("vlm") else CFG) for name, tree in out.items()}


@pytest.fixture(scope="module")
def refs(trees):
    """JAX's tokens for every request: ``generate_kv_cache`` (or
    ``generate_multimodal``) on the merged adapter, and JAX's engine on the
    plain traffic."""
    t, _ = trees
    base = t["base"]
    merged = {name: [jl.merge_adapter(t[name], j) for j in range(jl.num_adapters(t[name]))]
              for name in ("plain", "prefix", "sampling", "int8", "chunked", "vlm")}
    out = {
        "plain": [jax_tokens(base if a is None else merged["plain"][a], p, g)
                  for p, g, a in zip(PLAIN, PLAIN_GEN, PLAIN_WHO)],
        "prefix": [jax_tokens(merged["prefix"][0], PREFIX + s, 5) for s in SUFFIXES]
        + [jax_tokens(base, PREFIX + SUFFIXES[0], 5)],
        "sampling": jax_tokens(merged["sampling"][0], SAMPLED[0], 6),
        "int8": [jax_tokens(merged["int8"][0], INT8[0], 6), jax_tokens(merged["int8"][1], INT8[1], 5)],
        "chunked": [jax_tokens(merged["chunked"][0], LONG, 12), jax_tokens(base, SHORT, 6),
                    jax_tokens(base, LONG, 12)],
        "vlm": [jax_mm_tokens(merged["vlm"][0], MM[0], MM_IMAGES[0], 6),
                jax_mm_tokens(t["vlm_base"], MM[1], MM_IMAGES[1], 6),
                jax_tokens(t["vlm_base"], MM_TEXT, 6, VLM_CFG, JaxVLM)],
    }
    engine = JaxEngine(jq3, t["plain"], jcfg(CFG), n_slots=2, max_len=48, decode_chunk=3, prefill_buckets=(8,), **BASE)
    out["plain_engine"] = engine.serve([(p, g, None, None, a) for p, g, a in zip(PLAIN, PLAIN_GEN, PLAIN_WHO)])
    return out


def engine(model, cfg=CFG, mod=tq3, **kw):
    args = dict(n_slots=2, max_len=48, decode_chunk=3, prefill_buckets=(8,), **BASE)
    return ContinuousBatchingEngine(mod, model, tcfg(cfg), device="cpu", **{**args, **kw})


def test_plain_traffic_tokens_equal_jax(trees, refs):
    """test_serving_multi_lora: two adapters and the base mixed in a pool of
    2 slots; every request equals its merged adapter's reference and JAX's
    engine."""
    model = trees[1]["plain"]
    assert tl.num_adapters(model) == 3
    got = engine(model).serve([(p, g, None, None, a) for p, g, a in zip(PLAIN, PLAIN_GEN, PLAIN_WHO)])
    assert got == refs["plain"]
    assert got == refs["plain_engine"]


def test_prefix_traffic_tokens_equal_jax(trees, refs):
    """test_serving_multi_lora_with_prefix: a prefix registered through
    adapter 0 and one through the base; the mismatched requests refused as
    JAX refuses them; the stored rows unchanged by the waves."""
    eng = engine(trees[1]["prefix"], decode_chunk=2)
    pid0 = eng.register_prefix(PREFIX, adapter=0)
    pid_b = eng.register_prefix(PREFIX)
    with pytest.raises(ValueError, match="baked into prefix"):
        eng.submit(SUFFIXES[0], 4, prefix=pid0, adapter=1)
    with pytest.raises(ValueError, match="baked into prefix"):
        eng.submit(SUFFIXES[0], 4, prefix=pid0)  # None != 0
    stored = {pid: _clone(eng._prefixes[pid][0]) for pid in (pid0, pid_b)}
    assert not all(torch.equal(stored[pid0][k], stored[pid_b][k]) for k in ("k", "v"))  # the adapter moved K/V
    got = eng.serve([(s, 5, pid0, None, 0) for s in SUFFIXES] + [(SUFFIXES[0], 5, pid_b, None, None)])
    assert got == refs["prefix"]
    for pid, rows in stored.items():
        for name, leaf in rows.items():
            assert torch.equal(eng._prefixes[pid][0][name], leaf) if torch.is_tensor(leaf) else True, name


def test_per_request_sampling_with_adapter_equals_jax(trees, refs):
    """test_serving_per_request_sampling_with_lora: a greedy request on
    adapter 0 beside a stochastic base one."""
    eng = engine(trees[1]["sampling"], decode_chunk=2, temp=0.7, per_request_sampling=True,
                 generator=torch.Generator().manual_seed(0))
    rids = [eng.submit(SAMPLED[0], 6, adapter=0, temp=0.0), eng.submit(SAMPLED[1], 5)]
    while eng.step():
        pass
    assert eng.result(rids[0])[0] == refs["sampling"]
    assert len(eng.result(rids[1])[0]) == 5


def test_int8_base_tokens_equal_jax(trees, refs):
    """test_serving_multi_lora_over_int8_base: adapters over int8 linears
    (``QuantLinear``); the merged references are dense over the dequantized
    base, the null adapter's included."""
    model = trees[1]["int8"]
    wrapped = [name.rsplit(".", 1)[0] for name, _ in tl.lora_modules(model)]
    assert wrapped and all(hasattr(model.get_submodule(n), "w_q") for n in wrapped)
    got = engine(model, decode_chunk=2).serve([(INT8[0], 6, None, None, 0), (INT8[1], 5)])
    assert got == refs["int8"]


def test_chunked_prefill_tokens_equal_jax(trees, refs):
    """test_serving_multi_lora_chunked_prefill: a 19-token prompt through
    adapter 0 admitted in 3 chunks of 8, beside a short base prompt; the
    decode runs through the adapter too (the base's tokens differ)."""
    got = engine(trees[1]["chunked"], max_len=40, prefill_chunk=8).serve([(LONG, 12, None, None, 0), (SHORT, 6)])
    assert got == refs["chunked"][:2]
    assert got[0] != refs["chunked"][2]


def test_multimodal_tokens_equal_jax(trees, refs):
    """test_serving_multimodal_with_lora: an image request through adapter
    0 (text attention wrapped), a base image request and a text-only one in
    one pool."""
    eng = engine(trees[1]["vlm"], VLM_CFG, tq35, prefill_buckets=(16,))
    rids = [eng.submit(MM[0], 6, pixels=MM_IMAGES[0], adapter=0), eng.submit(MM[1], 6, pixels=MM_IMAGES[1]),
            eng.submit(MM_TEXT, 6)]
    while eng.step():
        pass
    assert [eng.result(r)[0] for r in rids] == refs["vlm"]


def test_refusals_match_jax(trees):
    """JAX's checks: an adapter without stacked adapters, one out of range
    (at submit and at register_prefix), prefix + multimodal with adapters."""
    plain = engine(trees[1]["base"])
    for call in (lambda e: e.submit(PLAIN[0], 4, adapter=0), lambda e: e.register_prefix(PREFIX, adapter=0)):
        with pytest.raises(ValueError, match="no stacked adapters"):
            call(plain)
    eng = engine(trees[1]["plain"])
    for bad in (2, -1):
        with pytest.raises(ValueError, match=r"out of range \[0, 2\)"):
            eng.submit(PLAIN[0], 4, adapter=bad)
        with pytest.raises(ValueError, match=r"out of range \[0, 2\)"):
            eng.register_prefix(PREFIX, adapter=bad)
    vlm = engine(trees[1]["vlm"], VLM_CFG, tq35, prefill_buckets=(16,))
    pid = vlm.register_prefix(MM_TEXT)
    with pytest.raises(ValueError, match="prefix\\+multimodal"):
        vlm.submit(MM[0], 4, prefix=pid, pixels=MM_IMAGES[0])
    vlm.submit(MM[0], 4, pixels=MM_IMAGES[0], adapter=0)  # multimodal with an adapter is served


def test_warmup_keeps_live_adapters_and_tokens(trees, refs):
    """``warmup`` while adapter requests are live (its scratch admissions
    take the null adapter into slots 0 and 1) leaves the per-slot adapters
    and the pool as they were, and the tokens equal those without it (JAX's
    warmup leaves its slot adapters changed)."""
    def run(warm):
        eng = engine(trees[1]["plain"])
        rids = [eng.submit(p, g, adapter=a) for p, g, a in zip(PLAIN, PLAIN_GEN, PLAIN_WHO)]
        eng.step()
        if warm:
            before = _clone(eng.state)
            assert before["adapter"].tolist() == [0, 1]
            eng.warmup()
            for name in ("adapter", "mask_buf", "last_logits", "seqpos", "finished", "budget"):
                assert torch.equal(eng.state[name], before[name]), name
        while eng.step():
            pass
        return [eng.result(r)[0] for r in rids]

    got = run(True)
    assert got == run(False) == refs["plain"]
