"""Speculative serving in the ported engine against the JAX package, on the
CPU in fp32, on the traffic of ``tests/test_serving.py``'s seven speculative
tests: lossless with EOS retirement (:583), the self-draft (:618), the
stochastic properties (:673), prefix (:702), multi-LoRA with and without a
prefix (:1348), chunked prefill (:1408) and per-request sampling (:1429).

The target is that file's dense Qwen3 ``CFG`` and the draft its weak 1-layer
``dict(CFG, n_layers=1, emb_dim=16, hidden_dim=32, head_dim=4)``, both
initialised in JAX and carried over by ``from_jax_flat`` (the stacked
adapters too, built in JAX as :1348 builds them). Greedy speculation is
lossless, so every request's tokens must equal JAX's plain greedy tokens
for its prompt alone (``generate_batched_kv_cache`` over all the prompts at
once: one compile, ``refs``); on the lossless traffic they must also equal
JAX's speculative engine. A Qwen3-MoE (``tests/test_serving.py``'s
``temp_moe``-shaped tiny config) with int8 experts runs K11's plain version
under speculation.

Also: the reference fault (JAX's engine on the hybrid Qwen3.5 with the
target as its own draft gives other tokens than its ``generate_kv_cache``;
the port rolls the recurrent caches back and serves a Qwen3.5 or Qwen3-Next
target or draft losslessly: ``test_recurrent_caches_served``, and
``tests/test_torch_spec_hybrid.py``), the overhang rule, JAX's refusals,
and ``warmup``, ``cancel`` and ``stats`` with speculation.
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
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine, _clone
from llm_quest_tpu_torch.kernels import quantized_gmm as kqg
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_5 as tq35
from llm_quest_tpu_torch.models import qwen3_next as tqn
from llm_quest_tpu_torch.weights.interop import from_jax_flat

# tests/test_serving.py's configs
CFG = {
    "model_type": "dense", "vocab_size": 128, "context_length": 64, "emb_dim": 32,
    "n_layers": 2, "n_heads": 4, "num_kv_groups": 2, "head_dim": 8, "hidden_dim": 64,
    "rope_base": 10_000, "tie_embeddings": False,
}
DRAFT_CFG = dict(CFG, n_layers=1, emb_dim=16, hidden_dim=32, head_dim=4)
HYBRID_CFG = {
    "model_type": "qwen3_5_text", "vocab_size": 128, "emb_dim": 32, "hidden_dim": 64,
    "n_layers": 4, "linear_sdpa_ratio": 2, "n_heads": 4, "num_kv_groups": 2, "head_dim": 8,
    "rope_base": 10_000_000, "partial_rope_factor": 0.25, "context_length": 64,
    "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8,
    "linear_value_head_dim": 8, "linear_conv_kernel_size": 4,
    "tie_embeddings": False, "mrope_section": [1, 1, 0], "p_dropout": 0.0,
}
MOE_CFG = {
    "model_type": "moe", "vocab_size": 128, "context_length": 64, "emb_dim": 32, "n_layers": 2, "n_heads": 4,
    "num_kv_groups": 2, "head_dim": 8, "moe_hidden_dim": 64, "num_experts": 4, "top_k": 2, "aux_loss_coef": 0.001,
    "rope_base": 10_000, "tie_embeddings": False,
}
NEXT_CFG = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 32, "n_layers": 2, "linear_sdpa_ratio": 2, "n_heads": 4,
    "head_dim": 8, "num_kv_groups": 2, "partial_rope_factor": 0.25, "rope_base": 10_000,
    "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8, "linear_value_head_dim": 8,
    "linear_conv_kernel_size": 4, "moe_hidden_dim": 64, "shared_expert_hidden_dim": 64, "num_experts": 4,
    "top_k": 2, "aux_loss_coef": 0.001, "tie_embeddings": False, "p_dropout": 0.0,
}
BASE = dict(temp=0.0, eos_ids=-1, pad_id=0)
MAX_GEN = 12  # the references' length (every budget below is at most it)


def ints(rng, *sizes):
    return [rng.integers(1, 128, size=n).tolist() for n in sizes]


# each test's traffic, drawn as the JAX test draws it
LOSSLESS = ints(np.random.default_rng(16), 3, 7, 5, 12, 4)
LOSSLESS_GEN = [6, 10, 4, 8, 5]
SELF = ints(np.random.default_rng(17), 5)[0]
_rng = np.random.default_rng(19)
STOCH = ints(_rng, 5)[0]
_rng = np.random.default_rng(20)
PREFIX = ints(_rng, 7)[0]
SUFFIXES = ints(_rng, 3, 5, 2)
_rng = np.random.default_rng(79)
LORA_P0, LORA_P1 = ints(_rng, 5, 7)
LORA_PREFIX, LORA_SUF = ints(_rng, 6)[0], ints(_rng, 3)[0]
LONG_A, LONG_B, SHORT = ints(np.random.default_rng(83), 20, 17, 5)
SAMPLED = ints(np.random.default_rng(89), 5, 7, 4)
MOE_PROMPTS = ints(np.random.default_rng(7), 4, 9, 6)
HYBRID_PROMPTS = ints(np.random.default_rng(15), 3, 7)
# every prompt whose plain greedy tokens a test reads
ALL = [*LOSSLESS, SELF, *(PREFIX + s for s in SUFFIXES), LORA_P0, LORA_P1, LORA_PREFIX + LORA_SUF, LONG_A, LONG_B,
       SHORT, *SAMPLED, LONG_A[:8]]


def jcfg(cfg):
    return dict(cfg, dtype=jnp.float32)


def tcfg(cfg):
    return dict(cfg, dtype=torch.float32)


def port(params, cfg):
    return from_jax_flat({k: np.asarray(v) for k, v in flatten_params(params).items()}, tcfg(cfg), device="cpu")


def jax_plain(params, cfg, prompts, model=jq3, max_gen=MAX_GEN):
    """JAX's greedy tokens of each prompt: one right-padded batch."""
    width = max(map(len, prompts))
    ids = np.zeros((len(prompts), width), np.int32)
    mask = np.zeros((len(prompts), width), bool)
    for j, p in enumerate(prompts):
        ids[j, : len(p)], mask[j, : len(p)] = p, True
    seqs = jgen.generate_batched_kv_cache(model, params, jcfg(cfg), jnp.asarray(ids), jnp.asarray(mask),
                                          max_gen=max_gen, **BASE)["sequences"]
    return {tuple(p): np.asarray(seqs[j, width:]).tolist() for j, p in enumerate(prompts)}


def randomize(node, k):
    """tests/test_serving.py's ``randomize`` at :1356: B drawn N(0, 0.3²) by its size."""
    if isinstance(node, dict):
        if "lora" in node:
            b = node["lora"]["B"]
            noise = 0.3 * jax.random.normal(jax.random.fold_in(k, b.size), b.shape)
            return {**node, "lora": {**node["lora"], "B": noise.astype(b.dtype)}}
        return {kk: randomize(v, k) for kk, v in node.items()}
    if isinstance(node, list):
        return [randomize(v, k) for v in node]
    return node


@pytest.fixture(scope="module")
def models():
    """JAX trees and their port models: the target, the weak draft, the
    target with one stacked adapter (:1348's), the int8 Qwen3-MoE."""
    target = jq3.init(jax.random.PRNGKey(0), jcfg(CFG))
    draft = jq3.init(jax.random.PRNGKey(7), jcfg(DRAFT_CFG))
    k = jax.random.PRNGKey(73)
    stacked = jl.stack_adapters([randomize(jl.replace_with_lora(k, target, 4, 16, path_filter=lambda p: "att" in p),
                                           k)])
    moe = jquantize(jq3.init(jax.random.PRNGKey(2), jcfg(MOE_CFG)), min_size=0)
    jax_trees = {"target": target, "draft": draft, "stacked": stacked, "moe": moe}
    ported = {"target": port(target, CFG), "draft": port(draft, DRAFT_CFG), "stacked": port(stacked, CFG),
              "moe": port(moe, MOE_CFG)}
    return jax_trees, ported


@pytest.fixture(scope="module")
def refs(models):
    """JAX's plain greedy tokens (the target, adapter 0's merge, the int8
    MoE) and JAX's speculative engine on the lossless traffic, EOS included."""
    t = models[0]
    out = {"plain": jax_plain(t["target"], CFG, ALL),
           "merged": jax_plain(jl.merge_adapter(t["stacked"], 0), CFG, ALL),
           "moe": jax_plain(t["moe"], MOE_CFG, MOE_PROMPTS, max_gen=5)}
    kw = dict(n_slots=2, max_len=40, decode_chunk=2, **BASE, draft_model=jq3, draft_params=t["draft"],
              draft_cfg=jcfg(DRAFT_CFG), gamma=3)
    out["engine"] = JaxEngine(jq3, t["target"], jcfg(CFG), prefill_buckets=(8, 16), **kw).serve(
        list(zip(LOSSLESS, LOSSLESS_GEN)))
    eos = out["plain"][tuple(LOSSLESS[0])][3]
    out["eos"] = eos
    out["engine_eos"] = JaxEngine(jq3, t["target"], jcfg(CFG), prefill_buckets=(8,), **{**kw, "eos_ids": eos}).serve(
        [(LOSSLESS[0], 8), (LOSSLESS[0], 8)])
    return out


def ref(refs, ids, n, table="plain"):
    return refs[table][tuple(ids)][:n]


def engine(models, target="target", draft="draft", cfg=CFG, dcfg=DRAFT_CFG, **kw):
    ported = models[1]
    args = dict(n_slots=2, max_len=48, decode_chunk=2, prefill_buckets=(8,), **BASE, draft_model=tq3,
                draft_params=ported[draft], draft_cfg=tcfg(dcfg), gamma=3)
    return ContinuousBatchingEngine(tq3, ported[target], tcfg(cfg), device="cpu", **{**args, **kw})


def test_lossless_tokens_equal_jax(models, refs):
    """test_serving_speculative_lossless: 5 requests through 2 slots, a draft
    that knows nothing; then an EOS mid-stream retires both rows of a pool."""
    eng = engine(models, max_len=40, prefill_buckets=(8, 16))
    got = eng.serve(list(zip(LOSSLESS, LOSSLESS_GEN)))
    assert got == [ref(refs, p, g) for p, g in zip(LOSSLESS, LOSSLESS_GEN)]
    assert got == refs["engine"]
    eos = refs["eos"]
    eng2 = engine(models, max_len=40, eos_ids=eos)
    got2 = eng2.serve([(LOSSLESS[0], 8), (LOSSLESS[0], 8)])
    free = ref(refs, LOSSLESS[0], 8)
    assert got2 == [free[: free.index(eos) + 1]] * 2 == refs["engine_eos"]


def test_self_draft_commits_gamma_plus_one(models, refs):
    """test_serving_speculative_self_draft_accepts_everything: 12 tokens at
    γ + 1 = 4 a window are 3 windows, one a chunk."""
    eng = engine(models, draft="target", dcfg=CFG, n_slots=1, decode_chunk=1)
    assert eng.serve([(SELF, 12)]) == [ref(refs, SELF, 12)]
    stats = eng.stats()
    assert stats["decode_chunks"] == stats["windows"] == 3 and stats["tokens_per_row_window"] == 4.0


def test_stochastic_properties(models):
    """test_serving_speculative_stochastic: with the target as its own draft
    p/q = 1, so every window commits γ + 1; a weak draft at top-k 20 gives
    full budgets of vocabulary ids."""
    eng = engine(models, draft="target", dcfg=CFG, n_slots=1, decode_chunk=1, temp=0.8,
                 generator=torch.Generator().manual_seed(0))
    out = eng.serve([(STOCH, 12)])
    assert len(out[0]) == 12 and all(0 <= t < 128 for t in out[0])
    assert eng.stats()["decode_chunks"] == 3
    eng2 = engine(models, temp=0.8, top_k=20, generator=torch.Generator().manual_seed(1))
    outs = eng2.serve([(STOCH, 9), (ints(np.random.default_rng(21), 7)[0], 6)])
    assert [len(o) for o in outs] == [9, 6] and all(0 <= t < 128 for o in outs for t in o)


def test_prefix_tokens_equal_jax(models, refs):
    """test_serving_speculative_with_prefix: both pool caches seed from their
    stored prefix rows; the stored rows are unchanged by the waves."""
    eng = engine(models)
    pid = eng.register_prefix(PREFIX)
    stored = [_clone(row) for row in (eng._prefixes[pid][0], eng._prefixes[pid][2])]
    assert eng.serve([(s, 6, pid) for s in SUFFIXES]) == [ref(refs, PREFIX + s, 6) for s in SUFFIXES]
    for before, after in zip(stored, (eng._prefixes[pid][0], eng._prefixes[pid][2])):
        assert all(torch.equal(after[n], v) for n, v in before.items() if torch.is_tensor(v))


def test_lora_tokens_equal_jax(models, refs):
    """test_serving_speculative_with_lora: the target verifies through each
    slot's adapter (the draft is the base); adapter 0's tokens equal JAX's
    merged adapter's and differ from the base's; then prefix + adapter."""
    eng = engine(models, target="stacked")
    got = eng.serve([(LORA_P0, 10, None, None, 0), (LORA_P1, 6)])
    assert got == [ref(refs, LORA_P0, 10, "merged"), ref(refs, LORA_P1, 6)]
    assert got[0] != ref(refs, LORA_P0, 10)
    pid = eng.register_prefix(LORA_PREFIX, adapter=0)
    assert eng.serve([(LORA_SUF, 6, pid, None, 0)]) == [ref(refs, LORA_PREFIX + LORA_SUF, 6, "merged")]


def test_chunked_prefill_tokens_equal_jax(models, refs):
    """test_serving_speculative_chunked_prefill: prompts past the bucket fill
    both pool caches through chunks of 8 (the 17-token one ends in chunk 3's
    first column)."""
    eng = engine(models, prefill_chunk=8)
    got = eng.serve([(LONG_A, 8), (LONG_B, 8), (SHORT, 6)])
    assert got == [ref(refs, LONG_A, 8), ref(refs, LONG_B, 8), ref(refs, SHORT, 6)]


def test_per_request_sampling_equals_jax(models, refs):
    """test_serving_speculative_per_request_sampling: a greedy request in a
    stochastic pool and a top-k 1 one equal the greedy tokens; the default
    stochastic one gets its budget; min_p refused."""
    eng = engine(models, temp=0.9, top_k=20, per_request_sampling=True, generator=torch.Generator().manual_seed(0))
    rids = [eng.submit(SAMPLED[0], 9, temp=0.0), eng.submit(SAMPLED[1], 7),
            eng.submit(SAMPLED[2], 6, temp=0.8, top_k=1)]
    while eng.step():
        pass
    toks0, done0 = eng.result(rids[0])
    assert done0 and toks0 == ref(refs, SAMPLED[0], 9)
    toks1, _ = eng.result(rids[1])
    assert len(toks1) == 7 and all(0 <= t < 128 for t in toks1)
    assert eng.result(rids[2])[0] == ref(refs, SAMPLED[2], 6)
    with pytest.raises(ValueError, match="min_p"):
        eng.submit(SAMPLED[0], 4, temp=0.5, min_p=0.1)


def test_int8_moe_target_equals_jax(models, refs):
    """A Qwen3-MoE target with JAX's int8 linears and expert stacks: its
    expert matmuls take K11's plain version in the windows (spied: their
    rows are a window's), and the tokens equal JAX's."""
    calls = []
    real = kqg.quantized_ragged_dot

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    kqg.quantized_ragged_dot = spy
    try:
        eng = engine(models, target="moe", cfg=MOE_CFG, max_len=32, decode_chunk=3, prefill_buckets=(16,))
        got = eng.serve([(p, 5) for p in MOE_PROMPTS])
    finally:
        kqg.quantized_ragged_dot = real
    assert got == [ref(refs, p, 5, "moe") for p in MOE_PROMPTS]
    window = 2 * 4 * MOE_CFG["top_k"]  # 2 slots, γ + 1 = 4 tokens, top-2: the windows' expert rows
    assert window in calls and 2 * MOE_CFG["top_k"] not in calls  # no single-token decode step


def test_jax_hybrid_self_draft_differs_from_generate():
    """The reference fault: JAX's engine with the hybrid Qwen3.5 target as
    its own draft (2 slots, chunk 2, γ 3, greedy) gives other tokens than
    JAX's ``generate_kv_cache``: its windows advance the GDN state and conv
    taps with the re-fed token and the rejected drafts. Lossless speculation
    would give the same tokens, as the port's does
    (``test_recurrent_caches_served``)."""

    class Text:
        apply = staticmethod(jq35.apply_text)
        init_cache = staticmethod(jq35.init_cache)

    cfg = jcfg(HYBRID_CFG)
    hp = jq35.init_text(jax.random.PRNGKey(1), cfg)
    eng = JaxEngine(Text, hp, cfg, n_slots=2, max_len=32, decode_chunk=2, prefill_buckets=(8,), pipeline_depth=1,
                    **BASE, draft_model=Text, draft_params=hp, draft_cfg=cfg, gamma=3)
    spec = eng.serve([(HYBRID_PROMPTS[0], 6)])[0]
    plain = jgen.generate_kv_cache(Text, hp, cfg, jnp.asarray([HYBRID_PROMPTS[0]], jnp.int32), max_gen=6,
                                   **BASE)["sequences"][0, 3:].tolist()
    assert len(spec) == len(plain) == 6 and spec != plain


@pytest.mark.parametrize("role,family", [("target", "qwen3_5"), ("target", "qwen3_next"), ("draft", "qwen3_5"),
                                         ("draft", "qwen3_next")])
def test_recurrent_caches_served(models, refs, role, family):
    """A Qwen3.5 or Qwen3-Next target or draft is served (its GDN states and
    conv taps rolled back to each row's committed tokens): a hybrid target's
    tokens equal its plain engine's, the dense target's with a hybrid draft
    equal JAX's plain greedy tokens."""
    gen = torch.Generator().manual_seed(0)
    if family == "qwen3_5":
        mod, cfg = tq35.TextOnly, tcfg(HYBRID_CFG)
        hybrid = tq35.init_text(cfg, generator=gen, device="cpu")
    else:
        mod, cfg = tqn, tcfg(NEXT_CFG)
        hybrid = tqn.init(cfg, generator=gen, device="cpu")
    ported = models[1]
    traffic = list(zip(LOSSLESS[:3], LOSSLESS_GEN[:3]))
    kw = dict(n_slots=2, max_len=40, decode_chunk=2, prefill_buckets=(8, 16), **BASE, device="cpu")
    if role == "target":
        eng = ContinuousBatchingEngine(mod, hybrid, cfg, draft_model=tq3, draft_params=ported["draft"],
                                       draft_cfg=tcfg(DRAFT_CFG), gamma=3, **kw)
        assert eng.serve(traffic) == ContinuousBatchingEngine(mod, hybrid, cfg, **kw).serve(traffic)
    else:
        eng = ContinuousBatchingEngine(tq3, ported["target"], tcfg(CFG), draft_model=mod, draft_params=hybrid,
                                       draft_cfg=cfg, gamma=3, **kw)
        assert eng.serve(traffic) == [ref(refs, p, g) for p, g in traffic]
    assert eng.stats()["windows"] > 0


def test_overhang_rule(models, refs):
    """A window writes γ columns past a row's last (and positions as far):
    ``submit`` refuses prefix + bucket + max_gen + γ > max_len. At the limit
    the request is served, its last window's writes in range (an index past
    max_len raises on the CPU), and its tokens equal JAX's."""
    full = LONG_A[:8]  # a whole bucket: its last window writes column max_len - 1
    eng = engine(models, max_len=8 + 12 + 3, n_slots=1)
    with pytest.raises(ValueError, match="bucket 8 \\+ max_gen 13 \\+ gamma 3 exceeds max_len 23"):
        eng.submit(full, 13)
    assert eng.serve([(full, 12)]) == [ref(refs, full, 12)]
    pid = eng.register_prefix(PREFIX)
    with pytest.raises(ValueError, match="prefix 7 \\+ bucket 8 \\+ max_gen 6 \\+ gamma 3 exceeds max_len 23"):
        eng.submit(SUFFIXES[0], 6, prefix=pid)
    assert eng.serve([(SUFFIXES[0], 5, pid)]) == [ref(refs, PREFIX + SUFFIXES[0], 5)]


def test_refusals_match_jax(models):
    """JAX's messages: multimodal requests, logprobs, min_p (a request's;
    the engine's, which JAX ignores), chunked prefill with multi-LoRA; and a
    draft without its weights or config."""
    eng = engine(models)
    with pytest.raises(ValueError, match="multimodal requests are not supported in speculative serving yet"):
        eng.submit(SHORT, 4, pixels=np.zeros((3, 2, 16, 16), np.float32))
    with pytest.raises(ValueError, match="multimodal requests are not supported in speculative serving yet"):
        eng.warmup(image_shape=(3, 2, 16, 16))
    with pytest.raises(ValueError, match="return_logprobs does not compose with speculative serving yet"):
        engine(models, return_logprobs=True)
    with pytest.raises(ValueError, match="min_p is not defined"):
        engine(models, temp=0.7, min_p=0.1)
    with pytest.raises(ValueError, match="spec \\+ chunked prefill \\+ multi-LoRA is not wired yet"):
        engine(models, target="stacked", prefill_chunk=8).submit(LONG_A, 4)
    engine(models, target="stacked", prefill_chunk=8).submit(SHORT, 4)  # short prompts are served
    with pytest.raises(ValueError, match="draft_params and draft_cfg"):
        engine(models, draft_params=None)


def test_warmup_cancel_and_stats(models, refs):
    """``warmup`` with requests live (its scratch admissions and windows run
    on a copy) leaves the pool, the draft's cache and the window count as
    they were; a cancelled resident request frees its slot and the others'
    tokens equal JAX's."""
    eng = engine(models, max_len=40, prefill_buckets=(8, 16))
    rids = [eng.submit(p, g) for p, g in zip(LOSSLESS, LOSSLESS_GEN)]
    eng.step()
    before, windows = _clone(eng.state), eng.stats()["windows"]
    eng.warmup()
    for name in ("mask_buf", "seqpos", "finished", "budget", "last_tok"):
        assert torch.equal(eng.state[name], before[name]), name
    assert all(torch.equal(eng.state["d_cache"][n], v) for n, v in before["d_cache"].items())
    assert eng.stats()["windows"] == windows
    assert eng.cancel(rids[1]) and not eng.cancel(rids[1])
    while eng.step():
        pass
    for i, (p, g) in enumerate(zip(LOSSLESS, LOSSLESS_GEN)):
        toks, done = eng.result(rids[i])
        assert done and (toks == ref(refs, p, g) if i != 1 else len(toks) < g)
    stats = eng.stats()
    assert stats["requests_completed"] == 5 and stats["windows"] >= stats["decode_chunks"]
    assert 1.0 <= stats["tokens_per_row_window"] <= 4.0
