"""Speculative decoding over hybrid (recurrent) caches in the port, against
the JAX package, on the CPU in fp32.

The models are ``tests/test_serving.py``'s tiny configs: the hybrid Qwen3.5
text ``HYBRID_CFG`` (4 layers, GDN every other), a Qwen3-Next of the same
widths (``tests/test_torch_serving_spec.py``'s ``NEXT_CFG``: one GDN and one
attention layer, 4 experts top-2) and the dense Qwen3 ``CFG``. Their weights
are drawn from numpy seeds into JAX's layout (the JAX tree shaped by
``jax.eval_shape`` of its ``init``) and carried to the port by
``from_jax_flat``; a stacked adapter over the Qwen3.5 tree is built in JAX
as ``tests/test_serving.py`` builds its own.

Greedy speculation is lossless, so every request's tokens must equal JAX's
plain greedy tokens for its prompt alone (one ``generate_batched_kv_cache``
a model over all the prompts: ``refs``) and the port's plain engine's,
exactly: with a hybrid target as its own draft, with the other hybrid as the
draft, and a dense model paired with a hybrid one either way; through the
plain, chunked, prefix and multi-LoRA admissions; with an EOS and budgets
that cut a window. A self-draft commits γ + 1 tokens a window where no cap
cuts it, greedy and stochastic (p = q). After a serve each row's GDN states
and conv taps, in the target's pool and the draft's, equal a JAX
``apply`` prefill over exactly the row's committed tokens but the last,
within 1e-5, while a control whose windows keep every token they feed (JAX's
behaviour) reads beyond that. ``speculative_generate`` over hybrid models
equals the plain greedy tokens too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.models import qwen3_5 as jq35
from llm_quest_tpu.models import qwen3_next as jqn
from llm_quest_tpu.ops import lora as jl
from llm_quest_tpu.weights.interop import flatten_params, unflatten_into
from llm_quest_tpu_torch.inference import spec_decoding as tspec
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine, _clone
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_5 as tq35
from llm_quest_tpu_torch.models import qwen3_next as tqn
from llm_quest_tpu_torch.ops import gdn as gdn_ops
from llm_quest_tpu_torch.weights.interop import from_jax_flat

STATE_TOL = 1e-5
CONTROL_MIN = 1e-3  # the control's reading must exceed this (JAX's windows keep every token fed)

# tests/test_serving.py's configs and tests/test_torch_serving_spec.py's Qwen3-Next
CFG = {
    "model_type": "dense", "vocab_size": 128, "context_length": 64, "emb_dim": 32,
    "n_layers": 2, "n_heads": 4, "num_kv_groups": 2, "head_dim": 8, "hidden_dim": 64,
    "rope_base": 10_000, "tie_embeddings": False,
}
HYBRID_CFG = {
    "model_type": "qwen3_5_text", "vocab_size": 128, "emb_dim": 32, "hidden_dim": 64,
    "n_layers": 4, "linear_sdpa_ratio": 2, "n_heads": 4, "num_kv_groups": 2, "head_dim": 8,
    "rope_base": 10_000_000, "partial_rope_factor": 0.25, "context_length": 64,
    "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8,
    "linear_value_head_dim": 8, "linear_conv_kernel_size": 4,
    "tie_embeddings": False, "mrope_section": [1, 1, 0], "p_dropout": 0.0,
}
NEXT_CFG = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 32, "n_layers": 2, "linear_sdpa_ratio": 2, "n_heads": 4,
    "head_dim": 8, "num_kv_groups": 2, "partial_rope_factor": 0.25, "rope_base": 10_000,
    "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8, "linear_value_head_dim": 8,
    "linear_conv_kernel_size": 4, "moe_hidden_dim": 64, "shared_expert_hidden_dim": 64, "num_experts": 4,
    "top_k": 2, "aux_loss_coef": 0.001, "tie_embeddings": False, "p_dropout": 0.0,
}
BASE = dict(temp=0.0, eos_ids=-1, pad_id=0)
GAMMA = 3
MAX_GEN = 12  # the references' length (every budget below is at most it)
STATE_WIDTH = 32  # the JAX state prefills' padded width (one compile a model)


class JaxText:
    apply = staticmethod(jq35.apply_text)
    init_cache = staticmethod(jq35.init_cache)


# name: (JAX module, JAX init, config, port module, numpy seed)
FAMILIES = {
    "dense": (jq3, jq3.init, CFG, tq3, 2),
    "q35": (JaxText, jq35.init_text, HYBRID_CFG, tq35.TextOnly, 0),
    "next": (jqn, jqn.init, NEXT_CFG, tqn, 1),
}
OTHER = {"q35": "next", "next": "q35"}  # each hybrid's draft of another family (its drafts get rejected)


def ints(rng, *sizes):
    return [rng.integers(1, 128, size=n).tolist() for n in sizes]


PLAIN = ints(np.random.default_rng(31), 3, 7, 5, 1, 6)  # a one-token prompt: its state starts empty
PLAIN_GEN = [9, 6, 12, 7, 10]
LONG_A, LONG_B, SHORT = ints(np.random.default_rng(83), 20, 17, 5)  # chunks of 8 over bucket 8
_rng = np.random.default_rng(20)
PREFIX = ints(_rng, 7)[0]
SUFFIXES = ints(_rng, 3, 5, 2)  # 2 < the conv window's 3 taps
LORA_P0, LORA_P1 = ints(np.random.default_rng(79), 5, 7)
ALL = [*PLAIN, LONG_A, LONG_B, SHORT, *(PREFIX + s for s in SUFFIXES), LORA_P0, LORA_P1]


def jcfg(cfg):
    return dict(cfg, dtype=jnp.float32)


def tcfg(cfg):
    return dict(cfg, dtype=torch.float32)


def seeded_flat(name):
    """The family's weights from its numpy seed, in JAX's layout and names:
    norm scales 1 + N(0, 0.1²), matrices N(0, 1 / fan-in), other vectors
    N(0, 0.5²); and the JAX tree they fill (``jax.eval_shape`` of ``init``)."""
    _, init, cfg, _, seed = FAMILIES[name]
    template = jax.eval_shape(lambda k: init(k, jcfg(cfg)), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in sorted(flatten_params(template).items()):
        if path.endswith("scale"):
            arr = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif len(leaf.shape) >= 2:
            arr = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        else:
            arr = 0.5 * rng.standard_normal(leaf.shape)
        flat[path] = arr.astype(np.float32)
    return flat, unflatten_into(template, flat)


def port(flat, cfg):
    return from_jax_flat({k: np.asarray(v) for k, v in flat.items()}, tcfg(cfg), device="cpu")


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
    """{name: (JAX tree, port model)}: the three families and, as
    "q35_lora", the Qwen3.5 tree with one stacked adapter."""
    out = {}
    for name, (_, _, cfg, _, _) in FAMILIES.items():
        flat, tree = seeded_flat(name)
        out[name] = (tree, port(flat, cfg))
    k = jax.random.PRNGKey(73)
    stacked = jl.stack_adapters([randomize(jl.replace_with_lora(k, out["q35"][0], 4, 16,
                                                                path_filter=lambda p: "att" in p), k)])
    out["q35_lora"] = (stacked, port(flatten_params(stacked), HYBRID_CFG))
    out["q35_merged"] = (jl.merge_adapter(stacked, 0), None)
    return out


def jax_plain(jmod, params, cfg, prompts):
    """JAX's greedy tokens of each prompt: one right-padded batch."""
    width = max(map(len, prompts))
    ids = np.zeros((len(prompts), width), np.int32)
    mask = np.zeros((len(prompts), width), bool)
    for j, p in enumerate(prompts):
        ids[j, : len(p)], mask[j, : len(p)] = p, True
    seqs = jgen.generate_batched_kv_cache(jmod, params, jcfg(cfg), jnp.asarray(ids), jnp.asarray(mask),
                                          max_gen=MAX_GEN, **BASE)["sequences"]
    return {tuple(p): np.asarray(seqs[j, width:]).tolist() for j, p in enumerate(prompts)}


@pytest.fixture(scope="module")
def refs(models):
    """JAX's plain greedy tokens of every prompt: each family, and the
    Qwen3.5 tree merged with its adapter 0."""
    out = {name: jax_plain(jmod, models[name][0], cfg, ALL) for name, (jmod, _, cfg, _, _) in FAMILIES.items()}
    out["q35_merged"] = jax_plain(JaxText, models["q35_merged"][0], HYBRID_CFG, ALL)
    return out


def ref(refs, table, ids, n):
    return refs[table][tuple(ids)][:n]


def family_of(name):
    return "q35" if name.startswith("q35") else name


def engine(models, target, draft=None, **kw):
    """The port's engine (2 slots, chunk 2, bucket 8, γ 3), speculative with ``draft``."""
    _, _, cfg, mod, _ = FAMILIES[family_of(target)]
    spec = {}
    if draft is not None:
        _, _, dcfg, dmod, _ = FAMILIES[draft]
        spec = dict(draft_model=dmod, draft_params=models[draft][1], draft_cfg=tcfg(dcfg), gamma=GAMMA)
    args = dict(n_slots=2, max_len=48, decode_chunk=2, prefill_buckets=(8,), **BASE, device="cpu")
    return ContinuousBatchingEngine(mod, models[target][1], tcfg(cfg), **{**args, **spec, **kw})


@pytest.fixture(scope="module")
def plain_engine_tokens(models):
    """The port's plain engine's tokens on ``PLAIN`` for each family."""
    return {name: engine(models, name).serve(list(zip(PLAIN, PLAIN_GEN))) for name in FAMILIES}


PAIRS = [("q35", "q35"), ("q35", "next"), ("next", "next"), ("next", "q35"), ("q35", "dense"), ("dense", "q35"),
         ("next", "dense"), ("dense", "next")]


@pytest.mark.parametrize("target,draft", PAIRS, ids=[f"{t}-{d}" for t, d in PAIRS])
def test_lossless_greedy(models, refs, plain_engine_tokens, target, draft):
    """5 requests through 2 slots (a one-token prompt among them): the
    speculative tokens equal JAX's plain greedy tokens and the port's plain
    engine's, whichever of the target and the draft holds recurrent state."""
    got = engine(models, target, draft).serve(list(zip(PLAIN, PLAIN_GEN)))
    assert got == [ref(refs, target, p, g) for p, g in zip(PLAIN, PLAIN_GEN)]
    assert got == plain_engine_tokens[target]


@pytest.mark.parametrize("family", ["q35", "next"])
def test_chunked_admission(models, refs, family):
    """Prompts past the bucket fill both pools through chunks of 8 (the
    17-token one ends in chunk 3's first column, so its state mask leaves
    out a chunk's first token), beside a short prompt."""
    eng = engine(models, family, OTHER[family], prefill_chunk=8)
    got = eng.serve([(LONG_A, 8), (LONG_B, 8), (SHORT, 6)])
    assert got == [ref(refs, family, LONG_A, 8), ref(refs, family, LONG_B, 8), ref(refs, family, SHORT, 6)]


@pytest.mark.parametrize("family", ["q35", "next"])
def test_prefix_admission(models, refs, family):
    """Both pools seed from their stored prefix rows (the full prefix in the
    state); each suffix wave leaves out its own last token; the stored rows
    are unchanged by the waves."""
    eng = engine(models, family, OTHER[family])
    pid = eng.register_prefix(PREFIX)
    stored = [_clone(row) for row in (eng._prefixes[pid][0], eng._prefixes[pid][2])]
    assert eng.serve([(s, 6, pid) for s in SUFFIXES]) == [ref(refs, family, PREFIX + s, 6) for s in SUFFIXES]
    for before, after in zip(stored, (eng._prefixes[pid][0], eng._prefixes[pid][2])):
        assert all(torch.equal(after[n], v) for n, v in before.items() if torch.is_tensor(v))


def test_multi_lora_admission(models, refs):
    """The hybrid target verifies through each slot's adapter with a
    Qwen3-Next draft: adapter 0's tokens equal JAX's merged adapter's (and
    differ from the base's), the base request's the base's; then a prefix
    registered through adapter 0."""
    eng = engine(models, "q35_lora", "next")
    got = eng.serve([(LORA_P0, 10, None, None, 0), (LORA_P1, 6)])
    assert got == [ref(refs, "q35_merged", LORA_P0, 10), ref(refs, "q35", LORA_P1, 6)]
    assert got[0] != ref(refs, "q35", LORA_P0, 10)
    pid = eng.register_prefix(PREFIX, adapter=0)
    assert eng.serve([(SUFFIXES[1], 6, pid, None, 0)]) == [ref(refs, "q35_merged", PREFIX + SUFFIXES[1], 6)]


@pytest.mark.parametrize("family", ["q35", "next"])
def test_eos_and_budgets_cut_windows(models, refs, family):
    """A self-draft commits whole windows of 4; an EOS inside the second
    window and budgets of 7 and 10 (not multiples of 4) cut them. Tokens
    equal JAX's, up to and including the EOS."""
    free = ref(refs, family, PLAIN[2], MAX_GEN)
    eos = next(t for i, t in enumerate(free) if i >= 5 and t not in free[:i])
    eng = engine(models, family, family, eos_ids=eos)
    traffic = [(PLAIN[2], MAX_GEN), (PLAIN[0], 7), (PLAIN[4], 10)]
    expect = []
    for p, g in traffic:
        toks = ref(refs, family, p, g)
        expect.append(toks[: toks.index(eos) + 1] if eos in toks else toks)
    assert eng.serve(traffic) == expect
    assert len(expect[0]) < MAX_GEN and len(expect[0]) % (GAMMA + 1) != 0


@pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "stochastic"])
@pytest.mark.parametrize("family", ["q35", "next"])
def test_self_draft_commits_gamma_plus_one(models, refs, family, temp):
    """With the target as its own draft every window commits γ + 1 tokens
    where no budget cuts it (stochastic: p/q = 1): a request of budget g
    takes ⌈g / (γ + 1)⌉ windows; greedy tokens equal JAX's."""
    gen = torch.Generator().manual_seed(0)
    eng = engine(models, family, family, temp=temp, generator=gen)
    traffic = [(PLAIN[0], 12), (PLAIN[1], 8), (PLAIN[2], 9)]
    got = eng.serve(traffic)
    assert [len(t) for t in got] == [g for _, g in traffic]
    assert eng.stats()["row_windows"] == sum(-(-g // (GAMMA + 1)) for _, g in traffic)
    if temp == 0.0:
        assert got == [ref(refs, family, p, g) for p, g in traffic]


def jax_states(models, name, seqs):
    """The JAX model's cache after an ``apply`` prefill of ``seqs`` (right-
    padded to STATE_WIDTH, pads masked): its GDN state and conv-tap leaves."""
    jmod, _, cfg, _, _ = FAMILIES[name]
    ids = np.zeros((len(seqs), STATE_WIDTH), np.int32)
    mask = np.zeros((len(seqs), STATE_WIDTH), bool)
    for j, s in enumerate(seqs):
        ids[j, : len(s)], mask[j, : len(s)] = s, True
    cache = _prefill(jmod, name)(models[name][0], jnp.asarray(ids), jnp.asarray(mask))
    return {n: np.asarray(v) for n, v in cache.items() if n == "recurrent" or n.startswith("conv")}


_PREFILLS = {}


def _prefill(jmod, name):
    if name not in _PREFILLS:
        cfg = jcfg(FAMILIES[name][2])

        def fn(params, ids, mask):
            cache = jmod.init_cache(cfg, ids.shape[0], STATE_WIDTH)
            return jmod.apply(params, cfg, ids, attn_mask=mask, cache=cache)[1]

        _PREFILLS[name] = jax.jit(fn)
    return _PREFILLS[name]


def state_error(pool, ref_states, rows):
    return max(float(np.abs(pool[n][:, rows].numpy() - ref_states[n]).max()) for n in ref_states)


@pytest.mark.parametrize("control", [False, True], ids=["rolled_back", "control_keeps_all"])
@pytest.mark.parametrize("family", ["q35", "next"])
def test_state_is_a_prefill_of_the_committed_tokens(models, family, control, monkeypatch):
    """Three requests in three slots with the other hybrid as the draft
    (most drafts rejected): after the serve each row's GDN states and conv
    taps, in the target's pool and the draft's, equal a JAX prefill over
    the row's committed tokens but the last, within STATE_TOL. The control
    keeps every window token in the state (JAX's windows): it reads beyond
    CONTROL_MIN."""
    if control:
        real = gdn_ops.roll_window

        def keep_all(cfg, cache, counts, before=None):
            return real(cfg, cache, torch.full_like(counts, GAMMA + 1), before)

        monkeypatch.setattr(gdn_ops, "roll_window", keep_all)
    draft = OTHER[family]
    eng = engine(models, family, draft, n_slots=3)
    traffic = [(PLAIN[0], 9), (PLAIN[1], 6), (PLAIN[4], 12)]
    got = eng.serve(traffic)
    seqs = [p + t[:-1] for (p, _), t in zip(traffic, got)]
    rows = list(range(len(traffic)))
    errs = [state_error(eng.state["cache"], jax_states(models, family, seqs), rows),
            state_error(eng.state["d_cache"], jax_states(models, draft, seqs), rows)]
    if control:
        assert min(errs) > CONTROL_MIN, errs
    else:
        assert max(errs) <= STATE_TOL, errs


SPEC_CASES = [("q35", "q35", 1), ("q35", "next", 3), ("next", "next", 1), ("next", "dense", 0), ("dense", "q35", 4)]


@pytest.mark.parametrize("target,draft,prompt", SPEC_CASES, ids=[f"{t}-{d}-{p}" for t, d, p in SPEC_CASES])
def test_speculative_generate_hybrid(models, refs, target, draft, prompt):
    """``speculative_generate`` (b 1, γ 3, greedy; the 1-token prompt among
    the cases) equals JAX's plain greedy tokens; a self-draft takes
    ⌈12 / 4⌉ windows."""
    _, _, cfg, mod, _ = FAMILIES[target]
    _, _, dcfg, dmod, _ = FAMILIES[draft]
    ids = PLAIN[prompt]
    out = tspec.speculative_generate(mod, models[target][1], tcfg(cfg), dmod, models[draft][1], tcfg(dcfg), [ids],
                                     max_gen=MAX_GEN, draft_max_gen=GAMMA, device="cpu")
    assert out["sequences"][0, len(ids):].tolist() == ref(refs, target, ids, MAX_GEN)
    if target == draft:
        assert int(out["num_steps"]) == -(-MAX_GEN // (GAMMA + 1))


@pytest.mark.parametrize("size", ["gpt_s", "gpt_m", "gpt_l", "gpt_xl"])
def test_gpt2_config_creator_matches_jax(size):
    """The port's GPT-2 family configs carry the JAX package's keys and values."""
    from llm_quest_tpu import config as jconfig
    from llm_quest_tpu_torch import config as tconfig

    assert tconfig.gpt2_config_creator(size) == jconfig.gpt2_config_creator(size)


def test_spec_decoding_generate_script(monkeypatch):
    """The standalone speculative entry script at tiny widths on the CPU
    (its GPT-2 configs cut by a patched ``gpt2_config_creator``, fp32): each
    γ's greedy tokens equal the plain target's, in ⌈max_gen / (γ + 1)⌉ to
    max_gen windows."""
    from llm_quest_tpu_torch import config as tconfig
    from llm_quest_tpu_torch.scripts import spec_decoding_generate as script

    real = tconfig.gpt2_config_creator
    monkeypatch.setattr(tconfig, "gpt2_config_creator", lambda size: dict(
        real(size), n_layers=2 if size == "gpt_m" else 1, emb_dim=32, n_heads=4, vocab_size=512))
    monkeypatch.setattr(script, "PROMPT", [[464 % 512, 2068 % 512, 7586 % 512]])
    out = script.main(gammas=(1, 4), max_gens=(10,), device="cpu", dtype=torch.float32)
    for gamma, row in out[10]["gammas"].items():
        assert row["equal_to_plain"] and len(row["tokens"]) == 10
        assert -(-10 // (gamma + 1)) <= row["steps"] <= 10


@pytest.mark.parametrize("family", ["q35", "next"])
def test_warmup_restores_both_hybrid_pools(models, refs, family):
    """``warmup`` with requests live (its scratch admissions and windows
    roll scratch states) leaves both pools' GDN states and taps bit for bit
    as they were, and the served tokens equal JAX's."""
    eng = engine(models, family, OTHER[family])
    traffic = list(zip(PLAIN[:3], PLAIN_GEN[:3]))
    rids = [eng.submit(p, g) for p, g in traffic]
    eng.step()
    before = _clone(eng.state)
    eng.warmup()
    for pool in ("cache", "d_cache"):
        assert all(torch.equal(eng.state[pool][n], before[pool][n]) for n in gdn_ops.state_leaves(before[pool]))
    while eng.step():
        pass
    assert [eng.result(r)[0] for r in rids] == [ref(refs, family, p, g) for p, g in traffic]
