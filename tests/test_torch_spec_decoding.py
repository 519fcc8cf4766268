"""The ported ``inference/spec_decoding.py`` against the JAX package, on the
CPU in fp32.

- ``modified_probs`` against JAX's at several (temp, top-k, top-p), within
  1e-6;
- ``speculative_generate``, greedy, at γ 1, 2 and 4: the sequences equal
  JAX's exactly, on ``tests/test_spec_decoding.py``'s traffic (its prompts,
  ``jax.random.randint`` of keys 2-5) with ``tests/test_serving.py``'s dense
  Qwen3 ``CFG`` as the target and its weak 1-layer draft (GPT-2 is not
  ported yet);
- a perfect draft (the target itself) takes ⌈max_gen / (γ + 1)⌉ windows,
  where JAX's takes more: its draft cache keeps a stale column after a
  fully accepted window (the port feeds the last draft, as JAX's engine
  does); EOS stops generation at the plain engine's token;
- the stochastic path: lengths, vocabulary, steps; a perfect draft accepts
  every token; and the acceptance rule's distribution: over 50,000 rows of
  fixed logits, the first and second committed tokens are distributed as
  ``modified_probs`` of the target within a total-variation bound, which a
  draft's own tokens read beyond;
- a Qwen3.5 target and a Qwen3-Next draft, whose recurrent caches the
  windows roll back: the tokens equal plain greedy decoding's.

The weights are JAX's ``init`` carried to the port by ``from_jax_flat``;
the JAX references are computed once per module (``jax_refs``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.inference import spec_decoding as jspec
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.inference import spec_decoding as tspec
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_5 as tq35
from llm_quest_tpu_torch.models import qwen3_next as tqn
from llm_quest_tpu_torch.weights.interop import from_jax_flat

# tests/test_serving.py's dense Qwen3 and its weak draft
CFG = {
    "model_type": "dense", "vocab_size": 128, "context_length": 64, "emb_dim": 32,
    "n_layers": 2, "n_heads": 4, "num_kv_groups": 2, "head_dim": 8, "hidden_dim": 64,
    "rope_base": 10_000, "tie_embeddings": False,
}
DRAFT_CFG = dict(CFG, n_layers=1, emb_dim=16, hidden_dim=32, head_dim=4)
# tests/test_spec_decoding.py's prompts: jax.random.randint(PRNGKey(key), (1, n), 0, 128)
PROMPT_KEYS = {"gamma": (2, 5), "perfect": (3, 4), "eos": (4, 5), "stochastic": (5, 5)}
# a prompt on which JAX's perfect draft is rejected once at γ 4 (its stale column)
STALE = np.random.default_rng(3).integers(1, 128, (1, 4))
MAX_GEN = 12
PROBS_TOL = 1e-6
TV_BOUND = 0.02  # the histograms' total-variation distance from the target's distribution
HYBRID_CFG = {
    "model_type": "qwen3_5_text", "vocab_size": 128, "emb_dim": 32, "hidden_dim": 64,
    "n_layers": 4, "linear_sdpa_ratio": 2, "n_heads": 4, "num_kv_groups": 2, "head_dim": 8,
    "rope_base": 10_000_000, "partial_rope_factor": 0.25, "context_length": 64,
    "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8,
    "linear_value_head_dim": 8, "linear_conv_kernel_size": 4,
    "tie_embeddings": False, "mrope_section": [1, 1, 0], "p_dropout": 0.0, "dtype": torch.float32,
}
NEXT_CFG = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 32, "n_layers": 2, "linear_sdpa_ratio": 2, "n_heads": 4,
    "head_dim": 8, "num_kv_groups": 2, "partial_rope_factor": 0.25, "rope_base": 10_000,
    "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8, "linear_value_head_dim": 8,
    "linear_conv_kernel_size": 4, "moe_hidden_dim": 64, "shared_expert_hidden_dim": 64, "num_experts": 4,
    "top_k": 2, "aux_loss_coef": 0.001, "tie_embeddings": False, "p_dropout": 0.0, "dtype": torch.float32,
}


def jcfg(cfg):
    return dict(cfg, dtype=jnp.float32)


def tcfg(cfg):
    return dict(cfg, dtype=torch.float32)


def port(params, cfg):
    return from_jax_flat({k: np.asarray(v) for k, v in flatten_params(params).items()}, tcfg(cfg), device="cpu")


def prompt(name):
    key, n = PROMPT_KEYS[name]
    return np.array(jax.random.randint(jax.random.PRNGKey(key), (1, n), 0, 128))


@pytest.fixture(scope="module")
def models():
    """(JAX target, JAX draft, port target, port draft)."""
    target = jq3.init(jax.random.PRNGKey(0), jcfg(CFG))
    draft = jq3.init(jax.random.PRNGKey(1), jcfg(DRAFT_CFG))
    return target, draft, port(target, CFG), port(draft, DRAFT_CFG)


@pytest.fixture(scope="module")
def jax_refs(models):
    """JAX's greedy speculative sequences at γ 1, 2, 4 (weak draft), its
    window count with the perfect draft on ``STALE``, and the plain greedy
    tokens of every prompt (one batched ``generate_batched_kv_cache``)."""
    jt, jd, _, _ = models
    out = {"gamma": {}}
    for gamma in (1, 2, 4):
        res = jspec.speculative_generate(jq3, jt, jcfg(CFG), jq3, jd, jcfg(DRAFT_CFG), jnp.asarray(prompt("gamma")),
                                         max_gen=MAX_GEN, draft_max_gen=gamma, temp=0.0)
        out["gamma"][gamma] = (np.asarray(res["sequences"][0]).tolist(), int(res["num_generated"]))
    res = jspec.speculative_generate(jq3, jt, jcfg(CFG), jq3, jt, jcfg(CFG), jnp.asarray(STALE),
                                     max_gen=15, draft_max_gen=4, temp=0.0)
    out["stale_steps"] = int(res["num_steps"])
    names = [*PROMPT_KEYS, "stale"]
    ids = np.zeros((len(names), 5), np.int32)
    mask = np.zeros((len(names), 5), bool)
    for j, n in enumerate(names):
        p = STALE[0] if n == "stale" else prompt(n)[0]
        ids[j, : len(p)], mask[j, : len(p)] = p, True
    seqs = jgen.generate_batched_kv_cache(jq3, jt, jcfg(CFG), jnp.asarray(ids), jnp.asarray(mask), max_gen=15,
                                          temp=0.0, eos_ids=-1, pad_id=0)["sequences"]
    out["plain"] = {n: np.asarray(seqs[j, 5:]).tolist() for j, n in enumerate(names)}
    return out


def generate(models, name, *, draft="weak", **kw):
    _, _, tt, td = models
    d, dcfg = (td, DRAFT_CFG) if draft == "weak" else (tt, CFG)
    kw = {"max_gen": MAX_GEN, "device": "cpu", **kw}
    ids = STALE if name == "stale" else prompt(name)
    return tspec.speculative_generate(tq3, tt, tcfg(CFG), tq3, d, tcfg(dcfg), ids, **kw)


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, None, None), (0.7, 5, None), (1.3, None, 0.9), (0.5, 20, 0.8)])
def test_modified_probs_matches_jax(temp, top_k, top_p):
    logits = np.random.default_rng(0).standard_normal((4, 3, 50)).astype(np.float32) * 3
    ref = jspec.modified_probs(jnp.asarray(logits), top_k=top_k, top_p=top_p, temp=temp)
    got = tspec.modified_probs(torch.from_numpy(logits), top_k=top_k, top_p=top_p, temp=temp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=PROBS_TOL)
    assert torch.equal(got > 0, torch.from_numpy(np.asarray(ref) > 0))  # the same kept sets


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_greedy_sequences_equal_jax(models, jax_refs, gamma):
    """test_greedy_spec_matches_plain_greedy: the speculative sequences equal
    JAX's and the plain greedy tokens."""
    out = generate(models, "gamma", draft_max_gen=gamma)
    seq, n = jax_refs["gamma"][gamma]
    assert out["sequences"][0].tolist() == seq
    assert int(out["num_generated"]) == n == MAX_GEN
    assert seq[5:] == jax_refs["plain"]["gamma"][:MAX_GEN]


@pytest.mark.parametrize("name", ["perfect", "stale"])
def test_perfect_draft_takes_ceil_windows_unlike_jax(models, jax_refs, name):
    """test_perfect_draft_accepts_everything: the target as its own draft
    commits γ + 1 a window, so 15 tokens at γ 4 take 3 windows, on that
    test's prompt and on ``STALE``, where JAX's takes more (the stale draft
    column; module docstring of the port's spec_decoding.py). The tokens
    equal the plain greedy ones."""
    out = generate(models, name, draft="self", max_gen=15, draft_max_gen=4)
    assert int(out["num_generated"]) == 15
    assert int(out["num_steps"]) == 3
    if name == "stale":
        assert jax_refs["stale_steps"] > 3
    assert out["sequences"][0, 4:].tolist() == jax_refs["plain"][name][:15]


@pytest.mark.parametrize("gamma,max_gen", [(1, 7), (2, 9), (3, 12)])
def test_perfect_draft_windows(models, gamma, max_gen):
    out = generate(models, "perfect", draft="self", max_gen=max_gen, draft_max_gen=gamma)
    assert int(out["num_generated"]) == max_gen
    assert int(out["num_steps"]) == -(-max_gen // (gamma + 1))


def test_eos_stops_generation(models, jax_refs):
    """test_eos_stops_generation: the 3rd plain greedy token as the EOS; the
    committed tokens end at it and equal the plain ones."""
    plain = jax_refs["plain"]["eos"]
    eos = plain[2]
    out = generate(models, "eos", draft_max_gen=2, eos_id=eos)
    n = int(out["num_generated"])
    committed = out["sequences"][0, 5 : 5 + n].tolist()
    assert committed[-1] == eos and eos not in committed[:-1]
    assert committed == plain[:n]


def test_stochastic_runs_and_is_plausible(models):
    """test_stochastic_spec_runs_and_is_plausible, and with the target as its
    own draft (p/q = 1) every window commits γ + 1."""
    gen = torch.Generator().manual_seed(7)
    out = generate(models, "stochastic", max_gen=10, draft_max_gen=3, temp=0.8, top_k=40, generator=gen)
    assert int(out["num_generated"]) == 10
    toks = out["sequences"][0, 5:15]
    assert bool(((toks >= 0) & (toks < 128)).all())
    assert int(out["num_steps"]) <= 10
    out = generate(models, "stochastic", draft="self", max_gen=12, draft_max_gen=3, temp=0.8, top_k=40,
                   generator=torch.Generator().manual_seed(3))
    assert int(out["num_generated"]) == 12 and int(out["num_steps"]) == 3


def test_acceptance_rule_keeps_the_target_distribution():
    """``accept_window`` over 50,000 rows of one window (γ 2, vocabulary 8):
    drafts drawn from the draft's distribution q, target distributions p =
    ``modified_probs`` (temp 0.8, top-k 6). The first committed token (the
    accepted draft, else the correction) has p[0]'s histogram, and the second
    (over the rows that accepted the first) p[1]'s, within TV_BOUND; the
    drafted tokens themselves read beyond it (the bound sees a wrong rule)."""
    rows, gamma, v = 50_000, 2, 8
    rng = np.random.default_rng(0)
    t_logits = torch.from_numpy(rng.standard_normal((gamma + 1, v)).astype(np.float32) * 1.5)
    p = tspec.modified_probs(t_logits, temp=0.8, top_k=6)
    q = torch.softmax(torch.from_numpy(rng.standard_normal((gamma, v)).astype(np.float32)), dim=-1)
    gen = torch.Generator().manual_seed(0)
    drafted = torch.stack([torch.multinomial(q[i], rows, replacement=True, generator=gen) for i in range(gamma)],
                          dim=1)
    n, corr = tspec.accept_window(gen, p.expand(rows, -1, -1), q.expand(rows, -1, -1), drafted)
    first = torch.where(n > 0, drafted[:, 0], corr)
    second = torch.where(n > 1, drafted[:, 1], corr)[n > 0]

    def tv(tokens, probs):
        return 0.5 * float((torch.bincount(tokens, minlength=v).float() / len(tokens) - probs).abs().sum())

    assert tv(first, p[0]) <= TV_BOUND
    assert len(second) > rows // 4 and tv(second, p[1]) <= TV_BOUND
    assert tv(drafted[:, 0], p[0]) > TV_BOUND and tv(drafted[:, 1], p[1]) > TV_BOUND
    assert 0 < int((n == gamma).sum()) < rows  # the bonus and the resamples both ran


def test_greedy_acceptance_takes_the_longest_matching_prefix():
    t_logits = torch.full((3, 4, 6), -1.0)
    choice = torch.tensor([[1, 2, 3, 4], [1, 5, 3, 4], [0, 2, 3, 5]])
    t_logits.scatter_(2, choice[..., None], 1.0)
    drafted = torch.tensor([[1, 2, 3], [1, 2, 3], [1, 2, 3]])
    n, corr = tspec.accept_greedy(t_logits, drafted)
    assert n.tolist() == [3, 1, 0] and corr.tolist() == [4, 5, 0]


@pytest.mark.parametrize("role", ["target", "draft"])
def test_recurrent_caches_served(models, jax_refs, role):
    """A Qwen3.5 target (with the weak dense draft) or a Qwen3-Next draft
    (with the dense target): their caches hold GDN states and conv taps,
    which each window rolls back to the committed tokens, and the greedy
    tokens equal plain decoding's (the hybrid's ``generate_kv_cache``; JAX's
    for the dense target)."""
    _, _, tt, td = models
    ids = prompt("gamma")
    if role == "target":
        hybrid = tq35.init_text(HYBRID_CFG, generator=torch.Generator().manual_seed(0), device="cpu")
        args = (tq35.TextOnly, hybrid, HYBRID_CFG, tq3, td, tcfg(DRAFT_CFG))
        ref = tgen.generate_kv_cache(tq35.TextOnly, hybrid, HYBRID_CFG, torch.as_tensor(ids).long(), max_gen=MAX_GEN,
                                     temp=0.0, eos_ids=-1, pad_id=0)["sequences"][0, ids.shape[1]:].tolist()
    else:
        nxt = tqn.init(NEXT_CFG, generator=torch.Generator().manual_seed(0), device="cpu")
        args = (tq3, tt, tcfg(CFG), tqn, nxt, NEXT_CFG)
        ref = jax_refs["plain"]["gamma"][:MAX_GEN]
    out = tspec.speculative_generate(*args, ids, max_gen=MAX_GEN, draft_max_gen=2, device="cpu")
    assert out["sequences"][0, ids.shape[1]:].tolist() == ref


def test_default_device_is_the_card(models):
    """``device=None`` means the card: without one it raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(models, "gamma", draft_max_gen=2, device=None)
