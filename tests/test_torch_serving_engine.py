"""The ported continuous-batching engine and the pieces it stands on, against
the JAX package, on the CPU in fp32.

- per-row ``causal_mask`` / ``cur_token_mask`` and vector-position cache
  writes (fp32 and int8 caches, s 1 and 3) against JAX's and a numpy loop,
  exactly;
- ``filter_probs_per_row`` keep-sets against JAX's exact-head filter, and
  ``sampling_per_row`` against the port's scalar sampler;
- one decode step of the hybrid Qwen3.5 text model and of the dense Qwen3 at
  per-row positions against JAX's, within 1e-4;
- the engine's tokens against JAX's ``ContinuousBatchingEngine`` at
  ``tests/test_serving.py``'s tiny configs (the hybrid ``HYBRID_CFG``, the
  dense ``CFG``, and int8 weights with the int8 KV cache at head dim 128,
  where both route decode attention through K10: the plain version here, the
  Pallas kernel in interpret mode in JAX), through slot reuse, mid-flight
  admission, EOS retirement and early exit; per-request sampling,
  logprobs, cancel and stats.

Each JAX engine runs once per module (``jax_runs``): its programs compile
once per shape, and the dense engines share their admission programs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import cache as jcache
from llm_quest_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from llm_quest_tpu.models import qwen3 as jdense
from llm_quest_tpu.models import qwen3_5 as jq
from llm_quest_tpu.ops import masks as jmasks
from llm_quest_tpu.ops import sampling as jsamp
from llm_quest_tpu.ops.quantization import quantize_params_int8
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import cache as tcache
from llm_quest_tpu_torch.inference import serving
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
from llm_quest_tpu_torch.models import qwen3 as tdense
from llm_quest_tpu_torch.models import qwen3_5 as tq
from llm_quest_tpu_torch.ops import masks as tmasks
from llm_quest_tpu_torch.ops import sampling as tsamp
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TOL = 1e-4

# tests/test_serving.py's configs
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
# head dim 128 so that both packages stream the int8 cache through K10
INT8_CFG = dict(HYBRID_CFG, head_dim=128, mrope_section=[6, 5, 5], kv_quant="int8")


class JaxText:
    apply = staticmethod(jq.apply_text)
    init_cache = staticmethod(jq.init_cache)


def jcfg(cfg):
    return dict(cfg, dtype=jnp.float32)


def tcfg(cfg):
    return dict(cfg, dtype=torch.float32)


def port(params, cfg):
    return from_jax_flat({k: np.asarray(v) for k, v in flatten_params(params).items()}, tcfg(cfg), device="cpu")


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, JAX params, port model, port params, cfg)}."""
    dense = jdense.init(jax.random.PRNGKey(0), jcfg(CFG))
    hybrid = jq.init_text(jax.random.PRNGKey(0), jcfg(HYBRID_CFG))
    int8 = quantize_params_int8(jq.init_text(jax.random.PRNGKey(2), jcfg(INT8_CFG)), min_size=0)
    return {
        "dense": (jdense, dense, tdense, port(dense, CFG), CFG),
        "hybrid": (JaxText, hybrid, tq.TextOnly, port(hybrid, HYBRID_CFG), HYBRID_CFG),
        "int8": (JaxText, int8, tq.TextOnly, port(int8, INT8_CFG), INT8_CFG),
    }


def engine(side, models, name, **kw):
    jm, jp, tm, tp, cfg = models[name]
    args = dict(n_slots=2, max_len=32, decode_chunk=3, prefill_buckets=(8, 16), temp=0.0, eos_ids=-1, pad_id=0)
    args.update(kw)
    if side == "jax":
        return JaxEngine(jm, jp, jcfg(cfg), **args)
    return ContinuousBatchingEngine(tm, tp, tcfg(cfg), device="cpu", **args)


_rng = np.random.default_rng(0)
PROMPTS = [_rng.integers(1, 128, size=n).tolist() for n in (3, 7, 5, 12, 4)]
GENS = [6, 10, 4, 8, 5]


def scenario(eng):
    """5 requests through 2 slots (slot reuse): 3 submitted, one scheduler
    step, then 2 more (mid-flight admission); budgets end inside chunks, so
    the last chunks exit early. Returns each request's raw tokens."""
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS[:3], GENS[:3])]
    eng.step()
    rids += [eng.submit(p, g) for p, g in zip(PROMPTS[3:], GENS[3:])]
    while eng.step():
        pass
    return [eng._requests[r].tokens for r in rids]


def cancel_scenario(eng):
    """tests/test_serving.py::test_serving_cancel's schedule."""
    rids = [eng.submit(p, 10) for p in PROMPTS[:4]]
    eng.step()
    assert eng.cancel(rids[2])  # still queued: never admits
    eng.step()
    assert eng.cancel(rids[1])  # resident: its slot frees for rids[3]
    assert not eng.cancel(rids[1])
    while eng.step():
        pass
    return [eng._requests[r].tokens for r in rids]


def sampling_scenario(eng):
    """tests/test_serving.py::test_serving_per_request_sampling's requests:
    a greedy override, the engine default, top_k 1 and a top-p row."""
    rids = [
        eng.submit(PROMPTS[0], 6, temp=0.0),
        eng.submit(PROMPTS[1], 8),
        eng.submit(PROMPTS[2], 7, temp=0.8, top_k=1),
        eng.submit(PROMPTS[4], 5, temp=1.2, top_p=0.9, top_k=None),
    ]
    while eng.step():
        pass
    return [eng._requests[r].tokens for r in rids]


def logprob_scenario(eng):
    rids = [eng.submit(p, g) for p, g in zip(PROMPTS[:3], GENS[:3])]
    while eng.step():
        pass
    return [eng._requests[r].tokens for r in rids], [eng.request_logprobs(r) for r in rids]


SAMPLE_KW = dict(temp=0.9, top_k=20, per_request_sampling=True)
EARLY_KW = dict(n_slots=4, decode_chunk=16, prefill_buckets=(8,))


def run_all(side, models):
    """Every engine run of the module on one side."""
    out = {}
    for name in ("hybrid", "dense", "int8"):
        free = scenario(engine(side, models, name))
        out[name] = free
        eos = free[1][3]  # an EOS on request 1's 4th token
        out[name + "_eos"] = (eos, scenario(engine(side, models, name, eos_ids=eos)))
    out["early_exit"] = engine(side, models, "dense", **EARLY_KW).serve(list(zip(PROMPTS[:3], (3, 5, 2))))
    out["cancel"] = cancel_scenario(engine(side, models, "dense", pipeline_depth=1))
    out["sampling"] = sampling_scenario(engine(side, models, "dense", **SAMPLE_KW))
    out["logprobs"] = logprob_scenario(engine(side, models, "dense", return_logprobs=True))
    eng = engine(side, models, "dense", pipeline_depth=1)  # one schedule on both sides (the port's default)
    eng.serve(list(zip(PROMPTS, GENS)))
    out["stats"] = eng.stats()
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return run_all("jax", models)


@pytest.fixture(scope="module")
def port_runs(models):
    return run_all("port", models)


# ----------------------------------------------------------------- masks


@pytest.mark.parametrize("window", [None, 3])
def test_causal_mask_per_row_matches_jax(window):
    rng = np.random.default_rng(1)
    q_start = rng.integers(0, 12, size=4)
    attn = rng.random((4, 16)) > 0.3
    for q_len in (1, 3):
        ref = jmasks.causal_mask(q_len, 16, q_start=jnp.asarray(q_start), window_size=window,
                                 attn_mask=jnp.asarray(attn))
        got = tmasks.causal_mask(q_len, 16, q_start=torch.from_numpy(q_start), window_size=window,
                                 attn_mask=torch.from_numpy(attn))
        assert got.shape == (4, 1, q_len, 16)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_cur_token_mask_per_row_matches_jax():
    rng = np.random.default_rng(2)
    attn = rng.random((4, 16)) > 0.5
    pos = rng.integers(0, 14, size=4)
    for s in (1, 3):
        ref = jcache.cur_token_mask(jnp.asarray(attn), s, jnp.asarray(pos))
        got = tcache.cur_token_mask(torch.from_numpy(attn), s, torch.from_numpy(pos))
        assert np.array_equal(got.numpy(), np.asarray(ref))


# ----------------------------------------------------------- cache writes


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_vector_pos_writes_match_jax_and_numpy(s, quant):
    """write_layer at per-row columns into layer 1 of a 2-layer cache: every
    buffer equal to JAX's write_layer (and, fp32, to a numpy loop); the
    other layer untouched."""
    rng = np.random.default_rng(3 + s)
    b, h, S, d = 4, 2, 16, 8
    k_new, v_new = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, S - s + 1, size=b)
    jc = jcache.init_kv_cache(2, b, h, S, d, quant=quant)
    tc = tcache.init_kv_cache(2, b, h, S, d, quant=quant, device="cpu")
    if quant is None:  # start from a nonzero buffer
        start = rng.standard_normal((2, b, h, S, d)).astype(np.float32)
        jc = {**jc, "k": jnp.asarray(start), "v": jnp.asarray(start)}
        tc["k"].copy_(torch.from_numpy(start))
        tc["v"].copy_(torch.from_numpy(start))
    jc, _, _ = jcache.write_layer(jc, 1, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos))
    tc, _, _ = tcache.write_layer(tc, 1, torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(pos))
    for name in ("k", "v") if quant is None else ("k_q", "k_s", "v_q", "v_s"):
        assert np.array_equal(tc[name].numpy(), np.asarray(jc[name])), name
    if quant is None:
        ref = start.copy()
        for r in range(b):
            ref[1, r, :, pos[r] : pos[r] + s] = k_new[r]
        assert np.array_equal(tc["k"].numpy(), ref)


def test_write_kv_first_heads_only():
    """A new block with fewer heads than the buffer writes only its first h
    head rows, at scalar and per-row columns, as JAX's write_kv does."""
    rng = np.random.default_rng(5)
    buf = rng.standard_normal((2, 3, 4, 10, 8)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    for pos in (4, np.asarray([0, 5, 8])):
        ref = jcache.write_kv(jnp.asarray(buf), jnp.asarray(new), 1, jnp.asarray(pos))
        got = tcache.write_kv(torch.from_numpy(buf.copy()), torch.from_numpy(new), 1,
                              torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos)
        assert np.array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- sampling


def mixed_rows(v=128, seed=6):
    """Probabilities of 8 rows and a knob set a row: disabled, top-k, top-p,
    top-k + top-p, min-p, min-p with top-k as min_tokens_to_keep, top-k
    above the nucleus, top-p near 1."""
    logits = 2.0 * np.random.default_rng(seed).standard_normal((8, v)).astype(np.float32)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_k = np.asarray([0, 5, 0, 7, 0, 40, 60, 0])
    top_p = np.asarray([2.0, 2.0, 0.8, 0.6, 2.0, 2.0, 0.5, 0.999], np.float32)
    min_p = np.asarray([0, 0, 0, 0, 0.05, 0.2, 0, 0], np.float32)
    return probs, top_k, top_p, min_p


def test_filter_probs_per_row_keep_sets_match_jax():
    probs, top_k, top_p, min_p = mixed_rows()
    ref = jsamp.filter_probs_per_row(jnp.asarray(probs), top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p),
                                     min_p=jnp.asarray(min_p), exact_head=True)
    got = tsamp.filter_probs_per_row(torch.from_numpy(probs), top_k=torch.from_numpy(top_k),
                                     top_p=torch.from_numpy(top_p), min_p=torch.from_numpy(min_p))
    assert np.array_equal(got.numpy() > 0, np.asarray(ref) > 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert 1 < int((got[2] > 0).sum()) < 128  # the filters cut something


@pytest.mark.parametrize("knobs", [
    dict(temp=0.7), dict(temp=1.0, top_k=5), dict(temp=0.8, top_p=0.9), dict(temp=0.8, top_k=20, top_p=0.7),
    dict(temp=1.1, min_p=0.1), dict(temp=1.1, min_p=0.1, top_k=3),
], ids=["temp", "top_k", "top_p", "top_k_top_p", "min_p", "min_p_top_k"])
def test_sampling_per_row_uniform_rows_equal_scalar(knobs):
    """Every row with the same knobs: the per-row draws equal the scalar
    sampler's under the same generator state."""
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal((16, 300)).astype(np.float32) * 3)
    b = logits.shape[0]
    rows = dict(temp=torch.full((b,), knobs["temp"]), top_k=torch.full((b,), knobs.get("top_k") or 0),
                top_p=torch.full((b,), knobs.get("top_p") or 2.0), min_p=torch.full((b,), knobs.get("min_p") or 0.0))
    for seed in range(3):
        ref = tsamp.sampling(torch.Generator().manual_seed(seed), logits, **knobs)
        got = tsamp.sampling_per_row(torch.Generator().manual_seed(seed), logits, **rows)
        assert torch.equal(got, ref), seed


def test_sampling_draw_is_multinomial():
    """``draw`` is ``torch.multinomial(probs, 1)``'s draw, without its host
    read."""
    probs = torch.softmax(torch.from_numpy(np.random.default_rng(8).standard_normal((64, 500)).astype(np.float32)), -1)
    ref = torch.multinomial(probs, 1, generator=torch.Generator().manual_seed(4))[:, 0]
    assert torch.equal(tsamp.draw(torch.Generator().manual_seed(4), probs), ref)


def test_sampling_per_row_greedy_rows_are_argmax():
    """temp 0 rows (any other knobs) and temp > 0 rows with top_k 1 are the
    argmax of the raw logits; the other rows draw."""
    logits = torch.from_numpy(np.random.default_rng(9).standard_normal((6, 200)).astype(np.float32) * 4)
    temp = torch.tensor([0.0, 0.0, 0.9, 1.5, 0.7, 1.0])
    top_k = torch.tensor([0, 10, 1, 1, 0, 50])
    top_p = torch.tensor([2.0, 0.5, 2.0, 0.9, 0.9, 2.0])
    min_p = torch.zeros(6)
    for seed in range(5):
        got = tsamp.sampling_per_row(torch.Generator().manual_seed(seed), logits, temp=temp, top_k=top_k,
                                     top_p=top_p, min_p=min_p)
        assert torch.equal(got[:4], logits[:4].argmax(-1))
        assert bool(((got >= 0) & (got < 200)).all())


def test_top_k_above_head_keeps_the_scalar_set():
    """top_k 2000 over 4096 tokens keeps exactly the scalar filter's 2000
    tokens (the head grows to the largest top_k), where JAX's per-row filter
    clamps it to its 1024-entry head."""
    probs = torch.softmax(torch.from_numpy(np.random.default_rng(10).standard_normal((2, 4096)).astype(np.float32)),
                          -1)
    ref = tsamp.filter_probs(probs, top_k=2000)
    got = tsamp.filter_probs_per_row(probs, top_k=torch.tensor([2000, 2000]), top_p=torch.full((2,), 2.0))
    assert torch.equal(got > 0, ref > 0) and int((got[0] > 0).sum()) == 2000
    jax_kept = jsamp.filter_probs_per_row(jnp.asarray(probs.numpy()), top_k=jnp.asarray([2000, 2000]),
                                          top_p=jnp.full((2,), 2.0), exact_head=True)
    assert int((np.asarray(jax_kept[0]) > 0).sum()) == 1024


# ------------------------------------------------- per-row decode step


@pytest.mark.parametrize("name", ["hybrid", "dense"])
@torch.no_grad()
def test_decode_step_at_per_row_positions_matches_jax(models, name):
    """A right-padded prefill of 3 rows (real lengths 5, 8, 3), then two
    decode steps with the cache pointer a per-row vector (each row at its
    own column): logits within 1e-4 of JAX's at every call."""
    jm, jp, tm, tp, cfg = models[name]
    japply = jax.jit(lambda ids, mask, cache, pos_ids: jm.apply(jp, jcfg(cfg), ids, attn_mask=mask, cache=cache,
                                                                position_ids=pos_ids))
    b, lb, S = 3, 8, 16
    real = np.asarray([5, 8, 3])
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 128, (b, lb))
    mask = np.zeros((b, S), bool)
    mask[:, :lb] = np.arange(lb)[None, :] < real[:, None]
    jc = jm.init_cache(jcfg(cfg), b, S)
    tc = tm.init_cache(tcfg(cfg), b, S, device="cpu")
    jl, jc, _ = japply(jnp.asarray(ids), jnp.asarray(mask), jc, None)
    tl, tc, _ = tm.apply(tp, tcfg(cfg), torch.from_numpy(ids), attn_mask=torch.from_numpy(mask), cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    pos = real.copy()
    for _ in range(2):
        tok = rng.integers(1, 128, (b, 1))
        mask[np.arange(b), pos] = True
        jl, jc, _ = japply(jnp.asarray(tok), jnp.asarray(mask), {**jc, "pos": jnp.asarray(pos)},
                           jnp.asarray(pos[:, None]))
        tl, tc, _ = tm.apply(tp, tcfg(cfg), torch.from_numpy(tok), attn_mask=torch.from_numpy(mask),
                             cache={**tc, "pos": torch.from_numpy(pos)}, position_ids=torch.from_numpy(pos[:, None]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        pos = pos + 1


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("name", ["hybrid", "dense", "int8"])
def test_engine_greedy_tokens_equal_jax(jax_runs, port_runs, name):
    """Slot reuse, mid-flight admission and early exit; then the same with an
    EOS that retires request 1 on its 4th token and frees its slot."""
    assert port_runs[name] == jax_runs[name]
    assert [len(t) for t in port_runs[name]] == GENS
    eos, toks = port_runs[name + "_eos"]
    assert port_runs[name + "_eos"] == jax_runs[name + "_eos"]
    cut = toks[1].index(eos)
    assert cut <= 3 and toks[1][cut + 1 :] == [0] * (len(toks[1]) - cut - 1)


def test_engine_early_exit(jax_runs, port_runs, models):
    """decode_chunk 16 against budgets 3, 5, 2: JAX's tokens, and the port's
    chunk stops one step after the pool is all finished (the admission and
    6 decode steps: the 5 the budgets need and one), not after 16."""
    assert port_runs["early_exit"] == jax_runs["early_exit"]
    assert [len(t) for t in port_runs["early_exit"]] == [3, 5, 2]
    eng = engine("port", models, "dense", pipeline_depth=1, **EARLY_KW)
    calls = []
    apply = eng.model.apply

    class Counted:
        init_cache = staticmethod(eng.model.init_cache)

        @staticmethod
        def apply(*args, **kwargs):
            calls.append(args[2].shape)
            return apply(*args, **kwargs)

    eng.model = Counted
    assert eng.serve([(PROMPTS[0], 3), (PROMPTS[1], 5)]) == jax_runs["early_exit"][:2]
    assert [shape[1] for shape in calls] == [8, 1, 1, 1, 1, 1, 1]
    assert eng.stats()["decode_chunks"] == 1


def test_engine_pipeline_depths(jax_runs, models):
    """pipeline_depth 1 and 2 and "auto" (which means 1, also after
    ``warmup``) serve JAX's tokens."""
    for depth in (1, 2, "auto"):
        eng = engine("port", models, "hybrid", pipeline_depth=depth)
        if depth == "auto":
            eng.warmup()
            assert eng.pipeline_depth == 1
        assert scenario(eng) == jax_runs["hybrid"], depth


def test_engine_warmup_restores_the_pool(jax_runs, models):
    """``warmup`` with chunks as long as half the columns (two warm chunks
    from the admitted column stay in range), then the pool, the sampler
    table and the generator are as before it and the serve is JAX's."""
    eng = engine("port", models, "dense", generator=torch.Generator().manual_seed(9), **EARLY_KW)
    before = serving._clone(eng.state), eng.generator.get_state()
    eng.warmup()
    for name in ("mask_buf", "last_logits", "seqpos", "finished", "budget"):
        assert torch.equal(eng.state[name], before[0][name]), name
    assert all(torch.equal(eng.state["cache"][k], v) for k, v in before[0]["cache"].items())
    assert torch.equal(eng.generator.get_state(), before[1])
    assert eng.serve(list(zip(PROMPTS[:3], (3, 5, 2)))) == jax_runs["early_exit"]


def test_engine_per_request_sampling(jax_runs, port_runs):
    """In a pool with stochastic rows, the greedy override and the top_k 1
    row equal JAX's greedy rows; the stochastic rows are valid tokens of
    their budget's length."""
    got, ref = port_runs["sampling"], jax_runs["sampling"]
    assert got[0] == ref[0] and got[2] == ref[2]
    for toks, n in ((got[1], 8), (got[3], 5)):
        assert len(toks) == n and all(0 <= t < 128 for t in toks)


def test_engine_sampling_reproducible_and_seeded(models):
    """The same generator seed gives the same stochastic tokens; another
    seed other ones."""
    def run(seed):
        eng = engine("port", models, "dense", generator=torch.Generator().manual_seed(seed), **SAMPLE_KW)
        return sampling_scenario(eng)

    assert run(3) == run(3)
    assert run(3) != run(4)


def test_engine_request_logprobs(jax_runs, port_runs):
    (tt, tl), (jt, jl) = port_runs["logprobs"], jax_runs["logprobs"]
    assert tt == jt
    for got, ref in zip(tl, jl):
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_engine_cancel(jax_runs, port_runs):
    """A queued request cancelled never admits; a resident one frees its slot
    for the next; the survivors' tokens equal JAX's."""
    got = port_runs["cancel"]
    assert got == jax_runs["cancel"]
    assert got[2] == [] and len(got[1]) < 10 and len(got[0]) == len(got[3]) == 10


def test_engine_stats_keys(jax_runs, port_runs):
    got, ref = port_runs["stats"], jax_runs["stats"]
    assert set(got) == set(ref)
    for key in ("requests_submitted", "requests_completed", "tokens_generated", "admit_waves"):
        assert got[key] == ref[key], key
    assert 0.0 < got["slot_utilization"] <= 1.0 and got["ttft_p50_s"] > 0


def test_engine_refuses_later_slices_and_bad_requests(models):
    _, _, tm, tp, cfg = models["dense"]
    base = dict(n_slots=2, max_len=32, prefill_buckets=(8,), device="cpu")
    for kw in (dict(mesh=object()), dict(param_rules=[]), dict(draft_param_rules=[])):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            ContinuousBatchingEngine(tm, tp, tcfg(cfg), **base, **kw)
    # speculation is served (test_torch_serving_spec.py): a draft needs its
    # weights and config, and JAX's default gamma alone builds the plain engine
    with pytest.raises(ValueError, match="draft_params and draft_cfg"):
        ContinuousBatchingEngine(tm, tp, tcfg(cfg), **base, draft_model=tm)
    assert not ContinuousBatchingEngine(tm, tp, tcfg(cfg), **base, gamma=4)._spec
    with pytest.raises(NotImplementedError, match="expert_parallel"):
        ContinuousBatchingEngine(tm, tp, dict(tcfg(cfg), expert_parallel={}), **base)
    eng = ContinuousBatchingEngine(tm, tp, tcfg(cfg), **base)
    # multi-LoRA is served (test_torch_serving_lora.py); params without
    # stacked adapters refuse adapter= with JAX's ValueError
    with pytest.raises(ValueError, match="no stacked adapters"):
        eng.submit(PROMPTS[0], 4, adapter=0)
    with pytest.raises(ValueError, match="no stacked adapters"):
        eng.register_prefix(PROMPTS[0], adapter=0)
    with pytest.raises(ValueError, match="per_request_sampling"):
        eng.submit(PROMPTS[0], 4, temp=0.5)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        eng.submit(list(range(9)), 4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(PROMPTS[0], 30)
    sampled = ContinuousBatchingEngine(tm, tp, tcfg(cfg), per_request_sampling=True, **base)
    with pytest.raises(ValueError, match="top_p and min_p"):
        sampled.submit(PROMPTS[0], 4, top_p=0.9, min_p=0.1)


@pytest.mark.parametrize("feature", ["prefill_chunk", "pixel_transform", "prefix", "pixels"])
def test_engine_takes_the_admission_paths_ported_since(models, feature):
    """The features the refusal test used to name are taken now (their
    tokens against JAX's: test_torch_serving_admission.py and
    test_torch_serving_vlm.py)."""
    _, _, tm, tp, cfg = models["dense"]
    base = dict(n_slots=2, max_len=32, prefill_buckets=(8,), device="cpu")
    if feature == "prefill_chunk":
        assert ContinuousBatchingEngine(tm, tp, tcfg(cfg), **base, prefill_chunk=8)._bucket_len(9) == 16
        return
    if feature == "pixel_transform":
        assert ContinuousBatchingEngine(tm, tp, tcfg(cfg), **base, pixel_transform=abs)._pixel_transform is abs
        return
    eng = ContinuousBatchingEngine(tm, tp, tcfg(cfg), **base)
    if feature == "prefix":
        rid = eng.submit(PROMPTS[0], 4, prefix=eng.register_prefix(PROMPTS[1]))
    else:
        rid = eng.submit(PROMPTS[0], 4, pixels=np.zeros(3))
        assert eng._requests[rid].pixels_dev is not None  # uploaded at submit
    assert eng._queue[-1] is eng._requests[rid]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a CUDA device")
def test_engine_defaults_to_the_card(models):
    _, _, tm, tp, cfg = models["dense"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(tm, tp, tcfg(cfg), n_slots=2, max_len=32)


def test_insert_rows_by_position():
    """Rows land on the batch axis even when the layer count equals the slot
    count (axis 1 of a stacked leaf, axis 0 of ``pos``)."""
    big = torch.zeros(2, 2, 3)
    serving._insert_rows(big, torch.ones(2, 1, 3), torch.tensor([1]))
    assert big[:, 1].eq(1).all() and big[:, 0].eq(0).all()
    pos = torch.zeros(4, dtype=torch.long)
    serving._insert_rows(pos, torch.tensor([7, 9]), torch.tensor([3, 0]))
    assert pos.tolist() == [9, 0, 0, 7]
