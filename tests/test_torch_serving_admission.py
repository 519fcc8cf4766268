"""The ported engine's chunked and prefix admissions against the JAX engine,
on the CPU in fp32, at ``tests/test_serving.py``'s tiny configs (the dense
``CFG`` and the hybrid ``HYBRID_CFG``).

- chunked prefill (``prefill_chunk`` 8 over bucket 8): a wave whose rows
  end in different chunks (admitted by hand, as ``step`` never groups
  them), long prompts sharing the pool with a short one, and the hybrid's
  conv taps and recurrent state carried from chunk to chunk;
- prefix caching: two prefixes with budgets beside a plain request, the
  hybrid's prefix with a suffix shorter than the conv window; the stored
  row unchanged, bit for bit, after its waves;
- the greedy tokens equal JAX's; the first admission's logits and cache
  rows within 1e-4 of JAX's, and a chunked admission's logits within 1e-4
  of the port's one-shot prefill of the same prompt;
- the refusals: a prefix that leaves no room, a suffix whose budget does
  not fit behind its prefix.

Each engine runs once a side per module (``runs``): JAX's admission
programs compile once per shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from llm_quest_tpu.models import qwen3 as jdense
from llm_quest_tpu.models import qwen3_5 as jq
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine
from llm_quest_tpu_torch.models import qwen3 as tdense
from llm_quest_tpu_torch.models import qwen3_5 as tq
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
ENGINE = dict(n_slots=2, max_len=40, decode_chunk=3, prefill_buckets=(8,), temp=0.0, eos_ids=-1, pad_id=0)
CHUNKED = dict(ENGINE, prefill_chunk=8)


class JaxText:
    apply = staticmethod(jq.apply_text)
    init_cache = staticmethod(jq.init_cache)


def port(params, cfg):
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    return from_jax_flat(flat, dict(cfg, dtype=torch.float32), device="cpu")


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, JAX params, port model, port params, cfg)}."""
    dense = jdense.init(jax.random.PRNGKey(9), dict(CFG, dtype=jnp.float32))
    hybrid = jq.init_text(jax.random.PRNGKey(0), dict(HYBRID_CFG, dtype=jnp.float32))
    return {
        "dense": (jdense, dense, tdense, port(dense, CFG), CFG),
        "hybrid": (JaxText, hybrid, tq.TextOnly, port(hybrid, HYBRID_CFG), HYBRID_CFG),
    }


def engine(side, models, name, **kw):
    jm, jp, tm, tp, cfg = models[name]
    if side == "jax":
        return JaxEngine(jm, jp, dict(cfg, dtype=jnp.float32), **kw)
    return ContinuousBatchingEngine(tm, tp, dict(cfg, dtype=torch.float32), device="cpu", **kw)


_rng = np.random.default_rng(18)
LONG_A = _rng.integers(1, 128, size=20).tolist()  # 3 chunks of 8
LONG_B = _rng.integers(1, 128, size=17).tolist()  # ends in chunk 3, column 0
MID = _rng.integers(1, 128, size=9).tolist()  # 2 chunks
SHORT = _rng.integers(1, 128, size=5).tolist()
_rng = np.random.default_rng(8)
PREFIX_A = _rng.integers(1, 128, size=5).tolist()
PREFIX_B = _rng.integers(1, 128, size=9).tolist()
SUFFIXES = [_rng.integers(1, 128, size=n).tolist() for n in (4, 3, 6, 2)]
PLAIN = _rng.integers(1, 128, size=4).tolist()
_rng = np.random.default_rng(11)
HYB_PREFIX = _rng.integers(1, 128, size=7).tolist()  # longer than the conv window (k - 1 = 3)
HYB_SUFFIXES = [_rng.integers(1, 128, size=2).tolist(),  # shorter: the state reaches back into the taps
                _rng.integers(1, 128, size=6).tolist()]


def jax_admit_pending(eng):
    """The admission part of the JAX engine's ``step`` (its grouping of one
    take into waves), without the decode chunk that follows it there."""
    free = [s for s in range(eng.n_slots) if eng._slot_req[s] is None]
    take = [eng._queue.popleft() for _ in range(min(len(free), len(eng._queue)))]
    groups = {}
    for r in take:
        if r.prefix is None and len(r.ids) > eng.buckets[-1]:
            groups.setdefault(("chunked", eng._bucket_len(len(r.ids)) // eng.prefill_chunk), []).append(r)
        else:
            groups.setdefault(r.prefix, []).append(r)
    for key, reqs in groups.items():
        slots, free = free[: len(reqs)], free[len(reqs):]
        if isinstance(key, tuple):
            eng._admit_group_chunked(reqs, slots)
        elif key is None:
            eng._admit_group(reqs, slots)
        else:
            eng._admit_group_prefix(key, reqs, slots)


def snapshot(eng, rows):
    """The admitted rows' last-token logits and every cache leaf's rows, as
    numpy (the batch axis: axis 1 of the stacked leaves, axis 0 of pos)."""
    st = eng.state
    out = {"logits": np.asarray(st["last_logits"])[rows], "seqpos": np.asarray(st["seqpos"])[rows]}
    for name, leaf in st["cache"].items():
        leaf = np.asarray(leaf)
        out[f"cache/{name}"] = leaf[rows] if leaf.ndim == 1 else leaf[:, rows]
    return out


def first_wave(side, eng, submits, *, by_hand=None):
    """Submit ``submits`` ((ids, max_gen[, prefix]) each), admit the first
    wave (``by_hand``: these request indices as one wave, as ``step`` would
    not group them), read it, then step to the end. Returns (tokens a
    request, the first wave's snapshot)."""
    rids = [eng.submit(*req) for req in submits]
    if by_hand is not None:
        reqs = [eng._requests[rids[i]] for i in by_hand]
        for r in reqs:
            eng._queue.remove(r)
        slots = list(range(len(reqs)))
        if side == "jax":
            eng._admit_group_chunked(reqs, slots)
        else:
            eng._admit_group(reqs, slots)
        rows = slots
    else:
        if side == "jax":
            jax_admit_pending(eng)
        else:
            eng._admit_pending()
        rows = [s for s in range(eng.n_slots) if eng._slot_req[s] is not None]
    snap = snapshot(eng, rows)
    while eng.step():
        pass
    return [eng._requests[r].tokens for r in rids], snap


def run_all(side, models):
    out = {}
    out["chunked_mixed"] = first_wave(side, engine(side, models, "dense", **CHUNKED),
                                      [(LONG_A, 6), (MID, 6)], by_hand=[0, 1])
    out["chunked_pool"] = first_wave(side, engine(side, models, "dense", **CHUNKED),
                                     [(LONG_A, 6), (LONG_B, 6), (SHORT, 6)])
    out["chunked_hybrid"] = first_wave(side, engine(side, models, "hybrid", **dict(CHUNKED, n_slots=1)),
                                       [(LONG_A, 6)])
    eng = engine(side, models, "dense", **dict(ENGINE, decode_chunk=2))
    ia, ib = eng.register_prefix(PREFIX_A), eng.register_prefix(PREFIX_B)
    if side == "port":
        out["stored"] = [{name: t.clone() if torch.is_tensor(t) else t for name, t in eng._prefixes[p][0].items()}
                         for p in (ia, ib)]
    out["prefix"] = first_wave(side, eng, [(SUFFIXES[0], 5, ia), (SUFFIXES[1], 8, ib), (PLAIN, 6),
                                           (SUFFIXES[2], 5, ia), (SUFFIXES[3], 7, ib)])
    out["prefix_engine"] = eng
    eng = engine(side, models, "hybrid", **ENGINE)
    pid = eng.register_prefix(HYB_PREFIX)
    out["prefix_hybrid"] = first_wave(side, eng, [(HYB_SUFFIXES[0], 6, pid), (HYB_SUFFIXES[1], 6, pid)])
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return run_all("jax", models)


@pytest.fixture(scope="module")
def port_runs(models):
    return run_all("port", models)


CASES = ["chunked_mixed", "chunked_pool", "chunked_hybrid", "prefix", "prefix_hybrid"]


@pytest.mark.parametrize("case", CASES)
def test_tokens_equal_jax(jax_runs, port_runs, case):
    """Greedy tokens, request by request, equal the JAX engine's."""
    assert port_runs[case][0] == jax_runs[case][0]


@pytest.mark.parametrize("case", CASES)
def test_first_admission_matches_jax(jax_runs, port_runs, case):
    """The first wave's last-token logits and its cache rows (KV, and on the
    hybrid the conv taps and recurrent states) within 1e-4 of JAX's; the
    column pointers and RoPE positions equal."""
    got, ref = port_runs[case][1], jax_runs[case][1]
    assert set(got) == set(ref)
    for name in got:
        if name in ("seqpos", "cache/pos"):
            assert got[name].tolist() == ref[name].tolist(), name
        else:
            np.testing.assert_allclose(got[name], ref[name], atol=TOL, rtol=0, err_msg=name)


def one_shot_logits(models, name, ids):
    """The port's last-token logits of one b = 1 prefill of ``ids`` on a
    fresh cache of the engine's max_len."""
    _, _, tm, tp, cfg = models[name]
    cfg = dict(cfg, dtype=torch.float32)
    with torch.inference_mode():
        cache = tm.init_cache(cfg, 1, ENGINE["max_len"], device="cpu")
        logits, _, _ = tm.apply(tp, cfg, torch.tensor([ids]), cache=cache)
    return logits[0, -1].numpy()


@pytest.mark.parametrize("case, name, prompts", [
    ("chunked_mixed", "dense", [LONG_A, MID]),
    ("chunked_pool", "dense", [LONG_A, LONG_B]),
    ("chunked_hybrid", "hybrid", [LONG_A]),
])
def test_chunked_admission_equals_one_shot_prefill(models, port_runs, case, name, prompts):
    """A chunked admission's logits (rows ending in chunks 2 and 3 of one
    wave included) within 1e-4 of one prefill of the whole prompt."""
    logits = port_runs[case][1]["logits"]
    for row, ids in enumerate(prompts):
        np.testing.assert_allclose(logits[row], one_shot_logits(models, name, ids), atol=TOL, rtol=0)


def test_chunked_wave_ends_rows_in_different_chunks(port_runs):
    """The hand-admitted wave's rows end in different chunks (and its
    column pointers are the real lengths)."""
    snap = port_runs["chunked_mixed"][1]
    assert snap["cache/pos"].tolist() == [len(LONG_A), len(MID)]
    assert {(n - 1) // 8 for n in (len(LONG_A), len(MID))} == {1, 2}


def test_stored_prefix_rows_unchanged_after_waves(port_runs):
    """The registered rows are bit-equal after their waves (each prefix
    served two, the group caches being copies, not views)."""
    eng = port_runs["prefix_engine"]
    assert eng.stats()["admit_waves"] >= 3
    for pid, before in enumerate(port_runs["stored"]):
        after = eng._prefixes[pid][0]
        assert after["pos"] == before["pos"] == eng._prefixes[pid][1]
        for name, t in before.items():
            if torch.is_tensor(t):
                assert torch.equal(after[name], t), name


def test_prefix_pool_positions(port_runs):
    """A prefix row's column pointer and position are plen + the suffix's
    real length."""
    snap = port_runs["prefix"][1]
    assert snap["cache/pos"].tolist() == [len(PREFIX_A) + len(SUFFIXES[0]), len(PREFIX_B) + len(SUFFIXES[1])]
    assert snap["seqpos"].tolist() == snap["cache/pos"].tolist()


def test_prefix_refusals(models):
    """A prefix that leaves no room for the smallest bucket, and a suffix
    whose bucket and budget do not fit behind its prefix, are refused as
    JAX refuses them; a prompt past the largest bucket without
    ``prefill_chunk`` too."""
    eng = engine("port", models, "dense", **ENGINE)
    with pytest.raises(ValueError, match="leaves no room"):
        eng.register_prefix(list(range(1, 33)))  # 32 + bucket 8 >= max_len 40
    pid = eng.register_prefix(PREFIX_B)
    with pytest.raises(ValueError, match="prefix 9 \\+ bucket 8 \\+ max_gen 30 exceeds max_len"):
        eng.submit(SHORT, 30, prefix=pid)
    eng.submit(SHORT, 23, prefix=pid)  # 9 + 8 + 23 = 40 fits
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        eng.submit(LONG_A, 4)
    chunked = engine("port", models, "dense", **CHUNKED)
    with pytest.raises(ValueError, match="bucket 24 \\+ max_gen 17 exceeds max_len"):
        chunked.submit(LONG_A, 17)


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(draft_model=tq.TextOnly), dict(gamma=4)],
                         ids=["mesh", "draft", "gamma"])
def test_later_slices_still_refused_with_the_new_paths(models, kw):
    """The mesh still raises, also on an engine with chunked prefill and
    prefixes; this hybrid target with itself as the draft is built with
    those paths and serves a chunked, a prefix and a plain request with the
    plain engine's tokens (its recurrent caches rolled back:
    test_torch_spec_hybrid.py); JAX's default γ 4 without a draft builds
    the plain engine; an adapter on a prefix of params without stacked
    adapters raises JAX's ValueError (multi-LoRA itself is served:
    test_torch_serving_lora.py)."""
    if "gamma" in kw:
        assert not engine("port", models, "hybrid", **CHUNKED, **kw)._spec
    elif "draft_model" in kw:
        _, _, _, tp, cfg = models["hybrid"]
        served = []
        for spec in (dict(kw, draft_params=tp, draft_cfg=dict(cfg, dtype=torch.float32)), {}):
            eng = engine("port", models, "hybrid", **CHUNKED, **spec)
            pid = eng.register_prefix(HYB_PREFIX)
            served.append(eng.serve([(LONG_A, 6), (HYB_SUFFIXES[0], 5, pid), (SHORT, 4)]))
        assert served[0] == served[1]
    else:
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            engine("port", models, "hybrid", **CHUNKED, **kw)
    eng = engine("port", models, "hybrid", **CHUNKED)
    with pytest.raises(ValueError, match="no stacked adapters"):
        eng.submit(SHORT, 4, prefix=eng.register_prefix(HYB_PREFIX), adapter=0)


def test_max_len_past_the_rope_tables_refused(models):
    """The engine's positions stay below max_len, so it may not exceed the
    RoPE tables' context_length (an index past them would fault on the
    card; JAX clamps it)."""
    with pytest.raises(ValueError, match="context_length"):
        engine("port", models, "dense", **dict(ENGINE, max_len=65))
