"""The ported MiMo-V2-Flash training path against the JAX package, on the CPU.

A tiny MiMo with ``tests/test_mimo.py``'s widths (emb 32, 4 q heads of
head_dim 12 with value_head_dim 8, partial RoPE 0.33: a rotation of 3, so
2-wide tables), cut to 3 layers with ``hybrid_ratio`` 3 (GA, SWA, GA), window
4, 4 routed experts top-2 and MTP depth 2, is initialised in JAX, flattened
and loaded into the port with ``from_jax_flat``; both packages run in fp32 on
the same numpy-seeded batches of 24 tokens. JAX runs with ``use_flash=True``
and ``flash_min_seq`` 16, so its Pallas flash kernel runs in interpret mode on
the three main layers (24 tokens) and the two MTP blocks (22 and 21 tokens),
with the window and the sinks on the SWA layer and the MTP blocks; the port's
router takes the same route to the plain flash version at d 12 / dv 8.

The JAX references are jitted and computed once per module. Tolerances:
logits within 1e-4; the main and MTP losses within 1e-5 relative; every
gradient within 1e-4 of max(1, max |g|), the sinks' included; after 2 train
steps (learning rate 1e-3) the losses within 1e-5 relative, the parameters
within 3e-4 (0.3 of the learning rate: Adam's m/√v turns the fp32 noise of a
near-zero gradient into a step of up to the learning rate), and the expert
counts equal. The biases are the one documented divergence: the port keeps
them out of the optimizer, JAX's AdamW decays them by lr·wd·b a step
(``test_optimizer_decays_jax_biases_not_the_ports``). A near-tie in the top-2
of the biased router scores would flip an expert between the packages, so
each test asserts that every top-2 margin it routes exceeds 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.models import mimo_v2_flash as jm
from llm_quest_tpu.ops import moe as jmoe
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.training.mtp_engine import make_mimo_train_step as jmake_step
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import config as tconfig
from llm_quest_tpu_torch.models import mimo_v2_flash as tm
from llm_quest_tpu_torch.ops import moe as tmoe
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.training import mtp_engine
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {
    "vocab_size": 128,
    "context_length": 64,
    "emb_dim": 32,
    "n_layers": 3,
    "n_heads": 4,
    "num_swa_kv_groups": 4,
    "num_ga_kv_groups": 2,
    "head_dim": 12,
    "value_head_dim": 8,
    "hidden_dim": 64,
    "window_size": 4,
    "hybrid_ratio": 3,
    "rope_base": 10_000,
    "rope_base_ga": 640_000,
    "partial_rope_factor": 0.33,
    "mtp_depth": 2,
    "mtp_loss_coeff": 0.3,
    "num_experts": 4,
    "top_k": 2,
    "num_shared_experts": 0,
    "moe_scaling_factor": 1,
    "moe_bias_update_rate": 1e-3,
    "flash_min_seq": 16,
}
JCFG = dict(TINY, dtype=jnp.float32, use_flash=True)  # the Pallas flash kernel, interpret mode
TCFG = dict(TINY, dtype=torch.float32)
B, S = 2, 24
MARGIN = 1e-4
LR = 1e-3


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(ref, np.float64)).max())


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(np.asarray(ref, np.float64)).max()))


def batch_np(seed):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def port_layout(model, name, arr):
    """A JAX leaf in the port's layout: Linear weights transposed."""
    module_name = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(module_name), Linear):
        return np.asarray(arr).T
    return np.asarray(arr)


def topk_margin(moe, x, top_k):
    """The least gap, over tokens, between the k-th and (k+1)-th biased router
    score (softmax probabilities plus the biases) of ``deepseek_moe``'s input."""
    x2d = x.detach().reshape(-1, x.shape[-1])
    scores = torch.softmax((x2d @ moe.gate_w + moe.gate_b).float(), dim=-1) + moe.biases
    top = torch.topk(scores, top_k + 1, dim=-1).values
    return float((top[:, top_k - 1] - top[:, top_k]).min())


@pytest.fixture
def routing(monkeypatch):
    """Records the top-k margin and the expert counts of every
    ``deepseek_moe`` call of the port."""
    seen, real = {"margins": [], "counts": []}, tmoe.deepseek_moe

    def spy(params, x, *, top_k, **kw):
        seen["margins"].append(topk_margin(params, x, top_k))
        out, aux = real(params, x, top_k=top_k, **kw)
        seen["counts"].append(aux["counts"])
        return out, aux

    monkeypatch.setattr(tmoe, "deepseek_moe", spy)
    return seen


@pytest.fixture(scope="module")
def jparams():
    return jm.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture
def model(jparams):
    return from_jax_flat(flat(jparams), TCFG, device="cpu")


@pytest.fixture(scope="module")
def japply():
    """JAX's forward under ``jax.jit``, compiled once for the module's shapes."""
    return jax.jit(lambda p, x: jm.apply(p, JCFG, x))


@pytest.fixture(scope="module")
def jax_refs(jparams, japply):
    """JAX's logits, main loss, loss, gradients and expert counts on batch 2,
    each computed once under ``jax.jit``."""
    b = jbatch(batch_np(2))
    logits, _, aux = japply(jparams, b["input_ids"])
    main = jax.jit(lambda p, x, t: jm.loss(p, JCFG, x, t, training=False)[0])(jparams, b["input_ids"], b["targets"])
    value_and_grad = jax.jit(jax.value_and_grad(lambda p, x, t: jm.loss(p, JCFG, x, t)[0]))
    loss, grads = value_and_grad(jparams, b["input_ids"], b["targets"])
    return {"logits": np.asarray(logits), "counts": [np.asarray(c) for c in aux["moe_counts"]],
            "main": float(main), "loss": float(loss), "grads": flat(grads)}


# ------------------------------------------------------------------ config, weights


def test_config_matches_jax():
    ref = {k: v for k, v in jconfig.MIMO_V2_SMALL_CONFIG.items() if k != "dtype"}
    got = {k: v for k, v in tconfig.MIMO_V2_SMALL_CONFIG.items() if k != "dtype"}
    assert got == ref and tconfig.MIMO_V2_SMALL_CONFIG["dtype"] == torch.float32


@pytest.mark.parametrize("n_layers, ratio", [(3, 3), (6, 3), (12, 6), (4, 1)])
def test_layer_kinds_match_jax(n_layers, ratio):
    cfg = dict(TINY, n_layers=n_layers, hybrid_ratio=ratio)
    for fn in ("is_swa_layer", "is_moe_layer"):
        assert [getattr(tm, fn)(cfg, i) for i in range(n_layers)] == [getattr(jm, fn)(cfg, i) for i in range(n_layers)]
    small = tconfig.MIMO_V2_SMALL_CONFIG
    assert [i for i in range(12) if not tm.is_swa_layer(small, i)] == [0, 5, 11]


def test_params_named_and_shaped_like_jax(jparams, model):
    """Every JAX leaf is a trainable parameter of the port under the same
    name and shape (Linear weights transposed), but the MoE ``biases``, which
    are fp32 buffers; sinks only on the SWA layer and the MTP blocks."""
    assert isinstance(model, tm.MiMoV2Flash)
    ref = flat(jparams)
    params = {n.replace(".", "/"): p for n, p in model.named_parameters()}
    buffers = {n.replace(".", "/"): t for n, t in model.named_buffers() if n.endswith("biases")}
    assert set(params) | set(buffers) == set(ref) and not set(params) & set(buffers)
    assert sorted(buffers) == ["blocks/1/moe/biases", "blocks/2/moe/biases"]
    assert all(p.requires_grad for p in params.values())
    assert all(t.dtype == torch.float32 and not t.requires_grad for t in buffers.values())
    for name, p in params.items():
        assert tuple(p.shape) == port_layout(model, name.replace("/", "."), ref[name]).shape, name
    assert sorted(n for n in params if n.endswith("/sink")) == [
        "blocks/1/att/sink", "mtp/0/trf_block/att/sink", "mtp/1/trf_block/att/sink"]
    assert params["blocks/1/att/wv/w"].shape == (4 * 8, 32) and params["blocks/0/att/wk/w"].shape == (2 * 12, 32)


def test_from_jax_flat_rejects_bad_mimo_trees(jparams):
    f = flat(jparams)
    missing = {k: v for k, v in f.items() if k != "blocks/2/moe/biases"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat(missing, TCFG, device="cpu")
    extra = dict(f, **{"mtp/0/trf_block/att/wq/b": np.zeros(48, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_flat(extra, TCFG, device="cpu")
    bad = dict(f, **{"blocks/0/att/sink": np.zeros(4, np.float32)})  # GA layers have no sink
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_flat(bad, TCFG, device="cpu")
    shape = dict(f, **{"blocks/1/att/sink": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(shape, TCFG, device="cpu")


def test_from_jax_flat_loads_the_moe_biases(jparams):
    f = flat(jparams)
    f["blocks/2/moe/biases"] = np.asarray([0.5, -0.25, 0.0, 0.125], np.float32)
    model = from_jax_flat(f, TCFG, device="cpu")
    assert torch.equal(model.blocks[2].moe.biases, T(f["blocks/2/moe/biases"]))


def test_init_draws_the_jax_distributions():
    cfg = dict(TCFG, vocab_size=4096, n_heads=512, head_dim=8, value_head_dim=8, n_layers=2, mtp_depth=1)
    model = tm.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    w = model.tok_emb["w"].detach()
    assert abs(float(w.mean())) < 0.02 and abs(float(w.std()) - 1.0) < 0.02  # N(0, 1)
    assert float(model.blocks[0].att.wq.w.detach().abs().max()) <= 32**-0.5  # U(±1/sqrt(in))
    for sink in (model.blocks[1].att.sink, model.mtp[0].trf_block.att.sink):  # 0.02·N(0, 1)
        sink = sink.detach()
        assert abs(float(sink.std()) - 0.02) < 0.003 and abs(float(sink.mean())) < 0.003
    moe = model.blocks[1].moe
    bound = {"gate_w": 32**-0.5, "gate_b": 32**-0.5, "routed.lin1": 32**-0.5, "routed.gate": 32**-0.5,
             "routed.lin2": 64**-0.5}
    for name, p in moe.named_parameters():
        top = float(p.detach().abs().max())  # U(±bound): the larger draws come near the bound
        assert top <= bound[name] and (p.numel() < 100 or top >= 0.9 * bound[name]), name
    assert torch.equal(moe.biases, torch.zeros(4))
    assert torch.equal(model.blocks[0].norm1["scale"], torch.ones(32))


def test_dual_partial_rope_tables_match_jax():
    """0.33 of head_dim 12 rotates 3 features, so both packages build 2-wide
    tables; 0.33 of 64 is 21, so the small config's tables are 20 wide."""
    for cfg, jcfg, width in ((TCFG, JCFG, 2), (tconfig.MIMO_V2_SMALL_CONFIG, jconfig.MIMO_V2_SMALL_CONFIG, 20)):
        got, ref = tm.rope_tables(cfg, device="cpu"), jm.rope_tables(jcfg)
        for (cos, sin), (jcos, jsin) in zip(got, ref):
            assert cos.shape == (cfg["context_length"], width)
            assert max_err(cos, jcos) == 0.0 and max_err(sin, jsin) == 0.0
    # the two bases: one frequency (θ = 1) at the tiny width, ten at the small config's
    (cos_swa, _), (cos_ga, _) = tm.rope_tables(TCFG, device="cpu")
    assert torch.equal(cos_swa, cos_ga)
    (cos_swa, _), (cos_ga, _) = tm.rope_tables(tconfig.MIMO_V2_SMALL_CONFIG, device="cpu")
    assert torch.equal(cos_swa[:, 0], cos_ga[:, 0]) and not torch.equal(cos_swa[:, 1], cos_ga[:, 1])


@pytest.mark.parametrize("entry", ["MiMoV2Flash", "init", "from_jax_flat"])
def test_entry_points_default_to_the_card(jparams, entry):
    """With no device given the model builds on the current CUDA device;
    without a card it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    calls = {
        "MiMoV2Flash": lambda: tm.MiMoV2Flash(TCFG),
        "init": lambda: tm.init(TCFG, generator=torch.Generator()),
        "from_jax_flat": lambda: from_jax_flat(flat(jparams), TCFG),
    }
    with pytest.raises(RuntimeError, match='no CUDA device: pass device="cpu"'):
        calls[entry]()


def test_cached_path_raises(model):
    """The cached path is ported (tests/test_torch_serving_families.py);
    expert-parallel dispatch still raises on it."""
    ids = T(batch_np(0)["input_ids"])
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        tm.apply(model, dict(TCFG, expert_parallel={}), ids,
                 cache=tm.init_cache(TCFG, ids.shape[0], ids.shape[1], device="cpu"))


# ------------------------------------------------------------------ forward, loss, gradients


def test_apply_matches_jax(model, jax_refs, routing):
    got, _, aux = tm.apply(model, TCFG, T(batch_np(2)["input_ids"]))
    assert min(routing["margins"]) > MARGIN
    assert max_err(got, jax_refs["logits"]) <= 1e-4
    assert len(aux["moe_counts"]) == 2
    for c, ref in zip(aux["moe_counts"], jax_refs["counts"]):
        np.testing.assert_array_equal(c.numpy(), ref)


def test_flash_route_takes_the_window_and_sinks_at_dv(model, monkeypatch):
    """Every attention call of the loss takes the flash wrapper: the main
    layers (GA, SWA + sink, GA) and the two MTP blocks (SWA + sink, at 22 and
    21 tokens), with v's head dim 8 beside q's 12."""
    from llm_quest_tpu_torch.kernels import attention as kattn

    seen, real = [], kattn.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], q.shape[-1], v.shape[-1], kw.get("window_size"), kw.get("sink") is not None))
        return real(q, k, v, **kw)

    monkeypatch.setattr(kattn, "flash_attention", spy)
    b = batch_np(2)
    tm.loss(model, TCFG, T(b["input_ids"]), T(b["targets"]))
    assert seen == [(24, 12, 8, None, False), (24, 12, 8, 4, True), (24, 12, 8, None, False),
                    (22, 12, 8, 4, True), (21, 12, 8, 4, True)]


def test_loss_and_gradients_match_jax(model, jax_refs, routing):
    b = batch_np(2)
    x, t = T(b["input_ids"]), T(b["targets"])
    main = float(tm.loss(model, TCFG, x, t, training=False)[0])
    loss, _ = tm.loss(model, TCFG, x, t)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert min(routing["margins"]) > MARGIN
    assert abs(main - jax_refs["main"]) <= 1e-5 * abs(jax_refs["main"])
    mtp, jmtp = float(loss) - main, jax_refs["loss"] - jax_refs["main"]
    assert abs(mtp - jmtp) <= 1e-5 * abs(jmtp)
    assert abs(float(loss) - jax_refs["loss"]) <= 1e-5 * abs(jax_refs["loss"])
    ref = {k.replace("/", "."): v for k, v in jax_refs["grads"].items()}
    assert max_err(ref["blocks.1.moe.biases"], 0.0) == 0.0  # a leaf in JAX, with no gradient
    for (name, _), g in zip(model.named_parameters(), grads):
        assert rel_err(g, port_layout(model, name, ref[name])) <= 1e-4, name
    assert float(grads[[n for n, _ in model.named_parameters()].index("blocks.1.att.sink")].abs().max()) > 0


# ------------------------------------------------------------------ MoE


def deepseek_case(num_shared, seed):
    cfg = dict(TINY, num_experts=4 + num_shared, num_shared_experts=num_shared, top_k=2,
               moe_scaling_factor="auto" if num_shared else 1)
    jp = jmoe.init_deepseek_moe(jax.random.PRNGKey(seed), dict(cfg, dtype=jnp.float32))
    jp["biases"] = jnp.asarray(np.random.default_rng(seed).normal(0, 0.05, 4).astype(np.float32))
    moe = tmoe.DeepSeekMoE(cfg, torch.float32, "cpu")
    state = moe.state_dict()
    assert set(state) == {k.replace("/", ".") for k in flatten_params(jp)}
    for name, arr in flatten_params(jp).items():
        state[name.replace("/", ".")].copy_(T(arr))
    x = np.random.default_rng(seed + 1).standard_normal((2, 12, 32)).astype(np.float32)
    return cfg, jp, moe, x


@pytest.mark.parametrize("num_shared", [0, 1])
def test_deepseek_moe_matches_jax(num_shared):
    """Routed experts, the router bias and the balancing biases, plus (one
    shared expert) the non-gated shared MLP with b1/b2, hidden int(64/3)."""
    cfg, jp, moe, x = deepseek_case(num_shared, seed=3)
    assert topk_margin(moe, T(x), 2) > MARGIN
    ref, raux = jax.jit(lambda p, x: jmoe.deepseek_moe(p, x, top_k=2))(jp, jnp.asarray(x))
    got, aux = tmoe.deepseek_moe(moe, T(x), top_k=2)
    assert max_err(got, ref) <= 1e-5
    np.testing.assert_array_equal(aux["counts"].numpy(), np.asarray(raux["counts"]))
    assert abs(float(aux["max_vio"]) - float(raux["max_vio"])) <= 1e-6
    if num_shared:
        assert sorted(moe.shared) == ["b1", "b2", "lin1", "lin2"] and moe.shared["lin1"].shape == (1, 32, 21)


def test_balancing_helpers_match_jax():
    idx = np.random.default_rng(0).integers(0, 6, (40, 2))
    counts = tmoe.expert_counts(T(idx), 6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jmoe.expert_counts(jnp.asarray(idx), 6)))
    biases = np.random.default_rng(1).normal(0, 0.01, 6).astype(np.float32)
    got = tmoe.aux_free_bias_update(T(biases), counts, 1e-3)
    ref = jmoe.aux_free_bias_update(jnp.asarray(biases), jnp.asarray(counts.numpy()), 1e-3)
    assert max_err(got, ref) == 0.0
    assert abs(float(tmoe.max_violation(counts)) - float(jmoe.max_violation(jnp.asarray(counts.numpy())))) <= 1e-7


# ------------------------------------------------------------------ train step


def test_train_step_matches_jax(jparams, japply, model, routing):
    jstep = jmake_step(JCFG, jengine.make_optimizer(LR))
    tstep = mtp_engine.make_mimo_train_step(tm, TCFG, tengine.make_optimizer(LR))
    jp = jax.tree.map(jnp.copy, jparams)  # the JAX step donates its params
    jstate, tstate = jengine.make_optimizer(LR).init(jp), tengine.make_optimizer(LR).init(model)
    biases = [torch.zeros(4), torch.zeros(4)]
    for i in range(2):
        b = batch_np(10 + i)
        _, _, jaux = japply(jp, jnp.asarray(b["input_ids"]))  # the counts JAX's step folds
        jp, jstate, jloss = jstep(jp, jstate, jbatch(b), jax.random.PRNGKey(i))
        n = len(routing["margins"])
        model, tstate, tloss = tstep(model, tstate, b)
        assert min(routing["margins"][n:]) > MARGIN, i
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
        for c, ref in zip(routing["counts"][n:n + 2], jaux["moe_counts"]):  # the main model's MoE blocks
            np.testing.assert_array_equal(c.numpy(), np.asarray(ref))
        biases = [tmoe.aux_free_bias_update(bias, T(np.asarray(c)), TINY["moe_bias_update_rate"])
                  for bias, c in zip(biases, jaux["moe_counts"])]
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert max_err(p, port_layout(model, name, ref[name.replace(".", "/")])) <= 3e-4, name
    for block, bias in zip(model.blocks[1:], biases):
        assert torch.equal(block.moe.biases, bias)  # JAX's counts folded by the port's rule
    # JAX's biases differ only by its AdamW's decay of the first step's biases: lr·wd·|b| = 1e-7
    for i, bias in zip((1, 2), biases):
        assert max_err(ref[f"blocks/{i}/moe/biases"], bias.numpy()) <= LR * 0.1 * 1e-3 * 1.01


# a tiny DeepSeek-V3 (tests/test_deepseek.py's widths, 3 layers: 1 dense, 2
# MoE with 4 routed experts at top-2 and 1 shared) for the reference fault
DSV3_TINY = {
    "vocab_size": 128, "context_length": 64, "emb_dim": 48, "n_heads": 4, "n_layers": 3, "hidden_dim": 96,
    "num_ffn": 1, "num_experts": 5, "num_shared_experts": 1, "top_k": 2, "moe_scaling_factor": 1,
    "moe_bias_update_rate": 1e-3, "mtp_depth": 2, "mtp_loss_coeff": 0.2, "rope_base": 10_000, "q_rank": 64,
}


def bias_fault_case(name, jparams):
    """(JAX params, JAX step maker, JAX batch, port config, port step maker,
    port batch) of MiMo-V2-Flash's (``jparams``) or DeepSeek-V3's tiny model."""
    if name == "mimo":
        b = batch_np(20)
        return (jax.tree.map(jnp.copy, jparams), lambda opt: jmake_step(JCFG, opt), jbatch(b), TCFG,
                lambda opt: mtp_engine.make_mimo_train_step(tm, TCFG, opt), b)
    from llm_quest_tpu.models import deepseek_v3 as jd
    from llm_quest_tpu.training.mtp_engine import make_deepseek_train_step as jmake_dsv3_step
    from llm_quest_tpu_torch.data.datasets import collate_function_mtp
    from llm_quest_tpu_torch.models import deepseek_v3 as td

    jcfg, tcfg = dict(DSV3_TINY, dtype=jnp.float32), dict(DSV3_TINY, dtype=torch.float32)
    rng = np.random.default_rng(20)
    b = collate_function_mtp([rng.integers(1, 128, n).tolist() for n in (S, S - 5)], 2, pad_token_id=0)
    jb = {k: [jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v) for k, v in b.items()}
    return (jd.init(jax.random.PRNGKey(0), jcfg), lambda opt: jmake_dsv3_step(jcfg, opt), jb, tcfg,
            lambda opt: mtp_engine.make_deepseek_train_step(td, tcfg, opt), b)


@pytest.mark.parametrize("name", ["mimo", "deepseek_v3"])
def test_optimizer_decays_jax_biases_not_the_ports(name, jparams, routing):
    """The reference fault (ROADMAP Queue 3), in both models with the
    DeepSeek MoE: JAX keeps ``biases`` as a leaf of ``params`` and its AdamW
    has no mask, so one step with weight decay 0.1 at learning rate 1e-2
    shrinks them by lr·wd·b before the sign update; the port's buffers move
    by the sign update alone."""
    lr, wd, rate = 1e-2, 0.1, TINY["moe_bias_update_rate"]
    start = {1: np.asarray([0.02, -0.01, 0.015, -0.03], np.float32), 2: np.asarray([-0.02, 0.01, 0.03, 0.0], np.float32)}
    jp, jmake, jb, tcfg, tmake, b = bias_fault_case(name, jparams)
    for i, bias in start.items():
        jp["blocks"][i]["moe"]["biases"] = jnp.asarray(bias)
    model = from_jax_flat(flat(jp), tcfg, device="cpu")
    jp, _, _ = jmake(jengine.make_optimizer(lr, weight_decay=wd))(
        jp, jengine.make_optimizer(lr, weight_decay=wd).init(jp), jb, jax.random.PRNGKey(0))
    opt = tengine.make_optimizer(lr, weight_decay=wd)
    tmake(opt)(model, opt.init(model), b)
    assert min(routing["margins"]) > MARGIN
    for (i, bias), counts in zip(start.items(), routing["counts"]):  # the main model's MoE blocks
        moe = model.blocks[i].moe
        sign = np.sign(counts.numpy().mean() - counts.numpy())
        np.testing.assert_allclose(moe.biases.numpy(), bias + rate * sign, rtol=0, atol=1e-8)
        np.testing.assert_allclose(np.asarray(jp["blocks"][i]["moe"]["biases"]), bias * (1 - lr * wd) + rate * sign,
                                   rtol=0, atol=1e-8)
        assert np.abs(bias).max() * lr * wd >= 3e-5  # the decay is far above the tolerance


def test_mtp_evaluate_is_the_main_loss(model):
    batches = [batch_np(30), batch_np(31)]
    got = mtp_engine.mtp_evaluate(tm, TCFG, model, batches)
    ref = np.mean([float(tm.loss(model, TCFG, T(b["input_ids"]), T(b["targets"]), training=False)[0])
                   for b in batches])
    assert abs(got - ref) <= 1e-6


# ------------------------------------------------------------------ FLOP count


def test_mimo_flop_count_diverges_from_jax():
    """The port counts MiMo as built (``training/flops.py`` docstring): per
    layer type kv groups and dv, the dense layer 0, the MoE of layers 1+ at
    top-2 of 3072 with the router, SWA layers at their mean context, and the
    two MTP modules on s − 2 and s − 3 tokens. JAX's count reads the missing
    ``num_kv_groups`` (12 kv heads), a dense FFN everywhere, s/2 and no MTP."""
    from llm_quest_tpu.training import flops as jflops
    from llm_quest_tpu_torch.training import flops as tflops

    cfg, s = tconfig.MIMO_V2_SMALL_CONFIG, 2048
    got = tflops.text_train_flops_per_token(cfg, seq_len=s)
    ref = jflops.text_train_flops_per_token(jconfig.MIMO_V2_SMALL_CONFIG, seq_len=s)
    d, head = 768, 2 * 768 * 50304
    proj = {4: 2 * d * (768 + 4 * 64 + 4 * 32 + 384), 2: 2 * d * (768 + 2 * 64 + 2 * 32 + 384)}  # q, k, v, out
    scores = 2 * 12 * (64 + 32)  # QKᵀ and PV per visible key
    dense, moe = 6 * d * 3072, 2 * d * 8 + 2 * 6 * d * 3072
    ga = proj[2] + scores * 1024
    swa = proj[4] + scores * tflops.swa_mean_context(128, s)
    main = head + (ga + dense) + 2 * (ga + moe) + 9 * (swa + moe)
    mtp = sum((2 * 2 * d * d + proj[4] + scores * tflops.swa_mean_context(128, s - k - 1) + dense + head)
              * (s - k - 1) / s for k in (1, 2))
    assert got == pytest.approx(3 * (main + mtp), rel=1e-12)
    assert round(got / 1e6) == 1898 and round(ref / 1e6) == 954
    # a config without hybrid_ratio keeps the existing count
    dense = {k: v for k, v in jconfig.qwen3_config_creator("0.6B").items() if k != "dtype"}
    assert tflops.text_train_flops_per_token(dense, seq_len=2048) == jflops.text_train_flops_per_token(
        jconfig.qwen3_config_creator("0.6B"), seq_len=2048)
