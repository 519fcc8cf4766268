"""The ported DeepSeek-V3 training and generation paths against the JAX
package, on the CPU.

A tiny DeepSeek-V3 with ``tests/test_deepseek.py``'s widths (emb 48, 4 heads
of head_dim 12 with decoupled RoPE halves of 6, so q/k 18 and v 12; q_rank
64, kv_rank 48; 4 layers, the first 2 dense; 3 routed experts at top-1 and 1
shared; MTP depth 2) is initialised in JAX, flattened and loaded into the
port with ``from_jax_flat``; both packages run in fp32 on the same
numpy-seeded batches from the MTP collator (rows of 24 and 19 tokens, so the
shorter row's pads and -100 targets are in every loss). The port's config
sets ``flash_min_seq`` 16, so every attention call of the loss (4 layers, 2
MTP blocks) takes the flash route to K4's plain version at (18, 12); JAX
runs its CPU default, ``sdpa``, the plain reference of its Pallas kernel
(that K4's plain version at (96, 64) matches the Pallas kernel in interpret
mode is held in ``test_torch_attention.py``).

The JAX references are jitted and computed once per module. Tolerances:
logits within 1e-4; the main and MTP losses within 1e-5 relative; every
gradient within 1e-4 of max(1, max |g|); after one train step (learning rate
1e-4) the loss within 1e-5 relative, the parameters within 1e-4 and the
biases equal (they start at zero, so JAX's AdamW decay of them, the one
documented divergence, is nil on the first step). A near-tie in the top-1 of
the biased router scores would flip an expert between the packages, so each
test asserts that every margin it routes exceeds 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.data import datasets as jdata
from llm_quest_tpu.inference import cache as jcache
from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import deepseek_v3 as jd
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.training.mtp_engine import make_deepseek_train_step as jmake_step
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import config as tconfig
from llm_quest_tpu_torch.data import datasets as tdata
from llm_quest_tpu_torch.inference import cache as tcache
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.models import deepseek_v3 as td
from llm_quest_tpu_torch.ops import moe as tmoe
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.training import mtp_engine
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {
    "vocab_size": 128,
    "context_length": 64,
    "emb_dim": 48,
    "n_heads": 4,
    "n_layers": 4,
    "hidden_dim": 96,
    "num_ffn": 2,
    "num_experts": 4,
    "num_shared_experts": 1,
    "top_k": 1,
    "moe_scaling_factor": 1,
    "moe_bias_update_rate": 1e-3,
    "mtp_depth": 2,
    "mtp_loss_coeff": 0.2,
    "rope_base": 10_000,
    "q_rank": 64,
}
JCFG = dict(TINY, dtype=jnp.float32)
TCFG = dict(TINY, dtype=torch.float32, flash_min_seq=16)
LENGTHS = (24, 19)
MARGIN = 1e-4
LR = 1e-4


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(ref, np.float64)).max())


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(np.asarray(ref, np.float64)).max()))


def rows(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], n).tolist() for n in LENGTHS]


def batch_np(seed):
    """The MTP collator's batch (pad id 0) of two rows of 24 and 19 tokens."""
    return tdata.collate_function_mtp(rows(seed), TINY["mtp_depth"], pad_token_id=0)


def jbatch(b):
    return {k: [jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v) for k, v in b.items()}


def tbatch(b):
    return {k: [T(a) for a in v] if isinstance(v, list) else T(v) for k, v in b.items()}


def port_layout(model, name, arr):
    """A JAX leaf in the port's layout: Linear weights transposed."""
    module_name = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(module_name), Linear):
        return np.asarray(arr).T
    return np.asarray(arr)


@torch.no_grad()
def topk_margin(moe, x, top_k):
    """The least gap, over tokens, between the k-th and (k+1)-th biased router
    score (softmax probabilities plus the biases) of ``deepseek_moe``'s input."""
    x2d = x.reshape(-1, x.shape[-1])
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
    return jd.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture
def model(jparams):
    return from_jax_flat(flat(jparams), TCFG, device="cpu")


@pytest.fixture(scope="module")
def japply():
    """JAX's forward under ``jax.jit``, compiled once for the module's shapes."""
    return jax.jit(lambda p, x: jd.apply(p, JCFG, x))


def jloss(p, b, training=True):
    return jd.loss(p, JCFG, b["input_ids"], b["targets"], b["shifted_inputs"], b["shifted_targets"],
                   training=training)[0]


@pytest.fixture(scope="module")
def jax_refs(jparams, japply):
    """JAX's logits, aux, main loss, loss and gradients on batch 2, each
    computed once under ``jax.jit``."""
    b = jbatch(batch_np(2))
    logits, _, aux = japply(jparams, b["input_ids"])
    main = jax.jit(lambda p, b: jloss(p, b, training=False))(jparams, b)
    loss, grads = jax.jit(jax.value_and_grad(jloss))(jparams, b)
    return {"logits": np.asarray(logits), "counts": [np.asarray(c) for c in aux["moe_counts"]],
            "max_vio": float(aux["max_vio"]), "hidden": np.asarray(aux["hidden"]), "main": float(main),
            "loss": float(loss), "grads": flat(grads)}


def tloss(model, b, training=True):
    return td.loss(model, TCFG, b["input_ids"], b["targets"], b["shifted_inputs"], b["shifted_targets"],
                   training=training)


# ------------------------------------------------------------------ config, weights


def test_config_matches_jax():
    ref = {k: v for k, v in jconfig.DEEPSEEK_SMALL_CONFIG.items() if k != "dtype"}
    got = {k: v for k, v in tconfig.DEEPSEEK_SMALL_CONFIG.items() if k != "dtype"}
    assert got == ref and tconfig.DEEPSEEK_SMALL_CONFIG["dtype"] == torch.float32
    small = tconfig.DEEPSEEK_SMALL_CONFIG
    assert td.head_dims(small) == jd.head_dims(jconfig.DEEPSEEK_SMALL_CONFIG) == (64, 32)
    assert td.q_rank(small) == jd.q_rank(jconfig.DEEPSEEK_SMALL_CONFIG) == 1536
    assert (td.head_dims(TINY), td.q_rank(TINY)) == ((12, 6), 64)


def test_small_config_parameter_count():
    """DEEPSEEK_SMALL_CONFIG as built: 295.4 M parameters (no memory: the
    meta device), 7 routed experts and 1 shared, each 768 wide."""
    model = td.DeepSeekV3(tconfig.DEEPSEEK_SMALL_CONFIG, device="meta")
    assert round(sum(p.numel() for p in model.parameters()) / 1e5) == 2954
    moe = model.blocks[3].moe
    assert moe.routed["lin1"].shape == (7, 768, 768) and moe.shared["lin1"].shape == (1, 768, 768)
    assert [hasattr(b, "ffn") for b in model.blocks] == [True] * 3 + [False] * 9


def test_params_named_and_shaped_like_jax(jparams, model):
    """Every JAX leaf is a trainable parameter of the port under the same
    name and shape (Linear weights transposed), but the MoE ``biases``, which
    are fp32 buffers; the MTP blocks are dense, the out head untied."""
    assert isinstance(model, td.DeepSeekV3)
    ref = flat(jparams)
    params = {n.replace(".", "/"): p for n, p in model.named_parameters()}
    buffers = {n.replace(".", "/"): t for n, t in model.named_buffers() if n.endswith("biases")}
    assert set(params) | set(buffers) == set(ref) and not set(params) & set(buffers)
    assert sorted(buffers) == ["blocks/2/moe/biases", "blocks/3/moe/biases"]
    assert all(p.requires_grad for p in params.values())
    assert all(t.dtype == torch.float32 and not t.requires_grad for t in buffers.values())
    for name, p in params.items():
        assert tuple(p.shape) == port_layout(model, name.replace("/", "."), ref[name]).shape, name
    assert "out/b" not in params and "mtp/1/trf_block/ffn/gate/w" in params
    assert params["blocks/0/att/wk_decoup/w"].shape == (6, 48) and params["blocks/0/att/wq_decoup/b"].shape == (24,)


def test_from_jax_flat_rejects_bad_deepseek_trees(jparams):
    f = flat(jparams)
    missing = {k: v for k, v in f.items() if k != "blocks/3/moe/biases"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat(missing, TCFG, device="cpu")
    extra = dict(f, **{"out/b": np.zeros(128, np.float32)})  # the head has no bias
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_flat(extra, TCFG, device="cpu")
    dense_moe = dict(f, **{"blocks/1/moe/gate_b": np.zeros(3, np.float32)})  # layer 1 is dense
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_flat(dense_moe, TCFG, device="cpu")
    shape = dict(f, **{"mtp/0/trf_block/att/wk_decoup/w": np.zeros((48, 12), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(shape, TCFG, device="cpu")


def test_from_jax_flat_loads_the_moe_biases(jparams):
    f = flat(jparams)
    f["blocks/3/moe/biases"] = np.asarray([0.5, -0.25, 0.125], np.float32)
    model = from_jax_flat(f, TCFG, device="cpu")
    assert torch.equal(model.blocks[3].moe.biases, T(f["blocks/3/moe/biases"]))


def test_init_draws_the_jax_distributions():
    cfg = dict(TCFG, vocab_size=4096, emb_dim=512, n_heads=8, q_rank=512, n_layers=2, num_ffn=1, mtp_depth=1)
    model = td.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    w = model.tok_emb["w"].detach()
    assert abs(float(w.mean())) < 0.02 and abs(float(w.std()) - 1.0) < 0.02  # N(0, 1)
    att = model.blocks[0].att
    for name, p in att.named_parameters():  # U(±1/sqrt(in)) for every weight and bias
        if name.endswith("norm.scale"):
            assert torch.equal(p, torch.ones_like(p)), name
            continue
        bound = 1.0 / float(getattr(att, name.split(".")[0]).w.shape[1]) ** 0.5
        top = float(p.detach().abs().max())
        assert top <= bound and top >= 0.9 * bound, name
    assert float(model.out.w.detach().abs().max()) <= 512**-0.5 and model.out.b is None
    moe = model.blocks[1].moe
    assert torch.equal(moe.biases, torch.zeros(3))
    assert float(moe.shared["lin2"].detach().abs().max()) <= 96**-0.5
    assert torch.equal(model.mtp[0].rms_input["scale"], torch.ones(512))


def test_rope_tables_match_jax():
    """The decoupled head dim's tables (6 wide at the tiny widths, 32 at the
    small config's), built from ``rope_base`` alone: ``rope_freq`` is not read."""
    for cfg, jcfg, width in ((TCFG, JCFG, 6), (tconfig.DEEPSEEK_SMALL_CONFIG, jconfig.DEEPSEEK_SMALL_CONFIG, 32)):
        (cos, sin), (jcos, jsin) = td.rope_tables(cfg, device="cpu"), jd.rope_tables(jcfg)
        assert cos.shape == (cfg["context_length"], width)
        assert max_err(cos, jcos) == 0.0 and max_err(sin, jsin) == 0.0


@pytest.mark.parametrize("entry", ["DeepSeekV3", "init", "from_jax_flat", "init_cache"])
def test_entry_points_default_to_the_card(jparams, entry):
    """With no device given the model and its cache build on the current
    CUDA device; without a card they raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    calls = {
        "DeepSeekV3": lambda: td.DeepSeekV3(TCFG),
        "init": lambda: td.init(TCFG, generator=torch.Generator()),
        "from_jax_flat": lambda: from_jax_flat(flat(jparams), TCFG),
        "init_cache": lambda: td.init_cache(TCFG, 1, 8),
    }
    with pytest.raises(RuntimeError, match='no CUDA device: pass device="cpu"'):
        calls[entry]()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_init_kv_cache_v_head_dim_matches_jax(quant):
    """k rows at head_dim, v rows at v_head_dim, in the bf16 and the int8
    layouts, as JAX allocates them; the model's cache is q/k 18, v 12."""
    got = tcache.init_kv_cache(3, 2, 4, 10, 18, v_head_dim=12, quant=quant, device="cpu")
    ref = jcache.init_kv_cache(3, 2, 4, 10, 18, v_head_dim=12, quant=quant)
    assert set(got) == set(ref)
    for name, t in got.items():
        if name != "pos":
            assert tuple(t.shape) == ref[name].shape and str(t.dtype).removeprefix("torch.") == ref[name].dtype, name
    cache = td.init_cache(dict(TCFG, kv_quant=quant), 2, 10, device="cpu")
    jref = jd.init_cache(dict(JCFG, kv_quant=quant), 2, 10)
    assert {k: tuple(v.shape) for k, v in cache.items() if k != "pos"} == {
        k: v.shape for k, v in jref.items() if k != "pos"}


def test_expert_parallel_raises(model):
    with pytest.raises(NotImplementedError, match="expert-parallel"):
        td.apply(model, dict(TCFG, expert_parallel={}), T(batch_np(0)["input_ids"]))


# ------------------------------------------------------------------ forward, loss, gradients


def test_apply_matches_jax(model, jax_refs, routing):
    got, cache, aux = td.apply(model, TCFG, T(batch_np(2)["input_ids"]))
    assert cache is None and min(routing["margins"]) > MARGIN
    assert max_err(got, jax_refs["logits"]) <= 1e-4
    assert max_err(aux["hidden"], jax_refs["hidden"]) <= 1e-4
    assert len(aux["moe_counts"]) == 2
    for c, ref in zip(aux["moe_counts"], jax_refs["counts"]):
        np.testing.assert_array_equal(c.numpy(), ref)
    assert abs(float(aux["max_vio"]) - jax_refs["max_vio"]) <= 1e-6


def test_flash_route_takes_the_mla_head_dims(model, monkeypatch):
    """Every attention call of the loss takes the flash wrapper, causal, at
    q/k 18 and v 12 with MLA's scale: the 4 main layers and the 2 MTP blocks,
    all at the full 24 tokens (the collator pre-shifts); q and k arrive
    contiguous (the decoupled key copied into each head's rows)."""
    from llm_quest_tpu_torch.kernels import attention as kattn

    seen, real = [], kattn.flash_attention

    def spy(q, k, v, **kw):
        assert q.is_contiguous() and k.is_contiguous() and k.stride(1) != 0
        seen.append((q.shape[2], q.shape[-1], k.shape[-1], v.shape[-1], kw["causal"], kw["scale"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(kattn, "flash_attention", spy)
    tloss(model, tbatch(batch_np(2)))
    assert seen == [(24, 18, 18, 12, True, 18**-0.5)] * 6


def test_loss_and_gradients_match_jax(model, jax_refs, routing):
    b = tbatch(batch_np(2))
    main = float(tloss(model, b, training=False)[0])
    loss, _ = tloss(model, b)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert min(routing["margins"]) > MARGIN
    assert abs(main - jax_refs["main"]) <= 1e-5 * abs(jax_refs["main"])
    mtp, jmtp = float(loss) - main, jax_refs["loss"] - jax_refs["main"]
    assert abs(mtp - jmtp) <= 1e-5 * abs(jmtp)
    assert abs(float(loss) - jax_refs["loss"]) <= 1e-5 * abs(jax_refs["loss"])
    ref = {k.replace("/", "."): v for k, v in jax_refs["grads"].items()}
    assert max_err(ref["blocks.2.moe.biases"], 0.0) == 0.0  # a leaf in JAX, with no gradient
    for (name, _), g in zip(model.named_parameters(), grads):
        assert rel_err(g, port_layout(model, name, ref[name])) <= 1e-4, name
    mtp_grad = grads[[n for n, _ in model.named_parameters()].index("mtp.0.trf_block.att.wq_down.w")]
    assert float(mtp_grad.abs().max()) > 0  # the MTP logits come from the block output


# ------------------------------------------------------------------ train step, evaluation


def test_train_step_matches_jax(jparams, japply, model, routing):
    """One ``make_deepseek_train_step`` step of each package on the same
    batch: the loss, every parameter and the folded biases."""
    jp = jax.tree.map(jnp.copy, jparams)  # the JAX step donates its params
    jopt, topt = jengine.make_optimizer(LR), tengine.make_optimizer(LR)
    jstep = jmake_step(JCFG, jopt)
    tstep = mtp_engine.make_deepseek_train_step(td, TCFG, topt)
    b = batch_np(10)
    _, _, jaux = japply(jp, jnp.asarray(b["input_ids"]))  # the counts JAX's step folds
    jp, _, jloss_ = jstep(jp, jopt.init(jp), jbatch(b), jax.random.PRNGKey(0))
    model, _, tloss_ = tstep(model, topt.init(model), b)
    assert min(routing["margins"]) > MARGIN
    assert abs(float(tloss_) - float(jloss_)) <= 1e-5 * abs(float(jloss_))
    for c, ref in zip(routing["counts"][:2], jaux["moe_counts"]):  # the main model's MoE blocks
        np.testing.assert_array_equal(c.numpy(), np.asarray(ref))
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert max_err(p, port_layout(model, name, ref[name.replace(".", "/")])) <= 1e-4, name
    for i, counts in zip((2, 3), jaux["moe_counts"]):
        expected = tmoe.aux_free_bias_update(torch.zeros(3), T(np.asarray(counts)), TINY["moe_bias_update_rate"])
        assert torch.equal(model.blocks[i].moe.biases, expected)
        np.testing.assert_array_equal(ref[f"blocks/{i}/moe/biases"], expected.numpy())
        assert float(expected.abs().max()) > 0


def test_mtp_evaluate_is_the_main_loss(model):
    batches = [batch_np(30), batch_np(31)]
    got = mtp_engine.mtp_evaluate(td, TCFG, model, batches)
    ref = np.mean([float(tloss(model, tbatch(b), training=False)[0]) for b in batches])
    assert abs(got - ref) <= 1e-6
    assert abs(mtp_engine.mtp_evaluate(td, TCFG, model, batches, num_batches=1) - float(
        tloss(model, tbatch(batches[0]), training=False)[0])) <= 1e-6


def test_batches_keep_the_shifted_lists():
    """The train step's batch conversion keeps the MTP collator's per-depth
    lists as lists of tensors, numpy arrays and tensors alike."""
    b = batch_np(3)
    for src in (b, tbatch(b)):
        got = tengine._as_tensors(src, torch.device("cpu"))
        assert torch.is_tensor(got["input_ids"]) and got["input_ids"].shape == (2, 24)
        for key in ("shifted_inputs", "shifted_targets"):
            assert isinstance(got[key], list) and len(got[key]) == 2
            for t, ref in zip(got[key], b[key]):
                assert torch.is_tensor(t) and np.array_equal(t.numpy(), ref)


# ------------------------------------------------------------------ data


def test_collate_function_mtp_matches_jax():
    """The hand vectors of ``tests/test_deepseek.py`` (the reference
    collator's), then JAX's collator on random rows, pad ids and depths."""
    batch = [[1, 2, 3, 4, 5, 50256], [6, 7, 8, 50256], [9, 10, 11, 12, 50256]]
    coll = tdata.collate_function_mtp(batch, mtp_depth=2)
    np.testing.assert_array_equal(
        coll["targets"],
        [[2, 3, 4, 5, 50256, 50256], [7, 8, 50256, 50256, -100, -100], [10, 11, 12, 50256, 50256, -100]],
    )
    np.testing.assert_array_equal(coll["shifted_inputs"][0][0], [2, 3, 4, 5, 50256, 50256])
    np.testing.assert_array_equal(coll["shifted_targets"][0][0], [3, 4, 5, 50256, 50256, -100])
    np.testing.assert_array_equal(coll["shifted_inputs"][1][0], [3, 4, 5, 50256, 50256, 50256])
    for seed, depth, pad, max_len in ((0, 2, 0, None), (1, 3, 50256, 7), (2, 1, 5, None)):
        rng = np.random.default_rng(seed)
        rows_ = [rng.integers(1, 100, rng.integers(2, 12)).tolist() for _ in range(4)]
        got = tdata.collate_function_mtp(rows_, depth, custom_max_len=max_len, pad_token_id=pad)
        ref = jdata.collate_function_mtp(rows_, depth, custom_max_len=max_len, pad_token_id=pad)
        assert set(got) == set(ref)
        for key in ("input_ids", "targets", "attn_mask"):
            assert got[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(got[key], ref[key])
        for key in ("shifted_inputs", "shifted_targets"):
            assert len(got[key]) == depth
            for a, r in zip(got[key], ref[key]):
                np.testing.assert_array_equal(a, r)
    assert (tdata.PAD_TOKEN_ID, tdata.NO_LOSS_ID) == (jdata.PAD_TOKEN_ID, jdata.NO_LOSS_ID)


@pytest.mark.parametrize("shuffle, drop_last", [(False, True), (True, True), (True, False)])
def test_data_loader_matches_jax(shuffle, drop_last):
    samples = [list(range(i, i + 3 + i % 4)) for i in range(11)]
    coll = lambda rows_: tdata.collate_function_mtp(rows_, 2)  # noqa: E731
    jcoll = lambda rows_: jdata.collate_function_mtp(rows_, 2)  # noqa: E731
    got = tdata.data_loader(samples, 4, shuffle=shuffle, drop_last=drop_last, collate_fn=coll, seed=3)
    ref = jdata.data_loader(samples, 4, shuffle=shuffle, drop_last=drop_last, collate_fn=jcoll, seed=3)
    assert len(got) == len(ref) == (2 if drop_last else 3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["input_ids"], r["input_ids"])
        np.testing.assert_array_equal(g["shifted_targets"][1], r["shifted_targets"][1])
    arrays = (np.arange(20).reshape(10, 2), np.arange(20, 40).reshape(10, 2))
    for g, r in zip(tdata.data_loader(arrays, 3, shuffle=shuffle, drop_last=drop_last, seed=1),
                    jdata.data_loader(arrays, 3, shuffle=shuffle, drop_last=drop_last, seed=1)):
        np.testing.assert_array_equal(g["input_ids"], r["input_ids"])
        np.testing.assert_array_equal(g["targets"], r["targets"])
    assert tdata.data_loader(samples, 5) == jdata.data_loader(samples, 5)  # no collator: the chunks


# ------------------------------------------------------------------ generation


def test_cached_decode_matches_uncached_and_jax(jparams, model):
    """Greedy cached generation (``sdpa`` over the q/k 18, v 12 cache) gives
    the tokens of the uncached oracle, and both give JAX's uncached tokens;
    with an EOS the oracle stops before the step that drew it."""
    prompt = np.random.default_rng(2).integers(0, TINY["vocab_size"], (1, 5))
    cached = tgen.generate_kv_cache(td, model, TCFG, T(prompt), max_gen=6, eos_ids=-1, pad_id=0)["sequences"]
    uncached = tgen.generate_loop_uncached(td, model, TCFG, T(prompt), max_gen=6)
    japply_ = jax.jit(lambda p, x: jd.apply(p, JCFG, x))

    class JModel:  # JAX's model with a jitted apply (one compile per length)
        @staticmethod
        def apply(p, cfg, x):
            return japply_(p, x)

    ref = jgen.generate_loop_uncached(JModel, jparams, JCFG, jnp.asarray(prompt), max_gen=6)
    assert cached.tolist() == uncached.tolist() == np.asarray(ref).tolist()
    eos = int(uncached[0, 7])
    stopped = tgen.generate_loop_uncached(td, model, TCFG, T(prompt), max_gen=6, eos_ids=[eos])
    assert stopped.tolist() == uncached[:, :7].tolist()


def test_sampled_uncached_decode_follows_its_generator(model):
    prompt = T(np.random.default_rng(3).integers(0, TINY["vocab_size"], (2, 4)))
    runs = [tgen.generate_loop_uncached(td, model, TCFG, prompt, max_gen=5, temp=1.0, top_k=20,
                                        generator=torch.Generator().manual_seed(seed)) for seed in (7, 7, 8)]
    assert runs[0].shape == (2, 9) and torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    # the context truncation: a 3-token context ends in the same last-position logits
    short = tgen.generate_loop_uncached(td, model, TCFG, prompt, max_gen=1, context_length=3)
    logits, _, _ = td.apply(model, TCFG, prompt[:, -3:])
    assert short[:, -1].tolist() == logits[:, -1].argmax(-1).tolist()


# ------------------------------------------------------------------ FLOP count


def test_deepseek_flop_count_diverges_from_jax():
    """The port counts DeepSeek-V3 as built (``training/flops.py``
    docstring): MLA's latent projections and its scores at q/k 96 and v 64,
    3 dense and 9 MoE layers (router, top-3 of 7 routed, the non-gated
    shared expert, each 768 wide), the untied head and the two MTP modules at
    the full s. JAX's count reads dense MHA with a dense FFN everywhere and
    no MTP."""
    from llm_quest_tpu.training import flops as jflops
    from llm_quest_tpu_torch.training import flops as tflops

    cfg, s = tconfig.DEEPSEEK_SMALL_CONFIG, 2048
    got = tflops.text_train_flops_per_token(cfg, seq_len=s)
    ref = jflops.text_train_flops_per_token(jconfig.DEEPSEEK_SMALL_CONFIG, seq_len=s)
    d, qr, kvr, n, head = 768, 1536, 256, 12, 2 * 768 * 50304
    mla = 2 * (d * qr + qr * d + qr * n * 32 + d * kvr + 2 * kvr * d + d * 32 + d * d) + 2 * 1024 * n * (96 + 64)
    dense = 6 * d * 3072
    moe = 2 * d * 7 + 3 * 6 * d * 768 + 4 * d * 768
    main = head + 12 * mla + 3 * dense + 9 * moe
    mtp = 2 * (2 * 2 * d * d + mla + dense + head)
    assert got == pytest.approx(3 * (main + mtp), rel=1e-12)
    assert round(got / 1e5) == 17866 and round(ref / 1e5) == 10245
    assert got == tflops.deepseek_train_flops_per_token(cfg, seq_len=s)
