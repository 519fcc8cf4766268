"""The ported Qwen3-MoE model against the JAX package, on the CPU in fp32.

The tiny MoE of ``tests/test_serving.py::test_serving_qwen3_next_and_moe``
(2 layers, 4/2 heads of 8, 4 experts top-2, untied head) is initialised in
JAX and loaded into the port by ``from_jax_flat``; both run the same
numpy-seeded ids. Tolerances:

- logits within 1e-4 (padded and unpadded batches, cached prefill and decode
  steps), the gate probabilities and the training load-balance loss within
  1e-5 (fp32 sums in another order); each test first asserts that every
  token's top-2 margin exceeds 1e-4, so no expert choice rests on a near-tie;
- greedy ``generate_kv_cache`` tokens identical;
- ``from_jax_flat`` of a bf16 tree loads every leaf bit for bit, and of an
  int8 tree equals the port's own ``quantize_params_int8`` leaf for leaf (the
  walk selecting exactly JAX's leaves); the int8 model's logits within 1e-4
  of JAX's on the same quantized tree (K11's plain version here, JAX's
  dequantized ``ragged_dot`` on the CPU);
- an int8 model at head dim 128 with the int8 KV cache, so the decode steps
  take K10's plain version (spied) where JAX's router takes the Pallas
  kernel: cached logits within 1e-4, tokens identical;
- the dispatch's group sizes: equal to ``torch.bincount``'s, and the int8
  layer runs with ``torch.bincount`` and ``Tensor.tolist`` patched to raise
  (K11's plain version, the CPU stand-in for a kernel that reads the sizes on
  the device, reads them through the unpatched ``tolist``);
- ``quantize_params_int8`` leaves no reference to a module it replaced.

Qwen3-30B-A3B itself is built on the meta device only: its parameter count
against the published 30.53 B.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import config as tconfig
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.kernels import flash_decode as kfd
from llm_quest_tpu_torch.kernels import quantized_gmm as kqg
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.ops import moe as tmoe
from llm_quest_tpu_torch.ops import quantization as tquant
from llm_quest_tpu_torch.weights.interop import from_jax_flat

# tests/test_serving.py::test_serving_qwen3_next_and_moe's moe_cfg
MOE_CFG = {
    "model_type": "moe", "vocab_size": 128, "context_length": 64,
    "emb_dim": 32, "n_layers": 2, "n_heads": 4, "num_kv_groups": 2,
    "head_dim": 8, "moe_hidden_dim": 64, "num_experts": 4, "top_k": 2,
    "aux_loss_coef": 0.001, "rope_base": 10_000, "tie_embeddings": False,
}
# head dim 128 with the int8 KV cache: the decode steps stream the cache through K10
D128_CFG = dict(MOE_CFG, head_dim=128, kv_quant="int8")
MARGIN = 1e-4
B, S = 2, 11


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    return float(np.abs(got.detach().float().numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


def ids_np(seed, b=B, s=S):
    return np.random.default_rng(seed).integers(1, MOE_CFG["vocab_size"], (b, s)).astype(np.int32)


def top2_margins(gate_probas):
    """Per token, the gap between the k-th and the (k+1)-th gate probability of every layer."""
    top = torch.topk(torch.stack(gate_probas), MOE_CFG["top_k"] + 1, dim=-1).values
    return (top[..., -2] - top[..., -1]).flatten()


@pytest.fixture(scope="module")
def trees():
    jcfg = dict(MOE_CFG, dtype=jnp.float32)
    fp = jq3.init(jax.random.PRNGKey(2), jcfg)
    d128 = jquant.quantize_params_int8(jq3.init(jax.random.PRNGKey(4), dict(D128_CFG, dtype=jnp.float32)),
                                       min_size=0)
    return {"fp": fp, "int8": jquant.quantize_params_int8(fp, min_size=0), "d128": d128}


def port(tree, cfg):
    return from_jax_flat(flat(tree), dict(cfg, dtype=torch.float32), device="cpu")


@pytest.fixture(scope="module")
def models(trees):
    return {"fp": port(trees["fp"], MOE_CFG), "int8": port(trees["int8"], MOE_CFG), "d128": port(trees["d128"], D128_CFG)}


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("size", ["temp_dense", "0.6B", "1.7B", "4B", "temp_moe", "30B-A3B"])
def test_config_creator_matches_jax(size):
    got = tconfig.qwen3_config_creator(size)
    ref = jconfig.qwen3_config_creator(size)
    assert {k: v for k, v in got.items() if k != "dtype"} == {k: v for k, v in ref.items() if k != "dtype"}
    assert got["dtype"] == torch.bfloat16


@pytest.mark.parametrize("size,billions", [("temp_moe", None), ("30B-A3B", 30.53)])
def test_moe_configs_build(size, billions):
    """``Qwen3`` builds both MoE entries (on the meta device: no memory); the
    parameter count against the published size, and each block's expert
    stacks (E, d, hidden) for lin1/gate and (E, hidden, d) for lin2."""
    cfg = tconfig.qwen3_config_creator(size)
    model = tq3.Qwen3(cfg, device="meta")
    e, d, hidden = cfg["num_experts"], cfg["emb_dim"], cfg["moe_hidden_dim"]
    experts = model.blocks[0].moe.experts
    assert tuple(experts["lin1"].shape) == tuple(experts["gate"].shape) == (e, d, hidden)
    assert tuple(experts["lin2"].shape) == (e, hidden, d)
    assert not hasattr(model.blocks[0], "ffn") and not hasattr(model.blocks[0].moe, "shared")
    assert tuple(model.out.w.shape) == (cfg["vocab_size"], d)
    if billions is not None:
        n = sum(p.numel() for p in model.parameters())
        assert round(n / 1e9, 2) == billions


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("padded", [False, True])
def test_apply_matches_jax(trees, models, padded):
    jparams, model = trees["fp"], models["fp"]
    jcfg, tcfg = dict(MOE_CFG, dtype=jnp.float32), dict(MOE_CFG, dtype=torch.float32)
    ids = ids_np(1)
    mask = np.ones((B, S), bool)
    if padded:
        mask[1, -4:] = False
    kw = {"attn_mask": mask} if padded else {}
    jl, _, jaux = jq3.apply(jparams, jcfg, jnp.asarray(ids), training=True,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        tl, cache, aux = tq3.apply(model, tcfg, T(ids).long(), training=True, **{k: T(v) for k, v in kw.items()})
    assert cache is None
    assert float(top2_margins(aux["gate_probas"]).min()) > MARGIN
    assert max_err(tl, jl) <= 1e-4
    assert len(aux["gate_probas"]) == MOE_CFG["n_layers"]
    for got, ref in zip(aux["gate_probas"], jaux["gate_probas"]):
        assert max_err(got, ref) <= 1e-5
    assert abs(float(aux["moe_loss"]) - float(jaux["moe_loss"])) <= 1e-5
    with torch.no_grad():
        _, _, eval_aux = tq3.apply(model, tcfg, T(ids).long())
    assert "moe_loss" not in eval_aux


@pytest.mark.parametrize("variant", ["fp", "int8"])
def test_cached_prefill_and_decode_match_jax(trees, models, variant):
    """A right-padded cached prefill (row 1 with 3 pads) then three decode
    steps at per-row positions; logits after each call within 1e-4."""
    jparams, model = trees[variant], models[variant]
    jcfg, tcfg = dict(MOE_CFG, dtype=jnp.float32), dict(MOE_CFG, dtype=torch.float32)
    ids = ids_np(3)
    max_len = S + 4
    mask = np.zeros((B, max_len), bool)
    mask[:, :S] = True
    mask[1, S - 3:S] = False
    jc, tc = jq3.init_cache(jcfg, B, max_len), tq3.init_cache(tcfg, B, max_len, device="cpu")
    jl, jc, _ = jq3.apply(jparams, jcfg, jnp.asarray(ids), attn_mask=jnp.asarray(mask), cache=jc)
    with torch.no_grad():
        tl, tc, aux = tq3.apply(model, tcfg, T(ids).long(), attn_mask=T(mask), cache=tc)
    assert float(top2_margins(aux["gate_probas"]).min()) > MARGIN
    assert max_err(tl, jl) <= 1e-4
    pos = np.asarray([[S], [S - 3]])
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        mask[:, S + i] = True
        jl, jc, _ = jq3.apply(jparams, jcfg, jnp.asarray(tok), attn_mask=jnp.asarray(mask), cache=jc,
                              position_ids=jnp.asarray(pos + i))
        with torch.no_grad():
            tl, tc, _ = tq3.apply(model, tcfg, T(tok).long(), attn_mask=T(mask), cache=tc,
                                  position_ids=T(pos + i).long())
        assert max_err(tl, jl) <= 1e-4, i


@pytest.mark.parametrize("variant", ["fp", "int8"])
def test_generate_kv_cache_tokens_match_jax(trees, models, variant):
    ids = ids_np(5)
    ref = jgen.generate_kv_cache(jq3, trees[variant], dict(MOE_CFG, dtype=jnp.float32), jnp.asarray(ids),
                                 max_gen=6, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq3, models[variant], dict(MOE_CFG, dtype=torch.float32), T(ids).long(),
                                 max_gen=6, eos_ids=-1, pad_id=0)
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()


def test_int8_head_dim_128_takes_k10_and_matches_jax(trees, models, monkeypatch):
    """int8 linears and experts with the int8 KV cache at head dim 128: each
    decode step's attention goes through K10 (its plain version here), the
    cached logits within 1e-4 of JAX's and the greedy tokens identical."""
    jparams, model = trees["d128"], models["d128"]
    jcfg, tcfg = dict(D128_CFG, dtype=jnp.float32), dict(D128_CFG, dtype=torch.float32)
    calls = []
    real = kfd.flash_decode
    monkeypatch.setattr(kfd, "flash_decode", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    ids = ids_np(7)
    jc, tc = jq3.init_cache(jcfg, B, S + 3), tq3.init_cache(tcfg, B, S + 3, device="cpu")
    for _ in range(3):
        jl, jc, _ = jq3.apply(jparams, jcfg, jnp.asarray(ids), cache=jc)
        with torch.no_grad():
            tl, tc, _ = tq3.apply(model, tcfg, T(ids).long(), cache=tc)
        assert max_err(tl, jl) <= 1e-4
        ids = np.asarray(jnp.argmax(jl[:, -1:], -1), np.int32)
    assert len(calls) == 2 * MOE_CFG["n_layers"]  # the two decode steps, every layer
    ids = ids_np(8)
    ref = jgen.generate_kv_cache(jq3, jparams, jcfg, jnp.asarray(ids), max_gen=5, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq3, model, tcfg, T(ids).long(), max_gen=5, eos_ids=-1, pad_id=0)
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()


# ------------------------------------------------------------------ weights


def test_from_jax_flat_loads_a_bf16_tree():
    jtree = jq3.init(jax.random.PRNGKey(6), dict(MOE_CFG, dtype=jnp.bfloat16))
    jflat = flat(jtree)
    model = from_jax_flat(jflat, dict(MOE_CFG, dtype=torch.bfloat16), device="cpu")
    state = model.state_dict()
    assert set(state) == {k.replace("/", ".") for k in jflat}
    assert {"blocks.1.moe.experts.lin1", "blocks.1.moe.experts.gate", "blocks.1.moe.experts.lin2",
            "blocks.1.moe.gate_w", "out.w"} <= set(state)
    for name, arr in jflat.items():
        t = state[name.replace("/", ".")]
        ref = np.asarray(arr, np.float32)
        if name.endswith("/w") and arr.ndim == 2 and name != "tok_emb/w":  # Linear weights come transposed
            ref = ref.T
        assert t.dtype == torch.bfloat16 and np.array_equal(t.float().numpy(), ref), name


@pytest.mark.parametrize("options", [{}, {"min_size": 0}, {"quantize_experts": False, "min_size": 0},
                                     {"exclude": r"tok_emb|experts"}],
                         ids=["default", "min_size0", "no_experts", "exclude_experts"])
def test_int8_walk_matches_jax_and_from_jax_flat(trees, options):
    """The walk quantizes exactly JAX's leaves of the MoE tree, and the
    quantized JAX tree loaded by ``from_jax_flat`` equals the port's own
    quantization of the fp model, leaf for leaf and bit for bit."""
    jflat = flat(jquant.quantize_params_int8(trees["fp"], **options))
    mine = tquant.quantize_params_int8(port(trees["fp"], MOE_CFG), **options).state_dict()
    assert set(mine) == {k.replace("/", ".") for k in jflat}
    loaded = from_jax_flat(jflat, dict(MOE_CFG, dtype=torch.float32), device="cpu").state_dict()
    for name, t in mine.items():
        assert loaded[name].dtype == t.dtype and torch.equal(loaded[name], t), name


def test_int8_logits_match_jax(trees, models):
    ids = ids_np(9)
    jl, _, _ = jq3.apply(trees["int8"], dict(MOE_CFG, dtype=jnp.float32), jnp.asarray(ids))
    with torch.no_grad():
        tl, _, aux = tq3.apply(models["int8"], dict(MOE_CFG, dtype=torch.float32), T(ids).long())
    assert "lin1_q" in models["int8"].blocks[0].moe.experts
    assert float(top2_margins(aux["gate_probas"]).min()) > MARGIN
    assert max_err(tl, jl) <= 1e-4


def test_quantize_leaves_no_reference_to_replaced_modules():
    """Each replaced module is freed as the walk goes: weak references to an
    old expert stack and an old linear die with the walk, nothing else holding
    them."""
    model = tq3.init(dict(MOE_CFG, dtype=torch.float32), generator=torch.Generator().manual_seed(0), device="cpu")
    stack, lin = weakref.ref(model.blocks[1].moe.experts), weakref.ref(model.blocks[0].att.wq)
    tquant.quantize_params_int8(model, min_size=0)
    gc.collect()
    assert stack() is None and lin() is None
    assert "lin1_q" in model.blocks[1].moe.experts and hasattr(model.blocks[0].att.wq, "w_q")


# ------------------------------------------------------------------ dispatch counts


@pytest.mark.parametrize("e,shape", [(4, (7, 2)), (128, (256, 8)), (16, (1, 4))])
def test_assignment_counts_equal_bincount(e, shape):
    idx = torch.from_numpy(np.random.default_rng(e).integers(0, e, shape))
    got = tmoe.assignment_counts(idx, e)
    assert got.dtype == torch.long and got.shape == (e,)
    assert torch.equal(got, torch.bincount(idx.reshape(-1), minlength=e))


def test_int8_moe_layer_reads_no_group_sizes_on_the_host(models, monkeypatch):
    """The int8 layer's dispatch counts its groups on the device and hands
    them to K11 as a tensor: with ``torch.bincount`` and ``Tensor.tolist``
    raising it still runs, and gives the unpatched output. K11's plain
    version (the CPU stand-in for the kernel, which reads the sizes on the
    card) takes them through the unpatched ``tolist``."""
    layer = models["int8"].blocks[0].moe
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 5, MOE_CFG["emb_dim"])).astype(np.float32))
    with torch.no_grad():
        ref, _ = tmoe.qwen3_moe(layer, x, top_k=2, load_coeff=0.0, training=False)
    tolist, plain = torch.Tensor.tolist, kqg.quantized_ragged_dot_plain
    seen = []

    def stand_in(x, w_q, scale, group_sizes):
        seen.append(tolist(group_sizes))
        torch.Tensor.tolist = tolist
        try:
            return plain(x, w_q, scale, group_sizes)
        finally:
            torch.Tensor.tolist = refuse

    def refuse(*_, **__):
        raise AssertionError("a host read of the group sizes")

    monkeypatch.setattr(kqg, "quantized_ragged_dot_plain", stand_in)
    monkeypatch.setattr(torch, "bincount", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    with torch.no_grad():
        got, _ = tmoe.qwen3_moe(layer, x, top_k=2, load_coeff=0.0, training=False)
    monkeypatch.undo()
    assert len(seen) == 3 and all(sum(s) == 10 * 2 for s in seen)  # lin1, gate, lin2 over T·k rows
    assert torch.equal(got, ref)
