"""The ported LoRA family (``llm_quest_tpu_torch/ops/lora.py``) against the
JAX package's ``ops/lora.py``, on the CPU in fp32, at small sizes.

Inputs come from numpy with a seed, or from JAX's own transforms carried
across by ``from_jax_flat``. Tolerances:

- ``lora_delta`` of each variant, single and stacked per row, at (b, d) and
  (b, s, d): within 1e-6 of max |JAX| (fp32 products of rank 4 or 8 summed
  in another order);
- the model's logits through wrapped linears (single or stacked, the rows
  taking different adapters) within 1e-5 of max |JAX|; leaves loaded by
  ``from_jax_flat`` equal JAX's bit for bit (bf16 ones included);
- ``merge_adapter`` over fp32 and int8 bases: every merged weight within
  1e-6 of JAX's (an fp32 product of rank 4 added to the base);
- the wrapped paths under JAX's filters, the trainable set, the carried
  adapters of ``quantize_params_int8``: exactly JAX's;
- the tied TinyLoRA v's gradient within 1e-5 of max |JAX's summed one|;
- the inits: A's standard deviation within 5 % of 0.02 over 4,096 draws
  (the sample std of n normals sits within 5 % with p > 0.999 at n 4,096),
  mean within 4 std errors; LoRA-XS/Tiny A and B equal to JAX's (numpy's
  SVD of the same weight).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.models import qwen3_5 as jq35
from llm_quest_tpu.ops import lora as jl
from llm_quest_tpu.ops.quantization import quantize_params_int8 as jquantize
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_5 as tq35
from llm_quest_tpu_torch.ops import lora as tl
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.ops.quantization import QuantLinear, quantize_params_int8
from llm_quest_tpu_torch.weights.interop import from_jax_flat

# tests/test_serving.py's dense config and VLM_CFG (tests/test_torch_serving_vlm.py)
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
VARIANTS = ["lora", "lora_xs", "tiny_lora"]
FILTERS = {
    "all": None,
    "att_ffn": lambda p: "att" in p or "ffn" in p,
    "att": lambda p: "att" in p,
    "text_att": lambda p: "/text/" in p and "att" in p,
}
IDS = np.asarray([[5, 17, 99, 3, 64, 2, 41], [8, 1, 77, 120, 9, 33, 6], [11, 12, 13, 14, 15, 16, 17]], np.int32)


def jcfg(cfg, dtype=jnp.float32):
    return dict(cfg, dtype=dtype)


def tcfg(cfg, dtype=torch.float32):
    return dict(cfg, dtype=dtype)


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def port(params, cfg, dtype=torch.float32):
    return from_jax_flat(flat(params), tcfg(cfg, dtype), device="cpu")


def rel_err(got, ref):
    got = got.detach().float().numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def randomized(params, key, variant="lora", rank=4, alpha=8, path_filter=FILTERS["att_ffn"], **kw):
    """JAX's ``replace_with_lora`` with every trainable leaf drawn nonzero
    (B for LoRA, R for XS, v for Tiny), as tests/test_serving.py does."""
    tree = jl.replace_with_lora(key, params, rank, alpha, variant=variant, path_filter=path_filter, **kw)
    leaf = {"lora": "B", "lora_xs": "R", "tiny_lora": "v"}[variant]
    size = {"lora": 0.2, "lora_xs": 0.3, "tiny_lora": 0.05}[variant]

    def walk(node):
        if isinstance(node, dict):
            if "lora" in node and leaf in node["lora"]:
                x = node["lora"][leaf]
                noise = size * jax.random.normal(jax.random.fold_in(key, x.size), x.shape)
                return {**node, "lora": {**node["lora"], leaf: noise.astype(x.dtype)}}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


@pytest.fixture(scope="module")
def dense():
    return jq3.init(jax.random.PRNGKey(0), jcfg(CFG))


# ----------------------------------------------------------------- lora_delta


def lora_leaves(rng, variant, n, d, r, k, u=13):
    """numpy leaves of n adapters (leading axis n, or none when n is None)."""
    lead = () if n is None else (n,)
    leaves = {"A": rng.standard_normal(lead + (d, r)) * 0.3, "B": rng.standard_normal(lead + (r, k)) * 0.3,
              "scale": np.asarray(rng.uniform(0.5, 3.0, lead))}
    if variant == "lora_xs":
        leaves["R"] = rng.standard_normal(lead + (r, r))
    if variant == "tiny_lora":
        leaves["P"] = rng.standard_normal(lead + (u, r * r))
        leaves["v"] = rng.standard_normal(lead + (u,)) * 0.3
    return {name: a.astype(np.float32) for name, a in leaves.items()}


@pytest.mark.parametrize("shape", [(3, 24), (3, 5, 24)], ids=["b_d", "b_s_d"])
@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_lora_delta_matches_jax(variant, stacked, shape):
    rng = np.random.default_rng(1)
    leaves = lora_leaves(rng, variant, 4 if stacked else None, 24, 4, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    jlora = {k: jnp.asarray(v) for k, v in leaves.items()}
    tlora = tl.LoRA(index=tl.AdapterIndex() if stacked else None,
                    **{k: torch.from_numpy(v) for k, v in leaves.items()})
    if stacked:
        idx = np.asarray([2, 0, 3], np.int32)
        jlora["idx"] = jnp.asarray(idx)
        tlora.index.idx = torch.from_numpy(idx).long()
    ref = jl.lora_delta(jlora, jnp.asarray(x))
    got = tl.lora_delta(tlora, torch.from_numpy(x))
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= 1e-6
    if stacked:  # row i takes adapter idx[i]: the single form on that adapter's leaves
        for i, a in enumerate(idx):
            one = tl.LoRA(**{k: torch.from_numpy(np.asarray(v[a])) for k, v in leaves.items()})
            assert rel_err(got[i], tl.lora_delta(one, torch.from_numpy(x[i : i + 1]))[0].numpy()) <= 1e-6


def test_stacked_delta_without_selection_raises():
    leaves = lora_leaves(np.random.default_rng(0), "lora", 2, 8, 2, 8)
    lora = tl.LoRA(index=tl.AdapterIndex(), **{k: torch.from_numpy(v) for k, v in leaves.items()})
    with pytest.raises(ValueError, match="select_adapter"):
        tl.lora_delta(lora, torch.zeros(1, 8))


# ------------------------------------------------------- models, loads, merges


def base_tree(dense, base):
    if base == "bf16":
        return jq3.init(jax.random.PRNGKey(0), jcfg(CFG, jnp.bfloat16))
    if base == "int8":
        return jquantize(dense, min_size=0)
    return dense


@pytest.mark.parametrize("base", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_from_jax_flat_loads_adapters(dense, variant, stacked, base):
    """Single and stacked trees of each variant over each base load leaf for
    leaf; in fp32 (int8 weights with fp32 activations included) the logits
    equal JAX's, the rows of a stacked model taking different adapters."""
    params = base_tree(dense, base)
    key = jax.random.PRNGKey(3)
    trees = [randomized(params, jax.random.fold_in(key, a), variant) for a in range(2 if stacked else 1)]
    tree = jl.stack_adapters(trees) if stacked else trees[0]
    dtype = torch.bfloat16 if base == "bf16" else torch.float32
    model = port(tree, CFG, dtype)
    state = model.state_dict()
    leaves = {k: v for k, v in flat(tree).items() if "/lora/" in k}
    assert leaves and {k.replace(".", "/") for k in state if ".lora." in k} == set(leaves)
    for name, arr in leaves.items():
        got = state[name.replace("/", ".")]
        assert got.dtype == (torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32)
        assert np.array_equal(got.float().numpy(), arr.astype(np.float32)), name
    assert tl.num_adapters(model) == (3 if stacked else 0) == jl.num_adapters(tree)
    if base == "bf16":
        return
    idx = np.asarray([1, 0, 2], np.int32)
    jparams = jl.select_adapter(tree, jnp.asarray(idx)) if stacked else tree
    ref, _, _ = jq3.apply(jparams, jcfg(CFG), jnp.asarray(IDS))
    tl.select_adapter(model, torch.from_numpy(idx).long())
    got, _, _ = tq3.apply(model, tcfg(CFG), torch.from_numpy(IDS).long())
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("base", ["fp32", "int8"])
def test_merge_adapter_matches_jax(dense, base):
    """Each stacked adapter (the null one included) merges into the same
    dense weights as JAX's ``merge_adapter``; the merged model's logits
    equal the stacked model's rows selecting that adapter."""
    params = base_tree(dense, base)
    key = jax.random.PRNGKey(4)
    stacked = jl.stack_adapters([randomized(params, jax.random.fold_in(key, a)) for a in range(2)])
    model = port(stacked, CFG)
    for j in range(3):
        ref = flat(jl.merge_adapter(stacked, j))
        merged = tl.merge_adapter(model, j)
        state = merged.state_dict()
        assert tl.num_adapters(merged) == 0 and set(state) == {k.replace("/", ".") for k in ref}
        for name, arr in ref.items():
            got = state[name.replace("/", ".")]
            owner = merged.get_submodule(name.replace("/", ".").rsplit(".", 1)[0])
            is_w = isinstance(owner, (Linear, QuantLinear)) and name.rsplit("/", 1)[-1] in ("w", "w_q")
            assert rel_err(got.T if is_w else got, arr) <= 1e-6, name
        ids = torch.from_numpy(IDS).long()
        tl.select_adapter(model, torch.full((3,), j))
        want, _, _ = tq3.apply(merged, tcfg(CFG), ids)
        got, _, _ = tq3.apply(model, tcfg(CFG), ids)
        assert rel_err(got, want.detach().numpy()) <= 1e-5
    assert tl.num_adapters(model) == 3  # the stacked model is left as it was


# ---------------------------------------------------------- walks and masks


def port_wrapped(model, path_filter, **kw):
    tl.replace_with_lora(torch.Generator().manual_seed(0), model, 4, 8, path_filter=path_filter, **kw)
    return {tl._path(name).rsplit("/lora", 1)[0] for name, _ in tl.lora_modules(model)}


def jax_wrapped(tree):
    return {"/" + k.rsplit("/lora/", 1)[0] for k in flatten_params(tree) if "/lora/A" in k}


@pytest.mark.parametrize("filt", list(FILTERS))
@pytest.mark.parametrize("which", ["dense", "int8", "vlm"])
def test_replace_with_lora_wraps_jax_paths(dense, which, filt):
    """The same linears wrap in both packages (the VLM's tree by its shapes
    alone: the walk reads structure, not values)."""
    if which == "vlm":
        params = jax.eval_shape(lambda k: jq35.init(k, jcfg(VLM_CFG)), jax.random.PRNGKey(0))
        model = tq35.init(tcfg(VLM_CFG), generator=torch.Generator().manual_seed(0), device="cpu")
    else:
        params = dense if which == "dense" else jquantize(dense, min_size=0)
        model = port(params, CFG)
    ref = jax_wrapped(jl.replace_with_lora(jax.random.PRNGKey(0), params, 4, 8, path_filter=FILTERS[filt]))
    got = port_wrapped(model, FILTERS[filt])
    assert got == ref and (got or filt == "text_att" and which != "vlm")
    for name, lora in tl.lora_modules(model):
        assert isinstance(model.get_submodule(name.rsplit(".", 1)[0]), (QuantLinear if which == "int8" else Linear))


@pytest.mark.parametrize("variant", VARIANTS)
def test_lora_trainable_mask_matches_jax(dense, variant):
    tree = randomized(dense, jax.random.PRNGKey(5), variant)
    ref = {k for k, v in flatten_params(jl.lora_trainable_mask(tree)).items() if v}
    model = port(tree, CFG)
    mask = tl.lora_trainable_mask(model)
    assert {k.replace(".", "/") for k, v in mask.items() if v} == ref
    assert {n for n, p in model.named_parameters() if p.requires_grad} == {k for k, v in mask.items() if v}


def test_quantize_params_int8_carries_adapters(dense):
    """JAX wraps, then quantizes; the port loads the wrapped fp tree and
    quantizes it: the same int8 leaves and the adapters unquantized, on
    ``QuantLinear``s."""
    tree = randomized(dense, jax.random.PRNGKey(6))
    ref = flat(jquantize(tree, min_size=0))
    model = quantize_params_int8(port(tree, CFG), min_size=0)
    state = model.state_dict()
    assert set(state) == {k.replace("/", ".") for k in ref}
    for name, arr in ref.items():
        got = state[name.replace("/", ".")]
        got = got.T if name.endswith("/w_q") else got
        assert np.array_equal(got.numpy(), arr), name
    wrapped = [name.rsplit(".", 1)[0] for name, _ in tl.lora_modules(model)]
    assert wrapped and all(isinstance(model.get_submodule(n), QuantLinear) for n in wrapped)


# --------------------------------------------------------------- tied TinyLoRA


def test_tied_tiny_lora_v_gradient_matches_jax_sum(dense):
    """One v tied over every TinyLoRA: the port's shared parameter's
    gradient (autograd's sum) equals JAX's ``collect_shared_v_grad`` of the
    per-layer gradients of the injected tree."""
    tree = jl.replace_with_lora(jax.random.PRNGKey(7), dense, 4, 8, variant="tiny_lora", shared_v=True,
                                path_filter=FILTERS["att_ffn"])
    v = np.random.default_rng(7).standard_normal(13).astype(np.float32) * 0.1
    w = np.random.default_rng(8).standard_normal((3, 7, CFG["vocab_size"])).astype(np.float32)
    ids = jnp.asarray(IDS)

    def loss(p):
        return jnp.sum(jq3.apply(p, jcfg(CFG), ids)[0] * w)

    grads = jax.jit(jax.grad(loss))(jl.inject_shared_v(tree, jnp.asarray(v)))
    ref = jl.collect_shared_v_grad(grads)
    model = port(jl.inject_shared_v(tree, jnp.asarray(v)), CFG)
    shared = torch.nn.Parameter(torch.from_numpy(v.copy()))
    tl.inject_shared_v(model, shared)
    assert all(lora["v"] is shared for _, lora in tl.lora_modules(model))
    logits, _, _ = tq3.apply(model, tcfg(CFG), torch.from_numpy(IDS).long())
    (logits * torch.from_numpy(w)).sum().backward()
    got = tl.collect_shared_v_grad(model)
    assert rel_err(got, ref) <= 1e-5
    assert torch.equal(got, shared.grad)


# ----------------------------------------------------------------------- inits


def test_init_lora_distribution_and_dtypes():
    g = torch.Generator().manual_seed(0)
    lin = Linear(4096, 48, bias=False, dtype=torch.float32)
    lin.reset_parameters(torch.Generator().manual_seed(1))
    lora = tl.init_lora(g, lin, 8, 16)
    A = lora["A"].double()
    assert A.shape == (4096, 8) and lora["B"].shape == (8, 48) and not lora["B"].any()
    assert abs(A.std().item() / 0.02 - 1) < 0.05 and abs(A.mean().item()) < 4 * 0.02 / A.numel() ** 0.5
    assert lora["scale"].item() == 2.0 and lora["scale"].dtype == torch.float32
    again = tl.init_lora(torch.Generator().manual_seed(0), lin, 8, 16)
    assert torch.equal(again["A"], lora["A"])  # seeded
    q = quantize_params_int8(torch.nn.Sequential(lin), min_size=0)[0]
    assert tl.init_lora(g, q, 8, 16)["A"].dtype == torch.float32  # an int8 base: its scales' dtype
    assert tl.init_lora(g, lin, 8, 16, dtype=torch.bfloat16)["B"].dtype == torch.bfloat16


@pytest.mark.parametrize("variant", ["lora_xs", "tiny_lora"])
def test_svd_inits_match_jax(dense, variant):
    """The frozen A/B of LoRA-XS and TinyLoRA equal JAX's (the same SVD of
    the same weight, fp32 and int8); R ~ N(0, 1e-5), P ~ N(0, 1), v zero."""
    for params in (dense, jquantize(dense, min_size=0)):
        lin = params["blocks"][0]["ffn"]["gate"]
        ref = (jl.init_lora_xs if variant == "lora_xs" else jl.init_tiny_lora)(jax.random.PRNGKey(0), lin, 4, 8)
        model = port(params, CFG)
        got = (tl.init_lora_xs if variant == "lora_xs" else tl.init_tiny_lora)(
            torch.Generator().manual_seed(0), model.blocks[0].ffn["gate"], 4, 8)
        for leaf in ("A", "B", "scale"):
            assert rel_err(got[leaf], ref[leaf]) <= 1e-6, leaf
    big = Linear(64, 64, bias=False, dtype=torch.float32)
    big.reset_parameters(torch.Generator().manual_seed(2))
    if variant == "lora_xs":
        R = tl.init_lora_xs(torch.Generator().manual_seed(3), big, 64, 8)["R"].double()
        assert abs(R.std().item() / 1e-5 - 1) < 0.05
    else:
        lora = tl.init_tiny_lora(torch.Generator().manual_seed(3), big, 16, 8, num_trainable_params=16)
        P = lora["P"].double()
        assert abs(P.std().item() - 1) < 0.05 and not lora["v"].any()
        assert "v" not in tl.init_tiny_lora(torch.Generator(), big, 4, 8, shared_v=True)
