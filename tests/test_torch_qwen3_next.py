"""The ported Qwen3-Next hybrid training path against the JAX package, on the CPU.

The tiny configuration of ``tests/test_training.py`` (4 blocks: three
GatedDeltaNet and one GatedAttention; 4 experts, top-2, a shared expert) is
initialised in JAX, flattened and loaded into the port with
``from_jax_flat``; both packages run in fp32 on the same numpy-seeded
batches. JAX runs its flash-attention Pallas kernel in interpret mode
(``use_flash=True`` and ``flash_min_seq`` below the sequence length), and
``gdn_chunk_size=16`` splits the 40-token sequence into three chunks, the
last one padded, in both packages. Tolerances:

- logits within 1e-4 (the bar of the other port tests);
- ``qwen3_moe`` output and ``moe_loss`` within 1e-5, gradients within 1e-5
  relative to max(1, max |g|) (fp32 sums in another order);
- the fused-CE loss within 1e-5 relative and every gradient within 1e-4
  relative to max(1, max |g|) (the GDN and attention backward run in other
  forms: the port's per-chunk replay and plain attention against JAX's
  autograd through the chunked form and the Pallas kernel's VJP); the train
  step's losses within 1e-5 relative and the parameters within 3e-4 (0.3 of
  the learning rate: Adam's m/√v turns the fp32 noise of a near-zero
  gradient into an update of up to the learning rate) after 2 steps;
- exact dispatch equals capacity dispatch at factor 4.0 within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.models import qwen3_next as jq
from llm_quest_tpu.ops import losses as jlosses
from llm_quest_tpu.ops import moe as jmoe
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import config as tconfig
from llm_quest_tpu_torch.models import qwen3_next as tq
from llm_quest_tpu_torch.ops import moe as tmoe
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {k: v for k, v in jconfig.QWEN3_NEXT_SMALL_CONFIG.items() if k != "dtype"}
TINY.update(
    n_layers=4, emb_dim=64, head_dim=16, n_heads=4, num_kv_groups=2,
    linear_num_qk_heads=2, linear_num_value_heads=4, linear_qk_head_dim=16, linear_value_head_dim=16,
    moe_hidden_dim=96, shared_expert_hidden_dim=96, num_experts=4, top_k=2,
    vocab_size=256, context_length=64, p_dropout=0.0, gradient_checkpointing=False,
    flash_min_seq=16, gdn_chunk_size=16,
)
JCFG = dict(TINY, dtype=jnp.float32, use_flash=True)  # the flash Pallas kernel, interpret mode
TCFG = dict(TINY, dtype=torch.float32)
B, S = 2, 40
CAPACITY = {"exact": None, "capacity": 1.25}


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(ref, np.float64)).max())


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(np.asarray(ref, np.float64)).max()))


def batch_np(seed, padded=False):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S + 1)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}
    if padded:  # right padding: row 1 has 9 pad tokens, ignored as targets
        mask = np.ones((B, S), bool)
        mask[1, -9:] = False
        batch["attn_mask"] = mask
        batch["targets"] = np.where(mask, batch["targets"], -100).astype(np.int32)
    return batch


def with_capacity(cfg, mode):
    return cfg if CAPACITY[mode] is None else dict(cfg, moe_capacity_factor=CAPACITY[mode])


@pytest.fixture(scope="module")
def jparams():
    return jq.init(jax.random.PRNGKey(0), JCFG)


def torch_name(jax_name):
    return jax_name.replace("/", ".")


def jax_leaf_as_torch_layout(model, name, arr):
    """A JAX leaf in the port's layout: Linear weights transposed."""
    module_name = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(module_name), Linear):
        return np.asarray(arr).T
    return np.asarray(arr)


# ------------------------------------------------------------------ config, weights


def test_config_matches_jax():
    dtypes = {jnp.bfloat16: torch.bfloat16}
    ref = {k: dtypes.get(v, v) if k == "dtype" else v for k, v in jconfig.QWEN3_NEXT_SMALL_CONFIG.items()}
    assert tconfig.QWEN3_NEXT_SMALL_CONFIG == ref


def test_from_jax_flat_builds_qwen3_next_and_rejects_bad_trees(jparams):
    f = flat(jparams)
    model = from_jax_flat(f, TCFG, device="cpu")
    assert isinstance(model, tq.Qwen3Next)
    assert all(p.requires_grad for p in model.parameters())
    assert {n.replace(".", "/") for n, _ in model.named_parameters()} == set(f)
    missing = {k: v for k, v in f.items() if k != "blocks/0/moe/gate_w"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat(missing, TCFG, device="cpu")
    bad = dict(f, **{"blocks/3/att/wqg/w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(bad, TCFG, device="cpu")


def test_hybrid_tree_with_moe_leaves_is_never_a_qwen3_5_model(jparams):
    """A Qwen3-Next tree under a config without the MoE keys is told apart
    by its "moe/" names: it fails as a Qwen3-Next, not as a Qwen3.5 text model."""
    cfg = {k: v for k, v in TCFG.items() if k not in ("num_experts",)}
    with pytest.raises(KeyError, match="num_experts"):
        from_jax_flat(flat(jparams), cfg, device="cpu")


def test_cached_paths_raise():
    """The cached path refuses a KV cache type other than the model's or
    int8 (JAX's Qwen3-Next cache reads any other ``kv_quant`` as none and
    gives the bf16 cache; the port's shared cache raises)."""
    with pytest.raises(ValueError, match="quant must be None or 'int8'"):
        tq.init_cache(dict(TCFG, kv_quant="int4"), B, S, device="cpu")


def test_cached_paths_run_and_prefill_matches_uncached(jparams):
    """The cached paths are ported (tests/test_torch_qwen3_next_serving.py
    holds them to JAX): init_cache, a cached apply and a GDN decode step run,
    and a cached prefill gives the uncached forward's logits."""
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    ids = T(batch_np(0)["input_ids"]).long()
    cache = tq.init_cache(TCFG, B, S, device="cpu")
    assert set(cache) == set(jq.init_cache(JCFG, B, S))
    with torch.no_grad():
        cached, cache, _ = tq.apply(model, TCFG, ids, cache=cache)
        uncached, none, _ = tq.apply(model, TCFG, ids)
        step, convs, _ = tq.gated_delta_net_step(
            model.blocks[0].att, TCFG, torch.zeros(B, 1, TINY["emb_dim"]),
            {n: cache[n][0] for n in ("conv_q", "conv_k", "conv_v")}, cache["recurrent"], 0,
        )
    assert none is None and cache["pos"] == S
    assert max_err(cached, uncached.numpy()) <= 1e-4
    assert step.shape == (B, 1, TINY["emb_dim"]) and set(convs) == {"conv_q", "conv_k", "conv_v"}


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("padded", [False, True])
def test_apply_matches_jax(jparams, padded):
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    b = batch_np(1, padded)
    mask = b.get("attn_mask")
    ref, _, raux = jq.apply(jparams, JCFG, jnp.asarray(b["input_ids"]),
                            attn_mask=None if mask is None else jnp.asarray(mask), training=True)
    with torch.no_grad():
        got, cache, aux = tq.apply(model, TCFG, T(b["input_ids"]).long(),
                                   attn_mask=None if mask is None else T(mask), training=True)
    assert cache is None
    assert max_err(got, ref) <= 1e-4
    assert abs(float(aux["moe_loss"]) - float(raux["moe_loss"])) <= 1e-6
    assert len(aux["gate_probas"]) == TINY["n_layers"]
    for g, r in zip(aux["gate_probas"], raux["gate_probas"]):
        assert max_err(g, r) <= 1e-5


# ------------------------------------------------------------------ MoE


def moe_case(mode):
    """A JAX Qwen3-MoE at the tiny widths, its port twin, and an input."""
    cfg = dict(TINY, dtype=jnp.float32)
    jp = jmoe.init_qwen3_moe(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    module = tmoe.Qwen3MoE(TINY, torch.float32)
    state = module.state_dict()
    for name, arr in flat(jp).items():
        state[torch_name(name)].copy_(T(arr))
    x = np.random.default_rng(4).standard_normal((2, 16, TINY["emb_dim"])).astype(np.float32)
    cf = {"exact": None, "capacity": 1.25, "overflow": 0.5}[mode]
    return jp, module, x, cf


@pytest.mark.parametrize("mode", ["exact", "capacity", "overflow"])
def test_qwen3_moe_matches_jax(mode):
    jp, module, x, cf = moe_case(mode)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(params, x):
        out, aux = jmoe.qwen3_moe(params, x, top_k=2, load_coeff=0.01, capacity_factor=cf)
        return jnp.sum(out * w) + aux["moe_loss"], (out, aux["moe_loss"])

    (_, (rout, rmoe)), (rgp, rgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = T(x).requires_grad_()
    out, aux = tmoe.qwen3_moe(module, tx, top_k=2, load_coeff=0.01, capacity_factor=cf)
    loss = (out * T(w)).sum() + aux["moe_loss"]
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, [tx, *module.parameters()])
    assert max_err(out, rout) <= 1e-5
    assert abs(float(aux["moe_loss"].detach()) - float(rmoe)) <= 1e-5
    assert rel_err(grads[0], rgx) <= 1e-5
    ref = {torch_name(k): v for k, v in flat(rgp).items()}
    for name, g in zip(names, grads[1:]):
        assert rel_err(g, ref[name]) <= 1e-5, name
    if mode == "overflow":  # capacity ceil(0.5 · 32 · 2 / 4) = 8 rows against 16 a expert on average: rows drop
        _, idx = torch.topk(aux["gate_probas"], 2, dim=-1)
        assert int(torch.bincount(idx.reshape(-1), minlength=TINY["num_experts"]).max()) > 8


def test_load_balance_loss_and_router_init_match_jax():
    rng = np.random.default_rng(6)
    probas = rng.dirichlet(np.ones(4), size=10).astype(np.float32)
    idx = rng.integers(0, 4, (10, 2)).astype(np.int64)
    ref = jmoe.load_balance_loss(jnp.asarray(probas), jnp.asarray(idx), 4, 2)
    assert abs(float(tmoe.load_balance_loss(T(probas), T(idx), 4, 2)) - float(ref)) <= 1e-6
    w = rng.uniform(-0.1, 0.1, (64, 4)).astype(np.float32)
    assert max_err(tmoe.router_weights_init(T(w)), jmoe.router_weights_init(None, jnp.asarray(w))) <= 1e-6


# ------------------------------------------------------------------ training


def jax_loss_and_grads(jparams, cfg, batch):
    """JAX's fused-CE training loss (make_train_step's loss_fn) and its gradients."""

    def loss_fn(params):
        hidden, _, aux = jq.apply(params, cfg, batch["input_ids"], attn_mask=batch.get("attn_mask"),
                                  training=True, output_hidden_states=True)
        return jlosses.cross_entropy_fused_head(hidden, jq.head_weights(params, cfg), batch["targets"]) + aux["moe_loss"]

    return jax.jit(jax.value_and_grad(loss_fn))(jparams)


def port_loss_and_grads(model, cfg, batch):
    loss = tengine.make_loss_fn(tq, cfg, fused_head_ce=True)(model, tengine._as_tensors(batch, "cpu"))
    return float(loss.detach()), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("mode", ["exact", "capacity"])
def test_fused_ce_loss_and_gradients_match_jax(jparams, mode):
    b = batch_np(2)
    ref_loss, ref_grads = jax_loss_and_grads(jparams, with_capacity(JCFG, mode), {k: jnp.asarray(v) for k, v in b.items()})
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    loss, grads = port_loss_and_grads(model, with_capacity(TCFG, mode), b)
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = {torch_name(k): v for k, v in flat(ref_grads).items()}
    for (name, _), g in zip(model.named_parameters(), grads):
        assert rel_err(g, jax_leaf_as_torch_layout(model, name, ref[name])) <= 1e-4, name


def test_padded_batch_loss_matches_jax_and_gradients_are_finite(jparams):
    """Right padding: the loss matches JAX and every gradient is finite.
    Past the conv window, a pad token's q and k are zero vectors, and the
    gradient of the clamped L2 norm there is 0 · ∞ in JAX (its gradients come
    out NaN; ROADMAP Queue 3 records it), while the port's norm backward
    gives the clamped form's gradient."""
    b = batch_np(2, padded=True)
    jhidden, _, jaux = jq.apply(jparams, JCFG, jnp.asarray(b["input_ids"]), attn_mask=jnp.asarray(b["attn_mask"]),
                                training=True, output_hidden_states=True)
    ref = jlosses.cross_entropy_fused_head(jhidden, jq.head_weights(jparams, JCFG), jnp.asarray(b["targets"]))
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    loss, grads = port_loss_and_grads(model, TCFG, b)
    assert abs(loss - float(ref + jaux["moe_loss"])) <= 1e-5 * abs(float(ref))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("mode", ["exact", "capacity"])
def test_train_step_matches_jax(jparams, mode):
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    jstep = jengine.make_train_step(jq, with_capacity(JCFG, mode), jengine.make_optimizer(1e-3), fused_head_ce=True)
    tstep = tengine.make_train_step(tq, with_capacity(TCFG, mode), tengine.make_optimizer(1e-3), fused_head_ce=True)
    jp = jax.tree.map(jnp.copy, jparams)  # the JAX step donates its params
    jstate, tstate = jengine.make_optimizer(1e-3).init(jp), tengine.make_optimizer(1e-3).init(model)
    for i in range(2):
        b = batch_np(10 + i)
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        model, tstate, tloss = tstep(model, tstate, b)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert max_err(p, jax_leaf_as_torch_layout(model, name, ref[name.replace(".", "/")])) <= 3e-4, name


def test_exact_dispatch_equals_capacity_4(jparams):
    """Capacity ≥ the worst case drops nothing: the loss equals the exact
    dispatch's (the JAX package's own check, tests/test_training.py)."""
    b = tengine._as_tensors(batch_np(3), "cpu")
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    losses = [float(tengine.make_loss_fn(tq, cfg, fused_head_ce=True)(model, b))
              for cfg in (TCFG, dict(TCFG, moe_capacity_factor=4.0))]
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0]), losses


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_gradient_checkpointing_keeps_gradients(jparams, policy):
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    b = tengine._as_tensors(batch_np(4, padded=True), "cpu")

    def grads(cfg):
        loss = tengine.make_loss_fn(tq, cfg, fused_head_ce=True)(model, b)
        return torch.autograd.grad(loss, list(model.parameters()))

    ref = grads(TCFG)
    got = grads(dict(TCFG, gradient_checkpointing=True, remat_policy=policy))
    for g, r in zip(got, ref):
        assert torch.allclose(g, r, rtol=0, atol=1e-6)
