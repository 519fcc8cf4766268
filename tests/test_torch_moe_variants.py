"""The ported classic and latent MoE, the non-gated biased expert stacks
(bf16/fp, int8 and int4) and the routing replay against the JAX package,
on the CPU in fp32.

Layers are initialised in JAX (``init_classic_moe``, ``init_latent_moe``,
the latent ``biases`` set to seeded values so the biased top-k is
exercised), loaded by ``from_jax_flat`` and run on numpy-seeded inputs;
every JAX reference is jitted once a module. Each routing test first asserts
that every token's top-k margin exceeds 1e-4 (a near-tie would flip an
expert). Tolerances:

- outputs within 1e-5, losses within 1e-6 relative, each gradient within
  1e-5 of its leaf's largest (fp32 sums in another order; JAX scatter-adds
  a token's rows where the port sums them in rank order);
- quantized stacks (int8 and int4; K11's plain version against JAX's
  ``ragged_dot`` on the converted stack) within 1e-5 of max |ref|, and the
  JAX tree's load equal to the port's own quantization bit for bit;
- routing replay: a forward fed its own ``gate_probas`` gives the same
  logits bit for bit; replayed probabilities, per layer and broadcast, give
  JAX's logits within 1e-4, and another batch's change them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.ops import activations as jact
from llm_quest_tpu.ops import moe as jmoe
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.ops import activations as tact
from llm_quest_tpu_torch.ops import int4 as tint4
from llm_quest_tpu_torch.ops import moe as tmoe
from llm_quest_tpu_torch.ops import quantization as tquant
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
MODEL_TOL = 1e-4
MARGIN = 1e-4

CLASSIC = {"emb_dim": 16}  # 4 experts top-2 below: hidden int(4 · 1/2 · 16) = 32
CLASSIC_E, CLASSIC_K = 4, 2
LATENT = {"emb_dim": 32, "moe_hidden_dim": 24}  # JAX's defaults: 16 experts, top-8, latent 8
MOE = {
    "model_type": "moe", "vocab_size": 128, "context_length": 64, "emb_dim": 32, "n_layers": 2, "n_heads": 4,
    "num_kv_groups": 2, "head_dim": 8, "moe_hidden_dim": 64, "num_experts": 4, "top_k": 2,
    "aux_loss_coef": 0.001, "rope_base": 10_000, "tie_embeddings": False,
}


def rng(seed):
    return np.random.default_rng(seed)


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    return float(np.abs(got.detach().float().numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


def margin(scores, k):
    """The smallest gap between a token's k-th and (k+1)-th score."""
    top = torch.topk(torch.as_tensor(np.asarray(scores)), k + 1, dim=-1).values
    return float((top[..., k - 1] - top[..., k]).min())


def grads_close(model, jgrads):
    """Every parameter's gradient within GRAD_RTOL of its JAX leaf's largest."""
    ref = flat(jgrads)
    named = dict(model.named_parameters())
    assert set(named) == {k.replace("/", ".") for k in ref if k != "biases"}
    for name, p in named.items():
        r = ref[name.replace(".", "/")]
        assert max_err(p.grad, r) <= GRAD_RTOL * max(float(np.abs(r).max()), 1e-30), name


# ------------------------------------------------------------------ classic


@pytest.fixture(scope="module")
def classic():
    params = jmoe.init_classic_moe(jax.random.PRNGKey(0), CLASSIC, num_experts=CLASSIC_E, top_k=CLASSIC_K)
    x = rng(1).standard_normal((2, 9, CLASSIC["emb_dim"])).astype(np.float32)
    cot = rng(2).standard_normal(x.shape).astype(np.float32)

    def loss(p, x):
        out, aux = jmoe.classic_moe(p, x, top_k=CLASSIC_K)
        return jnp.sum(out * cot) + aux["moe_loss"], (out, aux["moe_loss"])

    (total, (out, moe_loss)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(x))
    return params, x, cot, out, moe_loss, total, grads


def test_classic_moe_matches_jax(classic):
    """Outputs, the z-loss + LBL auxiliary loss and every gradient (the
    router's weight and bias, the non-gated stack and its biases)."""
    params, x, cot, jout, jloss, jtotal, jgrads = classic
    model = from_jax_flat(flat(params), {}, device="cpu")
    assert isinstance(model, tmoe.ClassicMoE)
    logits = T(x).reshape(-1, CLASSIC["emb_dim"]) @ model.gate_w + model.gate_b
    assert margin(torch.softmax(logits, -1).detach(), CLASSIC_K) > MARGIN
    out, aux = tmoe.classic_moe(model, T(x), top_k=CLASSIC_K)
    assert max_err(out, jout) <= TOL
    assert abs(float(aux["moe_loss"].detach()) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    total = (out * T(cot)).sum() + aux["moe_loss"]
    assert abs(float(total) - float(jtotal)) <= LOSS_RTOL * abs(float(jtotal)) + TOL
    total.backward()
    grads_close(model, jgrads)


def test_z_router_loss_and_squared_relu_match_jax():
    logits = rng(3).standard_normal((7, 5)).astype(np.float32) * 4
    ref = float(jmoe.z_router_loss(jnp.asarray(logits)))
    assert abs(float(tmoe.z_router_loss(T(logits))) - ref) <= LOSS_RTOL * ref
    x = rng(4).standard_normal((3, 11)).astype(np.float32)
    assert max_err(tmoe.squared_relu(T(x)), jmoe.squared_relu(jnp.asarray(x))) == 0.0


def test_init_classic_moe_shapes_and_ranges():
    model = tmoe.init_classic_moe(CLASSIC, num_experts=CLASSIC_E, top_k=CLASSIC_K,
                                  generator=torch.Generator().manual_seed(0), device="cpu")
    ref = jmoe.init_classic_moe(jax.random.PRNGKey(0), CLASSIC, num_experts=CLASSIC_E, top_k=CLASSIC_K)
    mine = {k.replace(".", "/"): v for k, v in model.state_dict().items()}
    d, hidden = CLASSIC["emb_dim"], 2 * CLASSIC["emb_dim"]
    assert set(mine) == set(flat(ref))
    for name, arr in flat(ref).items():  # U(±1/sqrt(fan-in)) in both, hidden's for lin2 and b2
        bound = (hidden if name.split("/")[-1] in ("lin2", "b2") else d) ** -0.5
        assert mine[name].shape == arr.shape, name
        assert float(np.abs(arr).max()) <= bound and 0.5 * bound < float(mine[name].abs().max()) <= bound, name


# ------------------------------------------------------------------ latent


def latent_tree():
    params = jmoe.init_latent_moe(jax.random.PRNGKey(5), LATENT)
    e = params["gate_w"].shape[-1]
    return dict(params, biases=jnp.asarray(rng(6).uniform(-0.05, 0.05, e).astype(np.float32)))


@pytest.fixture(scope="module")
def latent():
    params = latent_tree()
    top_k = jmoe_latent_top_k()
    x = rng(7).standard_normal((2, 9, LATENT["emb_dim"])).astype(np.float32)
    cot = rng(8).standard_normal(x.shape).astype(np.float32)

    def loss(p, x):
        out, aux = jmoe.latent_moe(p, x, top_k=top_k)
        return jnp.sum(out * cot), (out, aux["counts"])

    (total, (out, counts)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(x))
    return params, x, cot, out, counts, total, grads


def jmoe_latent_top_k():
    """JAX's latent top_k when the config gives none: 2 · latent_ratio 4."""
    return LATENT.get("top_k", 2 * 4)


def test_latent_moe_matches_jax(latent):
    """Outputs, expert counts and every gradient (both stacks, the router,
    the down and up projections); the biases load into the buffer."""
    params, x, cot, jout, jcounts, jtotal, jgrads = latent
    model = from_jax_flat(flat(params), {}, device="cpu")
    assert isinstance(model, tmoe.LatentMoE)
    top_k = tmoe.latent_top_k(LATENT)
    assert top_k == jmoe_latent_top_k() == 8 and model.gate_w.shape[-1] == 16 and model.down_proj.shape[-1] == 8
    assert torch.equal(model.biases, T(params["biases"])) and "biases" not in dict(model.named_parameters())
    probas = torch.sigmoid(T(x).reshape(-1, LATENT["emb_dim"]) @ model.gate_w).detach() + model.biases
    assert margin(probas, top_k) > MARGIN
    out, aux = tmoe.latent_moe(model, T(x), top_k=top_k)
    assert max_err(out, jout) <= TOL
    assert torch.equal(aux["counts"], T(jcounts))
    total = (out * T(cot)).sum()
    assert abs(float(total) - float(jtotal)) <= LOSS_RTOL * abs(float(jtotal)) + TOL
    total.backward()
    grads_close(model, jgrads)
    _, eval_aux = tmoe.latent_moe(model, T(x), top_k=top_k, training=False)
    assert eval_aux == {}


def test_init_latent_moe_takes_jax_defaults():
    model = tmoe.init_latent_moe(LATENT, generator=torch.Generator().manual_seed(0), device="cpu")
    ref = latent_tree()
    mine = {k.replace(".", "/"): v for k, v in model.state_dict().items()}
    assert set(mine) == set(flat(ref))
    for name, arr in flat(ref).items():
        assert mine[name].shape == arr.shape, name
    assert not model.biases.any() and model.biases.dtype == torch.float32


# ------------------------------------------------------------------ quantized stacks


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("which", ["classic", "latent"])
def test_quantized_variants_match_jax(which, bits, classic, latent):
    """int8 and int4 stacks (the classic layer's non-gated biased experts;
    the latent layer's routed and shared gated ones) quantized by JAX,
    loaded by ``from_jax_flat``: equal to the port's own quantization bit for
    bit, outputs within 1e-5 of max |ref| through K11's plain version."""
    params, x = (classic if which == "classic" else latent)[:2]
    jq = jquant.quantize_params_int8(params, bits=bits)
    loaded = from_jax_flat(flat(jq), {}, device="cpu")
    mine = tquant.quantize_params_int8(from_jax_flat(flat(params), {}, device="cpu"), bits=bits)
    state = mine.state_dict()
    assert {k.replace("/", ".") for k in flat(jq)} == set(state)
    for name, t in loaded.state_dict().items():
        assert t.dtype == state[name].dtype and torch.equal(t, state[name]), name
    stored = torch.uint8 if bits == 4 else torch.int8
    assert sum(t.dtype == stored for t in state.values()) == (2 if which == "classic" else 6)
    if which == "classic":
        ref, _ = jax.jit(functools.partial(jmoe.classic_moe, top_k=CLASSIC_K))(jq, jnp.asarray(x))
        with torch.no_grad():
            got, _ = tmoe.classic_moe(loaded, T(x), top_k=CLASSIC_K)
    else:
        top_k = jmoe_latent_top_k()
        ref, _ = jax.jit(functools.partial(jmoe.latent_moe, top_k=top_k))(jq, jnp.asarray(x))
        with torch.no_grad():
            got, _ = tmoe.latent_moe(loaded, T(x), top_k=top_k)
    assert max_err(got, ref) <= TOL * float(np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_non_gated_biased_dispatch_matches_jax(bits):
    """The non-gated biased stack through ``dispatch``, act(lin1(x) + b1),
    lin2, + b2: exact (ragged) dispatch for fp, int8 and int4 stacks, and
    the fp stack's capacity dispatch (factor 1.0, so rows overflow and drop)."""
    e, d, hidden, t, k = 4, 12, 20, 10, 2
    stack = jmoe.init_expert_stack(jax.random.PRNGKey(9), e, d, hidden, gated=False, bias=True)
    if bits is not None:
        stack = jquant.quantize_expert_stack_int8(stack, bits=bits)
    jstack = {key: jnp.asarray(v) for key, v in stack.items()}
    tstack = {key: T(np.asarray(v).astype(np.int8)) if np.asarray(v).dtype.name == "int4" else T(v)
              for key, v in stack.items()}
    if bits == 4:
        tstack = {key: tint4.pack_int4(v) if key.endswith("_q") else v for key, v in tstack.items()}
    x = rng(10).standard_normal((t, d)).astype(np.float32)
    logits = rng(11).standard_normal((t, e)).astype(np.float32)
    w, idx = torch.topk(torch.softmax(T(logits), -1), k)
    factors = [None] if bits else [None, 1.0]
    for cf in factors:
        ref = jmoe.dispatch(jstack, jnp.asarray(x), jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()), e,
                            activation=jact.gelu_erf, capacity_factor=cf)
        got = tmoe.dispatch(tstack, T(x), idx, w, e, activation=tact.gelu_erf, capacity_factor=cf)
        assert max_err(got, ref) <= TOL * float(np.abs(np.asarray(ref)).max()), cf


# ------------------------------------------------------------------ routing replay


@pytest.fixture(scope="module")
def moe_model():
    jparams = jq3.init(jax.random.PRNGKey(12), dict(MOE, dtype=jnp.float32))
    return jparams, from_jax_flat(flat(jparams), dict(MOE, dtype=torch.float32), device="cpu")


IDS = rng(13).integers(1, 128, (2, 11)).astype(np.int32)
OTHER_IDS = rng(14).integers(1, 128, (2, 11)).astype(np.int32)


def test_replay_of_own_probabilities_is_exact(moe_model):
    """A forward fed its own ``aux["gate_probas"]`` (per layer) gives the same
    logits bit for bit, also through ``qwen3_moe`` alone; another batch's
    probabilities (the control) change them."""
    _, model = moe_model
    cfg = dict(MOE, dtype=torch.float32)
    with torch.no_grad():
        logits, _, aux = tq3.apply(model, cfg, T(IDS).long())
        again, _, aux2 = tq3.apply(model, cfg, T(IDS).long(), gate_probas=aux["gate_probas"])
        _, _, other = tq3.apply(model, cfg, T(OTHER_IDS).long())
        control, _, _ = tq3.apply(model, cfg, T(IDS).long(), gate_probas=other["gate_probas"])
        h = torch.randn(2, 11, MOE["emb_dim"], generator=torch.Generator().manual_seed(15))
        block = model.blocks[0].moe
        out, layer_aux = tmoe.qwen3_moe(block, h, top_k=2, load_coeff=0.001, training=False)
        replayed, _ = tmoe.qwen3_moe(block, h, top_k=2, load_coeff=0.001, training=False,
                                     gate_probas=layer_aux["gate_probas"])
    assert torch.equal(again, logits) and torch.equal(replayed, out)
    assert all(torch.equal(a, b) for a, b in zip(aux2["gate_probas"], aux["gate_probas"]))
    assert float((control - logits).abs().max()) > 1e-2
    with pytest.raises(ValueError, match="gate_probas"):
        tmoe.qwen3_moe(block, h, top_k=2, load_coeff=0.001, gate_probas=layer_aux["gate_probas"][None])


@pytest.mark.parametrize("form", ["per_layer", "broadcast"])
def test_replayed_probabilities_match_jax(moe_model, form):
    """Seeded probabilities replayed, a list of one per layer or one tensor
    for every layer: logits within 1e-4 of JAX's ``apply(gate_probas=)``,
    and the training LBL too."""
    jparams, model = moe_model
    t, e = IDS.size, MOE["num_experts"]
    probas = [rng(16 + i).dirichlet(np.ones(e), t).astype(np.float32) for i in range(MOE["n_layers"])]
    for p in probas:
        assert margin(p, MOE["top_k"]) > MARGIN
    given = probas if form == "per_layer" else probas[0]
    jcfg = dict(MOE, dtype=jnp.float32)
    jgiven = [jnp.asarray(p) for p in probas] if form == "per_layer" else jnp.asarray(given)
    jl, _, jaux = jax.jit(lambda p, x, g: jq3.apply(p, jcfg, x, gate_probas=g, training=True))(
        jparams, jnp.asarray(IDS), jgiven)
    tgiven = [T(p) for p in probas] if form == "per_layer" else T(given)
    with torch.no_grad():
        tl, _, taux = tq3.apply(model, dict(MOE, dtype=torch.float32), T(IDS).long(), gate_probas=tgiven,
                                training=True)
    assert max_err(tl, jl) <= MODEL_TOL
    assert abs(float(taux["moe_loss"]) - float(jaux["moe_loss"])) <= LOSS_RTOL * abs(float(jaux["moe_loss"]))
