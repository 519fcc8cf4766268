"""The ported hyper-connections and Hyper-Qwen3 against the JAX package, on
the CPU in fp32.

Every function of ``ops/hyper_connections.py`` is held to JAX's on the same
numpy-seeded inputs (within 1e-6; the Sinkhorn-Knopp and BvN projections
are also checked doubly stochastic). A tiny Hyper-Qwen3 (2 layers, emb 32,
2 q / 1 kv heads of 16, 3 streams) is initialised in JAX for each
``hc_type``, every leaf then moved off its init by N(0, 0.05²) noise (the
dynamic maps start at zero) and loaded into the port with
``from_jax_flat``. JAX runs its flash-attention Pallas kernel in interpret
mode (``use_flash``, ``flash_min_seq`` 16) at s 24: logits within 1e-4 and
greedy tokens equal, the loss within 1e-5 relative and every gradient
within 1e-4 relative to max(1, max |g|), and for classic HC (the type and
rate JAX's ``apply`` defaults to, which its train step calls) two train
steps within 3e-4 of JAX's. The reference fault: JAX's mHC-lite permutation
matrices sit in its parameter tree, get a gradient and move under its
optimizer; the port's are a buffer no optimizer sees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_quest_tpu.models import hyper_qwen3 as jh
from llm_quest_tpu.ops import hyper_connections as jhc
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.models import hyper_qwen3 as th
from llm_quest_tpu_torch.ops import hyper_connections as thc
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {
    "vocab_size": 64, "context_length": 32, "emb_dim": 32, "n_layers": 2, "n_heads": 2, "num_kv_groups": 1,
    "head_dim": 16, "hidden_dim": 64, "rope_base": 10_000, "tie_embeddings": True, "flash_min_seq": 16,
}
JCFG = dict(TINY, dtype=jnp.float32, use_flash=True)  # the Pallas kernel, interpret mode
TCFG = dict(TINY, dtype=torch.float32)
N = 3
B, S = 2, 24
HC_TYPES = ("hc", "mhc", "mhc-lite")


def T(x):
    return torch.from_numpy(np.array(x))


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def arr(x):
    return x.detach().float().numpy().astype(np.float64) if torch.is_tensor(x) else np.asarray(x, np.float64)


def max_err(got, ref):
    return float(np.abs(arr(got) - arr(ref)).max())


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(arr(ref)).max()))


def randn(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def jax_bundle(hc_type, d=8, n=N, seed=0):
    """A JAX bundle with every leaf but the permutation matrices moved off its init."""
    p = jhc.init_hc_set(d, n) if hc_type == "hc" else jhc.init_mhc_set(d, n, lite=hc_type == "mhc-lite")
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "_bvn_flat" in jax.tree_util.keystr(path)
        else x + jnp.asarray(0.3 * rng.normal(size=x.shape), jnp.float32), p)


def port_bundle(hc_type, jp, d=8, n=N):
    mine = thc.init_hc_set(d, n) if hc_type == "hc" else thc.init_mhc_set(d, n, lite=hc_type == "mhc-lite")
    ref = flat(jp)
    assert {k.replace(".", "/") for k in mine.state_dict()} == set(ref)
    with torch.no_grad():
        for name, t in mine.state_dict().items():
            t.copy_(T(ref[name.replace(".", "/")]))
    return mine


# ------------------------------------------------------------------ ops/hyper_connections.py


def test_sinkhorn_knopp_matches_jax_and_is_doubly_stochastic():
    p = np.abs(randn(0, 2, 5, 4, 4)) + 0.1
    got = thc.sinkhorn_knopp(T(p), max_iter=30)
    assert max_err(got, jhc.sinkhorn_knopp(jnp.asarray(p), max_iter=30)) <= 1e-6
    assert max_err(got.sum(-1), np.ones((2, 5, 4))) <= 1e-4 and max_err(got.sum(-2), np.ones((2, 5, 4))) <= 1e-4
    assert thc.sinkhorn_knopp(T(p).to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("n", [2, 3, 4])
def test_permutation_matrices_and_bvn_compose_match_jax(n):
    flat_p, identity = thc.permutation_matrices(n)
    jflat, jidentity = jhc.permutation_matrices(n)
    assert identity == jidentity and np.array_equal(flat_p.numpy(), np.asarray(jflat))
    w = np.asarray(jax.nn.softmax(jnp.asarray(randn(n, 4, flat_p.shape[0]))))
    h = thc.bvn_compose(T(w), flat_p, n)
    assert max_err(h, jhc.bvn_compose(jnp.asarray(w), jflat, n)) <= 1e-6
    assert max_err(h.sum(-1), np.ones((4, n))) <= 1e-5 and max_err(h.sum(-2), np.ones((4, n))) <= 1e-5


@pytest.mark.parametrize("hc_type", HC_TYPES)
def test_init_sets_match_jax(hc_type):
    mine = thc.init_hc_set(8, N) if hc_type == "hc" else thc.init_mhc_set(8, N, lite=hc_type == "mhc-lite")
    ref = flat(jhc.init_hc_set(8, N) if hc_type == "hc" else jhc.init_mhc_set(8, N, lite=hc_type == "mhc-lite"))
    state = mine.state_dict()
    assert {k.replace(".", "/") for k in state} == set(ref)
    for name, a in ref.items():
        assert state[name.replace("/", ".")].dtype == torch.float32 and np.array_equal(
            state[name.replace("/", ".")].numpy(), a), name
    assert ("_bvn_flat" in dict(mine.named_buffers())) == (hc_type == "mhc-lite")
    assert all(p.requires_grad for p in mine.parameters())


def test_classic_maps_match_jax():
    jp = jax_bundle("hc")
    mine = port_bundle("hc", jp)
    x = randn(1, 2, 3, N, 8)
    for fn in ("hc_res_matrix", "hc_pre_vector", "hc_post_vector"):
        part = fn.split("_")[1]
        got = getattr(thc, fn)(mine[part], T(x))
        assert max_err(got, getattr(jhc, fn)(jp[part], jnp.asarray(x))) <= 1e-6, fn
    at_init = thc.hc_res_matrix(thc.init_hc_set(8, N)["res"], T(x))
    assert max_err(at_init, np.broadcast_to(np.eye(N), (2, 3, N, N))) == 0.0  # H_res = I at init


@pytest.mark.parametrize("hc_type", ["mhc", "mhc-lite"])
def test_manifold_maps_match_jax(hc_type):
    jp = jax_bundle(hc_type)
    mine = port_bundle(hc_type, jp)
    x = randn(2, 2, 3, N * 8)
    res = thc.mhc_res_matrix(mine, T(x), N) if hc_type == "mhc" else thc.mhc_lite_res_matrix(mine, T(x), N)
    ref = (jhc.mhc_res_matrix(jp, jnp.asarray(x), N) if hc_type == "mhc"
           else jhc.mhc_lite_res_matrix(jp, jnp.asarray(x), N))
    assert max_err(res, ref) <= 1e-6
    # the columns are normalised last; 20 Sinkhorn-Knopp passes leave the rows of a near-identity H_res
    # (bias 8·I - 8) within ~5e-4 of 1 in both packages
    assert max_err(res.sum(-2), np.ones((2, 3, N))) <= 1e-5 and max_err(res.sum(-1), np.ones((2, 3, N))) <= 1e-3
    for fn in ("mhc_pre_vector", "mhc_post_vector"):
        assert max_err(getattr(thc, fn)(mine, T(x)), getattr(jhc, fn)(jp, jnp.asarray(x))) <= 1e-6, fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hc_type", HC_TYPES)
def test_hc_wrap_matches_jax(hc_type, dtype):
    """One wrapped sub-block (a fixed linear map as the block) in fp32 and
    with bf16 streams (the coefficients in fp32 in both, the result cast
    back: within one bf16 unit of the largest stream)."""
    jp = jax_bundle(hc_type)
    mine = port_bundle(hc_type, jp)
    x, w = randn(3, 2, 5, N, 8), randn(4, 8, 8, scale=0.3)
    jx = jnp.asarray(x).astype(dtype)
    ref = jhc.hc_wrap(jp, jx, lambda s: (s.astype(jnp.float32) @ w).astype(s.dtype), hc_type=hc_type, n=N)
    got = thc.hc_wrap(mine, T(x).to(getattr(torch, dtype)), lambda s: (s.float() @ T(w)).to(s.dtype),
                      hc_type=hc_type, n=N)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * float(np.abs(np.asarray(ref, np.float32)).max())
    assert max_err(got, np.asarray(ref, np.float32)) <= tol
    with pytest.raises(ValueError, match="hc_type"):
        thc.hc_wrap(mine, T(x), lambda s: s, hc_type="bogus", n=N)


# ------------------------------------------------------------------ models/hyper_qwen3.py


@pytest.fixture(scope="module")
def jax_models():
    """Per hc_type: JAX params moved off their init (module docstring)."""
    out = {}
    for i, hc_type in enumerate(HC_TYPES):
        p = jh.init(jax.random.PRNGKey(0), JCFG, hc_type=hc_type, expansion_rate=N)
        leaves, tree = jax.tree_util.tree_flatten_with_path(p)
        keys = jax.random.split(jax.random.PRNGKey(10 + i), len(leaves))
        out[hc_type] = jax.tree.unflatten(jax.tree.structure(p), [
            x if "_bvn_flat" in jax.tree_util.keystr(path) else x + 0.05 * jax.random.normal(k, x.shape)
            for (path, x), k in zip(leaves, keys)])
    return out


def batch_np(seed):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S + 1)).astype(np.int32)
    return {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}


def port_layout(model, name, a):
    owner = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(owner), Linear):
        return np.asarray(a).T
    return np.asarray(a)


def test_init_is_qwen3s_with_fresh_bundles():
    from llm_quest_tpu_torch.models import qwen3

    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    model = th.init(TCFG, generator=gen(), device="cpu", hc_type="mhc-lite", expansion_rate=N)
    base = qwen3.init(TCFG, generator=gen(), device="cpu")
    state = model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in base.state_dict().items())
    assert (model.hc_type, model.expansion_rate) == ("mhc-lite", N)
    assert "hc_attn" in dict(model.blocks[1].named_children())
    with pytest.raises(ValueError, match="hc_type"):
        th.HyperQwen3(TCFG, "cpu", hc_type="bogus")


@pytest.mark.parametrize("hc_type", HC_TYPES)
def test_apply_logits_and_greedy_tokens_match_jax(jax_models, hc_type):
    jp = jax_models[hc_type]
    model = from_jax_flat(flat(jp), TCFG, device="cpu")
    assert isinstance(model, th.HyperQwen3) and (model.hc_type, model.expansion_rate) == (hc_type, N)
    ids = batch_np(0)["input_ids"]
    ref, _, _ = jax.jit(lambda p, x: jh.apply(p, JCFG, x, hc_type=hc_type, expansion_rate=N))(jp, jnp.asarray(ids))
    got, cache, aux = th.apply(model, TCFG, T(ids).long())
    assert cache is None and aux == {} and max_err(got, ref) <= 1e-4
    assert np.array_equal(got.argmax(-1).numpy(), np.asarray(ref).argmax(-1))
    hidden, _, _ = th.apply(model, TCFG, T(ids).long(), output_hidden_states=True)
    head = th.head_weights(model, TCFG)
    assert max_err(hidden @ head, got) <= 1e-5
    with pytest.raises(ValueError, match="holds"):
        th.apply(model, TCFG, T(ids).long(), expansion_rate=N + 1)


@pytest.mark.parametrize("hc_type", HC_TYPES)
def test_loss_and_gradients_match_jax(jax_models, hc_type):
    jp = jax_models[hc_type]
    model = from_jax_flat(flat(jp), TCFG, device="cpu")
    b = batch_np(1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        logits, _, _ = jh.apply(p, JCFG, jb["input_ids"], hc_type=hc_type, expansion_rate=N)
        return jengine.global_loss(logits, jb["targets"])

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    loss = tengine.make_loss_fn(th, TCFG)(model, tengine.as_tensors(b, "cpu"))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = {k.replace("/", "."): v for k, v in flat(ref_grads).items()}
    assert set(ref) - set(names) == ({f"blocks.{i}.{h}._bvn_flat" for i in range(2) for h in ("hc_attn", "hc_ffn")}
                                     if hc_type == "mhc-lite" else set())
    for name, g in zip(names, grads):
        assert rel_err(g, port_layout(model, name, ref[name])) <= 1e-4, name
    assert float(np.abs(ref["blocks.0.hc_attn.res.w"]).max()) > 0


def test_train_steps_match_jax_for_classic_hc():
    """JAX's train step calls ``apply`` with its defaults ("hc", 4 streams)."""
    jp = jh.init(jax.random.PRNGKey(2), JCFG)
    model = from_jax_flat(flat(jp), TCFG, device="cpu")
    assert (model.hc_type, model.expansion_rate) == ("hc", 4)
    jstep = jengine.make_train_step(jh, JCFG, jengine.make_optimizer(1e-3))
    tstep = tengine.make_train_step(th, TCFG, tengine.make_optimizer(1e-3), fused_head_ce=True)
    jstate, tstate = jengine.make_optimizer(1e-3).init(jp), tengine.make_optimizer(1e-3).init(model)
    for i in range(2):
        b = batch_np(10 + i)
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        model, tstate, tloss = tstep(model, tstate, b)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert max_err(p, port_layout(model, name, ref[name.replace(".", "/")])) <= 3e-4, name


def test_permutation_matrices_move_under_jax_optimizer_not_the_ports(jax_models):
    """The reference fault: one optax AdamW step over JAX's mHC-lite tree
    changes its "fixed" permutation matrices; the port's optimizer never
    sees the buffer, which stays a set of permutation matrices."""
    jp = jax_models["mhc-lite"]
    model = from_jax_flat(flat(jp), TCFG, device="cpu")
    b = batch_np(2)

    def loss_fn(p):
        logits, _, _ = jh.apply(p, JCFG, jnp.asarray(b["input_ids"]), hc_type="mhc-lite", expansion_rate=N)
        return jengine.global_loss(logits, jnp.asarray(b["targets"]))

    opt = optax.adamw(1e-3)
    updates, _ = opt.update(jax.jit(jax.grad(loss_fn))(jp), opt.init(jp), jp)
    moved = optax.apply_updates(jp, updates)["blocks"][0]["hc_attn"]["_bvn_flat"]
    perms = np.asarray(jp["blocks"][0]["hc_attn"]["_bvn_flat"])
    assert max_err(moved, perms) > 1e-4
    tstep = tengine.make_train_step(th, TCFG, tengine.make_optimizer(1e-3))
    opt_state = tengine.make_optimizer(1e-3).init(model)
    assert len(opt_state["mu"]) == len(list(model.parameters()))
    tstep(model, opt_state, b)
    assert np.array_equal(model.blocks[0].hc_attn["_bvn_flat"].numpy(), perms)
