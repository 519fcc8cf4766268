"""The ported dense Qwen3 training path against the JAX package, on the CPU.

A tiny dense Qwen3 (2 layers, 4 q / 2 kv heads × 16) is initialised in JAX,
flattened and loaded into the port with ``from_jax_flat``; both packages run
in fp32. JAX runs its flash-attention Pallas kernel in interpret mode
(``use_flash=True`` and ``flash_min_seq`` below the sequence length), so the
port's plain flash version and its autograd gradients are held against the
kernel's custom VJP. Tolerances: train-step losses within 1e-5 and parameters
within 1e-4 after 3 steps; fused-head CE loss and gradients within 1e-5;
the optimizer within 1e-6 of optax after 3 updates; cached greedy tokens
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import qwen3 as jq
from llm_quest_tpu.ops import losses as jlosses
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.training import flops as jflops
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import config as tconfig
from llm_quest_tpu_torch.data.prefetch import prefetch_to_device
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.models import qwen3 as tq
from llm_quest_tpu_torch.ops import losses as tlosses
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.training import flops as tflops
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {
    "vocab_size": 128,
    "emb_dim": 32,
    "hidden_dim": 64,
    "n_layers": 2,
    "n_heads": 4,
    "num_kv_groups": 2,
    "head_dim": 16,
    "rope_base": 1_000_000,
    "context_length": 64,
    "tie_embeddings": True,
    "model_type": "dense",
    "flash_min_seq": 16,
}
JCFG = dict(TINY, dtype=jnp.float32, use_flash=True)  # the Pallas kernel, interpret mode
TCFG = dict(TINY, dtype=torch.float32)
B, S = 2, 24


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def max_err(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got.astype(np.float64) - np.asarray(ref, np.float64)).max())


def batch_np(seed, padded):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    targets = np.roll(ids, -1, axis=1)
    batch = {"input_ids": ids, "targets": targets}
    if padded:  # right padding: row 1 has 7 pad tokens, ignored as targets
        mask = np.ones((B, S), bool)
        mask[1, -7:] = False
        batch["attn_mask"] = mask
        batch["targets"] = np.where(mask, targets, -100).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def jparams():
    return jq.init(jax.random.PRNGKey(0), JCFG)


# ------------------------------------------------------------------ model


def test_qwen3_params_trainable_and_named_like_jax(jparams):
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    assert isinstance(model, tq.Qwen3)
    assert all(p.requires_grad for p in model.parameters())
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    assert names == set(flatten_params(jparams))


def test_from_jax_flat_rejects_bad_qwen3_trees(jparams):
    f = flat(jparams)
    missing = {k: v for k, v in f.items() if k != "final_norm/scale"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat(missing, TCFG, device="cpu")
    bad = dict(f, **{"blocks/0/att/wq/w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(bad, TCFG, device="cpu")


def test_moe_config_raises():
    """The MoE model is ported (tests/test_torch_qwen3_moe.py); a MoE config
    without its expert keys raises."""
    with pytest.raises(KeyError, match="num_experts"):
        tq.Qwen3(dict(TCFG, model_type="moe"), device="cpu")


@pytest.mark.parametrize("padded", [False, True])
def test_apply_matches_jax(jparams, padded):
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    b = batch_np(0, padded)
    mask = b.get("attn_mask")
    ref, _, _ = jq.apply(jparams, JCFG, jnp.asarray(b["input_ids"]),
                         attn_mask=None if mask is None else jnp.asarray(mask))
    got, _, _ = tq.apply(model, TCFG, T(b["input_ids"]), attn_mask=None if mask is None else T(mask))
    assert max_err(got, ref) <= 1e-4


def test_generate_kv_cache_matches_jax(jparams):
    """Prompt of 20 ≥ flash_min_seq tokens: the cached prefill takes flash
    with q_start against the max_len cache view, in both packages."""
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], (2, 20)).astype(np.int32)
    ref = jgen.generate_kv_cache(jq, jparams, JCFG, jnp.asarray(ids), max_gen=8, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq, model, TCFG, T(ids).long(), max_gen=8, temp=0.0, eos_ids=-1, pad_id=0)
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(ref["sequences"]))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_gradient_checkpointing_keeps_gradients(jparams, policy):
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    b = {k: T(v) for k, v in batch_np(1, True).items()}

    def grads(cfg):
        hidden, _, _ = tq.apply(model, cfg, b["input_ids"], attn_mask=b["attn_mask"], training=True,
                                output_hidden_states=True)
        loss = tlosses.cross_entropy_fused_head(hidden, tq.head_weights(model, cfg), b["targets"])
        return torch.autograd.grad(loss, list(model.parameters()))

    ref = grads(TCFG)
    got = grads(dict(TCFG, gradient_checkpointing=True, remat_policy=policy))
    for g, r in zip(got, ref):
        assert torch.allclose(g, r, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ losses


def test_cross_entropy_and_log_probs_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (3, 5)).astype(np.int32)
    targets[0, :2] = -100
    assert max_err(tlosses.cross_entropy(T(logits), T(targets)),
                   jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))) <= 1e-6
    safe = np.where(targets < 0, 0, targets)
    assert max_err(tlosses.log_probs_of(T(logits), T(safe)),
                   jlosses.log_probs_of(jnp.asarray(logits), jnp.asarray(safe))) <= 1e-6


def test_fused_head_ce_matches_jax():
    """Ignored targets and a chunk (16) that does not divide the 74 rows."""
    rng = np.random.default_rng(3)
    b, s, d, v = 2, 37, 16, 97
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head_w = rng.standard_normal((d, v)).astype(np.float32)
    targets = rng.integers(0, v, (b, s)).astype(np.int32)
    targets[0, :5] = -100

    def jloss(h, w):
        return jlosses.cross_entropy_fused_head(h, w, jnp.asarray(targets), chunk_size=16)

    ref, (rgh, rgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head_w))
    h, w = T(hidden).requires_grad_(), T(head_w).requires_grad_()
    got = tlosses.cross_entropy_fused_head(h, w, T(targets), chunk_size=16)
    gh, gw = torch.autograd.grad(got, (h, w))
    assert max_err(got, ref) <= 1e-5
    assert max_err(gh, rgh) <= 1e-5
    assert max_err(gw, rgw) <= 1e-5
    plain = tlosses.cross_entropy((T(hidden) @ T(head_w)).reshape(-1, v), T(targets).reshape(-1))
    assert abs(float(got.detach()) - float(plain)) <= 1e-5


# --------------------------------------------------------------- optimizer


def test_lr_schedule_matches_jax():
    args = dict(total_steps=100, init_lr=1e-5, peak_lr=1e-3, warmup_steps=10, min_lr=1e-4, decay="cosine")
    js, ts = jengine.make_lr_schedule(**args), tengine.make_lr_schedule(**args)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 120):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6)
    js, ts = jengine.make_lr_schedule(50, 1e-5, 1e-3), tengine.make_lr_schedule(50, 1e-5, 1e-3)
    assert [ts(i) for i in (0, 7, 49)] == pytest.approx([float(js(i)) for i in (0, 7, 49)], rel=1e-6)


@pytest.mark.parametrize("args, kwargs", [
    ((10, 1e-3, 1e-4), {"warmup_steps": 5}),  # init >= peak
    ((10, 1e-5, 1e-4), {"min_lr": 1e-3, "decay": "cosine"}),  # min >= peak
    ((10, 1e-5, 1e-4), {"decay": "cosine"}),  # decay without min_lr
    ((10, 1e-5, 1e-4), {"min_lr": 1e-5}),  # min_lr without decay
])
def test_lr_schedule_argument_errors(args, kwargs):
    with pytest.raises(ValueError):
        jengine.make_lr_schedule(*args, **kwargs)
    with pytest.raises(ValueError):
        tengine.make_lr_schedule(*args, **kwargs)


@pytest.mark.parametrize("accumulation_steps", [1, 2])
def test_optimizer_matches_optax(accumulation_steps):
    """A random tree, gradients large enough that clipping is active, a
    warmup + cosine schedule; 3 optimizer updates."""
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b": (7,), "c": (3, 2, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (3 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3 * accumulation_steps)]
    sched_args = (6, 1e-4, 1e-2, 2, 1e-3, "cosine")
    jopt = jengine.make_optimizer(jengine.make_lr_schedule(*sched_args), accumulation_steps=accumulation_steps)
    topt = tengine.make_optimizer(tengine.make_lr_schedule(*sched_args), accumulation_steps=accumulation_steps)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: T(v) for k, v in params.items()}
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tstate = topt.update([T(g[k]) for k in tp], tstate, tp)
    for k in shapes:
        assert max_err(tp[k], jp[k]) <= 1e-6
    assert tstate["count"] == 3


# -------------------------------------------------------------- train step


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_train_step_matches_jax(jparams, fused, padded):
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    jstep = jengine.make_train_step(jq, JCFG, jengine.make_optimizer(1e-3), fused_head_ce=fused)
    tstep = tengine.make_train_step(tq, TCFG, tengine.make_optimizer(1e-3), fused_head_ce=fused)
    jp = jax.tree.map(jnp.copy, jparams)  # the JAX step donates its params
    jstate, tstate = jengine.make_optimizer(1e-3).init(jp), tengine.make_optimizer(1e-3).init(model)
    for i in range(3):
        b = batch_np(10 + i, padded)
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        model, tstate, tloss = tstep(model, tstate, b)
        assert abs(float(tloss) - float(jloss)) <= 1e-5, i
    ref = flat(jp)
    for name, p in model.named_parameters():
        ref_p = ref[name.replace(".", "/")]
        if name.endswith(".w") and "tok_emb" not in name:
            ref_p = ref_p.T  # JAX linears are (in, out)
        assert max_err(p, ref_p) <= 1e-4, name


def test_training_eval_loop_matches_jax(jparams):
    batches = [batch_np(20 + i, i % 2 == 1) for i in range(4)]
    val = [batch_np(30 + i, False) for i in range(2)]
    kw = dict(num_epoch=1, peak_lr=1e-3, init_lr=1e-4, warmup_steps=2, min_lr=1e-4, decay="cosine",
              eval_freq=2, eval_iter=2, log=lambda _: None)
    _, jtr, jva = jengine.training_eval_loop(jq, JCFG, jax.tree.map(jnp.copy, jparams), batches, val, **kw)
    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    logs = []
    _, ttr, tva = tengine.training_eval_loop(tq, TCFG, model, batches, val, **dict(kw, log=logs.append))
    assert len(ttr) == len(jtr) == 3 and len(logs) == 3  # steps 1, 2, 4
    np.testing.assert_allclose(ttr, jtr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tva, jva, rtol=0, atol=1e-5)


def test_training_eval_loop_unported_options_raise(jparams, tmp_path):
    """Of the options that raised before ``training/checkpointing.py`` and
    ``training/profiling.py`` were ported, checkpointing and the profiler
    now run (a checkpoint at the last step; the profiler stepped once an
    optimizer step); a checkpoint period without a path, and dropout for a
    model whose ``apply`` takes no generator, still raise."""
    from llm_quest_tpu_torch.training.checkpointing import load_checkpoint

    model = from_jax_flat(flat(jparams), TCFG, device="cpu")
    batches = [batch_np(0, False), batch_np(1, False)]
    stepped = []
    profiler = type("Spy", (), {"step": lambda self: stepped.append(1)})()
    tengine.training_eval_loop(tq, TCFG, model, batches, [], num_epoch=1, checkpoint_every=1,
                               checkpoint_path=str(tmp_path / "ckpt"), profiler=profiler, log=lambda _: None)
    state = load_checkpoint(tmp_path / "ckpt", device="cpu")
    assert state["step"] == 2 and len(stepped) == 2 and state["opt_state"]["count"] == 2
    assert all(torch.equal(state["params"][k], v) for k, v in model.state_dict().items())
    with pytest.raises(ValueError, match="checkpoint_path"):
        tengine.training_eval_loop(tq, TCFG, model, batches, [], num_epoch=1, checkpoint_every=1)
    with pytest.raises(NotImplementedError, match="dropout"):
        tengine.training_eval_loop(tq, dict(TCFG, drop_rate=0.1), model, [batch_np(0, False)], [], num_epoch=1)


# ---------------------------------------------------------- flops, prefetch


def test_flop_counts_match_jax_and_peaks_need_a_card():
    bench = dict(tconfig.qwen3_config_creator("temp_dense"), n_layers=16, emb_dim=1024, n_heads=16,
                 num_kv_groups=8, hidden_dim=3072, context_length=2048)
    got = tflops.text_train_flops_per_token(bench, seq_len=2048)
    assert got == jflops.text_train_flops_per_token(dict(bench, dtype=jnp.bfloat16), seq_len=2048)
    assert 2.8e9 < got < 2.9e9
    # the hybrids: Qwen3-Next (MoE FFNs, gated attention, GDN) and the Qwen3.5 text model
    from llm_quest_tpu import config as jconfig

    for name in ("QWEN3_NEXT_SMALL_CONFIG", "QWEN3_5_08B_CONFIG"):
        got = tflops.text_train_flops_per_token(getattr(tconfig, name), seq_len=2048)
        assert got == jflops.text_train_flops_per_token(getattr(jconfig, name), seq_len=2048), name
    assert 2.30e9 < tflops.text_train_flops_per_token(tconfig.QWEN3_NEXT_SMALL_CONFIG, seq_len=2048) < 2.32e9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tflops.device_peaks()


def test_configs_match_jax():
    from llm_quest_tpu import config as jconfig

    for size in ("temp_dense", "0.6B", "1.7B", "4B", "temp_moe", "30B-A3B"):
        ref = jconfig.qwen3_config_creator(size)
        got = tconfig.qwen3_config_creator(size)
        assert {k: v for k, v in got.items() if k != "dtype"} == {k: v for k, v in ref.items() if k != "dtype"}
    with pytest.raises(ValueError):
        tconfig.qwen3_config_creator("235B-A22B")
    strip = lambda c: {k: v for k, v in c.items() if k != "dtype"}  # noqa: E731
    assert strip(tconfig.GEMMA3_SMALL_CONFIG) == strip(jconfig.GEMMA3_SMALL_CONFIG)
    assert tconfig.GEMMA3_SMALL_CONFIG["dtype"] == torch.float32


def test_prefetch_yields_batches_and_reraises():
    batches = [batch_np(i, True) for i in range(3)]
    got = list(prefetch_to_device(iter(batches), device="cpu"))
    assert len(got) == 3
    for g, b in zip(got, batches):
        for k in b:
            np.testing.assert_array_equal(g[k].numpy(), b[k])

    def broken():
        yield batches[0]
        raise KeyError("producer failed")

    it = prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(KeyError, match="producer failed"):
        next(it)


@pytest.mark.parametrize("entry", [
    "resolve_device", "from_jax_flat", "qwen3.init", "qwen3.init_cache", "qwen3_5.init", "qwen3_5.init_text",
    "qwen3_5.init_cache", "qwen3_next.init", "qwen3_next.init_cache", "prefetch_to_device",
])
def test_device_none_means_the_card_and_raises_without_one(jparams, monkeypatch, entry):
    """The public entry points build on the current CUDA device by default;
    with no card they raise and name the CPU opt-in instead of falling back."""
    from llm_quest_tpu_torch.models import qwen3_5 as tq35
    from llm_quest_tpu_torch.models import qwen3_next as tqn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator()
    calls = {
        "resolve_device": lambda: tconfig.resolve_device(None),
        "from_jax_flat": lambda: from_jax_flat(flat(jparams), TCFG),
        "qwen3.init": lambda: tq.init(TCFG, generator=gen),
        "qwen3.init_cache": lambda: tq.init_cache(TCFG, 1, 8),
        "qwen3_5.init": lambda: tq35.init(tconfig.QWEN3_5_08B_CONFIG, generator=gen),
        "qwen3_5.init_text": lambda: tq35.init_text(tconfig.QWEN3_5_08B_CONFIG, generator=gen),
        "qwen3_5.init_cache": lambda: tq35.init_cache(tconfig.QWEN3_5_08B_CONFIG, 1, 8),
        "qwen3_next.init": lambda: tqn.init(tconfig.QWEN3_NEXT_SMALL_CONFIG, generator=gen),
        "qwen3_next.init_cache": lambda: tqn.init_cache(tconfig.QWEN3_NEXT_SMALL_CONFIG, 1, 8),
        "prefetch_to_device": lambda: next(prefetch_to_device(iter([batch_np(0, False)]))),
    }
    with pytest.raises(RuntimeError, match='no CUDA device: pass device="cpu"'):
        calls[entry]()
    assert tconfig.resolve_device("cpu") == torch.device("cpu")
