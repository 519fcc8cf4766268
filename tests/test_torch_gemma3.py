"""The ported Gemma-3 sliding-window training path against the JAX package, on the CPU.

The tiny Gemma-3 of ``tests/test_llama_gemma.py`` (2 layers, 4 q / 2 kv heads
× 16, window 8, ratio 1: one SWA and one global layer) is initialised in
JAX, flattened and loaded into the port with ``from_jax_flat``; both
packages run in fp32 on the same numpy-seeded batches of 24 tokens, three
times the window. JAX runs its flash-attention Pallas kernel in interpret
mode (``use_flash=True`` and ``flash_min_seq`` below the sequence length),
window included, so the port's plain flash version (``sdpa`` on the dense
window mask) and its autograd gradients are held against the kernel and its
custom VJP. Right-padded rows carry 7 pads, fewer than the window, so every
query keeps a real key in its window. Tolerances: logits within 1e-4; the
loss within 1e-5 relative and every gradient within 1e-4 relative to
max(1, max |g|); after 2 train steps (learning rate 1e-3) the losses
within 1e-5 relative (the N(0, 1) tied table puts the loss near 27) and the
parameters within 3e-4 (0.3 of the learning rate: Adam's m/√v turns the
fp32 noise of a near-zero gradient into a step of up to the learning rate),
except the k-norm shifts, whose gradient is zero in exact arithmetic (a
shift common to every key adds one constant to a query's scores, which the
softmax cancels: both packages' gradients there are held under 1e-5) and
whose Adam steps are that noise's signs; greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import gemma3 as jg
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.models import gemma3 as tg
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {
    "vocab_size": 128,
    "context_length": 64,
    "emb_dim": 64,
    "n_heads": 4,
    "n_layers": 2,
    "num_kv_groups": 2,
    "hidden_dim": 128,
    "rope_base": 10_000,
    "window_size": 8,
    "local_global_att_ratio": 1,  # alternate SWA / global
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


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(np.asarray(ref, np.float64)).max()))


def batch_np(seed, padded=False):
    ids = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (B, S + 1)).astype(np.int32)
    batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}
    if padded:  # right padding: row 1 has 7 pad tokens, ignored as targets
        mask = np.ones((B, S), bool)
        mask[1, -7:] = False
        batch["attn_mask"] = mask
        batch["targets"] = np.where(mask, batch["targets"], -100).astype(np.int32)
    return batch


def port_layout(model, name, arr):
    """A JAX leaf in the port's layout: Linear weights transposed."""
    module_name = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(module_name), Linear):
        return np.asarray(arr).T
    return np.asarray(arr)


@pytest.fixture(scope="module")
def jparams():
    return jg.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture
def model(jparams):
    return from_jax_flat(flat(jparams), TCFG, device="cpu")


# ------------------------------------------------------------------ config, weights


@pytest.mark.parametrize("n_layers, ratio, window", [(4, 1, 8), (6, 5, 512), (18, 5, 512), (4, 0, 8), (4, 4, 8),
                                                     (4, 1, 0)])
def test_layer_kinds_match_jax(n_layers, ratio, window):
    cfg = dict(TINY, n_layers=n_layers, local_global_att_ratio=ratio, window_size=window)
    assert [tg.is_swa_layer(cfg, i) for i in range(n_layers)] == [jg.is_swa_layer(cfg, i) for i in range(n_layers)]
    assert tg.head_dim(cfg) == jg.head_dim(cfg) and tg.head_dim(dict(cfg, head_dim=256)) == 256


def test_params_trainable_and_named_like_jax(jparams, model):
    assert isinstance(model, tg.Gemma3)
    assert all(p.requires_grad for p in model.parameters())
    names = {n.replace(".", "/") for n, _ in model.named_parameters()}
    assert names == set(flatten_params(jparams))


def test_from_jax_flat_rejects_bad_gemma3_trees(jparams):
    f = flat(jparams)
    missing = {k: v for k, v in f.items() if k != "blocks/1/att/k_norm/shift"}
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat(missing, TCFG, device="cpu")
    extra = dict(f, **{"blocks/0/att/wq/b": np.zeros(64, np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        from_jax_flat(extra, TCFG, device="cpu")
    bad = dict(f, **{"blocks/0/att/out_proj/b": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(bad, TCFG, device="cpu")


def test_init_draws_the_jax_distributions():
    model = tg.init(dict(TCFG, vocab_size=4096), generator=torch.Generator().manual_seed(0), device="cpu")
    w = model.tok_emb["w"].detach()
    assert abs(float(w.mean())) < 0.02 and abs(float(w.std()) - 1.0) < 0.02  # N(0, 1), not Xavier
    wq = model.blocks[0].att.wq.w.detach()
    assert float(wq.abs().max()) <= TINY["emb_dim"] ** -0.5  # U(±1/sqrt(in))
    norm = model.blocks[0].att.q_norm
    assert torch.equal(norm["scale"], torch.ones(16)) and torch.equal(norm["shift"], torch.zeros(16))


def test_scaled_rope_tables_raise():
    """``scaled=True`` gives JAX's YaRN tables (the unscaled ones for a config
    without "rope_freq"); a "rope_freq" that lacks a key the scaling reads
    raises ValueError, where JAX raises KeyError."""
    cos, sin = tg.rope_tables(TCFG, device="cpu")
    jcos, jsin = jg.rope_tables(JCFG)
    assert max_err(cos, jcos) == 0.0 and max_err(sin, jsin) == 0.0
    assert all(max_err(a, b) == 0.0 for a, b in zip(tg.rope_tables(TCFG, scaled=True, device="cpu"), (cos, sin)))
    freq = {"factor": 8.0, "alpha": 1.0, "beta": 4.0, "og_ctx_len": 16, "ctx_len": 64}
    got = tg.rope_tables(dict(TCFG, rope_freq=freq), scaled=True, device="cpu")
    ref = jg.rope_tables(dict(JCFG, rope_freq=freq), scaled=True)
    assert all(max_err(a, b) <= 1e-6 for a, b in zip(got, ref)) and max_err(got[0], cos) > 0.1
    with pytest.raises(ValueError, match="ctx_len"):
        tg.rope_tables(dict(TCFG, rope_freq={"factor": 8.0, "alpha": 1.0, "beta": 4.0}), scaled=True, device="cpu")


# Gemma-3-270M's published widths (google/gemma-3-270m config.json)
GEMMA3_270M = {
    "vocab_size": 262_144, "context_length": 32_768, "emb_dim": 640, "n_layers": 18, "n_heads": 4,
    "num_kv_groups": 1, "head_dim": 256, "hidden_dim": 2048, "window_size": 512, "local_global_att_ratio": 5,
    "rope_base": 10_000,
}


def test_swa_flop_count_diverges_from_jax_only_below_the_window():
    """The port counts an SWA layer at its mean visible context (a documented
    divergence); JAX counts every layer at s/2. A window at or above s, and
    the Qwen configs, keep JAX's count exactly."""
    from llm_quest_tpu.training import flops as jflops
    from llm_quest_tpu_torch.training import flops as tflops

    jcfg = dict(GEMMA3_270M, dtype=jnp.bfloat16)
    got = tflops.text_train_flops_per_token(GEMMA3_270M, seq_len=2048)
    ref = jflops.text_train_flops_per_token(jcfg, seq_len=2048)
    # by hand: 18 × (q, k, v, o and the GeGLU FFN) + the head, plus QKᵀ and PV at
    # 4096 FLOPs per key: 15 SWA layers at a mean context of 448.125, 3 global at 1024
    dense = 18 * (2 * 640 * 1024 + 2 * 640 * 512 + 2 * 1024 * 640 + 6 * 640 * 2048) + 2 * 640 * 262_144
    hand = 3 * (dense + 4096 * (15 * 448.125 + 3 * 1024))
    assert got == hand and round(got / 1e5) == 17286
    assert ref == 1834745856 and round(ref / 1e5) == 18347
    assert tflops.swa_mean_context(512, 2048) == 448.125
    for window in (2048, 4096):  # a window ≥ s hides no key
        cfg = dict(GEMMA3_270M, window_size=window)
        assert tflops.text_train_flops_per_token(cfg, seq_len=2048) == jflops.text_train_flops_per_token(
            dict(cfg, dtype=jnp.bfloat16), seq_len=2048)
    # ratio 0: every layer global, no divergence
    cfg = dict(GEMMA3_270M, local_global_att_ratio=0)
    assert tflops.text_train_flops_per_token(cfg, seq_len=2048) == ref


# ------------------------------------------------------------------ forward, generation


@pytest.mark.parametrize("padded", [False, True])
def test_apply_matches_jax(jparams, model, padded):
    b = batch_np(0, padded)
    mask = b.get("attn_mask")
    ref, _, _ = jg.apply(jparams, JCFG, jnp.asarray(b["input_ids"]),
                         attn_mask=None if mask is None else jnp.asarray(mask))
    got, _, _ = tg.apply(model, TCFG, T(b["input_ids"]), attn_mask=None if mask is None else T(mask))
    assert max_err(got, ref) <= 1e-4


def test_flash_route_runs_the_window_on_swa_layers_only(model, monkeypatch):
    """Each layer's uncached attention takes the flash wrapper, with the
    window on the SWA layer (0) and none on the global layer (1)."""
    from llm_quest_tpu_torch.kernels import attention as kattn

    seen, real = [], kattn.flash_attention

    def spy(*args, **kwargs):
        seen.append(kwargs.get("window_size"))
        return real(*args, **kwargs)

    monkeypatch.setattr(kattn, "flash_attention", spy)
    tg.apply(model, TCFG, T(batch_np(0)["input_ids"]))
    assert seen == [TINY["window_size"], None]


def test_generate_kv_cache_matches_jax(jparams, model):
    """A 12-token prompt (past the window) and 8 greedy tokens: the cached
    branch (``sdpa`` on the dense SWA and global masks) in both packages."""
    ids = np.random.default_rng(5).integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
    ref = jgen.generate_kv_cache(jg, jparams, JCFG, jnp.asarray(ids), max_gen=8, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tg, model, TCFG, T(ids).long(), max_gen=8, temp=0.0, eos_ids=-1, pad_id=0)
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(ref["sequences"]))


def test_cached_decode_matches_uncached_flash_route(model):
    """Greedy tokens of the cached engine equal those of uncached forwards
    through the flash route (window on the SWA layer), over sequences that
    grow past two windows."""
    ids = T(np.random.default_rng(6).integers(0, TINY["vocab_size"], (1, 16))).long()
    cached = tgen.generate_kv_cache(tg, model, TCFG, ids, max_gen=6, temp=0.0, eos_ids=-1, pad_id=0)["sequences"]
    seq = ids
    with torch.no_grad():
        for _ in range(6):
            logits, _, _ = tg.apply(model, TCFG, seq)
            seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
    assert torch.equal(cached, seq)


# ------------------------------------------------------------------ loss, gradients, train step


def jax_loss_and_grads(jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits, _, aux = jg.apply(p, JCFG, jb["input_ids"], attn_mask=jb.get("attn_mask"))
        return jengine.global_loss(logits, jb["targets"], aux)

    return jax.value_and_grad(loss_fn)(jparams)


@pytest.mark.parametrize("padded", [False, True])
def test_global_loss_and_gradients_match_jax(jparams, model, padded):
    b = batch_np(2, padded)
    ref_loss, ref_grads = jax_loss_and_grads(jparams, b)
    loss = tengine.make_loss_fn(tg, TCFG)(model, tengine.as_tensors(b, "cpu"))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = {k.replace("/", "."): v for k, v in flat(ref_grads).items()}
    for (name, _), g in zip(model.named_parameters(), grads):
        assert rel_err(g, port_layout(model, name, ref[name])) <= 1e-4, name
        if name.endswith("k_norm.shift"):  # softmax-invariant: zero up to fp32 noise
            assert max_err(g, 0.0) <= 1e-5 and max_err(ref[name], 0.0) <= 1e-5, name


@pytest.mark.parametrize("padded", [False, True])
def test_train_step_matches_jax(jparams, model, padded):
    jstep = jengine.make_train_step(jg, JCFG, jengine.make_optimizer(1e-3))
    tstep = tengine.make_train_step(tg, TCFG, tengine.make_optimizer(1e-3))
    jp = jax.tree.map(jnp.copy, jparams)  # the JAX step donates its params
    jstate, tstate = jengine.make_optimizer(1e-3).init(jp), tengine.make_optimizer(1e-3).init(model)
    for i in range(2):
        b = batch_np(10 + i, padded)
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        model, tstate, tloss = tstep(model, tstate, b)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    ref = flat(jp)
    for name, p in model.named_parameters():
        if not name.endswith("k_norm.shift"):  # a zero gradient's noise steps (module docstring)
            assert max_err(p, port_layout(model, name, ref[name.replace(".", "/")])) <= 3e-4, name
