"""The ported GPT-2 against the JAX package, on the CPU in fp32.

A tiny GPT-2 (2 layers, 4 heads of 16, vocabulary 128, biased q/k/v) is
initialised in JAX, flattened and loaded into the port with
``from_jax_flat``; both packages run the same numpy-seeded batches of 24
tokens. JAX runs its flash-attention Pallas kernel in interpret mode
(``use_flash=True``, ``flash_min_seq`` 16), causal with the padding key
mask, so the port's plain flash version and its autograd gradients are held
against the kernel and its custom VJP. Cases: JAX's ``tests/test_gpt2.py``
(forward, causality, cached prefill and decode against the uncached
forward, ``last_token_only``, padding, ``input_embedded``), its
``test_generate.py`` GPT-2 cases (right- and left-padded batches, EOS) at
that file's config, the loss and every gradient, two train steps,
dropout in the train step and in ``training_eval_loop``, the FLOP count,
the int8 trees and the loads of fp32, bf16, int8 and stacked-LoRA trees.
Tolerances: logits within 1e-4; the loss within 1e-5 relative and every
gradient within 1e-4 relative to max(1, max |g|); after 2 steps (learning
rate 1e-3) the parameters within 3e-4 (Adam turns a near-zero gradient's
fp32 noise into a step of up to the learning rate); tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import gpt2 as jg
from llm_quest_tpu.ops import lora as jlora
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.training import flops as jflops
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.config import GPT_CONFIG_124M, GPT_SMALL_CONFIG
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.models import gpt2 as tg
from llm_quest_tpu_torch.ops import lora as tlora
from llm_quest_tpu_torch.ops import quantization as tquant
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.training import flops as tflops
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {
    "vocab_size": 128,
    "context_length": 64,
    "emb_dim": 64,
    "n_heads": 4,
    "n_layers": 2,
    "drop_rate": 0.0,
    "qkv_bias": True,
    "flash_min_seq": 16,
}
JCFG = dict(TINY, use_flash=True)  # the Pallas kernel, interpret mode; fp32 (no "dtype" key)
TCFG = dict(TINY)
B, S = 2, 24
# tests/test_generate.py's config
GEN_CFG = {"vocab_size": 61, "context_length": 48, "emb_dim": 32, "n_heads": 4, "n_layers": 2, "drop_rate": 0.0,
           "qkv_bias": False}
PAD, EOS = 59, 60


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
    owner = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(owner), Linear):
        return np.asarray(arr).T
    return np.asarray(arr)


@pytest.fixture(scope="module")
def jparams():
    return jg.init(jax.random.PRNGKey(0), JCFG)


@pytest.fixture
def model(jparams):
    return from_jax_flat(flat(jparams), TCFG, device="cpu")


@pytest.fixture(scope="module")
def gen_models():
    jp = jg.init(jax.random.PRNGKey(7), GEN_CFG)
    return jp, from_jax_flat(flat(jp), GEN_CFG, device="cpu")


# ------------------------------------------------------------------ config, weights


def test_configs_match_jax():
    from llm_quest_tpu import config as jconfig

    assert GPT_CONFIG_124M == jconfig.GPT_CONFIG_124M and GPT_SMALL_CONFIG == jconfig.GPT_SMALL_CONFIG


def test_routed_named_and_trainable_like_jax(jparams, model):
    assert isinstance(model, tg.GPT2)
    assert all(p.requires_grad for p in model.parameters())
    assert {n.replace(".", "/") for n, _ in model.named_parameters()} == set(flatten_params(jparams))


def test_init_draws_the_jax_distributions():
    model = tg.init(dict(TCFG, vocab_size=4096, context_length=1024), generator=torch.Generator().manual_seed(0),
                    device="cpu")
    for table in (model.tok_emb["w"], model.pos_emb["w"]):
        w = table.detach()
        assert abs(float(w.mean())) < 0.02 and abs(float(w.std()) - 1.0) < 0.02  # N(0, 1)
    bound = TINY["emb_dim"] ** -0.5
    att = model.blocks[0].att
    # U(±1/sqrt(in))
    assert float(att.wq.w.detach().abs().max()) <= bound and float(att.wq.b.detach().abs().max()) <= bound
    assert model.out.b is None and tuple(model.out.w.shape) == (4096, TINY["emb_dim"])
    assert torch.equal(model.final_ln["scale"], torch.ones(64)) and torch.equal(model.final_ln["shift"],
                                                                                 torch.zeros(64))


def test_pipeline_parallel_raises(model):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tg.apply(model, dict(TCFG, pipeline_parallel={"mesh": None}), T(batch_np(0)["input_ids"]).long())


def test_gpt2_mlp_flop_count_matches_jax():
    for cfg in (GPT_CONFIG_124M, GPT_SMALL_CONFIG):
        got = tflops.text_train_flops_per_token(cfg, seq_len=1024)
        assert got == jflops.text_train_flops_per_token(cfg, seq_len=1024)
    d = 768  # by hand at 124M: 12 × (q, k, v, o, the 4·d MLP, QKᵀ and PV at 512 keys) + the head
    hand = 3 * (12 * (4 * 2 * d * d + 2 * 2 * d * 4 * d + 2 * 512 * 2 * d) + 2 * d * 50257)
    assert tflops.text_train_flops_per_token(GPT_CONFIG_124M, seq_len=1024) == hand


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("padded", [False, True])
def test_apply_matches_jax(jparams, model, padded):
    b = batch_np(0, padded)
    mask = b.get("attn_mask")
    ref, _, _ = jg.apply(jparams, JCFG, jnp.asarray(b["input_ids"]), attn_mask=None if mask is None else
                         jnp.asarray(mask))
    got, cache, aux = tg.apply(model, TCFG, T(b["input_ids"]).long(), attn_mask=None if mask is None else T(mask))
    assert cache is None and aux == {}
    assert max_err(got, ref) <= 1e-4


def test_causality_and_padding_do_not_leak(model):
    a = T([[1, 2, 3, 4, 7, 8, 0, 0]]).long()
    b = T([[1, 2, 3, 90, 7, 8, 55, 66]]).long()
    la, _, _ = tg.apply(model, TCFG, a)
    lb, _, _ = tg.apply(model, TCFG, b)
    assert max_err(la[0, :3], lb[0, :3]) <= 1e-5  # a later token moves no earlier logit
    mask = T([[True] * 6 + [False] * 2])
    la, _, _ = tg.apply(model, TCFG, a, attn_mask=mask)
    lb, _, _ = tg.apply(model, TCFG, T([[1, 2, 3, 4, 7, 8, 55, 66]]).long(), attn_mask=mask)
    assert max_err(la[0, :6], lb[0, :6]) <= 1e-5  # nor does a padded slot


def test_cached_prefill_and_decode_match_jax_and_the_uncached_forward(jparams, model):
    """A 6-token prefill at column 0 of a 16-column cache, then 3 decode
    steps: logits equal JAX's cached calls and the uncached forward."""
    ids = np.asarray([[3, 14, 15, 92, 65, 35, 8, 97, 9]], np.int32)
    full, _, _ = tg.apply(model, TCFG, T(ids).long())
    jc, tc = jg.init_cache(JCFG, 1, 16), tg.init_cache(TCFG, 1, 16, device="cpu")
    got, ref = [], []
    for lo, hi in ((0, 6), (6, 7), (7, 8), (8, 9)):
        jl, jc, _ = jg.apply(jparams, JCFG, jnp.asarray(ids[:, lo:hi]), cache=jc)
        tl, tc, _ = tg.apply(model, TCFG, T(ids[:, lo:hi]).long(), cache=tc)
        ref.append(np.asarray(jl))
        got.append(tl)
        assert tc["pos"] == int(jc["pos"]) == hi
    assert max_err(torch.cat(got, 1), np.concatenate(ref, 1)) <= 1e-4
    assert max_err(torch.cat(got, 1), full) <= 1e-4


def test_last_token_only_matches_jax(jparams, model):
    ids = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    mask = np.asarray([[True, True, True, False], [True, True, False, False]])
    ref, _, _ = jg.apply(jparams, JCFG, jnp.asarray(ids), attn_mask=jnp.asarray(mask), last_token_only=True)
    got, _, _ = tg.apply(model, TCFG, T(ids).long(), attn_mask=T(mask), last_token_only=True)
    full, _, _ = tg.apply(model, TCFG, T(ids).long(), attn_mask=T(mask))
    assert got.shape == (2, TINY["vocab_size"]) and max_err(got, ref) <= 1e-4
    assert max_err(got[0], full[0, 2]) <= 1e-5 and max_err(got[1], full[1, 1]) <= 1e-5
    with pytest.raises(ValueError, match="attn_mask"):
        tg.apply(model, TCFG, T(ids).long(), last_token_only=True)


def test_input_embedded_matches_jax(jparams, model):
    emb = np.random.default_rng(0).normal(size=(1, 5, TINY["emb_dim"])).astype(np.float32)
    ref, _, _ = jg.apply(jparams, JCFG, jnp.asarray(emb), input_embedded=True)
    got, _, _ = tg.apply(model, TCFG, T(emb), input_embedded=True)
    assert got.shape == (1, 5, TINY["vocab_size"]) and max_err(got, ref) <= 1e-4


# ------------------------------------------------------------------ generation (tests/test_generate.py)


def test_right_padded_batch_matches_jax(gen_models):
    jp, model = gen_models
    batch = np.asarray([[5, 9, 2, 17], [11, 3, PAD, PAD]], np.int32)
    mask = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0]], bool)
    kw = dict(max_gen=5, temp=0.0, eos_ids=EOS, pad_id=PAD)
    ref = jgen.generate_batched_kv_cache(jg, jp, GEN_CFG, jnp.asarray(batch), jnp.asarray(mask), **kw)
    got = tgen.generate_batched_kv_cache(tg, model, GEN_CFG, T(batch).long(), T(mask), **kw)
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(ref["sequences"]))
    solo = tgen.generate_kv_cache(tg, model, GEN_CFG, T([[11, 3]]).long(), **kw)
    np.testing.assert_array_equal(got["sequences"][1, 4:].numpy(), solo["sequences"][0, 2:7].numpy())


def test_left_padded_batch_matches_jax(gen_models):
    jp, model = gen_models
    batch = np.asarray([[PAD, PAD, 11, 3], [5, 9, 2, 17]], np.int32)
    mask = np.asarray([[0, 0, 1, 1], [1, 1, 1, 1]], bool)
    kw = dict(max_gen=5, temp=0.0, eos_ids=EOS, pad_id=PAD, left_pad=True)
    ref = jgen.generate_batched_kv_cache(jg, jp, GEN_CFG, jnp.asarray(batch), jnp.asarray(mask), **kw)
    got = tgen.generate_batched_kv_cache(tg, model, GEN_CFG, T(batch).long(), T(mask), **kw)
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(ref["sequences"]))


def test_eos_finishes_row_with_pad_like_jax(gen_models):
    jp, model = gen_models
    prompt = np.asarray([[5, 9]], np.int32)
    free = tgen.generate_kv_cache(tg, model, GEN_CFG, T(prompt).long(), max_gen=4, eos_ids=EOS, pad_id=PAD)
    first = int(free["sequences"][0, 2])
    ref = jgen.generate_kv_cache(jg, jp, GEN_CFG, jnp.asarray(prompt), max_gen=4, temp=0.0, eos_ids=first,
                                 pad_id=PAD)
    got = tgen.generate_kv_cache(tg, model, GEN_CFG, T(prompt).long(), max_gen=4, eos_ids=first, pad_id=PAD)
    np.testing.assert_array_equal(got["sequences"][0, 2:].numpy(), [first, PAD, PAD, PAD])
    np.testing.assert_array_equal(got["sequences"].numpy(), np.asarray(ref["sequences"]))
    assert not got["mask"][0, 2:].any() and np.array_equal(got["mask"].numpy(), np.asarray(ref["mask"]))


# ------------------------------------------------------------------ loss, gradients, train step


@pytest.mark.parametrize("padded", [False, True])
def test_loss_and_gradients_match_jax(jparams, model, padded):
    b = batch_np(2, padded)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p):
        logits, _, aux = jg.apply(p, JCFG, jb["input_ids"], attn_mask=jb.get("attn_mask"))
        return jengine.global_loss(logits, jb["targets"], aux)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    loss = tengine.make_loss_fn(tg, TCFG)(model, tengine.as_tensors(b, "cpu"))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert abs(float(loss.detach()) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = {k.replace("/", "."): v for k, v in flat(ref_grads).items()}
    for (name, _), g in zip(model.named_parameters(), grads):
        assert rel_err(g, port_layout(model, name, ref[name])) <= 1e-4, name


def test_train_step_matches_jax(jparams, model):
    """Two steps through ``make_train_step`` (fused-head CE in the port, the
    full logits in JAX: GPT-2's head has no bias, so both are exact)."""
    jstep = jengine.make_train_step(jg, JCFG, jengine.make_optimizer(1e-3))
    tstep = tengine.make_train_step(tg, TCFG, tengine.make_optimizer(1e-3), fused_head_ce=True)
    jp = jax.tree.map(jnp.copy, jparams)  # the JAX step donates its params
    jstate, tstate = jengine.make_optimizer(1e-3).init(jp), tengine.make_optimizer(1e-3).init(model)
    for i in range(2):
        b = batch_np(10 + i, padded=bool(i))
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        model, tstate, tloss = tstep(model, tstate, b)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss)), i
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert max_err(p, port_layout(model, name, ref[name.replace(".", "/")])) <= 3e-4, name


def test_dropout_train_step_draws_from_its_generator(model):
    """With dropout (JAX's ``has_dropout``) the step takes a generator: the
    same seed gives the same loss, another seed another, both away from
    the deterministic loss; without a generator it raises."""
    cfg = dict(TCFG, drop_rate=0.1)
    batch = tengine.as_tensors(batch_np(3), "cpu")
    value_and_grad = tengine.make_value_and_grad(tg, cfg, has_dropout=True)
    losses = [float(value_and_grad(model, batch, torch.Generator().manual_seed(s))[0]) for s in (1, 1, 2)]
    plain = float(tengine.make_value_and_grad(tg, cfg)(model, batch)[0])
    assert losses[0] == losses[1] and losses[0] != losses[2] and plain not in losses
    with pytest.raises(ValueError, match="generator"):
        value_and_grad(model, batch)
    step = tengine.make_train_step(tg, cfg, tengine.make_optimizer(1e-3), has_dropout=True)
    opt = tengine.make_optimizer(1e-3)
    _, _, loss = step(model, opt.init(model), batch, torch.Generator().manual_seed(1))
    assert float(loss) == losses[0]


def test_training_eval_loop_trains_gpt2_with_dropout_and_refuses_models_without_it(model):
    cfg = dict(TCFG, drop_rate=0.1)
    batches = [batch_np(20 + i) for i in range(4)]
    logs = []
    _, train_losses, val_losses = tengine.training_eval_loop(
        tg, cfg, model, batches, batches[:1], num_epoch=2, peak_lr=1e-2, eval_freq=2, eval_iter=2,
        generator=torch.Generator().manual_seed(0), log=logs.append)
    assert len(train_losses) == len(val_losses) == len(logs) == 5  # steps 1, 2, 4, 6, 8
    assert all(np.isfinite(train_losses)) and train_losses[-1] < train_losses[0]
    from llm_quest_tpu_torch.models import qwen3_next

    with pytest.raises(NotImplementedError, match="no dropout generator"):
        tengine.training_eval_loop(qwen3_next, {"p_dropout": 0.1}, model, batches, [], num_epoch=1)


# ------------------------------------------------------------------ weights: int8, bf16, LoRA


def quantize_both(jparams, model, **options):
    return jquant.quantize_params_int8(jparams, **options), tquant.quantize_params_int8(model, **options)


@pytest.mark.parametrize("options", [{}, {"quantize_embeddings": True, "min_size": 0}], ids=["default", "tables"])
def test_int8_tree_matches_jax_leaf_by_leaf_but_the_position_table(jparams, model, options):
    """Every JAX leaf of ``quantize_params_int8`` equals the port's (``w_q``
    transposed): the biased linears, the untied head ``out`` and, with
    ``quantize_embeddings``, the token table. The position table is the
    divergence: JAX takes it for a linear (per-column scales), the port keeps
    it in its type."""
    jq, tq = quantize_both(jparams, model, **options)
    ref, state = flat(jq), tq.state_dict()
    assert {"pos_emb/w_q", "pos_emb/w_scale"} <= set(ref) and "pos_emb.w" in state and "pos_emb.w_q" not in state
    assert isinstance(tq.out, tquant.QuantLinear) and isinstance(tq.blocks[0].att.wq, tquant.QuantLinear)
    assert ("tok_emb.w_q" in state) == bool(options)
    for name, arr in ref.items():
        if name.startswith("pos_emb/"):
            continue
        got = state[name.replace("/", ".")]
        got = got.T if name.endswith("/w_q") and got.ndim == 2 and not name.startswith("tok_emb") else got
        assert np.array_equal(got.numpy(), arr), name
    assert np.array_equal(state["pos_emb.w"].numpy(), flat(jparams)["pos_emb/w"])


def test_from_jax_flat_loads_the_int8_tree(jparams, model):
    """JAX's int8 tree (quantized position table included) loads: its linears
    as ``QuantLinear``, the position table dequantized into its type. With
    the table left out of JAX's quantization the logits equal JAX's (fp32
    activations); with it in, JAX's gather reads per-column scales by
    position (its embedding takes them for per-row ones) and its logits move
    away from both."""
    ids = T(batch_np(4)["input_ids"]).long()
    default = jquant.quantize_params_int8(jparams)
    loaded = from_jax_flat(flat(default), TCFG, device="cpu")
    f = flat(default)
    assert max_err(loaded.pos_emb["w"], f["pos_emb/w_q"].astype(np.float32) * f["pos_emb/w_scale"][None]) == 0.0
    kept = jquant.quantize_params_int8(jparams, exclude=r"tok_emb|conv|pos_emb")
    ref, _, _ = jg.apply(kept, JCFG, jnp.asarray(ids.numpy()))
    got, _, _ = tg.apply(from_jax_flat(flat(kept), TCFG, device="cpu"), TCFG, ids)
    assert rel_err(got, ref) <= 1e-5
    faulty, _, _ = jg.apply(default, JCFG, jnp.asarray(ids.numpy()))
    ours, _, _ = tg.apply(loaded, TCFG, ids)
    assert rel_err(ours, ref) <= 1e-2 < rel_err(np.asarray(faulty), ref)


def test_from_jax_flat_loads_bf16_and_stacked_lora_trees(jparams):
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    model = from_jax_flat(flat(bf16), dict(TCFG, dtype=torch.bfloat16), device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in model.state_dict().values())
    key = jax.random.PRNGKey(3)
    trees = []
    for a in range(2):
        tree = jlora.replace_with_lora(jax.random.fold_in(key, a), jparams, 4, 8,
                                       path_filter=lambda p: "att" in p or "ffn" in p)
        trees.append(jax.tree_util.tree_map_with_path(
            lambda path, x, a=a: 0.2 * jax.random.normal(jax.random.fold_in(key, 10 + a + x.size), x.shape)
            if jax.tree_util.keystr(path).endswith("['B']") else x, tree))
    stacked = jlora.stack_adapters(trees)
    model = from_jax_flat(flat(stacked), TCFG, device="cpu")
    assert tlora.num_adapters(model) == 3 == jlora.num_adapters(stacked)
    idx = np.asarray([1, 0], np.int32)
    ids = batch_np(5)["input_ids"]
    ref, _, _ = jg.apply(jlora.select_adapter(stacked, jnp.asarray(idx)), JCFG, jnp.asarray(ids))
    tlora.select_adapter(model, T(idx).long())
    got, _, _ = tg.apply(model, TCFG, T(ids).long())
    assert rel_err(got, ref) <= 1e-5
