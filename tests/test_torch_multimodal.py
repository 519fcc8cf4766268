"""The ported ViT→GPT-2 VLM and image preprocessing against the JAX
package, on the CPU in fp32.

A tiny ViT (2 layers, 32 px, patch 8: 17 tokens, 2 heads of 64, so the
port's ``mha_packed`` takes K7's plain version), a tiny GPT-2 (2 layers, d
64, 4 heads, vocabulary 128, biased q/k/v) and an "ffn" adapter are drawn by
the port's ``init`` functions and handed to JAX over ``jax.eval_shape`` of
JAX's ``init`` (JAX's eager ``init`` of the ViT alone takes seconds); those
JAX trees are loaded back into the port with ``from_jax_flat``, and both
packages run the
same numpy-seeded images and captions (8 text tokens, row 1 right-padded).
Cases: the adapter in both types with and without a bias (and a bf16 input
into the fp32 adapter, JAX's promotion), ``fuse``, ``vlm_loss``'s alignment
(JAX's ``tests/test_vit_vlm.py``), ``vlm_forward_loss`` and the adapter's and
GPT-2's gradients against ``jax.value_and_grad`` through JAX's ``sdpa`` and,
with ``flash_min_seq`` 16, through JAX's flash kernel in interpret mode
against the port's plain K4; greedy ``vlm_generate`` tokens with an EOS that
fires mid-caption; the normalization folding in 2-D and 3-D,
``resize_bilinear`` down and up, ``make_uint8_encoder``,
``multimodal_batches``, one step of the port's ``scripts/vlm_training.py``
against JAX's step, and the JAX VLM's three trees through ``from_jax_flat``.
Tolerances: outputs within 1e-5, the loss 1e-5 relative and the gradients
1e-5 relative to max(1, max |g|); tokens and batches exactly; the resize
within 1e-3 on a 0–255 scale; after one AdamW step (lr 1e-4) a parameter
within 1e-5 of its leaf's max |·| plus 1 % of the learning rate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_quest_tpu.data import datasets as jdata
from llm_quest_tpu.models import gpt2 as jg
from llm_quest_tpu.models import qwen3_5 as jq
from llm_quest_tpu.models import vit as jv
from llm_quest_tpu.multimodal import preprocessing as jpre
from llm_quest_tpu.multimodal import vlm as jvlm
from llm_quest_tpu.weights.interop import flatten_params as jflatten
from llm_quest_tpu.weights.interop import unflatten_into as junflatten
from llm_quest_tpu_torch.data import datasets as tdata
from llm_quest_tpu_torch.models import gpt2 as tg
from llm_quest_tpu_torch.models import qwen3_5 as tq
from llm_quest_tpu_torch.models import vit as tv
from llm_quest_tpu_torch.multimodal import preprocessing as tpre
from llm_quest_tpu_torch.multimodal import vlm as tvlm
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.scripts import vlm_training as tscript
from llm_quest_tpu_torch.weights.interop import from_jax_flat

VIT = {"img_width": 32, "img_height": 32, "patch_size": 8, "num_channels": 3, "emb_dim": 128, "n_layers": 2,
       "n_heads": 2, "drop_rate": 0.0, "qkv_bias": True, "num_classes": 10}
GPT = {"vocab_size": 128, "context_length": 64, "emb_dim": 64, "n_heads": 4, "n_layers": 2, "drop_rate": 0.0,
       "qkv_bias": True}
FLASH = {"flash_min_seq": 16}  # the fused 17 + 8 tokens reach K4
B, S, NV = 2, 8, 17
PAD = 127


def T(x):
    return torch.from_numpy(np.array(x))


def flat(params):
    return {k: np.asarray(v) for k, v in jflatten(params).items()}


def arr(x):
    return x.detach().float().numpy().astype(np.float64) if torch.is_tensor(x) else np.asarray(x, np.float64)


def max_err(got, ref):
    return float(np.abs(arr(got) - arr(ref)).max())


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(arr(ref)).max()))


def jax_layout(model, name, t):
    """A port leaf in JAX's layout: a Linear weight transposed."""
    owner = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(owner), Linear):
        return t.T
    return t


def batch_np(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, S), bool)
    mask[1, -3:] = False
    return {"image": rng.normal(size=(B, 3, 32, 32)).astype(np.float32),
            "input_ids": rng.integers(0, GPT["vocab_size"], (B, S)).astype(np.int32), "attention_mask": mask}


def to_jax(model, init_fn):
    """The JAX tree of a port model: its leaves in JAX's layout over
    ``jax.eval_shape`` of JAX's ``init``."""
    updates = {n.replace(".", "/"): jax_layout(model, n, t).detach().numpy() for n, t in model.state_dict().items()}
    return junflatten(jax.eval_shape(init_fn), updates)


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def jmodels():
    """JAX's ViT, GPT-2 and adapter trees, drawn by the port's ``init`` functions."""
    adapter = tvlm.init_adapter(VIT["emb_dim"], GPT["emb_dim"], generator=gen(2), adapter_type="ffn", device="cpu")
    return (to_jax(tv.init(VIT, generator=gen(0), device="cpu"), lambda: jv.init(jax.random.PRNGKey(0), VIT)),
            to_jax(tg.init(GPT, generator=gen(1), device="cpu"), lambda: jg.init(jax.random.PRNGKey(1), GPT)),
            to_jax(adapter, lambda: jvlm.init_adapter(jax.random.PRNGKey(2), VIT["emb_dim"], GPT["emb_dim"],
                                                      adapter_type="ffn")))


@pytest.fixture(scope="module")
def tmodels(jmodels):
    vit_p, gpt_p, adapter = jmodels
    return (from_jax_flat(flat(vit_p), VIT, device="cpu"), from_jax_flat(flat(gpt_p), GPT, device="cpu"),
            from_jax_flat(flat(adapter), {}, device="cpu"))


# ------------------------------------------------------------------ adapter, fusion, loss


@pytest.mark.parametrize("adapter_type", ["simple", "ffn"])
@pytest.mark.parametrize("bias", [False, True])
def test_adapter_matches_jax(adapter_type, bias):
    ja = jvlm.init_adapter(jax.random.PRNGKey(3), 128, 64, adapter_type=adapter_type, bias=bias)
    ta = from_jax_flat(flat(ja), {}, device="cpu")
    assert isinstance(ta, tvlm.ViTAdapter) and set(dict(ta.named_children())) == set(ja)
    assert {n.replace(".", "/") for n, _ in ta.named_parameters()} == set(flat(ja))
    x = np.random.default_rng(4).normal(size=(2, 5, 128)).astype(np.float32)
    assert max_err(ta(T(x)), jvlm.adapter_apply(ja, jnp.asarray(x))) <= 1e-5
    # a bf16 ViT into JAX's default fp32 adapter: JAX promotes, so does the port
    ref = jvlm.adapter_apply(ja, jnp.asarray(x, jnp.bfloat16))
    got = tvlm.adapter_apply(ta, T(x).to(torch.bfloat16))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32 and max_err(got, ref) <= 1e-5


def test_init_adapter_shapes_and_distribution():
    ta = tvlm.init_adapter(128, 64, generator=torch.Generator().manual_seed(0), adapter_type="ffn", bias=True,
                           device="cpu")
    assert tuple(ta.fc.w.shape) == (512, 128) and tuple(ta.proj.w.shape) == (64, 512)
    assert all(p.requires_grad for p in ta.parameters())
    assert float(ta.fc.w.detach().abs().max()) <= 128**-0.5 and float(ta.proj.b.detach().abs().max()) <= 512**-0.5
    with pytest.raises(ValueError, match="Invalid adapter type"):
        tvlm.ViTAdapter(4, 4, adapter_type="mlp", device="cpu")


def test_fuse_matches_jax(jmodels, tmodels):
    b = batch_np()
    ref = jvlm.fuse(jv, jmodels[0], VIT, jmodels[2], jmodels[1], jnp.asarray(b["image"]), jnp.asarray(b["input_ids"]),
                    jnp.asarray(b["attention_mask"]))
    got = tvlm.fuse(tv, tmodels[0], VIT, tmodels[2], tmodels[1], T(b["image"]), T(b["input_ids"]).long(),
                    T(b["attention_mask"]))
    assert got[2] == ref[2] == NV
    assert max_err(got[0], ref[0]) <= 1e-5
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


def test_vlm_loss_alignment_and_matches_jax():
    logits = torch.zeros(B, 5 + 4, 128)
    labels, mask = torch.ones(B, 4, dtype=torch.long), torch.ones(B, 4, dtype=torch.bool)
    assert abs(float(tvlm.vlm_loss(logits, labels, mask, 5)) - float(np.log(128))) < 1e-4  # uniform: log v
    assert float(tvlm.vlm_loss(logits, labels, torch.zeros(B, 4, dtype=torch.bool), 5)) == 0.0  # no text: 0
    rng = np.random.default_rng(5)
    lg = rng.normal(size=(B, 5 + 4, 128)).astype(np.float32)
    lb = rng.integers(0, 128, (B, 4)).astype(np.int32)
    mk = np.asarray([[1, 1, 1, 1], [1, 1, 0, 0]], bool)
    ref = jvlm.vlm_loss(jnp.asarray(lg), jnp.asarray(lb), jnp.asarray(mk), 5)
    assert abs(float(tvlm.vlm_loss(T(lg), T(lb).long(), T(mk), 5)) - float(ref)) <= 1e-6


@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "k4"])
def test_vlm_forward_loss_and_grads_match_jax(jmodels, tmodels, flash):
    """Loss, the adapter's and GPT-2's gradients; with ``flash`` JAX runs
    its K4 Pallas kernel in interpret mode and the port K4's plain version
    (the fused 25 tokens from ``flash_min_seq`` 16, key mask [1 × 17 ‖ the
    text mask])."""
    jcfg, tcfg = (dict(GPT, use_flash=True, **FLASH), dict(GPT, **FLASH)) if flash else (GPT, GPT)
    b = batch_np()
    vit_p, gpt_p, adapter = jmodels
    loss_fn = lambda a, lp: jvlm.vlm_forward_loss(jv, vit_p, VIT, a, lp, jcfg,  # noqa: E731
                                                  {k: jnp.asarray(v) for k, v in b.items()})
    ref, (ga, gl) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(adapter, gpt_p)

    tvit, tgpt, tad = (m for m in tmodels)
    for m in (tgpt, tad):
        m.zero_grad(set_to_none=True)
    loss = tvlm.vlm_forward_loss(tv, tvit, VIT, tad, tgpt, tcfg,
                                 {"image": T(b["image"]), "input_ids": T(b["input_ids"]).long(),
                                  "attention_mask": T(b["attention_mask"])})
    loss.backward()
    assert abs(float(loss.detach()) - float(ref)) <= 1e-5 * abs(float(ref))
    assert all(p.grad is None for p in tvit.parameters())  # the ViT is frozen
    for model, jgrads in ((tad, ga), (tgpt, gl)):
        jflat = flat(jgrads)
        for name, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            assert rel_err(jax_layout(model, name, g), jflat[name.replace(".", "/")]) <= 1e-5, name
    assert float(tad.fc.w.grad.abs().max()) > 0 and float(tgpt.blocks[0].att.wq.w.grad.abs().max()) > 0


def test_vlm_forward_routes_k4_at_the_fused_length(tmodels, monkeypatch):
    """The fused sequence takes K4 from ``flash_min_seq`` queries up, with
    the [vision ‖ text] key mask; below it ``sdpa``."""
    from llm_quest_tpu_torch.kernels import attention as kattn

    seen = []
    real = kattn.flash_attention

    def spy(q, k, v, *, attn_mask=None, **kw):
        seen.append((q.shape[2], None if attn_mask is None else attn_mask.clone()))
        return real(q, k, v, attn_mask=attn_mask, **kw)

    monkeypatch.setattr(kattn, "flash_attention", spy)
    b = batch_np()
    batch = {"image": T(b["image"]), "input_ids": T(b["input_ids"]).long(), "attention_mask": T(b["attention_mask"])}
    tvit, tgpt, tad = tmodels
    tvlm.vlm_forward_loss(tv, tvit, VIT, tad, tgpt, GPT, batch)
    assert seen == []  # 25 < 256
    tvlm.vlm_forward_loss(tv, tvit, VIT, tad, tgpt, dict(GPT, **FLASH), batch)
    assert len(seen) == GPT["n_layers"] and all(s == NV + S for s, _ in seen)
    expect = torch.cat([torch.ones(B, NV, dtype=torch.bool), T(b["attention_mask"])], dim=1)
    assert all(torch.equal(m, expect) for _, m in seen)


# ------------------------------------------------------------------ generation


def jax_generate(jmodels, images, max_gen, **kw):
    vit_p, gpt_p, adapter = jmodels
    run = jax.jit(lambda vp, a, gp, x: jvlm.vlm_generate(jv, vp, VIT, a, gp, GPT, x, bos_id=1, max_gen=max_gen,
                                                          **kw))
    return np.asarray(run(vit_p, adapter, gpt_p, jnp.asarray(images)))


def test_vlm_generate_matches_jax_with_eos_mid_caption(jmodels, tmodels):
    tvit, tgpt, tad = tmodels
    images = np.random.default_rng(6).normal(size=(3, 3, 32, 32)).astype(np.float32)
    free = jax_generate(jmodels, images, 8, pad_id=PAD)
    got = tvlm.vlm_generate(tv, tvit, VIT, tad, tgpt, GPT, T(images), 1, max_gen=8, pad_id=PAD)
    np.testing.assert_array_equal(got.numpy(), free)
    # an EOS that row 0 emits for the first time at step 2 or later (JAX's tokens without EOS): it finishes
    # mid-caption, and its next steps attend without the EOS column
    step = next(i for i in range(2, 8) if free[0, i] not in free[0, :i])
    eos = int(free[0, step])
    ref = jax_generate(jmodels, images, 8, eos_id=eos, pad_id=PAD)
    got = tvlm.vlm_generate(tv, tvit, VIT, tad, tgpt, GPT, T(images), 1, max_gen=8, eos_id=eos, pad_id=PAD)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0, step] == eos and (ref[0, step + 1:] == PAD).all()
    # JAX's default pad 50256 lies past the 128-token table: JAX's gather clamps it, and so does the port's
    ref = jax_generate(jmodels, images, 8, eos_id=eos)
    got = tvlm.vlm_generate(tv, tvit, VIT, tad, tgpt, GPT, T(images), 1, max_gen=8, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[0, step + 1:] == 50256).all()


# ------------------------------------------------------------------ preprocessing


def test_fold_2d_matches_jax_and_explicit_normalization(jmodels, tmodels):
    mean, std = jdata.CIFAR10_MEAN, jdata.CIFAR10_STD
    ref = jpre.fold_image_normalization(jmodels[0]["patch_emb"], mean, std)
    before = {k: v.detach().clone() for k, v in tmodels[0].patch_emb.items()}
    got = tpre.fold_image_normalization(tmodels[0].patch_emb, mean, std)
    assert set(got) == set(ref)
    for key in ref:
        assert max_err(got[key], ref[key]) <= 1e-5, key
    assert all(torch.equal(tmodels[0].patch_emb[k], v) for k, v in before.items())  # the model is untouched
    u8 = np.random.default_rng(0).integers(0, 255, size=(2, 3, 32, 32)).astype(np.float32)
    normalized = (u8 / 255.0 - mean[None, :, None, None]) / std[None, :, None, None]
    explicit = tv.patch_embedding(tmodels[0].patch_emb, VIT, T(normalized))
    assert max_err(tv.patch_embedding(got, VIT, T(u8)), explicit) <= 1e-4


def test_fold_3d_matches_jax():
    cfg = {"patch_size": 4, "temporal_patch_size": 2, "in_channels": 3, "vision_emb_dim": 16}
    jp = jq.init_patch_embedding_3d(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = tq.PatchEmbedding3D(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for k in ("conv_w", "conv_b"):
            tp[k].copy_(T(jp[k]))
    mean, std = np.asarray([0.5, 0.4, 0.3], np.float32), np.asarray([0.2, 0.25, 0.3], np.float32)
    ref = jpre.fold_image_normalization(jp, mean, std)
    got = tpre.fold_image_normalization(tp, mean, std)
    for key in ("conv_w", "conv_b"):
        assert max_err(got[key], ref[key]) <= 1e-5, key
    u8 = np.random.default_rng(1).integers(0, 255, size=(1, 3, 2, 8, 8)).astype(np.float32)
    normalized = (u8 / 255.0 - mean[None, :, None, None, None]) / std[None, :, None, None, None]
    assert max_err(tq.patch_embedding_3d(got, cfg, T(u8)), tq.patch_embedding_3d(tp, cfg, T(normalized))) <= 1e-4


@pytest.mark.parametrize("shape,size", [((2, 3, 64, 48), (32, 24)), ((1, 3, 64, 48), (40, 30)),
                                        ((2, 3, 16, 12), (32, 24))], ids=["down2", "down_odd", "up2"])
def test_resize_bilinear_matches_jax(shape, size):
    """JAX's bilinear resize antialiases when it downsamples; the port's does too."""
    x = np.random.default_rng(2).integers(0, 256, size=shape).astype(np.float32)
    ref = jpre.resize_bilinear(jnp.asarray(x), *size)
    got = tpre.resize_bilinear(T(x), *size)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(ref.shape)
    assert max_err(got, ref) <= 1e-3
    assert torch.allclose(tpre.resize_bilinear(torch.ones(1, 3, 8, 8), 16, 16), torch.ones(1, 3, 16, 16))


def test_uint8_encoder_matches_jax_and_leaves_the_model(jmodels, tmodels):
    mean, std = jdata.IMAGENET_MEAN, jdata.IMAGENET_STD
    u8 = np.random.default_rng(3).integers(0, 256, size=(2, 3, 48, 40)).astype(np.uint8)
    ref = jpre.make_uint8_encoder(jv, jmodels[0], VIT, mean, std, resize_to=(32, 32))(jnp.asarray(u8))
    conv_w = tmodels[0].patch_emb["conv_w"].detach().clone()
    encode = tpre.make_uint8_encoder(tv, tmodels[0], VIT, mean, std, resize_to=(32, 32))
    got = encode(T(u8))
    assert tuple(got.shape) == (2, NV, VIT["emb_dim"]) and max_err(got, ref) <= 1e-4
    assert torch.equal(tmodels[0].patch_emb["conv_w"], conv_w)
    # the encoder's ViT has a patch embedding of its own and shares the rest with the model
    (folded,) = [c.cell_contents for c in encode.__closure__ if isinstance(c.cell_contents, tv.ViT)]
    assert folded.patch_emb is not tmodels[0].patch_emb and folded.blocks is tmodels[0].blocks
    assert folded.pos_emb is tmodels[0].pos_emb and folded.final_ln is tmodels[0].final_ln
    # resize, then normalize, then encode
    x = tpre.resize_bilinear(T(u8).float(), 32, 32) / 255.0
    normalized = (x - T(mean)[None, :, None, None]) / T(std)[None, :, None, None]
    assert max_err(got, tv.apply(tmodels[0], VIT, normalized, output_hidden_states=True)) <= 1e-4


def test_multimodal_batches_match_jax():
    rng = np.random.default_rng(4)
    images = rng.integers(0, 255, size=(10, 16, 16, 3), dtype=np.uint8)
    captions = [f"caption {i} " * (i % 3 + 1) for i in range(10)]
    tok = tscript.ByteTok()
    for kw in ({}, {"max_caption_len": 12, "pad_token_id": 7}):
        ref = jdata.multimodal_batches(images, captions, tok, 4, **kw)
        got = tdata.multimodal_batches(images, captions, tok, 4, **kw)
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert set(g) == set(r)
            for key in r:
                assert g[key].dtype == r[key].dtype
                np.testing.assert_array_equal(g[key], r[key])
    np.testing.assert_array_equal(tdata.IMAGENET_MEAN, jdata.IMAGENET_MEAN)
    np.testing.assert_array_equal(tdata.IMAGENET_STD, jdata.IMAGENET_STD)


# ------------------------------------------------------------------ the script, the weights


# GPT_SMALL_CONFIG's vocabulary (the batches pad with 50256) and its unbiased q/k/v
SCRIPT_GPT = dict(GPT, vocab_size=50304, qkv_bias=False)


def test_script_step_matches_jax(jmodels):
    """One step of the port's ``scripts/vlm_training.py`` loop (adamw(1e-4)
    over the adapter and GPT-2) against JAX's script step on the same batch."""
    batch = tscript.synthetic_batches()[0]
    vit_p, _, adapter = jmodels
    gpt_p = to_jax(tg.init(SCRIPT_GPT, generator=gen(1), device="cpu"),
                   lambda: jg.init(jax.random.PRNGKey(1), SCRIPT_GPT))
    optimizer = optax.adamw(tscript.LR)
    opt_state = optimizer.init((adapter, gpt_p))

    def loss_fn(trainable):
        return jvlm.vlm_forward_loss(jv, vit_p, VIT, *trainable, SCRIPT_GPT, {k: jnp.asarray(v) for k, v in
                                                                          batch.items()})

    @jax.jit
    def jax_step(trainable, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(trainable)
        updates, _ = optimizer.update(grads, opt_state, trainable)
        return loss, optax.apply_updates(trainable, updates)

    ref_loss, (new_adapter, new_gpt) = jax_step((adapter, gpt_p), opt_state)

    tvit = from_jax_flat(flat(vit_p), VIT, device="cpu")
    tgpt = from_jax_flat(flat(gpt_p), SCRIPT_GPT, device="cpu")
    tad = from_jax_flat(flat(adapter), {}, device="cpu")
    opt = tscript.adamw(tscript.LR)
    state = opt.init([*tad.parameters(), *tgpt.parameters()])
    step = tscript.make_train_step(tvit, VIT, SCRIPT_GPT, opt)
    _, _, _, loss = step(tad, tgpt, state, {k: T(v) if v.dtype != np.int32 else T(v).long() for k, v in batch.items()})
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for model, jnew in ((tad, new_adapter), (tgpt, new_gpt)):
        jflat = flat(jnew)
        for name, p in model.named_parameters():
            r = jflat[name.replace(".", "/")]
            tol = 1e-5 * float(np.abs(r).max()) + 0.01 * tscript.LR
            assert max_err(jax_layout(model, name, p), r) <= tol, name


def test_jax_vlm_trees_cross_over(jmodels, tmodels):
    tvit, tgpt, tad = tmodels
    assert isinstance(tvit, tv.ViT) and isinstance(tgpt, tg.GPT2) and isinstance(tad, tvlm.ViTAdapter)
    for model, jtree in zip(tmodels, jmodels):
        jflat = flat(jtree)
        state = model.state_dict()
        assert {n.replace(".", "/") for n in state} == set(jflat)
        for name, t in state.items():
            np.testing.assert_array_equal(arr(jax_layout(model, name, t)), np.asarray(jflat[name.replace(".", "/")],
                                                                                      np.float64))
    bf16 = {k: np.asarray(v, jnp.bfloat16) for k, v in flat(jmodels[2]).items()}
    assert from_jax_flat(bf16, {}, device="cpu").fc.w.dtype == torch.bfloat16
