"""The ported Qwen3.5 slice against the JAX package, end to end, on the CPU.

A tiny config (4 text layers: GDN, attention, GDN, attention; 2 vision
layers; a 16 px image) is initialised in JAX, flattened, loaded into the port
with ``from_jax_flat`` and run through both packages in fp32: logits must
agree within 1e-4 and greedy tokens must be identical, text-only and with an
image, through ``apply``, ``generate_multimodal`` and the batched decode
engine with left and right padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import qwen3_5 as jq
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.models import qwen3_5 as tq
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TOL = 1e-4

TINY = {
    # text
    "vocab_size": 256,
    "emb_dim": 32,
    "hidden_dim": 64,
    "n_layers": 4,
    "linear_sdpa_ratio": 2,  # GDN, ATTN, GDN, ATTN
    "n_heads": 4,
    "num_kv_groups": 2,
    "head_dim": 16,
    "rope_base": 10_000_000,
    "partial_rope_factor": 0.25,
    "context_length": 128,
    "linear_num_qk_heads": 2,
    "linear_num_value_heads": 4,  # value heads repeat the q/k heads
    "linear_qk_head_dim": 8,
    "linear_value_head_dim": 8,
    "linear_conv_kernel_size": 4,
    "tie_embeddings": True,
    "mrope_section": [1, 1, 0],
    # vision
    "vision_n_layers": 2,
    "vision_emb_dim": 24,
    "vision_hidden_dim": 48,
    "vision_num_heads": 2,
    "llm_d_in": 32,
    "in_channels": 3,
    "patch_size": 4,
    "spatial_merge_size": 2,
    "temporal_patch_size": 2,
    "num_position_embeddings": 64,
    "img_width": 16,
    "img_height": 16,
    "vision_rope_base": 10_000,
    "image_token_id": 200,
}
JCFG = dict(TINY, dtype=jnp.float32)
TCFG = dict(TINY, dtype=torch.float32)
IDS = np.asarray([[1, 2, 200, 200, 200, 200, 3]], np.int32)  # 4 merged vision tokens


class JaxText:
    apply = staticmethod(jq.apply_text)
    init_cache = staticmethod(jq.init_cache)


@pytest.fixture(scope="module")
def models():
    params = jq.init(jax.random.PRNGKey(0), JCFG)
    model = from_jax_flat({k: np.asarray(v) for k, v in flatten_params(params).items()}, TCFG)
    pixels = np.random.default_rng(1).standard_normal((1, 3, 2, 16, 16)).astype(np.float32)
    return params, model, pixels


def assert_close(got, ref, tol=TOL):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max())
    assert err <= tol, err


@pytest.mark.parametrize("with_image", [False, True])
def test_apply_logits_match(models, with_image):
    params, model, pixels = models
    px = pixels if with_image else None
    ref, _, _ = jq.apply(params, JCFG, jnp.asarray(IDS), image_pixels=None if px is None else jnp.asarray(px))
    tpx = None if px is None else torch.from_numpy(px)
    got, _, _ = tq.apply(model, TCFG, torch.from_numpy(IDS).long(), image_pixels=tpx)
    assert got.shape == ref.shape
    assert_close(got, ref)


@pytest.mark.parametrize("with_image", [False, True])
def test_generate_multimodal_tokens_match(models, with_image):
    params, model, pixels = models
    px = pixels if with_image else None
    ref = jq.generate_multimodal(
        params, JCFG, jnp.asarray(IDS), None if px is None else jnp.asarray(px),
        max_gen=6, temp=0.0, eos_ids=-1, pad_id=0,
    )
    got = tq.generate_multimodal(
        model, TCFG, torch.from_numpy(IDS).long(), None if px is None else torch.from_numpy(px),
        max_gen=6, eos_ids=-1, pad_id=0,
    )
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()


def test_prefill_cache_states_match(models):
    """After a cached multimodal prefill, the KV, conv and (dv, dk) recurrent
    states compare directly."""
    params, model, pixels = models
    s, max_len = IDS.shape[1], IDS.shape[1] + 3
    mask = np.zeros((1, max_len), bool)
    mask[:, :s] = True
    _, jc, _ = jq.apply(params, JCFG, jnp.asarray(IDS), image_pixels=jnp.asarray(pixels),
                        attn_mask=jnp.asarray(mask), cache=jq.init_cache(JCFG, 1, max_len))
    _, tc, _ = tq.apply(model, TCFG, torch.from_numpy(IDS).long(), image_pixels=torch.from_numpy(pixels),
                        attn_mask=torch.from_numpy(mask), cache=tq.init_cache(TCFG, 1, max_len))
    assert tc["pos"] == int(jc["pos"]) == s
    for name in ("k", "v", "conv", "recurrent"):
        assert tc[name].shape == jc[name].shape, name
        assert_close(tc[name], jc[name])


@pytest.mark.parametrize("left_pad", [True, False])
def test_batched_decode_engine_matches(models, left_pad):
    """Padded batch through the decode engine, with an EOS that finishes one
    row early: sequences (pad after EOS) and the validity mask match."""
    params, model, _ = models
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 199, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), bool)
    if left_pad:
        mask[1, :3] = False
    else:
        mask[1, 6:] = False
    ids[~mask] = 0

    def run_jax(eos):
        out = jgen.generate_batched_kv_cache(
            JaxText, params["text"], JCFG, jnp.asarray(ids), jnp.asarray(mask), max_gen=6, temp=0.0,
            eos_ids=eos, pad_id=0, left_pad=left_pad,
        )
        return np.asarray(out["sequences"]), np.asarray(out["mask"])

    def run_torch(eos):
        out = tgen.generate_batched_kv_cache(
            tq.TextOnly, model.text, TCFG, torch.from_numpy(ids).long(), torch.from_numpy(mask), max_gen=6,
            eos_ids=eos, pad_id=0, left_pad=left_pad,
        )
        return out["sequences"].numpy(), out["mask"].numpy()

    seq, _ = run_jax(-1)
    eos = int(seq[0, 9 + 2])  # row 0 stops at its third generated token
    for (a_seq, a_mask), (b_seq, b_mask) in ((run_torch(-1), run_jax(-1)), (run_torch(eos), run_jax(eos))):
        assert a_seq.tolist() == b_seq.tolist()
        assert a_mask.tolist() == b_mask.tolist()


def test_generate_kv_cache_flash_prefill_matches(models):
    """Unpadded text decode with the cached prefill routed through the flash
    wrapper (flash_min_seq lowered to the prompt length) against JAX's sdpa."""
    params, model, _ = models
    ids = np.random.default_rng(4).integers(0, 256, (2, 20)).astype(np.int32)
    ref = jgen.generate_kv_cache(
        JaxText, params["text"], JCFG, jnp.asarray(ids), max_gen=5, temp=0.0, eos_ids=-1, pad_id=0
    )
    got = tgen.generate_kv_cache(
        tq.TextOnly, model.text, dict(TCFG, flash_min_seq=16), torch.from_numpy(ids).long(),
        max_gen=5, eos_ids=-1, pad_id=0,
    )
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()


def test_from_jax_flat_checks_names_and_shapes(models):
    params, _, _ = models
    flat = {k: np.asarray(v) for k, v in flatten_params(params["text"]).items()}
    assert isinstance(from_jax_flat(flat, TCFG), tq.TextModel)
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat({k: v for k, v in flat.items() if k != "final_norm/scale"}, TCFG)
    bad = dict(flat, **{"blocks/0/att/w_qkv/w": flat["blocks/0/att/w_qkv/w"].T})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(bad, TCFG)


def test_torch_init_matches_jax_init_layout_and_ranges():
    """``init`` from a torch.Generator gives the JAX init's shapes, dtypes and
    distributions' supports."""
    model = tq.init(TCFG, generator=torch.Generator().manual_seed(0))
    jflat = flatten_params(jq.init(jax.random.PRNGKey(0), JCFG))
    state = model.state_dict()
    assert set(state) == {k.replace("/", ".") for k in jflat}
    for name, arr in jflat.items():
        t = state[name.replace("/", ".")]
        assert sorted(t.shape) == sorted(arr.shape), name
        assert str(t.dtype).removeprefix("torch.") == str(arr.dtype), name
    text = model.text
    att = text.blocks[0].att
    assert torch.all(text.final_norm["scale"] == 0) and torch.all(att.post_norm["scale"] == 1)
    assert torch.all(att.log_A < np.log(16.0)) and torch.all(att.dt_bias == 1)
    bound = (6.0 / (TINY["vocab_size"] + TINY["emb_dim"])) ** 0.5
    assert float(text.tok_emb["w"].abs().max()) <= bound
    assert float(att.w_qkv.w.abs().max()) <= TINY["emb_dim"] ** -0.5
    assert float(model.vision.pos_embed["w"].std()) == pytest.approx(1.0, abs=0.15)
