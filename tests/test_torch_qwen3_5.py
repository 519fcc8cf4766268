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
    model = from_jax_flat({k: np.asarray(v) for k, v in flatten_params(params).items()}, TCFG, device="cpu")
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
                        attn_mask=torch.from_numpy(mask), cache=tq.init_cache(TCFG, 1, max_len, device="cpu"))
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
    assert isinstance(from_jax_flat(flat, TCFG, device="cpu"), tq.TextModel)
    with pytest.raises(ValueError, match="missing"):
        from_jax_flat({k: v for k, v in flat.items() if k != "final_norm/scale"}, TCFG, device="cpu")
    bad = dict(flat, **{"blocks/0/att/w_qkv/w": flat["blocks/0/att/w_qkv/w"].T})
    with pytest.raises(ValueError, match="shape"):
        from_jax_flat(bad, TCFG, device="cpu")


def test_torch_init_matches_jax_init_layout_and_ranges():
    """``init`` from a torch.Generator gives the JAX init's shapes, dtypes and
    distributions' supports."""
    model = tq.init(TCFG, generator=torch.Generator().manual_seed(0), device="cpu")
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


# ------------------------------------------------------------------ int8 serving
#
# A tiny text model at head dim 128 (so that JAX's router takes K10 at every
# decode step), quantized by JAX's ``quantize_params_int8`` with the int8
# tied table, loaded into the port, both asking for the int8 KV cache. JAX's
# rule gathers an int8 table's rows in bf16 (a bf16 serving transform), so in
# an fp32 model the first blocks then run on a bf16 stream in both packages,
# where XLA's bf16 logistic and torch's differ by one bf16 unit (measured:
# sigmoid and silu of the same bf16 inputs). The fp32 bar therefore holds
# with the rows gathered in fp32 in both packages (``inputs_embs``), the int8
# table still read by the tied head; the default bf16 rows are held to a
# bf16 bar; greedy tokens are compared with the fp table.

INT8 = dict(TINY, head_dim=128, mrope_section=[6, 5, 5])


def int8_text(quantize_embeddings):
    from llm_quest_tpu.ops.quantization import quantize_params_int8

    params = quantize_params_int8(jq.init_text(jax.random.PRNGKey(2), dict(INT8, dtype=jnp.float32)),
                                  min_size=0, quantize_embeddings=quantize_embeddings)
    jcfg = dict(INT8, dtype=jnp.float32, kv_quant="int8")
    tcfg = dict(INT8, dtype=torch.float32, kv_quant="int8")
    model = from_jax_flat({k: np.asarray(v) for k, v in flatten_params(params).items()}, tcfg, device="cpu")
    return params, jcfg, model, tcfg


def _int8_steps(quantize_embeddings, rows_dtype):
    """Prefill 9 tokens into the int8 cache (dequantized attention in both),
    then two decode steps (K10's plain version against the Pallas kernel in
    interpret mode); yields (port logits, JAX logits) of each call."""
    from llm_quest_tpu.ops.linear import embedding as jembedding
    from llm_quest_tpu_torch.ops.linear import embedding as tembedding

    params, jcfg, model, tcfg = int8_text(quantize_embeddings)
    ids = np.random.default_rng(5).integers(0, 256, (2, 9)).astype(np.int32)
    jc, tc = jq.init_cache(jcfg, 2, 12), tq.init_cache(tcfg, 2, 12, device="cpu")
    assert tc["k_q"].dtype == torch.int8 and tc["k_q"].shape == jc["k_q"].shape
    for _ in range(3):
        je = jembedding(params["tok_emb"], jnp.asarray(ids), dtype=None if rows_dtype is None else jnp.float32)
        te = tembedding(model.tok_emb, torch.from_numpy(np.array(ids)).long(), dtype=rows_dtype)
        assert np.array_equal(np.asarray(je, np.float32), te.float().numpy())
        jl, jc, _ = jq.apply_text(params, jcfg, inputs_embs=je, cache=jc)
        tl, tc, _ = tq.apply_text(model, tcfg, inputs_embs=te, cache=tc)
        yield tl, jl
        ids = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_int8_text_prefill_and_decode_logits_match():
    """int8 linears, int8 tied table and int8 KV cache, fp32 rows: within 1e-4."""
    for tl, jl in _int8_steps(True, torch.float32):
        assert_close(tl, jl)


def test_int8_text_bf16_rows_match_at_bf16_precision():
    """The default gather (bf16 rows, the same bits in both packages) puts a
    bf16 stream through the first blocks: logits within 5e-2 × max |ref|
    (bf16's unit is 2⁻⁸ ≈ 3.9e-3, and one-unit differences of XLA's and
    torch's bf16 sigmoid/silu grow through 4 blocks; measured 2.9e-2)."""
    for tl, jl in _int8_steps(True, None):
        assert_close(tl, jl, tol=5e-2 * float(np.abs(np.asarray(jl)).max()))


def test_int8_text_generate_tokens_match():
    """int8 linears and the int8 KV cache (K10 at every step), fp32 table:
    identical greedy tokens."""
    params, jcfg, model, tcfg = int8_text(False)
    ids = np.random.default_rng(6).integers(0, 256, (2, 12)).astype(np.int32)
    ref = jgen.generate_kv_cache(JaxText, params, jcfg, jnp.asarray(ids), max_gen=6, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq.TextOnly, model, tcfg, torch.from_numpy(ids).long(), max_gen=6, eos_ids=-1,
                                 pad_id=0)
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()
