"""The ported int4 quantization and the mask helpers against the JAX
package, on the CPU.

Inputs come from numpy with a seed and go through both packages in fp32.
JAX keeps int4 values one a byte (ml_dtypes ``int4``); the port packs them
two a byte along the contraction axis (``ops/quantization.py::pack_int4``).
Tolerances:

- int4 values equal to JAX's once unpacked, at even and odd widths, and
  scales within 1e-7 relative (the same fp32 divide and round-half-to-even);
  the packing rule checked byte by byte;
- ``linear`` (per channel and ``block_size``, also the int8 block path),
  ``embedding``, ``tied_head`` and K11's plain version within 1e-5 of JAX
  (fp32 products summed in another order; the block path multiplies the
  scales into the weight before one product where JAX sums fp32 block
  partials against them);
- the block path's allocations: one copy of the weight in x's dtype beside
  the output (and the scales in x's dtype), counted by a dispatch mode;
- whole models: the walk selects JAX's leaves, ``from_jax_flat`` of a JAX
  int4 tree equals the port's own quantization bit for bit, fp32 logits
  within 1e-4 and greedy tokens (``generate_kv_cache``) identical for
  Qwen3.5 text and Qwen3-MoE; byte counts exact at even widths;
- the mask helpers equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.models import qwen3_5 as jq35
from llm_quest_tpu.ops import linear as jlinear
from llm_quest_tpu.ops import masks as jmasks
from llm_quest_tpu.ops import moe as jmoe
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.training import flops as jflops
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.kernels import quantized_gmm as kqg
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_5 as tq35
from llm_quest_tpu_torch.ops import int4 as tint4
from llm_quest_tpu_torch.ops import linear as tlinear
from llm_quest_tpu_torch.ops import masks as tmasks
from llm_quest_tpu_torch.ops import quantization as tquant
from llm_quest_tpu_torch.training import flops as tflops
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TOL = 1e-5
MODEL_TOL = 1e-4

TEXT = {
    "vocab_size": 256, "emb_dim": 32, "hidden_dim": 64, "n_layers": 4, "linear_sdpa_ratio": 2,
    "n_heads": 4, "num_kv_groups": 2, "head_dim": 16, "rope_base": 10_000_000, "partial_rope_factor": 0.25,
    "context_length": 64, "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8,
    "linear_value_head_dim": 8, "linear_conv_kernel_size": 4, "tie_embeddings": True, "mrope_section": [1, 1, 0],
}
MOE = {
    "model_type": "moe", "vocab_size": 128, "context_length": 64, "emb_dim": 32, "n_layers": 2, "n_heads": 4,
    "num_kv_groups": 2, "head_dim": 8, "moe_hidden_dim": 64, "num_experts": 4, "top_k": 2,
    "aux_loss_coef": 0.001, "rope_base": 10_000, "tie_embeddings": False,
}
# JAX pairs int4 with block scales; 16 divides every contraction width of both tiny models
INT4_OPTIONS = [
    {"bits": 4, "min_size": 0},
    {"bits": 4, "min_size": 0, "block_size": 16, "quantize_embeddings": True},
    {"bits": 4, "quantize_experts": False, "min_size": 1024},
]


class JaxText:
    apply = staticmethod(jq35.apply_text)
    init_cache = staticmethod(jq35.init_cache)


def rng(seed):
    return np.random.default_rng(seed)


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def ints(a):
    """A JAX int4 (or int8) array's values as numpy int8."""
    return np.asarray(a).astype(np.int8)


def assert_scales(got, ref):
    ref = np.asarray(ref, np.float64)
    err = np.abs(got.numpy().astype(np.float64) - ref).max() / np.abs(ref).max()
    assert got.shape == ref.shape and err <= 1e-7, err


def max_err(got, ref):
    return float(np.abs(got.detach().float().numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


# ------------------------------------------------------------------ packing


@pytest.mark.parametrize("width", [12, 13])
def test_pack_rule_byte_by_byte(width):
    """Element 2i in the low nibble, 2i + 1 in the high one, two's
    complement; an odd width's last byte has a zero high nibble. Unpacking
    gives the values back in int8 and in every float type, along any dim."""
    q = T(rng(0).integers(-8, 8, (3, width)).astype(np.int8))
    packed = tint4.pack_int4(q)
    assert packed.dtype == torch.uint8 and packed.shape == (3, (width + 1) // 2)
    v = q.numpy().astype(np.int64) & 0xF
    if width % 2:
        v = np.pad(v, ((0, 0), (0, 1)))
    assert np.array_equal(packed.numpy(), (v[:, 0::2] | (v[:, 1::2] << 4)).astype(np.uint8))
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        assert torch.equal(tint4.unpack_int4(packed, width, dtype=dtype), q.to(dtype))
    stack = T(rng(1).integers(-8, 8, (2, width, 5)).astype(np.int8))
    assert torch.equal(tint4.unpack_int4(tint4.pack_int4(stack, dim=1), width, dim=1), stack)


def test_every_byte_unpacks_and_the_unpack_probe_agrees():
    """All 256 bytes unpack to their two signed nibbles in bf16 and fp32;
    ``tools/int4_unpack_probe.py``'s earlier 7-pass form gives the same
    values, and the probe refuses to run without the card."""
    from tools import int4_unpack_probe

    every = torch.arange(256).to(torch.uint8)[None]
    nibbles = torch.stack((every.long() & 0xF, every.long() >> 4), -1).flatten(-2)
    signed = torch.where(nibbles >= 8, nibbles - 16, nibbles)
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(tint4.unpack_int4(every, 512, dtype=dtype), signed.to(dtype))
        assert torch.equal(int4_unpack_probe.unpack_seven_passes(every, 512, dtype), signed.to(dtype))
    with pytest.raises(SystemExit, match="no CUDA device"):
        int4_unpack_probe.main()


@pytest.mark.parametrize("d_in,block_size", [(32, None), (12, None), (13, None), (32, 4), (12, 4)])
def test_quantize_linear_int4_matches_jax(d_in, block_size):
    w = rng(2).standard_normal((d_in, 24)).astype(np.float32)  # JAX (in, out)
    b = rng(3).standard_normal(24).astype(np.float32)
    x = rng(4).standard_normal((3, 5, d_in)).astype(np.float32)
    jp = jquant.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)}, block_size=block_size, bits=4)
    tp = tquant.quantize_linear_int8({"w": T(w.T), "b": T(b)}, block_size=block_size, bits=4)
    assert tp["w_q"].dtype == torch.uint8 and tp["w_q"].shape == (24, (d_in + 1) // 2)
    assert np.array_equal(tint4.unpack_int4(tp["w_q"], d_in).numpy().T, ints(jp["w_q"]))
    assert np.abs(ints(jp["w_q"])).max() == 7
    assert_scales(tp["w_scale"], jp["w_scale"])
    assert max_err(tquant.dequantize_int8(tp["w_q"], tp["w_scale"], d_in).T,
                   jquant.dequantize_int8(jp["w_q"], jp["w_scale"])) <= 1e-7
    layer = tquant.QuantLinear(tp["w_q"], tp["w_scale"], tp["b"], d_in=d_in)
    assert tint4.is_int4(layer.w_q) and layer.d_in == d_in
    assert max_err(layer(T(x)), jlinear.linear(jp, jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("bits", [8, 4])
def test_block_matmul_matches_jax_blocked_einsum(bits):
    """The block path multiplies the (nb, out) scales into one copy of the
    weight, then takes one product; JAX sums fp32 block partials against
    the scales (its blocked einsum): within 1e-5 in fp32."""
    w = rng(5).standard_normal((64, 40)).astype(np.float32)
    x = rng(6).standard_normal((7, 64)).astype(np.float32)
    jp = jquant.quantize_linear_int8({"w": jnp.asarray(w)}, block_size=16, bits=bits)
    tp = tquant.quantize_linear_int8({"w": T(w.T)}, block_size=16, bits=bits)
    got = tquant.int8_matmul(T(x), tp["w_q"], tp["w_scale"])
    assert max_err(got, jquant.int8_matmul(jnp.asarray(x), jp["w_q"], jp["w_scale"])) <= TOL


class Allocations(TorchDispatchMode):
    """Bytes of every storage an op creates (views and in-place ops create none)."""

    def __init__(self):
        super().__init__()
        self.new = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        seen = {a.untyped_storage().data_ptr() for a in jax.tree.leaves((args, kwargs or {}))
                if isinstance(a, torch.Tensor)}
        out = func(*args, **(kwargs or {}))
        for t in jax.tree.leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen:
                seen.add(t.untyped_storage().data_ptr())
                self.new.append((str(func), t.untyped_storage().nbytes()))
        return out


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_matmul_transient_memory_is_one_weight_copy(bits, dtype):
    """What ``int8_matmul`` allocates on the block path, beyond its output:
    the weight in x's dtype and the (nb, out) scales in x's dtype, nothing
    else (no fp32 (rows, nb, out) partials, no fp32 weight)."""
    d_out, d_in, bs, rows = 96, 128, 32, 5
    w = torch.randn(d_out, d_in, generator=torch.Generator().manual_seed(7))
    q = tquant.quantize_linear_int8({"w": w}, block_size=bs, bits=bits)
    x = torch.randn(rows, d_in, generator=torch.Generator().manual_seed(8)).to(dtype)
    with Allocations() as mode:
        y = tquant.int8_matmul(x, q["w_q"], q["w_scale"])
    size = dtype.itemsize
    transient = sum(n for _, n in mode.new) - y.untyped_storage().nbytes()
    assert transient <= d_out * d_in * size + (d_in // bs) * d_out * size, mode.new


@pytest.mark.parametrize("emb", [16, 15])
def test_embedding_and_tied_head_int4_match_jax(emb):
    w = rng(9).standard_normal((40, emb)).astype(np.float32)
    ids = rng(10).integers(0, 40, (2, 7))
    h = rng(11).standard_normal((2, 7, emb)).astype(np.float32)
    jp = jquant.quantize_embedding_int8({"w": jnp.asarray(w)}, bits=4)
    tp = tquant.quantize_embedding_int8({"w": T(w)}, bits=4)
    assert np.array_equal(tint4.unpack_int4(tp["w_q"], emb).numpy(), ints(jp["w_q"]))
    assert_scales(tp["w_scale"], jp["w_scale"])
    table = tquant.quantized_group(emb, **tp)
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        got = tlinear.embedding(table, T(ids), dtype=dtype)
        ref = jlinear.embedding(jp, jnp.asarray(ids), dtype=jdtype)
        assert got.dtype == (dtype or torch.bfloat16) and got.shape == (2, 7, emb)
        assert max_err(got, np.asarray(ref, np.float32)) <= TOL
    assert max_err(tlinear.tied_head(table, T(h)), jlinear.tied_head(jp, jnp.asarray(h))) <= TOL


@pytest.mark.parametrize("d", [16, 15])
def test_expert_stack_int4_and_k11_plain_match_jax(d):
    """Stack values and scales against JAX's; K11's plain version over the
    packed stack against JAX's fallback for int4 (``ragged_dot`` on the
    converted stack, the row scales after)."""
    experts = {"lin1": rng(12).standard_normal((3, d, 12)).astype(np.float32),
               "lin2": rng(13).standard_normal((3, 12, d)).astype(np.float32),
               "b1": rng(14).standard_normal((3, 12)).astype(np.float32)}
    jp = jquant.quantize_expert_stack_int8({k: jnp.asarray(v) for k, v in experts.items()}, bits=4)
    tp = tquant.quantize_expert_stack_int8({k: T(v) for k, v in experts.items()}, bits=4)
    assert set(tp) == set(jp) and torch.equal(tp["b1"], T(experts["b1"]))
    for name, width in (("lin1", d), ("lin2", 12)):
        assert tp[name + "_q"].shape == (3, (width + 1) // 2, experts[name].shape[2])
        assert np.array_equal(tint4.unpack_int4(tp[name + "_q"], width, dim=1).numpy(), ints(jp[name + "_q"]))
        assert_scales(tp[name + "_scale"], jp[name + "_scale"])
    sizes = np.asarray([4, 0, 5], np.int32)
    x = rng(15).standard_normal((9, d)).astype(np.float32)
    expert_of_row = jnp.asarray(np.repeat(np.arange(3), sizes))
    ref = jmoe._ragged(jp, "lin1", jnp.asarray(x), jnp.asarray(sizes), expert_of_row)
    got = kqg.quantized_ragged_dot(T(x), tp["lin1_q"], tp["lin1_scale"], T(sizes).long())
    assert max_err(got, ref) <= TOL


@pytest.mark.parametrize("d_in", [24, 23])
def test_lora_over_an_int4_linear_matches_jax(d_in):
    """A LoRA adapter over an int4 ``QuantLinear`` (its logical in-width,
    also odd): classic LoRA's factor shapes and LoRA-XS's SVD init from the
    dequantized weight equal JAX's ``_dense_weight`` of the int4 linear, and
    the wrapped layer's output within 1e-5 of JAX's ``linear`` with the
    adapter."""
    from llm_quest_tpu.ops import lora as jlora
    from llm_quest_tpu_torch.ops import lora as tlora

    w = rng(22).standard_normal((d_in, 16)).astype(np.float32)
    jp = jquant.quantize_linear_int8({"w": jnp.asarray(w)}, bits=4)
    tp = tquant.quantize_linear_int8({"w": T(w.T)}, bits=4)
    layer = tquant.QuantLinear(tp["w_q"], tp["w_scale"], d_in=d_in)
    assert max_err(tlora._dense_weight(layer), jlora._dense_weight(jp)) <= 1e-7
    classic = tlora.init_lora(torch.Generator().manual_seed(0), layer, 4, 8.0)
    assert classic["A"].shape == (d_in, 4) and classic["B"].shape == (4, 16)
    xs = tlora.init_lora_xs(torch.Generator().manual_seed(0), layer, 4, 8.0)
    layer.lora = xs
    jp = dict(jp, lora={k: jnp.asarray(xs[k].detach().numpy()) for k in xs.keys()})
    x = rng(23).standard_normal((3, d_in)).astype(np.float32)
    assert max_err(layer(T(x)), jlinear.linear(jp, jnp.asarray(x))) <= TOL


# ------------------------------------------------------------------ whole models


@pytest.fixture(scope="module")
def trees():
    text = jq35.init_text(jax.random.PRNGKey(1), dict(TEXT, dtype=jnp.float32))
    moe = jq3.init(jax.random.PRNGKey(2), dict(MOE, dtype=jnp.float32))
    return {"text": (text, TEXT), "moe": (moe, MOE)}


@pytest.mark.parametrize("options", INT4_OPTIONS, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
@pytest.mark.parametrize("which", ["text", "moe"])
def test_int4_walk_selects_jax_leaves_and_from_jax_flat_equals_it(trees, which, options):
    """The walk packs exactly the leaves JAX quantizes to int4, and the JAX
    int4 tree loaded by ``from_jax_flat`` equals the port's own quantization
    of the fp model, leaf for leaf and bit for bit (the recorded widths too)."""
    jparams, cfg = trees[which]
    cfg = dict(cfg, dtype=torch.float32)
    jq = jquant.quantize_params_int8(jparams, **options)
    jflat = flat(jq)
    mine = tquant.quantize_params_int8(from_jax_flat(flat(jparams), cfg, device="cpu"), **options)
    state = mine.state_dict()
    assert set(state) == {k.replace("/", ".") for k in jflat}
    for name, t in state.items():
        leaf = jflat[name.replace(".", "/")]
        assert (t.dtype == torch.uint8) == (leaf.dtype.name == "int4"), name
    loaded = from_jax_flat(jflat, cfg, device="cpu")
    for name, t in loaded.state_dict().items():
        assert t.dtype == state[name].dtype and torch.equal(t, state[name]), name
    for (name, a), b in zip(mine.named_modules(), loaded.modules()):
        assert (getattr(a, "bits", 8), getattr(a, "widths", None), getattr(a, "d_in", None)) == (
            getattr(b, "bits", 8), getattr(b, "widths", None), getattr(b, "d_in", None)), name
    assert any(t.dtype == torch.uint8 for t in state.values())
    fp = from_jax_flat(flat(jparams), cfg, device="cpu")
    assert tquant.quantized_byte_fraction(mine, fp) == pytest.approx(jquant.quantized_byte_fraction(jq, jparams),
                                                                     rel=1e-12)
    assert tflops.param_bytes(mine) == sum(jquant._leaf_bytes(x) for x in jax.tree.leaves(jq))


def test_int4_decode_bytes_count_packed_weights(trees):
    """``decode_bytes_per_token`` counts int4 weights packed, half a byte an
    element, as JAX's ``quantized_byte_fraction`` does. Divergence by
    design: JAX's ``decode_bytes_per_token`` takes ml_dtypes' itemsize, one
    byte an int4 element, twice what XLA streams; the port's count is JAX's
    less half a byte for each int4 element."""
    jparams, cfg = trees["moe"]
    jq = jquant.quantize_params_int8(jparams, bits=4, min_size=0)
    model = from_jax_flat(flat(jq), dict(cfg, dtype=torch.float32), device="cpu")
    got = tflops.decode_bytes_per_token(model, dict(cfg, dtype=torch.bfloat16), kv_len=50, batch=2)
    ref = jflops.decode_bytes_per_token(jq, dict(cfg, dtype=jnp.bfloat16), kv_len=50, batch=2)
    packed = sum(t.numel() for t in model.state_dict().values() if t.dtype == torch.uint8)
    unpacked = sum(np.size(v) for v in flat(jq).values() if v.dtype.name == "int4")
    assert 2 * packed == unpacked and packed % 2 == 0
    assert got == ref - packed // 2  # the batch of 2 shares one weight pass


@pytest.fixture(scope="module")
def int4_text():
    """Qwen3.5 text with int4 linears and the int4 tied table (block scales
    of 16), JAX's tree loaded into the port."""
    jp = jquant.quantize_params_int8(jq35.init_text(jax.random.PRNGKey(3), dict(TEXT, dtype=jnp.float32)),
                                     bits=4, block_size=16, min_size=0, quantize_embeddings=True)
    model = from_jax_flat(flat(jp), dict(TEXT, dtype=torch.float32), device="cpu")
    return jp, model


def test_int4_qwen3_5_cached_logits_match_jax(int4_text):
    """A cached prefill and two decode steps, the rows gathered in fp32 in
    both packages (JAX's rule gathers a quantized table in bf16; see
    tests/test_torch_qwen3_5.py's int8 cases), the int4 table read by the
    tied head: logits within 1e-4."""
    from llm_quest_tpu.ops.linear import embedding as jembedding

    jp, model = int4_text
    jcfg, tcfg = dict(TEXT, dtype=jnp.float32), dict(TEXT, dtype=torch.float32)
    apply = jax.jit(lambda p, e, c: jq35.apply_text(p, jcfg, inputs_embs=e, cache=c))
    ids = rng(16).integers(0, 256, (2, 9)).astype(np.int32)
    jc, tc = jq35.init_cache(jcfg, 2, 12), tq35.init_cache(tcfg, 2, 12, device="cpu")
    for _ in range(3):
        je = jembedding(jp["tok_emb"], jnp.asarray(ids), dtype=jnp.float32)
        te = tlinear.embedding(model.tok_emb, T(ids).long(), dtype=torch.float32)
        assert np.array_equal(np.asarray(je), te.numpy())
        jl, jc, _ = apply(jp, je, jc)
        with torch.no_grad():
            tl, tc, _ = tq35.apply_text(model, tcfg, inputs_embs=te, cache=tc)
        assert max_err(tl, jl) <= MODEL_TOL
        ids = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_int4_qwen3_5_generate_tokens_match_jax():
    """int4 linears (per-channel scales), the fp table: greedy
    ``generate_kv_cache`` tokens identical."""
    jp = jquant.quantize_params_int8(jq35.init_text(jax.random.PRNGKey(4), dict(TEXT, dtype=jnp.float32)),
                                     bits=4, min_size=0)
    jcfg, tcfg = dict(TEXT, dtype=jnp.float32), dict(TEXT, dtype=torch.float32)
    model = from_jax_flat(flat(jp), tcfg, device="cpu")
    ids = rng(17).integers(0, 256, (2, 10)).astype(np.int32)
    ref = jgen.generate_kv_cache(JaxText, jp, jcfg, jnp.asarray(ids), max_gen=6, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq35.TextOnly, model, tcfg, T(ids).long(), max_gen=6, eos_ids=-1, pad_id=0)
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()


def top2_margins(gate_probas, k):
    top = torch.topk(torch.stack(gate_probas), k + 1, dim=-1).values
    return (top[..., -2] - top[..., -1]).flatten()


@pytest.mark.parametrize("block_size", [None, 16])
def test_int4_qwen3_moe_matches_jax(trees, block_size):
    """int4 linears and expert stacks (K11's plain version over the packed
    stacks; JAX's ``ragged_dot`` on the converted ones): a cached prefill
    and two decode steps within 1e-4, every top-2 margin above 1e-4, then
    greedy ``generate_kv_cache`` tokens identical."""
    jparams, _ = trees["moe"]
    jp = jquant.quantize_params_int8(jparams, bits=4, min_size=0, block_size=block_size)
    jcfg, tcfg = dict(MOE, dtype=jnp.float32), dict(MOE, dtype=torch.float32)
    model = from_jax_flat(flat(jp), tcfg, device="cpu")
    apply = jax.jit(lambda p, x, c: jq3.apply(p, jcfg, x, cache=c))
    ids = rng(18).integers(1, 128, (2, 11)).astype(np.int32)
    jc, tc = jq3.init_cache(jcfg, 2, 14), tq3.init_cache(tcfg, 2, 14, device="cpu")
    for _ in range(3):
        jl, jc, _ = apply(jp, jnp.asarray(ids), jc)
        with torch.no_grad():
            tl, tc, aux = tq3.apply(model, tcfg, T(ids).long(), cache=tc)
        assert float(top2_margins(aux["gate_probas"], MOE["top_k"]).min()) > 1e-4
        assert max_err(tl, jl) <= MODEL_TOL
        ids = np.asarray(jnp.argmax(jl[:, -1:], -1), np.int32)
    ids = rng(19).integers(1, 128, (2, 11)).astype(np.int32)
    ref = jgen.generate_kv_cache(jq3, jp, jcfg, jnp.asarray(ids), max_gen=6, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq3, model, tcfg, T(ids).long(), max_gen=6, eos_ids=-1, pad_id=0)
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()


def test_int4_moe_layer_reads_no_group_sizes_on_the_host(trees, monkeypatch):
    """The int4 MoE layer sends its stacks to K11 (spied: packed uint8
    stacks, every call) with ``torch.bincount`` patched to raise."""
    jp = jquant.quantize_params_int8(trees["moe"][0], bits=4, min_size=0)
    model = from_jax_flat(flat(jp), dict(MOE, dtype=torch.float32), device="cpu")
    calls = []
    real = kqg.quantized_ragged_dot
    monkeypatch.setattr(kqg, "quantized_ragged_dot", lambda x, w_q, *a, **k: calls.append(w_q.dtype) or real(
        x, w_q, *a, **k))
    monkeypatch.setattr(torch, "bincount", lambda *a, **k: (_ for _ in ()).throw(AssertionError("bincount")))
    with torch.no_grad():
        tq3.apply(model, dict(MOE, dtype=torch.float32), T(rng(20).integers(1, 128, (2, 5))).long())
    assert calls == [torch.uint8] * 3 * MOE["n_layers"]


# ------------------------------------------------------------------ masks


@pytest.mark.parametrize("with_mask", [False, True])
def test_bidirectional_mask_matches_jax(with_mask):
    if not with_mask:
        assert tmasks.bidirectional_mask(None) is None and jmasks.bidirectional_mask(None) is None
        return
    mask = rng(21).random((3, 9)) > 0.3
    got = tmasks.bidirectional_mask(T(mask))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), np.asarray(jmasks.bidirectional_mask(
        jnp.asarray(mask))))


@pytest.mark.parametrize("ctx,window", [(12, 4), (9, 1), (16, 16), (5, 9)])
def test_swa_causal_mask_table_matches_jax(ctx, window):
    got = tmasks.swa_causal_mask_table(ctx, window, device="cpu")
    assert got.dtype == torch.bool and got.shape == (ctx, ctx)
    assert np.array_equal(got.numpy(), np.asarray(jmasks.swa_causal_mask_table(ctx, window)))
    assert torch.equal(got[None, None], tmasks.causal_mask(ctx, window_size=window, device="cpu"))
