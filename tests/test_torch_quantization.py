"""The ported int8 quantization against the JAX package, on the CPU.

Inputs come from numpy with a seed and go through both packages in fp32.
Tolerances:

- int8 codes equal, scales within 1e-7 relative: both divide and round in
  fp32 with round-half-to-even, so a difference would be a different rule,
  not rounding noise;
- ``linear``, ``embedding``, ``tied_head`` and the dequantization within 1e-5
  (fp32 products summed in another order);
- the module walk selects exactly the JAX leaves, and ``from_jax_flat`` of a
  quantized JAX tree equals the port's own quantization of the same fp model,
  leaf for leaf and bit for bit;
- byte counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.inference import generate as jgen
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.models import qwen3_5 as jq35
from llm_quest_tpu.models import qwen3_next as jqn
from llm_quest_tpu.ops import linear as jlinear
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.training import flops as jflops
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference import generate as tgen
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.ops import linear as tlinear
from llm_quest_tpu_torch.ops import quantization as tquant
from llm_quest_tpu_torch.training import flops as tflops
from llm_quest_tpu_torch.weights.interop import from_jax_flat

NEXT = {k: v for k, v in jconfig.QWEN3_NEXT_SMALL_CONFIG.items() if k != "dtype"}
NEXT.update(
    n_layers=4, emb_dim=64, head_dim=16, n_heads=4, num_kv_groups=2,
    linear_num_qk_heads=2, linear_num_value_heads=4, linear_qk_head_dim=16, linear_value_head_dim=16,
    moe_hidden_dim=96, shared_expert_hidden_dim=96, num_experts=4, top_k=2,
    vocab_size=256, context_length=64, p_dropout=0.0,
)
TEXT = {
    "vocab_size": 256, "emb_dim": 64, "hidden_dim": 128, "n_layers": 4, "linear_sdpa_ratio": 2,
    "n_heads": 4, "num_kv_groups": 2, "head_dim": 16, "rope_base": 10_000_000, "partial_rope_factor": 0.25,
    "context_length": 64, "linear_num_qk_heads": 2, "linear_num_value_heads": 4, "linear_qk_head_dim": 8,
    "linear_value_head_dim": 8, "linear_conv_kernel_size": 4, "tie_embeddings": True, "mrope_section": [1, 1, 0],
}
QUANT_OPTIONS = [
    {},
    {"quantize_embeddings": True},
    {"quantize_experts": False, "min_size": 1024},
    {"exclude": r"tok_emb|conv|out_proj", "min_size": 0, "quantize_embeddings": True},
    {"block_size": 16},
]


def rng(seed):
    return np.random.default_rng(seed)


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def T(x):
    return torch.from_numpy(np.array(x))


def assert_scales(got, ref):
    ref = np.asarray(ref, np.float64)
    err = np.abs(got.numpy().astype(np.float64) - ref).max() / np.abs(ref).max()
    assert got.shape == ref.shape and err <= 1e-7, err


def max_err(got, ref):
    return float(np.abs(got.detach().numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


# ------------------------------------------------------------------ quantizers


def test_quantize_rows_matches_jax():
    x = rng(0).standard_normal((2, 3, 5, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-12 floor
    q, s = tquant.quantize_rows_int8(T(x))
    jq, js = jquant.quantize_rows_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert_scales(s, js)


@pytest.mark.parametrize("block_size", [None, 8])
def test_quantize_linear_and_matmul_match_jax(block_size):
    w = rng(1).standard_normal((32, 24)).astype(np.float32)  # JAX (in, out)
    b = rng(2).standard_normal(24).astype(np.float32)
    x = rng(3).standard_normal((3, 5, 32)).astype(np.float32)
    jp = jquant.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)}, block_size=block_size)
    tp = tquant.quantize_linear_int8({"w": T(w.T), "b": T(b)}, block_size=block_size)
    assert np.array_equal(tp["w_q"].numpy().T, np.asarray(jp["w_q"]))
    assert_scales(tp["w_scale"], jp["w_scale"])
    assert max_err(tquant.dequantize_int8(tp["w_q"], tp["w_scale"]).T,
                   jquant.dequantize_int8(jp["w_q"], jp["w_scale"])) <= 1e-7
    layer = tquant.QuantLinear(tp["w_q"], tp["w_scale"], tp["b"])
    assert max_err(layer(T(x)), jlinear.linear(jp, jnp.asarray(x))) <= 1e-5
    with pytest.raises(ValueError, match="block_size"):
        tquant.quantize_linear_int8({"w": T(w.T)}, block_size=7)


def test_embedding_and_tied_head_match_jax():
    w = rng(4).standard_normal((40, 16)).astype(np.float32)
    ids = rng(5).integers(0, 40, (2, 7))
    h = rng(6).standard_normal((2, 7, 16)).astype(np.float32)
    jp = jquant.quantize_embedding_int8({"w": jnp.asarray(w)})
    tp = tquant.quantize_embedding_int8({"w": T(w)})
    assert np.array_equal(tp["w_q"].numpy(), np.asarray(jp["w_q"]))
    assert_scales(tp["w_scale"], jp["w_scale"])
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        got = tlinear.embedding(tp, T(ids), dtype=dtype)
        ref = jlinear.embedding(jp, jnp.asarray(ids), dtype=jdtype)
        assert got.dtype == (dtype or torch.bfloat16)  # JAX's rule: int8 tables gather to bf16
        assert max_err(got.float(), np.asarray(ref, np.float32)) <= 1e-5
    assert max_err(tlinear.tied_head(tp, T(h)), jlinear.tied_head(jp, jnp.asarray(h))) <= 1e-5
    fp = {"w": T(w)}
    assert max_err(tlinear.embedding(fp, T(ids)), jlinear.embedding({"w": jnp.asarray(w)}, jnp.asarray(ids))) == 0.0


def test_quantize_expert_stack_matches_jax():
    experts = {n: rng(i).standard_normal((3, 8, 12) if n != "lin2" else (3, 12, 8)).astype(np.float32)
               for i, n in enumerate(("lin1", "gate", "lin2"))}
    experts["b1"] = rng(9).standard_normal((3, 12)).astype(np.float32)
    jp = jquant.quantize_expert_stack_int8({k: jnp.asarray(v) for k, v in experts.items()})
    tp = tquant.quantize_expert_stack_int8({k: T(v) for k, v in experts.items()})
    assert set(tp) == set(jp)
    for n in ("lin1", "gate", "lin2"):
        assert np.array_equal(tp[n + "_q"].numpy(), np.asarray(jp[n + "_q"]))
        assert_scales(tp[n + "_scale"], jp[n + "_scale"])
    assert torch.equal(tp["b1"], T(experts["b1"]))


# ------------------------------------------------------------------ whole models


@pytest.fixture(scope="module")
def jax_models():
    nxt = jqn.init(jax.random.PRNGKey(0), dict(NEXT, dtype=jnp.float32))
    text = jq35.init_text(jax.random.PRNGKey(1), dict(TEXT, dtype=jnp.float32))
    return {"next": (nxt, dict(NEXT, dtype=torch.float32)), "text": (text, dict(TEXT, dtype=torch.float32))}


@pytest.mark.parametrize("options", QUANT_OPTIONS, ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()) or "default")
@pytest.mark.parametrize("which", ["next", "text"])
def test_walk_selects_jax_leaves_and_from_jax_flat_equals_it(jax_models, which, options):
    """The module walk quantizes exactly the leaves the JAX walk does, and the
    quantized JAX tree loaded by ``from_jax_flat`` equals the port's own
    quantization of the fp model, leaf for leaf."""
    jparams, cfg = jax_models[which]
    jflat = flat(jquant.quantize_params_int8(jparams, **options))
    mine = tquant.quantize_params_int8(from_jax_flat(flat(jparams), cfg, device="cpu"), **options)
    state = mine.state_dict()
    assert set(state) == {k.replace("/", ".") for k in jflat}
    loaded = from_jax_flat(jflat, cfg, device="cpu").state_dict()
    for name, t in state.items():
        assert loaded[name].dtype == t.dtype and torch.equal(loaded[name], t), name
    assert any(t.dtype == torch.int8 for t in state.values())


def test_byte_fraction_and_param_bytes_match_jax(jax_models):
    jparams, cfg = jax_models["next"]
    options = {"quantize_embeddings": True}
    fp = from_jax_flat(flat(jparams), cfg, device="cpu")
    q = tquant.quantize_params_int8(from_jax_flat(flat(jparams), cfg, device="cpu"), **options)
    jq = jquant.quantize_params_int8(jparams, **options)
    assert tquant.quantized_byte_fraction(q, fp) == pytest.approx(jquant.quantized_byte_fraction(jq, jparams), rel=1e-12)
    assert tflops.param_bytes(q) == jflops.param_bytes(jq)
    assert tflops.param_bytes(fp) == jflops.param_bytes(jparams)


# ------------------------------------------------------------------ decode bytes


def test_decode_bytes_match_jax_for_a_bf16_cache_and_count_int8_as_stored():
    """bf16 cache: the port's count equals JAX's. int8 cache: the port counts
    one byte an element plus the fp32 k and v scales; JAX keeps 2 bytes an
    element and no scales (the documented fault in the reference)."""
    jbf = jqn.init(jax.random.PRNGKey(0), dict(NEXT, dtype=jnp.bfloat16))  # fp32 islands stay fp32
    cfg = dict(NEXT, dtype=torch.bfloat16)
    model = from_jax_flat(flat(jbf), cfg, device="cpu")
    kv_len, batch = 100, 4
    got = tflops.decode_bytes_per_token(model, cfg, kv_len=kv_len, batch=batch)
    assert got == jflops.decode_bytes_per_token(jbf, dict(NEXT, dtype=jnp.bfloat16), kv_len=kv_len, batch=batch)

    q8 = dict(cfg, kv_quant="int8")
    got8 = tflops.decode_bytes_per_token(model, q8, kv_len=kv_len, batch=batch)
    n_attn, nkv, hd = NEXT["n_layers"] // NEXT["linear_sdpa_ratio"], NEXT["num_kv_groups"], NEXT["head_dim"]
    by_hand_kv8 = n_attn * kv_len * nkv * (2 * hd * 1 + 2 * 4)
    by_hand_kv16 = n_attn * kv_len * nkv * 2 * hd * 2
    assert got8 == got - by_hand_kv16 + by_hand_kv8
    jax8 = jflops.decode_bytes_per_token(jbf, dict(NEXT, dtype=jnp.bfloat16, kv_quant="int8"), kv_len=kv_len,
                                         batch=batch)
    assert jax8 - got8 == by_hand_kv16 - by_hand_kv8 > 0


def test_mbu_is_a_card_metric(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tflops.mbu(100.0, 1e9)
    monkeypatch.setattr(tflops, "device_peaks", lambda device=None: {"hbm_gbps": 3350.0})
    assert tflops.mbu(100.0, 1e9) == pytest.approx(100.0 * 1e9 / 3.35e12)
    assert tflops.mbu(100.0, 1e9) == pytest.approx(jflops.mbu(100.0, 1e9) * 819.0 / 3350.0)


# ------------------------------------------------------------------ int8 Qwen3 serving


def test_int8_qwen3_decode_matches_jax():
    """A tiny dense Qwen3 at head dim 128 with int8 linears and the int8 KV
    cache (K10's plain version against the Pallas kernel in interpret mode at
    every decode step; the table stays fp, see tests/test_torch_qwen3_5.py):
    cached logits within 1e-4 and identical greedy tokens."""
    cfg = {"vocab_size": 128, "emb_dim": 32, "hidden_dim": 64, "n_layers": 2, "n_heads": 4, "num_kv_groups": 2,
           "head_dim": 128, "rope_base": 1_000_000, "context_length": 64, "tie_embeddings": True,
           "model_type": "dense", "kv_quant": "int8"}
    jcfg, tcfg = dict(cfg, dtype=jnp.float32), dict(cfg, dtype=torch.float32)
    jparams = jquant.quantize_params_int8(jq3.init(jax.random.PRNGKey(3), jcfg), min_size=0)
    model = from_jax_flat(flat(jparams), tcfg, device="cpu")
    ids = rng(7).integers(0, 128, (2, 10)).astype(np.int32)
    jc, tc = jq3.init_cache(jcfg, 2, 13), tq3.init_cache(tcfg, 2, 13, device="cpu")
    for _ in range(3):
        jl, jc, _ = jq3.apply(jparams, jcfg, jnp.asarray(ids), cache=jc)
        with torch.no_grad():
            tl, tc, _ = tq3.apply(model, tcfg, T(ids).long(), cache=tc)
        assert max_err(tl, jl) <= 1e-4
        ids = np.asarray(jnp.argmax(jl[:, -1:], -1), np.int32)
    ids = rng(8).integers(0, 128, (2, 10)).astype(np.int32)
    ref = jgen.generate_kv_cache(jq3, jparams, jcfg, jnp.asarray(ids), max_gen=6, temp=0.0, eos_ids=-1, pad_id=0)
    got = tgen.generate_kv_cache(tq3, model, tcfg, T(ids).long(), max_gen=6, eos_ids=-1, pad_id=0)
    assert got["sequences"].tolist() == np.asarray(ref["sequences"]).tolist()
