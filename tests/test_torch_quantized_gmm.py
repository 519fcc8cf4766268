"""K11 (the grouped matmul over int8 expert stacks) and the int8 Qwen3-MoE
layer against the JAX package, on the CPU.

The plain version of ``kernels/quantized_gmm.py`` is held to the Pallas
kernel run as ``tests/test_quantized_gmm.py`` runs it (``interpret=True``):
fp32 rows within 1e-5 (sums in another order); bf16 rows within 2e-2 ×
max |ref|, because the TPU kernel rounds the product to bf16 before the scale
multiplies and the port rounds once, after it (a documented divergence).
``qwen3_moe`` with int8 stacks (the shared expert included) is held to JAX's
``qwen3_moe`` on the same quantized tree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu import config as jconfig
from llm_quest_tpu.kernels.quantized_gmm import quantized_ragged_dot as jqrd
from llm_quest_tpu.ops import moe as jmoe
from llm_quest_tpu.ops import quantization as jquant
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.kernels import quantized_gmm as kq
from llm_quest_tpu_torch.ops import moe as tmoe
from llm_quest_tpu_torch.ops.linear import params as tparams

SIZES = {
    "empty groups": [0, 7, 0, 9],
    "one expert": [16, 0, 0, 0],
    "unaligned": [1, 1, 1, 13],
    "eight experts": [3, 0, 5, 1, 0, 2, 4, 1],
    "twelve experts": [2, 1, 0, 4, 3, 0, 0, 2, 1, 1, 1, 1],
}


def T(x):
    return torch.from_numpy(np.array(x))


def make(sizes, d=64, n=96, seed=0):
    rng = np.random.default_rng(seed)
    t, e = sum(sizes), len(sizes)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w_q = rng.integers(-127, 128, (e, d, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.02, (e, n)).astype(np.float32)
    return x, w_q, scale, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("sizes", list(SIZES.values()), ids=list(SIZES))
def test_plain_matches_pallas_interpret_fp32(sizes):
    x, w_q, scale, gs = make(sizes, seed=len(sizes))
    ref = jqrd(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale), jnp.asarray(gs), tile_m=8, interpret=True)
    got = kq.quantized_ragged_dot(T(x), T(w_q), T(scale), T(gs).long())
    err = float(np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())
    assert got.shape == ref.shape and err <= 1e-5, err


def test_plain_matches_pallas_interpret_bf16_rows():
    x, w_q, scale, gs = make([5, 0, 11, 16], seed=3)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jqrd(jx, jnp.asarray(w_q), jnp.asarray(scale), jnp.asarray(gs), tile_m=16, interpret=True),
                     np.float32)
    got = kq.quantized_ragged_dot(T(np.asarray(jx, np.float32)).bfloat16(), T(w_q), T(scale), T(gs).long())
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - ref).max())
    assert err <= 2e-2 * float(np.abs(ref).max()), err


TINY = {k: v for k, v in jconfig.QWEN3_NEXT_SMALL_CONFIG.items() if k != "dtype"}
TINY.update(emb_dim=64, moe_hidden_dim=96, shared_expert_hidden_dim=96, num_experts=8, top_k=2)


def to_port(jtree):
    """A quantized JAX ``qwen3_moe`` parameter tree as the port's module
    (every leaf keeps its layout: expert stacks are (E, in, out) in both)."""
    flat = {k: torch.from_numpy(np.array(v)) for k, v in flatten_params(jtree).items()}
    module = torch.nn.Module()
    for group in ("experts", "shared"):
        module.add_module(group, tparams(**{k.split("/")[1]: v for k, v in flat.items() if k.startswith(group + "/")}))
    module.gate_w = torch.nn.Parameter(flat["gate_w"], requires_grad=False)
    module.shared_gate_w = torch.nn.Parameter(flat["shared_gate_w"], requires_grad=False)
    return module


@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_int8_qwen3_moe_matches_jax(capacity_factor):
    """Exact dispatch through K11's plain version; a capacity factor is
    ignored for int8 stacks in both packages (they keep the exact path)."""
    jparams = jmoe.init_qwen3_moe(jax.random.PRNGKey(0), TINY)
    jq = jquant.quantize_params_int8(jparams, min_size=0)
    assert "lin1_q" in jq["experts"] and "lin1_q" in jq["shared"]
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32)
    ref, raux = jmoe.qwen3_moe(jq, jnp.asarray(x), top_k=2, load_coeff=0.001, training=False,
                               capacity_factor=capacity_factor)
    got, aux = tmoe.qwen3_moe(to_port(jq), T(x), top_k=2, load_coeff=0.001, training=False,
                              capacity_factor=capacity_factor)
    err = float(np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())
    assert err <= 1e-5, err
    assert float(np.abs(aux["gate_probas"].numpy() - np.asarray(raux["gate_probas"])).max()) <= 1e-6


def test_cpu_tensors_take_the_plain_version():
    x, w_q, scale, gs = make([2, 2], seed=9)
    n = kq.quantized_ragged_dot.launches
    kq.quantized_ragged_dot(T(x), T(w_q), T(scale), T(gs).long())
    assert kq.quantized_ragged_dot.launches == n
