"""K12, the attention core of the int8-score ablation, against the JAX package, on the CPU.

``scripts/ablate_int8_scores.py`` is loaded by path; its Pallas kernel body
``_attn_kernel`` runs in interpret mode through a ``pl.pallas_call`` of the
form ``make_attn_core`` builds (GB groups per program, VMEM block specs),
at a small G. The port's plain ``attn_core`` (the CPU path of
``kernels/attn_core.py``) is held to it: int8 scores bit for bit, bf16
scores within one bf16 unit of max |ref| (the fp32 score sums of the two
may round to neighbouring bf16 values). The tensor-core kernel
(``csrc/attn_core_tc.cu``) runs only on the card; its order of work, the
scores of each 64-key chunk rounded to bf16 and the chunks' products summed
in order (``chunked_plain`` here), is held to the Pallas kernel within
``k12_tolerance`` at M 80 and 208 (a last chunk of 16 keys). Also: the
wrapper's CPU path launches nothing, the CUDA checks refuse what the kernel does not take, and
the port's ablation keeps the JAX script's shapes and FLOP count.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from llm_quest_tpu_torch.kernels import attn_core as kac
from llm_quest_tpu_torch.scripts import ablate_int8_scores as tab

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "ablate_int8_scores.py"


@pytest.fixture(scope="module")
def jscript():
    spec = importlib.util.spec_from_file_location("jax_ablate_int8_scores", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_attn_core(mod, t, q, k, v, acc_dtype, gb):
    """``make_attn_core``'s pallas_call at q's shape, in interpret mode."""
    g, m, d = q.shape
    kv = v.shape[-1]
    spec_qk = pl.BlockSpec((gb, m, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    spec_v = pl.BlockSpec((gb, m, kv), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    spec_t = pl.BlockSpec((1, 1, kv), lambda i: (0, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(mod._attn_kernel, acc_dtype=acc_dtype),
        grid=(g // gb,),
        in_specs=[spec_t, spec_qk, spec_qk, spec_v],
        out_specs=spec_v,
        out_shape=jax.ShapeDtypeStruct((g, m, kv), jnp.bfloat16),
        interpret=True,
    )(t, q, k, v)


def inputs(g, m, d, kv, int8, seed=0, sign=1):
    """bf16 q/k/v as the script draws them, q/k scaled by 16 and truncated
    to int8 for the int8 variant, and the ±0.01 perturbation t; returned as
    bf16-exact fp32 / int8 numpy arrays."""
    rng = np.random.default_rng(seed)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q, k = bf(rng.standard_normal((g, m, d))), bf(rng.standard_normal((g, m, d)))
    v = bf(rng.standard_normal((g, m, kv)))
    if int8:
        q, k = (q * 16).astype(np.int8), (k * 16).astype(np.int8)
    return bf(np.full((1, 1, kv), 0.01 * sign)), q, k, v


def to_jax(x):
    return jnp.asarray(x) if x.dtype == np.int8 else jnp.asarray(x, jnp.bfloat16)


def to_torch(x):
    t = torch.from_numpy(np.array(x))
    return t if t.dtype == torch.int8 else t.to(torch.bfloat16)


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("d", [16, 32])
def test_k12_plain_int8_equals_pallas(jscript, d, sign):
    t, q, k, v = inputs(32, 24, d, 16, int8=True, sign=sign)
    ref = jax_attn_core(jscript, *map(to_jax, (t, q, k, v)), jnp.int32, gb=16)
    got = kac.attn_core(*map(to_torch, (t, q, k, v)))
    assert got.dtype == torch.bfloat16 and got.shape == (32, 24, 16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("d", [16, 32])
def test_k12_plain_bf16_matches_pallas(jscript, d):
    t, q, k, v = inputs(32, 24, d, 16, int8=False, seed=1)
    args = tuple(map(to_torch, (t, q, k, v)))
    ref = torch.from_numpy(np.asarray(jax_attn_core(jscript, *map(to_jax, (t, q, k, v)), jnp.float32, gb=16)
                                      .astype(jnp.float32)))
    got = kac.attn_core(*args).float()
    assert bool(((got - ref).abs() <= kac.k12_tolerance(*args, ref)).all())


def chunked_plain(t, q, k, v):
    """The kernel's order of work in fp32 (comparisons on the CPU): the
    scores of each ``kac.CHUNK`` keys (exact int32 for int8 q/k), rounded to bf16,
    times that chunk's rows of the bf16 ``v + t[0]``, the chunks' products
    summed in order, the sum stored as bf16."""
    with kac._full_fp32(q.device):
        vt = (v + t[0]).float()
        o = torch.zeros(*q.shape[:2], v.shape[-1], dtype=torch.float32, device=q.device)
        for c in range(0, q.shape[1], kac.CHUNK):
            kc = k[:, c:c + kac.CHUNK]
            if q.dtype == torch.int8:
                s = torch.einsum("gmd,gnd->gmn", q.to(torch.int32), kc.to(torch.int32)).float()
            else:
                s = torch.einsum("gmd,gnd->gmn", q.float(), kc.float())
            o = o + torch.einsum("gmn,gnk->gmk", s.to(torch.bfloat16).float(), vt[:, c:c + kac.CHUNK])
        return o.to(torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("m", [80, 208])
def test_k12_chunked_order_matches_pallas(jscript, int8, m):
    d = 128 if int8 else 64
    t, q, k, v = inputs(16, m, d, 64, int8=int8, seed=m + int(int8))
    args = tuple(map(to_torch, (t, q, k, v)))
    ref = torch.from_numpy(np.asarray(jax_attn_core(jscript, *map(to_jax, (t, q, k, v)),
                                                    jnp.int32 if int8 else jnp.float32, gb=16).astype(jnp.float32)))
    got = chunked_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (16, m, 64)
    err = (got.float() - ref).abs()
    assert bool((err <= kac.k12_tolerance(*args, ref)).all()), float(err.max())


def test_k12_int8_scores_round_through_fp32():
    """The int32 scores round to bf16 (nearest, ties to even), and ``v + t``
    rounds to bf16 before the product: hand-computed cases."""
    q = torch.tensor([[[127, 127], [0, 0]]], dtype=torch.int8)
    k = torch.tensor([[[127, 2], [0, 3]]], dtype=torch.int8)
    eye = torch.eye(2, dtype=torch.bfloat16)[None]
    got = kac.attn_core(torch.zeros(1, 1, 2, dtype=torch.bfloat16), q, k, eye)
    # s = [[16383, 381], [0, 0]]: 16383 → 16384, and 381 is a tie between 380 and 382 → 380 (even)
    np.testing.assert_array_equal(got.float().numpy(), [[[16384.0, 380.0], [0.0, 0.0]]])
    # s = 129 (exact in bf16); v + t = 1 + (2^-8 - 2^-16) rounds to 1, so o = 129 (130 unrounded)
    t = torch.full((1, 1, 1), 2.0**-8 - 2.0**-16, dtype=torch.bfloat16)
    got = kac.attn_core(t, torch.tensor([[[127, 2]]], dtype=torch.int8), torch.tensor([[[1, 1]]], dtype=torch.int8),
                        torch.ones(1, 1, 1, dtype=torch.bfloat16))
    assert float(got) == 129.0


def test_k12_cpu_path_launches_nothing_and_cuda_checks_refuse():
    t, q, k, v = map(to_torch, inputs(4, 32, 128, 64, int8=True))
    n = kac.attn_core.launches, kac.attn_core.int8_launches
    kac.attn_core(t, q, k, v)
    assert (kac.attn_core.launches, kac.attn_core.int8_launches) == n
    cases = [  # what the kernel does not take raises before any launch
        (t, q[:, :24], k[:, :24], v[:, :24], "multiple of 16"),
        (t, q[..., :64], k[..., :64], v, "bytes"),
        (t[..., :32], q, k, v[..., :32], "v \\(G, M, 64\\)"),
        (t, q, k.float().to(torch.bfloat16), v, "one dtype"),
        (t, q, k, v, "CUDA"),  # every check passes but the device
    ]
    for *args, msg in cases:
        with pytest.raises(ValueError, match=msg):
            kac._check_cuda(*args)


def test_ablation_keeps_the_jax_shapes_and_flop_count(jscript):
    assert (tab.G, tab.M, tab.K, tab.N_ITERS) == (jscript.G, jscript.M, jscript.K, jscript.N_ITERS)
    assert 4 * tab.G * tab.M * tab.M * tab.K == 17_012_097_024
    run = tab.make_attn_core(torch.int8, tab.K_INT8, m=tab.M_INT8)
    t, q, k, v = map(to_torch, inputs(4, 32, 128, 64, int8=True))
    with pytest.raises(ValueError, match="built for"):
        run(t, q, k, v)
