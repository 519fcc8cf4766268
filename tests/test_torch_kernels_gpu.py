"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips when no CUDA device is present (the kernels
are compiled by nvcc for sm_90a and have no CPU or interpret mode). On a
machine with an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Tolerances on max |kernel - plain| relative to max(1, max |plain|): fp32 2e-4
(both compute in fp32, in another summation order), bf16 2e-2 (bf16 inputs
and outputs round once more).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def assert_close(got, ref, dtype):
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    assert err <= TOL[dtype] * max(1.0, float(ref.float().abs().max())), err


def gdn_inputs(gen, b, h, s, dtype):
    from llm_quest_tpu_torch.ops.gdn import l2_norm_clamp

    q = l2_norm_clamp(randn(gen, b, h, s, 128)).to(dtype)
    k = l2_norm_clamp(randn(gen, b, h, s, 128)).to(dtype)
    v = randn(gen, b, h, s, 128, dtype=dtype)
    beta = torch.sigmoid(randn(gen, b, h, s))
    alpha = torch.sigmoid(randn(gen, b, h, s, scale=0.3) + 2.0)
    return q, k, v, beta, alpha, randn(gen, b, h, 128, 128, scale=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 37, 156])
def test_gdn_prefill_kernel(gen, dtype, s):
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 4, s, dtype)
    n = gdn.gated_delta_rule_fwd.launches
    out, st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0)
    assert gdn.gated_delta_rule_fwd.launches == n + 1
    ref_out, ref_st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0, plain=True)
    assert_close(out, ref_out, dtype)
    assert_close(st, ref_st, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gdn_step_stacked_kernel_in_place(gen, dtype):
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha = (x[:, :, 0] for x in gdn_inputs(gen, 3, 4, 1, dtype)[:5])
    stacked = randn(gen, 5, 3, 4, 128, 128, scale=0.1)
    before, ref_stacked = stacked.clone(), stacked.clone()
    out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, stacked, 2)
    ref_out, _ = gdn.gated_delta_rule_step_stacked(q, k, v, beta, alpha, ref_stacked, 2, plain=True)
    assert_close(out, ref_out, dtype)
    assert_close(stacked[2], ref_stacked[2], torch.float32)
    for other in (0, 1, 3, 4):
        assert torch.equal(stacked[other], before[other])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q_start", [0, 32])
def test_flash_attention_kernel(gen, dtype, q_start):
    from llm_quest_tpu_torch.kernels import attention

    q = randn(gen, 2, 8, 150, 256, dtype=dtype)
    k, v = randn(gen, 2, 2, 200, 256, dtype=dtype), randn(gen, 2, 2, 200, 256, dtype=dtype)
    mask = torch.rand(2, 200, generator=gen, device="cuda") > 0.2
    mask[:, 0] = True
    for m in (None, mask):
        got = attention.flash_attention(q, k, v, attn_mask=m, q_start=q_start)
        assert_close(got, attention.flash_attention(q, k, v, attn_mask=m, q_start=q_start, plain=True), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [20, 576])
def test_packed_mha_kernel(gen, dtype, s):
    from llm_quest_tpu_torch.kernels import attention

    q, k, v = (randn(gen, 2, s, 12 * 64, dtype=dtype) for _ in range(3))
    assert_close(attention.packed_mha(q, k, v, 12), attention.packed_mha(q, k, v, 12, plain=True), dtype)


def test_wrappers_raise_on_unsupported_shapes(gen):
    from llm_quest_tpu_torch.kernels import attention, gdn

    q = randn(gen, 1, 2, 4, 64)  # dk = 64: the GDN kernels take 128
    with pytest.raises(ValueError):
        gdn.gated_delta_rule_fwd(q, q, q, q[..., 0], q[..., 0])
    x = randn(gen, 1, 4, 2 * 48)  # head dim 48 has no instantiation
    with pytest.raises(ValueError):
        attention.packed_mha(x, x, x, 2)
