"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips when no CUDA device is present (the kernels
are compiled by nvcc for sm_90a and have no CPU or interpret mode). On a
machine with an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Tolerances on max |kernel - plain| relative to max(1, max |plain|): fp32 2e-4
(both compute in fp32, in another summation order), bf16 2e-2 (bf16 inputs
and outputs round once more). The flash backward's gradients are held to
autograd through the plain forward with the same tolerances, and K1's
backward to its plain version (the per-chunk replay) on the same anchors.
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


def gdn_inputs(gen, b, h, s, dtype, dk=128, dv=128):
    from llm_quest_tpu_torch.ops.gdn import l2_norm_clamp

    q = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    k = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    v = randn(gen, b, h, s, dv, dtype=dtype)
    beta = torch.sigmoid(randn(gen, b, h, s))
    alpha = torch.sigmoid(randn(gen, b, h, s, scale=0.3) + 2.0)
    return q, k, v, beta, alpha, randn(gen, b, h, dv, dk, scale=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 37, 156])
@pytest.mark.parametrize("dk", [64, 128])
def test_gdn_prefill_kernel(gen, dtype, s, dk):
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 4, s, dtype, dk=dk, dv=dk)
    n = gdn.gated_delta_rule_fwd.launches
    out, st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0)
    assert gdn.gated_delta_rule_fwd.launches == n + 1
    ref_out, ref_st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, s0, plain=True)
    assert_close(out, ref_out, dtype)
    assert_close(st, ref_st, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk, dv", [(64, 64), (128, 128), (64, 128)])
@pytest.mark.parametrize("s", [20, 300])
@pytest.mark.parametrize("with_prev", [False, True])
def test_gdn_prefill_backward_kernel(gen, dtype, dk, dv, s, with_prev):
    """K1's backward against the plain per-chunk replay on the kernel's own
    anchors (s = 300 ends in a partial chunk), then the autograd Function
    against autograd through the plain chunked forward."""
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 4, s, dtype, dk=dk, dv=dv)
    prev = s0 if with_prev else None
    d_out = randn(gen, 2, 4, s, dv, dtype=dtype)
    d_state = randn(gen, 2, 4, dv, dk)
    out, st, anchors = gdn._launch_fwd(q, k, v, beta, alpha, prev, anchor_chunk=gdn.ANCHOR_CHUNK)
    _, _, ref_anchors = gdn.gated_delta_rule_fwd_plain(
        q, k, v, beta, alpha, prev, chunk_size=gdn.ANCHOR_CHUNK, with_anchors=True
    )
    assert_close(anchors, ref_anchors, dtype)
    n = gdn.gated_delta_rule_bwd.launches
    got = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=gdn.ANCHOR_CHUNK)
    assert gdn.gated_delta_rule_bwd.launches == n + 1
    ref = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=gdn.ANCHOR_CHUNK,
                                   plain=True)
    for g, r, src in zip(got, ref, (q, k, v, beta, alpha, d_state)):
        assert g.dtype == src.dtype
        assert_close(g, r, dtype)

    args = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha, s0)]
    n_fwd, n_bwd = gdn.gated_delta_rule_fwd.launches, gdn.gated_delta_rule_bwd.launches
    o, fin = gdn.gated_delta_rule_fwd(*args[:5], args[5] if with_prev else None)
    grads = torch.autograd.grad((o, fin), args if with_prev else args[:5], (d_out, d_state))
    assert (gdn.gated_delta_rule_fwd.launches, gdn.gated_delta_rule_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    plain_args = [t.clone().requires_grad_() for t in (q, k, v, beta, alpha, s0)]
    po, pfin = gdn.gated_delta_rule_fwd(*plain_args[:5], plain_args[5] if with_prev else None, plain=True)
    refs = torch.autograd.grad((po, pfin), plain_args if with_prev else plain_args[:5], (d_out, d_state))
    for g, r in zip(grads, refs):
        assert_close(g, r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk", [64, 128])
def test_gdn_step_stacked_kernel_in_place(gen, dtype, dk):
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha = (x[:, :, 0] for x in gdn_inputs(gen, 3, 4, 1, dtype, dk=dk, dv=dk)[:5])
    stacked = randn(gen, 5, 3, 4, dk, dk, scale=0.1)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("heads", [(16, 8), (8, 2)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_flash_attention_backward_kernel(gen, dtype, d, heads, with_mask):
    from llm_quest_tpu_torch.kernels import attention

    hq, hkv = heads
    q0 = randn(gen, 2, hq, 150, d, dtype=dtype)
    k0, v0 = randn(gen, 2, hkv, 150, d, dtype=dtype), randn(gen, 2, hkv, 150, d, dtype=dtype)
    do = randn(gen, 2, hq, 150, d, dtype=dtype)
    mask = None
    if with_mask:
        mask = torch.rand(2, 150, generator=gen, device="cuda") > 0.2
        mask[:, 0] = True
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    n_fwd, n_bwd = attention.flash_attention.launches, attention.flash_attention_bwd.launches
    out = attention.flash_attention(q, k, v, attn_mask=mask)
    out.backward(do)
    assert (attention.flash_attention.launches, attention.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    refs = attention.flash_attention_bwd_plain(q0, k0, v0, do, attn_mask=mask)
    assert_close(out, attention.flash_attention(q0, k0, v0, attn_mask=mask, plain=True), dtype)
    for got, ref in zip((q.grad, k.grad, v.grad), refs):
        assert got.dtype == dtype
        assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_backward_q_start_and_delta_shift(gen, dtype):
    """Cached-prefill geometry (sq < sk, q_start > 0) and the lse cotangent."""
    from llm_quest_tpu_torch.kernels import attention

    q = randn(gen, 2, 8, 100, 128, dtype=dtype)
    k, v = randn(gen, 2, 2, 164, 128, dtype=dtype), randn(gen, 2, 2, 164, 128, dtype=dtype)
    do = randn(gen, 2, 8, 100, 128, dtype=dtype)
    shift = randn(gen, 2, 8, 100, scale=0.1)
    mask = torch.rand(2, 164, generator=gen, device="cuda") > 0.2
    mask[:, 0] = True
    for delta_shift in (None, shift):
        o = attention.flash_attention(q, k, v, attn_mask=mask, q_start=40)
        lse = attention._plain_lse(q, k, mask, True, 40, 128**-0.5)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, attn_mask=mask, q_start=40, delta_shift=delta_shift)
        ref = attention.flash_attention_bwd(
            q, k, v, o, lse, do, attn_mask=mask, q_start=40, delta_shift=delta_shift, plain=True
        )
        for g, r in zip(got, ref):
            assert_close(g, r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("features", [
    {"window_size": 40}, {"window_size": 1}, {"window_size": 500}, {"softcap": 30.0}, {"sink": True},
    {"window_size": 64, "softcap": 20.0, "sink": True, "padding": True}, {"window_size": 100, "causal": False},
])
def test_flash_attention_window_softcap_sink_kernels(gen, dtype, features):
    """K4's sliding window, softcap and sinks, forward and backward (dsink
    included), against autograd through the plain version; s 300 spans
    several key tiles on either side of the window."""
    from llm_quest_tpu_torch.kernels import attention

    q0 = randn(gen, 2, 4, 300, 256, dtype=dtype)
    k0, v0 = randn(gen, 2, 1, 300, 256, dtype=dtype), randn(gen, 2, 1, 300, 256, dtype=dtype)
    do = randn(gen, 2, 4, 300, 256, dtype=dtype)
    kw = {key: val for key, val in features.items() if key not in ("sink", "padding")}
    if features.get("padding"):
        kw["attn_mask"] = torch.rand(2, 300, generator=gen, device="cuda") > 0.2
        kw["attn_mask"][:, 0] = True
    sink0 = randn(gen, 4) if features.get("sink") else None
    leaves = [t.clone().requires_grad_() for t in (q0, k0, v0) + (() if sink0 is None else (sink0,))]
    n_fwd, n_bwd = attention.flash_attention.launches, attention.flash_attention_bwd.launches
    out = attention.flash_attention(*leaves[:3], sink=None if sink0 is None else leaves[3], **kw)
    grads = torch.autograd.grad(out, leaves, do)
    assert (attention.flash_attention.launches, attention.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert_close(out, attention.flash_attention(q0, k0, v0, sink=sink0, plain=True, **kw), dtype)
    refs = attention.flash_attention_bwd_plain(q0, k0, v0, do, sink=sink0, **kw)
    assert len(grads) == len(refs)
    for got, ref in zip(grads, refs):
        assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_window_at_least_s_is_causal_on_the_card(gen, dtype):
    from llm_quest_tpu_torch.kernels import attention

    q, k, v = randn(gen, 1, 4, 200, 128, dtype=dtype), randn(gen, 1, 2, 200, 128, dtype=dtype), \
        randn(gen, 1, 2, 200, 128, dtype=dtype)
    causal = attention.flash_attention(q, k, v)
    for w in (200, 1000):
        assert torch.equal(attention.flash_attention(q, k, v, window_size=w), causal)


# K4 at MiMo-V2-Flash's heads (d 64, dv 32), at DeepSeek-V3's MLA (d 96,
# dv 64, causal MHA), and one d = dv case:
# name -> (hq, hkv, sq, sk, q_start, d, dv, features)
DV_CASES = {
    "mla_causal_padding": (12, 12, 300, 300, 0, 96, 64, {"padding": True}),
    "ragged_2045_mla": (12, 12, 2045, 2045, 0, 96, 64, {}),
    "window_sink_padding": (12, 4, 300, 300, 0, 64, 32, {"window_size": 128, "sink": True, "padding": True}),
    "causal_gqa6": (12, 2, 300, 300, 0, 64, 32, {}),
    "ragged_2045_window_sink": (6, 2, 2045, 2045, 0, 64, 32, {"window_size": 128, "sink": True}),
    "ragged_2045_causal": (6, 1, 2045, 2045, 0, 64, 32, {}),
    "window_q_start": (12, 4, 100, 164, 40, 64, 32, {"window_size": 32, "sink": True, "padding": True}),
    "window_q_start_d128": (8, 2, 100, 164, 40, 128, 128, {"window_size": 48}),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DV_CASES)
def test_flash_attention_dv_kernels(gen, dtype, name):
    """K4 with v's head dim 32 beside q/k's 64, forward and backward (dsink
    included), against autograd through the plain version: the SWA layers'
    window and sinks with key padding, the GA layers' causal GQA at group 6,
    the MTP blocks' ragged length (2045: no multiple of the 16-row or 32-key
    tiles) and a window with q_start > 0 (sq < sk, the dk/dv row bound),
    the last also at d = dv = 128; and DeepSeek-V3's MLA pair (96, 64),
    causal MHA with key padding and at the ragged 2045."""
    from llm_quest_tpu_torch.kernels import attention

    hq, hkv, sq, sk, q_start, d, dv, features = DV_CASES[name]
    b = 2 if sq < 1000 else 1
    q0, k0 = randn(gen, b, hq, sq, d, dtype=dtype), randn(gen, b, hkv, sk, d, dtype=dtype)
    v0, do = randn(gen, b, hkv, sk, dv, dtype=dtype), randn(gen, b, hq, sq, dv, dtype=dtype)
    kw = {"q_start": q_start, "window_size": features.get("window_size")}
    if features.get("padding"):
        kw["attn_mask"] = torch.rand(b, sk, generator=gen, device="cuda") > 0.2
        kw["attn_mask"][:, 0] = True
    sink0 = randn(gen, hq, scale=0.5) + 2.0 if features.get("sink") else None
    leaves = [t.clone().requires_grad_() for t in (q0, k0, v0) + (() if sink0 is None else (sink0,))]
    n_fwd, n_bwd = attention.flash_attention.launches, attention.flash_attention_bwd.launches
    out = attention.flash_attention(*leaves[:3], sink=None if sink0 is None else leaves[3], **kw)
    grads = torch.autograd.grad(out, leaves, do)
    assert (attention.flash_attention.launches, attention.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert out.shape == (b, hq, sq, dv) and grads[2].shape == v0.shape and grads[0].dtype == dtype
    assert_close(out, attention.flash_attention(q0, k0, v0, sink=sink0, plain=True, **kw), dtype)
    refs = attention.flash_attention_bwd_plain(q0, k0, v0, do, sink=sink0, **kw)
    assert len(grads) == len(refs)
    for got, ref in zip(grads, refs):
        assert_close(got, ref, dtype)


def test_flash_attention_refuses_unsupported_head_dim_pairs(gen):
    """The (d, dv) pairs without a kernel instantiation raise a ValueError
    naming the pairs that have one, before any launch."""
    from llm_quest_tpu_torch.kernels import attention

    n = attention.flash_attention.launches
    for d, dv in ((64, 48), (128, 64), (192, 128), (32, 32)):
        q, v = randn(gen, 1, 2, 40, d), randn(gen, 1, 2, 40, dv)
        with pytest.raises(ValueError, match=r"kernel head dims \(d, dv\) are \[\(64, 32\)"):
            attention.flash_attention(q, q, v)
    assert attention.flash_attention.launches == n


def test_forward_only_kernels_raise_under_grad(gen):
    """K2 and K9 have no backward: on the card they refuse to run when a
    gradient would be needed, and run under no_grad."""
    from llm_quest_tpu_torch.kernels import fused_mha, gdn

    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 1, 2, 8, torch.float32)
    x = randn(gen, 1, 8, 2 * 64)
    stacked = randn(gen, 2, 1, 2, 128, 128, scale=0.1)
    calls = {
        "K2": lambda g: gdn.gated_delta_rule_step_stacked(
            q[:, :, 0].clone().requires_grad_(g), k[:, :, 0], v[:, :, 0], beta[..., 0], alpha[..., 0], stacked, 0
        ),
        "K9": lambda g: fused_mha.packed_mha_int8_inkernel(x.clone().requires_grad_(g), x, x, 2, (0.02, 0.02)),
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)


# (heads, d) of the packed kernels: ViT-B's 12 x 64, TinyViT's 8 x 32, 2 x 128
PACKED_HEADS = [(12, 64), (8, 32), (2, 128)]


def int8_scales(q, k):
    return float(q.float().abs().max()) / 127.0, float(k.float().abs().max()) / 127.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [20, 197, 512])
@pytest.mark.parametrize("heads, d", PACKED_HEADS)
@pytest.mark.parametrize("mode", ["dynamic", "static", "inkernel"])
def test_packed_mha_int8_kernels(gen, dtype, s, heads, d, mode):
    """K8 (dynamic and static scales) and K9 against their plain versions;
    K9 equal to K8 with the same static scales, bit for bit."""
    from llm_quest_tpu_torch.kernels import fused_mha

    q, k, v = (randn(gen, 2, s, heads * d, dtype=dtype) for _ in range(3))
    ss = None if mode == "dynamic" else int8_scales(q, k)
    n8, n9 = fused_mha.packed_mha_int8.launches, fused_mha.packed_mha_int8_inkernel.launches
    if mode == "inkernel":
        got = fused_mha.packed_mha_int8_inkernel(q, k, v, heads, ss)
        assert fused_mha.packed_mha_int8_inkernel.launches == n9 + 1
        torch.cuda.synchronize()
        assert torch.equal(got, fused_mha.packed_mha_int8(q, k, v, heads, static_scales=ss))
        ref = fused_mha.packed_mha_int8_inkernel(q, k, v, heads, ss, plain=True)
    else:
        got = fused_mha.packed_mha_int8(q, k, v, heads, static_scales=ss)
        assert fused_mha.packed_mha_int8.launches == n8 + 1
        ref = fused_mha.packed_mha_int8(q, k, v, heads, static_scales=ss, plain=True)
    assert got.dtype == dtype
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_packed_mha_kernel_d32(gen, dtype):
    from llm_quest_tpu_torch.kernels import attention

    q, k, v = (randn(gen, 4, 65, 8 * 32, dtype=dtype) for _ in range(3))
    n = attention.packed_mha.launches
    got = attention.packed_mha(q, k, v, 8)
    assert attention.packed_mha.launches == n + 1
    assert_close(got, attention.packed_mha(q, k, v, 8, plain=True), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["k7", "k8_dynamic", "k8_static"])
def test_packed_backward(gen, dtype, kernel):
    """K7's recompute and K8's straight-through backward: the kernel forward,
    and gradients against autograd through the plain packed sdpa."""
    from llm_quest_tpu_torch.kernels import attention, fused_mha

    q, k, v, do = (randn(gen, 2, 197, 12 * 64, dtype=dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if kernel == "k7":
        counter, out = attention.packed_mha, lambda: attention.packed_mha(*leaves, 12)
    else:
        ss = int8_scales(q, k) if kernel == "k8_static" else None
        counter, out = fused_mha.packed_mha_int8, lambda: fused_mha.packed_mha_int8(*leaves, 12, static_scales=ss)
    n = counter.launches
    grads = torch.autograd.grad(out(), leaves, do)
    assert counter.launches == n + 1
    for got, ref in zip(grads, attention.packed_mha_bwd_plain(q, k, v, do, 12)):
        assert_close(got, ref, dtype)


def test_packed_wrappers_raise_on_unsupported_shapes(gen):
    """d 96 (128 % d != 0) and h·d % 128 != 0 are refused by K7, K8 and K9."""
    from llm_quest_tpu_torch.kernels import attention, fused_mha

    for heads, d in ((4, 96), (3, 64)):
        x = randn(gen, 1, 8, heads * d)
        calls = (lambda: attention.packed_mha(x, x, x, heads), lambda: fused_mha.packed_mha_int8(x, x, x, heads),
                 lambda: fused_mha.packed_mha_int8_inkernel(x, x, x, heads, (0.02, 0.02)))
        for call in calls:
            with pytest.raises(ValueError):
                call()


@pytest.mark.parametrize("mode", ["k7", "dynamic", "static", "inkernel"])
def test_vit_through_kernels_matches_plain(gen, mode):
    """A 2-layer ViT at ViT-B's widths through each packed kernel against the
    plain versions, fp32, one launch a layer: logits within 2e-4 relative
    through K7; within 2e-3 absolute through K8/K9, since the second layer's
    q and k differ between the runs in the last fp32 bits, which moves a few
    of their int8 roundings by one."""
    from llm_quest_tpu_torch.config import VIT_BASE_CONFIG
    from llm_quest_tpu_torch.kernels import attention, fused_mha
    from llm_quest_tpu_torch.models import vit

    cfg = dict(VIT_BASE_CONFIG, n_layers=2, drop_rate=0.0, dtype=torch.float32)
    model = vit.init(cfg, generator=gen, device="cuda")
    x = randn(gen, 4, 3, 224, 224)
    if mode != "k7":
        cfg["int8_scores"] = True
    if mode in ("static", "inkernel"):
        cfg["int8_qk_scales"] = vit.calibrate_int8_scales(model, cfg, x)
    if mode == "inkernel":
        cfg["int8_scores_mode"] = "inkernel"
    counter = {"k7": attention.packed_mha, "dynamic": fused_mha.packed_mha_int8,
               "static": fused_mha.packed_mha_int8, "inkernel": fused_mha.packed_mha_int8_inkernel}[mode]
    n = counter.launches
    with torch.inference_mode():
        got = vit.apply(model, cfg, x)
        assert counter.launches == n + 2
        ref = vit.apply(model, dict(cfg, use_kernels=False), x)
    if mode == "k7":
        assert_close(got, ref, torch.float32)
    else:
        assert float((got - ref).abs().max()) <= 2e-3


TINY_QWEN3 = {
    "vocab_size": 256, "emb_dim": 64, "hidden_dim": 128, "n_layers": 2, "n_heads": 4, "num_kv_groups": 2,
    "head_dim": 64, "rope_base": 1_000_000, "context_length": 128, "tie_embeddings": True,
    "model_type": "dense", "flash_min_seq": 16, "dtype": torch.float32,
}


def _tiny_batch(gen, b=2, s=64):
    ids = torch.randint(0, TINY_QWEN3["vocab_size"], (b, s), generator=gen, device="cuda")
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask[1, -9:] = False
    return {"input_ids": ids, "targets": torch.where(mask, torch.roll(ids, -1, 1), -100), "attn_mask": mask}


@pytest.mark.parametrize("policy", ["none", "full", "dots"])
def test_qwen3_gradients_through_kernels(gen, policy):
    """Dense Qwen3 loss gradients through the flash kernels (with each remat
    policy) against the plain versions, fp32."""
    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.models import qwen3
    from llm_quest_tpu_torch.training import engine

    cfg = dict(TINY_QWEN3, gradient_checkpointing=policy != "none", remat_policy=policy)
    model = qwen3.init(cfg, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    batch = _tiny_batch(gen)
    n_bwd = attention.flash_attention_bwd.launches
    grads = {}
    for use_kernels in (True, False):
        loss = engine.make_loss_fn(qwen3, dict(cfg, use_kernels=use_kernels), fused_head_ce=True)(model, batch)
        grads[use_kernels] = torch.autograd.grad(loss, list(model.parameters()))
    assert attention.flash_attention_bwd.launches == n_bwd + cfg["n_layers"]
    for got, ref in zip(grads[True], grads[False]):
        assert_close(got, ref, torch.float32)


@pytest.mark.parametrize("capacity", [None, 1.25])
def test_qwen3_next_gradients_through_kernels(gen, capacity):
    """Qwen3-Next loss gradients through K1 and K4 (forward and backward)
    against the plain versions, fp32, exact and capacity dispatch."""
    from llm_quest_tpu_torch.config import QWEN3_NEXT_SMALL_CONFIG
    from llm_quest_tpu_torch.kernels import attention, gdn
    from llm_quest_tpu_torch.models import qwen3_next
    from llm_quest_tpu_torch.training import engine

    cfg = dict(
        QWEN3_NEXT_SMALL_CONFIG, n_layers=4, emb_dim=64, n_heads=2, num_kv_groups=1, head_dim=64,
        linear_num_qk_heads=1, linear_num_value_heads=2, linear_qk_head_dim=64, linear_value_head_dim=64,
        moe_hidden_dim=96, shared_expert_hidden_dim=96, num_experts=4, vocab_size=256, context_length=128,
        p_dropout=0.0, flash_min_seq=16, dtype=torch.float32, moe_capacity_factor=capacity,
    )
    model = qwen3_next.init(cfg, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    batch = _tiny_batch(gen)
    n = gdn.gated_delta_rule_bwd.launches, attention.flash_attention_bwd.launches
    grads = {}
    for use_kernels in (True, False):
        loss = engine.make_loss_fn(qwen3_next, dict(cfg, use_kernels=use_kernels), fused_head_ce=True)(model, batch)
        grads[use_kernels] = torch.autograd.grad(loss, list(model.parameters()))
    assert (gdn.gated_delta_rule_bwd.launches, attention.flash_attention_bwd.launches) == (n[0] + 3, n[1] + 1)
    for got, ref in zip(grads[True], grads[False]):
        assert_close(got, ref, torch.float32)


def test_gemma3_gradients_through_kernels(gen):
    """Gemma-3 loss gradients through K4 with the window on the SWA layers
    (2 of 3) against the plain versions, fp32, padded batch."""
    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.models import gemma3
    from llm_quest_tpu_torch.training import engine

    cfg = {
        "vocab_size": 256, "context_length": 128, "emb_dim": 64, "n_heads": 4, "n_layers": 3, "num_kv_groups": 1,
        "head_dim": 64, "hidden_dim": 128, "rope_base": 10_000, "window_size": 24, "local_global_att_ratio": 2,
        "flash_min_seq": 16, "dtype": torch.float32,
    }
    model = gemma3.init(cfg, generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    batch = _tiny_batch(gen)
    n, n_win = attention.flash_attention_bwd.launches, attention.flash_attention_bwd.window_launches
    grads = {}
    for use_kernels in (True, False):
        loss = engine.make_loss_fn(gemma3, dict(cfg, use_kernels=use_kernels))(model, batch)
        grads[use_kernels] = torch.autograd.grad(loss, list(model.parameters()))
    assert (attention.flash_attention_bwd.launches, attention.flash_attention_bwd.window_launches) == (n + 3, n_win + 2)
    for got, ref in zip(grads[True], grads[False]):
        assert_close(got, ref, torch.float32)


def test_mimo_gradients_through_kernels(gen):
    """A tiny MiMo-V2-Flash (d 64 / dv 32, GA / SWA + sinks / GA, MTP depth
    2): the loss and every gradient through K4 (3 main layers and 2 MTP
    blocks, 3 of them windowed) against the plain versions, fp32; then a
    train step folds the expert counts into the biases."""
    from llm_quest_tpu_torch.config import MIMO_V2_SMALL_CONFIG
    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.models import mimo_v2_flash as mimo
    from llm_quest_tpu_torch.training import engine, mtp_engine

    cfg = dict(MIMO_V2_SMALL_CONFIG, vocab_size=256, context_length=128, emb_dim=96, n_layers=3, n_heads=6,
               num_swa_kv_groups=2, num_ga_kv_groups=1, hidden_dim=128, window_size=24, hybrid_ratio=3,
               num_experts=4, flash_min_seq=16)
    model = mimo.init(cfg, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    batch = {k: v for k, v in _tiny_batch(gen).items() if k != "attn_mask"}
    n, n_win = attention.flash_attention_bwd.launches, attention.flash_attention_bwd.window_launches
    results = {}
    for use_kernels in (True, False):
        loss, _ = mimo.loss(model, dict(cfg, use_kernels=use_kernels), batch["input_ids"], batch["targets"])
        results[use_kernels] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert (attention.flash_attention_bwd.launches, attention.flash_attention_bwd.window_launches) == (n + 5, n_win + 3)
    assert_close(results[True][0], results[False][0], torch.float32)
    for got, ref in zip(results[True][1], results[False][1]):
        assert_close(got, ref, torch.float32)
    opt = engine.make_optimizer(1e-3)
    mtp_engine.make_mimo_train_step(mimo, cfg, opt)(model, opt.init(model), batch)
    assert all(float(b.moe.biases.abs().max()) == pytest.approx(1e-3) for b in model.blocks[1:])


def test_deepseek_gradients_through_kernels(gen):
    """A tiny DeepSeek-V3 at the small config's head dims (4 heads of 64, so
    MLA's q/k 96 and v 64; 3 layers, 1 dense, MTP depth 2, a batch from the
    MTP collator): the loss and every gradient through K4 (3 main layers and
    2 MTP blocks, each at the full length) against the plain versions, fp32;
    then a train step folds the expert counts into the biases."""
    from llm_quest_tpu_torch.config import DEEPSEEK_SMALL_CONFIG
    from llm_quest_tpu_torch.data.datasets import collate_function_mtp
    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.models import deepseek_v3 as dsv3
    from llm_quest_tpu_torch.training import engine, mtp_engine

    cfg = dict(DEEPSEEK_SMALL_CONFIG, vocab_size=256, context_length=128, emb_dim=256, n_heads=4, n_layers=3,
               num_ffn=1, hidden_dim=256, q_rank=128, num_experts=5, flash_min_seq=16)
    model = dsv3.init(cfg, generator=torch.Generator(device="cuda").manual_seed(6), device="cuda")
    rows = torch.randint(1, 256, (2, 96), generator=gen, device="cuda").tolist()
    batch = collate_function_mtp([rows[0], rows[1][:80]], cfg["mtp_depth"], pad_token_id=0)
    b = engine._as_tensors(batch, torch.device("cuda"))
    args = (b["input_ids"], b["targets"], b["shifted_inputs"], b["shifted_targets"])
    n, n_fwd = attention.flash_attention_bwd.launches, attention.flash_attention.launches
    results = {}
    for use_kernels in (True, False):
        loss, _ = dsv3.loss(model, dict(cfg, use_kernels=use_kernels), *args)
        results[use_kernels] = (loss.detach(), torch.autograd.grad(loss, list(model.parameters())))
    assert (attention.flash_attention.launches, attention.flash_attention_bwd.launches) == (n_fwd + 5, n + 5)
    assert_close(results[True][0], results[False][0], torch.float32)
    for got, ref in zip(results[True][1], results[False][1]):
        assert_close(got, ref, torch.float32)
    opt = engine.make_optimizer(1e-3)
    mtp_engine.make_deepseek_train_step(dsv3, cfg, opt)(model, opt.init(model), batch)
    assert all(float(b.moe.biases.abs().max()) == pytest.approx(1e-3) for b in model.blocks[1:])


def test_training_eval_loop_and_prefetch_on_the_card(gen):
    from llm_quest_tpu_torch.data.prefetch import prefetch_to_device
    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.models import qwen3
    from llm_quest_tpu_torch.training import engine

    batches = [{k: v.cpu().numpy() for k, v in _tiny_batch(gen).items()} for _ in range(3)]
    moved = list(prefetch_to_device(iter(batches), device="cuda"))
    for got, ref in zip(moved, batches):
        for k in ref:
            assert got[k].is_cuda and (got[k].cpu().numpy() == ref[k]).all()
    model = qwen3.init(TINY_QWEN3, generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    n_bwd = attention.flash_attention_bwd.launches
    _, train_losses, val_losses = engine.training_eval_loop(
        qwen3, TINY_QWEN3, model, batches, batches[:1], num_epoch=2, peak_lr=3e-3, eval_freq=2, eval_iter=3,
        log=lambda _: None,
    )
    assert attention.flash_attention_bwd.launches == n_bwd + 6 * TINY_QWEN3["n_layers"]
    assert len(train_losses) == 4 and all(map(torch.isfinite, torch.tensor(train_losses + val_losses)))
    assert train_losses[-1] < train_losses[0]


def test_wrappers_raise_on_unsupported_shapes(gen):
    from llm_quest_tpu_torch.kernels import attention, flash_decode, gdn, quantized_gmm

    q = randn(gen, 1, 2, 4, 96)  # dk = 96: the GDN prefill takes 64 and 128
    with pytest.raises(ValueError):
        gdn.gated_delta_rule_fwd(q, q, q, q[..., 0], q[..., 0])
    with pytest.raises(ValueError):  # the decode step takes dk 64 and 128
        gdn.gated_delta_rule_step_stacked(q[:, :, 0], q[:, :, 0], q[:, :, 0], q[..., 0, 0], q[..., 0, 0],
                                          randn(gen, 1, 1, 2, 96, 96), 0)
    x = randn(gen, 1, 4, 2 * 48)  # head dim 48 has no instantiation
    with pytest.raises(ValueError):
        attention.packed_mha(x, x, x, 2)
    kq = torch.zeros(1, 2, 8, 64, dtype=torch.int8, device="cuda")  # K10 takes d 128 and 256
    ks, bias = randn(gen, 1, 2, 8), randn(gen, 1, 8)
    with pytest.raises(ValueError):
        flash_decode.flash_decode(randn(gen, 1, 4, 1, 64), kq, ks, kq, ks, bias)
    w_q = torch.zeros(2, 32, 24, dtype=torch.int8, device="cuda")  # K11 takes N % 16 == 0
    with pytest.raises(ValueError):
        quantized_gmm.quantized_ragged_dot(randn(gen, 4, 32), w_q, randn(gen, 2, 24),
                                           torch.tensor([1, 3], device="cuda"))


def int8_cache_inputs(gen, b, hq, hkv, s_len, d, dtype):
    """q and an int8 KV cache layer as the model writes it (a (L, b, hkv,
    S, d) buffer and its layer view), with a random key mask as the bias."""
    from llm_quest_tpu_torch.inference import cache as kv_cache
    from llm_quest_tpu_torch.ops.masks import mask_value

    cache = kv_cache.init_kv_cache(2, b, hkv, s_len, d, quant="int8", device="cuda")
    _, k, v = kv_cache.write_layer(cache, 1, randn(gen, b, hkv, s_len, d, dtype=dtype),
                                   randn(gen, b, hkv, s_len, d, dtype=dtype), 0)
    valid = torch.rand(b, s_len, generator=gen, device="cuda") > 0.3
    valid[:, 0] = True
    bias = torch.where(valid, 0.0, mask_value(torch.float32)).float()
    return randn(gen, b, hq, 1, d, dtype=dtype), k, v, bias


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("shape", [(1, 8, 2, 96), (3, 4, 4, 75), (2, 16, 2, 1000), (1, 8, 8, 1)])
def test_flash_decode_kernel(gen, dtype, d, shape):
    """K10 against its plain version: one or many splits, a ragged tail, GQA
    groups 1 to 8, one key."""
    from llm_quest_tpu_torch.kernels import flash_decode

    b, hq, hkv, s_len = shape
    q, k, v, bias = int8_cache_inputs(gen, b, hq, hkv, s_len, d, dtype)
    n = flash_decode.flash_decode.launches
    got = flash_decode.flash_decode(q, k.data, k.scale, v.data, v.scale, bias)
    assert flash_decode.flash_decode.launches == n + 1
    ref = flash_decode.flash_decode(q, k.data, k.scale, v.data, v.scale, bias, plain=True)
    assert got.dtype == dtype and got.shape == (b, hq, 1, d)
    assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sizes", [[0, 3, 0, 5], [1, 0, 2, 1, 0, 3, 1, 0], [300, 0, 257, 43]])
@pytest.mark.parametrize("k, n", [(96, 160), (64, 48)])
def test_quantized_gmm_kernel(gen, dtype, sizes, k, n):
    """K11 against its plain version: empty experts, ragged groups, both row
    tilings (few rows and many), a K that is not a multiple of 64."""
    from llm_quest_tpu_torch.kernels import quantized_gmm

    e = len(sizes)
    x = randn(gen, sum(sizes), k, dtype=dtype)
    w_q = torch.randint(-127, 128, (e, k, n), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(e, n, generator=gen, device="cuda") * 0.02 + 0.001
    gs = torch.tensor(sizes, device="cuda")
    cnt = quantized_gmm.quantized_ragged_dot.launches
    got = quantized_gmm.quantized_ragged_dot(x, w_q, scale, gs)
    assert quantized_gmm.quantized_ragged_dot.launches == cnt + 1
    assert_close(got, quantized_gmm.quantized_ragged_dot(x, w_q, scale, gs, plain=True), dtype)


def test_int8_serving_through_kernels_matches_plain(gen):
    """A small int8 Qwen3-Next (int8 linears, experts and KV cache) and an
    int8 Qwen3.5 text model at head dim 256 decode the same greedy tokens
    through the kernels (K1, K2 at dk 64 and 128, K10, K11) as through the
    plain versions, fp32."""
    from llm_quest_tpu_torch.config import QWEN3_5_08B_CONFIG, QWEN3_NEXT_SMALL_CONFIG
    from llm_quest_tpu_torch.inference import generate
    from llm_quest_tpu_torch.kernels import flash_decode, gdn, quantized_gmm
    from llm_quest_tpu_torch.models import qwen3_5, qwen3_next
    from llm_quest_tpu_torch.ops.quantization import quantize_params_int8

    nxt = dict(QWEN3_NEXT_SMALL_CONFIG, n_layers=4, emb_dim=128, moe_hidden_dim=128, shared_expert_hidden_dim=128,
               vocab_size=256, dtype=torch.float32, kv_quant="int8")
    txt = dict(QWEN3_5_08B_CONFIG, n_layers=4, emb_dim=256, hidden_dim=256, vocab_size=256, dtype=torch.float32,
               kv_quant="int8")
    ids = torch.randint(0, 256, (2, 40), generator=gen, device="cuda")
    for mod, entry, cfg, launched in ((qwen3_next, qwen3_next, nxt, quantized_gmm.quantized_ragged_dot),
                                      (qwen3_5, qwen3_5.TextOnly, txt, flash_decode.flash_decode)):
        init = mod.init if mod is qwen3_next else mod.init_text
        model = quantize_params_int8(init(cfg, generator=torch.Generator(device="cuda").manual_seed(4), device="cuda"),
                                     min_size=0, quantize_embeddings=mod is qwen3_5)
        counts = launched.launches, gdn.gated_delta_rule_step_stacked.launches
        seqs = [generate.generate_kv_cache(entry, model, dict(cfg, use_kernels=k), ids, max_gen=8, eos_ids=-1,
                                           pad_id=0)["sequences"] for k in (True, False)]
        assert launched.launches > counts[0] and gdn.gated_delta_rule_step_stacked.launches > counts[1]
        assert torch.equal(seqs[0], seqs[1])
