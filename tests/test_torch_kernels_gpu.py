"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips when no CUDA device is present (the kernels
are compiled by nvcc for sm_90a and have no CPU or interpret mode). On a
machine with an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Tolerances on max |kernel - plain| relative to max(1, max |plain|): fp32 2e-4
(both compute in fp32, in another summation order), bf16 2e-2 (bf16 inputs
and outputs round once more; K4, K5 and K7 take bf16 inputs to their
tensor-core kernels, which also round p and ds to bf16 before their
products, and each of their cases asserts which route its launches took).
The flash backward's gradients are held to
autograd through the plain forward with the same tolerances, and K1's
backward to its plain version (the per-chunk replay) on the same anchors;
K1 in bf16 takes the chunked tensor-core kernels (its cases assert
``tc_launches``) and is also held per 64-token tile at the hybrid step's
shape.
K12 (bf16 or int8 scores, no fp32 form) has its own, ``attn_core.py::
k12_tolerance``: bf16 within one bf16 unit of max |plain|; int8 each output
within one bf16 unit of its plain value plus the fp32 summation bound of
p·(v + t); and hand-computed roundings bit for bit.
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


def tc_counts():
    """The tensor-core launch counts of K4 (forward, backward), K5 (forward,
    backward), K6 (forward, backward) and K7 (forward, backward)."""
    from llm_quest_tpu_torch.kernels import attention as a
    from llm_quest_tpu_torch.kernels import fused_mha as f

    return (a.flash_attention.tc_launches, a.flash_attention_bwd.tc_launches, a.flash_attention_with_lse.tc_launches,
            a.flash_attention_with_lse.tc_bwd_launches, f.fused_mha.tc_launches, f.fused_mha.tc_bwd_launches,
            a.packed_mha.tc_launches, a.packed_mha.tc_bwd_launches)


def assert_tc_moved(before, dtype, k4=0, k4_bwd=0, k5=0, k5_bwd=0, k6=0, k6_bwd=0, k7=0, k7_bwd=0):
    """bf16 launches went to the tensor-core kernels (the counts moved by the
    launches made), fp32 launches to the SIMT kernels (no count moved)."""
    moved = (k4, k4_bwd, k5, k5_bwd, k6, k6_bwd, k7, k7_bwd) if dtype == torch.bfloat16 else (0,) * 8
    assert tc_counts() == tuple(n + m for n, m in zip(before, moved))


# bf16 results of the short-sequence kernels at s >= 128 are also held tile
# by tile: ||kernel - plain|| / ||plain|| over each 64-row tile of the
# sequence axis within TILE_TOL (chip_smoke.py's bar). TOL's bar scales with
# max |plain|, which late causal rows are far below. Their plain version runs
# in fp32 on the same bf16 values: in bf16 it rounds p before p·V, and at s
# 257, causal, its dk tile of the one last key was 3.4% off an fp64 reference
# on the card, where the kernel's was 0.74%.
TILE_TOL = 2e-2


def f32(*tensors):
    """fp32 copies of the inputs, for the plain version as the reference."""
    return [t.float() for t in tensors]


def assert_tiles_close(got, ref):
    """(..., s, w) results, tile by tile along s (64 rows)."""
    torch.cuda.synchronize()
    diff, ref = got.float() - ref.float(), ref.float()
    pad = (-ref.shape[-2]) % 64
    tiles = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad)).unflatten(-2, (-1, 64)).square().sum((-2, -1))  # noqa: E731
    err = float((tiles(diff) / tiles(ref).clamp_min(torch.finfo(torch.float32).tiny)).sqrt().max())
    assert err <= TILE_TOL, err


def assert_short_close(got, ref, dtype, s):
    """The short-sequence kernels' bar: TOL, and at s >= 128 in bf16 TILE_TOL."""
    assert_close(got, ref, dtype)
    if dtype == torch.bfloat16 and s >= 128:
        assert_tiles_close(got, ref)


def gdn_inputs(gen, b, h, s, dtype, dk=128, dv=128):
    from llm_quest_tpu_torch.ops.gdn import l2_norm_clamp

    q = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    k = l2_norm_clamp(randn(gen, b, h, s, dk)).to(dtype)
    v = randn(gen, b, h, s, dv, dtype=dtype)
    beta = torch.sigmoid(randn(gen, b, h, s))
    alpha = torch.sigmoid(randn(gen, b, h, s, scale=0.3) + 2.0)
    return q, k, v, beta, alpha, randn(gen, b, h, dv, dk, scale=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 37, 156, 300])
@pytest.mark.parametrize("dk, dv", [(64, 64), (128, 128), (64, 128)])
@pytest.mark.parametrize("with_prev", [False, True])
def test_gdn_prefill_kernel(gen, dtype, s, dk, dv, with_prev):
    """K1's forward against the plain chunked form; a bf16 call takes the
    chunked tensor-core kernels (``tc_launches``), an fp32 one the scan."""
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 4, s, dtype, dk=dk, dv=dv)
    prev = s0 if with_prev else None
    n, tc = gdn.gated_delta_rule_fwd.launches, gdn.gated_delta_rule_fwd.tc_launches
    out, st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, prev)
    assert gdn.gated_delta_rule_fwd.launches == n + 1
    assert gdn.gated_delta_rule_fwd.tc_launches == tc + (dtype == torch.bfloat16)
    ref_out, ref_st = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, prev, plain=True)
    assert_close(out, ref_out, dtype)
    assert_close(st, ref_st, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dk, dv", [(64, 64), (128, 128), (64, 128)])
@pytest.mark.parametrize("s", [20, 37, 300])
@pytest.mark.parametrize("with_prev", [False, True])
def test_gdn_prefill_backward_kernel(gen, dtype, dk, dv, s, with_prev):
    """K1's backward against the plain per-chunk replay on the kernel's own
    anchors (every 32 tokens in fp32, every 64 in bf16; s = 300 ends in a
    partial chunk), then the autograd Function against autograd through the
    plain chunked forward; bf16 calls take the tensor-core kernels."""
    from llm_quest_tpu_torch.kernels import gdn

    c = gdn.anchor_chunk(dtype)
    q, k, v, beta, alpha, s0 = gdn_inputs(gen, 2, 4, s, dtype, dk=dk, dv=dv)
    prev = s0 if with_prev else None
    d_out = randn(gen, 2, 4, s, dv, dtype=dtype)
    d_state = randn(gen, 2, 4, dv, dk)
    out, st, anchors = gdn._launch_fwd(q, k, v, beta, alpha, prev, anchor_chunk=c)
    _, _, ref_anchors = gdn.gated_delta_rule_fwd_plain(q, k, v, beta, alpha, prev, chunk_size=c, with_anchors=True)
    assert isinstance(anchors, gdn.TcAnchors) == (dtype == torch.bfloat16)
    assert_close(gdn.anchor_states(anchors), ref_anchors, dtype)
    n, tc = gdn.gated_delta_rule_bwd.launches, gdn.gated_delta_rule_bwd.tc_launches
    got = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=c)
    assert gdn.gated_delta_rule_bwd.launches == n + 1
    assert gdn.gated_delta_rule_bwd.tc_launches == tc + (dtype == torch.bfloat16)
    ref = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, d_state, chunk_size=c, plain=True)
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


def test_gdn_tc_tiles_at_the_hybrid_shape(gen):
    """bf16 K1 at the hybrid train step's shape (b 4, h 8, s 2048, dk = dv =
    64): the output and the five gradients of the tensor-core kernels
    against the plain versions per 64-token tile (TILE_TOL), and two
    backward runs bit for bit."""
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha, _ = gdn_inputs(gen, 4, 8, 2048, torch.bfloat16, dk=64, dv=64)
    d_out = randn(gen, 4, 8, 2048, 64, dtype=torch.bfloat16)
    out, _, anchors = gdn._launch_fwd(q, k, v, beta, alpha, None, anchor_chunk=gdn.TC_CHUNK)
    ref_out, _ = gdn.gated_delta_rule_fwd(q, k, v, beta, alpha, plain=True)
    assert_tiles_close(out, ref_out)
    got = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=gdn.TC_CHUNK)
    again = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=gdn.TC_CHUNK)
    ref = gdn.gated_delta_rule_bwd(q, k, v, beta, alpha, anchors, d_out, None, chunk_size=gdn.TC_CHUNK, plain=True)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g, r in zip(got[:5], ref):
        assert_tiles_close(g if g.dim() == 4 else g[..., None], r if r.dim() == 4 else r[..., None])


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
    tc = tc_counts()
    for m in (None, mask):
        got = attention.flash_attention(q, k, v, attn_mask=m, q_start=q_start)
        assert_close(got, attention.flash_attention(q, k, v, attn_mask=m, q_start=q_start, plain=True), dtype)
    assert_tc_moved(tc, dtype, k4=2)


# sequence lengths of the short-sequence kernels (K6, K7): one 16-key step,
# a partial one, TinyViT's 65, ViT-B's 197, one whole 256-key chunk and one
# key past it, the causal fallback's 300, fused_mha_max_seq
SHORT_SEQS = [2, 17, 65, 197, 256, 257, 300, 512]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", SHORT_SEQS + [576])
@pytest.mark.parametrize("heads, d", [(8, 32), (12, 64), (2, 128)])
def test_packed_mha_kernel(gen, dtype, s, heads, d):
    """K7 at each head dim and at ViT lengths on both sides of a 64-key tile
    and a 256-key chunk, and the lse its forward keeps for the backward."""
    from llm_quest_tpu_torch.kernels import attention

    q, k, v = (randn(gen, 2, s, heads * d, dtype=dtype) for _ in range(3))
    tc = tc_counts()
    got = attention.packed_mha(q, k, v, heads)
    out, lse = attention._packed_fwd(q, k, v, heads, d**-0.5, with_lse=True)
    assert_tc_moved(tc, dtype, k7=2)
    ref = attention.packed_mha(*f32(q, k, v), heads, plain=True)
    assert_short_close(got, ref, dtype, s)
    assert_short_close(out, ref, dtype, s)
    assert_close(lse, attention.packed_mha_lse_plain(q, k, heads), torch.float32)


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
    n_fwd, n_bwd, tc = attention.flash_attention.launches, attention.flash_attention_bwd.launches, tc_counts()
    out = attention.flash_attention(q, k, v, attn_mask=mask)
    out.backward(do)
    assert (attention.flash_attention.launches, attention.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert_tc_moved(tc, dtype, k4=1, k4_bwd=1)
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
    tc = tc_counts()
    for delta_shift in (None, shift):
        o = attention.flash_attention(q, k, v, attn_mask=mask, q_start=40)
        lse = attention._plain_lse(q, k, mask, True, 40, 128**-0.5)
        got = attention.flash_attention_bwd(q, k, v, o, lse, do, attn_mask=mask, q_start=40, delta_shift=delta_shift)
        ref = attention.flash_attention_bwd(
            q, k, v, o, lse, do, attn_mask=mask, q_start=40, delta_shift=delta_shift, plain=True
        )
        for g, r in zip(got, ref):
            assert_close(g, r, dtype)
    assert_tc_moved(tc, dtype, k4=2, k4_bwd=2)


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
    n_fwd, n_bwd, tc = attention.flash_attention.launches, attention.flash_attention_bwd.launches, tc_counts()
    out = attention.flash_attention(*leaves[:3], sink=None if sink0 is None else leaves[3], **kw)
    grads = torch.autograd.grad(out, leaves, do)
    assert (attention.flash_attention.launches, attention.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert_tc_moved(tc, dtype, k4=1, k4_bwd=1)
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
# dv 64, causal MHA), and one d = dv case; then the cases that reach the edges
# of the tensor-core kernels (csrc/attention_tc.cu): query counts on both sides
# of a 64-row tile (1, 63, 64, 65, 300, 1000), sk > sq with q_start, every
# (d, dv) pair at GQA groups 1, 2 and 8, a window inside one 64-key tile and
# one straddling tile edges, softcap, sinks, padded keys, and a transposed
# (b, s, h, d) view: name -> (hq, hkv, sq, sk, q_start, d, dv, features)
DV_CASES = {
    "mla_causal_padding": (12, 12, 300, 300, 0, 96, 64, {"padding": True}),
    "ragged_2045_mla": (12, 12, 2045, 2045, 0, 96, 64, {}),
    "window_sink_padding": (12, 4, 300, 300, 0, 64, 32, {"window_size": 128, "sink": True, "padding": True}),
    "causal_gqa6": (12, 2, 300, 300, 0, 64, 32, {}),
    "ragged_2045_window_sink": (6, 2, 2045, 2045, 0, 64, 32, {"window_size": 128, "sink": True}),
    "ragged_2045_causal": (6, 1, 2045, 2045, 0, 64, 32, {}),
    "window_q_start": (12, 4, 100, 164, 40, 64, 32, {"window_size": 32, "sink": True, "padding": True}),
    "window_q_start_d128": (8, 2, 100, 164, 40, 128, 128, {"window_size": 48}),
    **{f"sq{sq}": (4, 2, sq, sq, 0, 128, 128, {}) for sq in (1, 63, 64, 65, 300, 1000)},
    "sk_gt_sq_q_start": (4, 2, 100, 356, 256, 128, 128, {"padding": True}),
    **{f"d{d}_dv{dv}_group{g}": (8, 8 // g, 300, 300, 0, d, dv, {})
       for d, dv in ((64, 64), (128, 128), (256, 256), (64, 32), (96, 64)) for g in (1, 2, 8)},
    "window_in_tile": (4, 2, 300, 300, 0, 64, 64, {"window_size": 17}),
    "window_straddles_tiles": (4, 2, 300, 300, 0, 128, 128, {"window_size": 100}),
    "softcap": (4, 1, 300, 300, 0, 128, 128, {"softcap": 20.0}),
    "sinks": (4, 2, 300, 300, 0, 64, 32, {"sink": True}),
    "padded_keys": (4, 2, 300, 300, 0, 96, 64, {"padding": True}),
    "transposed_view": (4, 2, 300, 300, 0, 128, 128, {"transposed": True}),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DV_CASES)
def test_flash_attention_dv_kernels(gen, dtype, name):
    """K4 forward and backward (dsink included) against autograd through the
    plain version, fp32 on the SIMT kernels and bf16 on the tensor-core
    ones: MiMo-V2-Flash's SWA layers (window and sinks with key padding),
    its GA layers' causal GQA at group 6, the MTP blocks' ragged length (2045:
    no multiple of a row or key tile) and a window with q_start > 0 (sq < sk,
    the dk/dv row bound), the last also at d = dv = 128; DeepSeek-V3's MLA
    pair (96, 64), causal MHA with key padding and at the ragged 2045; and
    the tensor-core kernels' edge cases."""
    from llm_quest_tpu_torch.kernels import attention

    hq, hkv, sq, sk, q_start, d, dv, features = DV_CASES[name]
    b = 2 if sq < 2000 else 1
    if features.get("transposed"):  # (b, s, h, d) storage read as (b, h, s, d)
        q0 = randn(gen, b, sq, hq, d, dtype=dtype).transpose(1, 2)
        k0, v0 = (randn(gen, b, sk, hkv, w, dtype=dtype).transpose(1, 2) for w in (d, dv))
    else:
        q0, k0 = randn(gen, b, hq, sq, d, dtype=dtype), randn(gen, b, hkv, sk, d, dtype=dtype)
        v0 = randn(gen, b, hkv, sk, dv, dtype=dtype)
    do = randn(gen, b, hq, sq, dv, dtype=dtype)
    kw = {"q_start": q_start, "window_size": features.get("window_size"), "softcap": features.get("softcap")}
    if features.get("padding"):
        kw["attn_mask"] = torch.rand(b, sk, generator=gen, device="cuda") > 0.2
        kw["attn_mask"][:, 0] = True
    sink0 = randn(gen, hq, scale=0.5) + 2.0 if features.get("sink") else None
    leaves = [t.clone().requires_grad_() for t in (q0, k0, v0) + (() if sink0 is None else (sink0,))]
    n_fwd, n_bwd, tc = attention.flash_attention.launches, attention.flash_attention_bwd.launches, tc_counts()
    out = attention.flash_attention(*leaves[:3], sink=None if sink0 is None else leaves[3], **kw)
    grads = torch.autograd.grad(out, leaves, do)
    assert (attention.flash_attention.launches, attention.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert_tc_moved(tc, dtype, k4=1, k4_bwd=1)
    assert out.shape == (b, hq, sq, dv) and grads[2].shape == v0.shape and grads[0].dtype == dtype
    assert_close(out, attention.flash_attention(q0, k0, v0, sink=sink0, plain=True, **kw), dtype)
    refs = attention.flash_attention_bwd_plain(q0, k0, v0, do, sink=sink0, **kw)
    assert len(grads) == len(refs)
    for got, ref in zip(grads, refs):
        assert_close(got, ref, dtype)


@pytest.mark.parametrize("d, dv", [(128, 128), (256, 256)])
def test_flash_attention_tensor_core_backward_is_bit_equal(gen, d, dv):
    """Two kernels and no atomics: the bf16 backward repeats to the bit."""
    from llm_quest_tpu_torch.kernels import attention

    q, k, v = randn(gen, 2, 8, 1000, d), randn(gen, 2, 2, 1000, d), randn(gen, 2, 2, 1000, dv)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, randn(gen, 2, 8, 1000, dv)))
    o = attention.flash_attention(q, k, v)
    lse = attention._plain_lse(q, k, None, True, 0, d**-0.5)
    tc = tc_counts()
    first = attention.flash_attention_bwd(q, k, v, o, lse, do)
    second = attention.flash_attention_bwd(q, k, v, o, lse, do)
    assert_tc_moved(tc, torch.bfloat16, k4_bwd=2)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_tensor_core_kernels_refuse_unaligned_strides(gen):
    """The bf16 kernels copy 16-byte chunks: a stride that is no multiple of
    8 elements raises before any launch (fp32 takes it, on the SIMT kernels)."""
    from llm_quest_tpu_torch.kernels import attention

    wide = randn(gen, 1, 2, 40, 68)
    q32, q16 = wide[..., :64], wide.to(torch.bfloat16)[..., :64]  # row stride 68
    n = attention.flash_attention.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        attention.flash_attention(q16, q16, q16)
    assert attention.flash_attention.launches == n
    got = attention.flash_attention(q32, q32, q32)
    assert_close(got, attention.flash_attention(q32, q32, q32, plain=True), torch.float32)


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
    """K7 at TinyViT's shape (s 65, 8 heads of 32): forward, and forward +
    backward against autograd through the plain version."""
    from llm_quest_tpu_torch.kernels import attention

    q, k, v, do = (randn(gen, 4, 65, 8 * 32, dtype=dtype) for _ in range(4))
    n, tc = (attention.packed_mha.launches, attention.packed_mha.bwd_launches), tc_counts()
    got = attention.packed_mha(q, k, v, 8)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(attention.packed_mha(*leaves, 8), leaves, do)
    assert (attention.packed_mha.launches, attention.packed_mha.bwd_launches) == (n[0] + 2, n[1] + 1)
    assert_tc_moved(tc, dtype, k7=2, k7_bwd=1)
    assert_close(got, attention.packed_mha(*f32(q, k, v), 8, plain=True), dtype)
    for g, r in zip(grads, attention.packed_mha_bwd_plain(*f32(q, k, v, do), 8)):
        assert_close(g, r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["k7", "k8_dynamic", "k8_static"])
def test_packed_backward(gen, dtype, kernel):
    """K7's backward (the flash recompute kernels, gradients written in the
    packed layout) and K8's straight-through one: the kernel forward, and
    gradients against autograd through the plain packed sdpa."""
    from llm_quest_tpu_torch.kernels import attention, fused_mha

    q, k, v, do = (randn(gen, 2, 197, 12 * 64, dtype=dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    if kernel == "k7":
        counter, out = attention.packed_mha, lambda: attention.packed_mha(*leaves, 12)
    else:
        ss = int8_scales(q, k) if kernel == "k8_static" else None
        counter, out = fused_mha.packed_mha_int8, lambda: fused_mha.packed_mha_int8(*leaves, 12, static_scales=ss)
    n, n_bwd, tc = counter.launches, attention.packed_mha.bwd_launches, tc_counts()
    grads = torch.autograd.grad(out(), leaves, do)
    assert counter.launches == n + 1
    assert attention.packed_mha.bwd_launches == n_bwd + (kernel == "k7")
    if kernel == "k7":
        assert_tc_moved(tc, dtype, k7=1, k7_bwd=1)
    refs = attention.packed_mha_bwd_plain(*(f32(q, k, v, do) if kernel == "k7" else (q, k, v, do)), 12)
    for got, ref in zip(grads, refs):
        if kernel == "k7":  # per head: the packed (b, s, h·d) gradients as (b, h, s, d)
            assert_short_close(got.unflatten(-1, (12, 64)).transpose(1, 2), ref.unflatten(-1, (12, 64)).transpose(1, 2),
                               dtype, 197)
        else:
            assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", SHORT_SEQS)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_packed_mha_backward(gen, dtype, s, d):
    """K7 forward + backward at each head dim and short length against
    autograd through the plain version (heads · d = 256)."""
    from llm_quest_tpu_torch.kernels import attention

    h = 256 // d
    q, k, v, do = (randn(gen, 2, s, h * d, dtype=dtype) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tc = tc_counts()
    out = attention.packed_mha(*leaves, h)
    grads = torch.autograd.grad(out, leaves, do)
    assert_tc_moved(tc, dtype, k7=1, k7_bwd=1)
    heads = lambda t: t.unflatten(-1, (h, d)).transpose(1, 2)  # noqa: E731
    for got, ref in zip(grads, attention.packed_mha_bwd_plain(*f32(q, k, v, do), h)):
        assert_short_close(heads(got), heads(ref), dtype, s)


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
    b = engine.as_tensors(batch, torch.device("cuda"))
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


# ------------------------------------------------ K3, K5, K6 and context parallelism


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b, dk", [(1, 128), (32, 128), (3, 64)])
def test_gdn_step_kernel_in_place(gen, dtype, b, dk):
    """K3: one layer's decode step, the state updated in place."""
    from llm_quest_tpu_torch.kernels import gdn

    q, k, v, beta, alpha = (x[:, :, 0] for x in gdn_inputs(gen, b, 16, 1, dtype, dk=dk, dv=dk)[:5])
    state = randn(gen, b, 16, dk, dk, scale=0.1)
    ref_state = state.clone()
    n = gdn.gated_delta_rule_step.launches, gdn.gated_delta_rule_step_stacked.launches
    out, new = gdn.gated_delta_rule_step(q, k, v, beta, alpha, state)
    assert new is state
    assert (gdn.gated_delta_rule_step.launches, gdn.gated_delta_rule_step_stacked.launches) == (n[0] + 1, n[1])
    ref_out, _ = gdn.gated_delta_rule_step(q, k, v, beta, alpha, ref_state, plain=True)
    assert_close(out, ref_out, dtype)
    assert_close(state, ref_state, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", [(16, 8, 128, 128), (4, 4, 64, 64), (12, 4, 64, 32)])
def test_flash_attention_with_lse_kernel(gen, dtype, causal, dims):
    """K5: output, lse, and dq/dk/dv for an output and a random lse
    cotangent, against autograd through the plain version; its launches are
    its own, not K4's."""
    from llm_quest_tpu_torch.kernels import attention

    hq, hkv, d, dv = dims
    q0, k0, v0 = randn(gen, 2, hq, 300, d, dtype=dtype), randn(gen, 2, hkv, 300, d, dtype=dtype), \
        randn(gen, 2, hkv, 300, dv, dtype=dtype)
    do, g_lse = randn(gen, 2, hq, 300, dv, dtype=dtype), randn(gen, 2, hq, 300)
    counts = lambda: (attention.flash_attention_with_lse.launches,  # noqa: E731
                      attention.flash_attention_with_lse.bwd_launches,
                      attention.flash_attention.launches, attention.flash_attention_bwd.launches)
    n, tc = counts(), tc_counts()
    got, ref = [], []
    for plain, out_list in ((False, got), (True, ref)):
        leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
        out, lse = attention.flash_attention_with_lse(*leaves, causal=causal, plain=plain)
        out_list.extend([out.detach(), lse.detach(), *torch.autograd.grad((out, lse), leaves, (do, g_lse))])
    assert counts() == (n[0] + 1, n[1] + 1, n[2], n[3])
    assert_tc_moved(tc, dtype, k5=1, k5_bwd=1)
    assert got[1].dtype == torch.float32
    for g, r in zip(got, ref):
        assert_close(g, r, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", SHORT_SEQS + [1024])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_fused_mha_kernel(gen, dtype, causal, s, d):
    """K6's forward against its plain version, and the lse it keeps for the
    backward against the plain lse."""
    from llm_quest_tpu_torch.kernels import fused_mha

    q, k, v = (randn(gen, 2, 3, s, d, dtype=dtype) for _ in range(3))
    n, tc = fused_mha.fused_mha.launches, tc_counts()
    got = fused_mha.fused_mha(q, k, v, causal=causal)
    out, lse = fused_mha._fused_fwd(q, k, v, causal, d**-0.5, with_lse=True)
    assert fused_mha.fused_mha.launches == n + 2
    assert_tc_moved(tc, dtype, k6=2)
    ref = fused_mha.fused_mha(*f32(q, k, v), causal=causal, plain=True)
    assert_short_close(got, ref, dtype, s)
    assert_short_close(out, ref, dtype, s)
    assert_close(lse, fused_mha.fused_mha_lse_plain(q, k, causal=causal), torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", SHORT_SEQS + [1024])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_fused_mha_backward(gen, dtype, causal, s, d):
    """K6 forward + backward (the flash recompute kernels fed K6's lse)
    against autograd through the plain version; the backward's launches
    are K6's own, not K4's."""
    from llm_quest_tpu_torch.kernels import attention, fused_mha

    q0, k0, v0, do = (randn(gen, 2, 3, s, d, dtype=dtype) for _ in range(4))
    counts = lambda: (fused_mha.fused_mha.launches, fused_mha.fused_mha.bwd_launches,  # noqa: E731
                      fused_mha.fused_mha.causal_bwd_launches, attention.flash_attention_bwd.launches)
    n, tc = counts(), tc_counts()
    got, ref = [], []
    for plain, out_list in ((False, got), (True, ref)):
        leaves = [t.clone().requires_grad_() for t in (f32(q0, k0, v0) if plain else (q0, k0, v0))]
        out = fused_mha.fused_mha(*leaves, causal=causal, plain=plain)
        out_list.extend([out.detach(), *torch.autograd.grad(out, leaves, do.to(out.dtype))])
    assert counts() == (n[0] + 1, n[1] + 1, n[2] + causal, n[3])
    assert_tc_moved(tc, dtype, k6=1, k6_bwd=1)
    for g, r in zip(got, ref):
        assert_short_close(g, r, dtype, s)


def test_fused_mha_kernel_reads_strided_heads(gen):
    """The router hands K6 split-head views ((b, h, s, d) of a (b, s, h·d)
    tensor): read by stride, equal to the contiguous call."""
    from llm_quest_tpu_torch.kernels import fused_mha

    q, k, v = (randn(gen, 2, 40, 4 * 64).reshape(2, 40, 4, 64).transpose(1, 2) for _ in range(3))
    got = fused_mha.fused_mha(q, k, v, causal=True)
    assert_close(got, fused_mha.fused_mha(q.contiguous(), k.contiguous(), v.contiguous(), causal=True),
                 torch.float32)
    with pytest.raises(ValueError):
        fused_mha.fused_mha(q[:, :2], k, v)  # unequal heads
    with pytest.raises(ValueError):
        fused_mha.fused_mha(*(randn(gen, 1, 2, 8, 256) for _ in range(3)))  # no d 256 instance


@pytest.fixture
def group1(gen):
    import torch.distributed as dist

    from llm_quest_tpu_torch.parallel import init_cp_group

    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    group = init_cp_group(0, 1, store=dist.HashStore(), backend="gloo")
    yield group
    dist.destroy_process_group()


def test_ring_flash_of_one_on_the_card(gen, group1):
    """At world 1 the ring is one causal K5 block: the output equals K5's
    and the gradients K5's, launches counted once each way."""
    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.parallel import ring_flash_attention

    q0, k0, v0 = randn(gen, 1, 8, 256, 128), randn(gen, 1, 4, 256, 128), randn(gen, 1, 4, 256, 128)
    do = randn(gen, 1, 8, 256, 128)
    leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    n = attention.flash_attention_with_lse.launches, attention.flash_attention_with_lse.bwd_launches
    out = ring_flash_attention(group1, *leaves)
    grads = torch.autograd.grad(out, leaves, do)
    assert (attention.flash_attention_with_lse.launches, attention.flash_attention_with_lse.bwd_launches) == \
        (n[0] + 1, n[1] + 1)
    ref_leaves = [t.clone().requires_grad_() for t in (q0, k0, v0)]
    ref = attention.flash_attention_with_lse(*ref_leaves, causal=True)[0]
    assert torch.equal(out, ref)
    for g, r in zip(grads, torch.autograd.grad(ref, ref_leaves, do)):
        assert torch.isfinite(g).all()
        assert_close(g, r, torch.float32)


def test_qwen3_context_parallel_step_of_one_on_the_card(gen, group1):
    """The dense Qwen3 under CP at world 1 (the ring through K5) against the
    same loss without CP (K4), fp32; and the unshardable fallback through K6."""
    from llm_quest_tpu_torch.kernels import attention, fused_mha
    from llm_quest_tpu_torch.models import qwen3
    from llm_quest_tpu_torch.parallel import shard_batch
    from llm_quest_tpu_torch.training import engine

    cfg = dict(TINY_QWEN3, head_dim=64)
    cp_cfg = dict(cfg, context_parallel={"group": group1})
    model = qwen3.init(cfg, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    ids = torch.randint(0, cfg["vocab_size"], (2, 64), generator=gen, device="cuda")
    batch = {"input_ids": ids, "targets": torch.roll(ids, -1, 1)}
    n_k5 = attention.flash_attention_with_lse.launches
    cp_loss, cp_grads = engine.make_value_and_grad(qwen3, cp_cfg)(model, shard_batch(batch, group1))
    assert attention.flash_attention_with_lse.launches == n_k5 + cfg["n_layers"]
    loss, grads = engine.make_value_and_grad(qwen3, cfg)(model, batch)
    assert abs(float(cp_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    for got, ref in zip(cp_grads, grads):
        assert_close(got, ref, torch.float32)
    cfg_eq = dict(cp_cfg, num_kv_groups=cfg["n_heads"])
    model_eq = qwen3.init(cfg_eq, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    n_k6 = fused_mha.fused_mha.launches
    with torch.no_grad():
        got, _, _ = qwen3.apply(model_eq, cfg_eq, ids[:, :27])
        ref, _, _ = qwen3.apply(model_eq, dict(cfg_eq, use_fused_mha=False), ids[:, :27])
    assert fused_mha.fused_mha.launches == n_k6 + cfg["n_layers"]
    assert_close(got, ref, torch.float32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g, m", [(3, 16), (64, 208), (64, 224)])
def test_attn_core_kernel(gen, int8, g, m):
    """K12 against its plain version within ``k12_tolerance``: bf16 scores
    within one bf16 unit of max |plain|; int8 scores (exact on both sides)
    each output within one bf16 unit of its plain value plus the fp32
    summation bound of p·(v + t)."""
    from llm_quest_tpu_torch.kernels import attn_core as ac

    d = 128 if int8 else 64
    q, k = (randn(gen, g, m, d) for _ in range(2))
    if int8:
        q, k = (torch.clamp(x * 16, -127, 127).to(torch.int8) for x in (q, k))
    else:
        q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    v = randn(gen, g, m, 64, dtype=torch.bfloat16)
    t = randn(gen, 1, 1, 64, dtype=torch.bfloat16, scale=0.01)
    n, n8 = ac.attn_core.launches, ac.attn_core.int8_launches
    out = ac.attn_core(t, q, k, v)
    assert (ac.attn_core.launches, ac.attn_core.int8_launches) == (n + 1, n8 + int(int8))
    ref = ac.attn_core(t, q, k, v, plain=True)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == (g, m, 64)
    err = (out.float() - ref.float()).abs()
    assert bool((err <= ac.k12_tolerance(t, q, k, v, ref)).all()), float(err.max())


def k12_rounding_cases(int8, device):
    """Hand-computed K12 cases, zero-padded to M 16, D 64 (bf16) or 128
    (int8) and Kv 64, as (t, q, k, v, expected o): the scores 16383 → 16384
    and the tie 381 → 380 (to even); p rounded before the product (16383 and
    16129 round to 16384 and 16128, so p·(1, -1) is 256, where unrounded
    scores give 254); ``v + t`` = 1 + (2⁻⁸ - 2⁻¹⁶) rounded to 1 before the
    product (o = 129, where the unrounded sum gives 130). Every value is
    exact in bf16 and in int8."""
    dtype, d = (torch.int8, 128) if int8 else (torch.bfloat16, 64)
    cases = []
    for qr, kr, vr, tr, want in [
        ([[127, 127]], [[127, 2], [0, 3]], [[1, 0], [0, 1]], 0.0, [[16384, 380]]),
        ([[127, 127]], [[127, 2], [127, 0]], [[1], [-1]], 0.0, [[256]]),
        ([[127, 2]], [[1, 1]], [[1]], 2.0**-8 - 2.0**-16, [[129]]),
    ]:
        q, k = (torch.zeros(1, 16, d, dtype=dtype, device=device) for _ in range(2))
        v = torch.zeros(1, 16, 64, dtype=torch.bfloat16, device=device)
        o = torch.zeros(1, 16, 64, device=device)
        qr, kr, vr, want = (torch.tensor(x, dtype=torch.float32) for x in (qr, kr, vr, want))
        q[0, : qr.shape[0], : qr.shape[1]] = qr.to(dtype)
        k[0, : kr.shape[0], : kr.shape[1]] = kr.to(dtype)
        v[0, : vr.shape[0], : vr.shape[1]] = vr.to(torch.bfloat16)
        o[0, : want.shape[0], : want.shape[1]] = want
        t = torch.zeros(1, 1, 64, dtype=torch.bfloat16, device=device)
        t[..., : vr.shape[1]] = tr
        cases.append((t, q, k, v, o))
    return cases


@pytest.mark.usefixtures("gen")  # skips without a card
@pytest.mark.parametrize("int8", [False, True])
def test_attn_core_kernel_rounds_like_jax(int8):
    """The kernel rounds p and ``v + t`` to bf16 before p·(v + t): the
    hand-computed cases, bit for bit."""
    from llm_quest_tpu_torch.kernels import attn_core as ac

    for t, q, k, v, want in k12_rounding_cases(int8, "cuda"):
        got = ac.attn_core(t, q, k, v)
        torch.testing.assert_close(got.float(), want, rtol=0, atol=0)


def test_attn_core_raises_on_unsupported_shapes(gen):
    from llm_quest_tpu_torch.kernels import attn_core as ac

    q = randn(gen, 2, 40, 64, dtype=torch.bfloat16)  # M 40 is no multiple of 16
    t, v = randn(gen, 1, 1, 64, dtype=torch.bfloat16), randn(gen, 2, 40, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ac.attn_core(t, q, q, v)
    q = randn(gen, 2, 32, 32, dtype=torch.bfloat16)  # 64-byte rows
    with pytest.raises(ValueError):
        ac.attn_core(t, q, q, v[:, :32])


def test_vit_train_step_through_kernels_matches_plain(gen):
    """One ``make_vit_train_step`` of a 2-layer ViT at ViT-B's widths, fp32,
    no dropout, through K7 against the plain step: the loss within 1e-6
    relative, every gradient within 1e-5 of its largest (the key biases',
    zero in exact arithmetic, of the key weight's), the parameters with a
    clear gradient updated alike; and with dropout, a seeded forward repeats
    exactly."""
    from llm_quest_tpu_torch.config import VIT_BASE_CONFIG
    from llm_quest_tpu_torch.kernels import attention
    from llm_quest_tpu_torch.models import vit
    from llm_quest_tpu_torch.training import engine, vit_engine

    cfg = dict(VIT_BASE_CONFIG, n_layers=2, drop_rate=0.0, dtype=torch.float32)
    batch = {"image": randn(gen, 4, 3, 224, 224), "label": torch.randint(0, 100, (4,), generator=gen, device="cuda")}
    results = {}
    for use_kernels in (True, False):
        model = vit.init(cfg, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
        step_cfg = dict(cfg, use_kernels=use_kernels)
        loss_fn = lambda: torch.nn.functional.cross_entropy(vit.apply(model, step_cfg, batch["image"]), batch["label"])  # noqa: E731
        grads = dict(zip([n for n, _ in model.named_parameters()], torch.autograd.grad(loss_fn(), list(model.parameters()))))
        n = attention.packed_mha.launches
        opt = engine.make_optimizer(1e-3)
        _, _, loss = vit_engine.make_vit_train_step(vit, step_cfg, opt)(model, opt.init(model), batch, None)
        assert attention.packed_mha.launches == n + (cfg["n_layers"] if use_kernels else 0)
        results[use_kernels] = (float(loss), grads, {n: p.detach().clone() for n, p in model.named_parameters()})
    (loss_k, grads_k, params_k), (loss_p, grads_p, params_p) = results[True], results[False]
    assert abs(loss_k - loss_p) <= 1e-6 * abs(loss_p)
    for name, ref in grads_p.items():  # the key biases' gradient is zero in exact arithmetic: the key weight's scale
        scale = float(grads_p[name.replace("wk.b", "wk.w")].abs().max())
        assert float((grads_k[name] - ref).abs().max()) <= 1e-5 * scale, name
    # Adam's first step moves each element by lr·g / (|g| + eps): where |g| is
    # within the two runs' rounding noise of zero the two moves may differ by
    # up to 2·lr, so only the elements with a gradient of at least 1e-3 of
    # their leaf's largest (the key biases: of the key weight's) are held alike
    for name, ref in params_p.items():
        sure = grads_p[name].abs() >= 1e-3 * float(grads_p[name.replace("wk.b", "wk.w")].abs().max())
        if bool(sure.any()):
            assert float((params_k[name] - ref).abs()[sure].max()) <= 1e-5 * float(ref.abs().max()), name
    cfg = dict(cfg, drop_rate=0.1)
    model = vit.init(cfg, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    with torch.no_grad():
        a, b = (vit.apply(model, cfg, batch["image"], deterministic=False,
                          generator=torch.Generator(device="cuda").manual_seed(5)) for _ in range(2))
    assert torch.equal(a, b)
