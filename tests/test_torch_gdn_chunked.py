"""The chunked gated delta rule of K1's bf16 tensor-core kernels, on the CPU.

``csrc/gdn_tc.cu`` computes the chunked form (chunks of 64) in six phases:
F1 (per chunk: A = K Kᵀ, X = (I + L)⁻¹, W = X diag(βγ) K, U = X diag(β) V),
F2 (the state pass: D = W S₀ᵀ − U, S ← γ_C S − (rc ⊙ D)ᵀ K), F3 (the
output), B0 (per chunk: X and P), B1 (the reverse pass: the state
cotangent H, dD and drhs = Xᵀ dD) and B2 (each chunk's gradients by
matrix products). A kernel cannot run here, so its
arithmetic is transcribed below in fp64, phase by phase, with the kernels'
operand rounding as an option: every fp32 operand of a bf16 product enters
as bf16 hi + lo (``split_round``).

- Exact (no rounding), the transcription is held to JAX's
  ``gated_delta_rule_pallas`` in interpret mode (the way the JAX package's
  own tests run it on the CPU) and its custom VJP, and to the port's plain
  backward: s ∈ {1, 37, 156, 300}, dk ∈ {64, 128}, dv ≠ dk, with and
  without ``prev_state`` and a final-state cotangent, and a masked pad row.
  Tolerance: 1e-4 relative to max(1, max |ref|), JAX's fp32 arithmetic
  (its Newton–Schulz inverse, other summation orders) against fp64.
- With the split rounding, at the hybrid train step's shape (b 4, h 8,
  s 2048, dk = dv = 64), the transcription stays within the card's bf16
  bars (``chip_smoke.py``'s TOL and TILE_TOL, 2e-2) of the exact one, also
  for long-memory heads (α near 1); rounded to bf16 alone, their dα does
  not. ``rnd`` may also give each phase its own rounding
  (``tools/gdn_tc_rounding.py`` reads them one by one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.kernels.gdn_pallas import gated_delta_rule_pallas
from llm_quest_tpu.ops import gdn as jgdn
from llm_quest_tpu_torch.kernels import gdn as kgdn
from llm_quest_tpu_torch.ops import gdn as tgdn

C = 64  # tokens a chunk of the tensor-core kernels
TOL = 1e-4  # exact transcription (fp64) against the fp32 references, relative to max(1, max |ref|)
BF16_TOL = 2e-2  # chip_smoke.py's TOL["bfloat16"] and TILE_TOL


def exact(x):
    return x


def split_round(x):
    """bf16 hi + bf16 lo of an fp64 value: the kernels' fp32 operand."""
    hi = x.to(torch.bfloat16).double()
    return hi + (x - hi).to(torch.bfloat16).double()


def bf16_round(x):
    """bf16 alone (``LLMQ_GDN_TC_SPLIT 0``)."""
    return x.to(torch.bfloat16).double()


PHASES = ("F1", "F2", "F3", "B1", "B2")


def rounding(rnd, phase):
    """The rounding of ``phase``'s operands: ``rnd`` itself, or its entry when
    it maps phases to roundings."""
    return rnd[phase] if isinstance(rnd, dict) else rnd


def chunks(x, fill=0.0):
    """(b, h, s, ...) → (b, h, n, 64, ...) fp64, the tail padded with ``fill``."""
    b, h, s = x.shape[:3]
    n = -(-s // C)
    x = x.double()
    pad = torch.full((b, h, n * C - s, *x.shape[3:]), fill, dtype=torch.float64)
    return torch.cat([x, pad], dim=2).reshape(b, h, n, C, *x.shape[3:])


def scalars(al):
    """γ, rc, γ_C and R of a chunk (α padded with 1)."""
    lg = torch.cumsum(torch.log(al.clamp_min(1e-30)), -1)
    lgc = lg[..., -1:]
    incl = torch.ones(C, C, dtype=torch.bool).tril()
    ratio = torch.exp((lg[..., :, None] - lg[..., None, :]).clamp_max(0.0))
    return torch.exp(lg), torch.exp((lgc - lg).clamp_max(0.0)), torch.exp(lgc), torch.where(incl, ratio, 0.0)


def chunk_local(q_, k_, bt, al, scale):
    """F1 / B0: γ, rc, γ_C, R, A = K Kᵀ, X = (I + strict_tril(β_t R A))⁻¹ and
    P = dk^-½ tril(R ⊙ Q Kᵀ)."""
    gam, rc, gc, R = scalars(al)
    A = k_ @ k_.transpose(-1, -2)
    L = torch.where(torch.ones(C, C, dtype=torch.bool).tril(-1), bt[..., :, None] * R * A, 0.0)
    X = torch.linalg.inv(torch.eye(C, dtype=torch.float64) + L)
    return gam, rc, gc, R, A, X, scale * R * (q_ @ k_.transpose(-1, -2))


def tc_forward(q, k, v, beta, alpha, s0=None, rnd=exact):
    """F1–F3. Returns (out, final state, the anchors, Dᵀ), anchors and Dᵀ as
    the kernels store them (hi + lo). ``rnd``: one rounding, or one a phase."""
    r1, r2, r3 = (rounding(rnd, ph) for ph in ("F1", "F2", "F3"))
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    scale = dk**-0.5
    Q, K, V, Bt, Al = chunks(q), chunks(k), chunks(v), chunks(beta), chunks(alpha, 1.0)
    S = torch.zeros(b, h, dv, dk, dtype=torch.float64) if s0 is None else s0.double()
    outs, anchors, ds = [], [], []
    for j in range(Q.shape[2]):
        q_, k_, v_, bt = Q[:, :, j], K[:, :, j], V[:, :, j], Bt[:, :, j]
        gam, rc, gc, _, _, X, P = chunk_local(q_, k_, bt, Al[:, :, j], scale)
        W = r1(r1(X * (bt * gam)[..., None, :]) @ k_)  # F1, stored hi + lo
        UT = (r1(X * bt[..., None, :]) @ v_).transpose(-1, -2)
        S0 = r2(S)  # F2: the anchor
        DT = S0 @ W.transpose(-1, -2) - UT
        S = gc[..., None] * S + r2(-DT * rc[..., None, :]) @ k_
        anchors.append(S0)
        ds.append(r2(DT))
        outs.append(scale * gam[..., None] * (q_ @ S0.transpose(-1, -2)) - r3(P) @ ds[-1].transpose(-1, -2))  # F3
    out = torch.stack(outs, 2).reshape(b, h, -1, dv)[:, :, :s]
    return out, S, torch.stack(anchors), torch.stack(ds, 2)


def tc_backward(q, k, v, beta, alpha, anchors, ds, d_out, d_state=None, rnd=exact):
    """B0–B2 from the forward's anchors and Dᵀ. Returns (dq, dk, dv, dβ, dα, d_prev)."""
    r1, r2 = rounding(rnd, "B1"), rounding(rnd, "B2")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    scale = dk**-0.5
    Q, K, V, Bt, Al, dO = chunks(q), chunks(k), chunks(v), chunks(beta), chunks(alpha, 1.0), chunks(d_out)
    n = Q.shape[2]
    strict = torch.ones(C, C, dtype=torch.bool).tril(-1)
    local = [chunk_local(Q[:, :, j], K[:, :, j], Bt[:, :, j], Al[:, :, j], scale) for j in range(n)]
    # B1: the reverse pass
    H = torch.zeros(b, h, dv, dk, dtype=torch.float64) if d_state is None else d_state.double()
    hin, drhs_t = [None] * n, [None] * n
    dv_ = torch.zeros(b, h, n, C, dv, dtype=torch.float64)
    for j in reversed(range(n)):
        gam, rc, gc, _, _, X, P = local[j]
        q_, k_, bt, doT = Q[:, :, j], K[:, :, j], Bt[:, :, j], dO[:, :, j].transpose(-1, -2)
        hin[j] = r1(H)
        dDT = -(doT @ r1(P)) - (hin[j] @ k_.transpose(-1, -2)) * rc[..., None, :]
        dr = r1(dDT) @ r1(X)
        drhs_t[j] = r1(dr)
        dv_[:, :, j] = (-bt[..., None, :] * dr).transpose(-1, -2)
        H = gc[..., None] * H + r1(doT * (scale * gam)[..., None, :]) @ q_ + r1(dr * (bt * gam)[..., None, :]) @ k_
    # B2: each chunk's gradients
    dq, dk_, db, da = [], [], [], []
    for j in range(n):
        gam, rc, gc, R, A, _, _ = local[j]
        q_, k_, v_, bt, al, do = Q[:, :, j], K[:, :, j], V[:, :, j], Bt[:, :, j], Al[:, :, j], dO[:, :, j]
        S, Hc, D, drhs = anchors[j], hin[j], ds[:, :, j].transpose(-1, -2), drhs_t[j].transpose(-1, -2)
        QK = q_ @ k_.transpose(-1, -2)
        dP = torch.where(torch.ones(C, C, dtype=torch.bool).tril(), -(do @ D.transpose(-1, -2)), 0.0)
        dQK = scale * dP * R
        dL = torch.where(strict, -(drhs @ D.transpose(-1, -2)), 0.0)
        dA = dL * bt[..., :, None] * R
        G = dP * scale * QK * R + dL * bt[..., :, None] * A * R
        KS, QS, KH = k_ @ S.transpose(-1, -2), q_ @ S.transpose(-1, -2), k_ @ Hc.transpose(-1, -2)
        dgam = scale * (do * QS).sum(-1) + bt * (drhs * KS).sum(-1)
        dbeta = (dL * R * A).sum(-1) + (drhs * (gam[..., None] * KS - v_)).sum(-1)
        drc = -(KH * D).sum(-1)
        dq.append(scale * gam[..., None] * (do @ S) + r2(dQK) @ k_)
        dk_.append(r2(drhs * (bt * gam)[..., None]) @ S + r2(dQK.transpose(-1, -2)) @ q_
                   + r2(dA + dA.transpose(-1, -2)) @ k_ + r2(-rc[..., None] * D) @ Hc)
        dlg = dgam * gam + G.sum(-1) - G.sum(-2) - drc * rc
        dlg[..., -1] += (Hc * S).sum((-1, -2)) * gc[..., 0] + (drc * rc).sum(-1)
        dla = torch.flip(torch.cumsum(torch.flip(dlg, [-1]), -1), [-1])
        db.append(dbeta)
        da.append(torch.where(al >= 1e-30, dla / al, 0.0))

    def whole(xs):
        x = torch.stack(xs, 2) if isinstance(xs, list) else xs
        return x.reshape(b, h, n * C, *x.shape[4:])[:, :, :s]

    return whole(dq), whole(dk_), whole(dv_), whole(db), whole(da), H


def inputs(b, h, s, dk, dv, seed):
    """l2-normalized q/k (as the model feeds them), β ∈ (0, 1), α near 1, as
    fp32 numpy arrays (the JAX side) and fp64 tensors (the transcription)."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    arrays = (
        unit(rng.standard_normal((b, h, s, dk))), unit(rng.standard_normal((b, h, s, dk))),
        rng.standard_normal((b, h, s, dv)).astype(np.float32),
        (1 / (1 + np.exp(-rng.standard_normal((b, h, s))))).astype(np.float32),
        (1 / (1 + np.exp(-(rng.standard_normal((b, h, s)) * 0.3 + 2.0)))).astype(np.float32),
        (rng.standard_normal((b, h, dv, dk)) * 0.1).astype(np.float32),
        rng.standard_normal((b, h, s, dv)).astype(np.float32),
        rng.standard_normal((b, h, dv, dk)).astype(np.float32),
    )
    return arrays


def assert_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def pad_row(beta, alpha, real):
    """Row 1 right-padded after ``real`` tokens (β = 0, α = 1 on the pads), as
    serving admission pads a batch."""
    mask = np.ones(beta.shape[::2], bool)
    mask[1, real:] = False
    fb, fa = tgdn.freeze_masked_updates(torch.from_numpy(beta), torch.from_numpy(alpha), torch.from_numpy(mask))
    return fb.numpy(), fa.numpy()


# (s, dk, dv, prev_state, final-state cotangent, a masked pad row)
CASES = [
    (1, 64, 64, False, False, False),
    (37, 64, 64, True, True, False),
    (156, 128, 128, False, True, False),
    (300, 64, 64, True, False, False),
    (300, 128, 128, True, True, False),
    (156, 64, 128, True, True, False),
    (37, 128, 64, False, True, False),
    (130, 64, 64, True, True, True),
]
IDS = [f"s{s}-dk{dk}-dv{dv}{'-prev' if p else ''}{'-dstate' if d else ''}{'-pad' if m else ''}"
       for s, dk, dv, p, d, m in CASES]


def case_inputs(s, dk, dv, with_prev, with_dstate, masked):
    q, k, v, beta, alpha, s0, d_out, d_state = inputs(2, 2, s, dk, dv, seed=s + dk + 3 * dv)
    if masked:
        beta, alpha = pad_row(beta, alpha, real=s // 2 + 3)
    return q, k, v, beta, alpha, s0 if with_prev else np.zeros_like(s0), d_out, d_state if with_dstate else None


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tc_forward_matches_pallas(case):
    """F1–F3 against ``gated_delta_rule_pallas(interpret=True)``: the output,
    the final state, and each anchor against the state the scan reaches."""
    q, k, v, beta, alpha, s0, _, _ = case_inputs(*case)
    out, state, anchors, _ = tc_forward(*(torch.from_numpy(x) for x in (q, k, v, beta, alpha, s0)))
    ref_out, ref_state = gated_delta_rule_pallas(*map(jnp.asarray, (q, k, v, beta, alpha, s0)), 64, True)
    assert_close(out, ref_out)
    assert_close(state, ref_state)
    s = q.shape[2]
    for j in range(-(-s // C)):
        if j == 0:
            assert_close(anchors[0], s0)
            continue
        _, ref = jgdn.gated_delta_rule(*(jnp.asarray(x[:, :, : j * C]) for x in (q, k, v, beta, alpha)),
                                       prev_state=jnp.asarray(s0))
        assert_close(anchors[j], ref)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tc_backward_matches_pallas_vjp_and_plain(case):
    """B0–B2 against ``jax.vjp`` of ``gated_delta_rule_pallas(interpret=True)``
    and against the port's plain backward (the per-chunk replay) from the
    plain forward's anchors: dq, dk, dv, dβ, dα and d_prev_state. On a
    masked row's pads (α exactly 1) the decay ratios sit on the tie of
    min(lg_t - lg_i, 0), where JAX's gradient takes half and PyTorch's clamp
    (the plain version) all: dα of the pads is held to the plain version
    only (``freeze_masked_updates`` passes no gradient to them)."""
    q, k, v, beta, alpha, s0, d_out, d_state = case_inputs(*case)
    t = [torch.from_numpy(x) for x in (q, k, v, beta, alpha, s0, d_out)]
    ds_t = None if d_state is None else torch.from_numpy(d_state)
    _, _, anchors, ds = tc_forward(*t[:6])
    got = tc_backward(*t[:5], anchors, ds, t[6], ds_t)
    _, vjp = jax.vjp(lambda *a: gated_delta_rule_pallas(*a, 64, True), *map(jnp.asarray, (q, k, v, beta, alpha, s0)))
    ref = vjp((jnp.asarray(d_out), jnp.asarray(np.zeros_like(s0) if d_state is None else d_state)))
    real = alpha < 1.0
    for name, g, r in zip(("q", "k", "v", "beta", "alpha", "prev_state"), got, ref):
        if name == "alpha":
            g, r = np.where(real, np.asarray(g), 0.0), np.where(real, np.asarray(r), 0.0)
        assert_close(g, r)
    _, _, plain_anchors = kgdn.gated_delta_rule_fwd_plain(*t[:6], chunk_size=C, with_anchors=True)
    plain = kgdn.gated_delta_rule_bwd(*t[:5], plain_anchors, t[6], ds_t, chunk_size=C)
    for g, r in zip(got, plain):
        assert_close(g, r)


def test_tc_masked_pad_row_leaves_its_state():
    """The pad tokens of a masked row are no-ops in the transcription: its
    final state is the state after its last real token."""
    q, k, v, beta, alpha, s0, _, _ = case_inputs(130, 64, 64, True, False, True)
    _, state, _, _ = tc_forward(*(torch.from_numpy(x) for x in (q, k, v, beta, alpha, s0)))
    real = 130 // 2 + 3
    _, ref = jgdn.gated_delta_rule(*(jnp.asarray(x[1:, :, :real]) for x in (q, k, v, beta, alpha)),
                                   prev_state=jnp.asarray(s0[1:]))
    assert_close(state[1:], ref)


def tile_err(got, ref):
    """max over 64-token tiles (the state: 64-row tiles) of ||got - ref|| / ||ref||."""
    got, ref = (x[..., None] if x.dim() == 3 else x for x in (got, ref))
    pad = (-ref.shape[-2]) % C

    def sq(x):
        return torch.nn.functional.pad(x, (0, 0, 0, pad)).unflatten(-2, (-1, C)).square().sum((-2, -1))

    return float((sq(got - ref) / sq(ref).clamp_min(1e-300)).sqrt().max())


def hybrid_readings(rnd, decay=2.0):
    """The split (or another) rounding against the exact transcription at the
    hybrid train step's shape, bf16 inputs: each output's max abs error over
    max(1, max |ref|), and its tile error. ``decay``: the mean of α's logit
    (2: α about 0.88, as ``chip_smoke.py``'s inputs; 5 or 8: about 0.993 or
    0.9997, long-memory heads)."""
    torch.manual_seed(0)
    b, h, s, d = 4, 8, 2048, 64

    def bf(x):
        return x.to(torch.bfloat16).double()

    q = bf(torch.nn.functional.normalize(torch.randn(b, h, s, d), dim=-1))
    k = bf(torch.nn.functional.normalize(torch.randn(b, h, s, d), dim=-1))
    v, d_out = bf(torch.randn(b, h, s, d)), bf(torch.randn(b, h, s, d))
    beta = torch.sigmoid(torch.randn(b, h, s)).double()
    alpha = torch.sigmoid(torch.randn(b, h, s) * 0.3 + decay).double()
    results = []
    for r in (exact, rnd):
        out, state, anchors, ds = tc_forward(q, k, v, beta, alpha, rnd=r)
        results.append((out, state, *tc_backward(q, k, v, beta, alpha, anchors, ds, d_out, rnd=r)))
    names = ("out", "state", "dq", "dk", "dv", "dbeta", "dalpha", "d_prev")
    return {n: (float((g - e).abs().max()) / max(1.0, float(e.abs().max())), tile_err(g, e))
            for n, g, e in zip(names, results[1], results[0])}


def test_split_rounding_stays_within_the_bf16_bar():
    """The kernels' operand rounding (bf16 hi + lo of every fp32 operand)
    emulated in fp64 at the hybrid shape: every output and gradient within
    the card's bf16 bars of the exact transcription, whole and per tile."""
    for name, (err, tile) in hybrid_readings(split_round).items():
        assert err <= BF16_TOL and tile <= BF16_TOL, (name, err, tile)


@pytest.mark.parametrize("decay", [5.0, 8.0], ids=["alpha-0.993", "alpha-0.9997"])
def test_split_rounding_stays_within_the_bf16_bar_for_long_memory_heads(decay):
    """The same with α near 1, where the state carries its rounding over
    many chunks."""
    for name, (err, tile) in hybrid_readings(split_round, decay).items():
        assert err <= BF16_TOL and tile <= BF16_TOL, (name, err, tile)


def test_bf16_alone_leaves_the_bar_for_long_memory_heads():
    """Why the kernels split their fp32 operands: rounded to bf16 alone
    (``LLMQ_GDN_TC_SPLIT 0``), dα of long-memory heads leaves the bf16 bar."""
    err, tile = hybrid_readings(bf16_round, 8.0)["dalpha"]
    assert max(err, tile) > BF16_TOL, (err, tile)


def scan64(q, k, v, beta, alpha, s0):
    """The recurrence token by token in fp64: S_t = α_t S + β_t (v_t − α_t S k_t) k_tᵀ, o_t = S_t q_t dk^-½."""
    state, outs = s0, []
    for t in range(q.shape[2]):
        kt = k[:, :, t]
        gated = alpha[:, :, t, None, None] * state
        delta = beta[:, :, t, None] * (v[:, :, t] - (gated @ kt[..., None])[..., 0])
        state = gated + delta[..., :, None] * kt[..., None, :]
        outs.append((state @ q[:, :, t, :, None])[..., 0] * q.shape[-1] ** -0.5)
    return torch.stack(outs, 2), state


def test_exact_transcription_matches_the_fp64_scan():
    """Exactly, the transcription is the recurrence: against the scan in fp64,
    and its gradients against autograd through that scan (s 70, two chunks)."""
    q, k, v, beta, alpha, s0, d_out, d_state = inputs(1, 2, 70, 64, 64, seed=5)
    t = [torch.from_numpy(x).double().requires_grad_() for x in (q, k, v, beta, alpha, s0)]
    ref_out, ref_state = scan64(*t)
    cts = [torch.from_numpy(x).double() for x in (d_out, d_state)]
    grads = torch.autograd.grad((ref_out, ref_state), t, cts)
    args = [x.detach() for x in t]
    out, state, anchors, ds = tc_forward(*args)
    got = tc_backward(*args[:5], anchors, ds, *cts)
    for g, r in zip((out, state, *got), (ref_out, ref_state, *grads)):
        assert_close(g.detach(), r.detach(), 1e-9)
