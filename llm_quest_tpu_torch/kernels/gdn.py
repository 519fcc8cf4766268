"""Gated-delta-rule kernels (csrc/gdn.cu) and their plain PyTorch versions.

- ``gated_delta_rule_fwd``: K1, the full-sequence forward; replaces
  ``llm_quest_tpu/kernels/gdn_pallas.py::gated_delta_rule_pallas`` (forward).
  Plain version: ``ops/gdn.py::gated_delta_rule_chunked``.
- ``gated_delta_rule_step_stacked``: K2, the one-token decode step on the
  stacked (L, b, h, dv, dk) state, in place at ``layer``; replaces
  ``gdn_pallas.py::gated_delta_rule_step_stacked_pallas``. Plain version:
  ``ops/gdn.py::gated_delta_rule_step`` plus an indexed write.

Both are forward-only on the card: their backward is not ported, so on a
CUDA tensor they raise ``NotImplementedError`` when grad mode is on and an
input requires grad (the plain versions, on the CPU, differentiate).

Device rule: a CUDA tensor launches the kernel (or raises), a CPU tensor runs
the plain version. ``plain=True`` forces the plain version on any device; only
comparisons against the kernel pass it. Each wrapper counts its launches in
its ``launches`` attribute.
"""

import torch

from llm_quest_tpu_torch.kernels import build
from llm_quest_tpu_torch.ops import gdn as gdn_ops


def gated_delta_rule_fwd_plain(q, k, v, beta, alpha, prev_state=None, *, chunk_size=64):
    return gdn_ops.gated_delta_rule_chunked(q, k, v, beta, alpha, prev_state, chunk_size=chunk_size)


def gated_delta_rule_fwd(q, k, v, beta, alpha, prev_state=None, *, chunk_size=64, plain=False):
    """Gated delta rule over a sequence.

    q/k: (b, h, s, dk) heads pre-repeated; v: (b, h, s, dv); beta/alpha:
    (b, h, s); prev_state: (b, h, dv, dk) fp32 or None (zeros). Returns
    (out (b, h, s, dv) in q's dtype, final state (b, h, dv, dk) fp32).
    ``chunk_size`` shapes only the plain chunked form; the kernel is the scan.
    """
    if plain or not q.is_cuda:
        return gated_delta_rule_fwd_plain(q, k, v, beta, alpha, prev_state, chunk_size=chunk_size)
    build.require_no_grad("gated_delta_rule_fwd", q, k, v, beta, alpha, prev_state)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    operands = (q, k, v, beta, alpha) + (() if prev_state is None else (prev_state,))
    build.require_cuda(*operands)
    build.require(k.shape == q.shape and v.shape == (b, h, s, dv), "q/k (b, h, s, dk), v (b, h, s, dv)")
    build.require(beta.shape == (b, h, s) and alpha.shape == (b, h, s), "beta/alpha must be (b, h, s)")
    build.require(k.dtype == q.dtype and v.dtype == q.dtype, "q, k and v must share one dtype")
    build.require(dk == 128 and dv % 8 == 0, f"kernel takes dk = 128 and dv % 8 == 0, got dk={dk} dv={dv}")
    build.require(all(t.stride(-1) == 1 for t in (q, k, v)), "q/k/v need a contiguous last dim")
    if prev_state is not None:
        build.require(
            prev_state.shape == (b, h, dv, dk) and prev_state.dtype == torch.float32
            and prev_state.is_contiguous(),
            "prev_state must be contiguous fp32 (b, h, dv, dk)",
        )
    beta32 = beta.float().contiguous()
    alpha32 = alpha.float().contiguous()
    out = torch.empty(b, h, s, dv, dtype=q.dtype, device=q.device)
    state = torch.empty(b, h, dv, dk, dtype=torch.float32, device=q.device)
    build.launch(
        "llmq_gdn_prefill", build.dtype_code(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), beta32.data_ptr(), alpha32.data_ptr(),
        None if prev_state is None else prev_state.data_ptr(), state.data_ptr(), out.data_ptr(),
        b, h, s, dk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], dk**-0.5,
        build.stream_of(q),
    )
    gated_delta_rule_fwd.launches += 1
    return out, state


gated_delta_rule_fwd.launches = 0


def gated_delta_rule_step_stacked_plain(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer):
    out, new = gdn_ops.gated_delta_rule_step(q_t, k_t, v_t, beta_t, alpha_t, stacked[layer])
    stacked[layer] = new
    return out, stacked


def gated_delta_rule_step_stacked(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer, *, plain=False):
    """One decode step on the stacked recurrent state, updated IN PLACE at
    ``layer`` (every other layer is left untouched).

    q_t/k_t: (b, h, dk); v_t: (b, h, dv); beta_t/alpha_t: (b, h); stacked:
    (L, b, h, dv, dk) fp32 contiguous. Returns (out (b, h, dv) in q's dtype,
    stacked).
    """
    if plain or not q_t.is_cuda:
        return gated_delta_rule_step_stacked_plain(q_t, k_t, v_t, beta_t, alpha_t, stacked, layer)
    build.require_no_grad("gated_delta_rule_step_stacked", q_t, k_t, v_t, beta_t, alpha_t, stacked)
    b, h, dk = q_t.shape
    dv = v_t.shape[-1]
    n_layers = stacked.shape[0]
    build.require_cuda(q_t, k_t, v_t, beta_t, alpha_t, stacked)
    build.require(k_t.shape == q_t.shape and v_t.shape == (b, h, dv), "q/k (b, h, dk), v (b, h, dv)")
    build.require(beta_t.shape == (b, h) and alpha_t.shape == (b, h), "beta/alpha must be (b, h)")
    build.require(k_t.dtype == q_t.dtype and v_t.dtype == q_t.dtype, "q, k and v must share one dtype")
    build.require(dk == 128 and dv % 8 == 0, f"kernel takes dk = 128 and dv % 8 == 0, got dk={dk} dv={dv}")
    build.require(all(t.stride(-1) == 1 for t in (q_t, k_t, v_t)), "q/k/v need a contiguous last dim")
    build.require(
        stacked.shape == (n_layers, b, h, dv, dk) and stacked.dtype == torch.float32 and stacked.is_contiguous(),
        "stacked must be contiguous fp32 (L, b, h, dv, dk)",
    )
    layer = int(layer)
    build.require(0 <= layer < n_layers, f"layer {layer} out of range for {n_layers} layers")
    beta32 = beta_t.float().contiguous()
    alpha32 = alpha_t.float().contiguous()
    out = torch.empty(b, h, dv, dtype=q_t.dtype, device=q_t.device)
    build.launch(
        "llmq_gdn_step_stacked", build.dtype_code(q_t),
        q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), beta32.data_ptr(), alpha32.data_ptr(),
        stacked.data_ptr(), layer, out.data_ptr(), b, h, dk, dv,
        *q_t.stride()[:2], *k_t.stride()[:2], *v_t.stride()[:2], dk**-0.5, build.stream_of(q_t),
    )
    gated_delta_rule_step_stacked.launches += 1
    return out, stacked


gated_delta_rule_step_stacked.launches = 0
