"""Analytic model-FLOPs accounting → MFU (counterpart of
``llm_quest_tpu/training/flops.py``, dense text models only).

**MFU**: achieved matmul FLOP/s over the card's peak — the lens for training,
which is compute-bound.

FLOP counts are analytic from the model config (matmul FLOPs only: norms,
softmax, activations and RoPE are small next to the matmuls), 2·m·n·k per
matmul and 3× forward for a train step (backward ≈ 2× forward); the same
formulas as the JAX package for a dense GQA model with a SwiGLU FFN. The
MoE, hybrid (GDN) and ViT counts, MBU and the decode byte counts come with
the first ported path that reads them.

Peaks are those of the card present, looked up by
``torch.cuda.get_device_name()``; an unknown card, or no card, raises.
"""

import torch

# Peak dense rates by device name (NVIDIA's data sheet, SXM part, without
# sparsity, at the full 700 W power limit).
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "int8": 1979e12, "hbm_gbps": 3350.0},
}


def device_peaks(device=None):
    """Peak-rate dict of the CUDA card ``device`` (default: the current one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_peaks: no CUDA device; MFU is a card metric")
    name = torch.cuda.get_device_name(device)
    if name not in _DEVICE_PEAKS:
        raise ValueError(f"device_peaks: no peak rates known for {name!r} (known: {sorted(_DEVICE_PEAKS)})")
    return _DEVICE_PEAKS[name]


def mfu(rate_per_sec, flops_per_unit, *, dtype="bf16", device=None):
    """Fraction of peak matmul throughput: (units/s · FLOPs/unit) / peak."""
    return rate_per_sec * flops_per_unit / device_peaks(device)[dtype]


# ---------------------------------------------------------- text models


def _attn_layer_flops(cfg, kv_len):
    """Per-token FLOPs of one GQA attention sublayer at context kv_len."""
    d = cfg["emb_dim"]
    nq = cfg["n_heads"]
    hd = cfg.get("head_dim", d // nq)
    nkv = cfg.get("num_kv_groups", nq)
    q = 2 * d * nq * hd
    kv = 2 * d * nkv * 2 * hd
    o = 2 * nq * hd * d
    scores = 2 * kv_len * nq * 2 * hd  # QKᵀ + AV
    return q + kv + o + scores


def text_forward_flops_per_token(cfg, *, kv_len):
    """Forward matmul FLOPs per processed token at attention context kv_len
    (dense GQA with a SwiGLU FFN and the LM head)."""
    if cfg.get("model_type") == "moe" or "linear_sdpa_ratio" in cfg or "hidden_dim" not in cfg:
        raise NotImplementedError("text_forward_flops_per_token: only dense SwiGLU models are counted")
    ffn = 3 * 2 * cfg["emb_dim"] * cfg["hidden_dim"]  # SwiGLU: gate/up/down
    total = cfg["n_layers"] * (_attn_layer_flops(cfg, kv_len) + ffn)
    total += 2 * cfg["emb_dim"] * cfg["vocab_size"]  # LM head
    return total


def text_train_flops_per_token(cfg, *, seq_len):
    """Train-step FLOPs per token: 3× forward, causal attention averaged over
    positions (mean context = seq_len / 2)."""
    return 3 * text_forward_flops_per_token(cfg, kv_len=seq_len // 2)
