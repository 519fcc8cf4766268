"""Analytic model-FLOPs and decode-byte accounting → MFU / MBU (counterpart
of ``llm_quest_tpu/training/flops.py``, text models).

**MFU**: achieved matmul FLOP/s over the card's peak — the lens for training,
which is compute-bound. **MBU**: achieved device-memory bytes/s over the
card's peak — the lens for small-batch decode, which streams every weight
once per step.

FLOP counts are analytic from the model config (matmul FLOPs only: norms,
softmax, activations and RoPE are small next to the matmuls), 2·m·n·k per
matmul and 3× forward for a train step (backward ≈ 2× forward); the same
formulas as the JAX package for GQA attention (gated in the hybrids), SwiGLU,
GeGLU, GPT-2's GELU MLP (a config without "hidden_dim": 2·2·d·4d) or
Qwen3-MoE FFNs and GatedDeltaNet layers, and for the ViT (per image). A
Hyper-Qwen3 counts as its Qwen3: the hyper-connections' maps (n·d by n! +
2n a sub-block for mHC-lite) and stream mixes are left out, as JAX leaves
them.

Divergence by design: the train count takes a sliding-window layer (Gemma-3's
``is_swa_layer``) at its mean visible context, the mean over positions of
min(pos + 1, window), where the JAX count takes every attention layer at the
causal mean s/2. At Gemma-3-270M's widths and s = 2048 (window 512, 15 of 18
layers SWA) that is 1.7286e9 FLOP/token against JAX's 1.8347e9, which would
read MFU about 6 % high. A window at or above s, and every config without
one, keeps JAX's count exactly.

MiMo-V2-Flash (a config with ``hybrid_ratio``) is counted as it is built
(``mimo_train_flops_per_token``): each layer type with its own kv groups and
dv; layer 0's dense SwiGLU; the DeepSeek MoE of layers 1+ at top_k routed
experts of int(``moe_scaling_factor``·``hidden_dim``), its router and any
shared experts; the SWA layers (``hybrid_ratio``) at ``swa_mean_context``;
and the MTP modules (down projection, one SWA block with a dense FFN, the
shared head), module k on s − k − 1 of the s tokens. Divergence by design:
the JAX count reads ``num_kv_groups``, which MiMo lacks (so every layer
takes n_heads kv heads), a dense FFN in every layer, every layer at s/2,
and no MTP: at ``MIMO_V2_SMALL_CONFIG`` and s 2048 it gives 9.54e8
FLOP/token against the port's 1.899e9, so JAX's MFU would read about half.

DeepSeek-V3 (a config with ``num_ffn``) is counted as built too
(``deepseek_train_flops_per_token``): MLA's eight projections through the q
and kv latents, its scores at the q/k width head_dim·3/2 and the value sum
at head_dim; the first ``num_ffn`` layers' dense SwiGLU and the DeepSeek MoE
of the rest; the untied head; and the MTP modules, each on all s tokens
(the collator pre-shifts). Divergence by design: the JAX count reads dense
MHA with a dense FFN in every layer and no MTP: at ``DEEPSEEK_SMALL_CONFIG``
and s 2048 it gives 1.0245e9 FLOP/token against the port's 1.7866e9.

Decode bytes count the KV cache as it is stored: bf16 (or the model's type)
at its element size, an int8 cache (``cfg["kv_quant"] = "int8"``) at one
byte an element plus its fp32 k and v scales. Divergence by design: the JAX
count takes 2 bytes an element whatever the cache holds and leaves the
scales out, so it overstates an int8 cache's bytes and MBU. Weights count
as stored too: an int4 weight packed, half a byte an element (as JAX's
``quantized_byte_fraction`` counts it). Divergence by design: JAX's count
takes ml_dtypes' itemsize, one byte an int4 element.

Peaks are those of the card present, looked up by
``torch.cuda.get_device_name()``; an unknown card, or no card, raises.
"""

import torch

from llm_quest_tpu_torch.models import deepseek_v3, mimo_v2_flash
from llm_quest_tpu_torch.models.gemma3 import is_swa_layer
from llm_quest_tpu_torch.ops.quantization import param_bytes

# Peak dense rates by device name (NVIDIA's data sheet, SXM part, without
# sparsity, at the full 700 W power limit).
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "int8": 1979e12, "hbm_gbps": 3350.0},
}


def device_peaks(device=None):
    """Peak-rate dict of the CUDA card ``device`` (default: the current one)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_peaks: no CUDA device; MFU and MBU are card metrics")
    name = torch.cuda.get_device_name(device)
    if name not in _DEVICE_PEAKS:
        raise ValueError(f"device_peaks: no peak rates known for {name!r} (known: {sorted(_DEVICE_PEAKS)})")
    return _DEVICE_PEAKS[name]


def mfu(rate_per_sec, flops_per_unit, *, dtype="bf16", device=None):
    """Fraction of peak matmul throughput: (units/s · FLOPs/unit) / peak."""
    return rate_per_sec * flops_per_unit / device_peaks(device)[dtype]


def mbu(tok_per_sec, bytes_per_token, *, device=None):
    """Fraction of peak device-memory bandwidth streamed by decode (weights
    and state read once per token); a lower bound: activations are left out."""
    return tok_per_sec * bytes_per_token / (device_peaks(device)["hbm_gbps"] * 1e9)


# ---------------------------------------------------------- text models


def _ffn_flops(cfg):
    """Per-token FLOPs of one FFN or MoE sublayer."""
    d = cfg["emb_dim"]
    if cfg.get("model_type") == "moe" or ("num_experts" in cfg and "moe_hidden_dim" in cfg):
        router = 2 * d * cfg["num_experts"]
        experts = cfg["top_k"] * 3 * 2 * d * cfg["moe_hidden_dim"]  # SwiGLU per routed expert
        shared = 3 * 2 * d * cfg["shared_expert_hidden_dim"] if cfg.get("shared_expert_hidden_dim") else 0
        return router + experts + shared
    if "hidden_dim" in cfg:
        return 3 * 2 * d * cfg["hidden_dim"]  # SwiGLU: gate/up/down
    return 2 * 2 * d * 4 * d  # GPT-2 GELU MLP (up + down at 4·d)


def _attn_layer_flops(cfg, kv_len):
    """Per-token FLOPs of one full-attention sublayer at context kv_len."""
    d = cfg["emb_dim"]
    nq = cfg["n_heads"]
    hd = cfg.get("head_dim", d // nq)
    vhd = cfg.get("value_head_dim", hd)
    nkv = cfg.get("num_kv_groups", nq)
    gated = "linear_sdpa_ratio" in cfg  # hybrids fuse a sigmoid out-gate with Q
    q = 2 * d * nq * hd * (2 if gated else 1)
    kv = 2 * d * nkv * (hd + vhd)
    o = 2 * nq * vhd * d
    scores = 2 * kv_len * nq * (hd + vhd)  # QKᵀ + AV
    return q + kv + o + scores


def _gdn_layer_flops(cfg):
    """Per-token FLOPs of one GatedDeltaNet sublayer (the decode-step form;
    the chunked and scan forms do the same MACs reassociated)."""
    d = cfg["emb_dim"]
    nqk, dk = cfg["linear_num_qk_heads"], cfg["linear_qk_head_dim"]
    nv, dv = cfg["linear_num_value_heads"], cfg["linear_value_head_dim"]
    fused = 2 * nqk * dk + 2 * nv * dv + 2 * nv  # q, k, v, z, b, a in-projections
    in_proj = 2 * d * fused
    conv = 2 * cfg["linear_conv_kernel_size"] * (2 * nqk * dk + nv * dv)
    delta = 8 * nv * dk * dv  # S·k, the rank-1 update, decay, S·q ≈ 4 dk·dv MACs per head
    out = 2 * nv * dv * d
    return in_proj + conv + delta + out


def text_forward_flops_per_token(cfg, *, kv_len):
    """Forward matmul FLOPs per processed token at attention context kv_len:
    GQA (gated in the hybrids), SwiGLU or MoE FFNs, GatedDeltaNet layers of
    the hybrids (Qwen3-Next, Qwen3.5 text) and the LM head."""
    layers = cfg["n_layers"]
    ratio = cfg.get("linear_sdpa_ratio")
    n_attn = layers // ratio if ratio else layers
    total = n_attn * _attn_layer_flops(cfg, kv_len)
    if layers > n_attn:
        total += (layers - n_attn) * _gdn_layer_flops(cfg)
    total += layers * _ffn_flops(cfg)
    total += 2 * cfg["emb_dim"] * cfg["vocab_size"]  # LM head
    return total


def swa_mean_context(window, seq_len):
    """Mean over positions 0..seq_len-1 of the keys a sliding-window query
    sees, min(pos + 1, window)."""
    return (window * (window + 1) / 2 + (seq_len - window) * window) / seq_len


def _deepseek_moe_flops(cfg):
    """Per-token FLOPs of one DeepSeek MoE sublayer: the router, top_k
    gated routed experts and every non-gated shared expert."""
    d, num_shared = cfg["emb_dim"], cfg["num_shared_experts"]
    sf = cfg["moe_scaling_factor"]
    hidden = int((1 / (cfg["top_k"] + num_shared) if sf == "auto" else sf) * cfg["hidden_dim"])
    router = 2 * d * (cfg["num_experts"] - num_shared)
    return router + cfg["top_k"] * 3 * 2 * d * hidden + num_shared * 2 * 2 * d * hidden


def mimo_train_flops_per_token(cfg, *, seq_len):
    """MiMo-V2-Flash's train-step FLOPs per token (module docstring): 3×
    the main model's forward and its MTP modules'."""
    d, window = cfg["emb_dim"], cfg["window_size"]

    def attn(swa, s):
        groups = cfg["num_swa_kv_groups"] if swa else cfg["num_ga_kv_groups"]
        kv_len = swa_mean_context(window, s) if swa and window < s else s / 2
        return _attn_layer_flops(dict(cfg, num_kv_groups=groups), kv_len)

    dense_ffn, head = 3 * 2 * d * cfg["hidden_dim"], 2 * d * cfg["vocab_size"]
    total = head
    for i in range(cfg["n_layers"]):
        ffn = _deepseek_moe_flops(cfg) if mimo_v2_flash.is_moe_layer(cfg, i) else dense_ffn
        total += attn(mimo_v2_flash.is_swa_layer(cfg, i), seq_len) + ffn
    for k in range(1, cfg.get("mtp_depth", 0) + 1):
        s_k = seq_len - k - 1
        total += (2 * 2 * d * d + attn(True, s_k) + dense_ffn + head) * s_k / seq_len
    return 3 * total


def _mla_flops(cfg, kv_len):
    """Per-token FLOPs of one MLA sublayer at context kv_len."""
    d, n = cfg["emb_dim"], cfg["n_heads"]
    hd, dhd = deepseek_v3.head_dims(cfg)
    qr, kvr = deepseek_v3.q_rank(cfg), 4 * hd
    q = 2 * d * qr + 2 * qr * d + 2 * qr * n * dhd  # down, up, decoupled
    kv = 2 * d * kvr + 2 * 2 * kvr * d + 2 * d * dhd  # down, k and v up, decoupled k
    out = 2 * d * d
    scores = 2 * kv_len * n * ((hd + dhd) + hd)  # QKᵀ at q/k width, AV at v width
    return q + kv + out + scores


def deepseek_train_flops_per_token(cfg, *, seq_len):
    """DeepSeek-V3's train-step FLOPs per token (module docstring): 3× the
    main model's forward and its MTP modules', causal attention at the mean
    context seq_len / 2."""
    d = cfg["emb_dim"]
    attn = _mla_flops(cfg, seq_len // 2)
    dense_ffn, head = 3 * 2 * d * cfg["hidden_dim"], 2 * d * cfg["vocab_size"]
    total = head
    for i in range(cfg["n_layers"]):
        total += attn + (dense_ffn if i < cfg["num_ffn"] else _deepseek_moe_flops(cfg))
    total += cfg["mtp_depth"] * (2 * 2 * d * d + attn + dense_ffn + head)
    return 3 * total


def text_train_flops_per_token(cfg, *, seq_len):
    """Train-step FLOPs per token: 3× forward, causal attention averaged over
    positions (mean context = seq_len / 2), sliding-window layers with a
    window below seq_len at ``swa_mean_context`` (module docstring);
    MiMo-V2-Flash by ``mimo_train_flops_per_token``, DeepSeek-V3 by
    ``deepseek_train_flops_per_token``."""
    if "hybrid_ratio" in cfg:
        return mimo_train_flops_per_token(cfg, seq_len=seq_len)
    if "num_ffn" in cfg:
        return deepseek_train_flops_per_token(cfg, seq_len=seq_len)
    total = text_forward_flops_per_token(cfg, kv_len=seq_len // 2)
    window = cfg.get("window_size", 0)
    if "local_global_att_ratio" in cfg and 0 < window < seq_len:
        n_swa = sum(is_swa_layer(cfg, i) for i in range(cfg["n_layers"]))
        total += n_swa * (_attn_layer_flops(cfg, swa_mean_context(window, seq_len))
                          - _attn_layer_flops(cfg, seq_len // 2))
    return 3 * total


def decode_bytes_per_token(params, cfg, *, kv_len, batch=1):
    """Device-memory bytes read per decode step ÷ batch: one pass over the
    weights as stored (int4 packed), shared by the batch, plus each
    sequence's KV cache at context kv_len (as stored: see the module
    docstring) and the hybrids' fp32 GDN states."""
    weights = param_bytes(params)
    ratio = cfg.get("linear_sdpa_ratio")
    layers = cfg["n_layers"]
    n_attn = layers // ratio if ratio else layers
    nkv = cfg.get("num_kv_groups", cfg["n_heads"])
    hd = cfg.get("head_dim", cfg["emb_dim"] // cfg["n_heads"])
    vhd = cfg.get("value_head_dim", hd)
    if cfg.get("kv_quant") == "int8":
        per_position = nkv * ((hd + vhd) + 2 * 4)  # int8 k and v, one fp32 scale each per head
    else:
        per_position = nkv * (hd + vhd) * torch.finfo(cfg.get("dtype", torch.float32)).bits // 8
    kv = n_attn * kv_len * per_position
    state = 0
    if ratio:
        nv, dk, dv = cfg["linear_num_value_heads"], cfg["linear_qk_head_dim"], cfg["linear_value_head_dim"]
        state = (layers - n_attn) * nv * dk * dv * 4  # the fp32 recurrent state
    return weights // batch + kv + state


# ----------------------------------------------------------------- vision


def vit_flops_per_image(cfg):
    """Forward matmul FLOPs per image for the scratch ViT (CLS + patches,
    bidirectional attention, GELU MLP at 4·d)."""
    p = cfg["patch_size"]
    n_patches = (cfg["img_height"] // p) * (cfg["img_width"] // p)
    n = n_patches + 1  # CLS
    d = cfg["emb_dim"]
    patchify = 2 * n_patches * cfg["num_channels"] * p * p * d
    per_layer = n * (8 * d * d + 16 * d * d) + 4 * n * n * d  # QKVO+MLP / scores
    head = 2 * d * cfg["num_classes"]
    return patchify + cfg["n_layers"] * per_layer + head


def vit_train_flops_per_image(cfg):
    return 3 * vit_flops_per_image(cfg)
