"""Model configurations (counterpart of ``llm_quest_tpu/config.py``).

Plain dicts with the reference's keys; dtypes are torch dtypes. Only the
configurations of the ported slices are here: GPT-2 124M and small (and
the family's sizes, ``gpt2_config_creator``),
Llama-3.2-1B and small, Qwen3.5-0.8B, the Qwen3 entries (dense and MoE),
Qwen3-Next-small, Gemma-3-small, DeepSeek-V3 small, MiMo-V2-Flash small and
the two ViTs.
A config without a "dtype" key (the ViTs, as in the JAX package) runs in
torch.float32 (``model_dtype``).
"""

import torch

# GPT-2 124M and the small training config (same keys and values as the JAX
# package's; no "dtype" key: fp32 unless the caller sets one)
GPT_CONFIG_124M = {
    "vocab_size": 50257,
    "context_length": 1024,
    "emb_dim": 768,
    "n_heads": 12,
    "n_layers": 12,
    "drop_rate": 0.0,
    "qkv_bias": True,
}

GPT_SMALL_CONFIG = {
    "vocab_size": 50304,
    "context_length": 256,
    "emb_dim": 768,
    "n_heads": 12,
    "n_layers": 12,
    "drop_rate": 0.0,
    "qkv_bias": False,
}

# Llama-3.2-1B (same keys and values as the JAX package's). Its "rope_freq"
# names "original_context_length", as the JAX config does, and has neither
# "ctx_len" nor "og_ctx_len": ``llama3.rope_tables(scaled=True)`` refuses it
# with a ValueError naming the missing keys (JAX raises a bare KeyError).
LLAMA32_SMALL_CONFIG_1B = {
    "vocab_size": 128_256,
    "context_length": 131_072,
    "emb_dim": 2048,
    "n_heads": 32,
    "n_layers": 16,
    "hidden_dim": 8192,
    "num_kv_groups": 8,
    "rope_base": 500_000,
    "rope_freq": {
        "factor": 32.0,
        "alpha": 1.0,
        "beta": 4.0,
        "original_context_length": 8192,
    },
    "dtype": torch.bfloat16,
}

# Llama-3.2 small (same keys and values as the JAX package's), with the
# YaRN / NTK-by-parts context extension of ``rope_tables(scaled=True)``
LLAMA32_SMALL_CONFIG = {
    "vocab_size": 50304,
    "context_length": 512,
    "emb_dim": 768,
    "n_heads": 12,
    "n_layers": 12,
    "num_kv_groups": 4,
    "hidden_dim": 4 * 768,
    "rope_base": 10_000,
    "rope_freq": {
        "factor": 32.0,
        "alpha": 1.0,
        "beta": 32.0,
        "og_ctx_len": 4096,
        "ctx_len": 8192,
    },
    "dtype": torch.float32,
}

# DeepSeek-V3 small (same keys and values as the JAX package's): MLA with the
# default q_rank 1536, the first num_ffn layers dense SwiGLU, then DeepSeek
# MoE (num_experts counts the shared expert), pre-shifted MTP of depth 2.
# "rope_freq" is kept as JAX keeps it; DeepSeek's RoPE tables do not read it.
DEEPSEEK_SMALL_CONFIG = {
    "vocab_size": 50304,
    "context_length": 512,
    "emb_dim": 768,
    "n_heads": 12,
    "n_layers": 12,
    "hidden_dim": 4 * 768,
    "num_ffn": 3,
    "num_experts": 8,
    "num_shared_experts": 1,
    "top_k": 3,
    "moe_scaling_factor": "auto",  # "auto" → width scaled by 1/(top_k + num_shared)
    "moe_bias_update_rate": 1e-3,
    "mtp_depth": 2,
    "mtp_loss_coeff": 0.2,
    "rope_base": 10_000,
    "rope_freq": {
        "factor": 32.0,
        "alpha": 1.0,
        "beta": 32.0,
        "og_ctx_len": 4096,
        "ctx_len": 8192,
    },
    "dtype": torch.float32,
}

# Gemma-3 small (same keys and values as the JAX package's)
GEMMA3_SMALL_CONFIG = {
    "vocab_size": 50304,
    "context_length": 512,
    "emb_dim": 768,
    "n_heads": 12,
    "n_layers": 12,
    "num_kv_groups": 6,
    "hidden_dim": 4 * 768,
    "window_size": 3,
    # 0 → all global attn; n_layers → all SWA; else alternate every Nth layer global
    "local_global_att_ratio": 5,
    "rope_base": 10_000,
    "rope_freq": {
        "factor": 32.0,
        "alpha": 1.0,
        "beta": 32.0,
        "og_ctx_len": 4096,
        "ctx_len": 8192,
    },
    "logits_softcap": 30.0,
    "dtype": torch.float32,
}

# MiMo-V2-Flash small (same keys and values as the JAX package's): SWA with
# sinks and GA layers (layer 0 and every hybrid_ratio-th), decoupled value
# head dim, DeepSeek MoE from layer 1, shrinking-slice MTP
MIMO_V2_SMALL_CONFIG = {
    "vocab_size": 50304,
    "context_length": 512,
    "emb_dim": 768,
    "n_layers": 12,
    "n_heads": 12,
    "num_swa_kv_groups": 4,
    "num_ga_kv_groups": 2,
    "head_dim": 64,
    "value_head_dim": 32,
    "hidden_dim": 4 * 768,
    "window_size": 128,
    "hybrid_ratio": 6,  # every 6th layer global attention; layer 0 also GA
    "rope_base": 10_000,
    "rope_base_ga": 640_000,
    "partial_rope_factor": 0.33,
    "mtp_depth": 2,
    "mtp_loss_coeff": 0.3,
    "num_experts": 8,
    "top_k": 2,
    "num_shared_experts": 0,
    "moe_scaling_factor": 1.0,
    "moe_bias_update_rate": 1e-3,
    "dtype": torch.float32,
}

# Qwen3-Next small hybrid (same keys and values as the JAX package's): 8
# blocks, GatedAttention every 4th, Qwen3-MoE FFNs with a weighted shared expert
QWEN3_NEXT_SMALL_CONFIG = {
    "vocab_size": 151_936,
    "rope_base": 10_000,
    "partial_rope_factor": 0.25,
    "n_layers": 8,
    "linear_sdpa_ratio": 4,
    "dtype": torch.bfloat16,
    "tie_embeddings": False,
    "emb_dim": 896,
    # gated attention
    "head_dim": 64,
    "n_heads": 8,
    "num_kv_groups": 4,
    "context_length": 512,
    # gated deltanet
    "linear_num_qk_heads": 4,
    "linear_num_value_heads": 8,
    "linear_qk_head_dim": 64,
    "linear_value_head_dim": 64,
    "linear_conv_kernel_size": 4,
    # moe
    "re_init_router_weights": True,
    "moe_hidden_dim": 4 * 896,
    "shared_expert_hidden_dim": 4 * 896,
    "num_experts": 8,
    "top_k": 2,
    "aux_loss_coef": 0.001,
    # training
    "p_dropout": 0.1,
}

# Qwen3.5-0.8B Vision + Text config (same keys and values as the JAX package's)
QWEN3_5_08B_CONFIG = {
    # ------ Text config keys ------
    "model_path": "Qwen/Qwen3.5-0.8B",
    "vocab_size": 248_320,
    "emb_dim": 1024,
    "hidden_dim": 3584,
    "n_layers": 24,
    "linear_sdpa_ratio": 4,
    "n_heads": 8,
    "num_kv_groups": 2,
    "head_dim": 256,
    "rope_base": 10_000_000,
    "partial_rope_factor": 0.25,
    "context_length": 8192,
    # GDN
    "linear_num_qk_heads": 16,
    "linear_num_value_heads": 16,
    "linear_qk_head_dim": 128,
    "linear_value_head_dim": 128,
    "linear_conv_kernel_size": 4,
    "tie_embeddings": True,
    "dtype": torch.bfloat16,
    "p_dropout": 0.0,
    "training": False,
    # interleaved 3D (T, H, W) MRoPE sections; sum == head_dim * partial_rope_factor / 2
    "mrope_section": [11, 11, 10],
    # ------ Vision config keys ------
    "vision_n_layers": 12,
    "vision_emb_dim": 768,
    "vision_hidden_act": "gelu_pytorch_tanh",
    "vision_hidden_dim": 3072,
    "vision_num_heads": 12,
    "llm_d_in": 1024,
    "in_channels": 3,
    "patch_size": 16,
    "spatial_merge_size": 2,
    "temporal_patch_size": 2,
    "num_position_embeddings": 2304,
    "img_width": 384,
    "img_height": 384,
    "vision_rope_base": 10_000,
    # Special token IDs
    "image_token_id": 248056,
    "vision_start_token_id": 248053,
    "vision_end_token_id": 248054,
    "video_token_id": 248057,
    "image_mean": [0.5, 0.5, 0.5],
    "image_std": [0.5, 0.5, 0.5],
}


# ViT-B/16 at 224 px and the CIFAR-sized TinyViT (same keys and values as the JAX package's)
VIT_BASE_CONFIG = {
    "img_width": 224,
    "img_height": 224,
    "patch_size": 16,
    "num_channels": 3,
    "emb_dim": 768,
    "n_layers": 12,
    "n_heads": 12,
    "drop_rate": 0.1,
    "qkv_bias": True,
    "num_classes": 100,
}

TINY_VIT_CONFIG = {
    "img_width": 32,
    "img_height": 32,
    "patch_size": 4,
    "num_channels": 3,
    "emb_dim": 256,
    "n_layers": 12,
    "n_heads": 8,
    "drop_rate": 0.3,
    "qkv_bias": True,
    "num_classes": 10,
}


def gpt2_config_creator(gpt_size):
    """GPT-2 family configs with the JAX package's values (``GPT_CONFIG_124M``
    at another size); gpt_size: "gpt_s" (124M) | "gpt_m" (355M) | "gpt_l"
    (774M) | "gpt_xl" (1558M)."""
    model_configs = {
        "gpt_s": {"emb_dim": 768, "n_layers": 12, "n_heads": 12, "qkv_bias": True},
        "gpt_m": {"emb_dim": 1024, "n_layers": 24, "n_heads": 16, "qkv_bias": True},
        "gpt_l": {"emb_dim": 1280, "n_layers": 36, "n_heads": 20, "qkv_bias": True},
        "gpt_xl": {"emb_dim": 1600, "n_layers": 48, "n_heads": 25, "qkv_bias": True},
    }
    return {**GPT_CONFIG_124M, **model_configs[gpt_size]}


def qwen3_config_creator(model_size="0.6B", base_model=True):
    """Qwen3 configs with the JAX package's values (HF config.json);
    model_size: "temp_dense" | "0.6B" | "1.7B" | "4B" (dense) or "temp_moe" |
    "30B-A3B" (MoE: untied head, Qwen3-MoE FFNs without a shared expert)."""
    base_config = {
        "vocab_size": 151_936,
        "rope_base": 1_000_000,
        "head_dim": 128,
        "dtype": torch.bfloat16,
        "model_path": f"Qwen/Qwen3-{model_size}{'-Base' if base_model else ''}",
        "model_type": "dense",
        "tie_embeddings": True,
    }
    configs = {
        "temp_dense": {"emb_dim": 896, "n_layers": 12, "n_heads": 8, "num_kv_groups": 4,
                       "hidden_dim": 4 * 896, "context_length": 512},
        "0.6B": {"emb_dim": 1024, "n_layers": 28, "n_heads": 16, "num_kv_groups": 8,
                 "hidden_dim": 3072, "context_length": 40_960},
        "1.7B": {"emb_dim": 2048, "n_layers": 28, "n_heads": 16, "num_kv_groups": 8,
                 "hidden_dim": 6144, "context_length": 40_960},
        "4B": {"emb_dim": 2560, "n_layers": 36, "n_heads": 32, "num_kv_groups": 8,
               "hidden_dim": 9728, "context_length": 40_960},
        "temp_moe": {"model_type": "moe", "emb_dim": 896, "n_layers": 12, "n_heads": 8, "num_kv_groups": 4,
                     "moe_hidden_dim": 4 * 896, "context_length": 512, "tie_embeddings": False,
                     "num_experts": 16, "top_k": 4, "aux_loss_coef": 0.001},
        "30B-A3B": {"model_type": "moe", "emb_dim": 2048, "n_layers": 48, "n_heads": 32, "num_kv_groups": 4,
                    "hidden_dim": 6144, "moe_hidden_dim": 768, "context_length": 40_960, "tie_embeddings": False,
                    "num_experts": 128, "top_k": 8, "aux_loss_coef": 0.001},
    }
    if model_size not in configs:
        raise ValueError(f"Unknown model size: {model_size}. Available sizes: {list(configs)}")
    return {**base_config, **configs[model_size]}


def model_dtype(cfg):
    """Resolve a config's parameter/computation dtype (default fp32)."""
    return cfg.get("dtype", torch.float32)


def resolve_device(device=None):
    """The device a public entry point allocates on: ``device`` as given, or
    the current CUDA device for None. The port runs on the card: None with no
    CUDA device present raises ``RuntimeError`` (CPU callers say
    ``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to build on the CPU')
    return torch.device("cuda", torch.cuda.current_device())
