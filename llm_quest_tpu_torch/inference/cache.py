"""Static-shape KV cache (counterpart of ``llm_quest_tpu/inference/cache.py``).

The cache is a dict of tensors pre-allocated to ``max_len`` once, layout
(n_layers, b, n_kv_heads, max_len, head_dim), plus an int ``pos`` counting
the filled positions. Unlike the JAX version, writes go IN PLACE into the
preallocated buffers (no copy of the cache per step); ``pos`` is a plain int
returned in a new dict. Only scalar-position writes are ported; the per-row
vector positions and the int8 cache of continuous-batching serving wait for
the serving port.
"""

import torch


def init_kv_cache(n_layers, batch, n_kv_heads, max_len, head_dim, *, dtype=torch.float32, device=None):
    """Zero-filled cache {"k", "v", "pos"}."""
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }


def update_layer(cache, layer_idx, k_new, v_new):
    """``write_layer`` at the cache's own position (models with one stacked
    KV cache, e.g. Qwen3); ``pos`` is advanced by ``advance`` after the last
    layer."""
    return write_layer(cache, layer_idx, k_new, v_new, cache["pos"])


def write_layer(cache, layer_idx, k_new, v_new, pos):
    """Write (b, h, s, d) new keys/values at column ``pos`` of layer
    ``layer_idx`` in place; returns (cache, full max_len k view, v view).
    ``pos`` is not advanced here."""
    s = k_new.shape[2]
    cache["k"][layer_idx, :, :, pos : pos + s] = k_new
    cache["v"][layer_idx, :, :, pos : pos + s] = v_new
    return cache, cache["k"][layer_idx], cache["v"][layer_idx]


def cur_token_mask(attn_mask, s, pos0):
    """The s columns of the (b, max_len) validity mask the current call
    covers, starting at ``pos0``."""
    if attn_mask is None:
        return None
    if attn_mask.shape[1] == s:
        return attn_mask
    return attn_mask[:, pos0 : pos0 + s]


def advance(cache, seq_len):
    """The cache with its filled-position counter advanced by seq_len."""
    return {**cache, "pos": cache["pos"] + seq_len}


def max_len(cache):
    return cache["k"].shape[3]
