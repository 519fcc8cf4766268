"""Static-shape KV cache (counterpart of ``llm_quest_tpu/inference/cache.py``).

The cache is a dict of tensors pre-allocated to ``max_len`` once, layout
(n_layers, b, n_kv_heads, max_len, head_dim) for k and the same with
``v_head_dim`` (default head_dim) for v, plus an int ``pos`` counting the
filled positions. Unlike the JAX version, writes go IN PLACE into the
preallocated buffers (no copy of the cache per step); ``pos`` is a plain int
returned in a new dict.

``quant="int8"`` allocates the int8 serving cache instead ({"k_q", "k_s",
"v_q", "v_s", "pos"}): int8 data and per-(layer, row, head, position) fp32
scales, kept with JAX's trailing singleton. New keys and values are quantized
once at write time (``ops/quantization.py::quantize_rows_int8``) and the
layer views come back as ``QuantKV``, which the attention router streams
through K10 or dequantizes.

``pos`` may also be a (b,) tensor of per-row columns (continuous-batching
serving, inference/serving.py: each slot writes at its own column). Those
writes go in place by advanced indexing; the JAX package's positional select
(``_vector_pos_write``) is a TPU choice, where per-row scatters serialize.
"""

import torch

from llm_quest_tpu_torch.ops.quantization import QuantKV, quantize_rows_int8


def init_kv_cache(n_layers, batch, n_kv_heads, max_len, head_dim, *, v_head_dim=None, dtype=torch.float32,
                  device=None, quant=None):
    """Zero-filled cache {"k", "v", "pos"}, or the int8 cache with
    ``quant="int8"``; v rows are ``v_head_dim`` wide (default ``head_dim``:
    MLA caches q/k at 96 and v at 64)."""
    shape = (n_layers, batch, n_kv_heads, max_len, head_dim)
    v_shape = shape[:4] + (head_dim if v_head_dim is None else v_head_dim,)
    if quant == "int8":
        return {
            "k_q": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_s": torch.zeros(*shape[:4], 1, dtype=torch.float32, device=device),
            "v_q": torch.zeros(v_shape, dtype=torch.int8, device=device),
            "v_s": torch.zeros(*shape[:4], 1, dtype=torch.float32, device=device),
            "pos": 0,
        }
    if quant is not None:
        raise ValueError(f"quant must be None or 'int8', got {quant!r}")
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(v_shape, dtype=dtype, device=device),
        "pos": 0,
    }


def update_layer(cache, layer_idx, k_new, v_new):
    """``write_layer`` at the cache's own position (models with one stacked
    KV cache, e.g. Qwen3); ``pos`` is advanced by ``advance`` after the last
    layer."""
    return write_layer(cache, layer_idx, k_new, v_new, cache["pos"])


def is_vector(pos):
    """True for a (b,) tensor of per-row positions."""
    return torch.is_tensor(pos) and pos.ndim >= 1


def write_layer(cache, layer_idx, k_new, v_new, pos):
    """Write (b, h, s, d) new keys/values at column ``pos`` (an int, or a
    (b,) tensor of per-row columns) of layer ``layer_idx`` in place; returns
    (cache, full max_len k view, v view) — ``QuantKV`` views for an int8
    cache. ``pos`` is not advanced here."""
    if "k_q" in cache:
        for name, new in (("k", k_new), ("v", v_new)):
            data, scale = quantize_rows_int8(new)
            write_kv(cache[f"{name}_q"], data, layer_idx, pos)
            write_kv(cache[f"{name}_s"], scale[..., None], layer_idx, pos)
        return (
            cache,
            QuantKV(cache["k_q"][layer_idx], cache["k_s"][layer_idx, ..., 0]),
            QuantKV(cache["v_q"][layer_idx], cache["v_s"][layer_idx, ..., 0]),
        )
    write_kv(cache["k"], k_new, layer_idx, pos)
    write_kv(cache["v"], v_new, layer_idx, pos)
    return cache, cache["k"][layer_idx], cache["v"][layer_idx]


def write_kv(buf, new, layer_idx, pos):
    """Write (b, h, s, d) ``new`` in place into the stacked (L, b, H, max_len,
    d) ``buf`` at ``layer_idx`` from column ``pos``: an int (every row at the
    same column) or a (b,) tensor (each row at its own). Only the first h
    head rows are written when ``new`` carries fewer heads than the buffer
    (JAX's rule for models whose layer types differ in KV groups)."""
    b, h, s = new.shape[:3]
    if is_vector(pos):
        rows = torch.arange(b, device=buf.device)[:, None]
        cols = pos[:, None] + torch.arange(s, device=buf.device)[None, :]
        buf[layer_idx, rows, :h, cols] = new.transpose(1, 2).to(buf.dtype)  # indexed dims first: (b, s, h, d)
    else:
        buf[layer_idx, :, :h, pos : pos + s] = new
    return buf


def cur_token_mask(attn_mask, s, pos0):
    """The s columns of the (b, max_len) validity mask the current call
    covers, starting at ``pos0`` (an int or a (b,) tensor)."""
    if attn_mask is None:
        return None
    if attn_mask.shape[1] == s:
        return attn_mask
    if is_vector(pos0):
        cols = pos0[:, None] + torch.arange(s, device=attn_mask.device)[None, :]
        return torch.gather(attn_mask, 1, cols)
    return attn_mask[:, pos0 : pos0 + s]


def advance(cache, seq_len):
    """The cache with its filled-position counter advanced by seq_len."""
    return {**cache, "pos": cache["pos"] + seq_len}


def max_len(cache):
    return cache["k_q" if "k_q" in cache else "k"].shape[3]
