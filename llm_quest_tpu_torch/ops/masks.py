"""Attention mask construction (counterpart of ``llm_quest_tpu/ops/masks.py``).

Polarity: boolean masks built here are True = MASKED. (b, s) padding masks
coming in are True = REAL token and are inverted when combined. The flash
kernel's ``attn_mask`` keeps the padding polarity: (b, sk), True = real key.
Masked scores are filled with finfo.min/2, not -inf, so a fully-masked row
softmaxes to uniform instead of NaN.
"""

import torch


def mask_value(dtype):
    """finfo.min/2 fill value."""
    return torch.finfo(dtype).min / 2


def causal_mask(q_len, k_len=None, *, q_start=0, window_size=None, attn_mask=None, device=None):
    """(b|1, 1, q_len, k_len) bool mask, True = masked.

    Queries sit at absolute positions q_start .. q_start+q_len-1 against keys
    0 .. k_len-1 (no cache: q_start=0, k_len=q_len; static KV cache:
    q_start=pos, k_len=max_len). ``q_start`` may be a (b,) tensor of per-row
    offsets (continuous-batching serving: each slot at its own position),
    which gives a (b, 1, q_len, k_len) mask. window_size: optional sliding
    window; keys at or below q_pos - window_size are masked too (Gemma SWA).
    attn_mask: optional (b, k_len) bool padding mask, True = real token.
    """
    if k_len is None:
        k_len = q_len
    if attn_mask is not None:
        device = attn_mask.device
    elif torch.is_tensor(q_start):
        device = q_start.device
    k_pos = torch.arange(k_len, device=device)
    q_pos = torch.arange(q_len, device=device)
    if torch.is_tensor(q_start) and q_start.ndim >= 1:
        q_pos = q_start[:, None] + q_pos[None, :]  # (b, q)
    else:
        q_pos = (q_start + q_pos)[None]  # (1, q)
    masked = k_pos[None, None, :] > q_pos[:, :, None]
    if window_size is not None:
        masked = masked | (k_pos[None, None, :] <= q_pos[:, :, None] - window_size)
    masked = masked[:, None]
    if attn_mask is not None:
        masked = masked | ~attn_mask[:, None, None, :]
    return masked


def bidirectional_mask(attn_mask):
    """(b, k) padding mask, True = real token → (b, 1, 1, k), True = masked
    (the vision encoder's); None stays None."""
    if attn_mask is None:
        return None
    return ~attn_mask[:, None, None, :]


def swa_causal_mask_table(ctx_len, window_size, *, device=None):
    """The materialized (ctx, ctx) sliding-window causal mask, True = masked:
    future keys and keys at or below q_pos - window_size. Built on the
    device (kept for parity checks against the buffer variant)."""
    pos = torch.arange(ctx_len, device=device)
    offset = pos[None, :] - pos[:, None]  # key - query
    return (offset > 0) | (offset <= -window_size)
