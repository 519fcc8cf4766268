"""Rotary position embeddings (counterpart of ``llm_quest_tpu/ops/rope.py``):
classic RoPE, NTK-aware + YaRN by-parts scaling, partial RoPE, MRoPE-I
(interleaved 3-D multimodal) and 2-D axial VisionRoPE.

Tables are built once in fp32 with numpy, exactly as the JAX package builds
them. Half-split convention: x = [h1, h2] → cos·x + sin·[-h2, h1].

Divergence by design: a YaRN ``freq_cfg`` that lacks a key the scaling
reads ("factor", "alpha", "beta", "og_ctx_len", and "ctx_len" when
``ntk_aware``) raises a ``ValueError`` naming the missing keys, where JAX
raises a bare ``KeyError`` (``LLAMA32_SMALL_CONFIG_1B``'s "rope_freq" names
"original_context_length" instead). No other key is mapped onto them.
"""

import numpy as np
import torch


def partial_rotation(head_dim, factor):
    """Scaled rotation dim = floor(head_dim * factor)."""
    if not 0 < factor <= 1.0:
        raise ValueError("rotation factor must be in (0, 1]")
    return int(head_dim * factor)


def ntk_aware_base_scaling(theta_base, head_dim, ctx_len, old_ctx_len):
    """Fixed NTK-aware θ-base scaling."""
    return theta_base * (ctx_len / old_ctx_len) ** (head_dim / (head_dim - 2))


_YARN_KEYS = ("factor", "alpha", "beta", "og_ctx_len")


def wavelength_scaling(base, head_dim, freq_cfg, ntk_aware=True):
    """YaRN NTK-by-parts smooth frequency scaling across three wavelength
    bands: full interpolation θ/factor where og_ctx_len / wavelength < alpha,
    θ untouched above beta, a linear blend between. Returns θ of shape
    (head_dim // 2,) fp32. Raises ``ValueError`` when ``freq_cfg`` lacks a
    key it reads (module docstring)."""
    missing = [k for k in _YARN_KEYS + (("ctx_len",) if ntk_aware else ()) if k not in freq_cfg]
    if missing:
        raise ValueError(f"rope_freq lacks {missing} (has {sorted(freq_cfg)}); the YaRN tables read "
                         f"{list(_YARN_KEYS)} and, NTK-aware, ctx_len")
    if ntk_aware:
        base = ntk_aware_base_scaling(base, head_dim, freq_cfg["ctx_len"], freq_cfg["og_ctx_len"])
    i = np.arange(0, head_dim // 2, dtype=np.float32)
    theta = 1.0 / base ** (2 * i / head_dim)

    wavelen = 2 * np.pi / theta
    ratio = freq_cfg["og_ctx_len"] / wavelen
    # low freq (ratio < alpha): full interpolation θ/factor; high freq: untouched
    scaled_theta = np.where(ratio < freq_cfg["alpha"], theta / freq_cfg["factor"], theta)
    # medium band: smooth blend γ = clamp((r - α)/(β - α), 0, 1)
    smooth = np.clip((ratio - freq_cfg["alpha"]) / (freq_cfg["beta"] - freq_cfg["alpha"]), 0.0, 1.0)
    smoothed_theta = (1 - smooth) * (theta / freq_cfg["factor"]) + smooth * theta
    is_medium = (ratio >= freq_cfg["alpha"]) & (ratio <= freq_cfg["beta"])
    return np.where(is_medium, smoothed_theta, scaled_theta)


def compute_angles(base, head_dim, ctx_len, *, smooth_scaling_cfg=None, ntk_aware=True, rotation_factor=1.0,
                   device=None):
    """(cos, sin) tables, each (ctx_len, rotation_dim) fp32; rotation_dim =
    floor(head_dim·rotation_factor) for partial RoPE. ``smooth_scaling_cfg``
    (a config's "rope_freq") applies ``wavelength_scaling`` to the
    frequencies, NTK-aware unless ``ntk_aware`` is False."""
    if head_dim % 2:
        raise ValueError("head_dim must be even")
    if rotation_factor != 1.0:
        head_dim = partial_rotation(head_dim, rotation_factor)
    if smooth_scaling_cfg is not None:
        theta = wavelength_scaling(base, head_dim, smooth_scaling_cfg, ntk_aware)
    else:
        i = np.arange(0, head_dim // 2, dtype=np.float32)
        theta = 1.0 / base ** (2 * i / head_dim)
    angles = np.outer(np.arange(0, ctx_len, dtype=np.float32), theta)
    angles = np.concatenate([angles, angles], axis=-1)
    return _tables(angles, device)


def compute_angles_2d(base, head_dim, height_patches, width_patches, *, num_frames=1, device=None):
    """2-D axial VisionRoPE tables: first half of head_dim encodes rows, second
    half columns. Returns (cos, sin), each (num_frames·H·W, head_dim) fp32."""
    if head_dim % 4:
        raise ValueError("head_dim must be divisible by 4 for 2D RoPE")
    half_dim = head_dim // 2
    i = np.arange(0, half_dim // 2, dtype=np.float32)
    theta = 1.0 / base ** (2 * i / half_dim)
    row_pos, col_pos = np.meshgrid(
        np.arange(height_patches, dtype=np.float32), np.arange(width_patches, dtype=np.float32), indexing="ij"
    )
    angles_2d = np.concatenate([np.outer(row_pos.reshape(-1), theta), np.outer(col_pos.reshape(-1), theta)], axis=-1)
    if num_frames > 1:
        angles_2d = np.tile(angles_2d, (num_frames, 1))
    return _tables(np.concatenate([angles_2d, angles_2d], axis=-1), device)


def _tables(angles, device):
    return (
        torch.from_numpy(np.cos(angles)).to(device),
        torch.from_numpy(np.sin(angles)).to(device),
    )


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _rotate(x, cos_g, sin_g):
    """cos·x + sin·rotate_half(x) over the first rotation_dim features; the
    rest pass through (partial RoPE)."""
    rot = cos_g.shape[-1]
    if rot < x.shape[-1]:
        x_rot, x_rest = x[..., :rot], x[..., rot:]
        return torch.cat([cos_g * x_rot + sin_g * rotate_half(x_rot), x_rest], dim=-1)
    return cos_g * x + sin_g * rotate_half(x)


def apply(x, cos, sin, position_ids=None):
    """RoPE on x: (b, n_heads, s, head_dim); cos/sin: (ctx_len, rotation_dim).
    position_ids: optional (b, s) int positions (default 0..s-1). With
    rotation_dim < head_dim only the first rotation_dim features rotate
    (partial RoPE)."""
    if position_ids is not None:
        cos_g = cos[position_ids][:, None].to(x.dtype)  # (b, 1, s, rot)
        sin_g = sin[position_ids][:, None].to(x.dtype)
    else:
        s = x.shape[2]
        cos_g, sin_g = cos[:s].to(x.dtype), sin[:s].to(x.dtype)
    return _rotate(x, cos_g, sin_g)


def apply_packed(x, cos, sin):
    """RoPE on the packed head layout x: (b, s, n_heads, head_dim), positions
    0..s-1 (the vision tower's transpose-free form)."""
    s = x.shape[1]
    return _rotate(x, cos[:s].to(x.dtype)[None, :, None, :], sin[:s].to(x.dtype)[None, :, None, :])


def interleave_mrope_coeffs(cos3, sin3, mrope_section):
    """MRoPE-I: interleave chunked [TTT..HHH..WWW] rotary coeffs into the
    [T,H,W, T,H,W, ..., T,T] layout. cos3/sin3: (3, b, s, half_dim) →
    (b, s, half_dim) each. T fills every slot by default; H takes the
    stride-3 slots from 1, W those from 2, each within its section."""
    sel, feat = _mrope_select(cos3.shape[-1], tuple(mrope_section), cos3.device)
    return cos3[sel, ..., feat].movedim(0, -1), sin3[sel, ..., feat].movedim(0, -1)


_MROPE_SELECT = {}


def _mrope_select(half_dim, mrope_section, device):
    """(section of each rotary feature, feature index) as tensors on
    ``device``, made once: a decode step copies nothing from the host."""
    key = (half_dim, mrope_section, device)
    if key not in _MROPE_SELECT:
        feat = np.arange(half_dim)
        sel = np.zeros(half_dim, dtype=np.int64)
        sel[(feat % 3 == 1) & (feat < mrope_section[1] * 3)] = 1
        sel[(feat % 3 == 2) & (feat < mrope_section[2] * 3)] = 2
        _MROPE_SELECT[key] = (torch.from_numpy(sel).to(device), torch.arange(half_dim, device=device))
    return _MROPE_SELECT[key]


def apply_mrope(x, cos, sin, position_ids, mrope_section):
    """Multimodal RoPE with interleaved 3-D (T, H, W) sections.

    x: (b, h, s, head_dim); cos/sin: (ctx_len, rotation_dim) tables;
    position_ids: (3, b, s). Identical T=H=W ids reduce to standard RoPE.
    """
    half_dim = cos.shape[-1] // 2
    mcos, msin = interleave_mrope_coeffs(
        cos[:, :half_dim][position_ids], sin[:, :half_dim][position_ids], mrope_section
    )
    mcos = torch.cat([mcos, mcos], dim=-1)[:, None].to(x.dtype)  # (b, 1, s, rot)
    msin = torch.cat([msin, msin], dim=-1)[:, None].to(x.dtype)
    return _rotate(x, mcos, msin)
