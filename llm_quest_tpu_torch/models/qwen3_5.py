"""Qwen3.5 VLM: 3-D-patch ViT + hybrid FusedGDN / MRoPE-attention text model
(counterpart of ``llm_quest_tpu/models/qwen3_5.py``).

The ``nn.Module`` classes hold the parameters under the JAX parameter tree's
names (``blocks.3.att.w_qkv.w`` is ``blocks/3/att/w_qkv/w`` there); the
functions with the JAX package's names compute on them. Decode runs on the
hybrid static cache (stacked KV for the attention layers, rolling conv taps
and fp32 recurrent states for the GDN layers), updated in place, and the
vision tower runs once per prompt.

Kernels on this path (``llm_quest_tpu_torch/kernels``): the vision blocks'
packed attention (K7), the GDN prefill (K1) and decode step (K2), the
attention layers' flash prefill (K4) and, with ``cfg["kv_quant"] = "int8"``,
their decode step over the int8 KV cache (K10). Everything else is plain
torch. A model quantized by ``ops/quantization.py::quantize_params_int8``
serves unchanged: its linears are ``QuantLinear``s, and the embedding and
tied head read an int8 table through ``ops/linear.py``.
"""

import numpy as np
import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import cache as kv_cache
from llm_quest_tpu_torch.ops import gdn as gdn_ops
from llm_quest_tpu_torch.ops import rope
from llm_quest_tpu_torch.ops.activations import gelu_erf, gelu_tanh, silu
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, mha_packed, split_heads
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params, tied_head
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.mlp import swiglu
from llm_quest_tpu_torch.ops.norms import layer_norm_torch, rms_norm_torch_parity, zero_centered_rms_norm
from llm_quest_tpu_torch.ops.sampling import sampling


def _layer_norm(dim, dtype, device):
    return params(
        scale=torch.ones(dim, dtype=dtype, device=device), shift=torch.zeros(dim, dtype=dtype, device=device)
    )


def _rms_norm(dim, dtype, device, *, zero_centered):
    fill = torch.zeros if zero_centered else torch.ones
    return params(scale=fill(dim, dtype=dtype, device=device))


# ================================================================ vision tower


def n_patches_hw(cfg):
    return cfg["img_height"] // cfg["patch_size"], cfg["img_width"] // cfg["patch_size"]


class PatchEmbedding3D(nn.ParameterDict):
    """Conv3d (t_patch, p, p), stride = kernel, kept in conv layout."""

    def __init__(self, cfg, dtype, device):
        p, tp, c, d = cfg["patch_size"], cfg["temporal_patch_size"], cfg["in_channels"], cfg["vision_emb_dim"]
        super().__init__(params(
            conv_w=torch.empty(d, c, tp, p, p, dtype=dtype, device=device),
            conv_b=torch.empty(d, dtype=dtype, device=device),
        ))

    def reset_parameters(self, generator):
        bound = 1.0 / (self["conv_w"][0].numel() ** 0.5)
        for p in self.values():
            p.uniform_(-bound, bound, generator=generator)


def patch_embedding_3d(params, cfg, x):
    """x: (b, c, T, H, W) → (b, N, vision_emb_dim); N = (T/tp)·(H/p)·(W/p).
    Conv3d stride=kernel as reshape + matmul. The pixels are cast to the
    weight dtype (torch does not promote a matmul's mixed dtypes)."""
    b, c, t, hh, ww = x.shape
    p, tp = cfg["patch_size"], cfg["temporal_patch_size"]
    d = params["conv_w"].shape[0]
    nt, nh, nw = t // tp, hh // p, ww // p
    patches = (
        x.to(params["conv_w"].dtype)
        .reshape(b, c, nt, tp, nh, p, nw, p)
        .permute(0, 2, 4, 6, 1, 3, 5, 7)  # (b, nt, nh, nw, c, tp, p, p)
        .reshape(b, nt * nh * nw, c * tp * p * p)
    )
    return torch.nn.functional.linear(patches, params["conv_w"].reshape(d, -1), params["conv_b"])


class VisionBlock(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hidden = cfg["vision_emb_dim"], cfg["vision_hidden_dim"]
        self.norm1 = _layer_norm(d, dtype, device)
        self.qkv = Linear(d, 3 * d, bias=True, dtype=dtype, device=device)
        self.proj = Linear(d, d, bias=True, dtype=dtype, device=device)
        self.norm2 = _layer_norm(d, dtype, device)
        self.fc1 = Linear(d, hidden, bias=True, dtype=dtype, device=device)
        self.fc2 = Linear(hidden, d, bias=True, dtype=dtype, device=device)


class MergeAdapter(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["vision_emb_dim"]
        merged = d * cfg["spatial_merge_size"] ** 2
        self.norm = _layer_norm(d, dtype, device)
        self.lin1 = Linear(merged, merged, bias=True, dtype=dtype, device=device)
        self.lin2 = Linear(merged, cfg["llm_d_in"], bias=True, dtype=dtype, device=device)


def merge_adapter(params, cfg, x):
    """LayerNorm → m×m spatial merge concat → GELU MLP → llm_dim."""
    b, n, d = x.shape
    m = cfg["spatial_merge_size"]
    nh, nw = n_patches_hw(cfg)
    t = n // (nh * nw)
    x = layer_norm_torch(x, params.norm["scale"], params.norm["shift"])
    x = x.reshape(b, t, nh // m, m, nw // m, m, d).permute(0, 1, 2, 4, 3, 5, 6).reshape(b, -1, d * m * m)
    return params.lin2(gelu_erf(params.lin1(x)))


class VisionTower(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.patch_embed = PatchEmbedding3D(cfg, dtype, device)
        n_pos, d = cfg["num_position_embeddings"], cfg["vision_emb_dim"]
        self.pos_embed = params(w=torch.empty(n_pos, d, dtype=dtype, device=device))
        self.blocks = nn.ModuleList([VisionBlock(cfg, dtype, device) for _ in range(cfg["vision_n_layers"])])
        self.merge = MergeAdapter(cfg, dtype, device)

    def reset_parameters(self, generator):
        self.pos_embed["w"].normal_(generator=generator)  # torch nn.Embedding default


def vision_rope_tables(cfg, device=None):
    nh, nw = n_patches_hw(cfg)
    return rope.compute_angles_2d(
        cfg["vision_rope_base"], cfg["vision_emb_dim"] // cfg["vision_num_heads"], nh, nw, device=device
    )


def _vision_attention(block, cfg, x, cos, sin):
    b, s, d = x.shape
    nhh = cfg["vision_num_heads"]
    q, k, v = block.qkv(x).chunk(3, dim=-1)
    dh = q.shape[-1] // nhh
    # packed head layout end to end: RoPE on the (b, s, h, d) view, then the
    # packed kernel reads (b, s, h·d) by stride
    q = rope.apply_packed(q.reshape(b, s, nhh, dh), cos, sin).reshape(b, s, -1)
    k = rope.apply_packed(k.reshape(b, s, nhh, dh), cos, sin).reshape(b, s, -1)
    return block.proj(mha_packed(q, k, v, nhh, cfg=cfg))


def apply_vision(params, cfg, pixels):
    """pixels: (b, c, T, H, W) → (b, num_merged_patches, llm_d_in)."""
    nh, nw = n_patches_hw(cfg)
    n_spatial = nh * nw
    h = patch_embedding_3d(params.patch_embed, cfg, pixels)
    seq_len = h.shape[1]
    n_frames = seq_len // n_spatial

    # spatial pos-embeddings repeated across frames
    pos = params.pos_embed["w"][:n_spatial]
    h = h + pos.repeat(n_frames, 1)[None, :seq_len].to(h.dtype)

    cos, sin = vision_rope_tables(cfg, device=h.device)
    cos, sin = cos.repeat(n_frames, 1), sin.repeat(n_frames, 1)

    for block in params.blocks:
        hn = layer_norm_torch(h, block.norm1["scale"], block.norm1["shift"])
        h = h + _vision_attention(block, cfg, hn, cos, sin)
        hn = layer_norm_torch(h, block.norm2["scale"], block.norm2["shift"])
        h = h + block.fc2(gelu_tanh(block.fc1(hn)))
    return merge_adapter(params.merge, cfg, h)


# ================================================================= text model


def is_gdn_layer(cfg, layer_idx):
    return (layer_idx + 1) % cfg["linear_sdpa_ratio"] != 0


def gdn_layer_indices(cfg):
    return [i for i in range(cfg["n_layers"]) if is_gdn_layer(cfg, i)]


def attn_layer_indices(cfg):
    return [i for i in range(cfg["n_layers"]) if not is_gdn_layer(cfg, i)]


def _fused_dims(cfg):
    d_qk = cfg["linear_num_qk_heads"] * cfg["linear_qk_head_dim"]
    d_vg = cfg["linear_num_value_heads"] * cfg["linear_value_head_dim"]
    return d_qk, d_vg, 2 * d_qk + d_vg


class FusedGDN(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        d_qk, d_vg, fused = _fused_dims(cfg)
        nv = cfg["linear_num_value_heads"]
        self.w_qkv = Linear(d, fused, bias=False, dtype=dtype, device=device)
        self.w_gate = Linear(d, d_vg, bias=False, dtype=dtype, device=device)
        self.w_beta = Linear(d, nv, bias=False, dtype=dtype, device=device)
        self.w_alpha = Linear(d, nv, bias=False, dtype=dtype, device=device)
        self.log_A = nn.Parameter(torch.empty(nv, dtype=torch.float32, device=device), requires_grad=False)
        self.dt_bias = nn.Parameter(torch.ones(nv, dtype=dtype, device=device), requires_grad=False)
        self.conv1d = params(w=torch.empty(fused, cfg["linear_conv_kernel_size"], dtype=dtype, device=device))
        self.post_norm = _rms_norm(cfg["linear_value_head_dim"], torch.float32, device, zero_centered=False)
        self.out_proj = Linear(d_vg, d, bias=False, dtype=dtype, device=device)

    def reset_parameters(self, generator):
        self.log_A.copy_(torch.log(torch.empty_like(self.log_A).uniform_(0.0, 16.0, generator=generator)))
        bound = 1.0 / (self.conv1d["w"].shape[1] ** 0.5)  # torch Conv1d init, fan_in = kernel_size
        self.conv1d["w"].uniform_(-bound, bound, generator=generator)


def _fused_gdn_heads(cfg, q, k, v):
    """Sequence-major head split (b, s, c) → (b, h, s, hd) views."""
    b, s = q.shape[:2]
    nqk, dqk = cfg["linear_num_qk_heads"], cfg["linear_qk_head_dim"]
    nv, dv = cfg["linear_num_value_heads"], cfg["linear_value_head_dim"]
    q = q.reshape(b, s, nqk, dqk).transpose(1, 2)
    k = k.reshape(b, s, nqk, dqk).transpose(1, 2)
    v = v.reshape(b, s, nv, dv).transpose(1, 2)
    return q, k, v


def fused_gdn(params, cfg, x, attn_mask_cur, gdn_state, record=None):
    """Full-sequence FusedGDN (prefill). Returns (out, new_state | None).
    ``record`` (``ops/gdn.py::window_recorder``): the call's state inputs go
    to it and no new state is made (a speculative window's verify)."""
    d_qk, d_vg, _ = _fused_dims(cfg)
    num_repeat = cfg["linear_num_value_heads"] // cfg["linear_num_qk_heads"]
    ksz = cfg["linear_conv_kernel_size"]

    if attn_mask_cur is not None:
        x = x * attn_mask_cur[..., None].to(x.dtype)

    fused_in = params.w_qkv(x)  # (b, s, fused)
    beta = torch.sigmoid(params.w_beta(x)).transpose(1, 2)
    alpha = gdn_ops.compute_alpha_factor(params.log_A, params.w_alpha(x), params.dt_bias).transpose(1, 2)
    # pad tokens must be a state no-op
    beta, alpha = gdn_ops.freeze_masked_updates(beta, alpha, attn_mask_cur)

    if gdn_state is not None:
        fused_c, conv_ext = gdn_ops.causal_conv1d_seeded(params.conv1d["w"], fused_in, gdn_state["conv"])
        ext_mask = None
        if attn_mask_cur is not None:
            pre = torch.ones(x.shape[0], ksz - 1, dtype=torch.bool, device=x.device)
            ext_mask = torch.cat([pre, attn_mask_cur], dim=1)
    else:
        fused_c, conv_ext, ext_mask = gdn_ops.causal_conv1d(params.conv1d["w"], fused_in), fused_in, attn_mask_cur
    q, k, v = torch.split(silu(fused_c), [d_qk, d_qk, d_vg], dim=-1)
    q, k, v = _fused_gdn_heads(cfg, q, k, v)
    q = gdn_ops.l2_norm_clamp(q)
    k = gdn_ops.l2_norm_clamp(k)
    if num_repeat > 1:
        q = q.repeat_interleave(num_repeat, dim=1)
        k = k.repeat_interleave(num_repeat, dim=1)

    prev = gdn_state["recurrent"] if gdn_state is not None else None
    ctx, final_state = gdn_ops.gated_delta_rule_dispatch(cfg, q, k, v, beta, alpha, prev)

    out = _gdn_output(params, cfg, x, ctx)
    if record is not None:
        record(k, v, beta, alpha, {"conv": fused_in})
        return out, None
    new_state = None
    if gdn_state is not None:
        new_state = {"conv": gdn_ops.conv_state_from_prefill(conv_ext, ksz, mask=ext_mask), "recurrent": final_state}
    return out, new_state


def fused_gdn_step(params, cfg, x, conv_state, rec_stacked, layer, record=None):
    """Single-token FusedGDN decode step. x: (b, 1, d); ``conv_state`` is
    THIS layer's rolling taps, ``rec_stacked`` the (n_gdn, b, h, dv, dk)
    stacked recurrent cache, updated in place at ``layer``; ``record``
    (``ops/gdn.py::window_recorder``) also gets the step's state inputs.
    Returns (out, new_conv_state, rec_stacked)."""
    b = x.shape[0]
    d_qk, d_vg, _ = _fused_dims(cfg)
    nqk, dqk = cfg["linear_num_qk_heads"], cfg["linear_qk_head_dim"]
    nv, dv = cfg["linear_num_value_heads"], cfg["linear_value_head_dim"]
    x_t = x[:, 0, :]

    fused_in = params.w_qkv(x_t)
    fused_c, conv_state = gdn_ops.causal_conv1d_update(params.conv1d["w"], fused_in, conv_state)
    q, k, v = torch.split(silu(fused_c), [d_qk, d_qk, d_vg], dim=-1)
    # q and k stay at their nqk heads: the step reads v head i's at i // (nv / nqk)
    q = gdn_ops.l2_norm_clamp(q.reshape(b, nqk, dqk))
    k = gdn_ops.l2_norm_clamp(k.reshape(b, nqk, dqk))
    v = v.reshape(b, nv, dv)

    beta = torch.sigmoid(params.w_beta(x_t))
    alpha = gdn_ops.compute_alpha_factor(params.log_A, params.w_alpha(x_t[:, None, :]), params.dt_bias)[:, 0, :]

    if record is not None:
        record(k[:, :, None], v[:, :, None], beta[:, :, None], alpha[:, :, None], {"conv": fused_in[:, None]})
    ctx, rec_stacked = gdn_ops.gated_delta_rule_step_stacked_auto(cfg, q, k, v, beta, alpha, rec_stacked, layer)
    out = _gdn_output(params, cfg, x, ctx[:, :, None, :])
    return out, conv_state, rec_stacked


def _gdn_output(params, cfg, x, ctx):
    b, h, s, dv = ctx.shape
    ctx = rms_norm_torch_parity(ctx.float(), params.post_norm["scale"])
    ctx = ctx.transpose(1, 2).reshape(b, s, h * dv)
    gate = silu(params.w_gate(x).float())
    # the fp32 gate island collapses back to the model compute dtype
    return params.out_proj((gate * ctx).to(cfg["dtype"]))


class MRoPEAttention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hd = cfg["emb_dim"], cfg["head_dim"]
        d_out = cfg["n_heads"] * hd
        self.wqg = Linear(d, 2 * d_out, bias=False, dtype=dtype, device=device)  # fused q + gate
        self.wk = Linear(d, cfg["num_kv_groups"] * hd, bias=False, dtype=dtype, device=device)
        self.wv = Linear(d, cfg["num_kv_groups"] * hd, bias=False, dtype=dtype, device=device)
        self.q_norm = _rms_norm(hd, dtype, device, zero_centered=True)
        self.k_norm = _rms_norm(hd, dtype, device, zero_centered=True)
        self.out_proj = Linear(d_out, d, bias=False, dtype=dtype, device=device)


def mrope_attention(params, cfg, x, mask, cos, sin, position_ids, kv_view, attn_mask=None, q_start=None):
    """GatedAttention with MRoPE. position_ids: (3, b, s)."""
    b, s, _ = x.shape
    n_heads, hd = cfg["n_heads"], cfg["head_dim"]

    q, gate = params.wqg(x).reshape(b, s, n_heads, 2 * hd).split(hd, dim=-1)
    q = q.transpose(1, 2)
    gate = torch.sigmoid(gate.reshape(b, s, n_heads * hd))

    k = split_heads(params.wk(x), cfg["num_kv_groups"])
    v = split_heads(params.wv(x), cfg["num_kv_groups"])

    q = zero_centered_rms_norm(q, params.q_norm["scale"])
    k = zero_centered_rms_norm(k, params.k_norm["scale"])
    q = rope.apply_mrope(q, cos, sin, position_ids, cfg["mrope_section"])
    k = rope.apply_mrope(k, cos, sin, position_ids, cfg["mrope_section"])

    if kv_view is not None:
        k, v = kv_view(k, v)

    # flash covers uncached calls AND cached prefill (sq < max_len view)
    # when the query offset is static
    out = merge_heads(attention(
        q, k, v, cfg=cfg, mask=mask, causal=True, attn_mask=attn_mask,
        flash_ok=kv_view is None or q_start is not None, q_start=q_start,
    ))
    return params.out_proj(out * gate.to(out.dtype))


class TextBlock(nn.Module):
    def __init__(self, cfg, dtype, device, layer_idx):
        super().__init__()
        d, hidden = cfg["emb_dim"], cfg["hidden_dim"]
        self.norm1 = _rms_norm(d, dtype, device, zero_centered=True)
        self.att = FusedGDN(cfg, dtype, device) if is_gdn_layer(cfg, layer_idx) else MRoPEAttention(cfg, dtype, device)
        self.norm2 = _rms_norm(d, dtype, device, zero_centered=True)
        self.ffn = nn.ModuleDict({
            "gate": Linear(d, hidden, bias=False, dtype=dtype, device=device),
            "up": Linear(d, hidden, bias=False, dtype=dtype, device=device),
            "down": Linear(hidden, d, bias=False, dtype=dtype, device=device),
        })


def rope_tables(cfg, device=None):
    return rope.compute_angles(
        cfg["rope_base"], cfg["head_dim"], cfg["context_length"],
        rotation_factor=cfg["partial_rope_factor"], device=device,
    )


class TextModel(nn.Module):
    """The hybrid text model; ``forward`` is ``apply_text``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], cfg["emb_dim"], dtype=dtype, device=device))
        self.blocks = nn.ModuleList([TextBlock(cfg, dtype, device, i) for i in range(cfg["n_layers"])])
        self.final_norm = _rms_norm(cfg["emb_dim"], dtype, device, zero_centered=True)
        if not cfg["tie_embeddings"]:
            self.out = Linear(cfg["emb_dim"], cfg["vocab_size"], bias=False, dtype=dtype, device=device)
        # RoPE tables: constants of the config, built once (not parameters)
        cos, sin = rope_tables(cfg, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def reset_parameters(self, generator):
        w = self.tok_emb["w"]
        if self.cfg["tie_embeddings"]:
            bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
            w.uniform_(-bound, bound, generator=generator)
        else:
            w.normal_(generator=generator)

    def forward(self, x=None, **kwargs):
        return apply_text(self, self.cfg, x, **kwargs)


def init_cache(cfg, batch, max_len, *, dtype=None, device=None):
    """Hybrid cache: stacked KV (attention layers) + fused conv taps and fp32
    recurrent states (GDN layers), the state kept (dv, dk) as in the JAX
    package. ``cfg["kv_quant"] = "int8"`` makes the KV part the int8 cache;
    the GDN states stay in ``dtype`` and fp32."""
    dtype, device = dtype or model_dtype(cfg), resolve_device(device)
    n_gdn = len(gdn_layer_indices(cfg))
    _, _, fused = _fused_dims(cfg)
    kv = kv_cache.init_kv_cache(
        len(attn_layer_indices(cfg)), batch, cfg["num_kv_groups"], max_len, cfg["head_dim"], dtype=dtype,
        device=device, quant=cfg.get("kv_quant"),
    )
    return {
        **kv,
        "conv": torch.zeros(n_gdn, batch, cfg["linear_conv_kernel_size"] - 1, fused, dtype=dtype, device=device),
        "recurrent": torch.zeros(
            n_gdn, batch, cfg["linear_num_value_heads"], cfg["linear_value_head_dim"], cfg["linear_qk_head_dim"],
            dtype=torch.float32, device=device,
        ),
    }


def apply_text(params, cfg, x=None, *, attn_mask=None, inputs_embs=None, position_ids=None, cache=None):
    """Text forward. position_ids: (3, b, s) MRoPE ids, (b, s) 1-D ids
    (→ T=H=W) or None (sequential from the cache position). The cache, when
    given, is updated in place; its ``pos`` may be an int or a (b,) tensor
    of per-row columns (continuous-batching serving). Returns (logits, cache
    with pos advanced, {})."""
    gdn_ops.refuse_context_parallel(cfg, "qwen3_5")
    h = inputs_embs if inputs_embs is not None else embedding(params.tok_emb, x)
    b, s = h.shape[:2]
    device = h.device
    cos, sin = params.rope_cos, params.rope_sin

    pos0 = cache["pos"] if cache is not None else 0
    per_row = kv_cache.is_vector(pos0)
    if position_ids is None:
        steps = torch.arange(s, device=device)
        seq = pos0[:, None] + steps[None, :] if per_row else (pos0 + steps)[None].expand(b, s)
        position_ids = seq[None].expand(3, b, s)
    elif position_ids.ndim == 2:  # (b, s) 1-D ids (generic decode engine) → T=H=W
        position_ids = position_ids[None].expand(3, b, s)
    position_ids = position_ids.long()

    k_len = kv_cache.max_len(cache) if cache is not None else s
    mask = causal_mask(s, k_len, q_start=pos0, attn_mask=attn_mask, device=device)
    mask_cur = kv_cache.cur_token_mask(gdn_ops.state_mask(cache, attn_mask), s, pos0)  # the GDN layers' tokens
    # static query offset for cached prefill (flash over the max_len view);
    # per-row positions have none, as in JAX
    q_start = int(pos0) if cache is not None and s > 1 and not per_row else None
    decode_step = cache is not None and s == 1

    attn_i = gdn_i = 0
    for i, block in enumerate(params.blocks):
        residual = h
        hn = zero_centered_rms_norm(h, block.norm1["scale"])

        if is_gdn_layer(cfg, i):
            record = gdn_ops.window_recorder(cache, gdn_i)
            if cache is None:
                att_out, _ = fused_gdn(block.att, cfg, hn, mask_cur, None)
            elif decode_step:
                hn_m = hn if mask_cur is None else hn * mask_cur[..., None].to(hn.dtype)
                att_out, new_conv, _ = fused_gdn_step(
                    block.att, cfg, hn_m, cache["conv"][gdn_i], cache["recurrent"], gdn_i, record
                )
                cache["conv"][gdn_i] = new_conv
            else:
                st = {"conv": cache["conv"][gdn_i], "recurrent": cache["recurrent"][gdn_i]}
                att_out, st = fused_gdn(block.att, cfg, hn, mask_cur, st, record)
                if st is not None:  # a recorded window leaves the state to ``roll_window``
                    cache["conv"][gdn_i] = st["conv"]
                    cache["recurrent"][gdn_i] = st["recurrent"]
            gdn_i += 1
        else:
            kv_view = None
            if cache is not None:
                def kv_view(k_new, v_new, idx=attn_i):
                    _, kc, vc = kv_cache.write_layer(cache, idx, k_new, v_new, pos0)
                    return kc, vc

            att_out = mrope_attention(
                block.att, cfg, hn, mask, cos, sin, position_ids, kv_view, attn_mask=attn_mask, q_start=q_start
            )
            attn_i += 1

        h = residual + att_out
        h = h + swiglu(block.ffn, zero_centered_rms_norm(h, block.norm2["scale"]))

    h = zero_centered_rms_norm(h, params.final_norm["scale"])
    if cache is not None:
        cache = {**cache, "pos": pos0 + s}
    logits = tied_head(params.tok_emb, h) if cfg["tie_embeddings"] else params.out(h)
    return logits, cache, {}


class TextOnly:
    """The text model as the decode engine (inference/generate.py) drives it."""

    apply = staticmethod(apply_text)
    init_cache = staticmethod(init_cache)


# ==================================================================== VLM


class Qwen3_5(nn.Module):
    """Vision tower + text model; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.vision = VisionTower(cfg, model_dtype(cfg), device)
        self.text = TextModel(cfg, device)

    def forward(self, input_ids, **kwargs):
        return apply(self, self.cfg, input_ids, **kwargs)


def _reset(model, generator):
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def init_text(cfg, *, generator, device=None):
    """Text model with random weights drawn from ``generator`` (which lives on
    ``device``), with the JAX ``init_text`` distributions."""
    return _reset(TextModel(cfg, device), generator)


def init(cfg, *, generator, device=None):
    """Full VLM with random weights (the JAX ``init`` distributions)."""
    return _reset(Qwen3_5(cfg, device), generator)


def get_feeds_3d_shape(cfg, image_pixels_shape):
    """(t_patches, h_patches, w_patches) of the single feed."""
    nh, nw = n_patches_hw(cfg)
    n_frames = image_pixels_shape[2] // cfg["temporal_patch_size"]
    return np.asarray([[n_frames, nh, nw]])


def compute_3d_position_ids(cfg, input_ids, feeds_3d_shape=None):
    """Host-side (numpy) MRoPE position builder. input_ids: (b, s) array.
    Returns (3, b, s) int32."""
    input_ids = np.asarray(input_ids)
    b, s = input_ids.shape
    if feeds_3d_shape is None:
        return np.broadcast_to(np.arange(s, dtype=np.int32)[None, None], (3, b, s)).copy()

    merge = cfg["spatial_merge_size"]
    image_mask = input_ids == cfg["image_token_id"]
    pos_increments = (~image_mask).astype(np.int64)
    local = np.zeros((3, b, s), np.int64)

    for b_idx in range(b):
        img_indices = np.where(image_mask[b_idx])[0]
        if len(img_indices) == 0:
            continue
        pos = 0
        for t, h, w in np.asarray(feeds_3d_shape):
            mh, mw = h // merge, w // merge
            num_tokens = int(t * mh * mw)
            if pos + num_tokens > len(img_indices):
                break
            cur = img_indices[pos : pos + num_tokens]
            pos_increments[b_idx, cur[-1]] = max(int(t), mh, mw)
            li = np.arange(num_tokens)
            local[0, b_idx, cur] = li // (mh * mw)
            local[1, b_idx, cur] = (li % (mh * mw)) // mw
            local[2, b_idx, cur] = li % mw
            pos += num_tokens

    global_pos = np.cumsum(pos_increments, axis=1) - pos_increments
    return (global_pos[None] + local).astype(np.int32)


def _prompt_position_ids(cfg, input_ids, image_pixels):
    feeds = get_feeds_3d_shape(cfg, image_pixels.shape) if image_pixels is not None else None
    pos = compute_3d_position_ids(cfg, input_ids.cpu().numpy(), feeds)
    return torch.from_numpy(pos).to(input_ids.device, torch.long)


def fuse_embeddings(params, cfg, input_ids, image_pixels):
    """Embed ids and scatter the vision embeddings into the image-placeholder
    slots. Returns (b, s, d)."""
    inputs_embs = embedding(params.text.tok_emb, input_ids)
    if image_pixels is None:
        return inputs_embs
    vision = apply_vision(params.vision, cfg, image_pixels)  # (b, Nv, d)
    image_mask = input_ids == cfg["image_token_id"]
    # masked_scatter as a gather: position j takes vision[cumsum(mask)-1]
    idx = (torch.cumsum(image_mask, dim=1) - 1).clamp(0, vision.shape[1] - 1)
    scattered = torch.gather(vision.to(inputs_embs.dtype), 1, idx[..., None].expand(-1, -1, vision.shape[-1]))
    return torch.where(image_mask[..., None], scattered, inputs_embs)


def apply(params, cfg, input_ids, *, image_pixels=None, attn_mask=None, cache=None, position_ids=None):
    """Full VLM forward; position_ids default to the host-computed MRoPE ids."""
    inputs_embs = fuse_embeddings(params, cfg, input_ids, image_pixels)
    if position_ids is None:
        position_ids = _prompt_position_ids(cfg, input_ids, image_pixels)
    return apply_text(
        params.text, cfg, attn_mask=attn_mask, inputs_embs=inputs_embs, position_ids=position_ids, cache=cache
    )


@torch.inference_mode()
def generate_multimodal(
    params, cfg, input_ids, image_pixels, *, max_gen, temp=0.0, top_k=None, top_p=None, min_p=None,
    eos_ids=None, pad_id=0, generator=None,
):
    """Encode the image ONCE, prefill the hybrid cache, then greedy/sampled
    1-token decode steps. input_ids: (b, s) prompt with the image
    placeholders already expanded. Returns {"sequences": (b, s + max_gen)}.

    Decode positions continue from max(prompt position) + 1 per row (the
    MRoPE jump after an image), not from the prompt length. A finished row
    emits ``pad_id`` and its mask bit stays False.
    """
    b, prompt_len = input_ids.shape
    device = input_ids.device
    eos_list = list(eos_ids) if isinstance(eos_ids, (list, tuple)) else [eos_ids if eos_ids is not None else -1]
    eos_arr = torch.tensor(eos_list, device=device)
    prompt_pos = _prompt_position_ids(cfg, input_ids, image_pixels)  # (3, b, s)
    next_pos0 = prompt_pos.amax(dim=(0, 2)) + 1  # (b,)

    cache = init_cache(cfg, b, prompt_len + max_gen, device=device)
    mask_buf = torch.zeros(b, prompt_len + max_gen, dtype=torch.bool, device=device)
    mask_buf[:, :prompt_len] = True

    inputs_embs = fuse_embeddings(params, cfg, input_ids, image_pixels)
    logits, cache, _ = apply_text(
        params.text, cfg, attn_mask=mask_buf, inputs_embs=inputs_embs, position_ids=prompt_pos, cache=cache
    )
    logits = logits[:, -1]

    finished = torch.zeros(b, dtype=torch.bool, device=device)
    tokens = []
    for i in range(max_gen):
        sampled = sampling(generator, logits, top_k=top_k, top_p=top_p, min_p=min_p, temp=temp)
        tok = torch.where(finished, pad_id, sampled)
        finished = finished | (tok[:, None] == eos_arr[None]).any(dim=-1)
        mask_buf[:, prompt_len + i] = ~finished
        tokens.append(tok)
        if i + 1 < max_gen:  # the logits after the last token are never sampled
            pos = (next_pos0 + i)[None, :, None].expand(3, b, 1)
            logits, cache, _ = apply_text(
                params.text, cfg, tok[:, None], attn_mask=mask_buf, position_ids=pos, cache=cache
            )
            logits = logits[:, 0]
    return {"sequences": torch.cat([input_ids, torch.stack(tokens, dim=1).to(input_ids.dtype)], dim=1)}
