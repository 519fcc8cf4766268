"""Qwen3-Next: GatedDeltaNet / GatedAttention hybrid with Qwen3-MoE blocks
(counterpart of ``llm_quest_tpu/models/qwen3_next.py``: the training,
uncached and cached (serving) paths).

- hybrid layout: block i is GatedDeltaNet unless (i+1) % linear_sdpa_ratio
  == 0, then GatedAttention;
- GatedAttention: fused q+gate projection (per-head [q‖gate] chunks),
  zero-centred QK RMSNorm before partial RoPE, sigmoid output gate;
- GatedDeltaNet: depthwise causal convs + SiLU on the q/k/v projections,
  clamped L2 norm on q/k, q/k heads repeated to the v heads, β =
  sigmoid(w_β x), α = exp(−exp(log_A)·softplus(w_α x + dt_bias)), the fp32
  delta rule, per-v-head fp32 RMSNorm and an fp32 SiLU gate;
- every block ends in Qwen3-MoE with a weighted shared expert; zero-centred
  RMSNorm throughout; untied output head.

The ``nn.Module`` classes hold the parameters under the JAX tree's names
(``blocks.3.moe.experts.lin1`` is ``blocks/3/moe/experts/lin1`` there) and
are trainable.

Decode runs on the hybrid static cache of ``init_cache`` (stacked KV for the
GatedAttention layers, bf16 or int8 with ``cfg["kv_quant"]``; the rolling
conv_q/conv_k/conv_v taps and fp32 (dv, dk) recurrent states for the GDN
layers), updated in place: a cached prefill seeds the convs from the stored
taps and starts the recurrence from the stored state, and a one-token step
takes ``gated_delta_net_step``. As in JAX a cached prefill's attention stays
on ``sdpa`` (``flash_ok`` only without a cache).

Kernels on this path: the GDN prefill (K1, forward and backward), the GDN
decode step (K2, dk 64), flash attention (K4, forward and backward, uncached
from ``flash_min_seq`` tokens up) and, for a model quantized by
``ops/quantization.py::quantize_params_int8``, the int8 expert stacks' grouped
matmul (K11).
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import cache as kv_cache
from llm_quest_tpu_torch.ops import gdn as gdn_ops
from llm_quest_tpu_torch.ops import moe as moe_ops
from llm_quest_tpu_torch.ops import rope
from llm_quest_tpu_torch.ops.activations import silu
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, split_heads
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.norms import rms_norm_torch_parity, zero_centered_rms_norm
from llm_quest_tpu_torch.ops.remat import checkpoint_block

def is_gdn_layer(cfg, layer_idx):
    return (layer_idx + 1) % cfg["linear_sdpa_ratio"] != 0


def gdn_layer_indices(cfg):
    return [i for i in range(cfg["n_layers"]) if is_gdn_layer(cfg, i)]


def ga_layer_indices(cfg):
    return [i for i in range(cfg["n_layers"]) if not is_gdn_layer(cfg, i)]


def _linear(d_in, d_out, dtype, device):
    return Linear(d_in, d_out, bias=False, dtype=dtype, device=device, trainable=True)


def _zero_centered_norm(dim, dtype, device):
    return params(scale=torch.zeros(dim, dtype=dtype, device=device), trainable=True)


# ---------------------------------------------------------------- GatedAttention


class GatedAttention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hd = cfg["emb_dim"], cfg["head_dim"]
        d_out = cfg["n_heads"] * hd
        self.wqg = _linear(d, 2 * d_out, dtype, device)  # fused q + gate
        self.wk = _linear(d, cfg["num_kv_groups"] * hd, dtype, device)
        self.wv = _linear(d, cfg["num_kv_groups"] * hd, dtype, device)
        self.q_norm = _zero_centered_norm(hd, dtype, device)
        self.k_norm = _zero_centered_norm(hd, dtype, device)
        self.out_proj = _linear(d_out, d, dtype, device)


def gated_attention(params, cfg, x, mask, cos, sin, position_ids, kv_view, attn_mask=None):
    """kv_view: None (no cache) or a function writing the new k/v into the
    cache and returning the full max_len views."""
    b, s, _ = x.shape
    n_heads, hd = cfg["n_heads"], cfg["head_dim"]

    q, gate = params.wqg(x).reshape(b, s, n_heads, 2 * hd).split(hd, dim=-1)  # per-head chunks
    q = q.transpose(1, 2)
    gate = torch.sigmoid(gate.reshape(b, s, n_heads * hd))

    k = split_heads(params.wk(x), cfg["num_kv_groups"])
    v = split_heads(params.wv(x), cfg["num_kv_groups"])

    q = rope.apply(zero_centered_rms_norm(q, params.q_norm["scale"]), cos, sin, position_ids)
    k = rope.apply(zero_centered_rms_norm(k, params.k_norm["scale"]), cos, sin, position_ids)

    if kv_view is not None:
        k, v = kv_view(k, v)

    out = merge_heads(attention(
        q, k, v, cfg=cfg, mask=mask, causal=True, attn_mask=attn_mask, flash_ok=kv_view is None,
    ))
    return params.out_proj(out * gate.to(out.dtype))


# ---------------------------------------------------------------- GatedDeltaNet


class GatedDeltaNet(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        d_qk = cfg["linear_num_qk_heads"] * cfg["linear_qk_head_dim"]
        d_vg = cfg["linear_num_value_heads"] * cfg["linear_value_head_dim"]
        nv, ksz = cfg["linear_num_value_heads"], cfg["linear_conv_kernel_size"]
        self.wq = _linear(d, d_qk, dtype, device)
        self.wk = _linear(d, d_qk, dtype, device)
        self.wv = _linear(d, d_vg, dtype, device)
        self.wb = _linear(d, nv, dtype, device)
        self.wa = _linear(d, nv, dtype, device)
        self.log_A = nn.Parameter(torch.empty(nv, dtype=torch.float32, device=device))  # fp32 island
        self.dt_bias = nn.Parameter(torch.ones(nv, dtype=dtype, device=device))
        self.conv_q = params(w=torch.empty(d_qk, ksz, dtype=dtype, device=device), trainable=True)
        self.conv_k = params(w=torch.empty(d_qk, ksz, dtype=dtype, device=device), trainable=True)
        self.conv_v = params(w=torch.empty(d_vg, ksz, dtype=dtype, device=device), trainable=True)
        self.post_norm = params(scale=torch.ones(cfg["linear_value_head_dim"], dtype=torch.float32, device=device),
                                trainable=True)
        self.w_gate = _linear(d, d_vg, dtype, device)
        self.out_proj = _linear(d_vg, d, dtype, device)

    def reset_parameters(self, generator):
        """A ~ U(0, 16) stored as log; depthwise convs U(±1/sqrt(kernel_size))."""
        self.log_A.copy_(torch.log(torch.empty_like(self.log_A).uniform_(0.0, 16.0, generator=generator)))
        for conv in (self.conv_q, self.conv_k, self.conv_v):
            bound = 1.0 / conv["w"].shape[1] ** 0.5
            conv["w"].uniform_(-bound, bound, generator=generator)


def _gdn_heads(cfg, q, k, v):
    """(b, s, c) projections → (b, h, s, hd), channels grouped per head."""
    b, s = q.shape[:2]
    nqk, dqk = cfg["linear_num_qk_heads"], cfg["linear_qk_head_dim"]
    nv, dv = cfg["linear_num_value_heads"], cfg["linear_value_head_dim"]
    return (
        q.reshape(b, s, nqk, dqk).transpose(1, 2),
        k.reshape(b, s, nqk, dqk).transpose(1, 2),
        v.reshape(b, s, nv, dv).transpose(1, 2),
    )


_CONVS = ("conv_q", "conv_k", "conv_v")


def gated_delta_net(params, cfg, x, attn_mask_cur, gdn_state):
    """GDN over a full sequence (training / prefill).

    attn_mask_cur: (b, s) bool for the current tokens, True = real, or None.
    gdn_state: None (from a zero state), or {"conv_q", "conv_k", "conv_v",
    "recurrent"}: the convs continue from the stored taps, the recurrence
    from the stored state, and the new state is returned.
    Returns (out, new_gdn_state | None)."""
    num_repeat = cfg["linear_num_value_heads"] // cfg["linear_num_qk_heads"]
    ksz = cfg["linear_conv_kernel_size"]
    if attn_mask_cur is not None:
        x = x * attn_mask_cur[..., None].to(x.dtype)

    ins = {"conv_q": params.wq(x), "conv_k": params.wk(x), "conv_v": params.wv(x)}
    if gdn_state is not None:
        conv = {n: gdn_ops.causal_conv1d_seeded(getattr(params, n)["w"], ins[n], gdn_state[n]) for n in _CONVS}
        ext_mask = None
        if attn_mask_cur is not None:
            pre = torch.ones(x.shape[0], ksz - 1, dtype=torch.bool, device=x.device)
            ext_mask = torch.cat([pre, attn_mask_cur], dim=1)
    else:
        conv = {n: (gdn_ops.causal_conv1d(getattr(params, n)["w"], ins[n]), ins[n]) for n in _CONVS}
        ext_mask = attn_mask_cur
    q, k, v = (silu(conv[n][0]) for n in _CONVS)
    q, k, v = _gdn_heads(cfg, q, k, v)
    q = gdn_ops.l2_norm_clamp(q)
    k = gdn_ops.l2_norm_clamp(k)
    if num_repeat > 1:
        q = q.repeat_interleave(num_repeat, dim=1)
        k = k.repeat_interleave(num_repeat, dim=1)

    beta = torch.sigmoid(params.wb(x)).transpose(1, 2)  # (b, hv, s)
    alpha = gdn_ops.compute_alpha_factor(params.log_A, params.wa(x), params.dt_bias).transpose(1, 2)
    # pad tokens must be a state no-op
    beta, alpha = gdn_ops.freeze_masked_updates(beta, alpha, attn_mask_cur)

    prev = gdn_state["recurrent"] if gdn_state is not None else None
    ctx, final_state = gdn_ops.gated_delta_rule_dispatch(cfg, q, k, v, beta, alpha, prev)
    out = _gdn_output(params, cfg, x, ctx)
    if gdn_state is None:
        return out, None
    new_state = {n: gdn_ops.conv_state_from_prefill(conv[n][1], ksz, mask=ext_mask) for n in _CONVS}
    return out, {**new_state, "recurrent": final_state}


def gated_delta_net_step(params, cfg, x, conv_states, rec_stacked, layer):
    """Single-token GDN decode step. x: (b, 1, d); ``conv_states``: this
    layer's {"conv_q", "conv_k", "conv_v"} taps; ``rec_stacked``: the
    (n_gdn, b, h, dv, dk) stacked recurrent cache, updated in place at
    ``layer`` (K2). Returns (out (b, 1, d), new conv dict, rec_stacked)."""
    b = x.shape[0]
    nqk, dqk = cfg["linear_num_qk_heads"], cfg["linear_qk_head_dim"]
    nv, dv = cfg["linear_num_value_heads"], cfg["linear_value_head_dim"]
    x_t = x[:, 0, :]

    ins = {"conv_q": params.wq(x_t), "conv_k": params.wk(x_t), "conv_v": params.wv(x_t)}
    new_convs, outs = {}, {}
    for n in _CONVS:
        outs[n], new_convs[n] = gdn_ops.causal_conv1d_update(getattr(params, n)["w"], ins[n], conv_states[n])
    # channel-major head split (c = h·hd with the channels grouped per head); q
    # and k stay at their nqk heads: the step reads v head i's at i // (nv / nqk)
    q = gdn_ops.l2_norm_clamp(silu(outs["conv_q"]).reshape(b, nqk, dqk))
    k = gdn_ops.l2_norm_clamp(silu(outs["conv_k"]).reshape(b, nqk, dqk))
    v = silu(outs["conv_v"]).reshape(b, nv, dv)

    beta = torch.sigmoid(params.wb(x_t))
    alpha = gdn_ops.compute_alpha_factor(params.log_A, params.wa(x_t[:, None, :]), params.dt_bias)[:, 0, :]
    ctx, rec_stacked = gdn_ops.gated_delta_rule_step_stacked_auto(cfg, q, k, v, beta, alpha, rec_stacked, layer)
    return _gdn_output(params, cfg, x, ctx[:, :, None, :]), new_convs, rec_stacked


def _gdn_output(params, cfg, x, ctx):
    """Post-norm (fp32, per v-head), fp32 SiLU gate product, out projection.
    ctx: (b, h, s, dv)."""
    b, h, s, dv = ctx.shape
    ctx = rms_norm_torch_parity(ctx.float(), params.post_norm["scale"])
    ctx = ctx.transpose(1, 2).reshape(b, s, h * dv)
    gate = silu(params.w_gate(x).float())
    # the fp32 gate island collapses back to the model compute dtype
    return params.out_proj((gate * ctx).to(cfg["dtype"]))


# ----------------------------------------------------------------------- model


class Block(nn.Module):
    def __init__(self, cfg, dtype, device, layer_idx):
        super().__init__()
        d = cfg["emb_dim"]
        self.norm1 = _zero_centered_norm(d, dtype, device)
        self.att = GatedDeltaNet(cfg, dtype, device) if is_gdn_layer(cfg, layer_idx) else GatedAttention(
            cfg, dtype, device
        )
        self.norm2 = _zero_centered_norm(d, dtype, device)
        self.moe = moe_ops.Qwen3MoE(cfg, dtype, device)


class Qwen3Next(nn.Module):
    """The hybrid MoE model; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], cfg["emb_dim"], dtype=dtype, device=device),
                              trainable=True)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device, i) for i in range(cfg["n_layers"])])
        self.final_norm = _zero_centered_norm(cfg["emb_dim"], dtype, device)
        self.out = _linear(cfg["emb_dim"], cfg["vocab_size"], dtype, device)
        # RoPE tables: constants of the config, built once (not parameters)
        cos, sin = rope_tables(cfg, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def reset_parameters(self, generator):
        self.tok_emb["w"].normal_(generator=generator)

    def forward(self, x, **kwargs):
        return apply(self, self.cfg, x, **kwargs)


@torch.no_grad()
def init(cfg, *, generator, device=None):
    """Model with random weights drawn from ``generator`` (which lives on
    ``device``), with the JAX ``init`` distributions."""
    model = Qwen3Next(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def rope_tables(cfg, device=None):
    return rope.compute_angles(
        cfg["rope_base"], cfg["head_dim"], cfg["context_length"],
        rotation_factor=cfg["partial_rope_factor"], device=device,
    )


def init_cache(cfg, batch, max_len, *, dtype=None, device=None):
    """Hybrid cache: stacked KV over the GatedAttention layers (the int8
    cache with ``cfg["kv_quant"] = "int8"``), the GDN layers' conv_q /
    conv_k / conv_v taps (oldest first) and fp32 (dv, dk) recurrent states,
    and ``pos``; the JAX package's layout."""
    dtype, device = dtype or model_dtype(cfg), resolve_device(device)
    n_gdn = len(gdn_layer_indices(cfg))
    d_qk = cfg["linear_num_qk_heads"] * cfg["linear_qk_head_dim"]
    d_vg = cfg["linear_num_value_heads"] * cfg["linear_value_head_dim"]
    taps = cfg["linear_conv_kernel_size"] - 1
    kv = kv_cache.init_kv_cache(
        len(ga_layer_indices(cfg)), batch, cfg["num_kv_groups"], max_len, cfg["head_dim"], dtype=dtype,
        device=device, quant=cfg.get("kv_quant"),
    )
    return {
        **kv,
        "conv_q": torch.zeros(n_gdn, batch, taps, d_qk, dtype=dtype, device=device),
        "conv_k": torch.zeros(n_gdn, batch, taps, d_qk, dtype=dtype, device=device),
        "conv_v": torch.zeros(n_gdn, batch, taps, d_vg, dtype=dtype, device=device),
        "recurrent": torch.zeros(
            n_gdn, batch, cfg["linear_num_value_heads"], cfg["linear_value_head_dim"], cfg["linear_qk_head_dim"],
            dtype=torch.float32, device=device,
        ),
    }


def _gdn_block(block, cfg, hn, mask_cur, cache, gdn_i, decode_step):
    """A GDN layer's attention output; with a cache, its state is read and
    written in place at ``gdn_i``."""
    if cache is None:
        return gated_delta_net(block.att, cfg, hn, mask_cur, None)[0]
    if decode_step:
        hn_m = hn if mask_cur is None else hn * mask_cur[..., None].to(hn.dtype)
        out, convs, _ = gated_delta_net_step(
            block.att, cfg, hn_m, {n: cache[n][gdn_i] for n in _CONVS}, cache["recurrent"], gdn_i
        )
        for n in _CONVS:
            cache[n][gdn_i] = convs[n]
        return out
    state = {n: cache[n][gdn_i] for n in (*_CONVS, "recurrent")}
    out, state = gated_delta_net(block.att, cfg, hn, mask_cur, state)
    for n, t in state.items():
        cache[n][gdn_i] = t
    return out


def apply(params, cfg, x, *, attn_mask=None, cache=None, position_ids=None, training=False,
          output_hidden_states=False, **_):
    """Forward. x: (b, s) ids; attn_mask: optional bool, True = real token,
    (b, s) without a cache and (b, max_len) with one. The cache, when given,
    is written in place (prefill, or a one-token decode step); its ``pos``
    may be an int or a (b,) tensor of per-row columns (continuous-batching
    serving: the GDN layers gate each row's current tokens by the mask at
    its own columns). Returns
    (logits, cache with pos advanced | None, aux), or the final-norm hidden
    states in place of the logits with ``output_hidden_states``. aux has
    "gate_probas" (one (b·s, E) fp32 tensor per block) and, when training,
    "moe_loss" (the blocks' summed LBL terms)."""
    gdn_ops.refuse_context_parallel(cfg, "qwen3_next")
    b, s = x.shape
    device = x.device
    cos, sin = params.rope_cos, params.rope_sin
    pos0 = cache["pos"] if cache is not None else 0
    if position_ids is None and cache is not None:
        position_ids = kv_cache.positions(pos0, b, s, device)
    k_len = kv_cache.max_len(cache) if cache is not None else s
    mask = causal_mask(s, k_len, q_start=pos0, attn_mask=attn_mask, device=device)
    mask_cur = kv_cache.cur_token_mask(attn_mask, s, pos0)
    decode_step = cache is not None and s == 1
    plain = not cfg.get("use_kernels", True)

    h = embedding(params.tok_emb, x)
    aux = {"gate_probas": []}
    moe_loss = 0.0
    use_ckpt = cfg.get("gradient_checkpointing", False) and training and cache is None
    capacity_factor = cfg.get("moe_capacity_factor") if training else None
    ga_i = gdn_i = 0

    for i, block in enumerate(params.blocks):
        kv_view = None
        if cache is not None and not is_gdn_layer(cfg, i):
            def kv_view(k_new, v_new, idx=ga_i):
                _, kc, vc = kv_cache.write_layer(cache, idx, k_new, v_new, pos0)
                return kc, vc

        def block_fn(h, block=block, i=i, kv_view=kv_view, gdn_i=gdn_i):
            hn = zero_centered_rms_norm(h, block.norm1["scale"])
            if is_gdn_layer(cfg, i):
                att_out = _gdn_block(block, cfg, hn, mask_cur, cache, gdn_i, decode_step)
            else:
                att_out = gated_attention(block.att, cfg, hn, mask, cos, sin, position_ids, kv_view,
                                          attn_mask=attn_mask)
            h = h + att_out
            ffn_out, moe_aux = moe_ops.qwen3_moe(
                block.moe, zero_centered_rms_norm(h, block.norm2["scale"]), top_k=cfg["top_k"],
                load_coeff=cfg["aux_loss_coef"], training=training, capacity_factor=capacity_factor, plain=plain,
            )
            return h + ffn_out, moe_aux

        # rematerialising the whole block: the MoE and GDN activations dominate training memory
        h, moe_aux = checkpoint_block(cfg, block_fn)(h) if use_ckpt else block_fn(h)
        if is_gdn_layer(cfg, i):
            gdn_i += 1
        else:
            ga_i += 1
        aux["gate_probas"].append(moe_aux["gate_probas"])
        if "moe_loss" in moe_aux:
            moe_loss = moe_loss + moe_aux["moe_loss"]

    if training:
        aux["moe_loss"] = moe_loss

    h = zero_centered_rms_norm(h, params.final_norm["scale"])
    if cache is not None:
        cache = kv_cache.advance(cache, s)
    if output_hidden_states:
        return h, cache, aux
    return params.out(h), cache, aux


def head_weights(params, cfg):
    """(d, vocab) output-head matrix, a view of the untied head — for the
    fused-CE training path (an fp model)."""
    return params.out.w.T
