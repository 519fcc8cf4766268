"""Xiaomi MiMo-V2-Flash: SWA + sink hybrid with DeepSeek MoE and
shrinking-slice MTP (counterpart of ``llm_quest_tpu/models/mimo_v2_flash.py``,
the uncached forward and the training loss).

- attention: GQA with a decoupled value head dim (``value_head_dim``), QK
  RMSNorm in fp32 (``rms_norm_torch_parity``) BEFORE partial RoPE, and a
  learnable per-head sink logit on the SWA layers only;
- layout: layer 0 is GA with a dense SwiGLU FFN; layers 1+ carry the
  DeepSeek MoE (``ops/moe.py::deepseek_moe``) and are SWA unless (i + 1) %
  ``hybrid_ratio`` == 0 (GA); SWA and GA layers have their own kv-group
  counts and RoPE bases (``rope_base`` / ``rope_base_ga``);
- MTP: module k (1-based) runs on the embeddings of tokens k..s−2 and the
  previous hidden states, cut to the same length (the main model's first
  s − 2, then each module's first s − k − 1), through one SWA block with a
  sink and a dense FFN and the shared head; loss = main CE + (coeff /
  depth)·Σ_k CE_k, the targets of module k being the input ids from k + 1.

The ``nn.Module`` classes hold the parameters under the JAX tree's names
(``blocks.3.att.sink`` is ``blocks/3/att/sink`` there, ``mtp.0.trf_block``
is ``mtp/0/trf_block``), and the MoE balancing biases as the fp32 buffer
``blocks.<i>.moe.biases`` (``ops/moe.py``: it has no gradient and stays out
of the optimizer); the functions with the JAX package's names compute on
them.

Kernels on this path: flash attention (K4, forward and backward) through
the attention router for every call of ``flash_min_seq`` queries or more:
the main model's layers and both MTP blocks, at d 64 / dv 32, with the
window and the sinks on the SWA layers and the MTP blocks. The cached path
(``cache=``) is not ported: it waits for the per-layer-type ``write_kv`` of
the cache (ROADMAP Queue 1 item 2).
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.ops import moe as moe_ops
from llm_quest_tpu_torch.ops import rope
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, split_heads
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params
from llm_quest_tpu_torch.ops.losses import cross_entropy
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.mlp import swiglu
from llm_quest_tpu_torch.ops.norms import rms_norm_torch_parity


def is_swa_layer(cfg, layer_idx):
    """Layer 0 is GA; any other is SWA unless every ``hybrid_ratio``-th."""
    if layer_idx == 0:
        return False
    return (layer_idx + 1) % cfg["hybrid_ratio"] != 0


def is_moe_layer(cfg, layer_idx):
    return layer_idx != 0


def _linear(d_in, d_out, dtype, device):
    return Linear(d_in, d_out, bias=False, dtype=dtype, device=device, trainable=True)


def _rms_norm(dim, dtype, device):
    return params(scale=torch.ones(dim, dtype=dtype, device=device), trainable=True)


class Attention(nn.Module):
    """{"wq", "wk", "wv", "out_proj", "q_norm", "k_norm"[, "sink" (hq,)]}."""

    def __init__(self, cfg, dtype, device, *, swa):
        super().__init__()
        d, hd, nq = cfg["emb_dim"], cfg["head_dim"], cfg["n_heads"]
        vhd = cfg.get("value_head_dim") or hd
        groups = cfg["num_swa_kv_groups"] if swa else cfg["num_ga_kv_groups"]
        self.wq = _linear(d, nq * hd, dtype, device)
        self.wk = _linear(d, groups * hd, dtype, device)
        self.wv = _linear(d, groups * vhd, dtype, device)
        self.out_proj = _linear(nq * vhd, d, dtype, device)
        self.q_norm = _rms_norm(hd, dtype, device)
        self.k_norm = _rms_norm(hd, dtype, device)
        if swa:
            self.sink = nn.Parameter(torch.empty(nq, dtype=dtype, device=device))

    def reset_parameters(self, generator):
        """The sinks 0.02·N(0, 1)."""
        if hasattr(self, "sink"):
            self.sink.normal_(generator=generator).mul_(0.02)


class Block(nn.Module):
    """{"norm1", "att", "norm2", "moe" | "ffn"}; ``swa`` and ``moe`` default
    to the kinds of layer ``layer_idx``."""

    def __init__(self, cfg, dtype, device, layer_idx, *, swa=None, moe=None):
        super().__init__()
        d = cfg["emb_dim"]
        swa = is_swa_layer(cfg, layer_idx) if swa is None else swa
        moe = is_moe_layer(cfg, layer_idx) if moe is None else moe
        self.norm1 = _rms_norm(d, dtype, device)
        self.att = Attention(cfg, dtype, device, swa=swa)
        self.norm2 = _rms_norm(d, dtype, device)
        if moe:
            self.moe = moe_ops.DeepSeekMoE(cfg, dtype, device)
        else:
            self.ffn = nn.ModuleDict({
                "gate": _linear(d, cfg["hidden_dim"], dtype, device),
                "up": _linear(d, cfg["hidden_dim"], dtype, device),
                "down": _linear(cfg["hidden_dim"], d, dtype, device),
            })


class MTPModule(nn.Module):
    """{"rms_input", "rms_h_prev", "final_norm", "down_proj" (2d → d),
    "trf_block" (SWA with a sink, dense FFN)}."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        self.rms_input = _rms_norm(d, dtype, device)
        self.rms_h_prev = _rms_norm(d, dtype, device)
        self.final_norm = _rms_norm(d, dtype, device)
        self.down_proj = _linear(2 * d, d, dtype, device)
        self.trf_block = Block(cfg, dtype, device, 0, swa=True, moe=False)


class MiMoV2Flash(nn.Module):
    """MiMo-V2-Flash; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], cfg["emb_dim"], dtype=dtype, device=device),
                              trainable=True)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device, i) for i in range(cfg["n_layers"])])
        self.final_norm = _rms_norm(cfg["emb_dim"], dtype, device)
        self.out = _linear(cfg["emb_dim"], cfg["vocab_size"], dtype, device)
        self.mtp = nn.ModuleList([MTPModule(cfg, dtype, device) for _ in range(cfg.get("mtp_depth", 0))])
        # the dual RoPE tables: constants of the config, built once (not parameters)
        (cos_swa, sin_swa), (cos_ga, sin_ga) = rope_tables(cfg, device=device)
        for name, t in (("cos_swa", cos_swa), ("sin_swa", sin_swa), ("cos_ga", cos_ga), ("sin_ga", sin_ga)):
            self.register_buffer(f"rope_{name}", t, persistent=False)

    def reset_parameters(self, generator):
        self.tok_emb["w"].normal_(generator=generator)

    def forward(self, x, **kwargs):
        return apply(self, self.cfg, x, **kwargs)


@torch.no_grad()
def init(cfg, *, generator, device=None):
    """Model with random weights drawn from ``generator`` (which lives on
    ``device``), with the JAX ``init`` distributions."""
    model = MiMoV2Flash(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def rope_tables(cfg, device=None):
    """Dual partial tables: ((cos_swa, sin_swa), (cos_ga, sin_ga)), each
    (context_length, rotation dim) fp32."""
    return tuple(
        rope.compute_angles(base, cfg["head_dim"], cfg["context_length"],
                            rotation_factor=cfg["partial_rope_factor"], device=device)
        for base in (cfg.get("rope_base", 10_000), cfg.get("rope_base_ga", 640_000))
    )


def _attention(att, cfg, x, mask, cos, sin, position_ids, *, swa, attn_mask=None):
    groups = cfg["num_swa_kv_groups"] if swa else cfg["num_ga_kv_groups"]
    q = split_heads(att.wq(x), cfg["n_heads"])
    k = split_heads(att.wk(x), groups)
    v = split_heads(att.wv(x), groups)

    q = rope.apply(rms_norm_torch_parity(q, att.q_norm["scale"]), cos, sin, position_ids)
    k = rope.apply(rms_norm_torch_parity(k, att.k_norm["scale"]), cos, sin, position_ids)

    out = merge_heads(attention(
        q, k, v, cfg=cfg, mask=mask, sink=getattr(att, "sink", None), causal=True,
        window_size=cfg["window_size"] if swa else None, attn_mask=attn_mask,
    ))
    return att.out_proj(out)


def _block(block, cfg, h, mask, cos, sin, position_ids, *, swa, attn_mask=None):
    """One block; returns (h, aux) with aux["counts"] on an MoE block."""
    hn = rms_norm_torch_parity(h, block.norm1["scale"])
    h = h + _attention(block.att, cfg, hn, mask, cos, sin, position_ids, swa=swa, attn_mask=attn_mask)
    hn = rms_norm_torch_parity(h, block.norm2["scale"])
    if hasattr(block, "moe"):
        ffn_out, aux = moe_ops.deepseek_moe(block.moe, hn, top_k=cfg["top_k"])
    else:
        ffn_out, aux = swiglu(block.ffn, hn), {}
    return h + ffn_out, aux


def apply(params, cfg, x, *, attn_mask=None, cache=None, position_ids=None, **_):
    """Main-model forward, uncached. x: (b, s) ids; attn_mask: optional (b,
    s) bool, True = real token. Returns (logits, None, aux) with
    aux["hidden"] (the last block's output, before the final norm) and
    aux["moe_counts"] (one (E,) fp32 count per MoE block)."""
    if cache is not None:
        raise NotImplementedError(
            "mimo_v2_flash.apply: the cached path waits for the per-layer-type write_kv of the cache "
            "(ROADMAP Queue 1 item 2)"
        )
    if cfg.get("expert_parallel") is not None:
        raise NotImplementedError("mimo_v2_flash.apply: expert-parallel dispatch waits for the parallel port")
    s = x.shape[1]
    mask_ga = causal_mask(s, s, attn_mask=attn_mask, device=x.device)
    mask_swa = causal_mask(s, s, window_size=cfg["window_size"], attn_mask=attn_mask, device=x.device)

    h = embedding(params.tok_emb, x)
    counts = []
    for i, block in enumerate(params.blocks):
        swa = is_swa_layer(cfg, i)
        if swa:
            mask, cos, sin = mask_swa, params.rope_cos_swa, params.rope_sin_swa
        else:
            mask, cos, sin = mask_ga, params.rope_cos_ga, params.rope_sin_ga
        h, aux = _block(block, cfg, h, mask, cos, sin, position_ids, swa=swa, attn_mask=attn_mask)
        if "counts" in aux:
            counts.append(aux["counts"])

    logits = params.out(rms_norm_torch_parity(h, params.final_norm["scale"]))
    return logits, None, {"hidden": h, "moe_counts": counts}


def loss(params, cfg, x, targets, *, training=True):
    """Main CE + (coeff / depth)·Σ MTP CE over shrinking slices (module
    docstring). targets: (b, s), already shifted by one. Returns (loss, aux)
    with ``apply``'s aux; without ``training`` (or with no MTP) the main CE
    alone."""
    logits, _, aux = apply(params, cfg, x)
    main_loss = cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))

    depth = cfg.get("mtp_depth", 0)
    if not training or depth == 0:
        return main_loss, aux

    x_embeds = embedding(params.tok_emb, x)
    h_prev = aux["hidden"]
    mtp_total = 0.0
    for i, mtp in enumerate(params.mtp):
        k = i + 1
        mtp_slice = x_embeds[:, k:-1]  # (b, s - k - 1, d)
        mtp_target = x[:, k + 1:]
        h_slice = h_prev[:, :-2] if k == 1 else h_prev[:, :-1]
        s_k = h_slice.shape[1]
        if s_k == 0:
            break

        xn = rms_norm_torch_parity(mtp_slice, mtp.rms_input["scale"])
        hn = rms_norm_torch_parity(h_slice, mtp.rms_h_prev["scale"])
        combined = mtp.down_proj(torch.cat([xn, hn], dim=-1))

        mask = causal_mask(s_k, s_k, window_size=cfg["window_size"], device=x.device)
        h_curr, _ = _block(mtp.trf_block, cfg, combined, mask, params.rope_cos_swa, params.rope_sin_swa, None,
                           swa=True)
        mtp_logits = params.out(rms_norm_torch_parity(h_curr, mtp.final_norm["scale"]))
        mtp_total = mtp_total + cross_entropy(mtp_logits.reshape(-1, mtp_logits.shape[-1]), mtp_target.reshape(-1))
        h_prev = h_curr

    return main_loss + (cfg["mtp_loss_coeff"] / depth) * mtp_total, aux


@torch.no_grad()
def update_moe_biases(params, cfg, moe_counts):
    """Fold the aux-loss-free bias updates into the MoE blocks' ``biases``
    buffers, in place (a non-gradient state update). Returns ``params``."""
    rate = cfg["moe_bias_update_rate"]
    counts = iter(moe_counts)
    for block in params.blocks:
        if hasattr(block, "moe"):
            block.moe.biases.copy_(moe_ops.aux_free_bias_update(block.moe.biases, next(counts), rate))
    return params
