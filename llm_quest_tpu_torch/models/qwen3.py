"""Qwen3 dense and MoE models (counterpart of ``llm_quest_tpu/models/qwen3.py``).

- GQA with QK-RMSNorm applied BEFORE RoPE, the whole norm in fp32;
- ``head_dim`` decoupled from ``emb_dim``; all projections bias-free;
- tied output head: the tied table is re-initialised Xavier-uniform;
- gradient checkpointing per block through ``ops/remat.py``;
- ``model_type="moe"`` (Qwen3-30B-A3B, ``temp_moe``): every block's FFN is
  ``ops/moe.py::Qwen3MoE`` (no shared expert), the exact dispatch, with
  ``aux["gate_probas"]`` per block and, when training, ``aux["moe_loss"]``
  (the blocks' summed load-balance terms); the head is untied.

The ``nn.Module`` classes hold the parameters under the JAX tree's names
(``blocks.3.att.wq.w`` is ``blocks/3/att/wq/w`` there) and are trainable;
the functions with the JAX package's names compute on them. JAX's routing
replay (its ``gate_probas=`` argument) comes with the alignment trainers
(ROADMAP).

Kernels on this path: flash attention (K4, forward and backward) through the
attention router, for every call with s ≥ ``flash_min_seq``, and with
``cfg["kv_quant"] = "int8"`` the decode step over the int8 KV cache (K10);
the MoE model quantized by ``ops/quantization.py::quantize_params_int8``
also runs its expert stacks through the int8 grouped matmul (K11), the
group sizes staying on the device.

Context parallelism (JAX's ``cp_active``): under ``cfg["context_parallel"]
= {"group": ProcessGroup}`` an uncached forward without a padding mask
builds no dense mask. Given a rank's slice of the sequence with its global
``position_ids`` (``parallel/mesh.py::shard_batch``), RoPE takes those
positions and every attention layer runs the ring of
``parallel/sequence.py::ring_flash_attention`` (K5, forward and backward);
given a whole batch that would not shard, the router takes JAX's fall-through
with no mask: the short-sequence kernel (K6) for equal head counts at
2 ≤ s ≤ ``fused_mha_max_seq``, the causal mask rebuilt otherwise.
A model quantized by ``ops/quantization.py::quantize_params_int8`` serves
unchanged (``QuantLinear`` layers, an int8 table through ``ops/linear.py``).
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import cache as kv_cache
from llm_quest_tpu_torch.ops import moe as moe_ops
from llm_quest_tpu_torch.ops import rope
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, split_heads
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params, tied_head
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.mlp import swiglu
from llm_quest_tpu_torch.ops.norms import rms_norm_torch_parity
from llm_quest_tpu_torch.ops.remat import checkpoint_block


def _rms_norm(dim, dtype, device):
    return params(scale=torch.ones(dim, dtype=dtype, device=device), trainable=True)


def _linear(d_in, d_out, dtype, device):
    return Linear(d_in, d_out, bias=False, dtype=dtype, device=device, trainable=True)


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hd = cfg["emb_dim"], cfg["head_dim"]
        self.wq = _linear(d, cfg["n_heads"] * hd, dtype, device)
        self.wk = _linear(d, cfg["num_kv_groups"] * hd, dtype, device)
        self.wv = _linear(d, cfg["num_kv_groups"] * hd, dtype, device)
        self.out_proj = _linear(cfg["n_heads"] * hd, d, dtype, device)
        self.q_norm = _rms_norm(hd, dtype, device)
        self.k_norm = _rms_norm(hd, dtype, device)


def is_moe(cfg):
    return cfg.get("model_type", "dense") == "moe"


class Block(nn.Module):
    """{"pre_att_norm", "att", "pre_ffn_norm", "ffn" | "moe"}."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        self.pre_att_norm = _rms_norm(d, dtype, device)
        self.att = Attention(cfg, dtype, device)
        self.pre_ffn_norm = _rms_norm(d, dtype, device)
        if is_moe(cfg):
            self.moe = moe_ops.Qwen3MoE(cfg, dtype, device)
        else:
            hidden = cfg["hidden_dim"]
            self.ffn = nn.ModuleDict({
                "gate": _linear(d, hidden, dtype, device),
                "up": _linear(d, hidden, dtype, device),
                "down": _linear(hidden, d, dtype, device),
            })


class Qwen3(nn.Module):
    """Qwen3, dense or MoE (``cfg["model_type"]``); ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], cfg["emb_dim"], dtype=dtype, device=device),
                              trainable=True)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device) for _ in range(cfg["n_layers"])])
        self.final_norm = _rms_norm(cfg["emb_dim"], dtype, device)
        if not cfg["tie_embeddings"]:
            self.out = _linear(cfg["emb_dim"], cfg["vocab_size"], dtype, device)
        # RoPE tables: constants of the config, built once (not parameters)
        cos, sin = rope_tables(cfg, device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def reset_parameters(self, generator):
        w = self.tok_emb["w"]
        if self.cfg["tie_embeddings"]:
            # the tied head shares the table: Xavier-uniform replaces N(0, 1)
            bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
            w.uniform_(-bound, bound, generator=generator)
        else:
            w.normal_(generator=generator)

    def forward(self, x, **kwargs):
        return apply(self, self.cfg, x, **kwargs)


@torch.no_grad()
def init(cfg, *, generator, device=None):
    """Model with random weights drawn from ``generator`` (which lives on
    ``device``), with the JAX ``init`` distributions."""
    model = Qwen3(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def rope_tables(cfg, device=None):
    return rope.compute_angles(cfg["rope_base"], cfg["head_dim"], cfg["context_length"], device=device)


def init_cache(cfg, batch, max_len, *, dtype=None, device=None):
    return kv_cache.init_kv_cache(
        cfg["n_layers"], batch, cfg["num_kv_groups"], max_len, cfg["head_dim"],
        dtype=dtype or model_dtype(cfg), device=resolve_device(device), quant=cfg.get("kv_quant"),
    )


def _attention(att, cfg, x, mask, cos, sin, kv_view, position_ids, attn_mask=None, q_start=None):
    q = split_heads(att.wq(x), cfg["n_heads"])
    k = split_heads(att.wk(x), cfg["num_kv_groups"])
    v = split_heads(att.wv(x), cfg["num_kv_groups"])

    # QK-norm BEFORE RoPE
    q = rope.apply(rms_norm_torch_parity(q, att.q_norm["scale"]), cos, sin, position_ids)
    k = rope.apply(rms_norm_torch_parity(k, att.k_norm["scale"]), cos, sin, position_ids)

    if kv_view is not None:
        k, v = kv_view(k, v)

    # flash covers uncached full-sequence calls AND cached prefill (sq < sk
    # against the max_len cache view) when the query offset is static
    out = merge_heads(attention(
        q, k, v, cfg=cfg, mask=mask, causal=True, attn_mask=attn_mask,
        flash_ok=kv_view is None or q_start is not None, q_start=q_start,
    ))
    return att.out_proj(out)


def apply(params, cfg, x, *, attn_mask=None, cache=None, position_ids=None, training=False,
          output_hidden_states=False, **_):
    """Forward. x: (b, s) ids; attn_mask: optional (b, k_len) bool, True =
    real token. The cache, when given, is written in place; its ``pos`` may
    be an int or a (b,) tensor of per-row columns (continuous-batching
    serving). Returns (logits,
    cache with pos advanced, aux), or the final-norm hidden states in place of
    the logits with ``output_hidden_states``. aux is {} for the dense model;
    the MoE model's has "gate_probas" (one (b·s, E) fp32 tensor per block)
    and, when training, "moe_loss"."""
    b, s = x.shape
    device = x.device
    cos, sin = params.rope_cos, params.rope_sin

    pos0 = cache["pos"] if cache is not None else 0
    per_row = kv_cache.is_vector(pos0)
    if position_ids is None and cache is not None:
        position_ids = kv_cache.positions(pos0, b, s, device)
    # static query offset for cached prefill (flash over the max_len view);
    # per-row positions have none, as in JAX
    q_start = int(pos0) if cache is not None and s > 1 and not per_row else None

    k_len = kv_cache.max_len(cache) if cache is not None else s
    # under context parallelism the dense (s, s) mask is the O(s²) object CP
    # exists to avoid: the router streams causality through the ring instead.
    # A rank's slice (parallel/mesh.py::shard_batch) comes with its global
    # position_ids; a batch that would not shard comes whole, without them,
    # and its attention routes as JAX's does when the CP branch is not taken
    cp_active = cfg.get("context_parallel") is not None and cache is None and attn_mask is None
    mask = None if cp_active else causal_mask(s, k_len, q_start=pos0, attn_mask=attn_mask, device=device)
    att_cfg = cfg
    if cp_active and position_ids is None:
        att_cfg = {key: val for key, val in cfg.items() if key != "context_parallel"}
    h = embedding(params.tok_emb, x)
    use_ckpt = cfg.get("gradient_checkpointing", False) and training and cache is None
    moe = is_moe(cfg)
    plain = not cfg.get("use_kernels", True)
    aux = {"gate_probas": []} if moe else {}
    moe_loss = 0.0

    for i, block in enumerate(params.blocks):
        kv_view = None
        if cache is not None:
            def kv_view(k_new, v_new, idx=i):
                _, kc, vc = kv_cache.update_layer(cache, idx, k_new, v_new)
                return kc, vc

        def block_fn(h, block=block, kv_view=kv_view):
            hn = rms_norm_torch_parity(h, block.pre_att_norm["scale"])
            h = h + _attention(block.att, att_cfg, hn, mask, cos, sin, kv_view, position_ids, attn_mask, q_start)
            hn = rms_norm_torch_parity(h, block.pre_ffn_norm["scale"])
            if not moe:
                return h + swiglu(block.ffn, hn), {}
            ffn_out, moe_aux = moe_ops.qwen3_moe(block.moe, hn, top_k=cfg["top_k"], load_coeff=cfg["aux_loss_coef"],
                                                 training=training, plain=plain)
            return h + ffn_out, moe_aux

        h, moe_aux = checkpoint_block(cfg, block_fn)(h) if use_ckpt else block_fn(h)
        if moe:
            aux["gate_probas"].append(moe_aux["gate_probas"])
            if "moe_loss" in moe_aux:
                moe_loss = moe_loss + moe_aux["moe_loss"]

    if moe and training:
        aux["moe_loss"] = moe_loss
    h = rms_norm_torch_parity(h, params.final_norm["scale"])
    if cache is not None:
        cache = kv_cache.advance(cache, s)
    if output_hidden_states:
        return h, cache, aux
    logits = tied_head(params.tok_emb, h) if cfg["tie_embeddings"] else params.out(h)
    return logits, cache, aux


def head_weights(params, cfg):
    """(d, vocab) output-head matrix, a view of the tied table (or of the
    untied head) — for the fused-CE training path."""
    if cfg["tie_embeddings"]:
        return params.tok_emb["w"].T
    return params.out.w.T
