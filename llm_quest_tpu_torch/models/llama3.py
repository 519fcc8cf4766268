"""Llama-3.2 (counterpart of ``llm_quest_tpu/models/llama3.py``).

- GQA with RoPE on q and k (no QK-norm), the kv heads grouped inside the
  attention (no repeat);
- the Llama RMSNorm (fp32 mean square, eps outside the square root, the
  scale applied after the cast back);
- SwiGLU FFN; no biases but ``out_proj``'s;
- the output head tied to the token table, drawn N(0, 1) as JAX's ``init``
  draws it;
- ``rope_tables(cfg, scaled=True)``: the YaRN by-parts tables of
  ``cfg["rope_freq"]``, which ``apply(rope_cos_sin=)`` takes (the default
  is the unscaled tables, as in JAX);
- ``collect_max_logits``: ``aux["max_attn_logits"]``, one (n_heads,)
  tensor a layer, the largest q·k/√d of each head over the batch, the
  queries and every key of the call (masked ones included, as in JAX), for
  QK-clip.

``output_hidden_states`` and ``head_weights`` (the fused-CE training path,
as ``models/qwen3.py`` has them) are not in JAX's file, whose ``apply``
ignores the keyword.

The ``nn.Module`` classes hold the parameters under the JAX tree's names and
are trainable; the functions with the JAX package's names compute on them.

Kernels on this path: flash attention (K4, forward and backward) through the
attention router for every uncached call with s ≥ ``flash_min_seq``
(Llama-3.2-1B: 32 q / 8 kv heads of 64). A cached call runs ``sdpa`` (JAX's
``flash_ok=cache is None``); with ``cfg["kv_quant"] = "int8"`` at head dim
64 the decode step dequantizes the cache (K10 takes head dims that are
multiples of 128). Under ``cfg["context_parallel"]`` an uncached forward
without a padding mask builds no mask, as ``models/qwen3.py`` does.
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import cache as kv_cache
from llm_quest_tpu_torch.ops import rope
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, split_heads
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params, tied_head
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.mlp import swiglu
from llm_quest_tpu_torch.ops.norms import rms_norm


def head_dim(cfg):
    return cfg.get("head_dim", cfg["emb_dim"] // cfg["n_heads"])


def _linear(d_in, d_out, dtype, device, bias=False):
    return Linear(d_in, d_out, bias=bias, dtype=dtype, device=device, trainable=True)


def _rms_norm(dim, dtype, device):
    return params(scale=torch.ones(dim, dtype=dtype, device=device), trainable=True)


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hd = cfg["emb_dim"], head_dim(cfg)
        self.wq = _linear(d, cfg["n_heads"] * hd, dtype, device)
        self.wk = _linear(d, cfg["num_kv_groups"] * hd, dtype, device)
        self.wv = _linear(d, cfg["num_kv_groups"] * hd, dtype, device)
        self.out_proj = _linear(cfg["n_heads"] * hd, d, dtype, device, bias=True)


class Block(nn.Module):
    """{"pre_att_norm", "att", "pre_ffn_norm", "ffn"}."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hidden = cfg["emb_dim"], cfg["hidden_dim"]
        self.pre_att_norm = _rms_norm(d, dtype, device)
        self.att = Attention(cfg, dtype, device)
        self.pre_ffn_norm = _rms_norm(d, dtype, device)
        self.ffn = nn.ModuleDict({
            "gate": _linear(d, hidden, dtype, device),
            "up": _linear(d, hidden, dtype, device),
            "down": _linear(hidden, d, dtype, device),
        })


class Llama3(nn.Module):
    """Llama-3.2; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], cfg["emb_dim"], dtype=dtype, device=device),
                              trainable=True)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device) for _ in range(cfg["n_layers"])])
        self.final_norm = _rms_norm(cfg["emb_dim"], dtype, device)
        # the unscaled RoPE tables: constants of the config, built once (not parameters)
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
    model = Llama3(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def rope_tables(cfg, *, scaled=False, device=None):
    """(cos, sin) fp32 tables; ``scaled`` applies the YaRN by-parts scaling of
    ``cfg["rope_freq"]`` (``ops/rope.py``; a "rope_freq" without the keys it
    reads raises ``ValueError``)."""
    return rope.compute_angles(cfg["rope_base"], head_dim(cfg), cfg["context_length"],
                               smooth_scaling_cfg=cfg.get("rope_freq") if scaled else None, device=device)


def init_cache(cfg, batch, max_len, *, dtype=None, device=None):
    return kv_cache.init_kv_cache(
        cfg["n_layers"], batch, cfg["num_kv_groups"], max_len, head_dim(cfg),
        dtype=dtype or model_dtype(cfg), device=resolve_device(device), quant=cfg.get("kv_quant"),
    )


def _max_logits(q, k, cfg):
    """(n_heads,) largest q·k/√d of each head over batch, queries and keys."""
    if not torch.is_tensor(k):  # an int8 cache view
        k = k.dequant(q.dtype)
    b, hq, sq, hd = q.shape
    hkv = k.shape[1]
    scores = q.reshape(b, hkv, hq // hkv, sq, hd) @ k[:, :, None].transpose(-1, -2) * hd**-0.5
    return scores.reshape(b, hq, sq, -1).amax(dim=(0, 2, 3)).detach()


def _attention(att, cfg, x, mask, cos, sin, kv_view, position_ids, *, collect_max_logits=False, attn_mask=None):
    q = split_heads(att.wq(x), cfg["n_heads"])
    k = split_heads(att.wk(x), cfg["num_kv_groups"])
    v = split_heads(att.wv(x), cfg["num_kv_groups"])

    q = rope.apply(q, cos, sin, position_ids)
    k = rope.apply(k, cos, sin, position_ids)

    if kv_view is not None:
        k, v = kv_view(k, v)

    max_logits = _max_logits(q, k, cfg) if collect_max_logits else None
    out = merge_heads(attention(q, k, v, cfg=cfg, mask=mask, causal=True, attn_mask=attn_mask,
                                flash_ok=kv_view is None))
    return att.out_proj(out), max_logits


def apply(params, cfg, x, *, attn_mask=None, cache=None, position_ids=None, rope_cos_sin=None,
          collect_max_logits=False, output_hidden_states=False, **_):
    """Forward. x: (b, s) ids; attn_mask: optional (b, k_len) bool, True =
    real token; ``rope_cos_sin``: tables in place of the unscaled ones (e.g.
    ``rope_tables(cfg, scaled=True)``). The cache, when given, is written in
    place; its ``pos`` may be an int or a (b,) tensor of per-row columns.
    Returns (logits, cache with pos advanced, aux), or the final-norm hidden
    states in place of the logits with ``output_hidden_states``; aux holds
    "max_attn_logits" with ``collect_max_logits``."""
    b, s = x.shape
    device = x.device
    cos, sin = rope_cos_sin if rope_cos_sin is not None else (params.rope_cos, params.rope_sin)

    pos0 = cache["pos"] if cache is not None else 0
    if position_ids is None and cache is not None:
        position_ids = kv_cache.positions(pos0, b, s, device)

    k_len = kv_cache.max_len(cache) if cache is not None else s
    # context parallelism skips the dense O(s²) mask: the router streams
    # causality through the ring (models/qwen3.py's rule)
    cp_active = cfg.get("context_parallel") is not None and cache is None and attn_mask is None
    mask = None if cp_active else causal_mask(s, k_len, q_start=pos0, attn_mask=attn_mask, device=device)
    att_cfg = cfg
    if cp_active and position_ids is None:
        att_cfg = {key: val for key, val in cfg.items() if key != "context_parallel"}

    h = embedding(params.tok_emb, x)
    aux = {}
    for i, block in enumerate(params.blocks):
        kv_view = None
        if cache is not None:
            def kv_view(k_new, v_new, idx=i):
                _, kc, vc = kv_cache.update_layer(cache, idx, k_new, v_new)
                return kc, vc

        att_out, max_logits = _attention(
            block.att, att_cfg, rms_norm(h, block.pre_att_norm["scale"]), mask, cos, sin, kv_view, position_ids,
            collect_max_logits=collect_max_logits, attn_mask=attn_mask,
        )
        if collect_max_logits:
            aux.setdefault("max_attn_logits", []).append(max_logits)
        h = h + att_out
        h = h + swiglu(block.ffn, rms_norm(h, block.pre_ffn_norm["scale"]))

    h = rms_norm(h, params.final_norm["scale"])
    if cache is not None:
        cache = kv_cache.advance(cache, s)
    if output_hidden_states:
        return h, cache, aux
    return tied_head(params.tok_emb, h), cache, aux


def head_weights(params, cfg):
    """(d, vocab) output-head matrix, a view of the tied table — for the
    fused-CE training path."""
    return params.tok_emb["w"].T
