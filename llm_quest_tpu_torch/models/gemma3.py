"""Gemma-3 text model (counterpart of ``llm_quest_tpu/models/gemma3.py``).

- GQA with a per-head GPT-2 LayerNorm on q and k, applied AFTER RoPE;
- local/global alternation: a layer is sliding-window (SWA) unless
  (layer_id + 1) is divisible by (local_global_att_ratio + 1); ratio 0 makes
  every layer global, and so does window_size 0;
- GeGLU FFN (erf GELU gate, no biases); ``out_proj`` has a bias;
- pre- and post-norms around both attention and FFN (4 Llama RMSNorms a
  block);
- tied output head, the table drawn N(0, 1) as the JAX ``init`` draws it.

The JAX config's "logits_softcap" is not applied by the JAX model (the op
stays standalone, ``ops/activations.py::softcap``), nor here.

The ``nn.Module`` classes hold the parameters under the JAX tree's names
(``blocks.3.att.q_norm.shift`` is ``blocks/3/att/q_norm/shift`` there) and
are trainable; the functions with the JAX package's names compute on them.

Kernels on this path: flash attention (K4, forward and backward) through the
attention router for every uncached call with s ≥ ``flash_min_seq``, with
the sliding window on SWA layers, which skips the key tiles outside the
window (an SWA layer costs O(s·window), not O(s²)). The cached branch runs
``sdpa`` on the dense SWA or global mask, as JAX's ``flash_ok=cache is
None`` does. The YaRN-scaled RoPE tables (``rope_tables(scaled=True)``) are
not ported and raise.
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import cache as kv_cache
from llm_quest_tpu_torch.ops import rope
from llm_quest_tpu_torch.ops.activations import gelu_erf
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, split_heads
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params, tied_head
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.norms import layer_norm, rms_norm


def head_dim(cfg):
    return cfg.get("head_dim", cfg["emb_dim"] // cfg["n_heads"])


def is_swa_layer(cfg, layer_id):
    """SWA unless every (ratio+1)-th layer."""
    ratio = cfg["local_global_att_ratio"]
    return cfg["window_size"] > 0 and (layer_id + 1) % (ratio + 1) != 0


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
        for name in ("q_norm", "k_norm"):
            setattr(self, name, params(scale=torch.ones(hd, dtype=dtype, device=device),
                                       shift=torch.zeros(hd, dtype=dtype, device=device), trainable=True))


class Block(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, hidden = cfg["emb_dim"], cfg["hidden_dim"]
        self.pre_att_norm = _rms_norm(d, dtype, device)
        self.att = Attention(cfg, dtype, device)
        self.post_att_norm = _rms_norm(d, dtype, device)
        self.pre_ffn_norm = _rms_norm(d, dtype, device)
        self.ffn = nn.ModuleDict({
            "gate": _linear(d, hidden, dtype, device),
            "up": _linear(d, hidden, dtype, device),
            "down": _linear(hidden, d, dtype, device),
        })
        self.post_ffn_norm = _rms_norm(d, dtype, device)


class Gemma3(nn.Module):
    """Gemma-3; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], cfg["emb_dim"], dtype=dtype, device=device),
                              trainable=True)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device) for _ in range(cfg["n_layers"])])
        self.final_norm = _rms_norm(cfg["emb_dim"], dtype, device)
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
    model = Gemma3(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def rope_tables(cfg, *, scaled=False, device=None):
    if scaled:
        raise NotImplementedError("gemma3.rope_tables: the YaRN-scaled tables (scaled=True) are not ported")
    return rope.compute_angles(cfg["rope_base"], head_dim(cfg), cfg["context_length"], device=device)


def init_cache(cfg, batch, max_len, *, dtype=None, device=None):
    return kv_cache.init_kv_cache(
        cfg["n_layers"], batch, cfg["num_kv_groups"], max_len, head_dim(cfg),
        dtype=dtype or model_dtype(cfg), device=resolve_device(device), quant=cfg.get("kv_quant"),
    )


def geglu(ffn, x):
    """(GELU(x·W_gate) ⊙ x·W_up)·W_down."""
    return ffn["down"](gelu_erf(ffn["gate"](x)) * ffn["up"](x))


def _attention(att, cfg, x, mask, cos, sin, kv_view, position_ids, *, window_size=None, attn_mask=None):
    q = split_heads(att.wq(x), cfg["n_heads"])
    k = split_heads(att.wk(x), cfg["num_kv_groups"])
    v = split_heads(att.wv(x), cfg["num_kv_groups"])

    # RoPE first, QK-norm after
    q = layer_norm(rope.apply(q, cos, sin, position_ids), att.q_norm["scale"], att.q_norm["shift"])
    k = layer_norm(rope.apply(k, cos, sin, position_ids), att.k_norm["scale"], att.k_norm["shift"])

    if kv_view is not None:
        k, v = kv_view(k, v)

    out = merge_heads(attention(
        q, k, v, cfg=cfg, mask=mask, causal=True, window_size=window_size, attn_mask=attn_mask,
        flash_ok=kv_view is None,
    ))
    return att.out_proj(out)


def apply(params, cfg, x, *, attn_mask=None, cache=None, position_ids=None, rope_cos_sin=None, **_):
    """Forward. x: (b, s) ids; attn_mask: optional (b, k_len) bool, True =
    real token. The cache, when given, is written in place. Returns (logits,
    cache with pos advanced, {})."""
    b, s = x.shape
    device = x.device
    cos, sin = rope_cos_sin if rope_cos_sin is not None else (params.rope_cos, params.rope_sin)

    pos0 = cache["pos"] if cache is not None else 0
    if position_ids is None and cache is not None:
        position_ids = (pos0 + torch.arange(s, device=device))[None].expand(b, s)

    k_len = kv_cache.max_len(cache) if cache is not None else s
    global_mask = causal_mask(s, k_len, q_start=pos0, attn_mask=attn_mask, device=device)
    swa_mask = causal_mask(s, k_len, q_start=pos0, window_size=cfg["window_size"], attn_mask=attn_mask, device=device)

    h = embedding(params.tok_emb, x)
    for i, block in enumerate(params.blocks):
        swa = is_swa_layer(cfg, i)
        kv_view = None
        if cache is not None:
            def kv_view(k_new, v_new, idx=i):
                _, kc, vc = kv_cache.update_layer(cache, idx, k_new, v_new)
                return kc, vc

        att_out = _attention(
            block.att, cfg, rms_norm(h, block.pre_att_norm["scale"]), swa_mask if swa else global_mask, cos, sin,
            kv_view, position_ids, window_size=cfg["window_size"] if swa else None, attn_mask=attn_mask,
        )
        h = h + rms_norm(att_out, block.post_att_norm["scale"])
        ffn_out = geglu(block.ffn, rms_norm(h, block.pre_ffn_norm["scale"]))
        h = h + rms_norm(ffn_out, block.post_ffn_norm["scale"])

    h = rms_norm(h, params.final_norm["scale"])
    if cache is not None:
        cache = kv_cache.advance(cache, s)
    return tied_head(params.tok_emb, h), cache, {}
