"""GPT-2 (counterpart of ``llm_quest_tpu/models/gpt2.py``).

- learned absolute position embeddings, offset by the KV cache's column;
- pre-LN blocks with the GPT-2 LayerNorm ((x − μ)/(σ + eps)), erf-GELU FFN at
  4·d, biased projections (q/k/v by ``cfg["qkv_bias"]``, ``out_proj``
  always);
- an untied output head ``out`` without a bias (vocabulary 50,257 at 124M);
- ``input_embedded``: embeddings in place of ids (early-fusion entry, no
  position embedding added); ``last_token_only``: the logits of each row's
  last REAL token (needs ``attn_mask``);
- dropout at ``cfg["drop_rate"]`` with ``deterministic=False`` and a
  ``torch.Generator`` on x's device (``ops/dropout.py``), at JAX's three
  sites: the embedded input, the attention branch and the FFN branch.

The ``nn.Module`` classes hold the parameters under the JAX tree's names
(``blocks.3.att.wq.w`` is ``blocks/3/att/wq/w`` there) and are trainable;
the functions with the JAX package's names compute on them.

Kernels on this path: flash attention (K4, forward and backward) through the
attention router for every uncached call with s ≥ ``flash_min_seq``, causal,
with the padding key mask when ``attn_mask`` is given. A cached call (prefill
or decode) runs ``sdpa``, as JAX's ``flash_ok=cache is None`` does.
``cfg["pipeline_parallel"]`` (JAX's GPipe stack) raises: the pipeline waits
for the port's parallel package (ROADMAP Queue 1 item 10).
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import cache as kv_cache
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, split_heads
from llm_quest_tpu_torch.ops.dropout import dropout
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.mlp import init_mlp_gelu, mlp_gelu
from llm_quest_tpu_torch.ops.norms import layer_norm


def _layer_norm(dim, dtype, device):
    ones, zeros = torch.ones(dim, dtype=dtype, device=device), torch.zeros(dim, dtype=dtype, device=device)
    return params(scale=ones, shift=zeros, trainable=True)


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        for name in ("wq", "wk", "wv"):
            setattr(self, name, Linear(d, d, bias=cfg["qkv_bias"], dtype=dtype, device=device, trainable=True))
        self.out_proj = Linear(d, d, bias=True, dtype=dtype, device=device, trainable=True)


class Block(nn.Module):
    """{"ln_1", "att", "ln_2", "ffn"}."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        self.ln_1 = _layer_norm(d, dtype, device)
        self.att = Attention(cfg, dtype, device)
        self.ln_2 = _layer_norm(d, dtype, device)
        self.ffn = init_mlp_gelu(d, 4 * d, bias=True, dtype=dtype, device=device)


class GPT2(nn.Module):
    """GPT-2; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        d = cfg["emb_dim"]
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], d, dtype=dtype, device=device), trainable=True)
        self.pos_emb = params(w=torch.empty(cfg["context_length"], d, dtype=dtype, device=device), trainable=True)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device) for _ in range(cfg["n_layers"])])
        self.final_ln = _layer_norm(d, dtype, device)
        self.out = Linear(d, cfg["vocab_size"], bias=False, dtype=dtype, device=device, trainable=True)

    def reset_parameters(self, generator):
        """JAX's ``init_embedding``: both tables N(0, 1)."""
        self.tok_emb["w"].normal_(generator=generator)
        self.pos_emb["w"].normal_(generator=generator)

    def forward(self, x, **kwargs):
        return apply(self, self.cfg, x, **kwargs)


@torch.no_grad()
def init(cfg, *, generator, device=None):
    """Model with random weights drawn from ``generator`` (which lives on
    ``device``), with the JAX ``init`` distributions (linears U(±1/sqrt(in)),
    tables N(0, 1), LayerNorms 1 and 0)."""
    model = GPT2(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def init_cache(cfg, batch, max_len, *, dtype=None, device=None):
    return kv_cache.init_kv_cache(
        cfg["n_layers"], batch, cfg["n_heads"], max_len, cfg["emb_dim"] // cfg["n_heads"],
        dtype=dtype or model_dtype(cfg), device=resolve_device(device), quant=cfg.get("kv_quant"),
    )


def _attention(att, cfg, x, mask, kv_view, attn_mask=None):
    n_heads = cfg["n_heads"]
    q, k, v = (split_heads(proj(x), n_heads) for proj in (att.wq, att.wk, att.wv))
    if kv_view is not None:
        k, v = kv_view(k, v)
    out = attention(q, k, v, cfg=cfg, mask=mask, causal=True, attn_mask=attn_mask, flash_ok=kv_view is None)
    return att.out_proj(merge_heads(out))


def apply(params, cfg, x, *, attn_mask=None, cache=None, last_token_only=False, input_embedded=False,
          position_ids=None, deterministic=True, generator=None, output_hidden_states=False, **_):
    """Forward. x: (b, s) token ids, or (b, s, emb_dim) with
    ``input_embedded``. attn_mask: (b, s) bool, True = real token (or (b,
    max_len) with a cache, written in place). Position ids default to the
    cache's column + 0..s-1 (its per-row columns for a (b,) ``pos``).
    Returns (logits, cache with pos advanced or None, {}), the final-LN
    hidden states in place of the logits with ``output_hidden_states``, or
    (b, vocab) logits of each row's last real token with
    ``last_token_only``."""
    if cfg.get("pipeline_parallel") is not None:
        raise NotImplementedError("gpt2: pipeline_parallel (GPipe) waits for the port's parallel package "
                                  "(ROADMAP Queue 1 item 10)")
    b, s = x.shape[:2]
    device = x.device
    drop = cfg.get("drop_rate", 0.0)

    pos0 = cache["pos"] if cache is not None else 0
    if input_embedded:
        h = x
    else:
        h = embedding(params.tok_emb, x)
        if position_ids is None:
            position_ids = (kv_cache.positions(pos0, b, s, device) if cache is not None
                            else torch.arange(s, device=device)[None])
        h = h + embedding(params.pos_emb, position_ids)
    h = dropout(generator, h, drop, deterministic)

    k_len = kv_cache.max_len(cache) if cache is not None else s
    mask = causal_mask(s, k_len, q_start=pos0, attn_mask=attn_mask, device=device)

    for i, block in enumerate(params.blocks):
        kv_view = None
        if cache is not None:
            def kv_view(k_new, v_new, idx=i):
                _, kc, vc = kv_cache.update_layer(cache, idx, k_new, v_new)
                return kc, vc

        hn = layer_norm(h, block.ln_1["scale"], block.ln_1["shift"])
        att_out = _attention(block.att, cfg, hn, mask, kv_view, attn_mask)
        h = h + dropout(generator, att_out, drop, deterministic)
        hn = layer_norm(h, block.ln_2["scale"], block.ln_2["shift"])
        h = h + dropout(generator, mlp_gelu(block.ffn, hn), drop, deterministic)

    h = layer_norm(h, params.final_ln["scale"], params.final_ln["shift"])
    if cache is not None:
        cache = kv_cache.advance(cache, s)
    if output_hidden_states:
        return h, cache, {}
    if last_token_only:
        if attn_mask is None:
            raise ValueError("gpt2.apply: last_token_only=True needs attn_mask")
        h = h[torch.arange(b, device=device), attn_mask.long().sum(-1) - 1]  # (b, emb_dim)
    return params.out(h), cache, {}


def head_weights(params, cfg):
    """(d, vocab) output-head matrix, a view of the bias-free ``out`` head —
    for the fused-CE training path."""
    return params.out.w.T
