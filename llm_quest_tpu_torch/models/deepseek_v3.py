"""DeepSeek-V3: Multi-Latent Attention, DeepSeek MoE and pre-shifted MTP
(counterpart of ``llm_quest_tpu/models/deepseek_v3.py``: the uncached
forward and training loss, and the cached forward of generation).

- MLA: q and kv go down to latents (``q_rank``, default min(1536, 2·d);
  kv_rank 4·head_dim), each RMS-normed, and up to the heads (head_dim =
  d / n_heads); decoupled RoPE halves of head_dim / 2, q's projected per
  head from the q latent, k's projected once from x and shared by every
  head; q and k are the latent-up part concatenated with the RoPE'd
  decoupled part (q/k width head_dim·3/2, v width head_dim), scaled by
  (head_dim + decoupled)^-0.5; every projection has a bias.
- layout: the first ``num_ffn`` blocks have a dense SwiGLU FFN, the rest the
  DeepSeek MoE (``ops/moe.py::deepseek_moe``, shared experts included).
- MTP: module k takes the embeddings of the collator's k-shifted inputs and
  the previous hidden states at the full length s, RMS-norms both,
  concatenates them through a 2d → d projection and one dense block, and
  takes its logits from the block output through the shared untied head
  (the DeepSeek-V3 paper's form, JAX's deliberate divergence from its
  reference, which reads the logits off the projected input); loss = main
  CE + (coeff / depth)·Σ_k CE_k against the k-shifted targets.

The ``nn.Module`` classes hold the parameters under the JAX tree's names
(``blocks.4.att.wq_down.w`` is ``blocks/4/att/wq_down/w`` there,
``mtp.0.trf_block`` is ``mtp/0/trf_block``), and the MoE balancing biases as
the fp32 buffer ``blocks.<i>.moe.biases`` (no gradient, out of the
optimizer); the functions with the JAX package's names compute on them.

Kernels on this path: flash attention (K4, forward and backward) at q/k 96,
v 64 through the attention router for every uncached call of
``flash_min_seq`` queries or more: the main model's layers and both MTP
blocks. The cached path writes k at 96 and v at 64 (``init_cache``) and runs
``sdpa``, as JAX's ``flash_ok=cache is None`` does. Expert parallelism
(``cfg["expert_parallel"]``) waits for the parallel port and raises.
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import cache as kv_cache
from llm_quest_tpu_torch.ops import moe as moe_ops
from llm_quest_tpu_torch.ops import rope
from llm_quest_tpu_torch.ops.attention import attention, merge_heads, split_heads
from llm_quest_tpu_torch.ops.linear import Linear, embedding, params
from llm_quest_tpu_torch.ops.losses import cross_entropy
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.mlp import swiglu
from llm_quest_tpu_torch.ops.norms import rms_norm


def head_dims(cfg):
    """(head_dim, decoupled RoPE head dim)."""
    hd = cfg["emb_dim"] // cfg["n_heads"]
    return hd, hd // 2


def q_rank(cfg):
    return cfg.get("q_rank", min(1536, 2 * cfg["emb_dim"]))


def _linear(d_in, d_out, dtype, device, bias=True):
    return Linear(d_in, d_out, bias=bias, dtype=dtype, device=device, trainable=True)


def _rms_norm(dim, dtype, device):
    return params(scale=torch.ones(dim, dtype=dtype, device=device), trainable=True)


class MLA(nn.Module):
    """{"wq_down", "wq_up", "wq_decoup", "wkv_down", "wk_up", "wv_up",
    "wk_decoup", "out_proj", "q_norm", "kv_norm"}."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, n = cfg["emb_dim"], cfg["n_heads"]
        hd, dhd = head_dims(cfg)
        qr, kvr = q_rank(cfg), 4 * hd
        self.wq_down = _linear(d, qr, dtype, device)
        self.wq_up = _linear(qr, d, dtype, device)
        self.wq_decoup = _linear(qr, n * dhd, dtype, device)
        self.wkv_down = _linear(d, kvr, dtype, device)
        self.wk_up = _linear(kvr, d, dtype, device)
        self.wv_up = _linear(kvr, d, dtype, device)
        self.wk_decoup = _linear(d, dhd, dtype, device)
        self.out_proj = _linear(d, d, dtype, device)
        self.q_norm = _rms_norm(qr, dtype, device)
        self.kv_norm = _rms_norm(kvr, dtype, device)


class Block(nn.Module):
    """{"norm_1", "att", "norm_2", "ffn" (layer < num_ffn) | "moe"}."""

    def __init__(self, cfg, dtype, device, layer):
        super().__init__()
        d = cfg["emb_dim"]
        self.norm_1 = _rms_norm(d, dtype, device)
        self.att = MLA(cfg, dtype, device)
        self.norm_2 = _rms_norm(d, dtype, device)
        if layer < cfg["num_ffn"]:
            self.ffn = nn.ModuleDict({
                "gate": _linear(d, cfg["hidden_dim"], dtype, device, bias=False),
                "up": _linear(d, cfg["hidden_dim"], dtype, device, bias=False),
                "down": _linear(cfg["hidden_dim"], d, dtype, device, bias=False),
            })
        else:
            self.moe = moe_ops.DeepSeekMoE(cfg, dtype, device)


class MTPModule(nn.Module):
    """{"rms_input", "rms_h_prev", "down_proj" (2d → d), "trf_block" (a
    dense block, layer 0's kind)}."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        self.rms_input = _rms_norm(d, dtype, device)
        self.rms_h_prev = _rms_norm(d, dtype, device)
        self.down_proj = _linear(2 * d, d, dtype, device)
        self.trf_block = Block(cfg, dtype, device, layer=0)


class DeepSeekV3(nn.Module):
    """DeepSeek-V3; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        self.tok_emb = params(w=torch.empty(cfg["vocab_size"], cfg["emb_dim"], dtype=dtype, device=device),
                              trainable=True)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device, i) for i in range(cfg["n_layers"])])
        self.final_norm = _rms_norm(cfg["emb_dim"], dtype, device)
        self.out = _linear(cfg["emb_dim"], cfg["vocab_size"], dtype, device, bias=False)
        self.mtp = nn.ModuleList([MTPModule(cfg, dtype, device) for _ in range(cfg["mtp_depth"])])
        # the decoupled RoPE tables: constants of the config, built once (not parameters)
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
    model = DeepSeekV3(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def rope_tables(cfg, device=None):
    """(cos, sin), each (context_length, decoupled head dim) fp32; the
    config's ``rope_freq`` is not read, as in JAX."""
    _, dhd = head_dims(cfg)
    return rope.compute_angles(cfg["rope_base"], dhd, cfg["context_length"], device=device)


def init_cache(cfg, batch, max_len, *, dtype=None, device=None):
    """One KV cache for every layer: n_heads heads, k (head_dim + decoupled)
    wide and v head_dim wide."""
    hd, dhd = head_dims(cfg)
    return kv_cache.init_kv_cache(
        cfg["n_layers"], batch, cfg["n_heads"], max_len, hd + dhd, v_head_dim=hd,
        dtype=dtype or model_dtype(cfg), device=resolve_device(device), quant=cfg.get("kv_quant"),
    )


def _mla(att, cfg, x, mask, cos, sin, kv_view, position_ids, attn_mask=None):
    """Multi-Latent Attention (module docstring); ``kv_view(k, v)`` writes the
    cache and returns its full views."""
    b, s, _ = x.shape
    n = cfg["n_heads"]
    hd, dhd = head_dims(cfg)

    q_latent = rms_norm(att.wq_down(x), att.q_norm["scale"])
    kv_latent = rms_norm(att.wkv_down(x), att.kv_norm["scale"])
    q = split_heads(att.wq_up(q_latent), n)  # (b, h, s, hd)
    k = split_heads(att.wk_up(kv_latent), n)
    v = split_heads(att.wv_up(kv_latent), n)

    q_dec = rope.apply(split_heads(att.wq_decoup(q_latent), n), cos, sin, position_ids)  # (b, h, s, dhd)
    # one decoupled key for every head: RoPE'd once, then copied into each
    # head's rows by the concatenation (JAX's broadcast_to + concatenate)
    k_dec = rope.apply(att.wk_decoup(x)[:, None], cos, sin, position_ids).expand(b, n, s, dhd)
    q = torch.cat([q, q_dec], dim=-1)
    k = torch.cat([k, k_dec], dim=-1)

    if kv_view is not None:
        k, v = kv_view(k, v)
    out = attention(q, k, v, cfg=cfg, mask=mask, causal=True, scale=(hd + dhd) ** -0.5, attn_mask=attn_mask,
                    flash_ok=kv_view is None)
    return att.out_proj(merge_heads(out))


def _block(block, cfg, h, mask, cos, sin, kv_view, position_ids, attn_mask=None):
    """One block; returns (h, aux) with aux["counts"] and aux["max_vio"] on
    an MoE block."""
    h = h + _mla(block.att, cfg, rms_norm(h, block.norm_1["scale"]), mask, cos, sin, kv_view, position_ids,
                 attn_mask)
    hn = rms_norm(h, block.norm_2["scale"])
    if hasattr(block, "moe"):
        ffn_out, aux = moe_ops.deepseek_moe(block.moe, hn, top_k=cfg["top_k"])
    else:
        ffn_out, aux = swiglu(block.ffn, hn), {}
    return h + ffn_out, aux


def apply(params, cfg, x, *, attn_mask=None, cache=None, position_ids=None, **_):
    """Main-model forward (no MTP). x: (b, s) ids; attn_mask: optional (b,
    k_len) bool, True = real token. The cache, when given, is written in
    place. Returns (logits, cache with pos advanced or None, aux) with
    aux["hidden"] (the last block's output, before the final norm),
    aux["moe_counts"] (one (E,) fp32 count per MoE block) and aux["max_vio"]
    (their mean load violation)."""
    if cfg.get("expert_parallel") is not None:
        raise NotImplementedError("deepseek_v3.apply: expert-parallel dispatch waits for the parallel port")
    b, s = x.shape
    device = x.device
    pos0 = cache["pos"] if cache is not None else 0
    if position_ids is None and cache is not None:
        position_ids = (pos0 + torch.arange(s, device=device))[None].expand(b, s)
    k_len = kv_cache.max_len(cache) if cache is not None else s
    mask = causal_mask(s, k_len, q_start=pos0, attn_mask=attn_mask, device=device)

    h = embedding(params.tok_emb, x)
    counts, vios = [], []
    for i, block in enumerate(params.blocks):
        kv_view = None
        if cache is not None:
            def kv_view(k_new, v_new, idx=i):
                _, kc, vc = kv_cache.update_layer(cache, idx, k_new, v_new)
                return kc, vc

        h, aux = _block(block, cfg, h, mask, params.rope_cos, params.rope_sin, kv_view, position_ids, attn_mask)
        if "counts" in aux:
            counts.append(aux["counts"])
            vios.append(aux["max_vio"])

    if cache is not None:
        cache = kv_cache.advance(cache, s)
    logits = params.out(rms_norm(h, params.final_norm["scale"]))
    aux = {"hidden": h, "moe_counts": counts}
    if vios:
        aux["max_vio"] = torch.stack(vios).mean()
    return logits, cache, aux


def mtp_forward(mtp, params, cfg, s_x, h_prev, mask, cos, sin):
    """One MTP module (module docstring): returns (logits, h_curr), the
    logits from the block output through the shared head."""
    x = rms_norm(embedding(params.tok_emb, s_x), mtp.rms_input["scale"])
    h_prev = rms_norm(h_prev, mtp.rms_h_prev["scale"])
    x = mtp.down_proj(torch.cat([x, h_prev], dim=-1))
    h_curr, _ = _block(mtp.trf_block, cfg, x, mask, cos, sin, None, None)
    return params.out(h_curr), h_curr


def loss(params, cfg, x, y, shifted_x=None, shifted_y=None, *, training=True):
    """Main CE + (coeff / depth)·Σ MTP CE. x, y: (b, s); shifted_x/y: lists
    of ``mtp_depth`` pre-shifted (b, s) tensors from
    ``data/datasets.py::collate_function_mtp``. Returns (loss, aux) with
    ``apply``'s aux; without ``training``, MTP or shifted inputs, the main
    CE alone."""
    logits, _, aux = apply(params, cfg, x)
    main_loss = cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))

    depth = cfg["mtp_depth"]
    if not training or depth == 0 or shifted_x is None:
        return main_loss, aux

    s = x.shape[1]
    mask = causal_mask(s, s, device=x.device)
    h_prev = aux["hidden"]
    mtp_total = 0.0
    for k, mtp in enumerate(params.mtp):
        mtp_logits, h_prev = mtp_forward(mtp, params, cfg, shifted_x[k], h_prev, mask, params.rope_cos,
                                         params.rope_sin)
        mtp_total = mtp_total + cross_entropy(mtp_logits.reshape(-1, mtp_logits.shape[-1]), shifted_y[k].reshape(-1))
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
