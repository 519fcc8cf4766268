"""Vision Transformer classifier, the encode (serving) path (counterpart of
``llm_quest_tpu/models/vit.py``).

- patch embedding: the stride = kernel Conv2d as a patch reshape and one
  matmul against the weight kept in conv layout (emb, c, p, p), bias, a
  learnable CLS token prepended;
- a learnable (1, N+1, d) positional embedding; pre-LN blocks (GPT-2
  LayerNorm, bidirectional maskless attention, GELU-erf FFN at 4·d); final
  LN; the classifier on the CLS token, or the final hidden states with
  ``output_hidden_states``.

The ``nn.Module`` classes hold the parameters under the JAX tree's names
(``blocks.3.att.wq.w`` is ``blocks/3/att/wq/w`` there) and are frozen: the
port serves the ViT; its training engine (``training/vit_engine.py``) and
dropout (``ops/dropout.py``) are not ported, so ``deterministic=False``
with a nonzero ``drop_rate`` raises. Pixels are cast to the weights' dtype
(torch does not promote a matmul's mixed dtypes; JAX would run the whole
forward in fp32 for fp32 pixels and bf16 weights).

Kernels on this path: the attention of every block goes through
``ops/attention.py::mha_packed`` (K7; K8 or K9 with ``cfg["int8_scores"]``,
see ``calibrate_int8_scales``), with the block's index for per-layer scales.
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.ops.attention import mha_packed
from llm_quest_tpu_torch.ops.linear import Linear, params
from llm_quest_tpu_torch.ops.mlp import init_mlp_gelu, mlp_gelu
from llm_quest_tpu_torch.ops.norms import layer_norm


def num_patches(cfg):
    return (cfg["img_width"] * cfg["img_height"]) // cfg["patch_size"] ** 2


def _layer_norm(dim, dtype, device):
    ones, zeros = torch.ones(dim, dtype=dtype, device=device), torch.zeros(dim, dtype=dtype, device=device)
    return params(scale=ones, shift=zeros)


class Attention(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        for name in ("wq", "wk", "wv"):
            setattr(self, name, Linear(d, d, bias=cfg["qkv_bias"], dtype=dtype, device=device))
        self.out_proj = Linear(d, d, bias=True, dtype=dtype, device=device)


class Block(nn.Module):
    def __init__(self, cfg, dtype, device):
        super().__init__()
        d = cfg["emb_dim"]
        self.ln_1 = _layer_norm(d, dtype, device)
        self.att = Attention(cfg, dtype, device)
        self.ln_2 = _layer_norm(d, dtype, device)
        self.ffn = init_mlp_gelu(d, 4 * d, bias=True, dtype=dtype, device=device)


class ViT(nn.Module):
    """The ViT classifier; ``forward`` is ``apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, device = model_dtype(cfg), resolve_device(device)
        self.cfg = cfg
        p, c, d = cfg["patch_size"], cfg["num_channels"], cfg["emb_dim"]
        self.patch_emb = params(
            conv_w=torch.empty(d, c, p, p, dtype=dtype, device=device),
            conv_b=torch.empty(d, dtype=dtype, device=device),
            cls_token=torch.empty(1, 1, d, dtype=dtype, device=device),
        )
        self.pos_emb = nn.Parameter(torch.empty(1, num_patches(cfg) + 1, d, dtype=dtype, device=device),
                                    requires_grad=False)
        self.blocks = nn.ModuleList([Block(cfg, dtype, device) for _ in range(cfg["n_layers"])])
        self.final_ln = _layer_norm(d, dtype, device)
        self.classifier = Linear(d, cfg["num_classes"], bias=True, dtype=dtype, device=device)

    def reset_parameters(self, generator):
        """JAX's ``init_patch_embedding`` and positional embedding: the conv
        weight and bias U(±1/sqrt(c·p·p)), the CLS token and ``pos_emb`` N(0, 1)."""
        w = self.patch_emb["conv_w"]
        bound = 1.0 / (w[0].numel() ** 0.5)
        w.uniform_(-bound, bound, generator=generator)
        self.patch_emb["conv_b"].uniform_(-bound, bound, generator=generator)
        self.patch_emb["cls_token"].normal_(generator=generator)
        self.pos_emb.normal_(generator=generator)

    def forward(self, x, **kwargs):
        return apply(self, self.cfg, x, **kwargs)


@torch.no_grad()
def init(cfg, *, generator, device=None):
    """Model with random weights drawn from ``generator`` (which lives on
    ``device``), with the JAX ``init`` distributions (linears U(±1/sqrt(in)))."""
    model = ViT(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def patch_embedding(patch_emb, cfg, x):
    """x: (b, c, H, W) → (b, N+1, d) with the CLS token prepended."""
    b, c, hh, ww = x.shape
    p = cfg["patch_size"]
    w = patch_emb["conv_w"]
    d = w.shape[0]
    nh, nw = hh // p, ww // p
    # patchify: (b, c, nh, p, nw, p) → (b, nh, nw, c, p, p) → (b, N, c·p·p)
    patches = x.to(w.dtype).reshape(b, c, nh, p, nw, p).permute(0, 2, 4, 1, 3, 5).reshape(b, nh * nw, c * p * p)
    emb = torch.nn.functional.linear(patches, w.reshape(d, -1), patch_emb["conv_b"])
    cls = patch_emb["cls_token"].expand(b, 1, d).to(emb.dtype)
    return torch.cat([cls, emb], dim=1)


def _attention(att, cfg, x, layer_idx=None):
    # bidirectional and maskless, on the packed (b, s, h·d) projections
    out = mha_packed(att.wq(x), att.wk(x), att.wv(x), cfg["n_heads"], cfg=cfg, layer_idx=layer_idx)
    return att.out_proj(out)


def _embed(params, cfg, x):
    h = patch_embedding(params.patch_emb, cfg, x)
    return h + params.pos_emb.to(h.dtype)


def apply(params, cfg, x, *, output_hidden_states=False, deterministic=True, **_):
    """x: (b, c, H, W) images. Returns (b, num_classes) logits, or the final
    (b, N+1, d) hidden states with ``output_hidden_states``."""
    if not deterministic and cfg.get("drop_rate", 0.0) > 0:
        raise NotImplementedError("vit: dropout is not ported (it comes with the ViT training engine)")
    h = _embed(params, cfg, x)
    for i, block in enumerate(params.blocks):
        h = h + _attention(block.att, cfg, layer_norm(h, block.ln_1["scale"], block.ln_1["shift"]), layer_idx=i)
        h = h + mlp_gelu(block.ffn, layer_norm(h, block.ln_2["scale"], block.ln_2["shift"]))
    h = layer_norm(h, params.final_ln["scale"], params.final_ln["shift"])
    if output_hidden_states:
        return h
    return params.classifier(h[:, 0])


@torch.no_grad()
def calibrate_int8_scales(params, cfg, x):
    """Per-layer (q_scale, k_scale) = (max|q| / 127, max|k| / 127) for static
    int8 score quantization, from one forward of the calibration images
    ``x`` without int8 scores, reading each layer's q and k projections.
    Feed the result back as ``cfg["int8_qk_scales"]`` (with
    ``cfg["int8_scores"] = True``). One host sync, at the end."""
    cfg = dict(cfg, int8_scores=False, drop_rate=0.0)
    h = _embed(params, cfg, x)
    maxes = []
    for block in params.blocks:
        hn = layer_norm(h, block.ln_1["scale"], block.ln_1["shift"])
        q, k = block.att.wq(hn), block.att.wk(hn)
        maxes.append(torch.stack([q.float().abs().amax(), k.float().abs().amax()]))
        h = h + _attention(block.att, cfg, hn)
        h = h + mlp_gelu(block.ffn, layer_norm(h, block.ln_2["scale"], block.ln_2["shift"]))
    return [(mq / 127.0, mk / 127.0) for mq, mk in torch.stack(maxes).tolist()]
