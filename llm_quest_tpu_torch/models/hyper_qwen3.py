"""Qwen3 with hyper-connections: classic HC, mHC and mHC-lite (counterpart
of ``llm_quest_tpu/models/hyper_qwen3.py``).

The dense Qwen3 of ``models/qwen3.py`` with n residual streams: the token
embedding is expanded to n streams; each sub-block (attention, FFN) is
wrapped by its own HC bundle (``ops/hyper_connections.py::hc_wrap``:
residual = H_res·x, y = block(H_pre·x), out = residual + H_post·y); the
streams are SUMMED (not averaged) before the final norm.

A ``HyperQwen3`` is a ``qwen3.Qwen3`` whose blocks also hold ``hc_attn`` and
``hc_ffn`` and which knows its ``hc_type`` and ``expansion_rate`` (n), the
defaults of ``apply``'s keywords (JAX's default to "hc" and 4 whatever the
tree holds; asking for another type or rate than the model's raises here).
``output_hidden_states`` and ``head_weights`` (the fused-CE training path,
as in ``models/qwen3.py``) are not in JAX's file.

Kernels on this path: flash attention (K4, forward and backward) in every
attention sub-block with s ≥ ``flash_min_seq`` (through ``qwen3._attention``,
causal, without the padding key mask: JAX passes none to the router here
either, so a padded batch's pads are masked only on the ``sdpa`` route).
"""

import torch

from llm_quest_tpu_torch.models import qwen3
from llm_quest_tpu_torch.ops import hyper_connections as hc
from llm_quest_tpu_torch.ops.linear import embedding, tied_head
from llm_quest_tpu_torch.ops.masks import causal_mask
from llm_quest_tpu_torch.ops.mlp import swiglu
from llm_quest_tpu_torch.ops.norms import rms_norm_torch_parity

HC_TYPES = ("hc", "mhc", "mhc-lite")


class HyperQwen3(qwen3.Qwen3):
    """The dense Qwen3 with an HC bundle around each sub-block; ``forward``
    is ``apply``."""

    def __init__(self, cfg, device=None, *, hc_type="hc", expansion_rate=4):
        if hc_type not in HC_TYPES:
            raise ValueError(f"hc_type must be one of {HC_TYPES}, got {hc_type!r}")
        if qwen3.is_moe(cfg):
            raise ValueError("hyper_qwen3 wraps the dense Qwen3 (JAX's apply runs the SwiGLU FFN)")
        super().__init__(cfg, device)
        self.hc_type, self.expansion_rate = hc_type, expansion_rate
        d, device = cfg["emb_dim"], self.tok_emb["w"].device
        for block in self.blocks:
            for name in ("hc_attn", "hc_ffn"):
                bundle = (hc.init_hc_set(d, expansion_rate, device=device) if hc_type == "hc" else
                          hc.init_mhc_set(d, expansion_rate, lite=hc_type == "mhc-lite", device=device))
                block.add_module(name, bundle)

    def forward(self, x, **kwargs):
        return apply(self, self.cfg, x, **kwargs)


@torch.no_grad()
def init(cfg, *, generator, device=None, hc_type="hc", expansion_rate=4):
    """``qwen3.init``'s weights (the same draws from ``generator``) and
    freshly initialised HC bundles of ``hc_type`` over ``expansion_rate``
    streams."""
    model = HyperQwen3(cfg, device, hc_type=hc_type, expansion_rate=expansion_rate)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def apply(params, cfg, x, *, hc_type=None, expansion_rate=None, attn_mask=None, position_ids=None,
          output_hidden_states=False, **_):
    """Forward with n-stream hyper-connections. x: (b, s) ids. ``hc_type``
    and ``expansion_rate`` default to the model's. Returns (logits, None,
    {}), or the final-norm hidden states in place of the logits with
    ``output_hidden_states``."""
    hc_type = params.hc_type if hc_type is None else hc_type
    n = params.expansion_rate if expansion_rate is None else expansion_rate
    if (hc_type, n) != (params.hc_type, params.expansion_rate):
        raise ValueError(f"the model holds {params.hc_type} bundles over {params.expansion_rate} streams, "
                         f"not {hc_type} over {n}")
    b, s = x.shape
    cos, sin = params.rope_cos, params.rope_sin
    mask = causal_mask(s, s, attn_mask=attn_mask, device=x.device)

    h = embedding(params.tok_emb, x)
    h = h[:, :, None, :].expand(b, s, n, cfg["emb_dim"])  # expand to n streams

    for block in params.blocks:
        def attn_fn(single, block=block):
            hn = rms_norm_torch_parity(single, block.pre_att_norm["scale"])
            return qwen3._attention(block.att, cfg, hn, mask, cos, sin, None, position_ids)

        def ffn_fn(single, block=block):
            return swiglu(block.ffn, rms_norm_torch_parity(single, block.pre_ffn_norm["scale"]))

        h = hc.hc_wrap(block.hc_attn, h, attn_fn, hc_type=hc_type, n=n)
        h = hc.hc_wrap(block.hc_ffn, h, ffn_fn, hc_type=hc_type, n=n)

    # SUM the streams: the model learns to split features 1/n across them
    h = rms_norm_torch_parity(h.sum(dim=-2), params.final_norm["scale"])
    if output_hidden_states:
        return h, None, {}
    logits = tied_head(params.tok_emb, h) if cfg["tie_embeddings"] else params.out(h)
    return logits, None, {}


def head_weights(params, cfg):
    return qwen3.head_weights(params, cfg)
