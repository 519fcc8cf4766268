"""Load a JAX parameter tree into the port's modules (counterpart of
``llm_quest_tpu/weights/interop.py``; only the JAX → torch direction).

Layout rule: the JAX package stores linear weights ``(in, out)`` for
``x @ w``; the port stores them as torch does, ``(out, in)``, for
``F.linear``. So every ``Linear`` weight is transposed on the way in, and no
other leaf is: embedding tables are ``(num, dim)``, the patch conv weight
keeps its conv layout and the depthwise conv1d weight its ``(channels,
kernel)`` layout in both packages. The GDN recurrent state is ``(dv, dk)`` in
both, so cache states compare directly.

A tree quantized by the JAX ``quantize_params_int8`` loads too: the model
takes the quantized structure first (``ops/quantization.py::quantized_like``).
A linear's ``w_q`` is transposed like ``w``; its ``w_scale`` ((out,) or
(nb, out)), an int8 embedding table and its per-row scales, and the expert
stacks' ``<name>_q`` (E, in, out) and ``<name>_scale`` (E, out) have one
layout in both packages.
"""

import numpy as np
import torch

from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.models import deepseek_v3, gemma3, mimo_v2_flash, qwen3, qwen3_5, qwen3_next, vit
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.ops.quantization import quantized_like


def _model_for(flat, cfg, device):
    if "img_width" in cfg and "vocab_size" not in cfg:  # an image model with no text side: the ViT
        return vit.ViT(cfg, device)
    if "num_ffn" in cfg:  # dense blocks, then DeepSeek MoE, with MLA and MTP: DeepSeek-V3
        return deepseek_v3.DeepSeekV3(cfg, device)
    if "hybrid_ratio" in cfg:  # the SWA/GA hybrid with MTP: MiMo-V2-Flash
        return mimo_v2_flash.MiMoV2Flash(cfg, device)
    if "window_size" in cfg and "local_global_att_ratio" in cfg:  # local/global attention: Gemma-3
        return gemma3.Gemma3(cfg, device)
    if "linear_sdpa_ratio" not in cfg:  # no GDN/attention hybrid: Qwen3, dense or MoE (cfg["model_type"])
        return qwen3.Qwen3(cfg, device)
    if "num_experts" in cfg or any("/moe/" in name for name in flat):  # the MoE hybrid
        return qwen3_next.Qwen3Next(cfg, device)
    if any(name.startswith("text/") for name in flat):
        return qwen3_5.Qwen3_5(cfg, device)
    return qwen3_5.TextModel(cfg, device)


def from_jax_flat(flat, cfg, *, device=None):
    """Build a model from a flattened JAX param tree.

    flat: {"/"-joined path: numpy array}, i.e. ``flatten_params`` of the
    JAX params converted with ``np.asarray``. An image config with no
    vocabulary (``img_width``, no ``vocab_size``) gives a ``vit.ViT`` (its
    patch conv weight keeps its conv layout). A config with ``num_ffn``
    gives a ``deepseek_v3.DeepSeekV3`` and one with ``hybrid_ratio`` a
    ``mimo_v2_flash.MiMoV2Flash`` (each with its "mtp/<k>/…" modules, and
    the "blocks/<i>/moe/biases" leaves loaded into the MoE buffers). A
    config with ``window_size``
    and ``local_global_att_ratio`` gives a ``gemma3.Gemma3``; a hybrid
    config with MoE keys
    (``num_experts``), or a hybrid tree with "moe/" parameters, gives a
    ``qwen3_next.Qwen3Next``; another hybrid (Qwen3.5) config gives a
    ``qwen3_5.Qwen3_5`` for a tree with "vision/" and "text/" prefixes
    (``init``) and a ``qwen3_5.TextModel`` for a bare text tree
    (``init_text``); a Qwen3 config (no ``linear_sdpa_ratio``) gives a
    ``qwen3.Qwen3``, dense or, with ``model_type="moe"``, MoE (its
    "blocks/<i>/moe/experts/{lin1,gate,lin2}" stacks, int8 ones included,
    and "blocks/<i>/moe/gate_w" router). ``device`` defaults to the current CUDA device
    (``config.resolve_device``). Raises on a missing, unexpected or
    mis-shaped leaf.
    """
    model = _model_for(flat, cfg, resolve_device(device))
    names = {name.replace("/", "."): arr for name, arr in flat.items()}
    transposed = quantized_like(model, names)
    state = model.state_dict()
    missing, unexpected = sorted(set(state) - set(names)), sorted(set(names) - set(state))
    if missing or unexpected:
        raise ValueError(f"parameter names differ: missing {missing[:5]}, unexpected {unexpected[:5]}")
    linear_weights = {f"{name}.w" for name, m in model.named_modules() if isinstance(m, Linear)} | transposed
    for name, arr in names.items():
        arr = np.array(arr)  # a writable copy
        if arr.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes) has no torch view
            arr = arr.astype(np.float32)
        t = torch.from_numpy(arr)
        if name in linear_weights:
            t = t.T
        if t.shape != state[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(state[name].shape)}")
        state[name].copy_(t)
    return model
