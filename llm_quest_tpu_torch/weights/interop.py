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

A position table that the JAX quantizer took for a linear (GPT-2's
``pos_emb``: any 2-D table but ``tok_emb``) is dequantized on the way in,
since the port keeps such tables in their type (``_dequantized_tables``).

A tree with LoRA adapters (``lora`` sub-dicts of linears, from JAX's
``ops/lora.py``: classic, XS or Tiny, single or stacked with a leading
adapter axis, over fp32, bf16 or int8 linears) loads too: the model takes
the adapters first (``ops/lora.py::lora_like``). Their A (in, r) and B (r,
out) keep JAX's layout in the port, so no adapter leaf is transposed.
"""

import numpy as np
import torch

from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.models import (
    deepseek_v3, gemma3, gpt2, hyper_qwen3, llama3, mimo_v2_flash, qwen3, qwen3_5, qwen3_next, vit,
)
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.ops.lora import lora_like
from llm_quest_tpu_torch.ops.quantization import quantized_like


def _hc_bundle(flat, cfg):
    """(hc_type, expansion rate) of a Hyper-Qwen3 tree, from its first
    attention bundle: mHC-lite holds ``_bvn_flat``; classic HC's norm is
    emb wide and its H_res bias (n, n), mHC's norm n·emb wide."""
    prefix = next(name for name in flat if "/hc_attn/" in name).split("/hc_attn/")[0] + "/hc_attn/"
    norm = np.shape(flat[prefix + "norm/scale"])[0]
    if prefix + "_bvn_flat" in flat:
        return "mhc-lite", norm // cfg["emb_dim"]
    if norm == cfg["emb_dim"]:
        return "hc", np.shape(flat[prefix + "res/bias"])[0]
    return "mhc", norm // cfg["emb_dim"]


def _model_for(flat, cfg, device):
    if "head/w" in flat and any(name.startswith("body/") for name in flat):  # a GPT-2 body, a scalar head
        from llm_quest_tpu_torch.alignment.grpo import RewardModel

        return RewardModel(cfg, device)
    if "img_width" in cfg and "vocab_size" not in cfg:  # an image model with no text side: the ViT
        return vit.ViT(cfg, device)
    if "num_ffn" in cfg:  # dense blocks, then DeepSeek MoE, with MLA and MTP: DeepSeek-V3
        return deepseek_v3.DeepSeekV3(cfg, device)
    if "hybrid_ratio" in cfg:  # the SWA/GA hybrid with MTP: MiMo-V2-Flash
        return mimo_v2_flash.MiMoV2Flash(cfg, device)
    if "window_size" in cfg and "local_global_att_ratio" in cfg:  # local/global attention: Gemma-3
        return gemma3.Gemma3(cfg, device)
    if any(name.startswith("pos_emb/") for name in flat):  # learned positions: GPT-2
        return gpt2.GPT2(cfg, device)
    if any("/hc_attn/" in name for name in flat):  # hyper-connection bundles: Hyper-Qwen3
        hc_type, n = _hc_bundle(flat, cfg)
        return hyper_qwen3.HyperQwen3(cfg, device, hc_type=hc_type, expansion_rate=n)
    if (any(name.endswith("/att/out_proj/b") for name in flat)
            and not any("/att/q_norm/" in name for name in flat)):  # a biased out_proj, no QK-norm: Llama-3
        return llama3.Llama3(cfg, device)
    if "linear_sdpa_ratio" not in cfg:  # no GDN/attention hybrid: Qwen3, dense or MoE (cfg["model_type"])
        return qwen3.Qwen3(cfg, device)
    if "num_experts" in cfg or any("/moe/" in name for name in flat):  # the MoE hybrid
        return qwen3_next.Qwen3Next(cfg, device)
    if any(name.startswith("text/") for name in flat):
        return qwen3_5.Qwen3_5(cfg, device)
    return qwen3_5.TextModel(cfg, device)


def _dequantized_tables(model, names):
    """``names`` with every position table that JAX's ``quantize_params_int8``
    quantized as a linear (any 2-D table but ``tok_emb``: GPT-2's
    ``pos_emb``, the vision tower's) dequantized back into a "w" leaf: the
    port keeps such tables in their type (``ops/quantization.py``). JAX's
    linear rule gave it per-column scales, (out,) or (nb, out) blocks over
    the rows."""
    names = dict(names)
    for name, module in model.named_modules():
        if not (isinstance(module, torch.nn.ParameterDict) and "w" in module and f"{name}.w_q" in names
                and not name.endswith("tok_emb")):
            continue
        w_q = np.asarray(names.pop(f"{name}.w_q"), np.float32)
        scale = np.asarray(names.pop(f"{name}.w_scale"), np.float32)
        if scale.ndim == 1:
            w = w_q * scale[None, :]
        else:  # (nb, out) scales over row blocks
            nb = scale.shape[0]
            w = (w_q.reshape(nb, -1, w_q.shape[1]) * scale[:, None, :]).reshape(w_q.shape)
        names[f"{name}.w"] = w
    return names


def from_jax_flat(flat, cfg, *, device=None):
    """Build a model from a flattened JAX param tree.

    flat: {"/"-joined path: numpy array}, i.e. ``flatten_params`` of the
    JAX params converted with ``np.asarray``. A tree of a GPT-2 "body" and
    a "head" linear (``alignment/grpo.py::init_reward_model``'s) gives an
    ``alignment.grpo.RewardModel``. An image config with no
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
    (``init_text``). Otherwise the tree's names decide: a "pos_emb" table
    gives a ``gpt2.GPT2``; "hc_attn" bundles a ``hyper_qwen3.HyperQwen3``
    (its hc_type and expansion rate read from the bundles); an ``out_proj``
    bias without a q/k norm a ``llama3.Llama3``; and a Qwen3 config (no
    ``linear_sdpa_ratio``) a
    ``qwen3.Qwen3``, dense or, with ``model_type="moe"``, MoE (its
    "blocks/<i>/moe/experts/{lin1,gate,lin2}" stacks, int8 ones included,
    and "blocks/<i>/moe/gate_w" router). ``device`` defaults to the current CUDA device
    (``config.resolve_device``). Raises on a missing, unexpected or
    mis-shaped leaf.
    """
    model = _model_for(flat, cfg, resolve_device(device))
    names = _dequantized_tables(model, {name.replace("/", "."): arr for name, arr in flat.items()})
    transposed = quantized_like(model, names)
    lora_like(model, names)
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
