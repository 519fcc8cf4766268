"""Load a JAX parameter tree into the port's modules (counterpart of
``llm_quest_tpu/weights/interop.py``; only the JAX → torch direction).

Layout rule: the JAX package stores linear weights ``(in, out)`` for
``x @ w``; the port stores them as torch does, ``(out, in)``, for
``F.linear``. So every ``Linear`` weight is transposed on the way in, and no
other leaf is: embedding tables are ``(num, dim)``, the patch conv weight
keeps its conv layout and the depthwise conv1d weight its ``(channels,
kernel)`` layout in both packages. The GDN recurrent state is ``(dv, dk)`` in
both, so cache states compare directly.

A tree quantized by the JAX ``quantize_params_int8`` loads too, int8 or
int4: the model takes the quantized structure first
(``ops/quantization.py::quantized_like``). A linear's ``w_q`` is transposed
like ``w``; its ``w_scale`` ((out,) or (nb, out)), a quantized embedding
table and its per-row scales, and the expert stacks' ``<name>_q`` (E, in,
out) and ``<name>_scale`` (E, out), gated or not, with their biases, have
one layout in both packages. A JAX int4 leaf (``np.asarray`` gives
ml_dtypes ``int4``, told by its dtype's name, so ml_dtypes is never
imported) is read as int8 and packed two a byte along dim 1 of the port's
layout, the contraction axis (``ops/int4.py::pack_int4``).

A position table that the JAX quantizer took for a linear (GPT-2's
``pos_emb``: any 2-D table but ``tok_emb``) is dequantized on the way in,
since the port keeps such tables in their type (``_dequantized_tables``).

A tree with LoRA adapters (``lora`` sub-dicts of linears, from JAX's
``ops/lora.py``: classic, XS or Tiny, single or stacked with a leading
adapter axis, over fp32, bf16 or int8 linears) loads too: the model takes
the adapters first (``ops/lora.py::lora_like``). Their A (in, r) and B (r,
out) keep JAX's layout in the port, so no adapter leaf is transposed.

A standalone MoE layer's tree loads too: {"experts", "gate_w", "gate_b"}
gives an ``ops/moe.py::ClassicMoE`` and {"routed", "shared", "gate_w",
"down_proj", "up_proj", "biases"} a ``LatentMoE`` (its ``biases`` into the
buffer), their widths and dtype read from the arrays.

A JAX VLM crosses over as its three trees: the ViT and GPT-2 as above, the
adapter tree ({"proj"} or {"fc", "proj"}, ``multimodal/vlm.py``) as a
``ViTAdapter`` whose widths, type, bias and dtype are read from the arrays.

HF checkpoints (the second half of JAX's file): ``convert_weights`` with
JAX's ordered substring rules, ``report_loading_status``, and the GPT-2,
Qwen3 (dense and MoE) and Qwen3.5 VLM loaders. ``flatten_params(model)``
lists a model's leaves under JAX's "/"-joined names in JAX's layout (a
``Linear`` weight as its transposed view), so the rules, their transposes
(HF's torch ``(out, in)`` → JAX's ``(in, out)``) and the shape checks are
JAX's own; ``unflatten_into(model, converted)`` then writes each converted
leaf through ``from_jax_flat``'s per-leaf rule (a ``Linear`` weight
transposed back) into the model in place, leaving every leaf it does not
find as it was. HF GPT-2's ``Conv1D`` weights are stored ``(in, out)``,
JAX's layout, so its rules do not transpose and the port's ``Linear`` gets
them transposed; the MoE router ``gate_w`` (d, E) and the expert stacks (E,
in, out) are raw matrices in JAX's layout in both packages. The state dict
may hold torch tensors of any dtype (bf16 included: they are never passed
through numpy) or numpy arrays. Divergences by design: the loaders update
the model in place (JAX returns a new tree) and return it, and the missing
list follows the model's leaf order (the modules' registration order; JAX's
follows its tree's key order).
"""

import re

import numpy as np
import torch

from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.models import (
    deepseek_v3, gemma3, gpt2, hyper_qwen3, llama3, mimo_v2_flash, qwen3, qwen3_5, qwen3_next, vit,
)
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.ops.lora import lora_like
from llm_quest_tpu_torch.ops.int4 import is_int4, pack_int4
from llm_quest_tpu_torch.ops.quantization import QuantLinear, quantized_like


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


def _adapter_for(flat, device):
    """The ``ViTAdapter`` of a JAX adapter tree: {"proj"} or {"fc", "proj"}, (in, out) weights."""
    from llm_quest_tpu_torch.multimodal.vlm import ViTAdapter

    first = flat["fc/w"] if "fc/w" in flat else flat["proj/w"]
    vit_d, llm_d = np.shape(first)[0], np.shape(flat["proj/w"])[1]
    dtype = _dtype_of(first)
    if "fc/w" not in flat:
        return ViTAdapter(vit_d, llm_d, adapter_type="simple", bias="proj/b" in flat, dtype=dtype, device=device)
    return ViTAdapter(vit_d, llm_d, adapter_type="ffn", hidden_size_factor=np.shape(first)[1] // vit_d,
                      bias="fc/b" in flat, dtype=dtype, device=device)


def _dtype_of(arr):
    """The torch dtype of a JAX leaf (numpy's bf16 is ml_dtypes', told by name)."""
    return torch.bfloat16 if np.asarray(arr).dtype.name == "bfloat16" else _as_tensor(arr).dtype


def _stack_dims(flat, prefix):
    """(E, in, out) of a stack's lin1, quantized or not (a JAX int4 array has its logical shape)."""
    return np.shape(flat[prefix + "lin1"] if prefix + "lin1" in flat else flat[prefix + "lin1_q"])


def _moe_layer_for(flat, device):
    """A standalone classic or latent MoE layer of a JAX tree, or None."""
    from llm_quest_tpu_torch.ops.moe import ClassicMoE, LatentMoE

    top, dtype = {name.split("/")[0] for name in flat}, None
    if "gate_w" in flat:
        dtype = _dtype_of(flat["gate_w"])
    if top == {"experts", "gate_w", "gate_b"}:
        e, d, hidden = _stack_dims(flat, "experts/")
        return ClassicMoE(d, e, hidden, dtype, device)
    if top == {"routed", "shared", "gate_w", "down_proj", "up_proj", "biases"}:
        e, latent, hidden = _stack_dims(flat, "routed/")
        _, d, shared_hidden = _stack_dims(flat, "shared/")
        return LatentMoE(d, e, latent, hidden, shared_hidden, dtype, device)
    return None


def _model_for(flat, cfg, device):
    if {name.split("/")[0] for name in flat} <= {"fc", "proj"}:  # a ViT→LLM adapter (multimodal/vlm.py)
        return _adapter_for(flat, device)
    moe_layer = _moe_layer_for(flat, device)
    if moe_layer is not None:
        return moe_layer
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
    JAX params converted with ``np.asarray``. An adapter tree ({"proj"} or
    {"fc", "proj"}, JAX's ``multimodal/vlm.py::init_adapter``) gives a
    ``multimodal.vlm.ViTAdapter`` (``cfg`` unread); a standalone MoE layer's
    tree (JAX's ``init_classic_moe`` / ``init_latent_moe``) an
    ``ops/moe.py::ClassicMoE`` / ``LatentMoE`` (``cfg`` unread). A tree of a GPT-2 "body" and
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
    "blocks/<i>/moe/experts/{lin1,gate,lin2}" stacks, int8 and int4 ones
    included, and "blocks/<i>/moe/gate_w" router). Any tree may hold JAX
    int4 leaves (packed on the way in). ``device`` defaults to the current CUDA device
    (``config.resolve_device``). Raises on a missing, unexpected or
    mis-shaped leaf.
    """
    model = _model_for(flat, cfg, resolve_device(device))
    names = _dequantized_tables(model, {name.replace("/", "."): arr for name, arr in flat.items()})
    quantized_like(model, names)
    lora_like(model, names)
    state = model.state_dict()
    missing, unexpected = sorted(set(state) - set(names)), sorted(set(names) - set(state))
    if missing or unexpected:
        raise ValueError(f"parameter names differ: missing {missing[:5]}, unexpected {unexpected[:5]}")
    linear_weights = _linear_weights(model)
    for name, arr in names.items():
        _write_leaf(state, name, _as_tensor(arr), name in linear_weights)
    return model


def _linear_weights(model):
    """State-dict names of the port's ``(out, in)`` linear weights: a
    ``Linear``'s ``w`` and a quantized ``QuantLinear``'s ``w_q``."""
    return ({f"{name}.w" for name, m in model.named_modules() if isinstance(m, Linear)}
            | {f"{name}.w_q" for name, m in model.named_modules() if isinstance(m, QuantLinear)})


def _as_tensor(arr):
    """A torch tensor as given (any dtype, any device), or a numpy array as a torch tensor."""
    if torch.is_tensor(arr):
        return arr
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes) has no torch view
        arr = arr.astype(np.float32)
    elif arr.dtype.name == "int4":  # ml_dtypes' int4 (one value a byte in numpy): packed by ``_write_leaf``
        arr = arr.astype(np.int8)
    return torch.from_numpy(arr)


@torch.no_grad()
def _write_leaf(state, name, t, transpose):
    """``from_jax_flat``'s per-leaf rule: a JAX-layout leaf into the port's
    state tensor ``name`` (a linear weight transposed), cast to its dtype;
    int4 values into a packed (``uint8``) leaf are packed along dim 1."""
    if transpose:
        t = t.T
    if is_int4(state[name]) and not is_int4(t):
        t = pack_int4(t)
    if t.shape != state[name].shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(state[name].shape)}")
    state[name].copy_(t)


# ------------------------------------------------------------ HF checkpoints


def flatten_params(model):
    """{"/"-joined JAX path: tensor} of a port model's leaves in JAX's
    layout (a linear weight as its transposed view; views, not copies)."""
    linear_weights = _linear_weights(model)
    return {name.replace(".", "/"): (t.T if name in linear_weights else t) for name, t in model.state_dict().items()}


def unflatten_into(model, flat_updates):
    """Write ``flat_updates`` ({"/"-joined JAX path: JAX-layout tensor or
    array}) into ``model`` in place, through ``from_jax_flat``'s per-leaf
    rule; leaves not named keep their values. Returns the model."""
    state = model.state_dict()
    linear_weights = _linear_weights(model)
    for path, arr in flat_updates.items():
        name = path.replace("/", ".")
        _write_leaf(state, name, _as_tensor(arr), name in linear_weights)
    return model


def convert_weights(src_state_dict, target_flat, remapping_rules, *, ignored_prefixes=(), log=print):
    """JAX's ordered substring-rule remapping. remapping_rules: (pattern,
    replacement[, transform]) with transform True (transpose a 2-D weight)
    or a callable; a rule whose pattern is the whole source name ends the
    walk. target_flat: {JAX path: anything with a ``shape``} in JAX's
    layout. Returns {JAX path: JAX-layout tensor} of the matched weights; a
    shape mismatch or a name that matches nothing is logged and skipped."""
    converted, skipped = {}, []
    for src_name, weight in src_state_dict.items():
        if ignored_prefixes and any(src_name.startswith(p) for p in ignored_prefixes):
            skipped.append(src_name)
            continue

        our_name = src_name
        transform = None
        for rule in remapping_rules:
            pattern, replacement = rule[0], rule[1]
            if pattern in our_name:
                our_name = our_name.replace(pattern, replacement)
                if len(rule) > 2 and rule[2]:
                    transform = rule[2]
                if pattern == src_name:
                    break

        w = _as_tensor(weight)
        if transform is True and w.dim() == 2:
            w = w.T
        elif callable(transform):
            w = transform(w)
        if our_name in target_flat:
            if tuple(w.shape) == tuple(target_flat[our_name].shape):
                converted[our_name] = w
            else:
                log(f"WARNING: Shape mismatch: {our_name}: src {tuple(w.shape)} vs ours "
                    f"{tuple(target_flat[our_name].shape)}")
        else:
            log(f"WARNING: No match for weight '{src_name}' → tried '{our_name}'")

    if skipped:
        log(f"Skipped {len(skipped)} weights")
    return converted


def report_loading_status(target_flat, converted, *, log=print):
    """Log the loaded/missing report. Returns the missing paths, in the target's order."""
    missing = [k for k in target_flat if k not in converted]
    log(f"Loaded {len(converted)}/{len(target_flat)} weights successfully")
    if missing:
        log(f"Missing keys ({len(missing)}): {missing[:20]}{'...' if len(missing) > 20 else ''}")
    return missing


# OpenAI GPT-2 from HF ("gpt2"): Conv1D weights stored (in, out), JAX's layout
GPT2_HF_RULES = [
    ("wte.weight", "tok_emb/w"),
    ("wpe.weight", "pos_emb/w"),
    ("ln_f.weight", "final_ln/scale"),
    ("ln_f.bias", "final_ln/shift"),
    ("h.", "blocks/"),
    (".attn.c_proj.weight", "/att/out_proj/w"),
    (".attn.c_proj.bias", "/att/out_proj/b"),
    (".mlp.c_fc.weight", "/ffn/fc/w"),
    (".mlp.c_fc.bias", "/ffn/fc/b"),
    (".mlp.c_proj.weight", "/ffn/proj/w"),
    (".mlp.c_proj.bias", "/ffn/proj/b"),
    (".ln_1.weight", "/ln_1/scale"),
    (".ln_1.bias", "/ln_1/shift"),
    (".ln_2.weight", "/ln_2/scale"),
    (".ln_2.bias", "/ln_2/shift"),
]


def load_hf_gpt2(model, state_dict, *, log=print):
    """Load an HF GPT-2 state dict into a ``gpt2.GPT2`` in place: the fused
    ``c_attn`` (in, 3d) split into wq/wk/wv, and ``wte`` copied into the
    untied ``out`` head. Returns the model."""
    target = flatten_params(model)
    converted = convert_weights(state_dict, target, GPT2_HF_RULES, ignored_prefixes=("h_bias",),
                                log=lambda *_: None)
    for name, w in state_dict.items():
        m = re.match(r"h\.(\d+)\.attn\.c_attn\.(weight|bias)", name)
        if not m:
            continue
        i, kind = m.group(1), m.group(2)
        for part, proj in zip(_as_tensor(w).chunk(3, dim=-1), ("wq", "wk", "wv")):
            converted[f"blocks/{i}/att/{proj}/{'w' if kind == 'weight' else 'b'}"] = part
    if "out/w" in target and "wte.weight" in state_dict:
        converted["out/w"] = _as_tensor(state_dict["wte.weight"]).T  # (d, v)
    report_loading_status(target, converted, log=log)
    return unflatten_into(model, converted)


def qwen3_rules(cfg):
    """HF Qwen3 → JAX paths; torch Linear (out, in) → transpose."""
    t = True
    rules = [
        ("model.embed_tokens.weight", "tok_emb/w"),
        ("model.norm.weight", "final_norm/scale"),
        ("model.layers.", "blocks/"),
        (".self_attn.q_proj.weight", "/att/wq/w", t),
        (".self_attn.k_proj.weight", "/att/wk/w", t),
        (".self_attn.v_proj.weight", "/att/wv/w", t),
        (".self_attn.o_proj.weight", "/att/out_proj/w", t),
        (".self_attn.q_norm.weight", "/att/q_norm/scale"),
        (".self_attn.k_norm.weight", "/att/k_norm/scale"),
        (".input_layernorm.weight", "/pre_att_norm/scale"),
        (".post_attention_layernorm.weight", "/pre_ffn_norm/scale"),
    ]
    if not cfg["tie_embeddings"]:
        rules.append(("lm_head.weight", "out/w", t))
    if cfg.get("model_type", "dense") == "moe":
        rules += [(".mlp.gate.weight", "/moe/gate_w", t)]
    else:
        rules += [
            (".mlp.gate_proj.weight", "/ffn/gate/w", t),
            (".mlp.up_proj.weight", "/ffn/up/w", t),
            (".mlp.down_proj.weight", "/ffn/down/w", t),
        ]
    return rules


def gather_stacked_experts(state_dict, layer_pattern, our_path_fmt, n_experts, *, mapping=None):
    """Per-expert HF (out, in) tensors → stacked (n_experts, in, out)
    tensors. layer_pattern: a regex with groups (layer, expert, proj);
    our_path_fmt e.g. "blocks/{layer}/moe/experts/{proj}" with ``mapping``
    {"gate_proj": "gate", ...}. Returns {JAX path: stacked tensor}."""
    mapping = mapping or {"gate_proj": "gate", "up_proj": "lin1", "down_proj": "lin2"}
    buckets = {}
    for name, w in state_dict.items():
        m = re.match(layer_pattern, name)
        if not m:
            continue
        layer, expert, proj = m.group(1), int(m.group(2)), m.group(3)
        key = our_path_fmt.format(layer=layer, proj=mapping[proj])
        buckets.setdefault(key, {})[expert] = _as_tensor(w).T  # (in, out)
    return {key: torch.stack([experts[i] for i in range(n_experts)]) for key, experts in buckets.items()}


def load_hf_qwen3(model, cfg, state_dict, *, log=print):
    """Load an HF Qwen3 (dense or MoE) state dict into a ``qwen3.Qwen3`` in place. Returns the model."""
    target = flatten_params(model)
    converted = convert_weights(state_dict, target, qwen3_rules(cfg), log=lambda *_: None)
    if cfg.get("model_type", "dense") == "moe":
        converted.update(gather_stacked_experts(
            state_dict,
            r"model\.layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate_proj|up_proj|down_proj)\.weight",
            "blocks/{layer}/moe/experts/{proj}",
            cfg["num_experts"],
            mapping={"gate_proj": "gate", "up_proj": "lin1", "down_proj": "lin2"},
        ))
    report_loading_status(target, converted, log=log)
    return unflatten_into(model, converted)


def _squeeze1(w):
    return w[:, 0, :]  # torch depthwise Conv1d (c, 1, k) → (c, k)


def qwen3_5_text_rules():
    """HF Qwen3.5 text → JAX paths."""
    t = True
    return [
        ("model.language_model.embed_tokens.weight", "tok_emb/w"),
        ("model.language_model.norm.weight", "final_norm/scale"),
        ("model.language_model.layers.", "blocks/"),
        (".input_layernorm.weight", "/norm1/scale"),
        (".post_attention_layernorm.weight", "/norm2/scale"),
        # full attention (HF q_proj is fused [query ‖ gate])
        (".self_attn.q_proj.weight", "/att/wqg/w", t),
        (".self_attn.k_proj.weight", "/att/wk/w", t),
        (".self_attn.v_proj.weight", "/att/wv/w", t),
        (".self_attn.o_proj.weight", "/att/out_proj/w", t),
        (".self_attn.q_norm.weight", "/att/q_norm/scale"),
        (".self_attn.k_norm.weight", "/att/k_norm/scale"),
        # the gated DeltaNet
        (".linear_attn.A_log", "/att/log_A"),
        (".linear_attn.dt_bias", "/att/dt_bias"),
        (".linear_attn.in_proj_qkv.weight", "/att/w_qkv/w", t),
        (".linear_attn.in_proj_z.weight", "/att/w_gate/w", t),
        (".linear_attn.in_proj_b.weight", "/att/w_beta/w", t),
        (".linear_attn.in_proj_a.weight", "/att/w_alpha/w", t),
        (".linear_attn.conv1d.weight", "/att/conv1d/w", _squeeze1),
        (".linear_attn.norm.weight", "/att/post_norm/scale"),
        (".linear_attn.out_proj.weight", "/att/out_proj/w", t),
        # dense MLP
        (".mlp.gate_proj.weight", "/ffn/gate/w", t),
        (".mlp.up_proj.weight", "/ffn/up/w", t),
        (".mlp.down_proj.weight", "/ffn/down/w", t),
    ]


def qwen3_5_vision_rules():
    """HF Qwen3.5 vision → JAX paths."""
    t = True
    return [
        ("model.visual.patch_embed.proj.weight", "patch_embed/conv_w"),
        ("model.visual.patch_embed.proj.bias", "patch_embed/conv_b"),
        ("model.visual.pos_embed.weight", "pos_embed/w"),
        ("model.visual.blocks.", "blocks/"),
        (".attn.qkv.weight", "/qkv/w", t),
        (".attn.qkv.bias", "/qkv/b"),
        (".attn.proj.weight", "/proj/w", t),
        (".attn.proj.bias", "/proj/b"),
        (".mlp.linear_fc1.weight", "/fc1/w", t),
        (".mlp.linear_fc1.bias", "/fc1/b"),
        (".mlp.linear_fc2.weight", "/fc2/w", t),
        (".mlp.linear_fc2.bias", "/fc2/b"),
        (".norm1.weight", "/norm1/scale"),
        (".norm1.bias", "/norm1/shift"),
        (".norm2.weight", "/norm2/scale"),
        (".norm2.bias", "/norm2/shift"),
        ("model.visual.merger.norm.weight", "merge/norm/scale"),
        ("model.visual.merger.norm.bias", "merge/norm/shift"),
        ("model.visual.merger.linear_fc1.weight", "merge/lin1/w", t),
        ("model.visual.merger.linear_fc1.bias", "merge/lin1/b"),
        ("model.visual.merger.linear_fc2.weight", "merge/lin2/w", t),
        ("model.visual.merger.linear_fc2.bias", "merge/lin2/b"),
    ]


def load_hf_qwen3_5_vlm(model, cfg, state_dict, *, log=print):
    """Load HF Qwen3.5 text and vision weights into a ``qwen3_5.Qwen3_5``
    ({"vision", "text"}) in place. Returns the model."""
    text_target = flatten_params(model.text)
    text_conv = convert_weights(state_dict, text_target, qwen3_5_text_rules(),
                                ignored_prefixes=("model.visual.", "mtp."), log=lambda *_: None)
    vision_target = flatten_params(model.vision)
    vision_conv = convert_weights(state_dict, vision_target, qwen3_5_vision_rules(),
                                  ignored_prefixes=("model.language_model.", "lm_head.", "mtp."), log=lambda *_: None)
    report_loading_status({**{f"text/{k}": v for k, v in text_target.items()},
                           **{f"vision/{k}": v for k, v in vision_target.items()}},
                          {**{f"text/{k}": v for k, v in text_conv.items()},
                           **{f"vision/{k}": v for k, v in vision_conv.items()}}, log=log)
    unflatten_into(model.text, text_conv)
    unflatten_into(model.vision, vision_conv)
    return model
