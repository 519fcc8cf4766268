"""Weight-only int8 quantization for serving (counterpart of
``llm_quest_tpu/ops/quantization.py``).

Small-batch decode streams every weight once per token, so bytes per weight
set its rate. Symmetric int8 with fp32 scales halves the bytes of a bf16
weight:

- linears: per-output-channel scales over the contraction dim, ``y = (x @
  w_q) · scale`` (an exact epilogue), or ``block_size`` sub-channel scales
  (nb, out);
- embedding tables: per-ROW scales, which serve both the gather (only the
  rows looked up are dequantized) and a tied head (``(h @ w_qᵀ) · scale``);
- MoE expert stacks (E, in, out): per-(expert, output-channel) scales (E,
  out), applied per row after the grouped matmul (K11, kernels/quantized_gmm.py);
- the KV cache: per-(position, head) row scales at write time
  (``quantize_rows_int8``), streamed int8 by K10 (kernels/flash_decode.py).

Layout: the port's ``Linear`` is (out, in), so its ``w_q`` is (out, in) and
``from_jax_flat`` transposes JAX's (in, out) ``w_q`` like ``w``; the scales
((out,) or (nb, out)), embedding tables and expert stacks have one layout in
both packages. State-dict keys are the JAX leaf names (``w_q``, ``w_scale``,
``lin1_q``, ``lin1_scale``, ...).

``quantize_params_int8`` converts a model IN PLACE (torch modules are
mutable; the model is not copied): each selected ``Linear`` becomes a
``QuantLinear``, a selected ``tok_emb`` table a ``{w_q, w_scale}`` group and
each selected ``ExpertStack`` its ``{<name>_q, <name>_scale}`` group, under
JAX's selection rule. Rounding is ``torch.round`` (half to even, as
``jnp.round``). ``bits=4`` raises: torch has no packed int4 type, and packing
needs a kernel of its own (ROADMAP).
"""

import re
from typing import NamedTuple

import torch
from torch import nn

from llm_quest_tpu_torch.ops.linear import Linear, linear, params

_INT4 = "int4 weights are not ported: torch has no packed int4 dtype and the packing needs its own kernel (ROADMAP)"


class QuantKV(NamedTuple):
    """An int8 attention operand: ``data`` (…, d) int8 with per-row
    symmetric ``scale`` (…) fp32, as the int8 KV cache returns it
    (inference/cache.py). The attention router streams it through K10 or
    dequantizes it."""

    data: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self):
        return self.data.shape

    def dequant(self, dtype):
        return self.data.to(dtype) * self.scale[..., None].to(dtype)


def _qmax(bits):
    if bits == 4:
        raise NotImplementedError(_INT4)
    if bits != 8:
        raise ValueError(f"bits must be 8 (or 4, not ported), got {bits}")
    return 127.0


def _round_int8(w32, scale, qmax):
    return torch.round(w32 / scale).clamp(-qmax, qmax).to(torch.int8)


def quantize_rows_int8(x):
    """Symmetric per-row (last-dim absmax) int8 quantization, the KV-cache
    write. Returns (int8 data, fp32 scales shaped x.shape[:-1])."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    return _round_int8(x32, scale[..., None], 127.0), scale


def quantize_linear_int8(p, *, block_size=None, bits=8):
    """{"w": (out, in)[, "b"]} → {"w_q": (out, in) int8, "w_scale": fp32
    (out,), or (in // block_size, out) with ``block_size``[, "b"]}."""
    qmax = _qmax(bits)
    w = p["w"].detach().float()
    d_out, d_in = w.shape
    if block_size is not None:
        if d_in % block_size:
            raise ValueError(f"in dim {d_in} is not a multiple of block_size {block_size}")
        wb = w.reshape(d_out, d_in // block_size, block_size)
        scale = (wb.abs().amax(dim=2) / qmax).clamp_min(1e-12)  # (out, nb)
        w_q = _round_int8(wb, scale[..., None], qmax).reshape(d_out, d_in)
        scale = scale.T.contiguous()  # (nb, out), JAX's layout
    else:
        scale = (w.abs().amax(dim=1) / qmax).clamp_min(1e-12)  # (out,)
        w_q = _round_int8(w, scale[:, None], qmax)
    return {"w_q": w_q, "w_scale": scale, **{k: v for k, v in p.items() if k != "w"}}


def dequantize_int8(w_q, scale):
    """int8 (out, in) with (out,) or (nb, out) scales → fp32 (out, in)."""
    if scale.ndim == 1:
        return w_q.float() * scale[:, None]
    nb, d_out = scale.shape
    return (w_q.float().reshape(d_out, nb, -1) * scale.T[..., None]).reshape(w_q.shape)


def int8_matmul(x, w_q, scale):
    """x @ dequant(w_q)ᵀ with the dequantization around the product, in x's
    dtype: ``(x @ w_qᵀ) · scale`` per channel; per block, fp32 block partials
    reduced against the (nb, out) scales. The int8 → x.dtype conversion
    writes a copy of the weight (a fused weight-only GEMV is ROADMAP work)."""
    if scale.ndim == 1:
        return linear(x, w_q.to(x.dtype)) * scale.to(x.dtype)
    nb, d_out = scale.shape
    xb = x.float().reshape(*x.shape[:-1], nb, -1)
    part = torch.einsum("...nb,onb->...no", xb, w_q.float().reshape(d_out, nb, -1))
    return (part * scale).sum(dim=-2).to(x.dtype)


def quantize_embedding_int8(p, *, bits=8):
    """{"w": (vocab, emb)} → {"w_q": int8 (vocab, emb), "w_scale": fp32
    (vocab,)}: per-row scales, exact through the gather and the tied head."""
    qmax = _qmax(bits)
    w = p["w"].detach().float()
    scale = (w.abs().amax(dim=1) / qmax).clamp_min(1e-12)
    return {"w_q": _round_int8(w, scale[:, None], qmax), "w_scale": scale,
            **{k: v for k, v in p.items() if k != "w"}}


_EXPERT_MATS = ("lin1", "gate", "lin2")


def quantize_expert_stack_int8(experts, *, bits=8):
    """Stacked expert weights (E, in, out) → ``<name>_q`` int8 and
    ``<name>_scale`` fp32 (E, out); other entries pass through."""
    qmax = _qmax(bits)
    out = {}
    for k, w in experts.items():
        if k in _EXPERT_MATS and w.ndim == 3:
            w32 = w.detach().float()
            scale = (w32.abs().amax(dim=1) / qmax).clamp_min(1e-12)
            out[k + "_q"] = _round_int8(w32, scale[:, None, :], qmax)
            out[k + "_scale"] = scale
        else:
            out[k] = w
    return out


class QuantLinear(nn.Module):
    """A weight-only int8 linear: {"w_q": (out, in) int8, "w_scale": (out,)
    or (nb, out) fp32[, "b"]}, frozen."""

    def __init__(self, w_q, w_scale, b=None):
        super().__init__()
        self.w_q = nn.Parameter(w_q, requires_grad=False)
        self.w_scale = nn.Parameter(w_scale, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b.detach(), requires_grad=False)

    def forward(self, x):
        y = int8_matmul(x, self.w_q, self.w_scale)
        return y if self.b is None else y + self.b

    @classmethod
    def empty_like(cls, d_out, d_in, scale_shape, *, bias_dtype=None, device=None):
        """An uninitialised layer of the given shapes (filled by a state-dict load)."""
        b = None if bias_dtype is None else torch.empty(d_out, dtype=bias_dtype, device=device)
        return cls(torch.empty(d_out, d_in, dtype=torch.int8, device=device),
                   torch.empty(scale_shape, dtype=torch.float32, device=device), b)


def _set_module(model, name, module):
    parent, _, child = name.rpartition(".")
    model.get_submodule(parent).add_module(child, module)


def _is_expert_stack(module):
    return isinstance(module, nn.ParameterDict) and "lin1" in module and module["lin1"].ndim == 3


@torch.no_grad()
def quantize_params_int8(model, *, exclude=r"tok_emb|conv", block_size=None, min_size=4096,
                         quantize_experts=True, quantize_embeddings=False, bits=8):
    """Quantize ``model`` in place and return it, with JAX's selection rule
    over the parameter paths ("/blocks/0/att/wq", as the JAX walk spells
    them): every ``Linear`` with at least ``min_size`` weights whose path the
    ``exclude`` regex does not match; every expert stack (3-D lin1/gate/lin2)
    with ``quantize_experts`` unless excluded; the ``tok_emb`` table with
    ``quantize_embeddings`` (per-row scales, at least ``min_size`` entries).

    Divergence by design: the JAX walk also treats any other dict with a
    2-D "w" leaf as a linear — the vision tower's position table
    (``vision/pos_embed``) gets per-column scales there, which its own
    ``embedding`` then reads as per-row scales. Here only ``Linear`` modules
    are linears; such tables stay in their dtype.

    The walk holds module names, not modules, and looks each up as it goes:
    a replaced module has no reference left once its quantized form is in
    place, so a model at full width needs its own bytes plus one module's
    conversion at the peak, not the fp and the int8 models side by side."""
    _qmax(bits)
    pat = re.compile(exclude) if exclude else None
    for name in [name for name, _ in model.named_modules()]:
        module = model.get_submodule(name)
        path = "/" + name.replace(".", "/")
        excluded = pat is not None and pat.search(path) is not None
        if (quantize_embeddings and path.endswith("tok_emb") and isinstance(module, nn.ParameterDict)
                and "w" in module and module["w"].ndim == 2 and module["w"].numel() >= min_size):
            _set_module(model, name, params(**quantize_embedding_int8(dict(module), bits=bits)))
        elif isinstance(module, Linear) and module.w.numel() >= min_size and not excluded:
            p = {"w": module.w} if module.b is None else {"w": module.w, "b": module.b}
            q = quantize_linear_int8(p, block_size=block_size, bits=bits)
            _set_module(model, name, QuantLinear(q["w_q"], q["w_scale"], q.get("b")))
        elif quantize_experts and _is_expert_stack(module) and not excluded:
            _set_module(model, name, params(**quantize_expert_stack_int8(dict(module), bits=bits)))
    return model


def quantized_like(model, names):
    """Give ``model`` the quantized structure of a JAX tree in place: names
    maps each "."-joined leaf name to its array (``from_jax_flat``).
    Returns the state-dict names whose arrays come transposed (linear w_q)."""
    transposed = set()
    for name, module in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(module, Linear) and prefix + "w_q" in names:
            d_out, d_in = module.w.shape
            bias_dtype = None if module.b is None else module.b.dtype
            _set_module(model, name, QuantLinear.empty_like(
                d_out, d_in, tuple(names[prefix + "w_scale"].shape), bias_dtype=bias_dtype, device=module.w.device))
            transposed.add(prefix + "w_q")
        elif isinstance(module, nn.ParameterDict) and "w" in module and prefix + "w_q" in names:
            w = module["w"]
            _set_module(model, name, params(
                w_q=torch.empty(w.shape, dtype=torch.int8, device=w.device),
                w_scale=torch.empty(w.shape[0], dtype=torch.float32, device=w.device)))
        elif _is_expert_stack(module) and prefix + "lin1_q" in names:
            group = {}
            for k, w in module.items():
                group[k + "_q"] = torch.empty(w.shape, dtype=torch.int8, device=w.device)
                group[k + "_scale"] = torch.empty(w.shape[0], w.shape[2], dtype=torch.float32, device=w.device)
            _set_module(model, name, params(**group))
    return transposed


def param_bytes(params):
    """Bytes of a model's parameters as stored (int8 leaves and their fp32
    scales included)."""
    return sum(t.numel() * t.element_size() for t in params.state_dict().values())


def quantized_byte_fraction(params_q, params_fp):
    """Parameter bytes of the quantized model over those of the fp model."""
    return param_bytes(params_q) / param_bytes(params_fp)
