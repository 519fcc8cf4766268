"""Weight-only int8 and int4 quantization for serving (counterpart of
``llm_quest_tpu/ops/quantization.py``).

Small-batch decode streams every weight once per token, so bytes per weight
set its rate. Symmetric int8 (or int4, ``bits=4``) with fp32 scales cuts the
bytes of a bf16 weight by 2 (or 4):

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

int4 (``bits=4``): values rounded onto [-7, 7] and stored two a byte along
the contraction axis, which is dim 1 of every quantized weight here: a
linear's ``w_q`` (out, in) becomes (out, ⌈in/2⌉), a table (vocab, emb)
(vocab, ⌈emb/2⌉), an expert stack (E, in, out) (E, ⌈in/2⌉, out), all
``uint8`` (``ops/int4.py::pack_int4``): element 2i in the low nibble and 2i + 1 in the
high one, two's complement; an odd width gets a zero pad nibble, which
meets a zero or no column of x. The dtype
tells the two widths apart (int8: ``int8``; int4: ``uint8``, ``is_int4``);
a ``QuantLinear`` records its logical in-width ``d_in`` and an int4 table
group its row ``width``, which ``quantized_like`` rebuilds from the fp
model's shapes; an expert stack's is x's width. torch has no int4
type and no fused int4 convert: an int4 linear or table is unpacked into x's
dtype, then multiplied (plain PyTorch, as JAX leaves it to XLA); an int4
expert stack streams packed through K11.

``quantize_params_int8`` converts a model IN PLACE (torch modules are
mutable; the model is not copied): each selected ``Linear`` becomes a
``QuantLinear``, a selected ``tok_emb`` table a ``{w_q, w_scale}`` group and
each selected ``ExpertStack`` its ``{<name>_q, <name>_scale}`` group, under
JAX's selection rule. Rounding is ``torch.round`` (half to even, as
``jnp.round``).
"""

import re
from typing import NamedTuple

import torch
from torch import nn

from llm_quest_tpu_torch.ops.int4 import integer_weight, is_int4, pack_int4
from llm_quest_tpu_torch.ops.linear import Linear, linear, params
from llm_quest_tpu_torch.ops.lora import lora_delta


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
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    return 127.0 if bits == 8 else 7.0


def _round_int8(w32, scale, qmax):
    return torch.round(w32 / scale).clamp(-qmax, qmax).to(torch.int8)


def _store(w_q, bits):
    """int8 values as stored at ``bits``: int8 as they are, int4 packed along dim 1."""
    return pack_int4(w_q) if bits == 4 else w_q


def quantize_rows_int8(x):
    """Symmetric per-row (last-dim absmax) int8 quantization, the KV-cache
    write. Returns (int8 data, fp32 scales shaped x.shape[:-1])."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    return _round_int8(x32, scale[..., None], 127.0), scale


def quantize_linear_int8(p, *, block_size=None, bits=8):
    """{"w": (out, in)[, "b"]} → {"w_q": (out, in) int8, or (out, ⌈in/2⌉)
    packed int4 at ``bits=4``, "w_scale": fp32 (out,), or (in // block_size,
    out) with ``block_size``[, "b"]}."""
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
    return {"w_q": _store(w_q, bits), "w_scale": scale, **{k: v for k, v in p.items() if k != "w"}}


def dequantize_int8(w_q, scale, width=None):
    """int8 (out, in), or packed int4 (out, ⌈in/2⌉) of logical width
    ``width`` (default 2·⌈in/2⌉), with (out,) or (nb, out) scales → fp32
    (out, in)."""
    width = width or (2 * w_q.shape[1] if is_int4(w_q) else w_q.shape[1])
    w = integer_weight(w_q, width, torch.float32)
    if scale.ndim == 1:
        return w * scale[:, None]
    nb, d_out = scale.shape
    return (w.reshape(d_out, nb, -1) * scale.T[..., None]).reshape(w.shape)


def int8_matmul(x, w_q, scale):
    """x @ dequant(w_q)ᵀ, in x's dtype; ``w_q`` int8 (out, in) or packed
    int4 (out, ⌈in/2⌉), whose width is x's last. Per channel ``(x @ wᵀ) ·
    scale``; per block the (nb, out) scales multiply a copy of the weight
    in x's dtype in place before one product, so the transient memory is
    that one copy. The integer → x.dtype conversion writes that copy (a
    fused weight-only GEMV is ROADMAP work, perf note g)."""
    w = integer_weight(w_q, x.shape[-1], x.dtype)
    if scale.ndim == 1:
        return linear(x, w) * scale.to(x.dtype)
    nb, d_out = scale.shape
    w.unflatten(1, (nb, -1)).mul_(scale.T[..., None].to(x.dtype))
    return linear(x, w)


def quantize_embedding_int8(p, *, bits=8):
    """{"w": (vocab, emb)} → {"w_q": int8 (vocab, emb), or packed int4
    (vocab, ⌈emb/2⌉) at ``bits=4``, "w_scale": fp32 (vocab,)}: per-row
    scales, exact through the gather and the tied head."""
    qmax = _qmax(bits)
    w = p["w"].detach().float()
    scale = (w.abs().amax(dim=1) / qmax).clamp_min(1e-12)
    return {"w_q": _store(_round_int8(w, scale[:, None], qmax), bits), "w_scale": scale,
            **{k: v for k, v in p.items() if k != "w"}}


_EXPERT_MATS = ("lin1", "gate", "lin2")


def quantize_expert_stack_int8(experts, *, bits=8):
    """Stacked expert weights (E, in, out) → ``<name>_q`` int8, or packed
    int4 (E, ⌈in/2⌉, out) at ``bits=4``, and ``<name>_scale`` fp32 (E,
    out); other entries pass through."""
    qmax = _qmax(bits)
    out = {}
    for k, w in experts.items():
        if k in _EXPERT_MATS and w.ndim == 3:
            w32 = w.detach().float()
            scale = (w32.abs().amax(dim=1) / qmax).clamp_min(1e-12)
            out[k + "_q"] = _store(_round_int8(w32, scale[:, None, :], qmax), bits)
            out[k + "_scale"] = scale
        else:
            out[k] = w
    return out


def quantized_group(width=None, **tensors):
    """A frozen parameter group of quantized leaves (``linear.params``); an
    int4 table also records ``width``, its logical row width, to which
    ``linear.embedding`` unpacks the gathered rows."""
    group = params(**tensors)
    if width is not None:
        group.width = width
    return group


class QuantLinear(nn.Module):
    """A weight-only int8 or int4 linear: {"w_q": (out, in) int8, or (out,
    ⌈in/2⌉) packed int4 (``uint8``), "w_scale": (out,) or (nb, out)
    fp32[, "b"]}, frozen; the logical in-width ``d_in`` is recorded; a
    ``lora`` submodule adds its update (``ops/lora.py``)."""

    def __init__(self, w_q, w_scale, b=None, *, d_in=None):
        super().__init__()
        self.d_in = d_in or w_q.shape[1] * (2 if is_int4(w_q) else 1)
        self.w_q = nn.Parameter(w_q, requires_grad=False)
        self.w_scale = nn.Parameter(w_scale, requires_grad=False)
        self.b = None if b is None else nn.Parameter(b.detach(), requires_grad=False)

    def forward(self, x):
        y = int8_matmul(x, self.w_q, self.w_scale)
        if self.b is not None:
            y = y + self.b
        lora = self._modules.get("lora")
        return y if lora is None else y + lora_delta(lora, x)

    @classmethod
    def empty_like(cls, d_out, d_in, scale_shape, *, bias_dtype=None, device=None, bits=8):
        """An uninitialised layer of the given shapes (filled by a state-dict load)."""
        b = None if bias_dtype is None else torch.empty(d_out, dtype=bias_dtype, device=device)
        return cls(_empty_q((d_out, d_in), bits, device), torch.empty(scale_shape, dtype=torch.float32, device=device),
                   b, d_in=d_in)


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
    ``exclude`` regex does not match (its ``lora`` adapter, if any, crosses
    to the ``QuantLinear`` unquantized); every expert stack (3-D lin1/gate/lin2)
    with ``quantize_experts`` unless excluded; the ``tok_emb`` table with
    ``quantize_embeddings`` (per-row scales, at least ``min_size`` entries).
    ``bits`` 8 or 4 (packed two a byte, module docstring).

    Divergence by design: the JAX walk also treats any other dict with a
    2-D "w" leaf as a linear — the vision tower's position table
    (``vision/pos_embed``) gets per-column scales there, which its own
    ``embedding`` then reads as per-row scales. Here only ``Linear`` modules
    are linears; such tables stay in their dtype.

    The walk holds module names, not modules, and looks each up as it goes:
    a replaced module has no reference left once its quantized form is in
    place, so a model at full width needs its own bytes plus one module's
    conversion at the peak, not the fp and the quantized models side by side."""
    _qmax(bits)
    pat = re.compile(exclude) if exclude else None
    for name in [name for name, _ in model.named_modules()]:
        module = model.get_submodule(name)
        path = "/" + name.replace(".", "/")
        excluded = pat is not None and pat.search(path) is not None
        if (quantize_embeddings and path.endswith("tok_emb") and isinstance(module, nn.ParameterDict)
                and "w" in module and module["w"].ndim == 2 and module["w"].numel() >= min_size):
            q = quantize_embedding_int8(dict(module), bits=bits)
            _set_module(model, name, quantized_group(module["w"].shape[1] if bits == 4 else None, **q))
        elif isinstance(module, Linear) and module.w.numel() >= min_size and not excluded:
            p = {"w": module.w} if module.b is None else {"w": module.w, "b": module.b}
            q = quantize_linear_int8(p, block_size=block_size, bits=bits)
            qlin = QuantLinear(q["w_q"], q["w_scale"], q.get("b"), d_in=module.w.shape[1])
            if "lora" in module._modules:  # the adapter crosses unquantized (JAX copies every key but "w")
                qlin.lora = module.lora
            _set_module(model, name, qlin)
        elif quantize_experts and _is_expert_stack(module) and not excluded:
            _set_module(model, name, quantized_group(**quantize_expert_stack_int8(dict(module), bits=bits)))
    return model


def _bits_of(arr):
    """4 for a JAX int4 leaf (ml_dtypes ``int4``, read by name: no import of ml_dtypes), else 8."""
    return 4 if getattr(getattr(arr, "dtype", None), "name", "") == "int4" else 8


def quantized_like(model, names):
    """Give ``model`` the quantized structure of a JAX tree in place: names
    maps each "."-joined leaf name to its array (``from_jax_flat``); an int4
    leaf gives the packed int4 structure."""
    for name, module in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(module, Linear) and prefix + "w_q" in names:
            d_out, d_in = module.w.shape
            bias_dtype = None if module.b is None else module.b.dtype
            qlin = QuantLinear.empty_like(d_out, d_in, tuple(names[prefix + "w_scale"].shape), bias_dtype=bias_dtype,
                                          device=module.w.device, bits=_bits_of(names[prefix + "w_q"]))
            if "lora" in module._modules:
                qlin.lora = module.lora
            _set_module(model, name, qlin)
        elif isinstance(module, nn.ParameterDict) and "w" in module and prefix + "w_q" in names:
            w, bits = module["w"], _bits_of(names[prefix + "w_q"])
            _set_module(model, name, quantized_group(
                w.shape[1] if bits == 4 else None,
                w_q=_empty_q(w.shape, bits, w.device),
                w_scale=torch.empty(w.shape[0], dtype=torch.float32, device=w.device)))
        elif _is_expert_stack(module) and prefix + "lin1_q" in names:
            bits = _bits_of(names[prefix + "lin1_q"])
            group = {}
            for k, w in module.items():
                if k in _EXPERT_MATS:
                    group[k + "_q"] = _empty_q(w.shape, bits, w.device)
                    group[k + "_scale"] = torch.empty(w.shape[0], w.shape[2], dtype=torch.float32, device=w.device)
                else:  # the biases of a non-gated stack pass through
                    group[k] = torch.empty_like(w)
            _set_module(model, name, quantized_group(**group))


def _empty_q(shape, bits, device):
    """An uninitialised quantized leaf for an fp weight of ``shape`` (packed along dim 1 at 4 bits)."""
    if bits == 4:
        return torch.empty(shape[0], -(-shape[1] // 2), *shape[2:], dtype=torch.uint8, device=device)
    return torch.empty(shape, dtype=torch.int8, device=device)


def param_bytes(params):
    """Bytes of a model's parameters as stored (int8 leaves, packed int4
    leaves at half a byte an element, and their fp32 scales included)."""
    return sum(t.numel() * t.element_size() for t in params.state_dict().values())


def quantized_byte_fraction(params_q, params_fp):
    """Parameter bytes of the quantized model over those of the fp model."""
    return param_bytes(params_q) / param_bytes(params_fp)
