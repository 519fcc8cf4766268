"""Linear / embedding primitives (counterpart of ``llm_quest_tpu/ops/linear.py``).

Layout rule: the port stores linear weights as torch does, ``(out, in)``, and
applies them with ``F.linear``. The JAX package stores them ``(in, out)`` for
``x @ w``, so ``weights/interop.py::from_jax_flat`` transposes every
``Linear`` weight on the way in. Embedding tables are ``(num, dim)`` in both.

``embedding`` and ``tied_head`` take the table's parameter group and dispatch
on it: ``{"w"}``, or the int8 or packed int4 ``{"w_q", "w_scale"}`` of
``ops/quantization.py`` (per-row scales). The quantized linear is
``quantization.QuantLinear``. Both add the low-rank update of a ``lora``
submodule when one is present (``ops/lora.py``), as JAX's ``linear`` does.

Operand types are not promoted: ``linear`` raises on x and w of two types
(a mis-cast model fails instead of running in fp32). Divergence by design:
JAX's ``x @ w`` promotes, which only an fp32 model with an int8 table and an
unquantized linear reaches (the table's bf16 rows meeting an fp32 weight);
such a model quantizes every linear (``min_size=0``) or, as Qwen3.5, takes
fp32 rows (``embedding(..., dtype=torch.float32)``) as ``inputs_embs``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from llm_quest_tpu_torch.ops.int4 import is_int4, unpack_int4
from llm_quest_tpu_torch.ops.lora import lora_delta


def linear(x, w, b=None):
    """x: (..., in) → (..., out); w: (out, in)."""
    return F.linear(x, w, b)


def embedding(table, ids, *, dtype=None):
    """Token-id lookup. ids: (...,) int → (..., dim). A quantized table
    dequantizes only the gathered rows (an int4 table unpacks only those),
    in bf16 unless ``dtype`` says otherwise (JAX's rule: quantized tables
    are a bf16 serving transform)."""
    if "w_q" in table:
        dt = dtype or torch.bfloat16
        rows = table["w_q"][ids]
        if is_int4(rows):  # to the group's recorded row width (a group that records none: an even one)
            rows = unpack_int4(rows, getattr(table, "width", 2 * rows.shape[-1]), dim=-1, dtype=dt)
        else:
            rows = rows.to(dt)
        return rows * table["w_scale"][ids][..., None].to(dt)
    w = table["w"][ids]
    return w if dtype is None else w.to(dtype)


def tied_head(table, h):
    """Tied-embedding output head ``h @ wᵀ``; a quantized table gives ``(h
    @ w_qᵀ) · scale`` (an int4 table unpacked first), its per-row scale
    being the head's output-channel scale."""
    if "w_q" in table:
        from llm_quest_tpu_torch.ops.quantization import int8_matmul

        return int8_matmul(h, table["w_q"], table["w_scale"])
    return linear(h, table["w"])


def params(*, trainable=False, **tensors):
    """A parameter group whose keys are the JAX leaf names, so state-dict
    keys mirror the JAX parameter paths. Frozen (inference) unless
    ``trainable``."""
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=trainable) for k, t in tensors.items()})


class Linear(nn.Module):
    """Parameters {"w": (out, in)[, "b": (out,)]} — the JAX leaf dict
    {"w", "b"} under the same names (and a ``lora`` submodule once
    ``ops/lora.py::replace_with_lora`` wraps it). Frozen (inference) unless
    ``trainable``."""

    def __init__(self, d_in, d_out, *, bias, dtype, device=None, trainable=False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype, device=device), requires_grad=trainable)
        self.b = (
            nn.Parameter(torch.empty(d_out, dtype=dtype, device=device), requires_grad=trainable) if bias else None
        )

    def forward(self, x):
        y = linear(x, self.w, self.b)
        lora = self._modules.get("lora")
        return y if lora is None else y + lora_delta(lora, x)

    def reset_parameters(self, generator):
        """torch nn.Linear default init: U(±1/sqrt(in)) for weight and bias."""
        bound = 1.0 / (self.w.shape[1] ** 0.5)
        for p in self.parameters(recurse=False):
            p.uniform_(-bound, bound, generator=generator)
