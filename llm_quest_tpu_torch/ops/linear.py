"""Linear / embedding primitives (counterpart of ``llm_quest_tpu/ops/linear.py``).

Layout rule: the port stores linear weights as torch does, ``(out, in)``, and
applies them with ``F.linear``. The JAX package stores them ``(in, out)`` for
``x @ w``, so ``weights/interop.py::from_jax_flat`` transposes every
``Linear`` weight on the way in. Embedding tables are ``(num, dim)`` in both.
"""

import torch
import torch.nn.functional as F
from torch import nn


def linear(x, w, b=None):
    """x: (..., in) → (..., out); w: (out, in)."""
    return F.linear(x, w, b)


def embedding(w, ids):
    """Token-id lookup. ids: (...,) int → (..., dim)."""
    return w[ids]


def tied_head(w, h):
    """Tied-embedding output head ``h @ w.T``; w: (vocab, d)."""
    return F.linear(h, w)


def params(*, trainable=False, **tensors):
    """A parameter group whose keys are the JAX leaf names, so state-dict
    keys mirror the JAX parameter paths. Frozen (inference) unless
    ``trainable``."""
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=trainable) for k, t in tensors.items()})


class Linear(nn.Module):
    """Parameters {"w": (out, in)[, "b": (out,)]} — the JAX leaf dict
    {"w", "b"} under the same names. Frozen (inference) unless ``trainable``."""

    def __init__(self, d_in, d_out, *, bias, dtype, device=None, trainable=False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_out, d_in, dtype=dtype, device=device), requires_grad=trainable)
        self.b = (
            nn.Parameter(torch.empty(d_out, dtype=dtype, device=device), requires_grad=trainable) if bias else None
        )

    def forward(self, x):
        return linear(x, self.w, self.b)

    def reset_parameters(self, generator):
        """torch nn.Linear default init: U(±1/sqrt(in)) for weight and bias."""
        bound = 1.0 / (self.w.shape[1] ** 0.5)
        for p in self.parameters(recurse=False):
            p.uniform_(-bound, bound, generator=generator)
