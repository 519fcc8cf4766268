"""Normalization layers (counterpart of ``llm_quest_tpu/ops/norms.py``).

- ``layer_norm``: the GPT-2 form (x − μ)/(σ + eps)·γ + β, biased σ, eps
  outside the square root (Gemma-3's q/k norm).
- ``layer_norm_torch``: (x − μ)/sqrt(σ² + eps)·γ + β in the input dtype.
- ``rms_norm``: the Llama form x/(RMS(x) + eps) with an fp32 mean-square,
  the scale applied after the cast back to the input dtype (Gemma-3).
- ``rms_norm_torch_parity``: the whole op, weight multiply included, in fp32;
  cast back to the input dtype at the end.
- ``zero_centered_rms_norm``: Qwen3-Next (1 + weight) RMSNorm, fp32 island.
- ``l2_norm``: x·rsqrt(Σx² + eps) over the last dim in fp32, cast back (not
  ``ops/gdn.py::l2_norm_clamp``, which divides by max(‖x‖, eps)).
- ``DynamicTanh`` / ``init_dynamic_tanh`` / ``dynamic_tanh``: DyT, γ·tanh(αx)
  + β, a normalization-free stand-in for a norm layer; α a 0-d parameter,
  γ and β per channel. No port model calls it, as no JAX model does.
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import resolve_device


def layer_norm(x, scale, shift, *, eps=1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    std = (x - mean).square().mean(dim=-1, keepdim=True).sqrt()
    return scale * ((x - mean) / (std + eps)) + shift


def layer_norm_torch(x, scale, shift, *, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return scale * ((x - mean) * torch.rsqrt(var + eps)) + shift


def rms_norm(x, scale, *, eps=1e-6):
    x32 = x.float()
    normed = x32 / (x32.square().mean(dim=-1, keepdim=True).sqrt() + eps)
    return (scale * normed.to(x.dtype)).to(x.dtype)


def rms_norm_torch_parity(x, scale, *, eps=1e-6):
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (scale.float() * normed).to(x.dtype)


def zero_centered_rms_norm(x, scale, *, eps=1e-6):
    x32 = x.float()
    normed = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return ((1.0 + scale.float()) * normed).to(x.dtype)


def l2_norm(x, *, eps=1e-6):
    x32 = x.float()
    return (x32 * torch.rsqrt(x32.square().sum(dim=-1, keepdim=True) + eps)).to(x.dtype)


class DynamicTanh(nn.Module):
    """DyT's parameters under JAX's names {"alpha": (), "gamma": (dim,),
    "beta": (dim,)}, trainable, also read as ``params["alpha"]``;
    ``forward`` is ``dynamic_tanh``. Built on the card unless ``device``
    says otherwise."""

    def __init__(self, dim, *, alpha0=0.5, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.alpha = nn.Parameter(torch.full((), alpha0, dtype=dtype, device=device))
        self.gamma = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def __getitem__(self, key):
        return getattr(self, key)

    def forward(self, x):
        return dynamic_tanh(self, x)


def init_dynamic_tanh(dim, *, alpha0=0.5, dtype=torch.float32, device=None):
    return DynamicTanh(dim, alpha0=alpha0, dtype=dtype, device=device)


def dynamic_tanh(params, x):
    """γ·tanh(α·x) + β; ``params`` a ``DynamicTanh`` or a dict of its three
    tensors. Computed in the promoted type of x and the parameters, as JAX
    promotes (torch would round α·x to x's type: α is 0-d)."""
    alpha, gamma, beta = params["alpha"], params["gamma"], params["beta"]
    dt = torch.promote_types(torch.promote_types(x.dtype, alpha.dtype), torch.promote_types(gamma.dtype, beta.dtype))
    return gamma.to(dt) * torch.tanh(alpha.to(dt) * x.to(dt)) + beta.to(dt)
