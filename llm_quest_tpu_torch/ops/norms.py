"""Normalization layers (counterpart of ``llm_quest_tpu/ops/norms.py``).

- ``layer_norm``: the GPT-2 form (x − μ)/(σ + eps)·γ + β, biased σ, eps
  outside the square root (Gemma-3's q/k norm).
- ``layer_norm_torch``: (x − μ)/sqrt(σ² + eps)·γ + β in the input dtype.
- ``rms_norm``: the Llama form x/(RMS(x) + eps) with an fp32 mean-square,
  the scale applied after the cast back to the input dtype (Gemma-3).
- ``rms_norm_torch_parity``: the whole op, weight multiply included, in fp32;
  cast back to the input dtype at the end.
- ``zero_centered_rms_norm``: Qwen3-Next (1 + weight) RMSNorm, fp32 island.
"""

import torch


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
