"""Activation functions (counterpart of ``llm_quest_tpu/ops/activations.py``).

- ``gelu_erf``: exact GELU x·Φ(x) via erf.
- ``gelu_tanh``: tanh approximation (Qwen3.5 vision FFN).
- ``silu``: x·sigmoid(x) (SwiGLU gates, GDN).
- ``softcap``: cap·tanh(x / cap), logit soft-capping (Gemma).
"""

import math

import torch


def gelu_erf(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x):
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def silu(x):
    return x * torch.sigmoid(x)


def softcap(x, cap):
    return cap * torch.tanh(x / cap)
