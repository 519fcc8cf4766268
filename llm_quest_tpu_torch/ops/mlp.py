"""Feed-forward blocks (counterpart of ``llm_quest_tpu/ops/mlp.py``)."""

from torch import nn

from llm_quest_tpu_torch.ops.activations import gelu_erf, gelu_tanh, silu
from llm_quest_tpu_torch.ops.linear import Linear


def init_mlp_gelu(emb_dim, hidden_dim, *, bias=True, dtype, device=None):
    """The GPT-2/ViT FFN's frozen layers {"fc": emb→hidden, "proj":
    hidden→emb} (``reset_parameters`` draws JAX's ``init_linear`` distribution)."""
    return nn.ModuleDict({
        "fc": Linear(emb_dim, hidden_dim, bias=bias, dtype=dtype, device=device),
        "proj": Linear(hidden_dim, emb_dim, bias=bias, dtype=dtype, device=device),
    })


def mlp_gelu(ffn, x, *, tanh_approx=False):
    """proj(GELU(fc(x))), GELU by erf or, with ``tanh_approx``, by tanh."""
    act = gelu_tanh if tanh_approx else gelu_erf
    return ffn["proj"](act(ffn["fc"](x)))


def swiglu(ffn, x):
    """silu(x·W_gate) ⊙ (x·W_up) · W_down; ``ffn`` holds the "gate", "up" and
    "down" layers (``Linear`` or int8 ``QuantLinear``)."""
    return ffn["down"](silu(ffn["gate"](x)) * ffn["up"](x))
