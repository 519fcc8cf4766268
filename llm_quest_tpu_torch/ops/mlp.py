"""Feed-forward blocks (counterpart of ``llm_quest_tpu/ops/mlp.py``)."""

from llm_quest_tpu_torch.ops.activations import silu


def swiglu(ffn, x):
    """silu(x·W_gate) ⊙ (x·W_up) · W_down; ``ffn`` holds the "gate", "up" and
    "down" layers (``Linear`` or int8 ``QuantLinear``)."""
    return ffn["down"](silu(ffn["gate"](x)) * ffn["up"](x))
