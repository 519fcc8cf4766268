"""Feed-forward blocks (counterpart of ``llm_quest_tpu/ops/mlp.py``)."""

from llm_quest_tpu_torch.ops.activations import silu
from llm_quest_tpu_torch.ops.linear import linear


def swiglu(x, w_gate, w_up, w_down):
    """silu(x·W_gate) ⊙ (x·W_up) · W_down; weights (out, in)."""
    return linear(silu(linear(x, w_gate)) * linear(x, w_up), w_down)
