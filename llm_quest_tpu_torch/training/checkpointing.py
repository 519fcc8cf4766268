"""Checkpoint save and load, and best-checkpoint gating (counterpart of
``llm_quest_tpu/training/checkpointing.py``).

A checkpoint is one ``torch.save`` file, ``checkpoint.pt`` in the directory
``path``: {"params": the module's state dict, "opt_state": the
``training/engine.py::AdamW`` state (its step count and moment tensors),
"step", "extra"}, the keys present as given. JAX writes the same train state
through Orbax. ``save_if_best`` gates a save on
``utils.CheckpointEvaluator``.

Divergence by design: JAX's ``blocking=False`` schedules an asynchronous
save (Orbax snapshots the arrays to the host and writes on a background
thread). Here every save is synchronous, whatever ``blocking`` says: the
tensors are on the disk when ``save_checkpoint`` returns, and
``wait_for_saves`` has nothing to wait for.
"""

import os

import torch

from llm_quest_tpu_torch.config import resolve_device

FILE_NAME = "checkpoint.pt"


def save_checkpoint(path, params, *, opt_state=None, step=None, extra=None, blocking=True):
    """Save a train state into the directory ``path`` (made if needed).
    params: an ``nn.Module`` (its state dict is saved) or a dict of tensors.
    ``blocking`` is accepted for JAX's signature; the save is synchronous
    either way (module docstring). Returns the directory's absolute path."""
    del blocking
    state = {"params": params.state_dict() if isinstance(params, torch.nn.Module) else params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    if step is not None:
        state["step"] = step
    if extra is not None:
        state["extra"] = extra
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE_NAME + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, FILE_NAME))  # a reader never sees half a file
    return path


def wait_for_saves():
    """Every save has finished when it returns (module docstring): nothing to wait for."""


def load_checkpoint(path, *, target=None, device=None):
    """Load the train state saved in the directory ``path``.

    With ``target`` (an ``nn.Module`` of the saved structure) the tensors
    land on its device, its parameters are loaded in place, and "params" in
    the returned dict is the module itself. Without one they land on
    ``device`` (default: the card, ``config.resolve_device``) and "params"
    is the saved state dict. The optimizer state's tensors move with them."""
    device = next(iter(target.state_dict().values())).device if target is not None else resolve_device(device)
    state = torch.load(os.path.join(os.path.abspath(path), FILE_NAME), map_location=device, weights_only=False)
    if target is not None:
        target.load_state_dict(state["params"])
        state["params"] = target
    return state


def save_if_best(path, evaluator, kind, metrics, params, **kw):
    """Save when ``evaluator`` (``utils.CheckpointEvaluator``) calls the
    metrics the best so far. kind: "rlhf" or "rlvr" (metrics {"kl",
    "reward"}) or "rm" (metrics {"accuracy", "val_loss"}). Returns True if
    it saved."""
    if kind in ("rlhf", "rlvr"):
        fn = evaluator.is_rlhf_grpo_best if kind == "rlhf" else evaluator.is_rlvr_grpo_best
        best = fn(metrics["kl"], metrics["reward"])
    elif kind == "rm":
        best = evaluator.is_rm_accu_best(metrics["accuracy"], metrics["val_loss"])
    else:
        raise ValueError(f"Unknown checkpoint kind: {kind}")
    if best:
        save_checkpoint(path, params, **kw)
    return best
