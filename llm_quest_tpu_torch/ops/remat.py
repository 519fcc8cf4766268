"""Rematerialization policy for gradient checkpointing (counterpart of
``llm_quest_tpu/ops/remat.py``).

cfg["remat_policy"]:
- "full" (default): ``torch.utils.checkpoint`` (non-reentrant) saves only
  the block inputs; the backward recomputes the whole block.
- "dots": selective checkpointing that saves matmul OUTPUTS and recomputes
  the elementwise chains between them (JAX's
  ``dots_with_no_batch_dims_saveable``).
- "none": no checkpointing.

A recomputed block relaunches its kernels, so under "full" and "dots" the
flash forward runs twice per block per step.
"""

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

_MATMULS = frozenset({
    torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default,
    torch.ops.aten.bmm.default,
    torch.ops.aten.baddbmm.default,
})


def _save_matmuls(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_matmuls)


def checkpoint_block(cfg, fn):
    """Wrap a block function per cfg["remat_policy"]."""
    policy = cfg.get("remat_policy", "full")
    if policy == "none":
        return fn
    if policy == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=_dots_context)
    if policy != "full":
        raise ValueError(f"remat_policy must be 'full', 'dots' or 'none', got {policy!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False)
