"""MTP training engines for DeepSeek-V3 and MiMo-V2-Flash (counterpart of
``llm_quest_tpu/training/mtp_engine.py``).

The loss lives inside the model (main CE + coeff/depth·Σ MTP CE), and the
aux-loss-free MoE bias update is applied AFTER the optimizer step, as a
non-gradient state update of the MoE blocks' ``biases`` buffers (in place,
where JAX folds it into the returned params). The biases are buffers, not
parameters, so the optimizer neither steps nor decays them (``ops/moe.py``).
"""

import torch

from llm_quest_tpu_torch.training.engine import _as_tensors, _device_of, _leaves


def _mtp_step(model, cfg, optimizer, loss_args):
    """loss → gradients → optimizer update → bias fold; ``loss_args(batch)``
    gives ``model.loss``'s positional arguments after (params, cfg)."""

    def train_step(params, opt_state, batch):
        batch = _as_tensors(batch, _device_of(params))
        with torch.enable_grad():
            loss, aux = model.loss(params, cfg, *loss_args(batch))
            grads = torch.autograd.grad(loss, _leaves(params), allow_unused=True, materialize_grads=True)
        opt_state = optimizer.update(grads, opt_state, params)
        model.update_moe_biases(params, cfg, aux["moe_counts"])
        return params, opt_state, loss.detach()

    return train_step


def make_deepseek_train_step(model, cfg, optimizer):
    """One train step: (params, opt_state, batch) → (params, opt_state,
    loss). ``model`` is the model module (``models/deepseek_v3.py``);
    ``params`` (its ``nn.Module``) and ``opt_state`` are updated in place;
    ``loss`` is a 0-d device tensor. batch: from
    ``data/datasets.py::collate_function_mtp`` ({"input_ids", "targets",
    "shifted_inputs", "shifted_targets"}, the last two lists of arrays)."""
    return _mtp_step(model, cfg, optimizer, lambda batch: (
        batch["input_ids"], batch["targets"], batch.get("shifted_inputs"), batch.get("shifted_targets")))


def make_mimo_train_step(model, cfg, optimizer):
    """One train step: (params, opt_state, batch) → (params, opt_state,
    loss). ``model`` is the model module (``models/mimo_v2_flash.py``);
    ``params`` (its ``nn.Module``) and ``opt_state`` are updated in place;
    ``loss`` is a 0-d device tensor. batch: {"input_ids", "targets"} (the
    MTP slices shrink from the inputs, no pre-shifted collator)."""
    return _mtp_step(model, cfg, optimizer, lambda batch: (batch["input_ids"], batch["targets"]))


@torch.no_grad()
def mtp_evaluate(model, cfg, params, loader, num_batches=None):
    """Mean main-model loss (no MTP terms) over up to ``num_batches``
    batches of ``loader``."""
    batches = list(loader) if not isinstance(loader, list) else loader
    n = len(batches) if num_batches is None else min(num_batches, len(batches))
    total = 0.0
    for batch in batches[:n]:
        batch = _as_tensors(batch, _device_of(params))
        total += float(model.loss(params, cfg, batch["input_ids"], batch["targets"], training=False)[0])
    return total / max(n, 1)
