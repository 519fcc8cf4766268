"""Core training engine (counterpart of ``llm_quest_tpu/training/engine.py``).

One train step = forward, global loss, backward, global-norm clip, LR
schedule and AdamW update, with the parameters and optimizer state updated
IN PLACE (JAX donates the buffers to the same effect). Mixed precision is the
config dtype (bf16 parameters and compute), as in the JAX package.

``make_optimizer`` is written to optax's semantics, not as
``torch.optim.AdamW``: ``clip_by_global_norm`` without an epsilon, Adam's μ
in ``mu_dtype`` (fp32) and ν in the parameter dtype, ε = 1e-8 outside the
square root, decoupled weight decay on every leaf (norms and the embedding
included) scaled by the learning rate, the learning rate of update n taken
from ``schedule(n)`` with n counted from 0, and gradient accumulation as
``optax.MultiSteps`` (running mean of the micro-gradients, an update every
k-th call, none in between). The global norm is accumulated in fp32.
Under ``cfg["context_parallel"]`` (the dense Qwen3) the loss and the
gradients of a rank's slice are summed over the group before the clip
(``make_value_and_grad``).

Dropout (JAX's ``has_dropout``): ``make_train_step(..., has_dropout=True)``
gives a step that takes a ``torch.Generator`` on the parameters' device and
passes ``deterministic=False`` with it to ``model.apply`` (GPT-2 drops at
``cfg["drop_rate"]``, ``ops/dropout.py``); ``training_eval_loop`` sets it from
the config and draws from its ``generator=`` (default: seeded 0, as JAX's
``rng`` defaults to ``PRNGKey(0)``). A config with dropout for a model whose
``apply`` takes no generator (Qwen3-Next's "p_dropout") still raises there.

Classification (JAX's ``classification=``): the model gives the logits of
each row's last real token (``last_token_only``, which needs the batch's
"attn_mask") and the loss is their CE against (b,) targets
(``training/classifier.py`` trains over the vocabulary head this way).
``training_eval_loop`` saves (params, optimizer state, step) every
``checkpoint_every`` optimizer steps and at its end
(``training/checkpointing.py``; the saves are synchronous) and advances a
``training/profiling.py::ScheduledProfiler`` once an optimizer step, after a
device sync so the traced window holds the step's device work.
"""

import inspect
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from llm_quest_tpu_torch.ops.losses import IGNORE_INDEX, cross_entropy


def make_lr_schedule(total_steps, init_lr, peak_lr, warmup_steps=0, min_lr=None, decay=None):
    """Linear warmup init→peak over ``warmup_steps``, then cosine decay
    peak→min over the remaining steps (``decay="cosine"``) or constant peak.
    Returns a function of the step (int) → learning rate (float)."""
    if warmup_steps > 0 and init_lr >= peak_lr:
        raise ValueError(
            f"Warmup enabled (warmup_steps={warmup_steps}) but init_lr ({init_lr:.2e}) "
            f">= peak_lr ({peak_lr:.2e}). Either set warmup_steps=0 or init_lr < peak_lr."
        )
    if min_lr is not None and min_lr >= peak_lr:
        raise ValueError(
            f"min_lr ({min_lr:.2e}) >= peak_lr ({peak_lr:.2e}). "
            f"Either set min_lr=None (no decay) or min_lr < peak_lr."
        )
    if decay is not None and min_lr is None:
        raise ValueError(f"decay='{decay}' was set but min_lr=None. Either set min_lr < peak_lr or decay=None.")
    if decay is None and min_lr is not None:
        raise ValueError(f"min_lr ({min_lr:.2e}) was set but decay=None. Either set decay 'cosine' or min_lr=None.")

    init_lr = init_lr if warmup_steps > 0 else peak_lr
    lr_step = (peak_lr - init_lr) / warmup_steps if warmup_steps > 0 else 0.0
    eff_min_lr = min_lr if min_lr is not None else peak_lr

    def schedule(step):
        if step < warmup_steps:
            return init_lr + lr_step * step
        if decay == "cosine":
            total_decay = max(total_steps - warmup_steps, 1)
            cos = 0.5 * (1 + math.cos(math.pi * (step - warmup_steps) / total_decay))
            return eff_min_lr + (peak_lr - eff_min_lr) * cos
        return peak_lr

    return schedule


def param_leaves(params):
    """The parameter tensors of an ``nn.Module``, a dict or a list, in a fixed order."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


class AdamW:
    """``optax.chain(clip_by_global_norm, adamw)`` (inside ``optax.MultiSteps``
    when ``accumulation_steps > 1``), applied in place. ``init(params)``
    makes the state; ``update(grads, state, params)`` applies one call."""

    def __init__(self, lr_or_schedule, *, weight_decay, b1, b2, eps, grad_clip_norm, accumulation_steps, mu_dtype):
        self.schedule = lr_or_schedule if callable(lr_or_schedule) else (lambda step: lr_or_schedule)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.grad_clip_norm = grad_clip_norm
        self.accumulation_steps = accumulation_steps
        self.mu_dtype = mu_dtype

    def init(self, params):
        leaves = param_leaves(params)
        state = {
            "count": 0,
            "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves],
        }
        if self.accumulation_steps > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p) for p in leaves]
        return state

    @torch.no_grad()
    def update(self, grads, state, params):
        leaves = param_leaves(params)
        if self.accumulation_steps > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g - acc) / (n + 1))
            state["mini_step"] = (n + 1) % self.accumulation_steps
            if n != self.accumulation_steps - 1:
                return state
            grads = state["acc"]
        if self.grad_clip_norm is not None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            keep = norm < self.grad_clip_norm  # optax's trigger: no epsilon
            grads = [torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip_norm) for g in grads]
        lr = self.schedule(state["count"])
        state["count"] += 1
        bc1 = 1 - self.b1 ** state["count"]
        bc2 = 1 - self.b2 ** state["count"]
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            mu.mul_(self.b1).add_(g.to(mu.dtype), alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g.square(), alpha=1 - self.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + u * -lr)
        if self.accumulation_steps > 1:
            for acc in state["acc"]:
                acc.zero_()
        return state


def make_optimizer(
    lr_or_schedule, *, weight_decay=0.1, b1=0.9, b2=0.999, grad_clip_norm=1.0, accumulation_steps=1,
    mu_dtype=torch.float32,
):
    """AdamW + global-norm clipping (+ MultiSteps gradient accumulation), to
    optax's semantics; μ in ``mu_dtype`` (fp32 by default, so the first
    moment stays full precision under bf16 parameters)."""
    return AdamW(
        lr_or_schedule, weight_decay=weight_decay, b1=b1, b2=b2, eps=1e-8, grad_clip_norm=grad_clip_norm,
        accumulation_steps=accumulation_steps, mu_dtype=mu_dtype,
    )


def adamw(lr_or_schedule, *, weight_decay=1e-4, b1=0.9, b2=0.999):
    """``optax.adamw`` at its defaults, as the classifier, DPO, reward-model
    and GRPO loops take it: no gradient clipping, both moments in the
    parameters' dtype, ε 1e-8, decoupled weight decay 1e-4."""
    return AdamW(lr_or_schedule, weight_decay=weight_decay, b1=b1, b2=b2, eps=1e-8, grad_clip_norm=None,
                 accumulation_steps=1, mu_dtype=None)


def global_loss(logits, targets, aux=None, *, classification=False):
    """CE + the model's MoE auxiliary loss (aux["moe_loss"]) when present.
    ``classification``: (b, v) logits against (b,) targets."""
    if classification:
        loss = cross_entropy(logits, targets)
    else:
        loss = cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    if aux and "moe_loss" in aux:
        loss = loss + aux["moe_loss"]
    return loss


def device_of(params):
    """The device of the first parameter tensor."""
    return param_leaves(params)[0].device


_LIST_KEYS = ("shifted_inputs", "shifted_targets")  # the MTP collator's per-depth lists


def _as_tensor(v, device):
    return v.to(device) if torch.is_tensor(v) else torch.as_tensor(np.asarray(v), device=device)


def as_tensors(batch, device):
    """A batch dict (numpy arrays, lists or tensors) as tensors on ``device``;
    the MTP collator's ``shifted_inputs`` / ``shifted_targets`` stay lists,
    one tensor per depth."""
    return {k: [_as_tensor(a, device) for a in v] if k in _LIST_KEYS else _as_tensor(v, device)
            for k, v in batch.items()}


def make_loss_fn(model, cfg, *, fused_head_ce=False, has_dropout=False, classification=False):
    """The training loss of one batch: ``loss_fn(params, batch,
    generator=None) -> 0-d tensor``, differentiable in the parameters (see
    ``make_train_step``); with ``has_dropout`` the model drops, drawing from
    ``generator``; with ``classification`` the CE of each row's last real
    token's logits against its (b,) target."""
    if classification and fused_head_ce:
        raise ValueError("make_loss_fn: classification reads the last token's logits; fused_head_ce has none")

    def loss_fn(params, batch, generator=None):
        # a context-parallel rank's slice carries its global positions (parallel/mesh.py)
        pos = {"position_ids": batch["position_ids"]} if "position_ids" in batch else {}
        if has_dropout:
            if generator is None:
                raise ValueError("a train step with dropout draws from a torch.Generator: pass generator=")
            pos.update(deterministic=False, generator=generator)
        if fused_head_ce:
            from llm_quest_tpu_torch.ops.losses import cross_entropy_fused_head

            hidden, _, aux = model.apply(
                params, cfg, batch["input_ids"], attn_mask=batch.get("attn_mask"), training=True,
                output_hidden_states=True, **pos,
            )
            loss = cross_entropy_fused_head(hidden, model.head_weights(params, cfg), batch["targets"])
            if aux and "moe_loss" in aux:
                loss = loss + aux["moe_loss"]
            return loss
        if classification:
            pos["last_token_only"] = True
        logits, _, aux = model.apply(params, cfg, batch["input_ids"], attn_mask=batch.get("attn_mask"), training=True,
                                     **pos)
        return global_loss(logits, batch["targets"], aux, classification=classification)

    return loss_fn


def make_value_and_grad(model, cfg, *, fused_head_ce=False, has_dropout=False, classification=False):
    """``value_and_grad(params, batch, generator=None) -> (loss, grads)``: the training loss
    of one batch (a detached 0-d tensor) and its gradient for every
    parameter of ``params`` (``param_leaves`` order; zeros where none reaches).

    Under ``cfg["context_parallel"]`` each rank passes its part of the batch
    (``parallel/mesh.py::shard_batch``). For a rank's slice, the loss is
    JAX's, the mean over every token of the whole batch: the rank's mean
    times its share of the valid targets, summed over the group, and the
    gradients are summed over the group too (so a clip sees the global
    norm). A whole, replicated batch gives every rank the whole loss and
    gradients, which are not summed again."""
    from llm_quest_tpu_torch.parallel.mesh import cp_group, is_sharded

    loss_fn = make_loss_fn(model, cfg, fused_head_ce=fused_head_ce, has_dropout=has_dropout,
                           classification=classification)
    group = cp_group(cfg)

    def value_and_grad(params, batch, generator=None):
        leaves = param_leaves(params)
        reduce = group is not None and is_sharded(batch) and dist.get_world_size(group) > 1
        with torch.enable_grad():
            loss = loss_fn(params, batch, generator)
            if reduce:
                loss = loss * _target_share(batch["targets"], group)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        loss = loss.detach()
        if reduce:  # a group of one sums nothing
            grads = [g.contiguous() for g in grads]
            for t in (loss, *grads):
                dist.all_reduce(t, group=group)
        return loss, grads

    return value_and_grad


def make_train_step(model, cfg, optimizer, *, classification=False, fused_head_ce=False, has_dropout=False):
    """One train step: (params, opt_state, batch, generator=None) → (params,
    opt_state, loss). ``params`` (an ``nn.Module``) and ``opt_state`` are
    updated in place; ``loss`` is a 0-d device tensor (reading it
    synchronises). With ``has_dropout`` the model runs with
    ``deterministic=False`` and draws its masks from ``generator`` (a
    ``torch.Generator`` on the parameters' device), which it then needs.

    fused_head_ce: CE fused with the LM head over row chunks
    (ops/losses.py::cross_entropy_fused_head), so the (tokens, vocab) logits
    never exist. Needs ``output_hidden_states`` in ``model.apply`` and
    ``model.head_weights``. Under ``cfg["context_parallel"]`` the loss and
    the gradients are summed over the group before the clip
    (``make_value_and_grad``). ``classification``: the last-token CE
    (module docstring)."""
    value_and_grad = make_value_and_grad(model, cfg, fused_head_ce=fused_head_ce, has_dropout=has_dropout,
                                         classification=classification)

    def train_step(params, opt_state, batch, generator=None):
        loss, grads = value_and_grad(params, as_tensors(batch, device_of(params)), generator)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step


def _target_share(targets, group):
    """The rank's valid targets over the group's (fp32 0-dim): the weight of
    its mean loss in the mean over the whole batch."""
    valid = (targets != IGNORE_INDEX).sum().float()
    total = valid.clone()
    dist.all_reduce(total, group=group)
    return valid / total.clamp_min(1.0)


def make_eval_step(model, cfg, *, classification=False):
    @torch.no_grad()
    def eval_step(params, batch):
        batch = as_tensors(batch, device_of(params))
        logits, _, _ = model.apply(params, cfg, batch["input_ids"], attn_mask=batch.get("attn_mask"),
                                   last_token_only=classification)
        return global_loss(logits, batch["targets"], classification=classification)

    return eval_step


def calc_loss_loader(loader, eval_step, params, num_batches=None):
    """Mean eval loss over (up to) num_batches batches."""
    batches = list(loader) if not isinstance(loader, list) else loader
    if len(batches) == 0:
        return float("nan")
    n = len(batches) if num_batches is None else min(num_batches, len(batches))
    total = 0.0
    for batch in batches[:n]:
        total += float(eval_step(params, batch))
    return total / n


def evaluate(train_loader, val_loader, eval_step, params, eval_iter):
    """(train_loss, val_loss) over eval_iter batches of each loader."""
    train_loss = calc_loss_loader(train_loader, eval_step, params, num_batches=eval_iter)
    val_loss = calc_loss_loader(val_loader, eval_step, params, num_batches=eval_iter)
    return train_loss, val_loss


def training_eval_loop(
    model, cfg, params, train_loader, val_loader, *, num_epoch, peak_lr=4e-4, init_lr=1e-5, min_lr=None,
    warmup_steps=0, decay=None, weight_decay=0.1, accumulation_steps=1, eval_freq=5, eval_iter=5,
    generator=None, classification=False, log=print, timing=False, checkpoint_every=None, checkpoint_path=None,
    profiler=None,
):
    """Training loop with LR schedule, gradient accumulation, clipping and
    periodic evaluation (at step 1 and every ``eval_freq`` optimizer steps).
    A config with dropout ("drop_rate" or "p_dropout" above 0) trains with
    it, drawing from ``generator`` (a ``torch.Generator`` on the parameters'
    device; default one seeded 0); the evaluation is deterministic.

    train_loader / val_loader: re-iterable iterables of dict batches with
    "input_ids", "targets" and an optional "attn_mask" (numpy arrays or
    tensors); the training batches reach the device through
    ``data/prefetch.py``. ``params`` (an ``nn.Module``) is trained in place.
    ``classification``: the last-token CE (module docstring).

    checkpoint_every / checkpoint_path: every N optimizer steps, and once at
    the end, (params, optimizer state, step) are saved to checkpoint_path
    (``training/checkpointing.py::save_checkpoint``, synchronously).
    profiler: a ``training/profiling.py::ScheduledProfiler``, whose
    ``step()`` is called once an optimizer step after a device sync.

    Returns (params, train_losses, val_losses).
    """
    if checkpoint_every and checkpoint_path is None:
        raise ValueError("training_eval_loop: checkpoint_every needs checkpoint_path")
    has_dropout = cfg.get("drop_rate", cfg.get("p_dropout", 0.0)) > 0
    if has_dropout and "generator" not in inspect.signature(model.apply).parameters:
        name = getattr(model, "__name__", model)
        raise NotImplementedError(f"training_eval_loop: {name}.apply takes no dropout generator (the ViT trains "
                                  "with dropout through training/vit_engine.py)")
    train_batches = list(train_loader)
    steps_per_epoch = math.ceil(len(train_batches) / accumulation_steps)
    total_steps = steps_per_epoch * num_epoch

    schedule = make_lr_schedule(total_steps, init_lr, peak_lr, warmup_steps, min_lr, decay)
    optimizer = make_optimizer(schedule, weight_decay=weight_decay, accumulation_steps=accumulation_steps)
    opt_state = optimizer.init(params)

    train_step = make_train_step(model, cfg, optimizer, classification=classification, has_dropout=has_dropout)
    eval_step = make_eval_step(model, cfg, classification=classification)
    if has_dropout and generator is None:
        generator = torch.Generator(device=device_of(params)).manual_seed(0)

    train_losses, val_losses = [], []
    step = 0
    tokens_seen, t0 = 0, time.time()

    from llm_quest_tpu_torch.data.prefetch import prefetch_to_device

    for epoch in range(1, num_epoch + 1):
        for i, batch in enumerate(prefetch_to_device(iter(train_batches), device=device_of(params))):
            params, opt_state, loss = train_step(params, opt_state, batch, generator)
            tokens_seen += batch["input_ids"].numel()

            micro_step = i + 1 + (epoch - 1) * len(train_batches)
            if micro_step % accumulation_steps == 0:
                step += 1
                if profiler is not None:
                    if loss.is_cuda:
                        torch.cuda.synchronize(loss.device)  # the step's device work lands inside the trace
                    profiler.step()
                if step == 1 or step % eval_freq == 0:
                    tr, va = evaluate(train_batches, val_loader, eval_step, params, eval_iter)
                    train_losses.append(tr)
                    val_losses.append(va)
                    msg = (
                        f"Epoch: {epoch}, Step: {step}  | "
                        f"Train loss: {tr:.5f}  Val loss: {va:.5f}  | "
                        f"lr: {schedule(step):.1e}"
                    )
                    if timing:
                        elapsed = time.time() - t0
                        msg += f"  | tok/s: {tokens_seen / max(elapsed, 1e-9):.0f}"
                    log(msg)
                if checkpoint_every and step % checkpoint_every == 0:
                    from llm_quest_tpu_torch.training.checkpointing import save_checkpoint

                    save_checkpoint(checkpoint_path, params, opt_state=opt_state, step=step)

    if checkpoint_every:
        from llm_quest_tpu_torch.training.checkpointing import save_checkpoint

        save_checkpoint(checkpoint_path, params, opt_state=opt_state, step=step)
    return params, train_losses, val_losses
