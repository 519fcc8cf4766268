"""Classifier fine-tuning (counterpart of ``llm_quest_tpu/training/classifier.py``).

The loss is the CE of the logits at each row's last REAL token (the model's
``last_token_only`` gather over the batch's right-padded ``attn_mask``)
against 0/1 class ids. As in JAX, no class head is added: the GPT-2's
vocabulary head is trained, its first columns read as the classes
(``scripts/classifier_tuning.py``). The optimizer is ``optax.adamw``'s
(``training/engine.py::adamw``) at weight decay 0.1. The parameters (an
``nn.Module``) and the optimizer state are updated in place; batches are
dicts of numpy arrays or tensors ({"input_ids", "targets", "attn_mask"},
``data/datasets.py::spam_dataset`` rows).

Kernels on this path: K4 forward and backward (``kernels/attention.py``) in
every call with at least ``flash_min_seq`` (256) tokens, causal with the
padding key mask.
"""

import torch

from llm_quest_tpu_torch.training.engine import adamw, as_tensors, device_of, global_loss, make_train_step


def make_classifier_train_step(model, cfg, optimizer):
    """(params, opt_state, batch) → (params, opt_state, loss 0-d tensor):
    ``engine.make_train_step`` with ``classification``."""
    return make_train_step(model, cfg, optimizer, classification=True)


def make_classifier_eval_step(model, cfg):
    """(params, batch) → (loss, number of rows whose argmax is the target);
    the loss is ``engine.global_loss`` with ``classification``."""

    @torch.no_grad()
    def eval_step(params, batch):
        batch = as_tensors(batch, device_of(params))
        logits, _, _ = model.apply(params, cfg, batch["input_ids"], attn_mask=batch["attn_mask"],
                                   last_token_only=True)
        correct = (logits.argmax(dim=-1) == batch["targets"]).sum()
        return global_loss(logits, batch["targets"], classification=True), correct

    return eval_step


def classifier_accuracy(loader, eval_step, params, num_batches=None):
    """Accuracy over (up to) ``num_batches`` batches of ``loader``."""
    batches = list(loader) if not isinstance(loader, list) else loader
    n = len(batches) if num_batches is None else min(num_batches, len(batches))
    correct, seen = 0, 0
    for batch in batches[:n]:
        _, c = eval_step(params, batch)
        correct += int(c)
        seen += batch["targets"].shape[0]
    return correct / max(seen, 1)


def classifier_training_loop(model, cfg, params, train_loader, val_loader, *, num_epoch, lr=5e-5,
                             weight_decay=0.1, eval_freq=50, eval_iter=5, log=print):
    """Train ``params`` in place; the validation accuracy is logged at step
    1 and every ``eval_freq`` steps. Returns params."""
    optimizer = adamw(lr, weight_decay=weight_decay)
    opt_state = optimizer.init(params)
    train_step = make_classifier_train_step(model, cfg, optimizer)
    eval_step = make_classifier_eval_step(model, cfg)

    train_batches = list(train_loader)
    step = 0
    for epoch in range(1, num_epoch + 1):
        for batch in train_batches:
            params, opt_state, loss = train_step(params, opt_state, batch)
            step += 1
            if step == 1 or step % eval_freq == 0:
                acc = classifier_accuracy(val_loader, eval_step, params, eval_iter)
                log(f"Epoch {epoch} Step {step} | loss {float(loss):.4f} | val acc {acc:.3f}")
    return params
