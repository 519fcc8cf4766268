"""Direct Preference Optimization, DPO and cDPO (counterpart of
``llm_quest_tpu/alignment/dpo.py``).

- ``compute_logprobs``: the mean log-probability of each sequence's realized
  next tokens under the loss mask, divided, as JAX divides (reference
  parity), by the UNSHIFTED mask's sum;
- ``dpo_loss``: -log σ(β·(Δ_chosen - Δ_rejected)), with cDPO's label
  smoothing adding -log σ(-β·…)·ε; the detached rewards' means for the log;
- ``dpo_forward``: the policy's two passes with gradients and the frozen
  reference's two under ``torch.no_grad`` (JAX's ``stop_gradient``);
- ``make_dpo_train_step``, ``dpo_evaluate`` and ``dpo_training_loop``
  (``optax.adamw``'s settings: ``training/engine.py::adamw``).

Models are ``nn.Module``s updated in place; batches come from
``data/datasets.py::dpo_collate`` (numpy or tensors). The passes are
causal with no key mask (the loss masks only weigh the log-probabilities),
so K4 runs forward and backward (``kernels/attention.py``) in every pass of
at least ``flash_min_seq`` (256) tokens.
"""

import torch
import torch.nn.functional as F

from llm_quest_tpu_torch.training.engine import adamw, as_tensors, device_of, param_leaves


def compute_logprobs(logits, inputs, attention_mask=None):
    """(b,) mean log-probability of the realized tokens, in fp32."""
    logits = logits[:, :-1, :].float()
    labels = inputs[:, 1:].long()
    logprobs = torch.log_softmax(logits, dim=-1)
    label_logprobs = logprobs.gather(-1, labels[..., None])[..., 0]  # (b, s-1)

    if attention_mask is not None:
        shifted = attention_mask[:, 1:].to(label_logprobs.dtype)
        # the unshifted mask's sum, as JAX's reference divides
        return (label_logprobs * shifted).sum(-1) / attention_mask.to(label_logprobs.dtype).sum(-1)
    return label_logprobs.mean(-1)


def dpo_loss(pol_chosen, pol_rejected, ref_chosen, ref_rejected, *, beta=0.1, label_smoothing=0.0):
    """Returns (loss, chosen_rewards_mean, rejected_rewards_mean)."""
    pref_logratio = pol_chosen - ref_chosen
    rejec_logratio = pol_rejected - ref_rejected
    chosen_rewards = pref_logratio.detach()
    rejected_rewards = rejec_logratio.detach()

    logits = pref_logratio - rejec_logratio
    losses = (
        -F.logsigmoid(beta * logits) * (1 - label_smoothing)
        - F.logsigmoid(-beta * logits) * label_smoothing
    )
    return losses.mean(), chosen_rewards.mean(), rejected_rewards.mean()


def dpo_forward(model, cfg, policy_params, reference_params, batch, *, beta=0.1, label_smoothing=0.0):
    """Four passes and the loss. batch: ``dpo_collate``'s tensors; the
    collator's LOSS masks weigh the log-probabilities (JAX's reference
    passes them as the attention surrogate); no key mask is applied."""

    def seq_logprobs(params, ids, mask):
        logits, _, _ = model.apply(params, cfg, ids)
        return compute_logprobs(logits, ids, mask)

    pol_chosen = seq_logprobs(policy_params, batch["chosen"], batch["chosen_mask"])
    pol_rejected = seq_logprobs(policy_params, batch["rejected"], batch["rejected_mask"])
    with torch.no_grad():
        ref_chosen = seq_logprobs(reference_params, batch["chosen"], batch["chosen_mask"])
        ref_rejected = seq_logprobs(reference_params, batch["rejected"], batch["rejected_mask"])

    return dpo_loss(pol_chosen, pol_rejected, ref_chosen, ref_rejected, beta=beta, label_smoothing=label_smoothing)


def make_dpo_train_step(model, cfg, optimizer, *, beta=0.1, label_smoothing=0.0):
    """(policy, opt_state, reference, batch) → (policy, opt_state, metrics
    {"loss", "chosen_rewards", "rejected_rewards"} of 0-d tensors)."""

    def train_step(policy_params, opt_state, reference_params, batch):
        batch = as_tensors(batch, device_of(policy_params))
        with torch.enable_grad():
            loss, cr, rr = dpo_forward(model, cfg, policy_params, reference_params, batch, beta=beta,
                                       label_smoothing=label_smoothing)
            grads = torch.autograd.grad(loss, param_leaves(policy_params), allow_unused=True, materialize_grads=True)
        opt_state = optimizer.update(grads, opt_state, policy_params)
        return policy_params, opt_state, {"loss": loss.detach(), "chosen_rewards": cr, "rejected_rewards": rr}

    return train_step


@torch.no_grad()
def dpo_evaluate(model, cfg, policy_params, reference_params, loader, *, beta=0.1, num_batches=None):
    """(mean loss, mean reward margin) over (up to) ``num_batches`` batches."""
    batches = list(loader) if not isinstance(loader, list) else loader
    n = len(batches) if num_batches is None else min(num_batches, len(batches))
    tot_loss, tot_margin = 0.0, 0.0
    for batch in batches[:n]:
        batch = as_tensors(batch, device_of(policy_params))
        loss, cr, rr = dpo_forward(model, cfg, policy_params, reference_params, batch, beta=beta)
        tot_loss += float(loss)
        tot_margin += float(cr - rr)
    return tot_loss / max(n, 1), tot_margin / max(n, 1)


def dpo_training_loop(
    model, cfg, policy_params, reference_params, train_loader, *, num_epochs, lr=5e-6, beta=0.1,
    label_smoothing=0.0, val_loader=None, eval_freq=5, eval_iter=5, log=print,
):
    """Train the policy in place (``optax.adamw(lr)``'s settings); logs at
    step 1 and every ``eval_freq`` steps. Returns the policy."""
    optimizer = adamw(lr)
    opt_state = optimizer.init(policy_params)
    step_fn = make_dpo_train_step(model, cfg, optimizer, beta=beta, label_smoothing=label_smoothing)

    step = 0
    for epoch in range(1, num_epochs + 1):
        for batch in train_loader:
            policy_params, opt_state, metrics = step_fn(policy_params, opt_state, reference_params, batch)
            step += 1
            if step == 1 or step % eval_freq == 0:
                msg = f"Epoch {epoch} Step {step} | loss {float(metrics['loss']):.4f} | " \
                      f"margin {float(metrics['chosen_rewards'] - metrics['rejected_rewards']):.4f}"
                if val_loader is not None:
                    vl, vm = dpo_evaluate(model, cfg, policy_params, reference_params, val_loader,
                                          beta=beta, num_batches=eval_iter)
                    msg += f" | val loss {vl:.4f} margin {vm:.4f}"
                log(msg)
    return policy_params
