"""The GRPO family: the reward model, collators, advantages, KL estimators,
losses and the RLHF loop (counterpart of ``llm_quest_tpu/alignment/grpo.py``).

- ``RewardModel`` (``init_reward_model``): a GPT-2 body and a scalar head,
  with three readouts: the masked mean of per-token scores, the head over
  the masked mean of the hidden states, and the score of the last real
  token; ``bt_loss`` (Bradley–Terry), ``make_rm_train_step``,
  ``rm_evaluate``;
- ``prompt_collator`` (numpy, right-padded) and
  ``batched_responses_collator`` (the first-EoS cumsum trick);
- ``z_scores``: group-relative advantages, Dr.GRPO's mean-centring and the
  phantom reward;
- the log-probabilities per token and per sequence, the K3 KL estimator
  (and its ratio-scaled unbiased form) and the off-policy sequence mask;
- ``GRPOLoss``: grpo, dapo and dr_grpo (clipped), sapo (soft gate) and
  gspo (sequence level);
- ``make_grpo_update_step``, ``grpo_experience`` (sampling through
  ``inference/generate.py::generate_batched_kv_cache``, then scoring),
  ``rlhf_grpo_training_loop`` and ``grpo_evaluate``.

Models are ``nn.Module``s updated in place; randomness comes from an
explicit ``torch.Generator`` on the policy's device where JAX takes an
``rng`` (the two draw different tokens from the same seed). The optimizers
are ``optax.adamw``'s (``training/engine.py::adamw``).

Kernels on this path: K4 forward and backward (``kernels/attention.py``)
in the scoring and update passes and the reward model's, over the
responses' key masks. A GRPO key mask has holes: a prompt's pads sit
between its last real token and its response, and the tokens after the
first EoS are cut. Sampling's cached calls take ``sdpa``, as JAX's do.

Divergence by design: ``last_token_score`` reads the LAST True column of the
mask, where JAX reads column ``sum(mask) - 1``. The two agree on the
right-padded batches of ``pref_reward_collate``; on GRPO's holed masks
JAX's column lies inside the response (ROADMAP Queue 3).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from llm_quest_tpu_torch.config import model_dtype, resolve_device
from llm_quest_tpu_torch.inference import generate as gen
from llm_quest_tpu_torch.models import gpt2
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training.engine import adamw, as_tensors, device_of, param_leaves

# ------------------------------------------------------------ reward model


class RewardModel(nn.Module):
    """{"body": GPT-2, "head": Linear(emb_dim, 1) with a bias}; ``forward``
    is ``reward_model_apply``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.body = gpt2.GPT2(cfg, device)
        self.head = Linear(cfg["emb_dim"], 1, bias=True, dtype=model_dtype(cfg), device=device, trainable=True)

    def forward(self, x, **kwargs):
        return reward_model_apply(self, self.cfg, x, **kwargs)


@torch.no_grad()
def init_reward_model(cfg, *, generator, device=None):
    """A reward model with random weights from ``generator`` (on
    ``device``): the body as ``gpt2.init``, the head U(±1/sqrt(emb_dim))."""
    model = RewardModel(cfg, device)
    for module in model.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(generator)
    return model


def scores_mean_pooling(scores, reward_mask):
    """(b, s, 1) scalar scores → their masked mean (b,)."""
    m = reward_mask.to(scores.dtype)
    return (scores[..., 0] * m).sum(1) / m.sum(1).clamp_min(1)


def hidden_states_mean_pooling(hidden, reward_mask, head):
    m = reward_mask.to(hidden.dtype)[..., None]
    pooled = (hidden * m).sum(1) / m.sum(1).clamp_min(1)
    return head(pooled)[..., 0]


def last_token_score(hidden, attention_mask, head):
    """The score of each row's last True column of the mask (module docstring)."""
    cols = torch.arange(attention_mask.shape[1], device=attention_mask.device)
    last = torch.where(attention_mask.bool(), cols, -1).amax(-1)
    return head(hidden[torch.arange(hidden.shape[0], device=hidden.device), last])[..., 0]


def reward_model_apply(params, cfg, x, *, attn_mask=None, reward_mask=None, readout="scores_mean_pooling"):
    """(b, s) ids → (b,) scalar rewards; ``params`` is a ``RewardModel``."""
    hidden, _, _ = gpt2.apply(params.body, cfg, x, attn_mask=attn_mask, output_hidden_states=True)
    if readout == "last_token":
        assert attn_mask is not None
        return last_token_score(hidden, attn_mask, params.head)
    if readout == "hidden_states_pooling":
        assert reward_mask is not None
        return hidden_states_mean_pooling(hidden, reward_mask, params.head)
    assert reward_mask is not None
    return scores_mean_pooling(params.head(hidden), reward_mask)


def bt_loss(chosen_logits, rejected_logits, beta=1.0):
    """Bradley–Terry loss: mean -log σ(β (r_chosen - r_rejected))."""
    return (-F.logsigmoid(beta * (chosen_logits - rejected_logits))).mean()


def _rm_pair(params, cfg, batch, readout):
    chosen = reward_model_apply(params, cfg, batch["chosen"], attn_mask=batch["chosen_attn_mask"],
                                reward_mask=batch["chosen_mask"], readout=readout)
    rejected = reward_model_apply(params, cfg, batch["rejected"], attn_mask=batch["rejected_attn_mask"],
                                  reward_mask=batch["rejected_mask"], readout=readout)
    return chosen, rejected


def make_rm_train_step(cfg, optimizer, *, readout="scores_mean_pooling", beta=1.0):
    """(params, opt_state, batch) → (params, opt_state, loss, accuracy),
    batch from ``pref_reward_collate``."""

    def train_step(params, opt_state, batch):
        batch = as_tensors(batch, device_of(params))
        with torch.enable_grad():
            c, r = _rm_pair(params, cfg, batch, readout)
            loss = bt_loss(c, r, beta)
            grads = torch.autograd.grad(loss, param_leaves(params), allow_unused=True, materialize_grads=True)
        opt_state = optimizer.update(grads, opt_state, params)
        accuracy = (c > r).float().mean()
        return params, opt_state, loss.detach(), accuracy

    return train_step


@torch.no_grad()
def rm_evaluate(params, cfg, loader, *, readout="scores_mean_pooling", num_batches=None):
    """(mean loss, accuracy) over (up to) ``num_batches`` batches."""
    batches = list(loader) if not isinstance(loader, list) else loader
    n = len(batches) if num_batches is None else min(num_batches, len(batches))
    tot_loss, correct, seen = 0.0, 0, 0
    for batch in batches[:n]:
        batch = as_tensors(batch, device_of(params))
        chosen, rejected = _rm_pair(params, cfg, batch, readout)
        tot_loss += float(bt_loss(chosen, rejected))
        correct += int((chosen > rejected).sum())
        seen += batch["chosen"].shape[0]
    return tot_loss / max(n, 1), correct / max(seen, 1)


# --------------------------------------------------------------- collators


def prompt_collator(prompts, pad_token_id=50256, custom_max_length=None):
    """Right-pad prompts. Returns {"padded_prompts" int32, "prompt_masks"
    bool, "last_real_pos" int64} numpy arrays."""
    if custom_max_length is not None:
        prompts = [p[:custom_max_length] for p in prompts]
    max_length = max(len(p) for p in prompts)

    padded = np.full((len(prompts), max_length), pad_token_id, dtype=np.int32)
    masks = np.zeros((len(prompts), max_length), dtype=bool)
    last_real = np.zeros((len(prompts),), dtype=np.int64)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
        masks[i, : len(p)] = True
        last_real[i] = len(p) - 1
    return {"padded_prompts": padded, "prompt_masks": masks, "last_real_pos": last_real}


def batched_responses_collator(responses, prompt_masks, eos_ids=50256, pad_token_id=50256):
    """Masks of sampled responses. responses: (B, prompt + gen) ids tensor;
    prompt_masks: (B, prompt) bool. In the generated part everything up to
    and including the first EoS (or pad) is kept; the prompt part keeps its
    own mask, so its pads stay holes. Returns {"padded_responses",
    "reward_masks" (the kept generated tokens), "attn_masks"}."""
    len_prompt = prompt_masks.shape[1]
    eos_arr = torch.as_tensor([eos_ids] if isinstance(eos_ids, int) else list(eos_ids), device=responses.device)

    is_stop = (responses[..., None] == eos_arr).any(-1) | (responses == pad_token_id)
    is_stop[:, :len_prompt] = False

    attn_masks = is_stop.long().cumsum(1) <= 1  # everything before + the first EoS/pad
    attn_masks[:, :len_prompt] = prompt_masks.bool()

    reward_masks = attn_masks.clone()
    reward_masks[:, :len_prompt] = False
    return {"padded_responses": responses, "reward_masks": reward_masks, "attn_masks": attn_masks}


# --------------------------------------------------------------- core math


def z_scores(rewards, num_samples, dr_grpo=None, *, use_phantom_reward=False):
    """Group-relative advantages over groups of ``num_samples`` rows: (r -
    mean) / (std + 1e-8) with the unbiased std (one sample: NaN, as JAX's
    ``ddof=1``); Dr.GRPO (``dr_grpo="dr_grpo"``) only centres; the phantom
    reward adds a zero to each group's statistics."""
    rewards = rewards.reshape(-1, num_samples).float()
    if use_phantom_reward:
        augmented = torch.cat([rewards, torch.zeros(rewards.shape[0], 1, device=rewards.device)], dim=1)
    else:
        augmented = rewards
    group_mean = augmented.mean(1, keepdim=True)
    if dr_grpo == "dr_grpo":
        z = rewards - group_mean
    else:
        group_std = augmented.std(1, keepdim=True, correction=1)
        z = (rewards - group_mean) / (group_std + 1e-8)
    return z.reshape(-1)


def log_probs_per_token(logits, inputs):
    """(B, S-1) log-probability of each realized next token, in fp32."""
    logits = logits[:, :-1, :].float()
    labels = inputs[:, 1:].long()
    return torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]


def log_probs_per_token_optimized(logits, inputs):
    """The logsumexp form, in the logits' dtype (avoid under bf16)."""
    logits = logits[:, :-1, :]
    labels = inputs[:, 1:].long()
    label_logits = logits.gather(-1, labels[..., None])[..., 0]
    return label_logits - torch.logsumexp(logits, dim=-1)


def log_probs_per_seq(logprobs_per_token, loss_mask):
    """Masked mean per sequence (B,)."""
    m = loss_mask.to(logprobs_per_token.dtype)
    return (logprobs_per_token * m).sum(1) / m.sum(1)


def kl_div_per_token(policy_logprobs, reference_logprobs, policy_ratio=None):
    """K3 estimator; the ratio-scaled unbiased form when ``policy_ratio`` is given."""
    log_ratio = reference_logprobs - policy_logprobs
    ratio = torch.exp(log_ratio)
    kl = ratio - log_ratio - 1
    if policy_ratio is not None:
        kl = policy_ratio * kl
    return kl


def off_policy_seq_mask(kl_per_token, advantages, loss_mask, delta=0.5):
    """The off-policy sequence mask: False for a sequence with a negative
    advantage AND a masked mean KL above ``delta``. Returns (B, 1) bool."""
    m = loss_mask.to(kl_per_token.dtype)
    mean_kl = (kl_per_token * m).sum(-1, keepdim=True) / m.sum(-1, keepdim=True).clamp_min(1)
    advantage_mask = advantages.reshape(-1, 1) >= 0
    kl_mask = mean_kl <= delta
    return advantage_mask | kl_mask


class GRPOLoss:
    """The GRPO-family losses."""

    @staticmethod
    def compute(
        policy_ratio,
        advantages,
        loss_mask,
        min_clip,
        max_clip,
        beta,
        kl_div,
        num_samples,
        max_gen=1,
        variant="grpo",
        off_policy_mask=None,
    ):
        if variant == "gspo":
            return GRPOLoss._gspo(policy_ratio, advantages, min_clip, max_clip, off_policy_mask)

        adv = advantages[:, None]
        if variant in ("grpo", "dapo", "dr_grpo"):
            surr = GRPOLoss._clipped_surrogate(policy_ratio, adv, min_clip, max_clip)
        elif variant == "sapo":
            surr = GRPOLoss._sapo_surrogate(policy_ratio, adv)
        else:
            raise ValueError(f"Unknown loss type: {variant}")

        if off_policy_mask is not None:
            surr = surr * off_policy_mask.to(surr.dtype)

        loss_per_token = -(surr - beta * kl_div)
        loss_per_token = loss_per_token * loss_mask.to(loss_per_token.dtype)
        return GRPOLoss._aggregate(loss_per_token, loss_mask, num_samples, max_gen, variant)

    @staticmethod
    def _clipped_surrogate(ratio, adv, min_clip, max_clip):
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - min_clip, 1 + max_clip) * adv
        return torch.minimum(unclipped, clipped)

    @staticmethod
    def _sapo_surrogate(ratio, adv, temp_pos_tokens=1.0, temp_neg_tokens=1.05):
        """SAPO's soft sigmoid gate with asymmetric temperatures (t_neg > t_pos)."""
        temps = torch.where(adv > 0, temp_pos_tokens, temp_neg_tokens)
        soft_gate = torch.sigmoid(temps * (ratio - 1)) * 4 / temps
        return soft_gate * adv

    @staticmethod
    def _gspo(masked_seq_ratio, advantages, min_clip, max_clip, off_policy_mask=None):
        surr = masked_seq_ratio * advantages
        clipped = torch.clamp(masked_seq_ratio, 1 - min_clip, 1 + max_clip) * advantages
        surr = torch.minimum(surr, clipped)
        if off_policy_mask is not None:
            surr = surr * off_policy_mask[..., 0].to(surr.dtype)
        return (-surr).mean()

    @staticmethod
    def _aggregate(loss_per_token, loss_mask, num_samples, max_gen, variant):
        m = loss_mask.to(loss_per_token.dtype)
        if variant in ("grpo", "sapo"):
            per_seq = loss_per_token.sum(-1) / m.sum(-1).clamp_min(1)
            per_group = per_seq.reshape(-1, num_samples).mean(1)
            return per_group.mean()
        if variant == "dapo":
            return loss_per_token.sum() / m.sum().clamp_min(1)
        if variant == "dr_grpo":
            return loss_per_token.sum() / (loss_per_token.shape[0] * max_gen)
        raise ValueError(f"Unknown loss type: {variant}")


# ------------------------------------------------------------- RLHF loop


def grpo_loss(model, cfg, params, exp, *, num_samples=1, variant="grpo", min_clip=0.2, max_clip=0.2, beta=0.04,
              max_gen=1, opsm_delta=None, unbiased_kl=False):
    """The update's (loss, masked mean KL) on an experience dict, differentiable in ``params``."""
    logits, _, _ = model.apply(params, cfg, exp["responses"], attn_mask=exp["attn_masks"])
    logprobs = log_probs_per_token(logits, exp["responses"])
    loss_mask = exp["reward_masks"][:, 1:]

    if variant == "gspo":
        new_seq = log_probs_per_seq(logprobs, loss_mask)
        old_seq = log_probs_per_seq(exp["old_logprobs"], loss_mask)
        ratio = torch.exp(new_seq - old_seq)
        kl = kl_div_per_token(logprobs, exp["ref_logprobs"])
    else:
        ratio = torch.exp(logprobs - exp["old_logprobs"])
        kl = kl_div_per_token(logprobs, exp["ref_logprobs"], policy_ratio=ratio if unbiased_kl else None)

    opm = None
    if opsm_delta is not None:
        opm = off_policy_seq_mask(
            kl_div_per_token(exp["old_logprobs"], logprobs), exp["advantages"], loss_mask, delta=opsm_delta
        )

    loss = GRPOLoss.compute(
        ratio, exp["advantages"], loss_mask, min_clip, max_clip, beta, kl,
        num_samples, max_gen=max_gen, variant=variant, off_policy_mask=opm,
    )
    m = loss_mask.to(kl.dtype)
    mean_kl = (kl * m).sum() / m.sum().clamp_min(1)
    return loss, mean_kl


def make_grpo_update_step(model, cfg, optimizer, *, num_samples=1, variant="grpo", min_clip=0.2,
                          max_clip=0.2, beta=0.04, max_gen=1, opsm_delta=None, unbiased_kl=False):
    """One GRPO policy update: (params, opt_state, exp) → (params,
    opt_state, metrics {"loss", "kl"}). exp: ``grpo_experience``'s dict
    (responses, attn_masks, reward_masks, advantages, old_logprobs,
    ref_logprobs)."""
    kw = dict(num_samples=num_samples, variant=variant, min_clip=min_clip, max_clip=max_clip, beta=beta,
              max_gen=max_gen, opsm_delta=opsm_delta, unbiased_kl=unbiased_kl)

    def update(params, opt_state, exp):
        with torch.enable_grad():
            loss, mean_kl = grpo_loss(model, cfg, params, exp, **kw)
            grads = torch.autograd.grad(loss, param_leaves(params), allow_unused=True, materialize_grads=True)
        opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), "kl": mean_kl.detach()}

    return update


def grpo_experience(
    model, cfg, policy_params, reference_params, prompt_batch, reward_fn, *,
    num_samples, max_gen, temp=1.0, top_k=None, eos_id=50256, pad_id=50256, generator=None,
    dr_grpo=None, use_phantom_reward=False,
):
    """Sampling and scoring. Each prompt of ``prompt_batch``
    (``prompt_collator``'s) is sampled ``num_samples`` times (rows of a
    group adjacent) through ``generate_batched_kv_cache``, drawing from
    ``generator`` (default: one seeded 0 on the policy's device); the
    policy's and the reference's log-probabilities are taken without
    gradients. reward_fn(responses, reward_masks, attn_masks) → (B,)
    rewards on the device: a reward-model readout for RLHF, the verifier
    for RLVR, prefix matching for RPT. Returns the dict
    ``make_grpo_update_step`` takes, with "rewards"."""
    device = device_of(policy_params)
    prompts = torch.as_tensor(np.asarray(prompt_batch["padded_prompts"]), device=device)
    masks = torch.as_tensor(np.asarray(prompt_batch["prompt_masks"]), device=device)
    prompts = prompts.repeat_interleave(num_samples, 0)
    masks = masks.repeat_interleave(num_samples, 0)
    if generator is None and temp > 0:
        generator = torch.Generator(device=device).manual_seed(0)

    out = gen.generate_batched_kv_cache(
        model, policy_params, cfg, prompts, masks, max_gen=max_gen, temp=temp, top_k=top_k,
        eos_ids=eos_id, pad_id=pad_id, generator=generator,
    )
    sequences = out["sequences"].clone()  # a normal tensor: the generation ran in inference mode
    coll = batched_responses_collator(sequences, masks, eos_ids=eos_id, pad_token_id=pad_id)
    responses, attn_masks, reward_masks = coll["padded_responses"], coll["attn_masks"], coll["reward_masks"]

    with torch.no_grad():
        old_logits, _, _ = model.apply(policy_params, cfg, responses, attn_mask=attn_masks)
        old_logprobs = log_probs_per_token(old_logits, responses)
        del old_logits
        ref_logits, _, _ = model.apply(reference_params, cfg, responses, attn_mask=attn_masks)
        ref_logprobs = log_probs_per_token(ref_logits, responses)
        del ref_logits
        rewards = reward_fn(responses, reward_masks, attn_masks)
    rewards = torch.as_tensor(rewards, device=device)
    advantages = z_scores(rewards, num_samples, dr_grpo, use_phantom_reward=use_phantom_reward)

    return {
        "responses": responses,
        "attn_masks": attn_masks,
        "reward_masks": reward_masks,
        "advantages": advantages,
        "old_logprobs": old_logprobs,
        "ref_logprobs": ref_logprobs,
        "rewards": rewards,
    }


def rlhf_grpo_training_loop(
    model, cfg, policy_params, reference_params, rm_params, rm_cfg, prompt_batches, *,
    num_epochs=1, num_samples=4, max_gen=32, num_grad_updates=2, lr=1e-6, variant="grpo",
    min_clip=0.2, max_clip=0.2, beta=0.04, temp=1.0, top_k=None, eos_id=50256, pad_id=50256,
    readout="scores_mean_pooling", generator=None, log=print, evaluator=None,
):
    """The RLHF loop: for each prompt batch, sample and score against the
    reward model, then ``num_grad_updates`` updates of the policy (in
    place). Returns (policy_params, metrics list of {"loss", "kl",
    "reward"[, "best"]})."""
    optimizer = adamw(lr)
    opt_state = optimizer.init(policy_params)
    update = make_grpo_update_step(
        model, cfg, optimizer, variant=variant, min_clip=min_clip, max_clip=max_clip,
        beta=beta, max_gen=max_gen,
    )
    if generator is None and temp > 0:
        generator = torch.Generator(device=device_of(policy_params)).manual_seed(0)

    def reward_fn(responses, reward_masks, attn_masks):
        return reward_model_apply(
            rm_params, rm_cfg, responses, attn_mask=attn_masks, reward_mask=reward_masks, readout=readout
        )

    metrics = []
    for epoch in range(1, num_epochs + 1):
        for batch in prompt_batches:
            exp = grpo_experience(
                model, cfg, policy_params, reference_params, batch, reward_fn,
                num_samples=num_samples, max_gen=max_gen, temp=temp, top_k=top_k,
                eos_id=eos_id, pad_id=pad_id, generator=generator,
            )
            for _ in range(num_grad_updates):
                policy_params, opt_state, m = update(policy_params, opt_state, exp)
            entry = {"loss": float(m["loss"]), "kl": float(m["kl"]), "reward": float(exp["rewards"].mean())}
            metrics.append(entry)
            log(f"Epoch {epoch} | loss {entry['loss']:.4f} | reward {entry['reward']:.3f} | kl {entry['kl']:.4f}")
            if evaluator is not None and evaluator.is_rlhf_grpo_best(entry["kl"], entry["reward"]):
                metrics[-1]["best"] = True
    return policy_params, metrics


def grpo_evaluate(model, cfg, policy_params, reference_params, prompt_batches, reward_fn, *,
                  num_samples, max_gen, temp=1.0, top_k=None, eos_id=50256, pad_id=50256, generator=None):
    """Generate, then the mean reward and the masked mean K3 KL of the
    policy against the reference. Returns (mean_reward, mean_kl)."""
    if generator is None and temp > 0:
        generator = torch.Generator(device=device_of(policy_params)).manual_seed(0)
    tot_r, tot_kl, n = 0.0, 0.0, 0
    for batch in prompt_batches:
        exp = grpo_experience(
            model, cfg, policy_params, reference_params, batch, reward_fn,
            num_samples=num_samples, max_gen=max_gen, temp=temp, top_k=top_k,
            eos_id=eos_id, pad_id=pad_id, generator=generator,
        )
        kl = kl_div_per_token(exp["old_logprobs"], exp["ref_logprobs"])
        m = exp["reward_masks"][:, 1:].to(kl.dtype)
        tot_kl += float((kl * m).sum() / m.sum().clamp_min(1))
        tot_r += float(exp["rewards"].float().mean())
        n += 1
    return tot_r / max(n, 1), tot_kl / max(n, 1)
