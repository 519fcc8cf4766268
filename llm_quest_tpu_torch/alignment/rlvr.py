"""RLVR: GRPO with verifiable rewards (counterpart of
``llm_quest_tpu/alignment/rlvr.py``).

- ``VerifiableRewardCalculator``: decode each response on the host, take its
  <answer> after the last </think>, sanitize both numbers and compare them
  as floats: good / wrong / unfinished rewards (10 / 0 / -1 by default);
- ``rlvr_prompt_collator``: ``grpo.prompt_collator`` carrying the gold
  answer strings;
- ``rlvr_grpo_training_loop``: the RLHF loop with the verifier in place of
  the reward model, an LR schedule (warm-up from peak / 10,
  ``training/engine.py::make_lr_schedule``), the off-policy sequence mask
  and the phantom reward.

The verifier runs on the host between sampling and the update, where JAX's
does; its rewards go back to the policy's device.
"""

import numpy as np
import torch

from llm_quest_tpu_torch.alignment import grpo
from llm_quest_tpu_torch.training.engine import adamw, device_of, make_lr_schedule
from llm_quest_tpu_torch.utils import ResponseExtractor


def decode_rows(tokenizer, response_ids, pad_token_id):
    """Each row of a (B, S) id array or tensor decoded, its pads dropped."""
    rows = response_ids.detach().cpu().numpy() if torch.is_tensor(response_ids) else np.asarray(response_ids)
    return [tokenizer.decode([int(t) for t in row if int(t) != pad_token_id]) for row in rows]


def host_rewards(rewards, response_ids):
    """A list of float rewards as an fp32 tensor on the responses' device (the CPU for numpy)."""
    device = response_ids.device if torch.is_tensor(response_ids) else "cpu"
    return torch.tensor(rewards, dtype=torch.float32, device=device)


class VerifiableRewardCalculator:
    """A GSM8K-style verifier on the host."""

    def __init__(
        self,
        tokenizer,
        good_answer_reward=10.0,
        wrong_answer_reward=0.0,
        unfinished_answer_reward=-1.0,
        reasoning_weight=0.0,
        pad_token_id=50256,
    ):
        assert wrong_answer_reward <= 0, "wrong_answer_reward should be ≤ 0"
        assert unfinished_answer_reward <= 0, "unfinished_answer_reward should be ≤ 0"
        self.tokenizer = tokenizer
        self.good_answer_reward = good_answer_reward
        self.wrong_answer_reward = wrong_answer_reward
        self.unfinished_answer_reward = unfinished_answer_reward
        self.reasoning_weight = reasoning_weight
        self.pad_token_id = pad_token_id

    def _decode(self, response_ids):
        return decode_rows(self.tokenizer, response_ids, self.pad_token_id)

    def _calc_answer_reward(self, response_strings, correct_answers):
        rewards = []
        for response, correct in zip(response_strings, correct_answers):
            raw = ResponseExtractor.get_answer(response)
            model_ans = ResponseExtractor.sanitize_answer(raw)
            correct_ans = ResponseExtractor.sanitize_answer(correct)
            if model_ans is None:
                rewards.append(self.unfinished_answer_reward)
                continue
            try:
                rewards.append(
                    self.good_answer_reward if float(model_ans) == float(correct_ans) else self.wrong_answer_reward
                )
            except (ValueError, TypeError):
                rewards.append(self.wrong_answer_reward)
        return rewards

    def __call__(self, model_responses, correct_answers):
        """(B,) fp32 rewards on the responses' device."""
        decoded = self._decode(model_responses)
        return host_rewards(self._calc_answer_reward(decoded, correct_answers), model_responses)


def rlvr_prompt_collator(batch, pad_token_id=50256, custom_max_length=None):
    """``grpo.prompt_collator`` of batch's prompts, with "answers" (each
    item's "answer", or its "labels" for RPT). batch: list of {"prompt":
    ids, "answer" | "labels": str}."""
    prompts = [item["prompt"] for item in batch]
    answers = [item.get("answer", item.get("labels")) for item in batch]
    out = grpo.prompt_collator(prompts, pad_token_id, custom_max_length)
    out["answers"] = answers
    return out


def rlvr_grpo_training_loop(
    model, cfg, policy_params, reference_params, prompt_batches, reward_calculator, *,
    num_epochs=1, num_samples=4, max_gen=128, num_grad_updates=2, peak_lr=1e-6, warmup_steps=0,
    min_lr=None, decay=None, variant="grpo", min_clip=0.2, max_clip=0.2, beta=0.04, temp=1.0,
    top_k=None, eos_id=50256, pad_id=50256, opsm_delta=None, generator=None, log=print, evaluator=None,
    use_phantom_reward=False,
):
    """Train the policy in place. prompt_batches: ``rlvr_prompt_collator``
    outputs; ``reward_calculator(responses, answers)`` scores the response
    tokens alone (the prompt and pads replaced by ``pad_id``). Returns
    (policy_params, metrics list)."""
    total_steps = len(prompt_batches) * num_epochs * num_grad_updates
    schedule = make_lr_schedule(total_steps, peak_lr / 10, peak_lr, warmup_steps, min_lr, decay)
    optimizer = adamw(schedule)
    opt_state = optimizer.init(policy_params)
    update = grpo.make_grpo_update_step(
        model, cfg, optimizer, variant=variant, min_clip=min_clip, max_clip=max_clip, beta=beta,
        max_gen=max_gen, opsm_delta=opsm_delta,
    )
    if generator is None and temp > 0:
        generator = torch.Generator(device=device_of(policy_params)).manual_seed(0)

    metrics = []
    for epoch in range(1, num_epochs + 1):
        for batch in prompt_batches:
            answers = [a for a in batch["answers"] for _ in range(num_samples)]  # repeat-interleave

            def reward_fn(responses, reward_masks, attn_masks, answers=answers):
                resp_only = torch.where(reward_masks, responses, pad_id)  # only the response is decoded
                return reward_calculator(resp_only, answers)

            exp = grpo.grpo_experience(
                model, cfg, policy_params, reference_params, batch, reward_fn,
                num_samples=num_samples, max_gen=max_gen, temp=temp, top_k=top_k,
                eos_id=eos_id, pad_id=pad_id, generator=generator,
                dr_grpo=variant if variant == "dr_grpo" else None,
                use_phantom_reward=use_phantom_reward,
            )
            for _ in range(num_grad_updates):
                policy_params, opt_state, m = update(policy_params, opt_state, exp)
            entry = {"loss": float(m["loss"]), "kl": float(m["kl"]), "reward": float(exp["rewards"].mean())}
            metrics.append(entry)
            log(f"Epoch {epoch} | loss {entry['loss']:.4f} | reward {entry['reward']:.3f} | kl {entry['kl']:.4f}")
            if evaluator is not None and evaluator.is_rlvr_grpo_best(entry["kl"], entry["reward"]):
                metrics[-1]["best"] = True
    return policy_params, metrics
