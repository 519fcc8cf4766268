"""Text and format helpers, answer extraction, entropy buckets and
checkpoint gating (counterpart of ``llm_quest_tpu/utils.py``).

The port keeps its own copy: it imports nothing of the JAX package.

- ``time_it``, ``text_to_ids`` / ``ids_to_text``;
- ``alpaca_prompt_format`` and ``alpaca_deepseek_format`` (GSM8K into
  DeepSeek-R1's <think>/<answer> form);
- ``ResponseExtractor``: the <think>/<answer> regexes and the number
  sanitizer (US and EU thousand separators, decimal commas);
- ``EntropyFilteredTokens``: token positions bucketed by the Shannon entropy
  of their top-k predictions; the logits are torch tensors (on any device),
  the buckets host lists, as JAX's;
- ``CheckpointEvaluator``: best-checkpoint gating for RLHF/RLVR (score =
  reward - beta * KL under thresholds) and for the reward model (accuracy
  and validation loss).
"""

import functools
import re
import time

import numpy as np
import torch


def time_it(func):
    """Prints the execution time of the decorated function."""

    @functools.wraps(func)
    def wrapper_timer(*args, **kwargs):
        start = time.perf_counter()
        value = func(*args, **kwargs)
        print(f"Finished {func.__name__!r} in {time.perf_counter() - start:.4f} secs")
        return value

    return wrapper_timer


def text_to_ids(text, tokenizer):
    """text → (1, s) int32 numpy ids (tiktoken-compatible)."""
    try:
        encoded = tokenizer.encode(text, allowed_special={"<|endoftext|>"})
    except TypeError:
        encoded = tokenizer.encode(text)
    return np.asarray(encoded, dtype=np.int32)[None, :]


def ids_to_text(ids, tokenizer):
    """(s,) or (1, s) ids (numpy, list or tensor) → text."""
    ids = ids.detach().cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
    if ids.ndim == 2:
        ids = ids[0]
    return tokenizer.decode(ids.tolist())


def alpaca_prompt_format(entry, include_output=True):
    """The Alpaca instruction format; with ``include_output`` False, the
    prompt up to and including "### Response:\\n"."""
    instruction_txt = (
        "Below is an instruction that describes a task. Write a response that appropriately completes the request."
        "\n\n### Instruction:"
        f"\n{entry['instruction']}"
    )
    input_txt = f"\n\n### Input:\n{entry['input']}" if entry.get("input") else ""
    if not include_output:
        return instruction_txt + input_txt + "\n\n### Response:\n"
    output_txt = f"\n\n### Response:\n{entry['output']}" if entry.get("output") else ""
    return instruction_txt + input_txt + output_txt


def alpaca_deepseek_format(entry, include_response=True):
    """A GSM8K entry ({"question", "answer"}) in the Alpaca instruction form
    with a DeepSeek-R1 <think>reasoning</think><answer>final</answer>
    response (the answer split at its last "####")."""
    instruction_txt = (
        "Below is an instruction that describes a task. Write a response that appropriately completes the request."
        "\n\n### Instruction:"
        f"\n{entry['question']}"
    )
    if not include_response:
        return instruction_txt + "\n\n### Response:\n"

    answer = entry["answer"]
    if "####" in answer:
        reasoning, _, final = answer.rpartition("####")
        reasoning, final = reasoning.strip(), final.strip()
    else:
        reasoning, final = "", answer.strip()
    response_txt = f"\n\n### Response:\n<think>\n{reasoning}\n</think>\n<answer>\n{final}\n</answer>"
    return instruction_txt + response_txt


class ResponseExtractor:
    """Regex extraction of the reasoning and the answer of a response."""

    REASONING_PATTERN = re.compile(r"<think>(.*?)</think>", re.DOTALL)
    ANSWER_PATTERN = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)
    NUMBER_PATTERN = re.compile(r"[-+]?\s*\d*\.?\d+")
    THOUSAND_SEP_PATTERN = re.compile(r"[,.](?=\d{3})")

    @classmethod
    def get_reasoning(cls, response):
        matches = re.findall(cls.REASONING_PATTERN, response)
        return matches[-1].strip() if matches else None

    @classmethod
    def get_answer(cls, response):
        """The last <answer> after the last </think>; None for a response
        with no </think> (unfinished reasoning) or no answer after it."""
        if "</think>" not in response:
            return None
        response = response.rsplit("</think>", 1)[-1]
        matches = re.findall(cls.ANSWER_PATTERN, response)
        return matches[-1] if matches else None

    @classmethod
    def sanitize_answer(cls, answer):
        """Strip, drop US/EU thousand separators, read a decimal comma as a
        point, and return the first number (its inner spaces removed)."""
        if not answer:
            return None
        s = answer.strip()
        s = re.sub(cls.THOUSAND_SEP_PATTERN, "", s)
        s = s.replace(",", ".")
        m = re.search(cls.NUMBER_PATTERN, s)
        return m.group(0).replace(" ", "") if m else None


class EntropyFilteredTokens:
    """Token positions bucketed by the entropy of their top-k predictions:
    "hard" above ``high``, "medium" above ``mid``, "easy" above ``low`` (a
    position above ``high`` lands in all three, as in JAX). Pads are left
    out. The entropy is computed in fp32 on the logits' device; the buckets
    are host lists of [global sample index, position]."""

    def __init__(self, top_k=16, low=0.5, mid=1.0, high=1.5, pad_token=50256):
        self.top_k = top_k
        self.pad_token = pad_token
        self.threshold = {"hard": high, "medium": mid, "easy": low}
        self.hard_indices, self.medium_indices, self.easy_indices = [], [], []

    @torch.no_grad()
    def process_batch(self, logits, input_ids, global_sample_indices):
        """logits: (b, s, v) tensor; input_ids: (b, s); global_sample_indices: (b,)."""
        logits = logits.float()
        input_ids = input_ids if torch.is_tensor(input_ids) else torch.as_tensor(np.asarray(input_ids))
        global_sample_indices = np.asarray(torch.as_tensor(global_sample_indices).cpu())
        not_pad = input_ids.to(logits.device) != self.pad_token

        topk = torch.sort(logits, dim=-1).values[..., -self.top_k:]
        topk = topk - topk.max(dim=-1, keepdim=True).values
        probs = torch.exp(topk)
        probs = probs / probs.sum(dim=-1, keepdim=True)
        entropy = -torch.sum(probs * torch.log(probs + 1e-20), dim=-1)

        buckets = {"hard": self.hard_indices, "medium": self.medium_indices, "easy": self.easy_indices}
        for difficulty, threshold in self.threshold.items():
            mask = ((entropy > threshold) & not_pad).cpu().numpy()
            b_idx, t_idx = np.where(mask)
            if len(b_idx):
                pairs = np.stack([global_sample_indices[b_idx], t_idx], axis=1)
                buckets[difficulty].extend(pairs.tolist())

    def get_difficulty_indices(self):
        return {"hard": self.hard_indices, "medium": self.medium_indices, "easy": self.easy_indices}


class CheckpointEvaluator:
    """Best-checkpoint gating."""

    def __init__(
        self,
        kl_div_threshold=0.5,
        min_reward_threshold=6.0,
        beta=1.0,
        rm_min_accuracy_threshold=0.9,
        rm_min_val_loss_threshold=0.1,
    ):
        self.kl_div_threshold = kl_div_threshold
        self.min_reward_threshold = min_reward_threshold
        self.beta = beta
        self.max_score_grpo = float("-inf")
        self.max_accu_pref_rm = float("-inf")
        self.rm_min_accuracy_threshold = rm_min_accuracy_threshold
        self.rm_min_val_loss_threshold = rm_min_val_loss_threshold

    def is_rlhf_grpo_best(self, kl_div, reward):
        """Gated score = reward - beta * KL; must beat the running max."""
        if kl_div > self.kl_div_threshold or reward < self.min_reward_threshold:
            return False
        score = reward - self.beta * kl_div
        if score > self.max_score_grpo:
            self.max_score_grpo = score
            return True
        return False

    def is_rm_accu_best(self, accuracy, val_loss):
        if accuracy < self.rm_min_accuracy_threshold or val_loss > self.rm_min_val_loss_threshold:
            return False
        if accuracy > self.max_accu_pref_rm:
            self.max_accu_pref_rm = accuracy
            return True
        return False

    def is_rlvr_grpo_best(self, kl_div, reward):
        return self.is_rlhf_grpo_best(kl_div, reward)
