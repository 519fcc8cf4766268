"""Logit samplers: temperature, top-k, top-p (nucleus), min-p (counterpart
of ``llm_quest_tpu/ops/sampling.py``; the per-row serving sampler waits for
the serving port).

temp = 0 is greedy argmax (first index of the maximum). Otherwise
softmax(logits/temp) is filtered, renormalized and sampled with an explicit
``torch.Generator``. top_p and min_p are mutually exclusive; top_k composes
with top_p (pre-filter) and with min_p (as min_tokens_to_keep). top-k keeps
everything ≥ the k-th largest probability; top-p keeps the pivot token that
crosses the threshold.
"""

import torch


def top_k_filter(probs, k):
    kth = torch.topk(probs, k, dim=-1).values[..., -1:]
    return torch.where(probs < kth, torch.zeros_like(probs), probs)


def top_p_filter(probs, p, top_k=None):
    if top_k:
        probs = top_k_filter(probs, top_k)
    sorted_probs, sort_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    over = torch.cumsum(sorted_probs, dim=-1) > p
    # shift right: the pivot token (first to cross p) is kept; slot 0 always kept
    over = torch.cat([torch.zeros_like(over[..., :1]), over[..., :-1]], dim=-1)
    sorted_filtered = torch.where(over, torch.zeros_like(sorted_probs), sorted_probs)
    return torch.empty_like(probs).scatter_(-1, sort_idx, sorted_filtered)


def min_p_filter(probs, min_p, min_tokens_to_keep=1):
    p_max = probs.amax(dim=-1, keepdim=True)
    kth = torch.topk(probs, min_tokens_to_keep, dim=-1).values[..., -1:]
    remove = (probs < min_p * p_max) & (probs < kth)
    return torch.where(remove, torch.zeros_like(probs), probs)


def filter_probs(probs, *, top_k=None, top_p=None, min_p=None):
    """Apply the configured filters to a probability tensor (..., v)."""
    if top_p is not None and min_p is not None:
        raise ValueError("Cannot use top_p and min_p together")
    if min_p:
        probs = min_p_filter(probs, min_p, min_tokens_to_keep=1 if top_k is None else top_k)
    elif top_p:
        probs = top_p_filter(probs, top_p, top_k)
    elif top_k:
        probs = top_k_filter(probs, top_k)
    return probs / probs.sum(dim=-1, keepdim=True)


def sampling(generator, logits, *, top_k=None, top_p=None, min_p=None, temp=0.0):
    """Sample next-token ids from (..., v) logits → (...,) int64."""
    if temp == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / temp, dim=-1)
    probs = filter_probs(probs, top_k=top_k, top_p=top_p, min_p=min_p)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(probs.shape[:-1])
