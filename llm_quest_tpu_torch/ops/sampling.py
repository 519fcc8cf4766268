"""Logit samplers: temperature, top-k, top-p (nucleus), min-p (counterpart
of ``llm_quest_tpu/ops/sampling.py``).

temp = 0 is greedy argmax (first index of the maximum). Otherwise
softmax(logits/temp) is filtered, renormalized and sampled with an explicit
``torch.Generator``. top_p and min_p are mutually exclusive; top_k composes
with top_p (pre-filter) and with min_p (as min_tokens_to_keep). top-k keeps
everything ≥ the k-th largest probability; top-p keeps the pivot token that
crosses the threshold.

``sampling_per_row`` takes every knob as a (b,) tensor, so one decode step
serves requests with different samplers (continuous-batching serving). Its
filter works by thresholds read from an exact ``torch.topk`` head (JAX uses
the TPU's approximate top-k there). Divergence by design: the head is at
least the largest top-k of the call, so a per-row top_k above 1024 keeps
exactly its k tokens, where JAX clamps it to the 1024-entry head.
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


def sampling(generator, logits, *, top_k=None, top_p=None, min_p=None, temp=0.0, checked=True):
    """Sample next-token ids from (..., v) logits → (...,) int64. With
    ``checked`` the draw is ``torch.multinomial``'s, which raises on inf,
    NaN or negative probabilities (a host read of the device); without it
    the same token comes from ``draw``, unchecked and with no host read
    (the serving engine's decode steps)."""
    if temp == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / temp, dim=-1)
    probs = filter_probs(probs, top_k=top_k, top_p=top_p, min_p=min_p)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)[:, 0] if checked else draw(generator, flat)
    return ids.reshape(probs.shape[:-1])


def filter_probs_per_row(probs, *, top_k, top_p, min_p=None, head=1024, max_top_k=None):
    """``filter_probs`` with per-row knobs (b,) over (b, ..., v) probabilities
    (middle axes share their row's knobs), then renormalized. Disable
    encodings: top_k 0, top_p >= 1, min_p 0. Under min-p the hard top-k cut
    is off and top_k becomes min_tokens_to_keep (at least 1); top-p keeps the
    pivot token.

    Every filter is a per-row probability threshold read from the sorted
    ``torch.topk`` head of ``max(head, max_top_k)`` entries (capped at the
    vocabulary), then one compare over the vocabulary. A row whose nucleus
    is wider than the head keeps everything; tokens tying a threshold are
    all kept. ``max_top_k`` is the largest top_k of the call; it is read from
    the device when not given (the serving engine knows it on the host)."""
    v = probs.shape[-1]
    if max_top_k is None:
        max_top_k = int(top_k.max()) if top_k.numel() else 0
    h = min(max(head, max_top_k), v)
    mid = (1,) * (probs.ndim - 2)

    def col(a):
        return a.reshape(a.shape[:1] + mid + (1,))

    top_k = top_k.long()
    top_p = top_p.float()
    min_p = torch.zeros_like(top_p) if min_p is None else min_p.float()
    head_vals = torch.topk(probs, h, dim=-1).values  # (b, ..., h), descending

    def at_head(pos):  # per-row head position (b,) -> head value (b, ..., 1)
        return torch.gather(head_vals, -1, col(pos.clamp(0, h - 1)).expand(*probs.shape[:-1], 1))

    kth = at_head(top_k - 1)
    keep = torch.where(col((top_k > 0) & (min_p <= 0)), probs >= kth, True)

    cum = torch.cumsum(head_vals, dim=-1)
    # the pivot (the first sorted position whose cumulative crosses p) is
    # kept: n_keep counts the positions whose shifted cumulative is <= p
    shifted = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=-1)
    n_keep = (shifted <= col(top_p)).sum(dim=-1, keepdim=True)
    thr_p = torch.gather(head_vals, -1, n_keep - 1)
    thr_p = torch.where(cum[..., -1:] > col(top_p), thr_p, 0.0)  # nucleus wider than the head: keep all
    keep &= torch.where(col(top_p < 1.0), probs >= thr_p, True)

    mtk_th = at_head(top_k.clamp_min(1) - 1)
    keep_m = (probs >= col(min_p) * head_vals[..., :1]) | (probs >= mtk_th)
    keep &= torch.where(col(min_p > 0), keep_m, True)

    probs = torch.where(keep, probs, 0.0)
    return probs / probs.sum(dim=-1, keepdim=True)


def draw(generator, probs):
    """One token per row of (n, v) ``probs``, as ``torch.multinomial(probs,
    1)`` draws it (the argmax of probs / Exp(1) noise), without its host
    read of the probabilities' range."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / q).argmax(dim=-1)


def sampling_per_row(generator, logits, *, temp, top_k, top_p, min_p, max_top_k=None):
    """Per-row sampling of (b, v) logits: every knob is a (b,) tensor. temp
    0 is greedy on the raw logits; otherwise softmax(logits / temp) filtered
    by ``filter_probs_per_row`` and drawn from ``generator``. With uniform
    rows the draws equal ``sampling``'s under the same generator state (the
    same probabilities, the same draw)."""
    temp = temp.float()
    t_eff = torch.where(temp > 0, temp, 1.0)[:, None]
    probs = torch.softmax(logits.float() / t_eff, dim=-1)
    probs = filter_probs_per_row(probs, top_k=top_k, top_p=top_p, min_p=min_p, max_top_k=max_top_k)
    return torch.where(temp > 0, draw(generator, probs), logits.argmax(dim=-1))
