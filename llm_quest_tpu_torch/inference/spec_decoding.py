"""Speculative decoding (counterpart of ``llm_quest_tpu/inference/spec_decoding.py``).

Behaviour of the reference (speculative_decoding/spec_decoding_engine.py):

- greedy: accept drafted token i iff the target's argmax there equals it; on
  the first mismatch the target's choice replaces it;
- stochastic: accept with probability min(1, p/q) on the temperature/top-k/
  top-p modified distributions; on a rejection resample from
  norm(max(0, p − q)); when all γ are accepted, the bonus token comes from
  the target's γ+1-th distribution;
- γ drafted tokens a step; EOS stops the loop.

Both models run cached with fixed (γ+1)-token windows, as in JAX: a window
re-feeds the last committed token at column cur_len − 1, so a rejected
draft needs no rollback of a KV cache (the next window overwrites its K/V,
and columns past the committed length are causally masked). The acceptance
length n is a cumulative product, and the γ+1 candidates [accepted…,
correction | bonus, junk…] are written at once; cur_len advances by n + 1.

A recurrent cache (the GDN state and conv taps of Qwen3.5 and Qwen3-Next)
advances with every token fed, the re-fed one and the rejected drafts
included, so it is rolled back (``draft_and_verify``). The invariant: at the
start of a window each row's state holds exactly the tokens before the one
the window re-feeds. The draft's state, which its steps advance in place
(K2), is copied before the window; the target's verify (one K1 call a GDN
layer) leaves its state as it was. Both models record each GDN layer's
window inputs in the cache (``ops/gdn.py::WINDOW``), and once the caller's
final counts are known each pool is advanced from the state before the
window over each row's first count tokens (the re-fed token and the
accepted drafts; the correction or bonus is fed by the next window), the
rest frozen as pads are (``ops/gdn.py::roll_window``: one K1 call a GDN
layer). JAX's windows keep every token fed and give such models other
tokens than plain decoding (ROADMAP.md, reference faults fixed by design).

Divergence by design: the draft is also fed its last drafted token (output
discarded), as JAX's serving engine does (``serving.py:861-870``) and JAX's
``speculative_generate`` does not. Without it the draft cache keeps a stale
column where a fully accepted window's last draft sits, and even a perfect
draft is then rejected in some later window (JAX takes 4 windows where
⌈15 / 5⌉ = 3 suffice at γ 4 on the tests' dense Qwen3). Tokens are the
same either way: greedy speculation is lossless.
"""

import torch

from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.inference.generate import _is_eos
from llm_quest_tpu_torch.ops import gdn as gdn_ops
from llm_quest_tpu_torch.ops.sampling import draw, filter_probs


def modified_probs(logits, *, top_k=None, top_p=None, temp=1.0):
    """softmax(logits / temp) in fp32, filtered by top-k / top-p and
    renormalized (reference: get_modified_distrib :7-41)."""
    logits = logits.float()
    if temp > 0.0:
        logits = logits / temp
    probs = torch.softmax(logits, dim=-1)
    if top_p or top_k:
        probs = filter_probs(probs, top_k=top_k, top_p=top_p)
    return probs / probs.sum(dim=-1, keepdim=True)


def accepted_length(accept):
    """(b, γ) accept flags → (b,) length of each row's accepted prefix."""
    return accept.long().cumprod(dim=1).sum(dim=1)


def accept_greedy(t_logits, drafted):
    """Exact-match acceptance: t_logits (b, γ+1, v) of the window, drafted
    (b, γ). Returns (n (b,), the target's token at row position n (b,): the
    correction, or the bonus where n = γ)."""
    g = drafted.shape[1]
    choice = t_logits.argmax(dim=-1)
    n = accepted_length(choice[:, :g] == drafted)
    return n, choice.gather(1, n[:, None])[:, 0]


def accept_window(generator, t_probs, d_probs, drafted):
    """Stochastic acceptance of one window. t_probs (b, γ+1, v): the target's
    modified distributions over the window; d_probs (b, γ, v): the draft's,
    from which ``drafted`` (b, γ) was drawn. Draft i is accepted when u <
    p/q (u uniform); each position's correction is drawn from norm(max(0,
    p − q)), the bonus from t_probs[:, γ]. Returns (n (b,), the token at row
    position n (b,)): the first committed token after the window's
    accepted prefix is distributed as t_probs (the property that makes the
    scheme lossless)."""
    b, g = drafted.shape
    p_tok = t_probs[:, :g].gather(2, drafted[..., None])[..., 0]
    q_tok = d_probs.gather(2, drafted[..., None])[..., 0]
    ratio = p_tok / q_tok.clamp_min(1e-20)
    accept = torch.rand(ratio.shape, generator=generator, device=ratio.device) < ratio
    adjusted = (t_probs[:, :g] - d_probs).clamp_min(0.0)
    adjusted = adjusted / adjusted.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    # per-position resamples and the bonus, picked at row position n
    pool = torch.cat([adjusted, t_probs[:, g:]], dim=1)
    corr = draw(generator, pool.reshape(b * (g + 1), -1)).reshape(b, g + 1)
    n = accepted_length(accept)
    return n, corr.gather(1, n[:, None])[:, 0]


def window_tokens(drafted, n, corr, eos, junk):
    """A window's γ + 1 candidates per row, [accepted drafts, the correction
    or bonus ``corr`` at position n, ``junk``…], and each row's count n + 1
    cut at the first of the 1-d ``eos`` ids among them (that EOS included).
    Returns (candidates (b, γ+1), counts (b,), whether an EOS was hit (b,))."""
    idx = torch.arange(drafted.shape[1] + 1, device=drafted.device)
    pad = torch.cat([drafted, torch.zeros_like(drafted[:, :1])], dim=1)
    cand = torch.where(idx < n[:, None], pad, torch.where(idx == n[:, None], corr[:, None], junk))
    is_eos = _is_eos(cand, eos) & (idx <= n[:, None])
    any_eos = is_eos.any(dim=1)
    return cand, torch.where(any_eos, is_eos.int().argmax(dim=1) + 1, n + 1), any_eos


def draft_and_verify(target, draft, last_tok, colm1, gamma, *, propose, accept, eos, junk, cap=None, mask=None,
                     pos0=None):
    """One draft-and-verify window (module docstring), the one both
    ``speculative_generate`` and the serving engine run. ``target`` and
    ``draft``: (model, params, cfg, cache) each; ``last_tok`` (b,): the
    last committed token, fed at cache column ``colm1`` (b,).

    γ draft steps, each token from ``propose(logits (b, v))`` → (token (b,),
    its distribution (b, v), or None when greedy), and the last draft fed
    too (its output unused); one target forward over [last_tok, drafted]
    at ``colm1``, row i predicting the token after window[i]; then
    ``accept(t_logits (b, γ+1, v), drafted (b, γ), d_probs (b, γ, v) or
    None)`` → (n (b,), the token at row position n (b,)) and
    ``window_tokens`` (``eos``, ``junk``); ``cap(counts (b,))`` gives the
    caller's final counts (its budget; None: the counts as they are). A
    recurrent cache is rolled back to each row's final count (module
    docstring). The caller advances its columns.

    ``mask`` (b, L): the keys valid for both forwards, and ``pos0`` (b,):
    ``last_tok``'s position, for a ragged pool (the serving engine); None
    for both: one sequence, the caches' causal mask and their columns as
    positions. Returns (candidates (b, γ+1), counts (b,), whether an EOS was
    hit (b,), the target's cache, the draft's)."""
    t_model, t_params, t_cfg, t_cache = target
    d_model, d_params, d_cfg, d_cache = draft
    # the draft's steps advance its state in place: kept for the rollback
    before = None
    if gdn_ops.has_gdn_state(d_cache):
        before = {n: d_cache[n].clone() for n in gdn_ops.state_leaves(d_cache)}
    for cache in (t_cache, d_cache):
        if gdn_ops.has_gdn_state(cache):
            cache[gdn_ops.WINDOW] = {}
    steps = torch.arange(gamma + 1, device=colm1.device)
    tok, drafted, d_probs = last_tok, [], []
    for t in range(gamma + 1):  # γ drafts, then the last one fed too (its output unused)
        d_cache["pos"] = colm1 + t
        logits, d_cache, _ = d_model.apply(d_params, d_cfg, tok[:, None], attn_mask=mask, cache=d_cache,
                                           position_ids=None if pos0 is None else (pos0 + t)[:, None])
        if t == gamma:
            break
        tok, probs = propose(logits[:, 0])
        drafted.append(tok)
        if probs is not None:
            d_probs.append(probs)
    drafted = torch.stack(drafted, dim=1)  # (b, γ)
    t_cache["pos"] = colm1
    t_logits, t_cache, _ = t_model.apply(
        t_params, t_cfg, torch.cat([last_tok[:, None], drafted], dim=1), attn_mask=mask, cache=t_cache,
        position_ids=None if pos0 is None else pos0[:, None] + steps[None],
    )
    n, corr = accept(t_logits, drafted, torch.stack(d_probs, dim=1) if d_probs else None)
    cand, counts, any_eos = window_tokens(drafted, n, corr, eos, junk)
    if cap is not None:
        counts = cap(counts)
    if gdn_ops.WINDOW in t_cache:
        gdn_ops.roll_window(t_cfg, t_cache, counts)
    if gdn_ops.WINDOW in d_cache:
        gdn_ops.roll_window(d_cfg, d_cache, counts, before)
    return cand, counts, any_eos, t_cache, d_cache


@torch.inference_mode()
def speculative_generate(
    target_model, target_params, target_cfg, draft_model, draft_params, draft_cfg, prompt, *, max_gen,
    draft_max_gen, top_k=None, top_p=None, temp=0.0, eos_id=None, generator=None, device=None,
):
    """Speculative decoding of one sequence (b = 1) with fixed (γ+1)-token
    windows over both models' caches (γ = ``draft_max_gen``).

    ``prompt``: (1, prompt_len) ids (a tensor or array), moved to ``device``
    (None: the card, raising without one); the models' weights live there.
    ``generator``: a ``torch.Generator`` on that device driving the draws
    when temp > 0 (default one seeded with 0).

    A host loop runs the windows. A window makes ONE host read: whether the
    sequence is done (its length reached prompt_len + max_gen, or an EOS was
    committed), read before the window is queued; everything inside it
    (γ draft steps, the draft's extra feed, the verify forward, the
    acceptance and the writes) stays on the device.

    Returns {"sequences": (1, prompt_len + max_gen) (junk past the
    committed end, as JAX's), "num_generated": 0-d tensor, "num_steps":
    0-d tensor (windows run)}.
    """
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device).long()
    gamma = draft_max_gen
    b, prompt_len = prompt.shape
    if b != 1:
        raise ValueError("speculative decoding is single-sequence (reference parity)")
    eos = torch.tensor([-1 if eos_id is None else eos_id], device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    max_total = prompt_len + max_gen + gamma + 1  # slack for the fixed window
    buf = torch.zeros(1, max_total, dtype=torch.long, device=device)
    buf[:, :prompt_len] = prompt
    t_cache = target_model.init_cache(target_cfg, 1, max_total, device=device)
    d_cache = draft_model.init_cache(draft_cfg, 1, max_total, device=device)
    # prefill both with prompt[:-1]: each window re-feeds the last committed token (a recurrent state must not
    # hold it yet)
    if prompt_len > 1:
        _, t_cache, _ = target_model.apply(target_params, target_cfg, prompt[:, :-1], cache=t_cache)
        _, d_cache, _ = draft_model.apply(draft_params, draft_cfg, prompt[:, :-1], cache=d_cache)

    def mprobs(logits):
        return modified_probs(logits, top_k=top_k, top_p=top_p, temp=temp)

    def propose(logits):
        if temp == 0.0:
            return logits.argmax(dim=-1), None
        probs = mprobs(logits)
        return draw(generator, probs), probs

    def accept(t_logits, drafted, d_probs):
        if temp == 0.0:
            return accept_greedy(t_logits, drafted)
        return accept_window(generator, mprobs(t_logits), d_probs, drafted)

    idx = torch.arange(gamma + 1, device=device)
    cur_len = torch.full((1,), prompt_len, dtype=torch.long, device=device)
    finished = torch.zeros(1, dtype=torch.bool, device=device)
    end = prompt_len + max_gen
    n_steps = 0
    while not bool(((cur_len >= end) | finished)[0]):  # the window's one host read
        colm1 = cur_len - 1  # the caches hold exactly the verified prefix [0, cur_len - 1)
        cand, num_new, any_eos, t_cache, d_cache = draft_and_verify(
            (target_model, target_params, target_cfg, t_cache), (draft_model, draft_params, draft_cfg, d_cache),
            buf.gather(1, colm1[:, None])[:, 0], colm1, gamma, propose=propose, accept=accept, eos=eos, junk=0,
            cap=lambda n, cur_len=cur_len: torch.minimum(n, end - cur_len))  # the max_gen cap
        finished = finished | any_eos
        buf.scatter_(1, cur_len[:, None] + idx[None], cand)
        cur_len = cur_len + num_new
        n_steps += 1
    return {
        "sequences": buf[:, :end],
        "num_generated": (cur_len - prompt_len)[0],
        "num_steps": torch.tensor(n_steps, device=device),
    }
