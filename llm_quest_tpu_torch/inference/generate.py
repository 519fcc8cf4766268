"""Batched KV-cache decode loop (counterpart of
``llm_quest_tpu/inference/generate.py``).

One engine: prefill the static cache once, then ``max_gen`` single-token
steps with static shapes; a finished row emits ``pad_id``, and the attention
mask buffer grows by one valid bit per step (False once the row finished, so
later steps do not attend to its EOS). The loop is eager PyTorch; capturing
the decode step in a CUDA graph is later work.

- right padding: first-step logits are taken at each row's last REAL token;
  decode positions continue from mask.sum().
- left padding: prompt positions are cumsum(mask) - 1 with pads pinned to 0;
  logits are taken at the last column.

``generate_loop_uncached`` is the parity oracle of the cached engine: each
step reruns the whole (context-truncated) sequence through ``model.apply``
without a cache.
"""

import torch

from llm_quest_tpu_torch.ops.sampling import sampling


def _is_eos(tokens, eos_arr):
    """True where ``tokens`` is one of the ids of the 1-d ``eos_arr``."""
    return (tokens[..., None] == eos_arr).any(dim=-1)


def _normalize_eos(eos_ids, pad_id):
    if eos_ids is None:
        return [-1 if pad_id is None else pad_id]
    if not isinstance(eos_ids, (list, tuple)):
        return [eos_ids]
    return list(eos_ids)


@torch.inference_mode()
def generate_batched_kv_cache(
    model, params, cfg, input_ids, attention_mask, *, max_gen, top_k=None, top_p=None, min_p=None,
    temp=0.0, eos_ids=None, pad_id=50256, generator=None, left_pad=False, cache_dtype=None,
):
    """Batched KV-cache generation over right- or left-padded prompts.

    model: an object exposing ``apply(params, cfg, ids, attn_mask=, cache=,
    position_ids=)`` and ``init_cache(cfg, b, max_len, dtype=, device=)``
    (e.g. ``models.qwen3_5.TextOnly``). input_ids: (b, prompt_len) int;
    attention_mask: (b, prompt_len) bool, True = real token. ``generator``
    drives sampling when temp > 0.

    Returns {"sequences": (b, prompt_len + max_gen), "mask": (b, prompt_len +
    max_gen) bool validity mask (EOS and pads excluded)}.
    """
    b, prompt_len = input_ids.shape
    device = input_ids.device
    eos_arr = torch.tensor(_normalize_eos(eos_ids, pad_id), device=device)
    attention_mask = attention_mask.bool()

    cache = model.init_cache(cfg, b, prompt_len + max_gen, dtype=cache_dtype, device=device)
    mask_buf = torch.cat([attention_mask, torch.zeros(b, max_gen, dtype=torch.bool, device=device)], dim=1)

    if left_pad:
        prompt_pos = torch.where(attention_mask, attention_mask.long().cumsum(-1) - 1, 0)
        last_real = torch.full((b,), prompt_len - 1, device=device)
    else:
        prompt_pos = None  # arange positions (pads are masked anyway)
        last_real = attention_mask.sum(-1) - 1
    next_pos = attention_mask.sum(-1, keepdim=True)  # (b, 1)

    logits_all, cache, _ = model.apply(
        params, cfg, input_ids, attn_mask=mask_buf, cache=cache, position_ids=prompt_pos
    )
    logits = logits_all[torch.arange(b, device=device), last_real]

    finished = torch.zeros(b, dtype=torch.bool, device=device)
    tokens = []
    for i in range(max_gen):
        sampled = sampling(generator, logits, top_k=top_k, top_p=top_p, min_p=min_p, temp=temp)
        next_token = torch.where(finished, pad_id, sampled)
        finished = finished | _is_eos(next_token, eos_arr)
        mask_buf[:, prompt_len + i] = ~finished
        tokens.append(next_token)
        if i + 1 < max_gen:  # the logits after the last token are never sampled
            logits_step, cache, _ = model.apply(
                params, cfg, next_token[:, None], attn_mask=mask_buf, cache=cache, position_ids=next_pos
            )
            logits = logits_step[:, 0]
            next_pos = next_pos + 1
    sequences = torch.cat([input_ids, torch.stack(tokens, dim=1).to(input_ids.dtype)], dim=1)
    return {"sequences": sequences, "mask": mask_buf}


def generate_kv_cache(
    model, params, cfg, input_ids, *, max_gen, top_k=None, top_p=None, min_p=None, temp=0.0,
    eos_ids=None, pad_id=50256, generator=None,
):
    """Single-prompt (or uniformly unpadded batch) KV-cache generation."""
    mask = torch.ones(input_ids.shape, dtype=torch.bool, device=input_ids.device)
    return generate_batched_kv_cache(
        model, params, cfg, input_ids, mask, max_gen=max_gen, top_k=top_k, top_p=top_p, min_p=min_p,
        temp=temp, eos_ids=eos_ids, pad_id=pad_id, generator=generator,
    )


@torch.inference_mode()
def generate_loop_uncached(
    model, params, cfg, input_ids, *, max_gen, context_length=None, top_k=None, top_p=None, min_p=None, temp=0.0,
    eos_ids=None, generator=None,
):
    """Uncached decode loop with context truncation: each step runs
    ``model.apply`` on the last ``context_length`` (default
    ``cfg["context_length"]``) tokens and samples from the last position
    (``generator`` drives sampling when temp > 0). Stops before appending a
    step in which any row drew one of ``eos_ids``. Returns (b, prompt_len +
    generated) ids."""
    context_length = context_length or cfg["context_length"]
    eos = None if eos_ids is None else torch.tensor(_normalize_eos(eos_ids, None), device=input_ids.device)
    for _ in range(max_gen):
        logits, _, _ = model.apply(params, cfg, input_ids[:, -context_length:])
        next_token = sampling(generator, logits[:, -1], top_k=top_k, top_p=top_p, min_p=min_p, temp=temp)
        if eos is not None and bool(torch.isin(next_token, eos).any()):
            break
        input_ids = torch.cat([input_ids, next_token[:, None].to(input_ids.dtype)], dim=-1)
    return input_ids
