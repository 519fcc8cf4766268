"""QK-Clip (MuonClip): the rescale of the q and k projections after an
optimizer step (counterpart of ``llm_quest_tpu/ops/qk_clip.py``).

- ``qk_clip_naive``: one η = min(τ / max logit, 1) for a layer; W_q ·= η^α,
  W_k ·= η^(1−α).
- ``qk_clip_per_head``: γ per query head; a kv head shared by a group of
  query heads takes the group's reduced γ (min, max or mean; min is the one
  that guarantees max logit ≤ τ). Query head j's rows scale by γ_j^α, kv
  head g's rows by γ_g^(1−α); head j belongs to group j // (h / h_kv).
- ``magnitude_qk_clip``: on |max logit| (a negative blow-up clips too), MHA.
- ``apply_qk_clip``: the per-head (or naive) clip written into a port
  model's ``blocks[i].att.wq.w`` and ``wk.w`` in place, under
  ``torch.no_grad()``: the reference's "after ``optimizer.step()``" contract.
  It reads the per-layer (n_heads,) maxima that ``models/llama3.py``
  collects in ``aux["max_attn_logits"]`` with ``collect_max_logits``.

Layout: the port's linear weights are ``(out, in)`` (``ops/linear.py``), so a
head is a block of ROWS here where it is a block of columns in JAX's
``(in, out)``. Divergence by design: ``apply_qk_clip`` updates the model in
place (JAX returns a new tree), and refuses an int8 or LoRA-wrapped q/k
projection, whose effective weight is not the ``w`` it would scale.
"""

import torch

from llm_quest_tpu_torch.ops.linear import Linear


def max_logits_from_scores(scores):
    """Per-head max attention logit from (b, h, q, k) pre-softmax scores."""
    return scores.amax(dim=(0, 2, 3))


def _eta(clip_threshold, max_logits):
    return torch.clamp(clip_threshold / torch.as_tensor(max_logits), max=1.0)


def qk_clip_naive(wq, wk, max_logit, clip_threshold, *, alpha=0.5):
    """Layer-level clip. max_logit: the layer's scalar. Any layout."""
    eta = _eta(clip_threshold, max_logit)
    return wq * eta**alpha, wk * eta ** (1 - alpha)


def qk_clip_per_head(wq, wk, max_logits_per_head, clip_threshold, *, num_heads, num_kv_heads=None,
                     alpha=0.5, reduction="min"):
    """Per-head GQA-aware clip. wq: (num_heads·head_dim, d_in); wk:
    (num_kv_heads·head_dim, d_in), row blocks are heads; max_logits_per_head:
    (num_heads,). Returns the new (wq, wk)."""
    num_kv_heads = num_kv_heads or num_heads
    gamma = _eta(clip_threshold, max_logits_per_head)  # (num_heads,)
    new_wq = wq * torch.repeat_interleave(gamma**alpha, wq.shape[0] // num_heads)[:, None]

    grouped = gamma.reshape(num_kv_heads, num_heads // num_kv_heads)
    if reduction == "min":
        gamma_kv = grouped.amin(dim=1)
    elif reduction == "max":
        gamma_kv = grouped.amax(dim=1)
    elif reduction == "mean":
        gamma_kv = grouped.mean(dim=1)
    else:
        raise ValueError(f"Unknown reduction: {reduction}")
    new_wk = wk * torch.repeat_interleave(gamma_kv ** (1 - alpha), wk.shape[0] // num_kv_heads)[:, None]
    return new_wq, new_wk


def _plain_weight(proj, name):
    if type(proj) is not Linear or "lora" in proj._modules:
        raise ValueError(f"apply_qk_clip: {name} is a {type(proj).__name__}"
                         f"{' with a LoRA adapter' if 'lora' in getattr(proj, '_modules', {}) else ''}; "
                         "only a plain Linear's weight is its effective weight")
    return proj.w


@torch.no_grad()
def apply_qk_clip(model, max_logits_per_layer, clip_threshold, *, num_heads, num_kv_heads=None,
                  alpha=0.5, reduction="min", per_head=True):
    """Fold QK-Clip into ``model.blocks[i].att.wq/wk`` in place (module
    docstring). max_logits_per_layer: one (num_heads,) tensor a layer
    (per-head) or one scalar a layer (naive). Returns the model."""
    for i, (block, ml) in enumerate(zip(model.blocks, max_logits_per_layer)):
        wq = _plain_weight(block.att.wq, f"blocks.{i}.att.wq")
        wk = _plain_weight(block.att.wk, f"blocks.{i}.att.wk")
        ml = torch.as_tensor(ml, device=wq.device)
        if per_head:
            new_wq, new_wk = qk_clip_per_head(wq, wk, ml, clip_threshold, num_heads=num_heads,
                                              num_kv_heads=num_kv_heads, alpha=alpha, reduction=reduction)
        else:
            new_wq, new_wk = qk_clip_naive(wq, wk, ml, clip_threshold, alpha=alpha)
        wq.copy_(new_wq)
        wk.copy_(new_wk)
    return model


def magnitude_qk_clip(wq, wk, max_logits_per_head, clip_threshold, *, num_heads, alpha=0.5):
    """Magnitude variant: clips on |max logit|; MHA only (equal q/k head
    counts). wq/wk: (num_heads·head_dim, d_in). max_logits_per_head:
    (num_heads,) signed per-head extreme logits."""
    gamma = _eta(clip_threshold, torch.as_tensor(max_logits_per_head).abs())
    head_dim = wq.shape[0] // num_heads
    q_scale = torch.repeat_interleave(gamma**alpha, head_dim)[:, None]
    k_scale = torch.repeat_interleave(gamma ** (1 - alpha), head_dim)[:, None]
    return wq * q_scale, wk * k_scale
