"""Reinforced Attention Learning (RAL): the advantage-weighted Jensen-Shannon
divergence between the policy's and the old policy's attention maps
(counterpart of ``llm_quest_tpu/ops/reinforced_attention.py``).

Head-averaged maps, the diagonal zeroed, renormalized and clamped; JSD(P‖Q)
summed over keys; the loss is the mean over sequences of advantage · JSD's
masked mean over query tokens, times ``ral_factor``. The old policy's
statistics are ``detach()``ed, as JAX stops their gradient.
"""

import torch


def _prepare_attention_weights(attn_weights):
    """Head-average, zero the diagonal, renormalize, clamp: (b, h, s, s) → (b, s, s) fp32."""
    s = attn_weights.shape[-1]
    diag = torch.eye(s, dtype=torch.bool, device=attn_weights.device)
    attn = attn_weights.float().mean(dim=1).masked_fill(diag, 0.0)
    attn = attn / attn.sum(dim=-1, keepdim=True).clamp_min(1e-8)
    return attn.clamp_min(1e-8)


def attention_divergence_loss(policy_attention_weights, old_attention_weights, advantages, loss_mask, *,
                              ral_factor=1.0):
    """L_ral = mean_b[adv · masked-mean_q JSD(P‖Q)] · factor. Maps (b, h, s,
    s); advantages (b,); loss_mask (b, s)."""
    q = _prepare_attention_weights(old_attention_weights).detach()
    p = _prepare_attention_weights(policy_attention_weights)

    log_m = torch.log((p + q) / 2.0)
    jsd = 0.5 * (p * (torch.log(p) - log_m) + q * (torch.log(q) - log_m)).sum(-1)  # (b, s)

    lm = loss_mask.to(jsd.dtype)
    per_seq = (advantages[:, None] * jsd * lm).sum(-1) / lm.sum(-1).clamp_min(1)
    return per_seq.mean() * ral_factor
