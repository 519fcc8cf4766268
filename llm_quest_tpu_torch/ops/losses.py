"""Loss functions (counterpart of ``llm_quest_tpu/ops/losses.py``).

``cross_entropy`` has torch F.cross_entropy(ignore_index=-100) mean
semantics: ignored targets count in neither the numerator nor the
denominator.
"""

import torch

IGNORE_INDEX = -100


def cross_entropy(logits, targets, *, ignore_index=IGNORE_INDEX):
    """Mean token-level CE over non-ignored targets, in fp32.
    logits: (..., v); targets: (...,) int."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0).long()
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def log_probs_of(logits, targets):
    """Per-position log p(target) from (..., v) logits, fp32."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    return logprobs.gather(-1, targets.long()[..., None])[..., 0]


class _FusedHeadCE(torch.autograd.Function):
    """CE fused with the LM head over row chunks. The forward keeps only each
    row's fp32 logsumexp; the backward recomputes each chunk's logits, so at
    most one (chunk, vocab) logit block exists at a time, in either pass."""

    @staticmethod
    def forward(ctx, h2, head_w, targets, ignore_index, chunk):
        valid = targets != ignore_index
        safe = torch.where(valid, targets, 0).long()
        lse = torch.empty(h2.shape[0], dtype=torch.float32, device=h2.device)
        tgt = torch.empty_like(lse)
        for i in range(0, h2.shape[0], chunk):
            logits = h2[i : i + chunk] @ head_w  # (c, v) in the model dtype
            lse[i : i + chunk] = torch.logsumexp(logits.float(), dim=-1)
            tgt[i : i + chunk] = logits.gather(1, safe[i : i + chunk, None])[:, 0].float()
        count = valid.sum().clamp_min(1)
        ctx.save_for_backward(h2, head_w, safe, valid, lse, count)
        ctx.chunk = chunk
        return torch.where(valid, lse - tgt, 0.0).sum() / count

    @staticmethod
    def backward(ctx, g):
        h2, head_w, safe, valid, lse, count = ctx.saved_tensors
        chunk = ctx.chunk
        want_h, want_w = ctx.needs_input_grad[:2]
        gh = torch.empty_like(h2) if want_h else None
        gw = torch.zeros(head_w.shape, dtype=torch.float32, device=head_w.device) if want_w else None
        row_scale = valid.float() * (g.float() / count)
        for i in range(0, h2.shape[0], chunk):
            hc = h2[i : i + chunk]
            logits = hc @ head_w
            # d loss / d logits = (softmax - onehot(target)) * valid * g / count
            dl = torch.exp(logits.float() - lse[i : i + chunk, None])
            dl[torch.arange(hc.shape[0], device=dl.device), safe[i : i + chunk]] -= 1.0
            dl = (dl * row_scale[i : i + chunk, None]).to(logits.dtype)
            if want_h:
                gh[i : i + chunk] = dl @ head_w.T
            if want_w:
                gw += (hc.T @ dl).float()
        return gh, None if gw is None else gw.to(head_w.dtype), None, None, None


def cross_entropy_fused_head(hidden, head_w, targets, *, ignore_index=IGNORE_INDEX, chunk_size=1024):
    """Mean CE over non-ignored targets of ``hidden @ head_w``, computed in
    row chunks of ``chunk_size`` in the logsumexp form ``lse(logits) −
    logits[target]``: the full fp32 (b·s, vocab) logits never exist, in the
    forward or the backward. hidden: (b, s, d); head_w: (d, v) (may be a
    transposed view of the tied table, which then gets the head's gradient
    too); targets: (b, s). Equals ``cross_entropy(hidden @ head_w, targets)``.
    """
    b, s, d = hidden.shape
    t = b * s
    return _FusedHeadCE.apply(hidden.reshape(t, d), head_w, targets.reshape(t), ignore_index, min(chunk_size, t))
