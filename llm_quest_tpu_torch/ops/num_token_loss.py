"""Number Token Loss, Wasserstein variant (NTL-WAS) (counterpart of
``llm_quest_tpu/ops/num_token_loss.py``).

``build_num_vocab`` maps the vocabulary to number values (single digits by
default, any number with ``multi_digits``), NaN elsewhere. ``num_token_loss``
is the mean over number-label positions of Σ_j |label − value_j|·p_j, p the
softmax over the number tokens only; optional importance weights; 0 when no
label is a number.

Divergence by design (memory): JAX softmaxes the whole (b, s, V) logits with
the non-number columns set to −inf and builds two more (b, s, V) fp32
tensors. The port gathers the number-token columns first and works on (b, s,
n_numbers): the softmax over the unmasked columns equals the −inf-masked one,
so the value and the gradient are JAX's (the gradient is zero outside the
gathered columns in both). Finding the columns reads the map on the host, so
it is done once a map (``_number_columns``), not once a step.
"""

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from llm_quest_tpu_torch.config import resolve_device

_COLUMNS = WeakIdKeyDictionary()  # map → (its version, the number columns, their values)


def build_num_vocab(tokenizer, vocab_size, *, multi_digits=False, device=None):
    """(vocab_size,) fp32 tensor on ``device`` (the card unless the caller
    says otherwise): digit tokens → value, others → NaN. Works with any
    tokenizer exposing get_vocab() or decode(ids)."""
    values = np.full((vocab_size,), np.nan, np.float32)
    if hasattr(tokenizer, "get_vocab"):
        items = tokenizer.get_vocab().items()
    else:
        items = ((tokenizer.decode([i]), i) for i in range(vocab_size))
    for string, token_id in items:
        stripped = string.strip()
        try:
            value = float(stripped)
        except ValueError:
            continue
        single_digit = -1 <= value <= 9 and len(stripped) == 1
        if (multi_digits or single_digit) and token_id < vocab_size:
            values[token_id] = value
    return torch.from_numpy(values).to(resolve_device(device))


def _number_columns(num_nan_vocab):
    """The number tokens' columns of a map and their values. ``nonzero``
    waits for the card, so they are found once a map and kept while it lives
    (found again if it is changed in place)."""
    version = None if num_nan_vocab.is_inference() else num_nan_vocab._version
    hit = _COLUMNS.get(num_nan_vocab)
    if hit is None or hit[0] != version:
        cols = torch.nonzero(~torch.isnan(num_nan_vocab)).squeeze(-1)
        hit = (version, cols, num_nan_vocab[cols])
        _COLUMNS[num_nan_vocab] = hit
    return hit[1], hit[2]


def num_token_loss(logits, labels, num_nan_vocab, *, importance_mask=None, ignore_index=-100):
    """Mean NTL-WAS over number-token label positions.

    logits: (b, s, v); labels: (b, s); num_nan_vocab: (v,) value-or-NaN map.
    Returns a 0-d fp32 tensor."""
    cols, values = _number_columns(num_nan_vocab)

    safe_labels = torch.where(labels == ignore_index, 0, labels).long()
    label_values = num_nan_vocab[safe_labels]  # (b, s)
    valid = ~torch.isnan(label_values) & (labels != ignore_index)
    label_values = torch.where(valid, label_values, 0.0)

    number_probs = torch.softmax(logits[..., cols].float(), dim=-1)  # (b, s, n)
    per_pos = ((label_values[..., None] - values).abs() * number_probs).sum(-1)  # (b, s)

    if importance_mask is not None:
        w = importance_mask.to(per_pos.dtype) * valid
        denom = (w != 0).sum()
        return torch.where(denom > 0, (per_pos * w).sum() / denom.clamp_min(1), 0.0)
    denom = valid.sum()
    return torch.where(denom > 0, torch.where(valid, per_pos, 0.0).sum() / denom.clamp_min(1), 0.0)
