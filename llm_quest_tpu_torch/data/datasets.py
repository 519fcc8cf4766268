"""Collators and the batching loader (counterpart of
``llm_quest_tpu/data/datasets.py``, the parts the training paths use).

numpy only, and the port's own copies: the port imports nothing of the JAX
package. ``collate_*`` turn sample lists into padded numpy batches;
``data_loader`` shuffles and batches. The other dataset functions come with
the trainers that read them.
"""

import numpy as np

PAD_TOKEN_ID = 50256  # GPT-2 "<|endoftext|>"
NO_LOSS_ID = -100


def collate_function(batch, custom_max_len=None, pad_token_id=PAD_TOKEN_ID):
    """Pad-to-batch-max collator with 1-shifted targets: each row's targets
    are its inputs from position 1, one trailing pad token, then -100
    (no loss); the attention mask is True on real tokens.

    batch: list[list[int]] token sequences. Returns {"input_ids",
    "targets", "attn_mask"} numpy arrays (int32, int32, bool)."""
    if custom_max_len:
        batch = [sample[:custom_max_len] for sample in batch]
    batch_max_len = max(len(s) for s in batch)

    inputs = np.full((len(batch), batch_max_len), pad_token_id, dtype=np.int32)
    targets = np.full((len(batch), batch_max_len), NO_LOSS_ID, dtype=np.int32)
    mask = np.zeros((len(batch), batch_max_len), dtype=bool)
    for i, s in enumerate(batch):
        n = len(s)
        inputs[i, :n] = s
        targets[i, : n - 1] = s[1:]
        targets[i, n - 1] = pad_token_id  # one pad target after the sequence's end
        mask[i, :n] = True
    return {"input_ids": inputs, "targets": targets, "attn_mask": mask}


def collate_function_mtp(batch, mtp_depth, custom_max_len=None, pad_token_id=PAD_TOKEN_ID):
    """MTP collator: ``collate_function``'s batch plus ``mtp_depth``
    pre-shifted pairs; the shift-k inputs drop the first k tokens (pad fill
    at the end), the shift-k targets likewise (-100 fill).

    Returns {"input_ids", "targets", "attn_mask", "shifted_inputs": [k],
    "shifted_targets": [k]}."""
    base = collate_function(batch, custom_max_len, pad_token_id)
    inputs, targets = base["input_ids"], base["targets"]
    s = inputs.shape[1]

    shifted_inputs, shifted_targets = [], []
    for k in range(1, mtp_depth + 1):
        s_x = np.full_like(inputs, pad_token_id)
        s_y = np.full_like(targets, NO_LOSS_ID)
        s_x[:, : s - k] = inputs[:, k:]
        s_y[:, : s - k] = targets[:, k:]
        shifted_inputs.append(s_x)
        shifted_targets.append(s_y)

    return {
        "input_ids": inputs,
        "targets": targets,
        "attn_mask": base["attn_mask"],
        "shifted_inputs": shifted_inputs,
        "shifted_targets": shifted_targets,
    }


def data_loader(samples, batch_size, *, shuffle=False, drop_last=True, collate_fn=None, seed=0):
    """Minimal batching loader. samples: a list, or a tuple of parallel
    arrays (inputs, targets). Returns a list of batches: ``collate_fn`` of
    each chunk of a list (the chunk itself without one), or {"input_ids",
    "targets"} dicts for a tuple. ``shuffle`` permutes with numpy's
    generator seeded by ``seed``."""
    n = len(samples[0]) if isinstance(samples, tuple) else len(samples)
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    batches = []
    for i in range(0, end, batch_size):
        sel = idx[i : i + batch_size]
        if isinstance(samples, tuple):
            batches.append({"input_ids": samples[0][sel], "targets": samples[1][sel]})
        else:
            chunk = [samples[j] for j in sel]
            batches.append(collate_fn(chunk) if collate_fn else chunk)
    return batches
