"""Dataset functions, collators and the batching loader (counterpart of
``llm_quest_tpu/data/datasets.py``).

numpy only, and the port's own copies: the port imports nothing of the JAX
package. The dataset functions return lists or numpy arrays, as JAX's do; the
``collate_*`` functions turn sample lists into padded numpy batches;
``data_loader`` shuffles and batches; ``normalize_images`` prepares the ViT
trainer's images and ``multimodal_batches`` the VLM trainer's image-caption
batches. Every function of JAX's file is here: the pretraining windows
(``gpt_windows``, ``gpt_stream_windows``) and the gzip JSONL corpus reader,
the text collators and ``pad_to_multiple``, the instruction, spam,
preference, reasoning and RPT datasets and the DPO and reward-model
collators.
"""

import gzip
import json

import numpy as np

PAD_TOKEN_ID = 50256  # GPT-2 "<|endoftext|>"
NO_LOSS_ID = -100


def gpt_windows(text, tokenizer, max_length, stride):
    """Sliding-window next-token pairs over a tokenized corpus: (inputs,
    targets) int32 arrays of shape (n, max_length)."""
    ids = tokenizer.encode(text)
    inputs, targets = [], []
    for i in range(0, len(ids) - max_length, stride):
        inputs.append(ids[i : i + max_length])
        targets.append(ids[i + 1 : i + max_length + 1])
    return np.asarray(inputs, dtype=np.int32), np.asarray(targets, dtype=np.int32)


def gpt_stream_windows(stream, tokenizer, max_length, stride, text_key="text"):
    """The streaming form over an iterable of {"text": ...} samples: yields
    (input, target) int32 arrays a window; a sample whose text is not a
    string is skipped, one without the key raises KeyError."""
    for sample in stream:
        if text_key not in sample:
            raise KeyError(f'Missing "{text_key}" key in sample.')
        text = sample[text_key]
        if not isinstance(text, str):
            continue
        ids = tokenizer.encode(text)
        for i in range(0, len(ids) - max_length, stride):
            yield (
                np.asarray(ids[i : i + max_length], dtype=np.int32),
                np.asarray(ids[i + 1 : i + max_length + 1], dtype=np.int32),
            )


def load_jsonl_gz(path, max_samples=None, text_key="text"):
    """The ``text_key`` field of each line of a gzip JSONL corpus, up to ``max_samples`` lines."""
    out = []
    with gzip.open(path, "rt", encoding="utf-8") as f:
        for i, line in enumerate(f):
            if max_samples is not None and i >= max_samples:
                break
            out.append(json.loads(line)[text_key])
    return out


def load_instruction_data(path):
    """JSON (a list) or JSONL instruction data."""
    with open(path, encoding="utf-8") as f:
        first = f.read(1)
        f.seek(0)
        if first == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


def instruction_dataset(data, tokenizer, format_fn):
    """Tokenized formatted instruction samples → list[list[int]]."""
    return [tokenizer.encode(format_fn(entry)) for entry in data]


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


def dpo_collate(batch, pad_token_id=PAD_TOKEN_ID, allowed_max_length=None, mask_prompt_tokens=True):
    """DPO collator: chosen and rejected padded to one length (the longer of
    the two plus one, for the label shift; cut at ``allowed_max_length``);
    the loss masks are False on padding and (``mask_prompt_tokens``) on the
    prompt's tokens.

    batch: list of {"prompt": ids, "chosen": ids, "rejected": ids}, chosen
    and rejected each holding the prompt. Returns {"chosen", "rejected"}
    (int32) and {"chosen_mask", "rejected_mask"} (bool)."""
    max_common = max(max(len(x["chosen"]), len(x["rejected"])) for x in batch) + 1
    if allowed_max_length is not None:
        max_common = min(max_common, allowed_max_length)

    bsz = len(batch)
    chosen = np.full((bsz, max_common), pad_token_id, dtype=np.int32)
    rejected = np.full((bsz, max_common), pad_token_id, dtype=np.int32)
    chosen_mask = np.ones((bsz, max_common), dtype=bool)
    rejected_mask = np.ones((bsz, max_common), dtype=bool)

    for i, item in enumerate(batch):
        prompt_len = len(item["prompt"])
        chos = item["chosen"][:max_common]
        rej = item["rejected"][:max_common]
        chosen[i, : len(chos)] = chos
        rejected[i, : len(rej)] = rej
        chosen_mask[i, len(chos) :] = False
        rejected_mask[i, len(rej) :] = False
        if mask_prompt_tokens:
            chosen_mask[i, :prompt_len] = False
            rejected_mask[i, :prompt_len] = False

    return {
        "chosen": chosen,
        "rejected": rejected,
        "chosen_mask": chosen_mask,
        "rejected_mask": rejected_mask,
    }


def pref_reward_collate(batch, pad_token_id=PAD_TOKEN_ID, allowed_max_length=None):
    """Reward-model collator: ``dpo_collate``'s padding with the EoS token
    (``pad_token_id``) appended to each sequence; the loss masks
    ("<key>_mask") cover the response and its EoS, the attention masks
    ("<key>_attn_mask") every real token. Right-padded."""
    max_common = max(max(len(x["chosen"]), len(x["rejected"])) for x in batch) + 1  # +1 EoS
    if allowed_max_length is not None:
        max_common = min(max_common, allowed_max_length)

    bsz = len(batch)
    out = {}
    for key in ("chosen", "rejected"):
        toks = np.full((bsz, max_common), pad_token_id, dtype=np.int32)
        loss_mask = np.zeros((bsz, max_common), dtype=bool)
        attn_mask = np.zeros((bsz, max_common), dtype=bool)
        for i, item in enumerate(batch):
            prompt_len = len(item["prompt"])
            seq = list(item[key])[: max_common - 1] + [pad_token_id]  # append EoS
            n = len(seq)
            toks[i, :n] = seq
            attn_mask[i, :n] = True
            loss_mask[i, min(prompt_len, n) : n] = True  # response + EoS
        out[key] = toks
        out[f"{key}_mask"] = loss_mask
        out[f"{key}_attn_mask"] = attn_mask
    return out


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


def pad_to_multiple(batch_dict, multiple=128, pad_token_id=PAD_TOKEN_ID):
    """Pad the sequence dim of a collated batch ({"input_ids", "targets",
    "attn_mask"}) up to a multiple of ``multiple``: ids with the pad, targets
    with -100, the mask with False."""
    s = batch_dict["input_ids"].shape[1]
    target = ((s + multiple - 1) // multiple) * multiple
    if target == s:
        return batch_dict
    pad = target - s
    out = dict(batch_dict)
    out["input_ids"] = np.pad(batch_dict["input_ids"], ((0, 0), (0, pad)), constant_values=pad_token_id)
    out["targets"] = np.pad(batch_dict["targets"], ((0, 0), (0, pad)), constant_values=NO_LOSS_ID)
    out["attn_mask"] = np.pad(batch_dict["attn_mask"], ((0, 0), (0, pad)), constant_values=False)
    return out


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


def spam_dataset(rows, tokenizer, max_length=None, pad_token=PAD_TOKEN_ID):
    """Text classification data (the spam CSV's rows).

    rows: iterable of (text, label) pairs. Returns {"input_ids" (n,
    max_length) int32 right-padded, "targets" (n,) int32 labels, "attn_mask"
    (n, max_length) bool, "max_length"}; pass the training set's
    "max_length" to pad the validation and test sets alike."""
    texts, labels = zip(*rows)
    ids = [tokenizer.encode(t) for t in texts]
    if max_length:
        ids = [v[:max_length] for v in ids]
    else:
        max_length = max(len(v) for v in ids)

    inputs = np.full((len(ids), max_length), pad_token, dtype=np.int32)
    mask = np.zeros((len(ids), max_length), dtype=bool)
    for i, v in enumerate(ids):
        inputs[i, : len(v)] = v[:max_length]
        mask[i, : min(len(v), max_length)] = True
    return {
        "input_ids": inputs,
        "targets": np.asarray(labels, dtype=np.int32),
        "attn_mask": mask,
        "max_length": max_length,
    }


def load_csv_rows(path, text_col="text", label_col="label"):
    """(text, int label) rows of a CSV file (the standard library's reader)."""
    import csv

    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        return [(row[text_col], int(row[label_col])) for row in reader]


def reasoning_dataset(path, tokenizer):
    """GSM8K JSONL → samples in the DeepSeek <think>/<answer> format: a list
    of {"prompt": ids (up to "### Response:"), "full_response": ids, "answer":
    the gold answer string}."""
    from llm_quest_tpu_torch.utils import ResponseExtractor, alpaca_deepseek_format

    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            entry = json.loads(line)
            formatted = alpaca_deepseek_format(entry, include_response=True)
            prompt, sep, response = formatted.partition("### Response:")
            prompt = prompt + sep
            full_response = response.strip()
            answer = ResponseExtractor.get_answer(full_response)
            out.append(
                {
                    "prompt": tokenizer.encode(prompt),
                    "full_response": tokenizer.encode(full_response),
                    "answer": answer,
                }
            )
    return out


def preference_dataset(path, tokenizer, prompts_only=False):
    """Alpaca-format preference triplets from a JSON list: {"prompt",
    "chosen", "rejected"} ids, chosen and rejected holding the formatted
    prompt; with ``prompts_only`` the prompts' ids alone (for RLHF)."""
    from llm_quest_tpu_torch.utils import alpaca_prompt_format

    with open(path, encoding="utf-8") as f:
        entries = json.load(f)

    out = []
    for entry in entries:
        formatted = alpaca_prompt_format(entry, include_output=False)
        prompt_ids = tokenizer.encode(formatted)
        if prompts_only:
            out.append(prompt_ids)
        else:
            out.append(
                {
                    "prompt": prompt_ids,
                    "chosen": tokenizer.encode(f"{formatted}{entry['chosen']}"),
                    "rejected": tokenizer.encode(f"{formatted}{entry['rejected']}"),
                }
            )
    return out


RPT_DEFAULT_INSTRUCTION = (
    "### Instruction:\n"
    "Complete the given text under '### Context' by predicting the next token. "
    "Please reason step by step and list multiple candidates first. "
    "Select the most probable one as your final prediction by wrapping it in <answer> </answer> tags. "
    "(note: the token may begin with a space, e.g., '<answer> para</answer>' or '<answer> =</answer>'.\n\n"
    "### Context\n"
)


def rpt_structured_dataset(
    entries,
    tokenizer,
    max_context_length,
    *,
    labels_length=25,
    instruction=None,
    valid_indices=None,
    apply_chat_template=False,
    truncate_sample=None,
    min_context_tokens=None,
):
    """Reinforcement-pretraining (context, label string) pairs at every valid
    token position of GSM8K entries ({"question", "answer"} dicts).

    Returns (samples, allowed, getter): the tokenized samples, the allowed
    (sample, position) pairs, and ``getter(i)`` → {"prompt": ids (the
    instruction and up to the context budget of tokens ending at the
    position), "labels": the next ``labels_length`` tokens decoded}.
    ``apply_chat_template`` budgets the context by the templated
    instruction's length and templates each instruction + context string
    as one user turn (Qwen3's RPT variant)."""
    instruction = instruction if instruction is not None else RPT_DEFAULT_INSTRUCTION
    if apply_chat_template:
        out = tokenizer.apply_chat_template(
            [{"role": "user", "content": instruction}],
            tokenize=True, add_generation_prompt=True, enable_thinking=True,
        )
        templated_len = len(out["input_ids"] if hasattr(out, "keys") and "input_ids" in out else out)
        instr_ids = None
        available = max_context_length - templated_len
    else:
        instr_ids = tokenizer.encode(instruction)
        available = max_context_length - len(instr_ids)

    samples = []
    for data in entries:
        solution, _, answer = data["answer"].rpartition("\n#### ")
        full = data["question"] + "\n\n" + f"{solution} So the answer is <answer>{answer}</answer>"
        if truncate_sample is not None:
            start, end = truncate_sample
            full = full[max(0, start) : min(len(full), end)]
        samples.append(tokenizer.encode(full))

    if valid_indices is not None:
        allowed = [(s, t) for s, t in valid_indices if t < len(samples[s]) - labels_length]
    else:
        allowed = []
        for s_idx, toks in enumerate(samples):
            last_valid = len(toks) - labels_length
            if last_valid < 1:
                continue
            for t_idx in range(last_valid):
                start_ctx = max(0, t_idx + 1 - max_context_length)
                if min_context_tokens is not None and (t_idx + 1 - start_ctx) < min_context_tokens:
                    continue
                allowed.append((s_idx, t_idx))

    def getter(index):
        s_idx, t_idx = allowed[index]
        end_ctx = t_idx + 1
        start_ctx = max(0, end_ctx - available)
        context_ids = samples[s_idx][start_ctx:end_ctx]
        labels_ids = samples[s_idx][end_ctx : end_ctx + labels_length]
        if apply_chat_template:
            full_prompt = tokenizer.apply_chat_template(
                [{"role": "user", "content": instruction + tokenizer.decode(context_ids)}],
                tokenize=False, add_generation_prompt=True, enable_thinking=True,
            )
            prompt_ids = tokenizer.encode(full_prompt)
        else:
            prompt_ids = instr_ids + context_ids
        return {"prompt": prompt_ids, "labels": tokenizer.decode(labels_ids)}

    return samples, allowed, getter


def rpt_continuous_dataset(text, tokenizer, max_context_length, *, labels_length=25, instruction=None,
                           min_context_tokens=None):
    """``rpt_structured_dataset``'s pairs over one continuous corpus.
    Returns (tokens, allowed positions, getter)."""
    instruction = instruction if instruction is not None else RPT_DEFAULT_INSTRUCTION
    instr_ids = tokenizer.encode(instruction)
    available = max_context_length - len(instr_ids)
    toks = tokenizer.encode(text)

    allowed = []
    for t_idx in range(len(toks) - labels_length):
        start_ctx = max(0, t_idx + 1 - max_context_length)
        if min_context_tokens is not None and (t_idx + 1 - start_ctx) < min_context_tokens:
            continue
        allowed.append(t_idx)

    def getter(index):
        t_idx = allowed[index]
        end_ctx = t_idx + 1
        start_ctx = max(0, end_ctx - available)
        return {
            "prompt": instr_ids + toks[start_ctx:end_ctx],
            "labels": tokenizer.decode(toks[end_ctx : end_ctx + labels_length]),
        }

    return toks, allowed, getter


CIFAR10_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.asarray([0.2470, 0.2435, 0.2616], np.float32)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_images(images, mean=CIFAR10_MEAN, std=CIFAR10_STD):
    """uint8 (n, h, w, c) or float (n, c, h, w) images → normalized
    (n, c, h, w) float32: uint8 scaled by 1/255, channels-last moved first,
    then (x - mean) / std per channel."""
    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    if images.ndim == 4 and images.shape[-1] in (1, 3):  # NHWC → NCHW
        images = images.transpose(0, 3, 1, 2)
    return (images - mean[None, :, None, None]) / std[None, :, None, None]


def multimodal_batches(images, captions, tokenizer, batch_size, *, max_caption_len=None,
                       pad_token_id=PAD_TOKEN_ID, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """Image-caption pairs → full batches of {"image" (b, c, h, w) float32
    normalized, "input_ids" (b, max_len) int32 right-padded with
    ``pad_token_id``, "attention_mask" (b, max_len) bool}; a caption longer
    than ``max_caption_len`` (default: the longest) is cut, a last partial
    batch dropped. Resizing is the caller's concern."""
    images = normalize_images(images, mean, std)
    ids = [tokenizer.encode(c) for c in captions]
    max_len = max_caption_len or max(len(v) for v in ids)

    batches = []
    for i in range(0, len(ids) - len(ids) % batch_size, batch_size):
        inp = np.full((batch_size, max_len), pad_token_id, dtype=np.int32)
        mask = np.zeros((batch_size, max_len), dtype=bool)
        for j, v in enumerate(ids[i : i + batch_size]):
            v = v[:max_len]
            inp[j, : len(v)] = v
            mask[j, : len(v)] = True
        batches.append({"image": images[i : i + batch_size], "input_ids": inp, "attention_mask": mask})
    return batches
