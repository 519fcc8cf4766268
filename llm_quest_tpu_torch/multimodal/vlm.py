"""ViT→GPT-2 VLM: adapter, early fusion, captioning loss and generation
(counterpart of ``llm_quest_tpu/multimodal/vlm.py``).

- ``ViTAdapter`` (``init_adapter`` / ``adapter_apply``): the "simple" linear
  or the "ffn" (one GELU-erf hidden layer of ``hidden_size_factor``·d)
  projector from the ViT's hidden width to the LLM's embedding width, with or
  without biases, under JAX's names ({"proj"} or {"fc", "proj"});
- ``fuse``: [vision embeddings ‖ text embeddings] fed to GPT-2 through its
  ``input_embedded`` entry, the vision positions always attended; the ViT is
  frozen (run under ``torch.no_grad()``, JAX's ``stop_gradient``);
- ``vlm_loss``: CE on the logits sliced [nv − 1 : −1] (the last vision token
  predicts the first text token), padding masked to −100;
- ``vlm_generate``: greedy captions: the image is encoded once, the fused
  [vision ‖ BOS] sequence prefilled into ``gpt2.init_cache``, then one-token
  steps in embedding space. A finished row emits ``pad_id``; the column of
  step i's token is attended from the next step on only if its row had not
  finished by then (the EOS token itself is not), JAX's rule.

Types: JAX's ``x @ w`` promotes, torch's ``linear`` refuses mixed types, so
the adapter computes in the promoted type of its input and weights (a bf16
ViT into JAX's default fp32 adapter runs the adapter in fp32, as JAX does) and
``fuse`` casts the vision embeddings to the text table's type, as JAX does.

Kernels on this path: the frozen ViT's attention is K7 (``packed_mha``) at s
N+1 (197 for ViT-B/16 at 224 px); GPT-2's uncached forward over the fused
sequence takes K4 (``flash_attention``, forward and backward) from
``flash_min_seq`` (256) queries up, with the key mask [1 × nv ‖ the text
mask]; the cached prefill and steps of ``vlm_generate`` take ``sdpa``, as in
JAX (``flash_ok=cache is None``).
"""

import torch
from torch import nn

from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.models import gpt2
from llm_quest_tpu_torch.ops.activations import gelu_erf
from llm_quest_tpu_torch.ops.linear import Linear, linear
from llm_quest_tpu_torch.ops.losses import cross_entropy


class ViTAdapter(nn.Module):
    """{"proj"} ("simple") or {"fc", "proj"} ("ffn"), trainable Linears."""

    def __init__(self, vit_d_out, llm_d_in, *, adapter_type="simple", hidden_size_factor=4, bias=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = {"bias": bias, "dtype": dtype, "device": resolve_device(device), "trainable": True}
        if adapter_type == "simple":
            self.proj = Linear(vit_d_out, llm_d_in, **kw)
        elif adapter_type == "ffn":
            hidden = vit_d_out * hidden_size_factor
            self.fc = Linear(vit_d_out, hidden, **kw)
            self.proj = Linear(hidden, llm_d_in, **kw)
        else:
            raise ValueError(f"Invalid adapter type: {adapter_type}")

    def forward(self, x):
        return adapter_apply(self, x)


@torch.no_grad()
def init_adapter(vit_d_out, llm_d_in, *, generator, adapter_type="simple", hidden_size_factor=4, bias=False,
                 dtype=torch.float32, device=None):
    """A ``ViTAdapter`` with JAX's ``init_linear`` distributions (U(±1/sqrt(in))),
    drawn from ``generator`` (which lives on ``device``)."""
    adapter = ViTAdapter(vit_d_out, llm_d_in, adapter_type=adapter_type, hidden_size_factor=hidden_size_factor,
                         bias=bias, dtype=dtype, device=device)
    for module in adapter.modules():
        if isinstance(module, Linear):
            module.reset_parameters(generator)
    return adapter


def _promoted_linear(lin, x):
    dt = torch.promote_types(x.dtype, lin.w.dtype)
    b = None if lin.b is None else lin.b.to(dt)
    return linear(x.to(dt), lin.w.to(dt), b)


def adapter_apply(params, x):
    """(…, vit_d) → (…, llm_d) in the promoted type of x and the adapter's
    weights; the type is read from the structure ("fc" present → ffn)."""
    if hasattr(params, "fc"):
        return _promoted_linear(params.proj, gelu_erf(_promoted_linear(params.fc, x)))
    return _promoted_linear(params.proj, x)


def _encode(vit_model, vit_params, vit_cfg, images):
    with torch.no_grad():  # the frozen ViT
        return vit_model.apply(vit_params, vit_cfg, images, output_hidden_states=True)


def fuse(vit_model, vit_params, vit_cfg, adapter_params, llm_params, images, input_ids, text_attention_mask):
    """Encode the images, project, early-fuse with the text embeddings.
    Returns (combined (b, nv + s, d), combined mask (b, nv + s) bool, nv)."""
    vision_emb = adapter_apply(adapter_params, _encode(vit_model, vit_params, vit_cfg, images))  # (b, nv, d)
    text_emb = llm_params.tok_emb["w"][input_ids]
    combined = torch.cat([vision_emb.to(text_emb.dtype), text_emb], dim=1)
    b, nv = vision_emb.shape[:2]
    vision_mask = torch.ones(b, nv, dtype=torch.bool, device=combined.device)
    return combined, torch.cat([vision_mask, text_attention_mask.bool()], dim=1), nv


def vlm_loss(logits, labels, text_attention_mask, num_vision_tokens):
    """CE over the text positions; the last vision token predicts the first text token."""
    shifted = logits[:, num_vision_tokens - 1 : -1, :]
    labels = torch.where(text_attention_mask.bool(), labels, -100)
    return cross_entropy(shifted.reshape(-1, shifted.shape[-1]), labels.reshape(-1))


def vlm_forward_loss(vit_model, vit_params, vit_cfg, adapter_params, llm_params, llm_cfg, batch):
    """One fused forward and the captioning loss. batch: {"image",
    "input_ids", "attention_mask"} tensors on the models' device."""
    combined, mask, nv = fuse(vit_model, vit_params, vit_cfg, adapter_params, llm_params,
                              batch["image"], batch["input_ids"], batch["attention_mask"])
    logits, _, _ = gpt2.apply(llm_params, llm_cfg, combined, attn_mask=mask, input_embedded=True)
    return vlm_loss(logits, batch["input_ids"], batch["attention_mask"], nv)


@torch.inference_mode()
def vlm_generate(vit_model, vit_params, vit_cfg, adapter_params, llm_params, llm_cfg, images, bos_id, *,
                 max_gen=30, eos_id=None, pad_id=50256):
    """Greedy captions with the KV cache (module docstring). Returns (b,
    max_gen) int64 token ids; no host read."""
    b = images.shape[0]
    device = images.device
    vision_emb = adapter_apply(adapter_params, _encode(vit_model, vit_params, vit_cfg, images))
    table = llm_params.tok_emb["w"]
    bos_emb = table[torch.full((b, 1), bos_id, device=device)]
    combined = torch.cat([vision_emb.to(bos_emb.dtype), bos_emb], dim=1)

    prefill_len = combined.shape[1]
    cache = gpt2.init_cache(llm_cfg, b, prefill_len + max_gen, device=device)
    mask_buf = torch.zeros(b, prefill_len + max_gen, dtype=torch.bool, device=device)
    mask_buf[:, :prefill_len] = True
    logits, cache, _ = gpt2.apply(llm_params, llm_cfg, combined, attn_mask=mask_buf, cache=cache,
                                  input_embedded=True)
    logits = logits[:, -1]

    eos = -1 if eos_id is None else eos_id
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    tokens = []
    for i in range(max_gen):
        tok = torch.where(finished, pad_id, logits.argmax(-1))
        finished = finished | (tok == eos)
        mask_buf[:, prefill_len + i] = ~finished
        tokens.append(tok)
        if i + 1 < max_gen:  # JAX's scan runs one more step whose logits it drops
            # JAX's gather clamps a pad id past the vocabulary; a finished row's embedding reaches no other row
            emb = table[tok.clamp(max=table.shape[0] - 1)[:, None]]
            logits, cache, _ = gpt2.apply(llm_params, llm_cfg, emb, attn_mask=mask_buf, cache=cache,
                                          input_embedded=True)
            logits = logits[:, 0]
    return torch.stack(tokens, dim=1)
