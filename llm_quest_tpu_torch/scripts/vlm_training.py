"""ViT→GPT-2 VLM captioning training (counterpart of
``scripts/vlm_training.py``): the ViT frozen, the adapter and GPT-2 trained.

``TINY_VIT_CONFIG`` (the ViT, seed 0), ``GPT_SMALL_CONFIG`` at context 512
(seed 1) and an "ffn" adapter (seed 2), fp32 as in JAX; ``training/engine.py
::adamw`` at ``optax.adamw(1e-4)``'s defaults, b 4, 2 epochs. The data is
JAX's synthetic fallback only: 32 seeded uint8 32 × 32 images captioned "a
synthetic image number i", tokenized by bytes (mod 50,000), in 8 batches by
``multimodal_batches``. Then a greedy caption of the first image (BOS 1, 10
tokens). Runs on the card:

    python -m llm_quest_tpu_torch.scripts.vlm_training
"""

import numpy as np
import torch

from llm_quest_tpu_torch import config
from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.data.datasets import multimodal_batches
from llm_quest_tpu_torch.models import gpt2, vit
from llm_quest_tpu_torch.multimodal import vlm
from llm_quest_tpu_torch.training.engine import adamw, as_tensors

BATCH_SIZE = 4
NUM_EPOCHS = 2
LR = 1e-4
ADAPTER_TYPE = "ffn"


class ByteTok:
    def encode(self, t):
        return [b % 50000 for b in t.encode()]


def synthetic_batches(batch_size=BATCH_SIZE):
    """JAX's fallback: 32 seeded uint8 NHWC images and their captions, batched."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, size=(32, 32, 32, 3), dtype=np.uint8)
    captions = [f"a synthetic image number {i}" for i in range(32)]
    return multimodal_batches(images, captions, ByteTok(), batch_size)


def make_train_step(vit_params, vit_cfg, llm_cfg, optimizer):
    """``train_step(adapter, llm_params, opt_state, batch) -> (adapter,
    llm_params, opt_state, loss)``: the captioning loss through the frozen
    ViT, the gradients of the adapter's and GPT-2's parameters (zero for an
    unused one, GPT-2's position table, as ``jax.grad`` gives), one optimizer
    update in place over both, in that order."""

    def train_step(adapter, llm_params, opt_state, batch):
        leaves = [*adapter.parameters(), *llm_params.parameters()]
        loss = vlm.vlm_forward_loss(vit, vit_params, vit_cfg, adapter, llm_params, llm_cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        opt_state = optimizer.update(grads, opt_state, leaves)
        return adapter, llm_params, opt_state, loss.detach()

    return train_step


def main(*, vit_cfg=None, llm_cfg=None, num_epochs=NUM_EPOCHS, device=None, log=print):
    """Trains and captions; returns (adapter, GPT-2, the per-epoch last
    losses, the caption's token ids)."""
    device = resolve_device(device)
    vit_cfg = dict(vit_cfg or config.TINY_VIT_CONFIG)
    llm_cfg = dict(llm_cfg or dict(config.GPT_SMALL_CONFIG, context_length=512))
    batches = synthetic_batches()

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    vit_params = vit.init(vit_cfg, generator=gen(0), device=device)  # frozen
    llm_params = gpt2.init(llm_cfg, generator=gen(1), device=device)
    adapter = vlm.init_adapter(vit_cfg["emb_dim"], llm_cfg["emb_dim"], generator=gen(2), adapter_type=ADAPTER_TYPE,
                               device=device)

    optimizer = adamw(LR)
    opt_state = optimizer.init([*adapter.parameters(), *llm_params.parameters()])
    train_step = make_train_step(vit_params, vit_cfg, llm_cfg, optimizer)
    losses = []
    for epoch in range(1, num_epochs + 1):
        for batch in batches:
            adapter, llm_params, opt_state, loss = train_step(adapter, llm_params, opt_state,
                                                              as_tensors(batch, device))
        losses.append(float(loss))
        log(f"epoch {epoch} loss {losses[-1]:.4f}")

    tokens = vlm.vlm_generate(vit, vit_params, vit_cfg, adapter, llm_params, llm_cfg,
                              torch.as_tensor(batches[0]["image"][:1], device=device), bos_id=1, max_gen=10)
    log(f"generated token ids: {tokens[0].tolist()}")
    return adapter, llm_params, losses, tokens


if __name__ == "__main__":
    main()
