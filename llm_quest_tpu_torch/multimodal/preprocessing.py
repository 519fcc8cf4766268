"""On-device image preprocessing (counterpart of
``llm_quest_tpu/multimodal/preprocessing.py``).

- ``fold_image_normalization``: the per-channel affine normalization
  commutes into the patch-embedding projection,
      ((x·s − μ)/σ)·W == x·W̃ + b̃,  W̃ = W·s/σ,  b̃ = b − Σ (μ/σ)·W,
  so a model with folded weights takes raw (uint8-valued) pixels: the
  normalization costs nothing and the host→card copy is a quarter of fp32's.
  It touches only the input-channel axis of the conv weight, so it takes the
  2-D ViT ``patch_emb`` (d, c, p, p) and the 3-D Qwen3.5 ``patch_embed``
  (d, c, tp, p, p) alike, and returns folded copies (the model's own
  parameters are left as they were).
- ``resize_bilinear``: bilinear resize on the device, in fp32.
- ``make_uint8_encoder``: a plain function uint8 images → ViT hidden states
  over a copy of the ViT with a folded patch embedding (the rest shared),
  with an optional resize first (JAX jits the same pipeline; the port runs
  it eagerly under ``torch.inference_mode``).

Divergence from JAX's docstring, not its behaviour: JAX's ``resize_bilinear``
says "antialias off", but ``jax.image.resize(..., "bilinear")`` antialiases
when it downsamples. The port follows the behaviour:
``F.interpolate(..., antialias=True)``, which equals JAX's to fp32 rounding
both ways (without antialias a downsample differs by tens of units on a
0–255 scale).
"""

import copy

import torch
import torch.nn.functional as F

from llm_quest_tpu_torch.config import model_dtype


def resize_bilinear(images, height, width):
    """(b, c, H, W) → (b, c, height, width) fp32, antialiased when it downsamples (module docstring)."""
    return F.interpolate(images.float(), size=(height, width), mode="bilinear", align_corners=False,
                         antialias=True)


@torch.no_grad()
def fold_image_normalization(patch_params, mean, std, *, input_scale=1.0 / 255.0):
    """Fold (x·input_scale − mean)/std into the patch-embed conv.

    patch_params: a mapping with "conv_w" (d, c, ...spatial) and "conv_b"
    (d,) (the ViT's ``patch_emb``, which also holds its CLS token, or
    Qwen3.5's ``patch_embed``). Returns a dict of new tensors with the other
    entries as given: weights for raw pixels, computed in fp32 and cast back."""
    w32 = patch_params["conv_w"].detach().float()
    b32 = patch_params["conv_b"].detach().float()
    c = w32.shape[1]
    shape = (1, c) + (1,) * (w32.dim() - 2)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=w32.device).reshape(shape)
    std = torch.as_tensor(std, dtype=torch.float32, device=w32.device).reshape(shape)
    w_folded = w32 * (input_scale / std)
    b_folded = b32 - (w32 * (mean / std)).sum(dim=tuple(range(1, w32.dim())))
    return {
        **patch_params,
        "conv_w": w_folded.to(patch_params["conv_w"].dtype),
        "conv_b": b_folded.to(patch_params["conv_b"].dtype),
    }


def make_uint8_encoder(vit_module, params, cfg, mean, std, *, resize_to=None):
    """uint8 images (b, c, H, W) → ViT hidden states (b, N+1, d): the cast
    to the config's dtype, the optional bilinear resize to ``resize_to``
    (height, width) and the encode through a folded copy of ``params``
    (``vit_module`` is ``models.vit``). The copy has a patch embedding of its
    own and shares every other parameter with ``params``, which is not
    changed."""
    folded_model = copy.copy(params)
    folded_model._modules = dict(params._modules)  # a shallow copy shares the submodule table
    folded_model.patch_emb = copy.deepcopy(params.patch_emb)
    with torch.no_grad():
        for name, t in fold_image_normalization(params.patch_emb, mean, std).items():
            folded_model.patch_emb[name].copy_(t)
    dtype = model_dtype(cfg)

    def encode(images_u8):
        with torch.inference_mode():
            x = images_u8.to(dtype)
            if resize_to is not None:
                x = resize_bilinear(x, *resize_to).to(dtype)
            return vit_module.apply(folded_model, cfg, x, output_hidden_states=True)

    return encode
