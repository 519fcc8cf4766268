"""Hyper-connections (counterpart of ``llm_quest_tpu/ops/hyper_connections.py``):
classic HC, DeepSeek's mHC (Sinkhorn-Knopp) and mHC-lite (Birkhoff-von
Neumann).

- classic HC: n residual streams; H_res = tanh((x_norm·W)ᵀ)·α + I from a
  zero-initialised (emb → n) map, α = 0.01; H_pre (emb → 1, bias 1/n) and
  H_post (emb → 1, bias 1);
- mHC: H_res from the flattened streams (n·emb → n²), exp, then a fixed 20
  Sinkhorn-Knopp iterations onto the doubly stochastic matrices (bias
  8·I − 8, so exp(bias) ≈ I); H_pre = sigmoid(·) (bias −ln(n − 1)) and
  H_post = 2·sigmoid(·) (bias 0);
- mHC-lite: H_res = Σ aₖ·Pₖ, a softmax over the n! permutation matrices
  (bias −8 but 0 at the identity);
- all coefficient math in fp32; the streams are cast back to their dtype.

A bundle (``init_hc_set``, ``init_mhc_set``) is an ``HCSet``: {"norm",
"res", "pre", "post"} parameter groups under JAX's names, fp32 whatever the
model's dtype, their "w" maps in JAX's (in, out) layout, applied as ``x @
w`` (``weights/interop.py`` transposes only ``Linear`` weights). mHC-lite's
permutation matrices are the buffer ``_bvn_flat``, not a parameter: the
optimizer never sees them. Divergence by design: JAX keeps them in the
parameter tree, so its train step differentiates, Adam-updates and decays
them (a reference fault: its comment calls them a fixed buffer).
"""

import itertools
import math

import numpy as np
import torch
from torch import nn

from llm_quest_tpu_torch.ops.linear import params


def sinkhorn_knopp(p, *, max_iter=20):
    """Doubly-stochastic projection of non-negative (..., n, n) matrices: a
    fixed ``max_iter`` row-then-column normalisations in fp32, cast back."""
    m = p.float()
    for _ in range(max_iter):
        m = m / m.sum(dim=-1, keepdim=True)  # rows
        m = m / m.sum(dim=-2, keepdim=True)  # cols
    return m.to(p.dtype)


def permutation_matrices(n, *, device=None):
    """All n! permutation matrices flattened, (n!, n·n) fp32, and the
    identity's index."""
    perms = list(itertools.permutations(range(n)))
    eye = np.eye(n, dtype=np.float32)
    mats = np.stack([eye[list(p)] for p in perms]).reshape(len(perms), n * n)
    return torch.from_numpy(mats).to(device), perms.index(tuple(range(n)))


def bvn_compose(weights, flat_permut_matrices, n):
    """H = Σ aₖ·Pₖ as one matmul. weights: (..., n!) → (..., n, n)."""
    h = weights @ flat_permut_matrices.to(weights.dtype)
    return h.reshape(*weights.shape[:-1], n, n)


class HCSet(nn.ModuleDict):
    """One HC bundle: parameter groups "norm", "res", "pre", "post" and, for
    mHC-lite, the fixed buffer ``_bvn_flat``, each read by ``bundle[name]``."""

    def __getitem__(self, key):
        return self._buffers[key] if key in self._buffers else super().__getitem__(key)


def _group(w, bias):
    return params(w=w, factor=torch.full((1,), 0.01, device=w.device), bias=bias, trainable=True)


# ---------------------------------------------------------------- classic HC


def init_hc_set(emb_dim, n, *, device=None):
    """A classic HC bundle: the dynamic maps zero, α 0.01, the papers' biases,
    the norm scale 1 (all fp32)."""
    z = dict(dtype=torch.float32, device=device)
    return HCSet({
        "norm": params(scale=torch.ones(emb_dim, **z), trainable=True),
        "res": _group(torch.zeros(emb_dim, n, **z), torch.eye(n, **z)),
        "pre": _group(torch.zeros(emb_dim, 1, **z), torch.full((n,), 1.0 / n, **z)),
        "post": _group(torch.zeros(emb_dim, 1, **z), torch.ones(n, **z)),
    })


def hc_res_matrix(p, x_norm):
    """H_res: (b, s, n, n) = tanh((x_norm·W)ᵀ)·α + I."""
    x = (x_norm.float() @ p["w"]).transpose(-1, -2)
    return torch.tanh(x) * p["factor"] + p["bias"]


def hc_pre_vector(p, x_norm):
    """(b, s, 1, n) stream-aggregation weights."""
    x = (x_norm.float() @ p["w"])[..., 0]
    return (torch.tanh(x) * p["factor"] + p["bias"])[..., None, :]


def hc_post_vector(p, x_norm):
    """(b, s, n, 1) broadcast weights."""
    x = (x_norm.float() @ p["w"])[..., 0]
    return (torch.tanh(x) * p["factor"] + p["bias"])[..., None]


# ----------------------------------------------------------------------- mHC


def init_mhc_set(emb_dim, n, *, lite=False, device=None):
    """An mHC (or, with ``lite``, mHC-lite) bundle over the flattened n·emb
    streams."""
    z = dict(dtype=torch.float32, device=device)
    d = n * emb_dim
    groups = {
        "norm": params(scale=torch.ones(d, **z), trainable=True),
        "pre": _group(torch.zeros(d, n, **z), torch.full((n,), -math.log(n - 1) if n > 1 else 10.0, **z)),
        "post": _group(torch.zeros(d, n, **z), torch.zeros(n, **z)),
    }
    if lite:
        flat, identity = permutation_matrices(n, device=device)
        bias = torch.full((math.factorial(n),), -8.0, **z)
        bias[identity] = 0.0
        groups["res"] = _group(torch.zeros(d, math.factorial(n), **z), bias)
    else:
        groups["res"] = _group(torch.zeros(d, n * n, **z), torch.eye(n, **z) * 8.0 - 8.0)
    bundle = HCSet(groups)
    if lite:
        bundle.register_buffer("_bvn_flat", flat)
    return bundle


def mhc_res_matrix(p, x_norm_flat, n, *, sk_iters=20):
    """mHC H_res: Sinkhorn-Knopp of exp(x·W·α + bias), (b, s, n, n)."""
    b, s, _ = x_norm_flat.shape
    x = (x_norm_flat.float() @ p["res"]["w"]).reshape(b, s, n, n)
    x = x * p["res"]["factor"] + p["res"]["bias"]
    return sinkhorn_knopp(torch.exp(x), max_iter=sk_iters)


def mhc_lite_res_matrix(p, x_norm_flat, n):
    """mHC-lite H_res: a softmax over the n! permutation weights, composed."""
    x = x_norm_flat.float() @ p["res"]["w"]
    x = x * p["res"]["factor"] + p["res"]["bias"]
    return bvn_compose(torch.softmax(x, dim=-1), p["_bvn_flat"], n)


def mhc_pre_vector(p, x_norm_flat):
    x = x_norm_flat.float() @ p["pre"]["w"] * p["pre"]["factor"] + p["pre"]["bias"]
    return torch.sigmoid(x)[..., None, :]  # (b, s, 1, n)


def mhc_post_vector(p, x_norm_flat):
    x = x_norm_flat.float() @ p["post"]["w"] * p["post"]["factor"] + p["post"]["bias"]
    return (torch.sigmoid(x) * 2.0)[..., None]  # (b, s, n, 1)


# --------------------------------------------------------- sub-block wiring


def _rms(scale, x, eps=1e-6):
    x32 = x.float()
    return scale * x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)


def hc_wrap(hc_params, x, sub_block_fn, *, hc_type="hc", n=4, sk_iters=20):
    """One HC-wrapped sub-block (attention or FFN): residual = H_res·x,
    y = sub_block_fn(H_pre·x), out = residual + H_post·y. x: (b, s, n, d)
    streams; the result keeps x's dtype."""
    b, s, _, d = x.shape
    x32 = x.float()
    if hc_type == "hc":
        x_norm = _rms(hc_params["norm"]["scale"], x)
        residual = hc_res_matrix(hc_params["res"], x_norm) @ x32
        single = (hc_pre_vector(hc_params["pre"], x_norm) @ x32)[..., 0, :]
        post = hc_post_vector(hc_params["post"], x_norm)
    elif hc_type in ("mhc", "mhc-lite"):
        x_flat = _rms(hc_params["norm"]["scale"], x.reshape(b, s, -1))
        if hc_type == "mhc":
            residual = mhc_res_matrix(hc_params, x_flat, n, sk_iters=sk_iters) @ x32
        else:
            residual = mhc_lite_res_matrix(hc_params, x_flat, n) @ x32
        single = (mhc_pre_vector(hc_params, x_flat) @ x32)[..., 0, :]
        post = mhc_post_vector(hc_params, x_flat)
    else:
        raise ValueError(f"hc_type must be 'hc', 'mhc' or 'mhc-lite', got {hc_type!r}")
    y = sub_block_fn(single.to(x.dtype))  # (b, s, d)
    return (residual + post * y.float()[..., None, :]).to(x.dtype)
