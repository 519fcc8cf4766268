"""LoRA family: classic LoRA, LoRA-XS, TinyLoRA, and stacked adapters for
multi-LoRA serving (counterpart of ``llm_quest_tpu/ops/lora.py``, function
by function under its names).

- LoRA: y = xW + α/r·xAB; A ~ N(0, 0.02), B zero-init.
- LoRA-XS: frozen A = U_r·Σ_r, B = V_rᵀ from the truncated SVD of W;
  trainable (r, r) R ~ N(0, 1e-5); y = xW + α/r·xARB.
- TinyLoRA: R = (v @ P).reshape(r, r) from u trainable scalars v and fixed
  N(0, 1) matrices P; v optionally tied across layers.

A wrapped linear (``ops/linear.py::Linear`` or
``ops/quantization.py::QuantLinear``) carries a ``lora`` submodule, a
``LoRA``, whose parameters keep JAX's leaf names (``A``, ``B``, ``R``,
``P``, ``v``, ``scale``), so state-dict keys mirror the JAX paths
(``blocks.3.att.wq.lora.A`` is ``blocks/3/att/wq/lora/A`` there). The
linear adds ``lora_delta`` to its output when the submodule is present, as
JAX's ``linear`` does. A and B keep JAX's layouts, (in, r) and (r, out):
``x @ A @ B`` needs no transpose, and ``from_jax_flat`` copies them as they
are.

Stacked adapters (``stack_adapters``) carry a leading adapter axis, the
null adapter (zero update) last. All stacked ``LoRA``s of one model share
one ``AdapterIndex``: ``select_adapter`` sets its (b,) row ids once, and
every linear of the next call gathers row i's adapter ``idx[i]``. JAX pins
the index into every lora dict by a tree transform inside its jitted
programs; here a walk over ~190 modules on every eager call would cost the
host more than the adapter term itself.

Divergences by design:
- the transforms change the model in place and return it (torch modules
  are mutable; as ``quantize_params_int8``); ``merge_adapter`` returns a new
  model, the stacked one left as it is;
- freezing is ``requires_grad``: ``lora_trainable_mask`` sets it (only A/B,
  R or v train) and returns the mask by state-dict name, where JAX returns
  a bool pytree for ``optax``;
- a tied TinyLoRA v is one shared ``nn.Parameter`` (``inject_shared_v``),
  whose gradient autograd already sums over the layers;
  ``collect_shared_v_grad`` adds the gradients of the DISTINCT v parameters,
  which is that sum, as JAX's sum of the per-layer v gradients is;
- the single (unstacked) delta computes in x's dtype, as JAX's stacked form
  does (JAX's single form promotes a bf16 x against fp32 factors; the
  port's linears do not promote);
- randomness comes from a ``torch.Generator`` (JAX: a key folded with a
  counter per linear), so the draws differ; the SVD inits are numpy's, as
  JAX's, and equal on equal weights.
"""

import numpy as np
import torch
from torch import nn


class AdapterIndex:
    """The (b,) adapter ids of the current call, shared by every stacked
    ``LoRA`` of one model (``select_adapter`` sets them)."""

    __slots__ = ("idx",)

    def __init__(self):
        self.idx = None


class LoRA(nn.Module):
    """One linear's adapter: frozen parameters under JAX's leaf names (A,
    B, scale; R for LoRA-XS; P and v for TinyLoRA), stacked with a leading
    adapter axis when ``index`` is given."""

    def __init__(self, index=None, **tensors):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, t if isinstance(t, nn.Parameter) else nn.Parameter(t, requires_grad=False))
        self.index = index

    def __contains__(self, name):
        return name in self._parameters

    def __getitem__(self, name):
        return self._parameters[name]

    def keys(self):
        return self._parameters.keys()

    @property
    def stacked(self):
        return self._parameters["A"].ndim == 3


def _linear_classes():
    from llm_quest_tpu_torch.ops.linear import Linear
    from llm_quest_tpu_torch.ops.quantization import QuantLinear

    return Linear, QuantLinear


def _dense_weight(linear):
    """The (in, out) fp32 weight of a plain or quantized (int8 or int4)
    linear (JAX's layout): what the SVD inits and the merge read."""
    if hasattr(linear, "w_q"):
        from llm_quest_tpu_torch.ops.quantization import dequantize_int8

        return dequantize_int8(linear.w_q, linear.w_scale, linear.d_in).T
    return linear.w.T


def _randn(generator, shape, dtype, device):
    gen_device = generator.device if generator is not None else "cpu"
    return torch.randn(shape, generator=generator, device=gen_device).to(device=device, dtype=dtype)


def _svd(linear, r):
    w = _dense_weight(linear).detach()
    u, s, vt = np.linalg.svd(w.float().cpu().numpy(), full_matrices=False)
    return torch.from_numpy(u[:, :r] @ np.diag(s[:r])), torch.from_numpy(np.ascontiguousarray(vt[:r, :]))


def init_lora(generator, linear, r, alpha, *, dtype=None):
    """Classic LoRA for a ``Linear`` (or quantized ``QuantLinear``, whose
    factors take its scales' dtype, fp32, as JAX's)."""
    w = linear.w_q if hasattr(linear, "w_q") else linear.w
    dtype = dtype or (linear.w_scale.dtype if hasattr(linear, "w_q") else w.dtype)
    k, d = w.shape[0], getattr(linear, "d_in", w.shape[1])  # an int4 weight's in-width is its logical one
    return LoRA(A=0.02 * _randn(generator, (d, r), dtype, w.device),
                B=torch.zeros(r, k, dtype=dtype, device=w.device),
                scale=torch.tensor(alpha / r, dtype=torch.float32, device=w.device))


def init_lora_xs(generator, linear, r, alpha, *, dtype=None):
    """LoRA-XS: frozen truncated-SVD A/B, trainable R."""
    w = _dense_weight(linear)
    dtype = dtype or w.dtype
    A, B = _svd(linear, r)
    return LoRA(A=A.to(w.device, dtype), B=B.to(w.device, dtype), R=1e-5 * _randn(generator, (r, r), dtype, w.device),
                scale=torch.tensor(alpha / r, dtype=torch.float32, device=w.device))


def init_tiny_lora(generator, linear, r, alpha, *, num_trainable_params=13, shared_v=False, dtype=None):
    """TinyLoRA: frozen SVD A/B and fixed P; trainable v (absent when tied:
    ``inject_shared_v`` sets it)."""
    w = _dense_weight(linear)
    dtype = dtype or w.dtype
    A, B = _svd(linear, r)
    tensors = {"A": A.to(w.device, dtype), "B": B.to(w.device, dtype),
               "P": _randn(generator, (num_trainable_params, r * r), dtype, w.device),
               "scale": torch.tensor(alpha / r, dtype=torch.float32, device=w.device)}
    if not shared_v:
        tensors["v"] = torch.zeros(num_trainable_params, dtype=dtype, device=w.device)
    return LoRA(**tensors)


def lora_delta(lora, x):
    """The low-rank update α/r · x·(update) of any variant (by its leaves).

    Stacked: row i of x takes adapter ``idx[i]`` of the shared index, by a
    per-row gather and batched products; (b, d) decode-step inputs and (b,
    s, d) prefill inputs go through the same products."""
    if lora.stacked:
        idx = lora.index.idx
        if idx is None:
            raise ValueError("stacked adapters need select_adapter(model, idx) before the call")
        r = lora["A"].shape[-1]
        shape = x.shape
        xs = x.reshape(shape[0], -1, shape[-1])
        xa = torch.bmm(xs, lora["A"][idx].to(x.dtype))  # (b, s, r)
        if "P" in lora:  # TinyLoRA
            R = torch.bmm(lora["v"][idx][:, None], lora["P"][idx])[:, 0].reshape(-1, r, r)
            xa = torch.bmm(xa, R.to(x.dtype))
        elif "R" in lora:  # LoRA-XS
            xa = torch.bmm(xa, lora["R"][idx].to(x.dtype))
        scale = lora["scale"][idx].to(x.dtype)[:, None, None]
        out = scale * torch.bmm(xa, lora["B"][idx].to(x.dtype))
        return out.reshape(*shape[:-1], out.shape[-1])
    A, B = lora["A"].to(x.dtype), lora["B"].to(x.dtype)
    scale = lora["scale"].to(x.dtype)
    if "P" in lora:  # TinyLoRA
        r = A.shape[-1]
        R = (lora["v"] @ lora["P"]).reshape(r, r)
        return scale * (x @ A @ R.to(x.dtype) @ B)
    if "R" in lora:  # LoRA-XS
        return scale * (x @ A @ lora["R"].to(x.dtype) @ B)
    return scale * (x @ A @ B)  # classic


def _path(name):
    """A module name as the JAX walk spells its path ("/blocks/3/att/wq")."""
    return "/" + name.replace(".", "/")


def replace_with_lora(generator, params, rank, alpha, *, variant="lora", path_filter=None, **kw):
    """Give every matching linear of ``params`` (a model) a ``lora``
    submodule, in place; returns the model. ``path_filter(path)`` limits
    the wrap (JAX's path string, e.g. ``lambda p: "att" in p``). A linear
    whose own name holds "conv" or "emb" never wraps (JAX's rule). An
    already wrapped linear gets a new adapter."""
    init_fn = {"lora": init_lora, "lora_xs": init_lora_xs, "tiny_lora": init_tiny_lora}[variant]
    linears = _linear_classes()
    for name, module in list(params.named_modules()):
        last = name.rsplit(".", 1)[-1]
        if "conv" in last or "emb" in last or not isinstance(module, linears):
            continue
        if path_filter is None or path_filter(_path(name)):
            module.lora = init_fn(generator, module, rank, alpha, **kw)
    return params


def lora_modules(params):
    """[(module name, LoRA)] of the model's wrapped linears, in module order."""
    return [(name, m) for name, m in params.named_modules() if isinstance(m, LoRA)]


def lora_trainable_mask(params):
    """Freeze everything but the trainable LoRA leaves (A/B for LoRA, R for
    LoRA-XS, v for TinyLoRA) through ``requires_grad``, in place; returns
    {state-dict name: trainable} (JAX's mask pytree, flattened)."""
    for p in params.parameters():
        p.requires_grad_(False)
    for _, lora in lora_modules(params):
        trainable = {"v"} if "v" in lora else {"R"} if "R" in lora else {"A", "B"}
        for leaf in trainable:
            lora[leaf].requires_grad_(True)
    return {name: t.requires_grad for name, t in params.state_dict(keep_vars=True).items()}


def inject_shared_v(params, v):
    """Tie one TinyLoRA v across all layers: the same ``nn.Parameter`` on
    every TinyLoRA (set or replaced). Returns the model."""
    if not isinstance(v, nn.Parameter):
        v = nn.Parameter(v)
    for _, lora in lora_modules(params):
        if "P" in lora:
            lora.v = v
    return params


def collect_shared_v_grad(params):
    """The tied-v gradient: the sum of the gradients of the distinct
    TinyLoRA v parameters (one shared v: its gradient, which autograd has
    summed over the layers already)."""
    seen, total = set(), None
    for _, lora in lora_modules(params):
        v = lora._parameters.get("v") if "P" in lora else None
        if v is None or id(v) in seen or v.grad is None:
            continue
        seen.add(id(v))
        total = v.grad.clone() if total is None else total + v.grad
    return total


# ---------------------------------------------------------- multi-adapter


def stack_adapters(adapter_params):
    """Stack n same-rank adapters into the FIRST model, in place: each model
    (from ``replace_with_lora`` over the same base) gives its ``lora`` of
    every wrapped linear; the first model's linears get ``LoRA``s with a
    leading adapter axis, the null adapter (zero update, the first scale)
    appended at index n, sharing one ``AdapterIndex``. Base parameters are
    the first model's. Returns the first model."""
    first, *rest = adapter_params
    index = AdapterIndex()
    for name, lora in lora_modules(first):
        rows = {leaf: [lora[leaf]] + [m.get_submodule(name)[leaf] for m in rest] for leaf in lora.keys()}
        stacked = {leaf: torch.stack([t.detach() for t in ts] + [ts[0].detach() if leaf == "scale" else
                                                                 torch.zeros_like(ts[0])])
                   for leaf, ts in rows.items()}
        parent, _, child = name.rpartition(".")
        first.get_submodule(parent).add_module(child, LoRA(index=index, **stacked))
    first._lora_index = index
    return first


def num_adapters(params):
    """The number of stacked adapters (the null included) of a model, or 0
    without stacked adapters."""
    for _, lora in lora_modules(params):
        if lora.stacked:
            return lora["A"].shape[0]
    return 0


def _index_of(params):
    index = params.__dict__.get("_lora_index")
    if index is None:
        index = next((lora.index for _, lora in lora_modules(params) if lora.stacked), None)
        params._lora_index = index
    return index


def select_adapter(params, idx):
    """Select adapter ``idx[i]`` (a (b,) integer tensor on the model's
    device) for row i of the next calls, through the model's shared index;
    a model without stacked adapters is left as it is. Returns the model."""
    index = _index_of(params)
    if index is not None:
        index.idx = idx
    return params


def merge_adapter(params, j):
    """A new model with stacked adapter ``j`` merged dense into the base
    weights (w + scale·U) and the stacked adapters dropped: the
    single-adapter deployment form, and the oracle of per-row selection. An
    int8 base merges dense in fp32 over its dequantized weights (JAX's
    rule)."""
    import copy

    Linear, _ = _linear_classes()
    merged = copy.deepcopy(params)
    merged.__dict__.pop("_lora_index", None)
    for name, module in list(merged.named_modules()):
        lora = module._modules.get("lora")
        if lora is None or not lora.stacked:
            continue
        A, B = lora["A"][j], lora["B"][j]
        if "P" in lora:  # TinyLoRA
            r = A.shape[-1]
            U = A @ (lora["v"][j] @ lora["P"][j]).reshape(r, r).to(A.dtype) @ B
        elif "R" in lora:  # LoRA-XS
            U = A @ lora["R"][j] @ B
        else:
            U = A @ B
        U = lora["scale"][j].to(U.dtype) * U
        base = _dense_weight(module)
        w = (base + U.to(base.dtype)).to(base.dtype)
        b = module.b
        dense = Linear(w.shape[0], w.shape[1], bias=b is not None, dtype=w.dtype, device=w.device)
        with torch.no_grad():
            dense.w.copy_(w.T)
            if b is not None:
                dense.b.copy_(b)
        parent, _, child = name.rpartition(".")
        merged.get_submodule(parent).add_module(child, dense)
    return merged


def lora_like(params, names):
    """Give ``params`` the adapters of a JAX tree in place (for
    ``from_jax_flat``): ``names`` maps each "."-joined leaf name to its
    array; every linear with "<name>.lora.A" gets an empty ``LoRA`` of those
    leaves' shapes and dtypes (stacked ones sharing one ``AdapterIndex``)."""
    index, linears = None, _linear_classes()
    for name, module in list(params.named_modules()):
        prefix = f"{name}.lora."
        if not isinstance(module, linears) or prefix + "A" not in names:
            continue
        device = next(module.parameters()).device
        leaves = {}
        for key, arr in names.items():
            if key.startswith(prefix) and "." not in key[len(prefix):]:
                bf16 = arr.dtype.name == "bfloat16"  # numpy's bf16 (ml_dtypes) has no torch view
                dtype = torch.bfloat16 if bf16 else torch.from_numpy(np.zeros(0, arr.dtype)).dtype
                leaves[key[len(prefix):]] = torch.empty(arr.shape, dtype=dtype, device=device)
        stacked = leaves["A"].ndim == 3
        if stacked and index is None:
            index = AdapterIndex()
        module.lora = LoRA(index=index if stacked else None, **leaves)
    if index is not None:
        params._lora_index = index
