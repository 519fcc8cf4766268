"""Qwen3 and DeepSeek Mixture-of-Experts (counterpart of
``llm_quest_tpu/ops/moe.py``, the parts Qwen3-Next and MiMo-V2-Flash call).

- ``load_balance_loss``: N·Σ_i f_i·p_i; ``router_weights_init``: the
  sigma-MoE router re-init.
- ``expert_counts``, ``aux_free_bias_update`` (biases += rate·sign(mean −
  count)) and ``max_violation`` ((max − mean)/mean): the DeepSeek
  aux-loss-free balancing.
- ``ExpertStack``: stacked expert weights in the JAX layout, (E, d, hidden)
  for ``lin1``/``gate`` and (E, hidden, d) for ``lin2``, applied as ``x @
  w`` (no transpose on the way in from JAX); gated (``lin1``, ``gate``,
  ``lin2``) or not (``lin1``, ``lin2``), optionally with biases ``b1`` (E,
  hidden) and ``b2`` (E, d).
- ``dispatch``: sort-based dispatch. Assignments are flattened, stably
  sorted by expert id, run through the experts and scatter-added back to
  their tokens with their gate weights. ``capacity_factor=None`` is the
  exact (ragged) dispatch: every assignment computed, each expert's
  contiguous group through plain matmuls (JAX uses ``lax.ragged_dot``, an XLA
  op, not a Pallas kernel). The group sizes are read on the host, one device
  sync per call. A float is the GShard capacity dispatch: each expert takes
  at most C = ceil(int(cf·T·k)/E) rows, rounded up to a multiple of 8 and
  capped at T·k, in a dense (E, C, d) batch; the rows ranked past C within
  their expert (last in stable token order) go to a trash slot and are
  dropped.
- ``qwen3_moe``: fp32 gate softmax, top-k renormalised, LBL auxiliary loss,
  and the sigmoid-weighted shared expert.
- ``deepseek_moe``: fp32 gate softmax of ``x @ gate_w + gate_b``; the
  top-k taken on the probabilities plus the balancing ``biases``, the
  weights the unbiased probabilities renormalised; exact dispatch of the
  gated routed experts, plus every non-gated shared expert (``b1``/``b2``)
  on every token. ``DeepSeekMoE`` keeps ``biases`` as an fp32 buffer, not a
  parameter: it has no gradient and no optimizer touches it; the train step
  folds ``aux_free_bias_update`` into it after the optimizer step.
  Divergence by design: JAX keeps ``biases`` as a leaf of ``params``, so
  its AdamW (no mask) decays it by lr·wd·b every step; the reference keeps
  a non-gradient buffer, as the port does.
- int8 expert stacks (``ops/quantization.py::quantize_expert_stack_int8``:
  ``<name>_q`` (E, in, out) int8 and ``<name>_scale`` (E, out)): the exact
  dispatch sends each matrix to the grouped int8 matmul (K11,
  ``kernels/quantized_gmm.py``), which takes the group sizes on the device
  (no host sync); they keep the exact dispatch even when a capacity factor
  is given, and the shared expert's einsums multiply the scale after the
  product.

Classic and Latent MoE come with the models that call them.
"""

import torch
from torch import nn

from llm_quest_tpu_torch.ops.activations import silu


def load_balance_loss(gate_probas, topk_idxs, num_experts, top_k):
    """N · Σ_i f_i·p_i with f_i the share of assignments to expert i and p_i
    its mean gate probability."""
    t = gate_probas.shape[0]
    counts = torch.bincount(topk_idxs.reshape(-1), minlength=num_experts).float()
    f_i = counts / (top_k * t)
    p_i = gate_probas.float().mean(dim=0)
    return num_experts * (f_i @ p_i)


def router_weights_init(weights):
    """sigma-MoE router re-init: each expert's column (weights: (in, E))
    L2-normalised, then rescaled to the original standard deviation."""
    og_std = weights.std(unbiased=False)
    normed = weights / torch.linalg.vector_norm(weights, dim=0, keepdim=True)
    return normed * (og_std / normed.std(unbiased=False))


def expert_counts(topk_idxs, num_experts):
    """Assignments per expert (bincount of the top-k ids), fp32; no gradient."""
    return torch.bincount(topk_idxs.reshape(-1), minlength=num_experts).float()


def aux_free_bias_update(biases, counts, rate):
    """biases + rate·sign(mean(counts) − counts): under-used experts gain."""
    return biases + rate * torch.sign(counts.mean() - counts)


def max_violation(counts):
    """The load-balance metric (max − mean)/mean of the expert counts."""
    mean = counts.mean()
    return (counts.max() - mean) / mean


class ExpertStack(nn.ParameterDict):
    """Expert MLPs stacked on a leading expert axis (JAX layout): gated
    {"lin1", "gate", "lin2"} or not {"lin1", "lin2"}, with ``bias`` also
    {"b1", "b2"}."""

    def __init__(self, num_experts, d_in, hidden, *, dtype, device=None, gated=True, bias=False):
        shapes = {"lin1": (d_in, hidden), "gate": (d_in, hidden), "lin2": (hidden, d_in)}
        if not gated:
            del shapes["gate"]
        if bias:
            shapes.update(b1=(hidden,), b2=(d_in,))
        super().__init__({name: nn.Parameter(torch.empty(num_experts, *shape, dtype=dtype, device=device))
                          for name, shape in shapes.items()})

    def reset_parameters(self, generator):
        """U(±1/sqrt(d_in)) for lin1, gate and b1, U(±1/sqrt(hidden)) for lin2 and b2."""
        d_in, hidden = self["lin1"].shape[1:]
        for name, p in self.items():
            bound = 1.0 / (hidden if name in ("lin2", "b2") else d_in) ** 0.5
            p.uniform_(-bound, bound, generator=generator)


def _expert_mlp(x, lin1, gate, lin2, activation):
    """lin2(lin1(x) · act(gate(x))), the gate branch activated as in the
    reference Expert."""
    return (x @ lin1 * activation(x @ gate)) @ lin2


def _ragged(experts, name, x, group_sizes, plain):
    """One int8 stacked matrix over expert-sorted rows: K11 (the scale is its
    epilogue; each output row belongs to one expert group)."""
    from llm_quest_tpu_torch.kernels.quantized_gmm import quantized_ragged_dot

    return quantized_ragged_dot(x, experts[name + "_q"], experts[name + "_scale"], group_sizes, plain=plain)


def _expert_mlp_ragged(experts, x_sorted, group_sizes, activation, plain=False):
    """The expert MLP over expert-sorted rows. group_sizes: (E,) tensor.
    int8 stacks go through K11 with the sizes on the device; fp stacks take
    one expert's contiguous group at a time (the sizes read on the host)."""
    if "lin1_q" in experts:
        h = _ragged(experts, "lin1", x_sorted, group_sizes, plain)
        h = h * activation(_ragged(experts, "gate", x_sorted, group_sizes, plain))
        return _ragged(experts, "lin2", h, group_sizes, plain)
    group_sizes = group_sizes.tolist()
    outs = [
        _expert_mlp(xg, experts["lin1"][e], experts["gate"][e], experts["lin2"][e], activation)
        for e, xg in enumerate(torch.split(x_sorted, group_sizes))
        if xg.shape[0]
    ]
    if not outs:
        return x_sorted.new_zeros(0, experts["lin2"].shape[-1])
    return torch.cat(outs)


def _expert_mlp_dense(experts, xe, activation):
    """The expert MLP over a dense (E, C, d) capacity batch: batched matmuls."""
    return _expert_mlp(xe, experts["lin1"], experts["gate"], experts["lin2"], activation)


def dispatch(experts, x2d, topk_idxs, topk_weights, num_experts, *, activation=silu, capacity_factor=None,
             plain=False):
    """x2d: (T, d); topk_idxs/topk_weights: (T, k). Returns (T, d_out): the
    sum over each token's k experts of weight·expert(x). ``plain`` runs K11's
    plain version (int8 stacks; comparisons only)."""
    t, k = topk_idxs.shape
    d_out = (experts["lin2"] if "lin2" in experts else experts["lin2_q"]).shape[-1]
    if "lin1" not in experts:
        capacity_factor = None  # int8 stacks keep the exact path (K11)
    flat_expert = topk_idxs.reshape(-1)
    flat_weight = topk_weights.reshape(-1)
    token_of = torch.arange(t, device=x2d.device).repeat_interleave(k)

    order = torch.argsort(flat_expert, stable=True)
    expert_sorted = flat_expert[order]
    group_sizes = torch.bincount(flat_expert, minlength=num_experts)
    token_sorted = token_of[order]
    x_sorted = x2d[token_sorted]

    if capacity_factor is not None:
        cap = -(-int(capacity_factor * t * k) // num_experts)
        cap = min(-(-cap // 8) * 8, t * k)  # multiple of 8, never above T·k
        starts = torch.cumsum(group_sizes, 0) - group_sizes
        rank = torch.arange(t * k, device=x2d.device) - starts[expert_sorted]  # position within its group
        keep = rank < cap
        # slot in the (E·C + 1 trash) padded buffer; dropped rows go to the trash
        dest = torch.where(keep, expert_sorted * cap + rank.clamp_max(cap - 1), num_experts * cap)
        xe = x2d.new_zeros(num_experts * cap + 1, x2d.shape[1]).index_put((dest,), x_sorted)
        he = _expert_mlp_dense(experts, xe[: num_experts * cap].reshape(num_experts, cap, -1), activation)
        out_rows = he.reshape(num_experts * cap, d_out)[dest.clamp_max(num_experts * cap - 1)]
        out_rows = out_rows * (flat_weight[order] * keep)[:, None].to(he.dtype)
        return out_rows.new_zeros(t, d_out).index_add(0, token_sorted, out_rows)

    out_sorted = _expert_mlp_ragged(experts, x_sorted, group_sizes, activation, plain)
    out_sorted = out_sorted * flat_weight[order][:, None].to(out_sorted.dtype)
    return out_sorted.new_zeros(t, d_out).index_add(0, token_sorted, out_sorted)


def _shared_einsum(shared, name, spec, x):
    """A batched-over-experts einsum on one stacked matrix; an int8 stack
    multiplies its (E, out) scale into the product."""
    if name + "_q" in shared:
        y = torch.einsum(spec, x, shared[name + "_q"].to(x.dtype))
        return y * shared[name + "_scale"][None].to(y.dtype)
    return torch.einsum(spec, x, shared[name])


def _shared_experts_sum(shared, x2d, activation=silu):
    """Every shared expert on every token, summed over the experts: gated,
    lin2(lin1(x) · act(gate(x))), or not, lin2(act(lin1(x) + b1)) + b2."""
    h = _shared_einsum(shared, "lin1", "td,edh->teh", x2d)
    if "b1" in shared:
        h = h + shared["b1"][None]
    if "gate" in shared or "gate_q" in shared:
        h = h * activation(_shared_einsum(shared, "gate", "td,edh->teh", x2d))
    else:
        h = activation(h)
    out = _shared_einsum(shared, "lin2", "teh,ehd->ted", h)
    if "b2" in shared:
        out = out + shared["b2"][None]
    return out.sum(dim=1)


class Qwen3MoE(nn.Module):
    """Parameters {"experts", "gate_w" (d, E)[, "shared", "shared_gate_w" (d, 1)]}
    under the JAX tree's names."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, e = cfg["emb_dim"], cfg["num_experts"]
        self.re_init_router = cfg.get("re_init_router_weights", False)
        self.experts = ExpertStack(e, d, cfg["moe_hidden_dim"], dtype=dtype, device=device)
        self.gate_w = nn.Parameter(torch.empty(d, e, dtype=dtype, device=device))
        shared_hidden = cfg.get("shared_expert_hidden_dim")
        if shared_hidden is not None:
            self.shared = ExpertStack(1, d, shared_hidden, dtype=dtype, device=device)
            self.shared_gate_w = nn.Parameter(torch.empty(d, 1, dtype=dtype, device=device))

    def reset_parameters(self, generator):
        """The router and the shared gate U(±1/sqrt(d)); the router then
        re-initialised when the config asks for it."""
        bound = 1.0 / self.gate_w.shape[0] ** 0.5
        self.gate_w.uniform_(-bound, bound, generator=generator)
        if self.re_init_router:
            self.gate_w.copy_(router_weights_init(self.gate_w))
        if hasattr(self, "shared_gate_w"):
            self.shared_gate_w.uniform_(-bound, bound, generator=generator)


def qwen3_moe(params, x, *, top_k, load_coeff, training=True, capacity_factor=None, plain=False):
    """x: (b, s, d). Returns (out, aux); aux has "gate_probas" (T, E) fp32 and,
    when training, "moe_loss" = load_coeff · LBL. (JAX's ``gate_probas``
    argument, the RL routing replay, comes with the alignment trainers.)
    ``plain`` runs K11's plain version (int8 stacks; comparisons only)."""
    b, s, d = x.shape
    experts = params.experts
    num_experts = (experts["lin1"] if "lin1" in experts else experts["lin1_q"]).shape[0]
    x2d = x.reshape(-1, d)
    gate_probas = torch.softmax((x2d @ params.gate_w).float(), dim=-1)

    topk_probas, topk_idxs = torch.topk(gate_probas, top_k, dim=-1)
    topk_probas = topk_probas / topk_probas.sum(dim=-1, keepdim=True)

    aux = {"gate_probas": gate_probas}
    if training:
        aux["moe_loss"] = load_coeff * load_balance_loss(gate_probas, topk_idxs, num_experts, top_k)

    out = dispatch(experts, x2d, topk_idxs, topk_probas, num_experts, capacity_factor=capacity_factor, plain=plain)
    if hasattr(params, "shared"):
        shared_w = torch.sigmoid(x2d @ params.shared_gate_w)
        out = out + _shared_experts_sum(params.shared, x2d) * shared_w.to(out.dtype)
    return out.reshape(b, s, d), aux


class DeepSeekMoE(nn.Module):
    """Parameters {"routed" (gated stack), "gate_w" (d, E), "gate_b" (E,)[,
    "shared" (non-gated stack with biases)]} and the fp32 buffer "biases"
    (E,), under the JAX tree's names. E counts the routed experts:
    ``num_experts − num_shared_experts``; each expert's width is
    int(``moe_scaling_factor`` · ``hidden_dim``), "auto" being 1/(top_k +
    num_shared)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        d, num_shared = cfg["emb_dim"], cfg["num_shared_experts"]
        sf = cfg["moe_scaling_factor"]
        if sf == "auto":
            sf = 1 / (cfg["top_k"] + num_shared)
        hidden = int(sf * cfg["hidden_dim"])
        num_routed = cfg["num_experts"] - num_shared
        self.routed = ExpertStack(num_routed, d, hidden, dtype=dtype, device=device)
        self.gate_w = nn.Parameter(torch.empty(d, num_routed, dtype=dtype, device=device))
        self.gate_b = nn.Parameter(torch.empty(num_routed, dtype=dtype, device=device))
        self.register_buffer("biases", torch.zeros(num_routed, dtype=torch.float32, device=device))
        if num_shared > 0:
            self.shared = ExpertStack(num_shared, d, hidden, dtype=dtype, device=device, gated=False, bias=True)

    def reset_parameters(self, generator):
        """The router's weight and bias U(±1/sqrt(d)); the biases zero."""
        bound = 1.0 / self.gate_w.shape[0] ** 0.5
        self.gate_w.uniform_(-bound, bound, generator=generator)
        self.gate_b.uniform_(-bound, bound, generator=generator)
        self.biases.zero_()


def deepseek_moe(params, x, *, top_k):
    """x: (b, s, d). Returns (out, aux); aux has "counts" (E,) fp32, to fold
    into the biases with ``aux_free_bias_update`` after the optimizer step,
    and "max_vio"."""
    b, s, d = x.shape
    num_routed = params.gate_w.shape[-1]
    x2d = x.reshape(-1, d)
    gate_probas = torch.softmax((x2d @ params.gate_w + params.gate_b).float(), dim=-1)
    topk_idxs = torch.topk(gate_probas + params.biases, top_k, dim=-1).indices
    topk_probas = gate_probas.gather(-1, topk_idxs)  # unbiased weights
    topk_probas = topk_probas / topk_probas.sum(dim=-1, keepdim=True)

    out = dispatch(params.routed, x2d, topk_idxs, topk_probas, num_routed)
    if hasattr(params, "shared"):
        out = _shared_experts_sum(params.shared, x2d) + out
    counts = expert_counts(topk_idxs, num_routed)
    return out.reshape(b, s, d), {"counts": counts, "max_vio": max_violation(counts)}
