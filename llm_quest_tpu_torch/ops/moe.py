"""Mixture-of-Experts layers: Qwen3, DeepSeek, classic and Latent (counterpart
of ``llm_quest_tpu/ops/moe.py``).

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
  sorted by expert id, run through the experts and returned to their
  tokens with their gate weights, each token summing its k rows in rank
  order (JAX scatter-adds them; on the card a scatter-add's atomics land
  in any order, so its bits would vary run to run). ``capacity_factor=None`` is the
  exact (ragged) dispatch: every assignment computed, each expert's
  contiguous group through plain matmuls (JAX uses ``lax.ragged_dot``, an XLA
  op, not a Pallas kernel). The group sizes are counted on the device into a
  fixed (E,) tensor (``assignment_counts``: no host read, where
  ``torch.bincount`` sizes its output from the ids' max on the card); the fp
  stacks' exact branch then reads them on the host, one device sync per
  call (ROADMAP perf note b). A float is the GShard capacity dispatch: each expert takes
  at most C = ceil(int(cf·T·k)/E) rows, rounded up to a multiple of 8 and
  capped at T·k, in a dense (E, C, d) batch; the rows ranked past C within
  their expert (last in stable token order) go to a trash slot and are
  dropped.
- ``qwen3_moe``: fp32 gate softmax, top-k renormalised, LBL auxiliary loss,
  and the sigmoid-weighted shared expert; ``gate_probas=`` replays a
  routing (the RL routing replay).
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
- int8 and int4 expert stacks (``ops/quantization.py::quantize_expert_stack_int8``:
  ``<name>_q`` (E, in, out) int8 or (E, ⌈in/2⌉, out) packed int4, and
  ``<name>_scale`` (E, out)): the exact
  dispatch sends each matrix to the grouped quantized matmul (K11,
  ``kernels/quantized_gmm.py``), which takes the group sizes on the device,
  so a quantized MoE layer makes no host sync; they keep the exact dispatch even when a capacity factor
  is given, and the shared expert's einsums multiply the scale after the
  product (an int4 shared stack unpacked into x's dtype first).
- ``classic_moe``: a softmax router with a bias, top-k renormalised, the
  exact dispatch of non-gated biased GELU experts, and the z-router loss
  (``z_router_loss``) plus the LBL; ``init_classic_moe`` / ``ClassicMoE``.
- ``latent_moe``: Nvidia's LatentMoE, routed experts in the latent width
  behind the down and up projections, a sigmoid router with balancing
  ``biases`` (an fp32 buffer, as ``DeepSeekMoE``'s: the same divergence by
  design), ``routed_scaling_factor``, squared-ReLU experts (``squared_relu``)
  and a full-width shared expert; ``init_latent_moe`` / ``LatentMoE``,
  ``latent_top_k``.
- Quantized stacks of every form (gated or not, with biases or not, int8 or
  int4) go through K11 in the exact dispatch; the non-gated biased form is
  act(lin1(x) + b1), then lin2, then + b2, for bf16 stacks as for quantized
  ones and in the capacity batch (``_mlp``).
"""

import torch
from torch import nn

from llm_quest_tpu_torch.ops.activations import gelu_erf, silu


def assignment_counts(topk_idxs, num_experts):
    """Assignments per expert, (E,) int64, counted on the device into a
    tensor of fixed size (``torch.bincount`` gives the same counts but sizes
    its output from the ids' max, a host read on the card)."""
    flat = topk_idxs.reshape(-1)
    return torch.zeros(num_experts, dtype=torch.long, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.long))


def load_balance_loss(gate_probas, topk_idxs, num_experts, top_k):
    """N · Σ_i f_i·p_i with f_i the share of assignments to expert i and p_i
    its mean gate probability."""
    t = gate_probas.shape[0]
    counts = assignment_counts(topk_idxs, num_experts).float()
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
    """Assignments per expert (the count of the top-k ids), fp32; no gradient."""
    return assignment_counts(topk_idxs, num_experts).float()


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


def _mlp(experts, x, mm, bias, activation):
    """An expert MLP over rows ``x`` through ``mm(name, x)`` (one stacked
    matrix) and ``bias(name)`` (the bias rows that meet x's rows): gated,
    lin2(lin1(x) · act(gate(x))), the gate branch activated as in the
    reference Expert; or not, act(lin1(x) + b1), then lin2, then + b2
    (the classic and shared experts)."""
    h = mm("lin1", x)
    if "b1" in experts:
        h = h + bias("b1")
    if "gate" in experts or "gate_q" in experts:
        h = h * activation(mm("gate", x))
    else:
        h = activation(h)
    out = mm("lin2", h)
    return out + bias("b2") if "b2" in experts else out


def _ragged(experts, name, x, group_sizes, plain):
    """One int8 or int4 stacked matrix over expert-sorted rows: K11 (the
    scale is its epilogue; each output row belongs to one expert group)."""
    from llm_quest_tpu_torch.kernels.quantized_gmm import quantized_ragged_dot

    return quantized_ragged_dot(x, experts[name + "_q"], experts[name + "_scale"], group_sizes, plain=plain)


def _expert_mlp_ragged(experts, x_sorted, group_sizes, expert_sorted, activation, plain=False):
    """The expert MLP over expert-sorted rows. group_sizes: (E,) tensor;
    expert_sorted: each row's expert (its bias rows). int8 and int4 stacks
    go through K11 with the sizes on the device; fp stacks take one expert's
    contiguous group at a time (the sizes read on the host)."""
    if "lin1_q" in experts:
        return _mlp(experts, x_sorted, lambda name, x: _ragged(experts, name, x, group_sizes, plain),
                    lambda name: experts[name][expert_sorted], activation)
    outs = [
        _mlp(experts, xg, lambda name, x, e=e: x @ experts[name][e], lambda name, e=e: experts[name][e], activation)
        for e, xg in enumerate(torch.split(x_sorted, group_sizes.tolist()))
        if xg.shape[0]
    ]
    if not outs:
        return x_sorted.new_zeros(0, experts["lin2"].shape[-1])
    return torch.cat(outs)


def _expert_mlp_dense(experts, xe, activation):
    """The expert MLP over a dense (E, C, d) capacity batch: batched matmuls."""
    return _mlp(experts, xe, lambda name, x: x @ experts[name], lambda name: experts[name][:, None], activation)


def dispatch(experts, x2d, topk_idxs, topk_weights, num_experts, *, activation=silu, capacity_factor=None,
             plain=False):
    """x2d: (T, d); topk_idxs/topk_weights: (T, k). Returns (T, d_out): the
    sum over each token's k experts of weight·expert(x). ``plain`` runs K11's
    plain version (quantized stacks; comparisons only)."""
    t, k = topk_idxs.shape
    d_out = (experts["lin2"] if "lin2" in experts else experts["lin2_q"]).shape[-1]
    if "lin1" not in experts:
        capacity_factor = None  # quantized stacks keep the exact path (K11)
    flat_expert = topk_idxs.reshape(-1)
    flat_weight = topk_weights.reshape(-1)
    token_of = torch.arange(t, device=x2d.device)[:, None].expand(t, k).reshape(-1)  # each token k times

    order = torch.argsort(flat_expert, stable=True)
    expert_sorted = flat_expert[order]
    group_sizes = assignment_counts(flat_expert, num_experts)
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
        return _combine(out_rows, order, t, k)

    out_sorted = _expert_mlp_ragged(experts, x_sorted, group_sizes, expert_sorted, activation, plain)
    out_sorted = out_sorted * flat_weight[order][:, None].to(out_sorted.dtype)
    return _combine(out_sorted, order, t, k)


def _combine(rows_sorted, order, t, k):
    """(T·k, d) weighted expert rows in expert order back to their tokens:
    each row returns to its assignment slot (``order`` is a permutation, so
    the write is a plain scatter), then each token sums its k slots in
    rank order. The same bits every run, where a scatter-add into the
    tokens adds in the order its atomics land on the card."""
    rows = torch.empty_like(rows_sorted)
    rows[order] = rows_sorted
    return rows.reshape(t, k, -1).sum(dim=1)


def _shared_einsum(shared, name, spec, x):
    """A batched-over-experts einsum on one stacked matrix; a quantized
    stack (int4 unpacked into x's dtype) multiplies its (E, out) scale into
    the product."""
    if name + "_q" in shared:
        from llm_quest_tpu_torch.ops.quantization import integer_weight

        w = integer_weight(shared[name + "_q"], x.shape[-1], x.dtype)
        return torch.einsum(spec, x, w) * shared[name + "_scale"][None].to(x.dtype)
    return torch.einsum(spec, x, shared[name])


def _shared_experts_sum(shared, x2d, activation=silu):
    """Every shared expert on every token (``_mlp``'s forms), summed over the experts."""
    out = _mlp(shared, x2d,
               lambda name, x: _shared_einsum(shared, name, "teh,ehd->ted" if name == "lin2" else "td,edh->teh", x),
               lambda name: shared[name][None], activation)
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


def qwen3_moe(params, x, *, top_k, load_coeff, gate_probas=None, training=True, capacity_factor=None,
              plain=False):
    """x: (b, s, d). Returns (out, aux); aux has "gate_probas" (T, E) fp32 and,
    when training, "moe_loss" = load_coeff · LBL. ``gate_probas`` (b·s, E),
    the RL routing replay, takes the place of the router's probabilities:
    the same experts and weights as the run that returned them.
    ``plain`` runs K11's plain version (quantized stacks; comparisons only)."""
    b, s, d = x.shape
    experts = params.experts
    num_experts = (experts["lin1"] if "lin1" in experts else experts["lin1_q"]).shape[0]
    x2d = x.reshape(-1, d)
    if gate_probas is None:
        gate_probas = torch.softmax((x2d @ params.gate_w).float(), dim=-1)
    elif gate_probas.ndim != 2:
        raise ValueError(f"gate_probas must be (batch*seq, num_experts), got {tuple(gate_probas.shape)}")

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


# ------------------------------------------------------------------ classic MoE


def z_router_loss(gate_logits):
    """mean(logsumexp(logits)²), in fp32."""
    return (torch.logsumexp(gate_logits.float(), dim=-1) ** 2).mean()


class ClassicMoE(nn.Module):
    """Parameters {"experts" (non-gated stack with biases), "gate_w" (d, E),
    "gate_b" (E,)} under the JAX tree's names."""

    def __init__(self, d, num_experts, hidden, dtype, device=None):
        super().__init__()
        self.experts = ExpertStack(num_experts, d, hidden, dtype=dtype, device=device, gated=False, bias=True)
        self.gate_w = nn.Parameter(torch.empty(d, num_experts, dtype=dtype, device=device))
        self.gate_b = nn.Parameter(torch.empty(num_experts, dtype=dtype, device=device))

    def reset_parameters(self, generator):
        """The router's weight and bias U(±1/sqrt(d)), the experts as ``ExpertStack``."""
        bound = 1.0 / self.gate_w.shape[0] ** 0.5
        self.experts.reset_parameters(generator)
        self.gate_w.uniform_(-bound, bound, generator=generator)
        self.gate_b.uniform_(-bound, bound, generator=generator)


def init_classic_moe(cfg, *, num_experts=8, top_k=2, scaling_factor="auto", dtype=torch.float32, generator=None,
                     device=None):
    """A classic sparse MoE of GELU experts: "auto" scaling is 1/top_k, so
    the active experts' width matches one GPT-2 FFN; each expert is
    int(4·sf·emb_dim) wide. Random weights from ``generator``."""
    from llm_quest_tpu_torch.config import resolve_device

    if scaling_factor == "auto":
        scaling_factor = 1 / top_k
    module = ClassicMoE(cfg["emb_dim"], num_experts, int(4 * scaling_factor * cfg["emb_dim"]), dtype,
                        resolve_device(device))
    with torch.no_grad():
        module.reset_parameters(generator)
    return module


def classic_moe(params, x, *, top_k, load_coeff=10e-2, z_router_coeff=1e-3, plain=False):
    """x: (b, s, d). Returns (out, aux) with aux["moe_loss"] = z_router_coeff
    · z-loss + load_coeff · LBL: the softmax router with a bias, top-k
    renormalised, the exact dispatch of GELU (erf) experts. ``plain`` runs
    K11's plain version (quantized stacks; comparisons only)."""
    b, s, d = x.shape
    num_experts = params.gate_w.shape[-1]
    x2d = x.reshape(-1, d)
    gate_logits = x2d @ params.gate_w + params.gate_b
    gate_probas = torch.softmax(gate_logits.float(), dim=-1)
    topk_probas, topk_idxs = torch.topk(gate_probas, top_k, dim=-1)
    topk_probas = topk_probas / topk_probas.sum(dim=-1, keepdim=True)
    moe_loss = (z_router_coeff * z_router_loss(gate_logits)
                + load_coeff * load_balance_loss(gate_probas, topk_idxs, num_experts, top_k))
    out = dispatch(params.experts, x2d, topk_idxs, topk_probas, num_experts, activation=gelu_erf, plain=plain)
    return out.reshape(b, s, d), {"moe_loss": moe_loss}


# ------------------------------------------------------------------- Latent MoE


def squared_relu(x):
    """ReLU(x)² (Nemotron's expert activation)."""
    return torch.relu(x).square()


class LatentMoE(nn.Module):
    """Parameters {"routed" (gated stack in the latent width: (E, latent,
    hidden) and (E, hidden, latent)), "shared" (one gated expert at full
    width), "gate_w" (d, E), "down_proj" (d, latent), "up_proj" (latent,
    d)} and the fp32 buffer "biases" (E,), under the JAX tree's names; the
    projections are raw matrices in JAX's layout (``x @ w``), as ``gate_w``.
    Divergence by design: JAX keeps ``biases`` as a leaf of ``params``, which
    its AdamW decays; here it is a buffer, as in ``DeepSeekMoE``."""

    def __init__(self, d, num_experts, latent, hidden, shared_hidden, dtype, device=None):
        super().__init__()
        self.routed = ExpertStack(num_experts, latent, hidden, dtype=dtype, device=device)
        self.shared = ExpertStack(1, d, shared_hidden, dtype=dtype, device=device)
        self.gate_w = nn.Parameter(torch.empty(d, num_experts, dtype=dtype, device=device))
        self.down_proj = nn.Parameter(torch.empty(d, latent, dtype=dtype, device=device))
        self.up_proj = nn.Parameter(torch.empty(latent, d, dtype=dtype, device=device))
        self.register_buffer("biases", torch.zeros(num_experts, dtype=torch.float32, device=device))

    def reset_parameters(self, generator):
        """The stacks as ``ExpertStack``; the router and the down projection
        U(±1/sqrt(d)), the up projection U(±1/sqrt(latent)); the biases zero."""
        d, latent = self.down_proj.shape
        self.routed.reset_parameters(generator)
        self.shared.reset_parameters(generator)
        for p, fan_in in ((self.gate_w, d), (self.down_proj, d), (self.up_proj, latent)):
            p.uniform_(-fan_in**-0.5, fan_in**-0.5, generator=generator)
        self.biases.zero_()


def init_latent_moe(cfg, *, num_experts=4, latent_ratio=4, shared_expert_hidden_dim=None, dtype=torch.float32,
                    generator=None, device=None):
    """Nvidia's LatentMoE: experts in the latent width emb_dim / latent_ratio
    behind shared down and up projections, JAX's defaults: num_experts
    scaled by latent_ratio unless the config gives it (the layer's top_k,
    scaled alike, is ``latent_top_k``'s), routed experts
    ``routed_expert_hidden_dim`` or ``moe_hidden_dim`` wide, the shared one
    ``shared_expert_hidden_dim`` or ``moe_hidden_dim``. Random weights from
    ``generator``."""
    from llm_quest_tpu_torch.config import resolve_device

    d = cfg["emb_dim"]
    num_experts = cfg.get("num_experts", num_experts * latent_ratio)
    hidden = cfg.get("routed_expert_hidden_dim") or cfg["moe_hidden_dim"]
    shared_hidden = cfg.get("shared_expert_hidden_dim", shared_expert_hidden_dim) or cfg["moe_hidden_dim"]
    module = LatentMoE(d, num_experts, d // latent_ratio, hidden, shared_hidden, dtype, resolve_device(device))
    with torch.no_grad():
        module.reset_parameters(generator)
    return module


def latent_top_k(cfg):
    """The latent layer's top_k: the config's, else JAX's default top_k 2
    scaled by its default latent_ratio 4."""
    return cfg.get("top_k", 2 * 4)


def latent_moe(params, x, *, top_k, routed_scaling_factor=2.5, training=True, plain=False):
    """x: (b, s, d). Returns (out, aux): the shared expert (squared ReLU) on
    every token plus, in the latent width, the routed experts (squared
    ReLU) picked by top-k of sigmoid(x @ gate_w) + biases, weighted by the
    unbiased probabilities renormalised times ``routed_scaling_factor``, the
    sum projected back up. aux has "counts" (E,) when training, to fold into
    the biases with ``aux_free_bias_update`` after the optimizer step.
    ``plain`` runs K11's plain version (quantized stacks; comparisons only)."""
    b, s, d = x.shape
    num_experts = params.gate_w.shape[-1]
    x2d = x.reshape(-1, d)
    out = _shared_experts_sum(params.shared, x2d, activation=squared_relu)
    x_latent = x2d @ params.down_proj
    gate_probas = torch.sigmoid((x2d @ params.gate_w).float())
    topk_idxs = torch.topk(gate_probas + params.biases, top_k, dim=-1).indices  # biases kept at inference too
    topk_probas = gate_probas.gather(-1, topk_idxs)
    topk_probas = topk_probas / topk_probas.sum(dim=-1, keepdim=True) * routed_scaling_factor
    latent_out = dispatch(params.routed, x_latent, topk_idxs, topk_probas, num_experts, activation=squared_relu,
                          plain=plain)
    out = out + latent_out @ params.up_proj
    aux = {"counts": expert_counts(topk_idxs, num_experts)} if training else {}
    return out.reshape(b, s, d), aux
