"""The port's HF checkpoint loaders against the JAX package's, on the CPU.

The synthetic HF state dicts are JAX's ``tests/test_weight_interop.py``
(GPT-2 with its fused ``c_attn``, Qwen3-MoE with per-expert tensors, the
Qwen3.5 VLM partially filled) plus a dense Qwen3 with an untied head. Each
model starts from the same weights in both packages (the port's ``init``
handed to JAX over ``jax.eval_shape``); JAX's loader returns a new tree, the
port's loads in place. The loaded port model must equal ``from_jax_flat``
of JAX's loaded tree leaf by leaf, exactly, with the same log lines (the
loaded count and the missing list). Also: ``convert_weights``' rules,
transposes, first-exact-match break, shape-mismatch, no-match and skip
lines against JAX's, ``flatten_params`` / ``unflatten_into``, and a torch
bf16 state dict (no numpy round trip) into a bf16 and an fp32 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.models import gpt2 as jg
from llm_quest_tpu.models import qwen3 as jq3
from llm_quest_tpu.models import qwen3_5 as jq35
from llm_quest_tpu.weights import interop as ji
from llm_quest_tpu_torch.models import gpt2 as tg
from llm_quest_tpu_torch.models import qwen3 as tq3
from llm_quest_tpu_torch.models import qwen3_5 as tq35
from llm_quest_tpu_torch.weights import interop as ti

GPT = {"vocab_size": 64, "context_length": 32, "emb_dim": 16, "n_heads": 2, "n_layers": 1, "drop_rate": 0.0,
       "qkv_bias": True}
MOE = {"model_type": "moe", "vocab_size": 32, "context_length": 16, "emb_dim": 8, "n_layers": 1, "n_heads": 2,
       "num_kv_groups": 1, "head_dim": 4, "moe_hidden_dim": 12, "num_experts": 2, "top_k": 1, "aux_loss_coef": 0.001,
       "rope_base": 10_000, "tie_embeddings": True}
DENSE = {"vocab_size": 32, "context_length": 16, "emb_dim": 8, "n_layers": 2, "n_heads": 2, "num_kv_groups": 1,
         "head_dim": 4, "hidden_dim": 12, "rope_base": 10_000, "tie_embeddings": False}
VLM = {"vocab_size": 64, "emb_dim": 16, "hidden_dim": 32, "n_layers": 2, "linear_sdpa_ratio": 2, "n_heads": 2,
       "num_kv_groups": 1, "head_dim": 8, "rope_base": 10_000, "partial_rope_factor": 0.25, "context_length": 32,
       "linear_num_qk_heads": 1, "linear_num_value_heads": 2, "linear_qk_head_dim": 4, "linear_value_head_dim": 4,
       "linear_conv_kernel_size": 3, "tie_embeddings": True, "mrope_section": [1, 1, 0], "vision_n_layers": 1,
       "vision_emb_dim": 8, "vision_hidden_dim": 16, "vision_num_heads": 2, "llm_d_in": 16, "in_channels": 3,
       "patch_size": 4, "spatial_merge_size": 2, "temporal_patch_size": 2, "num_position_embeddings": 16,
       "img_width": 8, "img_height": 8, "vision_rope_base": 10_000, "image_token_id": 60}


def tcfg(cfg):
    return dict(cfg, dtype=torch.float32)


def jcfg(cfg):
    return dict(cfg, dtype=jnp.float32)


def flat(params):
    return {k: np.asarray(v) for k, v in ji.flatten_params(params).items()}


def to_jax(model, init_fn):
    """The JAX tree of a port model over ``jax.eval_shape`` of JAX's ``init``."""
    updates = {k: v.detach().numpy().copy() for k, v in ti.flatten_params(model).items()}
    return ji.unflatten_into(jax.eval_shape(init_fn), updates)


def lin(rng, o, i):
    return rng.normal(size=(o, i)).astype(np.float32)


def gpt2_state(rng):
    return {
        "wte.weight": rng.normal(size=(64, 16)).astype(np.float32),
        "wpe.weight": rng.normal(size=(32, 16)).astype(np.float32),
        "ln_f.weight": np.ones(16, np.float32), "ln_f.bias": np.zeros(16, np.float32),
        "h.0.attn.c_attn.weight": rng.normal(size=(16, 48)).astype(np.float32),
        "h.0.attn.c_attn.bias": rng.normal(size=(48,)).astype(np.float32),
        "h.0.attn.c_proj.weight": rng.normal(size=(16, 16)).astype(np.float32),
        "h.0.attn.c_proj.bias": rng.normal(size=(16,)).astype(np.float32),
        "h.0.mlp.c_fc.weight": rng.normal(size=(16, 64)).astype(np.float32),
        "h.0.mlp.c_fc.bias": rng.normal(size=(64,)).astype(np.float32),
        "h.0.mlp.c_proj.weight": rng.normal(size=(64, 16)).astype(np.float32),
        "h.0.mlp.c_proj.bias": rng.normal(size=(16,)).astype(np.float32),
        "h.0.ln_1.weight": np.ones(16, np.float32), "h.0.ln_1.bias": np.zeros(16, np.float32),
        "h.0.ln_2.weight": np.ones(16, np.float32), "h.0.ln_2.bias": np.zeros(16, np.float32),
        "h.0.attn.bias": np.tril(np.ones((32, 32), np.float32)),  # an HF buffer with no counterpart
    }


def qwen3_state(rng, moe):
    state = {
        "model.embed_tokens.weight": lin(rng, 32, 8), "model.norm.weight": np.ones(8, np.float32),
    }
    for i in range(1 if moe else 2):
        p = f"model.layers.{i}."
        state.update({
            p + "self_attn.q_proj.weight": lin(rng, 8, 8), p + "self_attn.k_proj.weight": lin(rng, 4, 8),
            p + "self_attn.v_proj.weight": lin(rng, 4, 8), p + "self_attn.o_proj.weight": lin(rng, 8, 8),
            p + "self_attn.q_norm.weight": np.ones(4, np.float32), p + "self_attn.k_norm.weight": np.ones(4, np.float32),
            p + "input_layernorm.weight": np.ones(8, np.float32),
            p + "post_attention_layernorm.weight": np.ones(8, np.float32),
        })
        if moe:
            state[p + "mlp.gate.weight"] = lin(rng, 2, 8)
            for e in range(2):
                state.update({p + f"mlp.experts.{e}.gate_proj.weight": lin(rng, 12, 8),
                              p + f"mlp.experts.{e}.up_proj.weight": lin(rng, 12, 8),
                              p + f"mlp.experts.{e}.down_proj.weight": lin(rng, 8, 12)})
        elif i == 0:  # layer 1's MLP stays missing
            state.update({p + "mlp.gate_proj.weight": lin(rng, 12, 8), p + "mlp.up_proj.weight": lin(rng, 12, 8),
                          p + "mlp.down_proj.weight": lin(rng, 8, 12)})
    if not moe:
        state["lm_head.weight"] = lin(rng, 32, 8)
        state["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(2, np.float32)  # no match
        state["model.layers.0.self_attn.k_norm.weight"] = np.ones(5, np.float32)  # a shape mismatch
    return state


def vlm_state(rng):
    d_qk, d_vg, fused = 4, 8, 16
    return {
        "model.language_model.embed_tokens.weight": lin(rng, 64, 16),
        "model.language_model.norm.weight": np.ones(16, np.float32),
        "model.language_model.layers.0.linear_attn.A_log": np.zeros(2, np.float32),
        "model.language_model.layers.0.linear_attn.dt_bias": np.ones(2, np.float32),
        "model.language_model.layers.0.linear_attn.in_proj_qkv.weight": lin(rng, fused, 16),
        "model.language_model.layers.0.linear_attn.in_proj_z.weight": lin(rng, d_vg, 16),
        "model.language_model.layers.0.linear_attn.in_proj_b.weight": lin(rng, 2, 16),
        "model.language_model.layers.0.linear_attn.in_proj_a.weight": lin(rng, 2, 16),
        "model.language_model.layers.0.linear_attn.conv1d.weight": rng.normal(size=(fused, 1, 3)).astype(np.float32),
        "model.language_model.layers.0.linear_attn.norm.weight": np.ones(d_qk, np.float32),
        "model.language_model.layers.0.linear_attn.out_proj.weight": lin(rng, 16, d_vg),
        "model.language_model.layers.1.self_attn.q_proj.weight": lin(rng, 32, 16),  # fused q + gate
        "model.language_model.layers.1.self_attn.k_proj.weight": lin(rng, 8, 16),
        "model.language_model.layers.1.self_attn.v_proj.weight": lin(rng, 8, 16),
        "model.language_model.layers.1.self_attn.o_proj.weight": lin(rng, 16, 16),
        "model.language_model.layers.1.self_attn.q_norm.weight": np.zeros(8, np.float32),
        "model.language_model.layers.1.self_attn.k_norm.weight": np.zeros(8, np.float32),
        "model.visual.patch_embed.proj.weight": rng.normal(size=(8, 3, 2, 4, 4)).astype(np.float32),
        "model.visual.patch_embed.proj.bias": np.zeros(8, np.float32),
        "model.visual.pos_embed.weight": lin(rng, 16, 8),
        "model.visual.blocks.0.attn.qkv.weight": lin(rng, 24, 8),
        "model.visual.blocks.0.attn.qkv.bias": np.zeros(24, np.float32),
        "model.visual.merger.linear_fc2.weight": lin(rng, 16, 32),
        "model.visual.merger.linear_fc2.bias": np.zeros(16, np.float32),
        "mtp.fc.weight": lin(rng, 16, 32),  # ignored by both halves
    }


def gen(seed):
    return torch.Generator().manual_seed(seed)


CASES = {
    "gpt2": (lambda: tg.init(GPT, generator=gen(0), device="cpu"), lambda: jg.init(jax.random.PRNGKey(0), GPT),
             gpt2_state, lambda p, s, log: ji.load_hf_gpt2(p, s, log=log),
             lambda m, s, log: ti.load_hf_gpt2(m, s, log=log), GPT),
    "qwen3_dense": (lambda: tq3.init(tcfg(DENSE), generator=gen(0), device="cpu"),
                    lambda: jq3.init(jax.random.PRNGKey(0), jcfg(DENSE)), lambda r: qwen3_state(r, False),
                    lambda p, s, log: ji.load_hf_qwen3(p, jcfg(DENSE), s, log=log),
                    lambda m, s, log: ti.load_hf_qwen3(m, tcfg(DENSE), s, log=log), tcfg(DENSE)),
    "qwen3_moe": (lambda: tq3.init(tcfg(MOE), generator=gen(0), device="cpu"),
                  lambda: jq3.init(jax.random.PRNGKey(0), jcfg(MOE)), lambda r: qwen3_state(r, True),
                  lambda p, s, log: ji.load_hf_qwen3(p, jcfg(MOE), s, log=log),
                  lambda m, s, log: ti.load_hf_qwen3(m, tcfg(MOE), s, log=log), tcfg(MOE)),
    "qwen3_5_vlm": (lambda: tq35.init(tcfg(VLM), generator=gen(0), device="cpu"),
                    lambda: jq35.init(jax.random.PRNGKey(0), jcfg(VLM)), vlm_state,
                    lambda p, s, log: ji.load_hf_qwen3_5_vlm(p, jcfg(VLM), s, log=log),
                    lambda m, s, log: ti.load_hf_qwen3_5_vlm(m, tcfg(VLM), s, log=log), tcfg(VLM)),
}


def missing_spy(monkeypatch, module, into):
    real = module.report_loading_status

    def spy(*args, **kw):
        into.append(real(*args, **kw))
        return into[-1]

    monkeypatch.setattr(module, "report_loading_status", spy)


@pytest.mark.parametrize("case", list(CASES))
def test_loader_equals_from_jax_flat_of_jax_loaded(case, monkeypatch):
    """Leaf by leaf, exactly; the same loaded line and missing list. The
    missing list comes in each tree's leaf order: JAX's tree here is rebuilt
    over ``jax.eval_shape`` (keys sorted), the port's in its modules' order,
    so the lists are compared as sets beside the counts."""
    make, jinit, state_fn, jload, tload, cfg = CASES[case]
    model = make()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params = to_jax(model, jinit)
    state = state_fn(np.random.default_rng(2))
    jlogs, tlogs, jmissing, tmissing = [], [], [], []
    missing_spy(monkeypatch, ji, jmissing)
    missing_spy(monkeypatch, ti, tmissing)
    ref = ti.from_jax_flat(flat(jload(params, state, jlogs.append)), cfg, device="cpu")
    assert tload(model, state, tlogs.append) is model
    assert len(tlogs) == len(jlogs) and tlogs[0] == jlogs[0] and jlogs[0].startswith("Loaded")
    assert [line.split(":")[0] for line in tlogs] == [line.split(":")[0] for line in jlogs]
    assert len(tmissing[0]) == len(jmissing[0]) and set(tmissing[0]) == set(jmissing[0])
    assert bool(jmissing[0]) == (case in ("qwen3_dense", "qwen3_5_vlm"))  # the partial state dicts
    got, want = model.state_dict(), ref.state_dict()
    assert list(got) == list(want)
    changed = 0
    for name, t in got.items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), name
        changed += not torch.equal(t, before[name])
    assert changed > 0


def test_gpt2_split_and_tied_head_in_the_port_layout():
    model = tg.init(GPT, generator=gen(0), device="cpu")
    state = gpt2_state(np.random.default_rng(0))
    ti.load_hf_gpt2(model, state, log=lambda *_: None)
    c_attn = torch.from_numpy(state["h.0.attn.c_attn.weight"])
    att = model.blocks[0].att
    assert torch.equal(att.wq.w, c_attn[:, :16].T) and torch.equal(att.wv.w, c_attn[:, 32:].T)
    assert torch.equal(att.wk.b, torch.from_numpy(state["h.0.attn.c_attn.bias"][16:32]))
    assert torch.equal(model.out.w, torch.from_numpy(state["wte.weight"]))  # the (v, d) head is wte itself
    assert torch.equal(model.blocks[0].ffn.fc.w, torch.from_numpy(state["h.0.mlp.c_fc.weight"]).T)
    logits, _, _ = tg.apply(model, GPT, torch.zeros(1, 4, dtype=torch.long))
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_torch_bf16_state_dict(dtype):
    """A torch bf16 state dict (no numpy view) loads without a numpy round
    trip: bit-equal into a bf16 model, the exact upcast into fp32."""
    cfg = dict(GPT, dtype=dtype)
    model = tg.init(cfg, generator=gen(0), device="cpu")
    state = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in gpt2_state(np.random.default_rng(1)).items()}
    ti.load_hf_gpt2(model, state, log=lambda *_: None)
    assert model.tok_emb["w"].dtype == dtype
    assert torch.equal(model.tok_emb["w"], state["wte.weight"].to(dtype))
    assert torch.equal(model.blocks[0].att.wk.w, state["h.0.attn.c_attn.weight"][:, 16:32].T.to(dtype))
    assert torch.equal(model.out.w, state["wte.weight"].to(dtype))
    moe = tq3.init(dict(MOE, dtype=dtype), generator=gen(0), device="cpu")
    qstate = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in qwen3_state(np.random.default_rng(1), True).items()}
    ti.load_hf_qwen3(moe, dict(MOE, dtype=dtype), qstate, log=lambda *_: None)
    assert torch.equal(moe.blocks[0].moe.experts["lin2"][1],
                       qstate["model.layers.0.mlp.experts.1.down_proj.weight"].T.to(dtype))
    assert torch.equal(moe.blocks[0].moe.gate_w, qstate["model.layers.0.mlp.gate.weight"].T.to(dtype))


def test_convert_weights_rules_and_transpose_match_jax():
    src = {"model.layers.0.self_attn.q_proj.weight": np.arange(32.0, dtype=np.float32).reshape(4, 8),
           "model.layers.0.self_attn.k_proj.weight": np.ones((3, 8), np.float32),  # shape mismatch
           "model.layers.0.unknown.weight": np.ones(2, np.float32),  # no match
           "skip.me": np.ones(1, np.float32),
           "exact": np.full((2, 2), 5.0, np.float32)}  # an exact rule stops the walk before "xa"
    target = {"blocks/0/att/wq/w": np.zeros((8, 4)), "blocks/0/att/wk/w": np.zeros((8, 4)),
              "done": np.zeros((2, 2))}
    rules = [("model.layers.", "blocks/"), (".self_attn.q_proj.weight", "/att/wq/w", True),
             (".self_attn.k_proj.weight", "/att/wk/w", True), ("exact", "done"), ("xa", "oops")]
    jlogs, tlogs = [], []
    ref = ji.convert_weights(src, target, rules, ignored_prefixes=("skip.",), log=jlogs.append)
    got = ti.convert_weights(src, target, rules, ignored_prefixes=("skip.",), log=tlogs.append)
    assert tlogs == jlogs and len(jlogs) == 3
    assert set(got) == set(ref) == {"blocks/0/att/wq/w", "done"}
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), ref[key])
    callable_rule = [("w", "w", lambda w: w[:, 0, :])]
    conv = ti.convert_weights({"w": torch.ones(4, 1, 3)}, {"w": np.zeros((4, 3))}, callable_rule)
    assert tuple(conv["w"].shape) == (4, 3)


def test_flatten_and_unflatten_in_jax_layout():
    model = tg.init(GPT, generator=gen(0), device="cpu")
    fl = ti.flatten_params(model)
    assert set(fl) == {n.replace(".", "/") for n in model.state_dict()}
    assert tuple(fl["blocks/0/att/wq/w"].shape) == (16, 16) and tuple(fl["out/w"].shape) == (16, 64)  # (in, out)
    before = model.blocks[0].ln_1["scale"].clone()
    new_out = np.arange(16 * 64, dtype=np.float32).reshape(16, 64)
    assert ti.unflatten_into(model, {"out/w": new_out}) is model
    assert torch.equal(model.out.w, torch.from_numpy(new_out).T)
    assert torch.equal(model.blocks[0].ln_1["scale"], before)  # untouched
