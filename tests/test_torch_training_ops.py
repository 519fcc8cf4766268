"""The port's model-agnostic training ops and the rest of its data
functions against the JAX package, on the CPU in fp32.

QK-Clip (naive, per head with min/max/mean under MHA and GQA, magnitude; the
port's ``(out, in)`` weights are JAX's ``(in, out)`` transposed, so a head
is a block of rows there), ``apply_qk_clip`` on a tiny port Llama-3
(JAX's ``tests/test_common_techniques.py`` config: 4 q / 2 kv heads of 8)
against JAX's on the same tree and the end-to-end cap, the Number-Token
Loss (vocabulary maps from a ``get_vocab`` and a decode-only tokenizer;
value and logits gradient, with an importance mask and with
``ignore_index``, 0 with no number label), Reinforced Attention Learning's
loss and gradient, ``l2_norm``, DyT with its gradients, and
``gpt_windows``, ``gpt_stream_windows``, ``load_jsonl_gz`` and
``pad_to_multiple``. Tolerances: 1e-6 (absolute, or relative to max(1,
|ref|) for gradients); data exactly.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.data import datasets as jdata
from llm_quest_tpu.models import llama3 as jl
from llm_quest_tpu.ops import norms as jnorms
from llm_quest_tpu.ops import num_token_loss as jntl
from llm_quest_tpu.ops import qk_clip as jqk
from llm_quest_tpu.ops import reinforced_attention as jral
from llm_quest_tpu.weights.interop import flatten_params as jflatten
from llm_quest_tpu_torch.data import datasets as tdata
from llm_quest_tpu_torch.models import llama3 as tl
from llm_quest_tpu_torch.ops import lora as tlora
from llm_quest_tpu_torch.ops import norms as tnorms
from llm_quest_tpu_torch.ops import num_token_loss as tntl
from llm_quest_tpu_torch.ops import qk_clip as tqk
from llm_quest_tpu_torch.ops import quantization as tquant
from llm_quest_tpu_torch.ops import reinforced_attention as tral
from llm_quest_tpu_torch.weights.interop import from_jax_flat

LLAMA = {"vocab_size": 64, "context_length": 32, "emb_dim": 32, "n_layers": 2, "n_heads": 4, "num_kv_groups": 2,
         "hidden_dim": 64, "rope_base": 10_000, "dtype": torch.float32}
JLLAMA = dict(LLAMA, dtype=jnp.float32)
TOL = 1e-6


def T(x):
    return torch.from_numpy(np.array(x))


def arr(x):
    return x.detach().float().numpy().astype(np.float64) if torch.is_tensor(x) else np.asarray(x, np.float64)


def max_err(got, ref):
    return float(np.abs(arr(got) - arr(ref)).max())


def rel_err(got, ref):
    return max_err(got, ref) / max(1.0, float(np.abs(arr(ref)).max()))


# ------------------------------------------------------------------ QK-Clip


def qk_weights(seed, d, hq, hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(d, hq * hd)).astype(np.float32), rng.normal(size=(d, hkv * hd)).astype(np.float32),
            np.abs(rng.normal(size=(hq,))).astype(np.float32) * 10 + 1)


@pytest.mark.parametrize("reduction", ["min", "max", "mean"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (6, 1)], ids=["mha", "gqa2", "mqa"])
def test_qk_clip_per_head_matches_jax(reduction, heads):
    hq, hkv = heads
    wq, wk, ml = qk_weights(0, 16, hq, hkv, 8)
    tau = float(np.median(ml))  # some heads clipped, some not
    rq, rk = jqk.qk_clip_per_head(jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(ml), tau, num_heads=hq,
                                  num_kv_heads=hkv, alpha=0.3, reduction=reduction)
    gq, gk = tqk.qk_clip_per_head(T(wq.T), T(wk.T), T(ml), tau, num_heads=hq, num_kv_heads=hkv, alpha=0.3,
                                  reduction=reduction)
    assert max_err(gq.T, rq) <= TOL and max_err(gk.T, rk) <= TOL


def test_qk_clip_per_head_bad_reduction():
    wq, wk, ml = qk_weights(0, 16, 4, 2, 8)
    with pytest.raises(ValueError, match="Unknown reduction"):
        tqk.qk_clip_per_head(T(wq.T), T(wk.T), T(ml), 1.0, num_heads=4, num_kv_heads=2, reduction="median")


@pytest.mark.parametrize("max_logit", [4.0, 0.5], ids=["clipped", "under"])
def test_qk_clip_naive_matches_jax(max_logit):
    wq, wk, _ = qk_weights(1, 8, 2, 2, 4)
    rq, rk = jqk.qk_clip_naive(jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(max_logit), 1.0, alpha=0.5)
    gq, gk = tqk.qk_clip_naive(T(wq.T), T(wk.T), torch.tensor(max_logit), 1.0, alpha=0.5)
    assert max_err(gq.T, rq) <= TOL and max_err(gk.T, rk) <= TOL


def test_magnitude_qk_clip_matches_jax():
    wq, wk, _ = qk_weights(2, 8, 2, 2, 4)
    ml = np.asarray([-4.0, 1.0], np.float32)  # head 0 blows up negatively
    rq, rk = jqk.magnitude_qk_clip(jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(ml), 1.0, num_heads=2)
    gq, gk = tqk.magnitude_qk_clip(T(wq.T), T(wk.T), T(ml), 1.0, num_heads=2)
    assert max_err(gq.T, rq) <= TOL and max_err(gk.T, rk) <= TOL
    assert torch.allclose(gq[:4], T(wq.T)[:4] * 0.5) and torch.equal(gq[4:], T(wq.T)[4:])


def test_max_logits_from_scores_matches_jax():
    scores = np.random.default_rng(3).normal(size=(2, 4, 5, 6)).astype(np.float32)
    np.testing.assert_array_equal(tqk.max_logits_from_scores(T(scores)).numpy(),
                                  np.asarray(jqk.max_logits_from_scores(jnp.asarray(scores))))


@pytest.fixture(scope="module")
def llama_pair():
    """JAX's tiny Llama with its q projections ×20 (huge logits), and the port's copy."""
    params = jl.init(jax.random.PRNGKey(0), JLLAMA)
    for blk in params["blocks"]:
        blk["att"]["wq"]["w"] = blk["att"]["wq"]["w"] * 20.0
    flat = {k: np.asarray(v) for k, v in jflatten(params).items()}
    return params, flat


@pytest.mark.parametrize("per_head", [True, False], ids=["per_head", "naive"])
def test_apply_qk_clip_on_llama_matches_jax_and_caps(llama_pair, per_head):
    params, flat = llama_pair
    model = from_jax_flat(flat, LLAMA, device="cpu")
    x = np.random.default_rng(1).integers(0, 64, (2, 8))
    _, _, jaux = jl.apply(params, JLLAMA, jnp.asarray(x), collect_max_logits=True)
    _, _, aux = tl.apply(model, LLAMA, T(x).long(), collect_max_logits=True)
    ml, jml = aux["max_attn_logits"], jaux["max_attn_logits"]
    assert len(ml) == 2 and tuple(ml[0].shape) == (4,)
    for g, r in zip(ml, jml):
        assert max_err(g, r) <= 1e-5 * float(np.abs(np.asarray(r)).max())
    tau = float(max(m.max() for m in ml)) / 2
    if not per_head:  # the naive clip takes one scalar a layer
        ml, jml = [m.max() for m in ml], [jnp.max(m) for m in jml]
    clipped = jqk.apply_qk_clip(params, jml, tau, num_heads=4, num_kv_heads=2, per_head=per_head)
    assert tqk.apply_qk_clip(model, ml, tau, num_heads=4, num_kv_heads=2, per_head=per_head) is model
    for i, blk in enumerate(clipped["blocks"]):
        for proj in ("wq", "wk"):
            w = getattr(model.blocks[i].att, proj).w
            assert w.requires_grad and rel_err(w.T, blk["att"][proj]["w"]) <= 1e-6
    _, _, aux2 = tl.apply(model, LLAMA, T(x).long(), collect_max_logits=True)
    assert all(float(m.max()) <= tau * 1.01 for m in aux2["max_attn_logits"])


def test_apply_qk_clip_refuses_int8_and_lora(llama_pair):
    ml = [torch.full((4,), 10.0)] * 2
    lora = tlora.replace_with_lora(torch.Generator().manual_seed(0), from_jax_flat(llama_pair[1], LLAMA, device="cpu"),
                                   4, 8, path_filter=lambda p: "att" in p)
    with pytest.raises(ValueError, match="LoRA"):
        tqk.apply_qk_clip(lora, ml, 1.0, num_heads=4, num_kv_heads=2)
    q = tquant.quantize_params_int8(from_jax_flat(llama_pair[1], LLAMA, device="cpu"), min_size=0)
    with pytest.raises(ValueError, match="QuantLinear"):
        tqk.apply_qk_clip(q, ml, 1.0, num_heads=4, num_kv_heads=2)


# ------------------------------------------------------------------ Number-Token Loss


class VocabTok:
    def __init__(self, vocab):
        self.vocab = vocab

    def get_vocab(self):
        return dict(self.vocab)


class DecodeTok:
    def __init__(self, vocab):
        self.by_id = {i: s for s, i in vocab.items()}

    def decode(self, ids):
        return self.by_id.get(ids[0], "<unk>")


NUM_VOCAB = {**{str(i): i for i in range(10)}, " 7": 10, "12": 11, "-1": 12, "3.5": 13, "abc": 14, " the": 15,
             "100": 16, "x9": 17, "99": 40}  # 40 lies past a 32-token vocabulary


@pytest.mark.parametrize("tok", [VocabTok, DecodeTok], ids=["get_vocab", "decode"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_build_num_vocab_matches_jax(tok, multi):
    t = tok(NUM_VOCAB)
    ref = np.asarray(jntl.build_num_vocab(t, 32, multi_digits=multi))
    got = tntl.build_num_vocab(t, 32, multi_digits=multi, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)  # NaN where JAX's is NaN
    assert multi == (not np.isnan(ref[11]))


def ntl_inputs(seed):
    rng = np.random.default_rng(seed)
    vocab = np.asarray(jntl.build_num_vocab(VocabTok(NUM_VOCAB), 32, multi_digits=True))
    logits = rng.normal(size=(2, 6, 32)).astype(np.float32) * 3
    labels = rng.integers(0, 32, (2, 6)).astype(np.int32)
    labels[0, :3] = [4, 11, 12]
    labels[1, 2] = -100
    labels[1, 5] = 15
    return vocab, logits, labels


@pytest.mark.parametrize("case", ["plain", "importance", "ignore_7", "no_number"])
def test_num_token_loss_value_and_grad_match_jax(case):
    vocab, logits, labels = ntl_inputs(0)
    kw, tkw = {}, {}
    if case == "importance":
        w = np.random.default_rng(1).uniform(0, 2, size=(2, 6)).astype(np.float32)
        w[0, 0] = 0.0
        kw, tkw = {"importance_mask": jnp.asarray(w)}, {"importance_mask": T(w)}
    if case == "ignore_7":  # the caller's ignored positions hold 7 (JAX would read a -100 label as a number)
        labels = np.where(labels == -100, 7, labels)
        labels[0, 4] = 7
        kw = tkw = {"ignore_index": 7}
    if case == "no_number":
        labels = np.full_like(labels, 15)
        labels[0, 0] = -100
    ref, rgrad = jax.value_and_grad(lambda lg: jntl.num_token_loss(lg, jnp.asarray(labels), jnp.asarray(vocab), **kw))(
        jnp.asarray(logits))
    lg = T(logits).requires_grad_(True)
    got = tntl.num_token_loss(lg, T(labels).long(), T(vocab), **tkw)
    (grad,) = torch.autograd.grad(got, lg)
    assert abs(float(got.detach()) - float(ref)) <= TOL and rel_err(grad, rgrad) <= TOL
    if case == "no_number":
        assert float(got) == 0.0 and float(grad.abs().max()) == 0.0
    else:
        assert float(got) > 0


def test_num_token_loss_jax_cases():
    """JAX's ``test_num_token_loss``: a perfect "4" → 0, mass on "5" → 1, on "9" → 5, no number label → 0."""
    vocab = torch.cat([torch.arange(10.0), torch.full((6,), float("nan"))])
    labels = torch.tensor([[4, 12, -100]])
    for peak, expect in ((4, 0.0), (5, 1.0), (9, 5.0)):
        logits = torch.full((1, 3, 16), -10.0)
        logits[0, 0, peak] = 10.0
        assert abs(float(tntl.num_token_loss(logits, labels, vocab)) - expect) < 1e-3
    assert float(tntl.num_token_loss(logits, torch.tensor([[12, 12, -100]]), vocab)) == 0.0


def test_num_token_loss_finds_the_columns_once_a_map(monkeypatch):
    """The number columns are read off the map (a host read on the card) once a map, not once a call, and
    read again after the map changes in place."""
    found = []
    nonzero = torch.nonzero
    monkeypatch.setattr(torch, "nonzero", lambda x: found.append(1) or nonzero(x))
    vocab, logits, labels = ntl_inputs(2)
    tvocab = T(vocab)
    first = tntl.num_token_loss(T(logits), T(labels).long(), tvocab)
    second = tntl.num_token_loss(T(logits), T(labels).long(), tvocab)
    assert len(found) == 1 and torch.equal(first, second)
    vocab = vocab.copy()
    vocab[4] = np.nan  # the label "4" at [0, 0] is a number no more
    tvocab[4] = float("nan")
    third = tntl.num_token_loss(T(logits), T(labels).long(), tvocab)
    ref = jntl.num_token_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(vocab))
    assert len(found) == 2 and abs(float(third) - float(ref)) <= TOL and float(third) != float(first)


# ------------------------------------------------------------------ RAL, norms


def softmaxed(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("factor", [1.0, 0.3])
def test_attention_divergence_loss_and_grad_match_jax(factor):
    rng = np.random.default_rng(2)
    p, q = softmaxed(rng, 2, 3, 5, 5), softmaxed(rng, 2, 3, 5, 5)
    adv = np.asarray([1.0, -0.5], np.float32)
    mask = np.asarray([[1, 1, 1, 0, 1], [1, 1, 0, 0, 0]], np.int32)

    def jloss(pp, qq):
        return jral.attention_divergence_loss(pp, qq, jnp.asarray(adv), jnp.asarray(mask), ral_factor=factor)

    ref, (rgp, rgq) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(p), jnp.asarray(q))
    tp, tq = T(p).requires_grad_(True), T(q).requires_grad_(True)
    got = tral.attention_divergence_loss(tp, tq, T(adv), T(mask), ral_factor=factor)
    gp, gq = torch.autograd.grad(got, (tp, tq), allow_unused=True, materialize_grads=True)
    assert abs(float(got) - float(ref)) <= TOL and rel_err(gp, rgp) <= TOL
    assert float(np.abs(np.asarray(rgq)).max()) == 0.0 and float(gq.abs().max()) == 0.0  # the old policy: no gradient
    same = tral.attention_divergence_loss(T(p), T(p), T(adv), T(mask))
    assert abs(float(same)) < 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2_norm_matches_jax(dtype):
    x = np.random.default_rng(3).normal(size=(2, 3, 16)).astype(np.float32)
    x[0, 0] = 0.0  # eps inside the root keeps a zero row finite
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jnorms.l2_norm(jnp.asarray(x, jdt))
    got = tnorms.l2_norm(T(x).to(dtype))
    assert got.dtype == dtype and max_err(got, ref) <= (TOL if dtype == torch.float32 else 0.0)
    lg = T(x).requires_grad_(True)
    (g,) = torch.autograd.grad((tnorms.l2_norm(lg) * T(x[::-1].copy())).sum(), lg)
    rg = jax.grad(lambda a: jnp.sum(jnorms.l2_norm(a) * jnp.asarray(x[::-1].copy())))(jnp.asarray(x))
    assert rel_err(g, rg) <= 1e-5


def test_dynamic_tanh_and_grads_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 8)).astype(np.float32)
    jp = jnorms.init_dynamic_tanh(8, alpha0=0.7)
    jp = {"alpha": jp["alpha"], "gamma": jnp.asarray(rng.normal(size=8), jnp.float32),
          "beta": jnp.asarray(rng.normal(size=8), jnp.float32)}
    tp = tnorms.init_dynamic_tanh(8, alpha0=0.7, device="cpu")
    assert isinstance(tp, tnorms.DynamicTanh) and tp["alpha"].shape == () and float(tp["alpha"]) == pytest.approx(0.7)
    assert torch.equal(tp["gamma"], torch.ones(8)) and torch.equal(tp["beta"], torch.zeros(8))
    with torch.no_grad():
        for k in ("gamma", "beta"):
            tp[k].copy_(T(jp[k]))
    w = rng.normal(size=(2, 3, 8)).astype(np.float32)
    ref, rg = jax.value_and_grad(lambda p: jnp.sum(jnorms.dynamic_tanh(p, jnp.asarray(x)) * w))(jp)
    out = tp(T(x))
    grads = torch.autograd.grad((out * T(w)).sum(), [tp["alpha"], tp["gamma"], tp["beta"]])
    assert abs(float((out * T(w)).sum()) - float(ref)) <= 1e-5
    for g, k in zip(grads[1:], ("gamma", "beta")):
        assert rel_err(g, rg[k]) <= TOL, k
    # α's gradient is a sum over all 48 elements: held to fp32's rounding of that sum, 1e-6 of Σ|terms|
    terms = w * np.asarray(jp["gamma"]) * x / np.cosh(0.7 * x) ** 2
    assert abs(float(grads[0]) - float(rg["alpha"])) <= TOL * float(np.abs(terms).sum())
    # bf16 input, fp32 parameters: JAX promotes the whole expression to fp32
    xb = T(x).to(torch.bfloat16)
    refb = jnorms.dynamic_tanh(jp, jnp.asarray(x, jnp.bfloat16))
    gotb = tnorms.dynamic_tanh(tp, xb)
    assert gotb.dtype == torch.float32 and refb.dtype == jnp.float32 and max_err(gotb, refb) <= TOL


def test_dynamic_tanh_builds_on_the_card_unless_told():
    for build in (tnorms.DynamicTanh, tnorms.init_dynamic_tanh):
        dyt = build(8, device="cpu")
        assert all(p.device.type == "cpu" for p in dyt.parameters())
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match='no CUDA device: pass device="cpu"'):
                build(8)


# ------------------------------------------------------------------ data


class WordTok:
    def encode(self, text):
        return [len(w) * 7 + i % 3 for i, w in enumerate(text.split())]


CORPUS = " ".join(f"w{'x' * (i % 5)}" for i in range(60))


@pytest.mark.parametrize("max_length,stride", [(8, 4), (8, 8), (59, 1), (60, 1)])
def test_gpt_windows_match_jax(max_length, stride):
    ref = jdata.gpt_windows(CORPUS, WordTok(), max_length, stride)
    got = tdata.gpt_windows(CORPUS, WordTok(), max_length, stride)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.int32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_gpt_stream_windows_match_jax():
    stream = [{"text": CORPUS}, {"text": None}, {"text": CORPUS[:40]}, {"text": CORPUS[::2]}]
    ref = list(jdata.gpt_stream_windows(stream, WordTok(), 6, 3))
    got = list(tdata.gpt_stream_windows(stream, WordTok(), 6, 3))
    assert len(got) == len(ref) > 0
    for (gi, gt), (ri, rt) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gt, rt)
    with pytest.raises(KeyError, match='"body"'):
        list(tdata.gpt_stream_windows(stream, WordTok(), 6, 3, text_key="body"))


@pytest.mark.parametrize("max_samples", [None, 2])
def test_load_jsonl_gz_matches_jax(tmp_path, max_samples):
    path = tmp_path / "corpus.jsonl.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        for i in range(4):
            f.write(json.dumps({"text": f"sample {i} ü", "id": i}) + "\n")
    assert tdata.load_jsonl_gz(path, max_samples) == jdata.load_jsonl_gz(path, max_samples)
    assert tdata.load_jsonl_gz(path, text_key="id") == jdata.load_jsonl_gz(path, text_key="id") == [0, 1, 2, 3]


@pytest.mark.parametrize("s,multiple", [(5, 8), (8, 8), (9, 4)])
def test_pad_to_multiple_matches_jax(s, multiple):
    rng = np.random.default_rng(5)
    batch = {"input_ids": rng.integers(0, 100, (2, s)).astype(np.int32),
             "targets": rng.integers(0, 100, (2, s)).astype(np.int32), "attn_mask": np.ones((2, s), bool),
             "extra": np.arange(3)}
    ref = jdata.pad_to_multiple(batch, multiple, pad_token_id=99)
    got = tdata.pad_to_multiple(batch, multiple, pad_token_id=99)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])
