"""The port's classifier tuning, checkpointing, profiling, ``utils`` and the
dataset functions against the JAX package, on the CPU in fp32.

The classifier runs JAX's tiny GPT-2 of ``tests/test_alignment.py`` (2
layers, 4 heads of 8, vocabulary 128) over right-padded byte-tokenized
texts from ``spam_dataset``, trained over the vocabulary head's logits at
the last real token with 0/1 targets (as JAX's script does: no class head).
JAX's train step runs with an optimizer that records the gradients it is
given before AdamW, so one jitted JAX step gives both. Tolerances: the loss
and every gradient within 1e-5 relative, the parameters after 2 steps within
1e-5, the losses of ``training_eval_loop(classification=True)`` within
1e-5; datasets, collators, extractors, entropy buckets and checkpoint
decisions exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_quest_tpu import utils as jutils
from llm_quest_tpu.data import datasets as jdata
from llm_quest_tpu.models import gpt2 as jg
from llm_quest_tpu.training import classifier as jcls
from llm_quest_tpu.training import engine as jengine
from llm_quest_tpu.training import profiling as jprof
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch import utils as tutils
from llm_quest_tpu_torch.data import datasets as tdata
from llm_quest_tpu_torch.models import gpt2 as tg
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import checkpointing as tckpt
from llm_quest_tpu_torch.training import classifier as tcls
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.training import profiling as tprof
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {"vocab_size": 128, "context_length": 96, "emb_dim": 32, "n_heads": 4, "n_layers": 2, "drop_rate": 0.0,
        "qkv_bias": False}
# Adam moves an element whose gradient is fp32 cancellation noise by up to the learning rate in either
# framework: at 1e-5 two steps stay inside the 1e-5 bar
LR = 1e-5
PAD = 127
TEXTS = ["buy cheap pills now", "hi mom how are you", "free money claim your prize today", "see you at dinner",
         "win a car", "the meeting moved to noon", "click here for cash", "thanks for the notes"]


class CharTok:
    def encode(self, text):
        return [min(b, 126) for b in text.encode()]

    def decode(self, ids):
        return bytes(int(i) for i in ids).decode(errors="ignore")


class SpecialTok(CharTok):
    """tiktoken's signature: ``encode(text, allowed_special=...)``."""

    def encode(self, text, allowed_special=()):
        return super().encode(text.replace("<|endoftext|>", "\x7f")) + [len(allowed_special)]


def T(x):
    return torch.from_numpy(np.array(x))


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def arr(x):
    return x.detach().float().numpy().astype(np.float64) if torch.is_tensor(x) else np.asarray(x, np.float64)


def rel(got, ref):
    d = float(np.abs(arr(got) - arr(ref)).max())
    return d / max(float(np.abs(arr(ref)).max()), 1e-30)


def port_layout(model, name, a):
    owner = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(owner), Linear):
        return np.asarray(a).T
    return np.asarray(a)


def capturing(tx):
    """``tx`` after a transformation keeping the gradients it is given in its state."""

    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module's tiny tensors: on an 8-thread host a
    tiny GPT-2 pass took ~0.3 s with the default pool and ~3 ms with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return jg.init(jax.random.PRNGKey(0), TINY)


@pytest.fixture
def model(jparams):
    return from_jax_flat(flat(jparams), TINY, device="cpu")


def spam_batches():
    """Two right-padded batches of 4 (labels 1 = spam), padded to the training set's length."""
    rows = [(t, int(i % 2 == 0)) for i, t in enumerate(TEXTS)]
    data = tdata.spam_dataset(rows, CharTok(), pad_token=PAD)
    keys = ("input_ids", "targets", "attn_mask")
    return [{k: data[k][i : i + 4] for k in keys} for i in (0, 4)]


# ------------------------------------------------------------------ utils


def test_text_helpers_and_formats_match_jax():
    for tok in (CharTok(), SpecialTok()):
        ref, got = jutils.text_to_ids("hi<|endoftext|>", tok), tutils.text_to_ids("hi<|endoftext|>", tok)
        assert np.array_equal(ref, got) and got.dtype == np.int32 and got.shape[0] == 1
    ids = np.asarray([[104, 105, 33]])
    assert tutils.ids_to_text(ids, CharTok()) == jutils.ids_to_text(ids, CharTok()) == "hi!"
    assert tutils.ids_to_text(T(ids[0]), CharTok()) == "hi!"
    entries = [{"instruction": "Greet", "input": "", "output": "Hello"}, {"instruction": "Add", "input": "2 3"},
               {"instruction": "Say", "input": "x", "output": ""}]
    for e in entries:
        for inc in (True, False):
            assert tutils.alpaca_prompt_format(e, inc) == jutils.alpaca_prompt_format(e, inc)
    for e in ({"question": "2+2?", "answer": "two and two\n#### 4"}, {"question": "1?", "answer": " 1 "}):
        for inc in (True, False):
            assert tutils.alpaca_deepseek_format(e, inc) == jutils.alpaca_deepseek_format(e, inc)


def test_time_it_prints_and_returns(capsys):
    got = tutils.time_it(lambda x: x + 1)(2)
    assert got == 3 and "Finished '<lambda>' in" in capsys.readouterr().out


@pytest.mark.parametrize("text", [
    "<think>a</think><think> b </think><answer>1</answer>", "<answer>1</answer>",
    "<think>x</think>no answer", "<think>x</think><answer>2</answer><answer> 3,5 </answer>",
])
def test_response_extractor_matches_jax(text):
    for fn in ("get_reasoning", "get_answer"):
        assert getattr(tutils.ResponseExtractor, fn)(text) == getattr(jutils.ResponseExtractor, fn)(text)
    for ans in (" 1,234.5 ", "1.000,50", "- 72", "no numbers", "", None, "+3.", "12,5"):
        assert tutils.ResponseExtractor.sanitize_answer(ans) == jutils.ResponseExtractor.sanitize_answer(ans)


def test_entropy_filtered_tokens_match_jax():
    rng = np.random.default_rng(0)
    ref, got = jutils.EntropyFilteredTokens(top_k=8, pad_token=PAD), tutils.EntropyFilteredTokens(top_k=8,
                                                                                                   pad_token=PAD)
    for b in range(2):
        logits = (rng.normal(size=(3, 9, 40)) * rng.uniform(0.2, 3.0, size=(3, 9, 1))).astype(np.float32)
        ids = rng.integers(0, 40, (3, 9))
        ids[1, 6:] = PAD
        index = np.arange(3) + 3 * b
        ref.process_batch(logits, ids, index)
        got.process_batch(T(logits), T(ids), T(index))
    assert got.get_difficulty_indices() == ref.get_difficulty_indices()
    assert all(len(v) for v in got.get_difficulty_indices().values())


def test_checkpoint_evaluator_and_save_if_best_match_jax(tmp_path, model):
    """The same metrics through the port's ``save_if_best`` and JAX's
    evaluator give the same decisions; a save happens exactly on them."""
    calls = [("rlhf", {"kl": 0.9, "reward": 10.0}), ("rlhf", {"kl": 0.1, "reward": 5.0}),
             ("rlhf", {"kl": 0.1, "reward": 8.0}), ("rlhf", {"kl": 0.2, "reward": 8.0}),
             ("rlvr", {"kl": 0.05, "reward": 9.0}), ("rm", {"accuracy": 0.95, "val_loss": 0.05}),
             ("rm", {"accuracy": 0.85, "val_loss": 0.01}), ("rm", {"accuracy": 0.97, "val_loss": 0.2}),
             ("rm", {"accuracy": 0.99, "val_loss": 0.08})]
    jev, tev = jutils.CheckpointEvaluator(), tutils.CheckpointEvaluator()
    method = {"rlhf": "is_rlhf_grpo_best", "rlvr": "is_rlvr_grpo_best", "rm": "is_rm_accu_best"}
    for i, (kind, metrics) in enumerate(calls):
        args = (metrics["kl"], metrics["reward"]) if kind != "rm" else (metrics["accuracy"], metrics["val_loss"])
        want = getattr(jev, method[kind])(*args)
        got = tckpt.save_if_best(tmp_path / str(i), tev, kind, metrics, model, step=i)
        assert got == want and (tmp_path / str(i) / tckpt.FILE_NAME).exists() == want, i
    with pytest.raises(ValueError, match="Unknown"):
        tckpt.save_if_best(tmp_path / "x", tev, "dpo", {}, model)


# ------------------------------------------------------------------ datasets


def test_instruction_spam_and_csv_datasets_match_jax(tmp_path):
    entries = [{"instruction": "Greet", "input": "", "output": "Hi"}, {"instruction": "Add", "input": "1 2",
                                                                         "output": "3"}]
    (tmp_path / "a.json").write_text(json.dumps(entries))
    (tmp_path / "a.jsonl").write_text("\n".join(json.dumps(e) for e in entries) + "\n\n")
    for name in ("a.json", "a.jsonl"):
        data = tdata.load_instruction_data(tmp_path / name)
        assert data == jdata.load_instruction_data(tmp_path / name) == entries
    tok = CharTok()
    assert (tdata.instruction_dataset(entries, tok, tutils.alpaca_prompt_format)
            == jdata.instruction_dataset(entries, tok, jutils.alpaca_prompt_format))
    (tmp_path / "spam.csv").write_text("text,label\n" + "\n".join(f'"{t}",{i % 2}' for i, t in enumerate(TEXTS)))
    rows = tdata.load_csv_rows(tmp_path / "spam.csv")
    assert rows == jdata.load_csv_rows(tmp_path / "spam.csv")
    for max_length in (None, 12):
        ref, got = jdata.spam_dataset(rows, tok, max_length), tdata.spam_dataset(rows, tok, max_length)
        assert ref["max_length"] == got["max_length"]
        assert all(np.array_equal(ref[k], got[k]) and ref[k].dtype == got[k].dtype
                   for k in ("input_ids", "targets", "attn_mask"))


def test_reasoning_and_preference_datasets_match_jax(tmp_path):
    tok = CharTok()
    gsm = [{"question": "What is 2+2?", "answer": "2 plus 2 equals 4.\n#### 4"},
           {"question": "Half of 10?", "answer": "5"}]
    (tmp_path / "gsm.jsonl").write_text("\n".join(json.dumps(e) for e in gsm))
    assert tdata.reasoning_dataset(tmp_path / "gsm.jsonl", tok) == jdata.reasoning_dataset(tmp_path / "gsm.jsonl",
                                                                                           tok)
    pref = [{"instruction": "Greet", "input": "", "chosen": "Hello!", "rejected": "Go away."},
            {"instruction": "Sum", "input": "1 1", "chosen": "2", "rejected": "11"}]
    (tmp_path / "pref.json").write_text(json.dumps(pref))
    for prompts_only in (False, True):
        assert (tdata.preference_dataset(tmp_path / "pref.json", tok, prompts_only)
                == jdata.preference_dataset(tmp_path / "pref.json", tok, prompts_only))


class ChatTok(CharTok):
    def apply_chat_template(self, messages, *, tokenize, add_generation_prompt, enable_thinking):
        text = "<u>" + messages[0]["content"] + "<g>"
        return {"input_ids": self.encode(text)} if tokenize else text


@pytest.mark.parametrize("options", [
    {}, {"min_context_tokens": 3, "truncate_sample": (2, 60)}, {"valid_indices": [(0, 3), (1, 5), (0, 900)]},
    {"apply_chat_template": True, "instruction": "Next:"}], ids=["plain", "min_ctx", "indices", "chat"])
def test_rpt_datasets_match_jax(options):
    entries = [{"question": "Count to five:", "answer": "one two three four five\n#### five"},
               {"question": "Tom has 3 apples and buys 4.", "answer": "He has 3 + 4 = 7.\n#### 7"}]
    tok = ChatTok()
    ref = jdata.rpt_structured_dataset(entries, tok, 40, labels_length=5, **options)
    got = tdata.rpt_structured_dataset(entries, tok, 40, labels_length=5, **options)
    assert got[0] == ref[0] and got[1] == ref[1] and len(got[1])
    assert all(got[2](i) == ref[2](i) for i in range(len(got[1])))
    text = entries[1]["question"] + " " + entries[1]["answer"]
    kw = {k: v for k, v in options.items() if k in ("min_context_tokens", "instruction")}
    ref = jdata.rpt_continuous_dataset(text, tok, 30, labels_length=4, **kw)
    got = tdata.rpt_continuous_dataset(text, tok, 30, labels_length=4, **kw)
    assert got[:2] == ref[:2] and all(got[2](i) == ref[2](i) for i in range(len(got[1])))


# ------------------------------------------------------------------ classification


def test_classifier_train_step_matches_jax(jparams, model):
    """``make_classifier_train_step``: the loss and every gradient of the
    first step, the parameters after 2 steps (``optax.adamw`` at weight
    decay 0.1), then the eval step and ``classifier_accuracy``."""
    batches = spam_batches()
    tb = tengine.as_tensors(batches[0], "cpu")
    logits, _, _ = tg.apply(model, TINY, tb["input_ids"], attn_mask=tb["attn_mask"], last_token_only=True)
    loss = tengine.global_loss(logits, tb["targets"], classification=True)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    jtx = capturing(optax.adamw(LR, weight_decay=0.1))
    jstep = jcls.make_classifier_train_step(jg, TINY, jtx)
    tstep = tcls.make_classifier_train_step(tg, TINY, tengine.adamw(LR, weight_decay=0.1))
    jp, jstate, tstate = jparams, jtx.init(jparams), tengine.adamw(LR, weight_decay=0.1).init(model)
    for i, batch in enumerate(batches):
        jp, jstate, jloss = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        if i == 0:
            assert rel(loss, jloss) <= 1e-5
            ref = {k.replace("/", "."): v for k, v in flat(jstate[0]).items()}
            for (name, _), g in zip(model.named_parameters(), grads):
                r = port_layout(model, name, ref[name])
                assert (rel(g, r) <= 1e-5) if np.abs(r).max() > 0 else float(g.abs().max()) == 0.0, name
        model, tstate, tloss = tstep(model, tstate, batch)
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss))), i
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert float(np.abs(arr(p) - port_layout(model, name, ref[name.replace(".", "/")])).max()) <= 1e-5, name
    jeval, teval = jcls.make_classifier_eval_step(jg, TINY), tcls.make_classifier_eval_step(tg, TINY)
    for batch in batches:
        (rl, rc), (gl, gc) = jeval(jp, {k: jnp.asarray(v) for k, v in batch.items()}), teval(model, batch)
        assert rel(gl, rl) <= 1e-5 and int(gc) == int(rc)
    assert tcls.classifier_accuracy(batches, teval, model) == jcls.classifier_accuracy(
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], jeval, jp)


def test_classifier_training_loop_matches_jax(jparams, model):
    batches = spam_batches()
    kw = dict(num_epoch=2, lr=LR, eval_freq=2, eval_iter=1)
    jlogs, tlogs = [], []
    jp = jcls.classifier_training_loop(jg, TINY, jparams, [{k: jnp.asarray(v) for k, v in b.items()}
                                                          for b in batches], batches[:1], log=jlogs.append, **kw)
    model = tcls.classifier_training_loop(tg, TINY, model, batches, batches[:1], log=tlogs.append, **kw)
    assert len(tlogs) == len(jlogs) == 3  # steps 1, 2, 4
    ref = flat(jp)
    for name, p in model.named_parameters():
        assert float(np.abs(arr(p) - port_layout(model, name, ref[name.replace(".", "/")])).max()) <= 1e-5, name


def test_training_eval_loop_classification_matches_jax(jparams, model):
    """``training_eval_loop(classification=True)`` (clipped AdamW, warm-up
    and cosine decay): the evaluated train and validation losses against
    JAX's."""
    batches = spam_batches()
    kw = dict(num_epoch=2, peak_lr=1e-3, init_lr=1e-4, warmup_steps=1, min_lr=1e-4, decay="cosine", eval_freq=2,
              eval_iter=2, classification=True, log=lambda _: None)
    _, jtr, jva = jengine.training_eval_loop(jg, TINY, jax.tree.map(jnp.copy, jparams), batches, batches[1:],
                                             **kw)  # JAX's step donates its parameters
    _, ttr, tva = tengine.training_eval_loop(tg, TINY, model, batches, batches[1:], **kw)
    assert len(ttr) == len(jtr) == 3
    np.testing.assert_allclose(ttr, jtr, rtol=1e-5, atol=0)
    np.testing.assert_allclose(tva, jva, rtol=1e-5, atol=0)
    with pytest.raises(ValueError, match="fused_head_ce"):
        tengine.make_loss_fn(tg, TINY, classification=True, fused_head_ce=True)


# ------------------------------------------------------------------ checkpointing, profiling


def test_checkpoint_round_trip_resumes_the_same_training(tmp_path, jparams):
    """Two steps, a save, two more steps; a fresh model and optimizer state
    loaded from the save then take the same two steps: the parameters and
    every optimizer tensor equal, bit for bit."""
    batches = spam_batches()
    opt = tengine.make_optimizer(1e-3, weight_decay=0.1)
    step = tengine.make_train_step(tg, TINY, opt, classification=True)
    model = from_jax_flat(flat(jparams), TINY, device="cpu")
    state = opt.init(model)
    for b in batches:
        model, state, _ = step(model, state, b)
    path = tckpt.save_checkpoint(tmp_path / "ckpt", model, opt_state=state, step=2, extra={"note": "x"},
                                 blocking=False)
    tckpt.wait_for_saves()
    for b in batches:
        model, state, _ = step(model, state, b)
    fresh = tg.init(TINY, generator=torch.Generator().manual_seed(1), device="cpu")
    loaded = tckpt.load_checkpoint(path, target=fresh)
    assert loaded["params"] is fresh and loaded["step"] == 2 and loaded["extra"] == {"note": "x"}
    resumed = loaded["opt_state"]
    for b in batches:
        fresh, resumed, _ = step(fresh, resumed, b)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), fresh.state_dict().values()))
    assert resumed["count"] == state["count"] == 4
    assert all(torch.equal(a, b) for key in ("mu", "nu") for a, b in zip(state[key], resumed[key]))
    raw = tckpt.load_checkpoint(path, device="cpu")
    assert set(raw) == {"params", "opt_state", "step", "extra"} and isinstance(raw["params"], dict)


def test_scheduled_profiler_follows_jax_and_writes_traces(tmp_path, monkeypatch):
    events = []
    monkeypatch.setattr(jprof.jax.profiler, "start_trace", lambda d: events.append(d))
    monkeypatch.setattr(jprof.jax.profiler, "stop_trace", lambda: None)
    jp = jprof.ScheduledProfiler(tmp_path / "j", wait=1, warmup=1, active=2, repeat=2)
    ref = [jp.step() for _ in range(10)]
    x = torch.ones(8, 8)
    with tprof.ScheduledProfiler(tmp_path / "t", wait=1, warmup=1, active=2, repeat=2) as p:
        got = []
        for _ in range(10):
            (x @ x).sum()
            got.append(p.step())
    assert got == ref == [False, False, True, True] * 2 + [False, False]
    for k in range(2):
        trace = json.loads((tmp_path / "t" / f"cycle_{k}" / "trace.json").read_text())
        assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    p2 = tprof.ScheduledProfiler(tmp_path / "early", wait=0, warmup=0, active=5)
    assert p2.step() and p2.step()  # tracing, the window unfinished
    assert not (tmp_path / "early").exists()
    p2.close()  # an early exit writes the trace in flight
    assert (tmp_path / "early" / "cycle_0" / "trace.json").exists()


def test_profile_trace_meter_memory_and_debug_checks(tmp_path):
    with tprof.profile_trace(tmp_path / "one") as prof:
        torch.ones(4, 4).sum()
    assert (tmp_path / "one" / "trace.json").exists() and len(prof.key_averages()) > 0
    assert tprof.device_memory_gb("cpu") == (0.0, 0.0)
    meter = tprof.ThroughputMeter(flops_per_token=1e6, device="cpu")
    meter.update(1000)
    r = meter.report()
    assert r["tok_s_interval"] > 0 and r["tok_s_cumulative"] > 0 and r["mem_gb_limit"] == 0.0 and "mfu_interval" \
        not in r and meter.tokens_interval == 0
    x = torch.tensor([-1.0], requires_grad=True)
    with tprof.debug_checks(disable_jit=True):
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.device_memory_gb()
