"""The ported alignment stack (DPO, the reward model, GRPO, RLVR, RPT)
against the JAX package, on the CPU in fp32.

JAX's tiny GPT-2 of ``tests/test_alignment.py`` (2 layers, 4 heads of 8,
vocabulary 128, context 96) is initialised in JAX as the policy, the
reference and the reward model's body, flattened and loaded into the port
with ``from_jax_flat``; every input comes from numpy seeds. JAX's steps run
with an optimizer that records the gradients it is given before AdamW
(``capturing``), so one jitted JAX step per case gives both its gradients
and its parameters. Tolerances: the math functions within 1e-6 relative;
each step's loss and every gradient within 1e-5 relative to the leaf's
largest gradient; the parameters after 2 steps within 1e-5 absolute;
collators and masks exactly. The GRPO update runs on an injected experience
whose key masks have holes (prompt pads between the prompt and the
response, the tokens after the first EoS cut); one case runs JAX's K4 in
interpret mode (``use_flash=True``, ``flash_min_seq`` 16) against the port's
plain K4. Sampling is compared at temperature 0 (JAX's rng and a
``torch.Generator`` draw different tokens).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_quest_tpu.alignment import dpo as jdpo
from llm_quest_tpu.alignment import grpo as jgrpo
from llm_quest_tpu.alignment import rlvr as jrlvr
from llm_quest_tpu.alignment import rpt as jrpt
from llm_quest_tpu.data import datasets as jdata
from llm_quest_tpu.models import gpt2 as jg
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.alignment import dpo as tdpo
from llm_quest_tpu_torch.alignment import grpo as tgrpo
from llm_quest_tpu_torch.alignment import rlvr as trlvr
from llm_quest_tpu_torch.alignment import rpt as trpt
from llm_quest_tpu_torch.data import datasets as tdata
from llm_quest_tpu_torch.models import gpt2 as tg
from llm_quest_tpu_torch.ops.linear import Linear
from llm_quest_tpu_torch.training import engine as tengine
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TINY = {  # tests/test_alignment.py's
    "vocab_size": 128,
    "context_length": 96,
    "emb_dim": 32,
    "n_heads": 4,
    "n_layers": 2,
    "drop_rate": 0.0,
    "qkv_bias": False,
}
FLASH = dict(TINY, use_flash=True, flash_min_seq=16)  # JAX: the Pallas kernel in interpret mode; port: K4's plain
EOS = 127  # also the pad id, as GPT-2's 50256
LR = 1e-4
P, G = 6, 12  # the injected experience: prompt columns, generated columns (s 18)
NUM_SAMPLES = 2


class CharTokenizer:
    """tests/test_alignment.py's byte tokenizer."""

    def encode(self, text):
        return [min(b, 127) for b in text.encode("utf-8")]

    def decode(self, ids):
        return bytes(ids).decode("utf-8", errors="ignore")


def T(x):
    return torch.from_numpy(np.array(x))


def flat(params):
    return {k: np.asarray(v) for k, v in flatten_params(params).items()}


def arr(x):
    return x.detach().float().numpy().astype(np.float64) if torch.is_tensor(x) else np.asarray(x, np.float64)


def rel(got, ref):
    """max |got - ref| / max |ref| (0-d and arrays)."""
    d = float(np.abs(arr(got) - arr(ref)).max())
    return d / max(float(np.abs(arr(ref)).max()), 1e-30)


def close(got, ref, tol=1e-5):
    """|got - ref| <= tol · max(1, |ref|): a loss after an update, or a
    loop's metric (near zero a relative bar would read noise)."""
    return abs(float(got) - float(ref)) <= tol * max(1.0, abs(float(ref)))


def port_layout(model, name, a):
    owner = name.rsplit(".", 1)[0]
    if name.endswith(".w") and isinstance(model.get_submodule(owner), Linear):
        return np.asarray(a).T
    return np.asarray(a)


def capturing(tx):
    """``tx`` after a transformation that keeps the gradients it is given in
    its state: a JAX step's opt_state[0] is then that step's gradient."""

    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def assert_grads(model, grads, jgrads, tol=1e-5, invariant=None):
    """Every gradient within ``tol`` of its leaf's largest JAX gradient.
    ``invariant`` maps a leaf whose gradient is zero in exact arithmetic
    (fp32 noise on both sides) to the leaf that scales it: both stay under
    ``tol`` times that leaf's largest gradient."""
    ref = {k.replace("/", "."): v for k, v in flat(jgrads).items()}
    invariant = invariant or {}
    for (name, _), g in zip(model.named_parameters(), grads):
        r = port_layout(model, name, ref[name])
        if name in invariant:
            scale = float(np.abs(ref[invariant[name]]).max())
            assert max(float(g.abs().max()), float(np.abs(r).max())) <= tol * scale, name
            continue
        if np.abs(r).max() == 0:
            assert float(g.abs().max()) == 0.0, name
            continue
        assert rel(g, r) <= tol, (name, rel(g, r))


def assert_params(model, jparams, tol=1e-5, noise=(), steps=2):
    """Every parameter within ``tol`` of JAX's. A leaf of ``noise`` (its
    gradient zero but for fp32 noise) moves by up to the learning rate a
    step in either framework (Adam divides the noise by its own scale):
    the two are held within twice that over ``steps``."""
    ref = flat(jparams)
    for name, p in model.named_parameters():
        r = port_layout(model, name, ref[name.replace(".", "/")])
        bar = 2 * steps * LR if name in noise else tol
        assert float(np.abs(arr(p) - r).max()) <= bar, name


def grads_of(loss, model):
    return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True, materialize_grads=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module's tiny tensors: on an 8-thread host a
    tiny GPT-2 pass took ~0.3 s with the default pool and ~3 ms with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmodels():
    """JAX's policy, reference and reward model (fp32)."""
    return (jg.init(jax.random.PRNGKey(0), TINY), jg.init(jax.random.PRNGKey(1), TINY),
            jgrpo.init_reward_model(jax.random.PRNGKey(2), TINY))


@pytest.fixture
def tmodels(jmodels):
    """The port's copies, fresh for each test (steps update them in place)."""
    return tuple(from_jax_flat(flat(p), TINY, device="cpu") for p in jmodels)


# the BT loss reads reward differences: a constant added to every score (the head's bias, the final
# LayerNorm's shift through the head) cancels, so these gradients are zero but for noise
RM_INVARIANT = {"head.b": "head.w", "body.final_ln.shift": "head.w"}


def pref_samples(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, 126, rng.integers(3, 7)).tolist()
        out.append({"prompt": prompt,
                    "chosen": prompt + rng.integers(0, 126, rng.integers(4, 11)).tolist(),
                    "rejected": prompt + rng.integers(0, 126, rng.integers(4, 11)).tolist()})
    return out


def jnp_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ------------------------------------------------------------------ DPO


def test_compute_logprobs_and_dpo_loss_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 16)).astype(np.float32)
    ids = rng.integers(0, 16, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) > 0.3
    mask[:, 0] = True
    for m in (None, mask):
        ref = jdpo.compute_logprobs(jnp.asarray(logits), jnp.asarray(ids), None if m is None else jnp.asarray(m))
        got = tdpo.compute_logprobs(T(logits), T(ids), None if m is None else T(m))
        assert rel(got, ref) <= 1e-6
    pc, pr, rc, rr = (rng.normal(size=4).astype(np.float32) for _ in range(4))
    for smoothing in (0.0, 0.1):
        ref = jdpo.dpo_loss(*(jnp.asarray(x) for x in (pc, pr, rc, rr)), beta=0.1, label_smoothing=smoothing)
        got = tdpo.dpo_loss(*(T(x) for x in (pc, pr, rc, rr)), beta=0.1, label_smoothing=smoothing)
        for g, r in zip(got, ref):
            assert rel(g, r) <= 1e-6


def test_dpo_collate_matches_jax():
    samples = pref_samples(1)
    for kw in ({}, {"allowed_max_length": 9, "mask_prompt_tokens": False}):
        ref, got = jdata.dpo_collate(samples, EOS, **kw), tdata.dpo_collate(samples, EOS, **kw)
        assert ref.keys() == got.keys() and all(np.array_equal(ref[k], got[k]) for k in ref)


def test_dpo_train_step_matches_jax(jmodels, tmodels):
    """Loss and every gradient of the first step against JAX's, then the
    policy after 2 steps of ``make_dpo_train_step`` (the reference frozen)."""
    jpol, jref, _ = jmodels
    pol, ref_model, _ = tmodels
    batch = tdata.dpo_collate(pref_samples(2), EOS)
    jstep = jdpo.make_dpo_train_step(jg, TINY, capturing(optax.adamw(LR)), beta=0.1, label_smoothing=0.1)
    jp, jstate = jpol, capturing(optax.adamw(LR)).init(jpol)
    tb = tengine.as_tensors(batch, "cpu")
    loss, cr, rr = tdpo.dpo_forward(tg, TINY, pol, ref_model, tb, beta=0.1, label_smoothing=0.1)
    grads = grads_of(loss, pol)
    tstep = tdpo.make_dpo_train_step(tg, TINY, tengine.adamw(LR), beta=0.1, label_smoothing=0.1)
    tstate = tengine.adamw(LR).init(pol)
    for i in range(2):
        jp, jstate, jm = jstep(jp, jstate, jref, jnp_batch(batch))
        if i == 0:
            assert rel(loss, jm["loss"]) <= 1e-5 and rel(cr, jm["chosen_rewards"]) <= 1e-5
            assert_grads(pol, grads, jstate[0])
        pol, tstate, tm = tstep(pol, tstate, ref_model, batch)
        assert close(tm["loss"], jm["loss"]), i
    assert_params(pol, jp)
    vl, vm = tdpo.dpo_evaluate(tg, TINY, pol, ref_model, [batch], beta=0.1)
    jl, jmarg = jdpo.dpo_evaluate(jg, TINY, jp, jref, [jnp_batch(batch)], beta=0.1)
    assert rel(vl, jl) <= 1e-5 and rel(vm, jmarg) <= 1e-5


def test_dpo_training_loop_composes_the_held_step(tmodels):
    """``dpo_training_loop`` (2 batches, 2 epochs, a validation loader)
    equals ``make_dpo_train_step`` taken 4 times at its settings
    (``optax.adamw(lr)``), which the test above holds to JAX, and logs at
    steps 1 and 2 and 4 (``eval_freq`` 2)."""
    pol, ref_model, _ = tmodels
    twin = copy.deepcopy(pol)
    batches = [tdata.dpo_collate(pref_samples(20 + i), EOS) for i in range(2)]
    logs = []
    pol = tdpo.dpo_training_loop(tg, TINY, pol, ref_model, batches, num_epochs=2, lr=LR, val_loader=batches[:1],
                                 eval_freq=2, log=logs.append)
    step = tdpo.make_dpo_train_step(tg, TINY, tengine.adamw(LR))
    state = tengine.adamw(LR).init(twin)
    for batch in batches * 2:
        twin, state, _ = step(twin, state, ref_model, batch)
    assert all(torch.equal(a, b) for a, b in zip(pol.parameters(), twin.parameters()))
    assert len(logs) == 3 and all("val loss" in line for line in logs)


# ----------------------------------------------------------- reward model


def test_pref_reward_collate_matches_jax():
    samples = pref_samples(3)
    for kw in ({}, {"allowed_max_length": 8}):
        ref, got = jdata.pref_reward_collate(samples, EOS, **kw), tdata.pref_reward_collate(samples, EOS, **kw)
        assert ref.keys() == got.keys() and all(np.array_equal(ref[k], got[k]) for k in ref)


def test_from_jax_flat_loads_the_reward_model(jmodels, tmodels):
    rm = tmodels[2]
    assert isinstance(rm, tgrpo.RewardModel) and isinstance(rm.body, tg.GPT2)
    assert {n.replace(".", "/") for n, _ in rm.named_parameters()} == set(flatten_params(jmodels[2]))
    assert tuple(rm.head.w.shape) == (1, TINY["emb_dim"]) and rm.head.b is not None
    init = tgrpo.init_reward_model(TINY, generator=torch.Generator().manual_seed(0), device="cpu")
    assert float(init.head.w.detach().abs().max()) <= TINY["emb_dim"] ** -0.5
    if not torch.cuda.is_available():  # the entry point builds on the card unless told otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgrpo.init_reward_model(TINY, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("readout", ["scores_mean_pooling", "hidden_states_pooling", "last_token"])
def test_rm_readouts_and_train_step_match_jax(jmodels, tmodels, readout):
    """On ``pref_reward_collate``'s right-padded batches: each readout, the
    BT loss and every gradient of the first step, the parameters after 2
    steps and ``rm_evaluate``."""
    jrm, rm = jmodels[2], tmodels[2]
    batch = tdata.pref_reward_collate(pref_samples(4, n=4), EOS)
    tb, jb = tengine.as_tensors(batch, "cpu"), jnp_batch(batch)
    for key in ("chosen", "rejected"):
        ref = jgrpo.reward_model_apply(jrm, TINY, jb[key], attn_mask=jb[f"{key}_attn_mask"],
                                       reward_mask=jb[f"{key}_mask"], readout=readout)
        got = tgrpo.reward_model_apply(rm, TINY, tb[key], attn_mask=tb[f"{key}_attn_mask"],
                                       reward_mask=tb[f"{key}_mask"], readout=readout)
        assert rel(got, ref) <= 1e-6, key
    c, r = tgrpo._rm_pair(rm, TINY, tb, readout)
    loss = tgrpo.bt_loss(c, r, 1.0)
    grads = grads_of(loss, rm)
    jstep = jgrpo.make_rm_train_step(TINY, capturing(optax.adamw(LR)), readout=readout)
    tstep = tgrpo.make_rm_train_step(TINY, tengine.adamw(LR), readout=readout)
    jp, jstate, tstate = jrm, capturing(optax.adamw(LR)).init(jrm), tengine.adamw(LR).init(rm)
    for i in range(2):
        jp, jstate, jloss, jacc = jstep(jp, jstate, jb)
        if i == 0:
            assert rel(loss, jloss) <= 1e-5
            assert_grads(rm, grads, jstate[0], invariant=RM_INVARIANT)
        rm, tstate, tloss, tacc = tstep(rm, tstate, batch)
        assert close(tloss, jloss) and float(tacc) == float(jacc), i
    assert_params(rm, jp, noise=RM_INVARIANT)
    got, ref = tgrpo.rm_evaluate(rm, TINY, [batch], readout=readout), jgrpo.rm_evaluate(jp, TINY, [jb],
                                                                                         readout=readout)
    assert rel(got[0], ref[0]) <= 1e-5 and got[1] == ref[1]


def test_bt_loss_matches_jax():
    rng = np.random.default_rng(5)
    c, r = rng.normal(size=6).astype(np.float32), rng.normal(size=6).astype(np.float32)
    for beta in (1.0, 0.5):
        assert rel(tgrpo.bt_loss(T(c), T(r), beta), jgrpo.bt_loss(jnp.asarray(c), jnp.asarray(r), beta)) <= 1e-6


def test_last_token_score_reads_the_last_real_column_unlike_jax(jmodels, tmodels):
    """JAX reads column sum(mask) - 1: on a right-padded mask that is the
    last real token and both agree; on a GRPO mask with holes (the prompt's
    pads before the response) it lies inside the response, and the port,
    which reads the last True column, differs from JAX there."""
    jrm, rm = jmodels[2], tmodels[2]
    ids = np.random.default_rng(6).integers(0, 126, (2, 10)).astype(np.int32)
    padded = np.zeros((2, 10), bool)
    padded[0, :10], padded[1, :7] = True, True
    holed = padded.copy()
    holed[1, 3:5] = False  # two prompt pads
    holed[1, 7:9] = True   # the response after them
    for mask, agree, col in ((padded, True, 6), (holed, False, 8)):
        ref = jgrpo.reward_model_apply(jrm, TINY, jnp.asarray(ids), attn_mask=jnp.asarray(mask), readout="last_token")
        got = tgrpo.reward_model_apply(rm, TINY, T(ids), attn_mask=T(mask), readout="last_token")
        hidden, _, _ = tg.apply(rm.body, TINY, T(ids), attn_mask=T(mask), output_hidden_states=True)
        last = rm.head(hidden[1, col])[0]  # row 1's last True column
        assert rel(got[1], last) <= 1e-6
        assert rel(got[0], ref[0]) <= 1e-6
        assert (rel(got[1], ref[1]) <= 1e-6) == agree


# ------------------------------------------------------- GRPO: math, collators


def test_prompt_and_responses_collators_match_jax():
    prompts = [[5, 9, 2, 17], [11, 3], [8]]
    for kw in ({}, {"custom_max_length": 3}):
        ref, got = jgrpo.prompt_collator(prompts, EOS, **kw), tgrpo.prompt_collator(prompts, EOS, **kw)
        assert all(np.array_equal(ref[k], got[k]) and ref[k].dtype == got[k].dtype for k in ref)
    coll = tgrpo.prompt_collator(prompts, EOS)
    rng = np.random.default_rng(7)
    responses = np.concatenate([coll["padded_prompts"], rng.integers(0, 126, (3, 8))], 1).astype(np.int32)
    responses[0, 6], responses[0, 9] = EOS, EOS  # cut after the first EoS
    responses[1, 5] = 9  # another stop id, listed in eos_ids
    for eos_ids in (EOS, [EOS, 9]):
        ref = jgrpo.batched_responses_collator(jnp.asarray(responses), jnp.asarray(coll["prompt_masks"]),
                                               eos_ids=eos_ids, pad_token_id=EOS)
        got = tgrpo.batched_responses_collator(T(responses), T(coll["prompt_masks"]), eos_ids=eos_ids,
                                               pad_token_id=EOS)
        for k in ref:
            assert np.array_equal(np.asarray(ref[k]), got[k].numpy()), (eos_ids, k)
    assert not got["attn_masks"][2, 1:4].any() and got["attn_masks"][2, 4:].any()  # a hole before the response


@pytest.mark.parametrize("mode", ["grpo", "dr_grpo", "phantom"])
def test_z_scores_match_jax(mode):
    rewards = np.random.default_rng(8).normal(size=8).astype(np.float32) * 3
    kw = {"dr_grpo": "dr_grpo"} if mode == "dr_grpo" else {"use_phantom_reward": mode == "phantom"}
    ref = jgrpo.z_scores(jnp.asarray(rewards), 4, **kw)
    got = tgrpo.z_scores(T(rewards), 4, **kw)
    assert rel(got, ref) <= 1e-6
    # one sample a group: the unbiased std is NaN in both, as ddof=1 gives it
    with pytest.warns(UserWarning, match="degrees of freedom"):  # torch says so; numpy's ddof=1 is silent
        one = tgrpo.z_scores(T(rewards), 1)
    one_ref = jgrpo.z_scores(jnp.asarray(rewards), 1)
    assert np.isnan(np.asarray(one_ref)).all() and torch.isnan(one).all()


def test_logprobs_kl_and_off_policy_mask_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 7, 16)).astype(np.float32)
    ids = rng.integers(0, 16, (3, 7)).astype(np.int32)
    lp_ref = jgrpo.log_probs_per_token(jnp.asarray(logits), jnp.asarray(ids))
    lp = tgrpo.log_probs_per_token(T(logits), T(ids))
    assert rel(lp, lp_ref) <= 1e-6
    assert rel(tgrpo.log_probs_per_token_optimized(T(logits), T(ids)),
               jgrpo.log_probs_per_token_optimized(jnp.asarray(logits), jnp.asarray(ids))) <= 1e-6
    mask = rng.random((3, 6)) > 0.3
    assert rel(tgrpo.log_probs_per_seq(lp, T(mask)), jgrpo.log_probs_per_seq(lp_ref, jnp.asarray(mask))) <= 1e-6
    other = lp + T(rng.normal(size=(3, 6)).astype(np.float32))
    ratio = torch.exp(lp - other)
    for pr in (None, ratio):
        got = tgrpo.kl_div_per_token(lp, other, policy_ratio=pr)
        ref = jgrpo.kl_div_per_token(jnp.asarray(lp.numpy()), jnp.asarray(other.numpy()),
                                     policy_ratio=None if pr is None else jnp.asarray(pr.numpy()))
        assert rel(got, ref) <= 1e-6
    kl = tgrpo.kl_div_per_token(lp, other)
    adv = np.asarray([-1.0, 0.5, -0.2], np.float32)
    for delta in (0.1, 0.5, 5.0):
        ref = jgrpo.off_policy_seq_mask(jnp.asarray(kl.numpy()), jnp.asarray(adv), jnp.asarray(mask), delta=delta)
        got = tgrpo.off_policy_seq_mask(kl, T(adv), T(mask), delta=delta)
        assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("variant", ["grpo", "dapo", "dr_grpo", "sapo", "gspo"])
def test_grpo_loss_variants_match_jax(variant):
    rng = np.random.default_rng(10)
    b, s = 4, 6
    ratio = np.exp(rng.normal(size=(b,) if variant == "gspo" else (b, s)) * 0.3).astype(np.float32)
    adv = rng.normal(size=b).astype(np.float32)
    mask = rng.random((b, s)) > 0.2
    kl = np.abs(rng.normal(size=(b, s))).astype(np.float32) * 0.1
    opm = np.asarray([[True], [False], [True], [True]])
    for off in (None, opm):
        ref = jgrpo.GRPOLoss.compute(jnp.asarray(ratio), jnp.asarray(adv), jnp.asarray(mask), 0.2, 0.28, 0.04,
                                     jnp.asarray(kl), 2, max_gen=s, variant=variant,
                                     off_policy_mask=None if off is None else jnp.asarray(off))
        got = tgrpo.GRPOLoss.compute(T(ratio), T(adv), T(mask), 0.2, 0.28, 0.04, T(kl), 2, max_gen=s,
                                     variant=variant, off_policy_mask=None if off is None else T(off))
        assert rel(got, ref) <= 1e-6


# ------------------------------------------------------- GRPO: the update step


def injected_experience(jpol, cfg):
    """A scored experience with holed key masks: 2 prompts (6 and 3 real
    tokens, right-padded with the EoS/pad id) × 2 samples, 12 generated
    columns with a first EoS in rows 0 and 3; old log-probs the policy's
    own plus noise (rows 0 and 2 far off, so OPSM drops one), reference
    log-probs further off; advantages from the rewards' z-scores."""
    rng = np.random.default_rng(11)
    coll = jgrpo.prompt_collator([rng.integers(0, 126, 6).tolist(), rng.integers(0, 126, 3).tolist()], EOS)
    prompts = np.repeat(coll["padded_prompts"], NUM_SAMPLES, 0)
    masks = np.repeat(coll["prompt_masks"], NUM_SAMPLES, 0)
    gen = rng.integers(0, 126, (4, G)).astype(np.int32)
    gen[0, 4], gen[3, 8] = EOS, EOS
    responses = np.concatenate([prompts, gen], 1)
    c = jgrpo.batched_responses_collator(jnp.asarray(responses), jnp.asarray(masks), eos_ids=EOS, pad_token_id=EOS)
    logits, _, _ = jg.apply(jpol, cfg, jnp.asarray(responses), attn_mask=c["attn_masks"])
    lp = np.asarray(jgrpo.log_probs_per_token(logits, jnp.asarray(responses)))
    scale = np.asarray([1.5, 0.2, 1.5, 0.2], np.float32)[:, None]
    old = (lp + rng.normal(size=lp.shape) * scale).astype(np.float32)
    ref = (old + rng.normal(size=lp.shape) * 0.3).astype(np.float32)
    adv = np.asarray(jgrpo.z_scores(jnp.asarray([1.0, 3.0, -2.0, 0.5]), NUM_SAMPLES))
    return {"responses": responses.astype(np.int32), "attn_masks": np.asarray(c["attn_masks"]),
            "reward_masks": np.asarray(c["reward_masks"]), "advantages": adv, "old_logprobs": old,
            "ref_logprobs": ref}


UPDATE_CASES = {
    "grpo": {}, "dapo": {"variant": "dapo", "max_clip": 0.28}, "dr_grpo": {"variant": "dr_grpo"},
    "sapo": {"variant": "sapo"}, "gspo": {"variant": "gspo"}, "opsm": {"opsm_delta": 0.5},
    "unbiased_kl": {"unbiased_kl": True}, "flash": {},
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_grpo_update_step_matches_jax(jmodels, tmodels, case):
    """Loss and every gradient against JAX's, then the policy after 2
    updates. ``flash``: JAX's K4 in interpret mode (forward and custom VJP)
    and the port's plain K4 on the holed key mask."""
    cfg = FLASH if case == "flash" else TINY
    kw = dict(UPDATE_CASES[case], num_samples=NUM_SAMPLES, max_gen=G)
    jpol, pol = jmodels[0], tmodels[0]
    exp = injected_experience(jpol, cfg)
    texp = tengine.as_tensors(exp, "cpu")
    jexp = jnp_batch(exp)
    if case == "opsm":  # the mask drops a sequence
        m = tgrpo.off_policy_seq_mask(tgrpo.kl_div_per_token(texp["old_logprobs"], tgrpo.log_probs_per_token(
            tg.apply(pol, cfg, texp["responses"], attn_mask=texp["attn_masks"])[0], texp["responses"])),
            texp["advantages"], texp["reward_masks"][:, 1:], delta=0.5)
        assert not m.all() and m.any()
    loss, kl = tgrpo.grpo_loss(tg, cfg, pol, texp, **kw)
    grads = grads_of(loss, pol)
    jupdate = jgrpo.make_grpo_update_step(jg, cfg, capturing(optax.adamw(LR)), **kw)
    tupdate = tgrpo.make_grpo_update_step(tg, cfg, tengine.adamw(LR), **kw)
    jp, jstate, tstate = jpol, capturing(optax.adamw(LR)).init(jpol), tengine.adamw(LR).init(pol)
    for i in range(2):
        jp, jstate, jm = jupdate(jp, jstate, jexp)
        if i == 0:
            assert rel(loss, jm["loss"]) <= 1e-5 and rel(kl, jm["kl"]) <= 1e-5
            assert_grads(pol, grads, jstate[0])
        pol, tstate, tm = tupdate(pol, tstate, texp)
        assert close(tm["loss"], jm["loss"]) and close(tm["kl"], jm["kl"]), i
    assert_params(pol, jp)


# ------------------------------------------------------- GRPO: experience and loops


def test_grpo_experience_at_temperature_0_matches_jax(jmodels, tmodels):
    """Greedy sampling of 2 prompts × 2 (one right-padded, so its key mask
    has holes), scored by both models and the reward model, the phantom
    reward making the advantages nonzero: sequences and masks equal,
    log-probs, rewards and advantages within 1e-5."""
    jpol, jref, jrm = jmodels
    pol, ref_model, rm = tmodels
    batch = tgrpo.prompt_collator([[5, 9, 2, 17, 33], [11, 3]], EOS)
    probe = tgrpo.grpo_experience(tg, TINY, pol, ref_model, batch, lambda r, m, a: torch.zeros(r.shape[0]),
                                  num_samples=2, max_gen=8, temp=0.0, eos_id=EOS, pad_id=EOS)
    eos = int(probe["responses"][0, 7])  # a token row 0 samples: its first EoS cuts it
    batch = tgrpo.prompt_collator([[5, 9, 2, 17, 33], [11, 3]], eos)

    def jreward(r, m, a):
        return jgrpo.reward_model_apply(jrm, TINY, r, attn_mask=a, reward_mask=m)

    def treward(r, m, a):
        return tgrpo.reward_model_apply(rm, TINY, r, attn_mask=a, reward_mask=m)

    kw = dict(num_samples=2, max_gen=8, temp=0.0, eos_id=eos, pad_id=eos, use_phantom_reward=True)
    ref = jgrpo.grpo_experience(jg, TINY, jpol, jref, batch, jreward, **kw)
    got = tgrpo.grpo_experience(tg, TINY, pol, ref_model, batch, treward, **kw)
    for k in ("responses", "attn_masks", "reward_masks"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    assert not got["attn_masks"][0, 8:].all() and not got["attn_masks"][2, 2:5].any()  # the cut and the holes
    for k in ("old_logprobs", "ref_logprobs", "rewards", "advantages"):
        assert rel(got[k], ref[k]) <= 1e-5, k
    assert float(got["advantages"].abs().max()) > 0.1


def test_rlhf_loop_and_grpo_evaluate_compose_the_held_steps(tmodels):
    """``rlhf_grpo_training_loop`` (one batch, 2 updates) and
    ``grpo_evaluate`` at temperature 0 equal the composition of
    ``grpo_experience`` and ``make_grpo_update_step``, which the tests
    above hold to JAX: the same policy, bit for bit, and the same metrics."""
    pol, ref_model, rm = tmodels
    twin = copy.deepcopy(pol)
    batches = [tgrpo.prompt_collator([[5, 9, 2, 17], [11, 3, 60]], EOS)]
    kw = dict(num_samples=2, max_gen=6, temp=0.0, eos_id=EOS, pad_id=EOS)

    def reward(r, m, a):
        return tgrpo.reward_model_apply(rm, TINY, r, attn_mask=a, reward_mask=m)

    pol, metrics = tgrpo.rlhf_grpo_training_loop(tg, TINY, pol, ref_model, rm, TINY, batches, lr=LR,
                                                 log=lambda _: None, **kw)
    exp = tgrpo.grpo_experience(tg, TINY, twin, ref_model, batches[0], reward, **kw)
    update = tgrpo.make_grpo_update_step(tg, TINY, tengine.adamw(LR), max_gen=6)
    state = tengine.adamw(LR).init(twin)
    for _ in range(2):
        twin, state, m = update(twin, state, exp)
    assert metrics == [{"loss": float(m["loss"]), "kl": float(m["kl"]), "reward": float(exp["rewards"].mean())}]
    assert all(torch.equal(a, b) for a, b in zip(pol.parameters(), twin.parameters()))
    got = tgrpo.grpo_evaluate(tg, TINY, pol, ref_model, batches, reward, **kw)
    exp = tgrpo.grpo_experience(tg, TINY, pol, ref_model, batches[0], reward, **kw)
    kl = tgrpo.kl_div_per_token(exp["old_logprobs"], exp["ref_logprobs"])
    mask = exp["reward_masks"][:, 1:].float()
    assert got == (float(exp["rewards"].mean()), float((kl * mask).sum() / mask.sum()))


# ------------------------------------------------------------------ RLVR and RPT


def test_rewards_match_jax_on_crafted_strings():
    tok = CharTokenizer()
    calc, jcalc = trlvr.VerifiableRewardCalculator(tok, pad_token_id=0), jrlvr.VerifiableRewardCalculator(
        tok, pad_token_id=0)
    strings = ["<think>some reasoning</think><answer>42</answer>", "<think>r</think><answer> 1,000.00 </answer>",
               "<think>r</think><answer>41</answer>", "no tags at all", "<think>r</think><answer>x</answer>"]
    width = max(len(s) for s in strings)
    ids = np.zeros((len(strings), width), np.int32)
    for i, s in enumerate(strings):
        ids[i, : len(s)] = tok.encode(s)
    answers = ["42", "1000", "42", "42", "1"]
    assert calc(T(ids), answers).tolist() == np.asarray(jcalc(jnp.asarray(ids), answers)).tolist() == [
        10.0, 10.0, 0.0, -1.0, -1.0]  # no number in the last answer: unfinished
    pm, jpm = trpt.PrefixMatchingReward(tok, pad_token_id=0), jrpt.PrefixMatchingReward(tok, pad_token_id=0)
    answers = ["time", " time", " time and", " tim", "x"]
    rows = [f"<think>x</think><answer>{a}</answer>" for a in answers] + ["no tags"]
    ids = np.zeros((len(rows), max(len(r) for r in rows)), np.int32)
    for i, s in enumerate(rows):
        ids[i, : len(s)] = tok.encode(s)
    labels = [" time and time again"] * len(rows)
    got, ref = pm(T(ids), labels), jpm(jnp.asarray(ids), labels)
    assert got.tolist() == np.asarray(ref).tolist() and got.tolist()[-1] == -10.0
    batch = [{"prompt": [1, 2, 3], "answer": "7"}, {"prompt": [4], "labels": " x"}]
    ref, got = jrlvr.rlvr_prompt_collator(batch, 0), trlvr.rlvr_prompt_collator(batch, 0)
    assert got["answers"] == ref["answers"] == ["7", " x"]
    assert all(np.array_equal(got[k], ref[k]) for k in ("padded_prompts", "prompt_masks", "last_real_pos"))


def rpt_batch(tok):
    entries = [{"question": "Tom has 3 apples and buys 4.", "answer": "He has 3 + 4 = 7.\n#### 7"}]
    kw = dict(labels_length=4, instruction="Next:")
    _, allowed, getter = tdata.rpt_structured_dataset(entries, tok, 24, **kw)
    _, jallowed, jgetter = jdata.rpt_structured_dataset(entries, tok, 24, **kw)
    assert allowed == jallowed and all(getter(i) == jgetter(i) for i in (0, 17, len(allowed) - 1))
    return trlvr.rlvr_prompt_collator([getter(i) for i in (10, 30)], 0)


@pytest.mark.parametrize("kind", ["rlvr", "rpt"])
def test_rlvr_and_rpt_loop_iteration_matches_jax(jmodels, tmodels, kind):
    """One batch of ``rlvr_grpo_training_loop`` at temperature 0 (2 updates,
    warm-up and cosine decay, OPSM, the phantom reward) with the verifier
    (RLVR) or the prefix-matching reward over RPT pairs, against JAX's."""
    jpol, jref, _ = jmodels
    pol, ref_model, _ = tmodels
    tok = CharTokenizer()
    if kind == "rlvr":
        batch = trlvr.rlvr_prompt_collator([{"prompt": tok.encode("Q: 2+3?"), "answer": "5"},
                                            {"prompt": tok.encode("Q: 10-4?"), "answer": "6"}], 0)
        calc, jcalc = (trlvr.VerifiableRewardCalculator(tok, pad_token_id=0),
                       jrlvr.VerifiableRewardCalculator(tok, pad_token_id=0))
    else:
        batch = rpt_batch(tok)
        calc, jcalc = trpt.PrefixMatchingReward(tok, pad_token_id=0), jrpt.PrefixMatchingReward(tok, pad_token_id=0)
    kw = dict(num_samples=2, max_gen=8, temp=0.0, eos_id=0, pad_id=0, peak_lr=1e-3, warmup_steps=1, min_lr=1e-5,
              decay="cosine", opsm_delta=0.5, use_phantom_reward=True, log=lambda _: None)
    jp, jmetrics = jrlvr.rlvr_grpo_training_loop(jg, TINY, jpol, jref, [batch], jcalc, **kw)
    pol, metrics = trlvr.rlvr_grpo_training_loop(tg, TINY, pol, ref_model, [batch], calc, **kw)
    for key in ("loss", "kl", "reward"):
        assert close(metrics[0][key], jmetrics[0][key]), key
    assert_params(pol, jp)
