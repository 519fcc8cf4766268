"""The ported engine's multimodal requests against the JAX engine, on the
CPU in fp32, at ``tests/test_serving.py``'s tiny VLM (``VLM_CFG``: 2 vision
blocks, 4 text layers, 64 px images of 4 merged vision tokens).

- per-request images beside a text-only request in one pool, after
  ``warmup(image_shape=)``; a text prefix with image-bearing suffixes (the
  MRoPE positions shifted by the prefix length); uint8 images through an
  on-device ``pixel_transform``: the greedy tokens equal JAX's, and the
  first multimodal wave's logits and cache rows lie within 1e-4 of JAX's;
- ``warmup(image_shape=)`` with requests live restores the pool, the slot
  map, the sampler rows, the wave count and the generator;
- at most ``n_slots`` queued images are on the device at once;
- a prefix holding image placeholders is refused.

Each engine runs once a side per module (``runs``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_quest_tpu.inference.serving import ContinuousBatchingEngine as JaxEngine
from llm_quest_tpu.models import qwen3_5 as jq
from llm_quest_tpu.weights.interop import flatten_params
from llm_quest_tpu_torch.inference.serving import ContinuousBatchingEngine, _clone
from llm_quest_tpu_torch.models import qwen3_5 as tq
from llm_quest_tpu_torch.ops import lora as tl
from llm_quest_tpu_torch.weights.interop import from_jax_flat

TOL = 1e-4

# tests/test_serving.py's VLM_CFG
VLM_CFG = {
    "vocab_size": 512, "emb_dim": 64, "hidden_dim": 128, "n_layers": 4, "linear_sdpa_ratio": 2,
    "n_heads": 4, "num_kv_groups": 2, "head_dim": 16, "rope_base": 10_000_000,
    "partial_rope_factor": 0.25, "context_length": 128, "linear_num_qk_heads": 2,
    "linear_num_value_heads": 4, "linear_qk_head_dim": 8, "linear_value_head_dim": 8,
    "linear_conv_kernel_size": 4, "tie_embeddings": True, "mrope_section": [1, 1, 0],
    "vision_n_layers": 2, "vision_emb_dim": 32, "vision_hidden_dim": 64, "vision_num_heads": 2,
    "llm_d_in": 64, "in_channels": 3, "patch_size": 16, "spatial_merge_size": 2,
    "temporal_patch_size": 2, "num_position_embeddings": 256, "img_width": 64, "img_height": 64,
    "vision_rope_base": 10_000, "image_token_id": 500, "p_dropout": 0.0,
}
ENGINE = dict(n_slots=2, max_len=48, decode_chunk=3, prefill_buckets=(16,), temp=0.0, eos_ids=-1, pad_id=0)
N_VIS = (64 // 16) ** 2 // 2**2  # 4 merged vision tokens
IMAGE = VLM_CFG["image_token_id"]
SHAPE = (3, 2, 64, 64)


class JaxVLM:
    apply = staticmethod(jq.apply)
    init_cache = staticmethod(jq.init_cache)


def jax_transform(px):
    return (px.astype(jnp.float32) - 127.5) / 58.0


def port_transform(px):
    return (px.to(torch.float32) - 127.5) / 58.0


@pytest.fixture(scope="module")
def models():
    params = jq.init(jax.random.PRNGKey(0), dict(VLM_CFG, dtype=jnp.float32))
    flat = {k: np.asarray(v) for k, v in flatten_params(params).items()}
    return params, from_jax_flat(flat, dict(VLM_CFG, dtype=torch.float32), device="cpu")


def engine(side, models, **kw):
    if side == "jax":
        return JaxEngine(JaxVLM, models[0], dict(VLM_CFG, dtype=jnp.float32), **{**ENGINE, **kw})
    return ContinuousBatchingEngine(tq, models[1], dict(VLM_CFG, dtype=torch.float32), device="cpu",
                                    **{**ENGINE, **kw})


_rng = np.random.default_rng(12)


def mm_prompt(head, tail, rng=_rng):
    return rng.integers(1, 500, size=head).tolist() + [IMAGE] * N_VIS + rng.integers(1, 500, size=tail).tolist()


PROMPTS = [mm_prompt(2, 3), mm_prompt(4, 1)]
IMAGES = [_rng.standard_normal(SHAPE).astype(np.float32) for _ in PROMPTS]
TEXT_ONLY = _rng.integers(1, 500, size=5).tolist()
_rng = np.random.default_rng(14)
SYSPROMPT = _rng.integers(1, 500, size=9).tolist()
SUFFIXES = [_rng.integers(1, 500, size=2).tolist() + [IMAGE] * N_VIS + _rng.integers(1, 500, size=2).tolist()
            for _ in range(2)]
PREFIX_IMAGES = [_rng.standard_normal(SHAPE).astype(np.float32) for _ in SUFFIXES]
_rng = np.random.default_rng(3)
U8_PROMPTS = [[5, 6] + [IMAGE] * N_VIS + [7], [9] + [IMAGE] * N_VIS + [3, 4, 8]]
U8_IMAGES = [_rng.integers(0, 256, size=SHAPE, dtype=np.uint8) for _ in U8_PROMPTS]


def jax_admit_pending(eng):
    """The admission part of the JAX engine's ``step`` for these traffics
    (multimodal waves by (shape, prefix), plain text), without its decode
    chunk."""
    free = [s for s in range(eng.n_slots) if eng._slot_req[s] is None]
    take = [eng._queue.popleft() for _ in range(min(len(free), len(eng._queue)))]
    groups = {}
    for r in take:
        key = ("vlm", r.pixels.shape, r.prefix) if r.pixels is not None else r.prefix
        groups.setdefault(key, []).append(r)
    for key, reqs in groups.items():
        slots, free = free[: len(reqs)], free[len(reqs):]
        if isinstance(key, tuple):
            eng._admit_group_vlm(reqs, slots)
        elif key is None:
            eng._admit_group(reqs, slots)
        else:
            eng._admit_group_prefix(key, reqs, slots)


def serve(side, eng, submits, warm=False):
    """Submit ``submits`` (ids, max_gen, submit kwargs), admit and read the
    first wave, step to the end: (tokens a request, the first wave's
    last-token logits and cache rows)."""
    if warm:
        eng.warmup(image_shape=SHAPE)
    rids = [eng.submit(ids, gen, **kw) for ids, gen, kw in submits]
    if side == "jax":
        jax_admit_pending(eng)
    else:
        eng._admit_pending()
    rows = [s for s in range(eng.n_slots) if eng._slot_req[s] is not None]
    st = eng.state
    snap = {"logits": np.asarray(st["last_logits"])[rows], "seqpos": np.asarray(st["seqpos"])[rows]}
    for name, leaf in st["cache"].items():
        leaf = np.asarray(leaf)
        snap[f"cache/{name}"] = leaf[rows] if leaf.ndim == 1 else leaf[:, rows]
    while eng.step():
        pass
    return [eng._requests[r].tokens for r in rids], snap


def run_all(side, models):
    out = {}
    out["images"] = serve(side, engine(side, models), [(p, 6, {"pixels": im}) for p, im in zip(PROMPTS, IMAGES)]
                          + [(TEXT_ONLY, 6, {})], warm=True)
    eng = engine(side, models)
    pid = eng.register_prefix(SYSPROMPT)
    out["prefix_images"] = serve(side, eng, [(s, 6, {"prefix": pid, "pixels": im})
                                             for s, im in zip(SUFFIXES, PREFIX_IMAGES)])
    transform = jax_transform if side == "jax" else port_transform
    out["uint8"] = serve(side, engine(side, models, pixel_transform=transform),
                         [(p, 6, {"pixels": im}) for p, im in zip(U8_PROMPTS, U8_IMAGES)])
    return out


@pytest.fixture(scope="module")
def jax_runs(models):
    return run_all("jax", models)


@pytest.fixture(scope="module")
def port_runs(models):
    return run_all("port", models)


CASES = ["images", "prefix_images", "uint8"]


@pytest.mark.parametrize("case", CASES)
def test_tokens_equal_jax(jax_runs, port_runs, case):
    """Greedy tokens, request by request, equal the JAX engine's, each
    request its budget long."""
    got = port_runs[case][0]
    assert got == jax_runs[case][0]
    assert all(len(t) == 6 for t in got)


@pytest.mark.parametrize("case", CASES)
def test_first_wave_matches_jax(jax_runs, port_runs, case):
    """The first multimodal wave's logits and cache rows within 1e-4 of
    JAX's; its column pointers (the text lengths, past the prefix) and its
    decode positions (the largest 3-D position + 1) equal."""
    got, ref = port_runs[case][1], jax_runs[case][1]
    assert set(got) == set(ref)
    for name in got:
        if name in ("seqpos", "cache/pos"):
            assert got[name].tolist() == ref[name].tolist(), name
        else:
            np.testing.assert_allclose(got[name], ref[name], atol=TOL, rtol=0, err_msg=name)
    assert (got["seqpos"] < got["cache/pos"]).all()  # the image grid counts fewer positions than tokens


def test_uint8_transform_equals_float_pixels(models, port_runs):
    """uint8 pixels through the on-device transform give the tokens of the
    same images transformed on the host and served as fp32."""
    floats = [np.asarray(port_transform(torch.from_numpy(im))) for im in U8_IMAGES]
    got, _ = serve("port", engine("port", models), [(p, 6, {"pixels": im}) for p, im in zip(U8_PROMPTS, floats)])
    assert got == port_runs["uint8"][0]


def test_warmup_with_images_restores_live_state(models):
    """``warmup(image_shape=)`` while requests are live (per-request
    sampling, one stochastic row) leaves the pool, the slot map, the request
    table, the sampler rows, the wave count and the generator as they were,
    and the tokens equal those of the same schedule without it."""
    def run(warm):
        eng = engine("port", models, per_request_sampling=True, generator=torch.Generator().manual_seed(5))
        eng.submit(PROMPTS[0], 7, pixels=IMAGES[0], temp=0.9, top_k=20)
        eng.submit(TEXT_ONLY, 8)
        eng.step()
        if warm:
            before = (_clone(eng.state), list(eng._slot_req), dict(eng._requests), eng._slot_sample.copy(),
                      eng._sample_dev.clone(), eng._n_waves, eng.generator.get_state())
            eng.warmup(image_shape=SHAPE, image_dtype=np.float32)
            state, slot_req, requests, sample, sample_dev, waves, gen = before
            for name in ("mask_buf", "last_logits", "seqpos", "finished", "budget"):
                assert torch.equal(eng.state[name], state[name]), name
            for name, leaf in state["cache"].items():
                assert torch.equal(eng.state["cache"][name], leaf), name
            assert eng._slot_req == slot_req and eng._requests == requests
            assert np.array_equal(eng._slot_sample, sample) and torch.equal(eng._sample_dev, sample_dev)
            assert eng._n_waves == waves and torch.equal(eng.generator.get_state(), gen)
        while eng.step():
            pass
        return [r.tokens for r in eng._requests.values()]

    assert run(True) == run(False)


def test_queued_images_on_device_bounded(models):
    """With 3·n_slots image requests queued, at most n_slots of them hold a
    device copy at any time, the oldest first; an admitted image leaves the
    device with its wave; every request is served its budget."""
    eng = engine("port", models)
    rng = np.random.default_rng(21)
    for i in range(3 * eng.n_slots):
        eng.submit(PROMPTS[i % 2], 3 + i % 3, pixels=rng.standard_normal(SHAPE).astype(np.float32))
        on_device = [r.pixels_dev is not None for r in eng._queue]
        assert sum(on_device) == min(len(eng._queue), eng.n_slots)
        assert on_device == sorted(on_device, reverse=True)  # the oldest hold them
    while eng.step():
        on_device = [r.pixels_dev is not None for r in eng._queue]
        assert sum(on_device) == min(len(eng._queue), eng.n_slots)
        assert all(r.pixels_dev is None for r in eng._requests.values() if r not in eng._queue)
    assert [len(r.tokens) for r in eng._requests.values()] == [3 + i % 3 for i in range(3 * eng.n_slots)]


def test_prefix_with_image_placeholders_refused(models):
    eng = engine("port", models)
    with pytest.raises(ValueError, match="pure text"):
        eng.register_prefix([1, IMAGE, 2])


def test_multimodal_adapter_refusals_match_jax(models):
    """An image request naming an adapter is refused by params without
    stacked adapters, and with stacked adapters a prefix + image request is
    (JAX's two ValueErrors); an image request with an adapter is served
    (its tokens: test_torch_serving_lora.py)."""
    with pytest.raises(ValueError, match="no stacked adapters"):
        engine("port", models).submit(PROMPTS[0], 4, pixels=IMAGES[0], adapter=0)
    model = tl.stack_adapters([tl.replace_with_lora(torch.Generator().manual_seed(0), copy.deepcopy(models[1]), 4, 8,
                                                    path_filter=lambda p: "/text/" in p and "att" in p)])
    eng = ContinuousBatchingEngine(tq, model, dict(VLM_CFG, dtype=torch.float32), device="cpu", **ENGINE)
    pid = eng.register_prefix(SYSPROMPT)
    with pytest.raises(ValueError, match="prefix\\+multimodal"):
        eng.submit(SUFFIXES[0], 4, prefix=pid, pixels=PREFIX_IMAGES[0])
    eng.submit(PROMPTS[0], 4, pixels=IMAGES[0], adapter=0)
