"""Continuous-batching serving engine (counterpart of
``llm_quest_tpu/inference/serving.py``): its single-device paths.

A fixed pool of ``n_slots`` slots, each one in-flight sequence: the model's
ordinary static cache allocated for ``n_slots`` rows, with the column pointer
``cache["pos"]`` a per-row (n_slots,) tensor. Finished slots retire and are
refilled while the others keep decoding (iteration-level scheduling).

- **Admit**: a wave of k queued prompts, right-padded to the wave's largest
  prompt bucket, is prefilled as a b = k batch on a fresh cache; its rows
  (cache rows, mask row, last-token logits, counters) are then copied into
  the pool at the free slots. The column pointer of a row is its REAL
  prompt length, so decode overwrites the masked bucket-pad columns and the
  cache columns stay contiguous with the tokens. A wave is one of four
  kinds (``step`` groups a take by kind, in FIFO order):
  - plain: one prefill at the wave's bucket;
  - chunked (``prefill_chunk``): prompts longer than the largest bucket pad
    to a multiple of the chunk and prefill through sequential chunk-sized
    calls on one group cache with the full (k, max_len) mask; each row's
    last-token logits come from the chunk that holds its last real token.
    The hybrid's GDN layers carry their recurrent state and conv taps from
    chunk to chunk through the cache, and the attention layers run at the
    static query offset c·chunk against the max_len view;
  - prefix (``register_prefix``, ``submit(prefix=)``): a shared prefix is
    prefilled once into a b = 1 row; a wave copies that row into k rows
    and prefills only the suffixes at query offset ``plen``;
  - multimodal (``submit(pixels=)``): each row carries its own image, kept
    on the device since ``submit``; the wave stacks them, applies
    ``pixel_transform`` on the device, and prefills with host-computed 3-D
    MRoPE positions (shifted by ``plen`` under a text prefix). Decode
    continues from the largest 3-D position + 1, not the text length.
- **Decode chunk**: up to ``decode_chunk`` single-token steps over all
  slots. Per-row finished flags and generation budgets live on the device:
  a row that draws an EOS or spends its budget is finished there, emits
  ``pad_id`` from then on and stops growing its mask. The chunk ends early
  once every slot is finished. Its tokens (with the bitcast logprobs when
  asked for) and the finished column reach the host in ONE copy a chunk,
  into pinned memory behind an event, so with ``pipeline_depth`` 2 the
  host can dispatch the next chunk before reading it.
- **Retire/refill** on the host: read a chunk, credit its tokens to the
  requests resident at its dispatch, close those that finished, admit
  queued prompts into the freed slots.

A model serves through the engine when it exposes ``apply(params, cfg, ids,
attn_mask=, cache=, position_ids=)`` and ``init_cache(cfg, b, max_len,
dtype=, device=)`` with layer-stacked cache leaves (layers, batch, ...):
``models.qwen3`` (dense and MoE, e.g. Qwen3-30B-A3B), ``models.qwen3_next``,
``models.qwen3_5.TextOnly`` and, for multimodal requests, ``models.qwen3_5``
itself (its ``apply`` takes ``image_pixels``), ``models.gemma3``,
``models.deepseek_v3`` and ``models.mimo_v2_flash``, int8 checkpoints
(linears and expert stacks) and the int8 KV cache included. An int8 MoE
decode step makes no host sync: the expert group sizes stay on the device
(``ops/moe.py``); a bf16 MoE reads them on the host once a layer.

The early exit reads the pool's "all finished" flag one step late: after
each step the flag is copied to pinned memory without blocking, and the
host waits for the flag of the step before the one it has just queued. So
the host never waits for the step the device is running, and a chunk runs
exactly one step past the first all-finished step. That step draws only
pads (finished rows keep their pad and their budget), so the tokens are
those of an exact exit; it moves only the finished rows' scratch state and
the generator. A blocking read each step would leave the device idle while
the host queues the next step's kernels.

Divergences by design from the JAX engine:
- no compile cache (``_SERVE_JIT_CACHE``, ``_freeze``): eager PyTorch has
  no programs to bound;
- a wave is admitted at its own size k; JAX pads it to a power of two (by
  repeating its last request) only to bound its compile count. So the
  multimodal warmup has no wave sizes to cover (JAX's warms the powers of
  two up to ``n_slots`` only, so with ``n_slots`` not a power of two the
  size that the larger waves pad to is never warmed);
- the pool state is a dict of tensors updated in place, and rows move by
  index copies and advanced-index writes (JAX: positional selects, since
  per-row scatters serialize on a TPU). A prefix wave's group cache is a
  materialised copy of the stored row (JAX broadcasts it): the prefill
  writes its cache in place, and the stored row must not change;
- a finished row's column pointer and position stop advancing (JAX lets
  them run on and relies on its gathers clamping out-of-range indices; an
  index write here must stay in range). Only finished rows see this: their
  state is scratch until an admission overwrites the whole row. For the
  same reason ``max_len`` may not exceed the RoPE tables' ``context_length``
  (JAX clamps the positions past it);
- ``generator=`` (a ``torch.Generator`` on the engine's device) takes the
  place of ``rng``; draws are the port's (``ops/sampling.py::draw``);
- ``warmup`` admits one wave of 1 and one of ``n_slots`` rows per bucket
  (text, and with ``image_shape`` multimodal) and runs one chunk, where JAX
  warms every power-of-two wave size it could compile and runs a second
  chunk to time. It restores everything the scratch admissions touched: the
  pool, the slot map, the request table, the per-slot sampler rows, the
  wave count and the generator (JAX's multimodal warmup leaves the wave
  count and the sampler rows changed);
- ``submit`` keeps at most ``n_slots`` queued images on the device: an
  image uploads (from pinned memory, without blocking) at ``submit`` while
  fewer are there, else when the queue ahead of it drains to that depth
  (JAX uploads every queued image at ``submit``, without a bound); an
  admitted image leaves the device with its wave;
- ``pipeline_depth`` defaults to 1 and "auto" means 1, with no timing (JAX
  times a chunk against a round trip and takes 2 when the chunk is
  shorter). A decode step here already waits on the early-exit flag of the
  step before it, so a second chunk in flight overlaps only the drain's
  host work, and it refills freed slots a chunk later: on an H100 depth 2
  served no faster than depth 1 (``chip_smoke.py``, engine_serve_uniform).

Not ported yet (ROADMAP.md, Queue 1 item 3): multi-LoRA
(``submit(adapter=)``, ``register_prefix(adapter=)``; the port has no
stacked adapters yet), speculative windows (``draft_*``, ``gamma``) and the
mesh / expert-parallel engine (``mesh``, ``param_rules``,
``cfg["expert_parallel"]``); each raises ``NotImplementedError``.
"""

import statistics
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from llm_quest_tpu_torch.config import resolve_device
from llm_quest_tpu_torch.inference.generate import _is_eos, _normalize_eos
from llm_quest_tpu_torch.ops.sampling import sampling, sampling_per_row

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)
LATER = "belongs to a later slice of the serving port (ROADMAP.md, Queue 1 item 3)"


def _insert_rows(big, small, slots):
    """Copy the k rows of a group-cache leaf into the pool leaf at the row
    indices ``slots`` (k,), in place. The batch axis is found by position:
    axis 1 of a layer-stacked cache leaf, axis 0 of the (n_slots,) ``pos``
    (JAX looks for the axis by its size, which a layer count equal to the
    slot count would fool)."""
    big.index_copy_(1 if big.ndim >= 2 else 0, slots, small.to(big.dtype))


def _clone(tree):
    if isinstance(tree, dict):
        return {key: _clone(val) for key, val in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def _repeat_row(cache, k):
    """A b = k group cache whose rows are copies of the b = 1 ``cache``'s
    (batch on axis 1 of every layer-stacked leaf). Copies, never a
    broadcast view: the prefill writes the group cache in place, and the
    stored row must not change (K1 also needs its state contiguous)."""
    return {name: leaf.repeat(1, k, *(1,) * (leaf.ndim - 2)) if torch.is_tensor(leaf) else leaf
            for name, leaf in cache.items()}


@dataclass
class _Request:
    rid: int
    ids: np.ndarray  # (prompt_len,) int
    max_gen: int
    tokens: list = field(default_factory=list)
    logprobs: list = field(default_factory=list)  # per committed token (when enabled)
    done: bool = False
    prefix: int | None = None  # registered prefix id (register_prefix); ids is then the suffix
    pixels: np.ndarray | None = None  # multimodal: the prompt's image, on the host
    pixels_dev: torch.Tensor | None = None  # its copy on the device while queued (submit's bound)
    sample: np.ndarray | None = None  # per-request [temp, top_k, top_p, min_p] override
    # host timestamps (time.monotonic): queued / admitted to a slot / first
    # token credited / retired
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class ContinuousBatchingEngine:
    """Iteration-level scheduler over a fixed slot pool (module docstring).

    Args:
        model: object with ``apply`` / ``init_cache`` (the module
            docstring lists the models).
        params: the model's weights, on ``device``.
        n_slots: concurrent sequences resident on the device.
        max_len: cache columns a slot (a prompt's bucket + its max_gen must fit).
        decode_chunk: decode steps between two scheduler interventions.
        prefill_buckets: a prompt is right-padded to the smallest bucket that
            holds it (they decide routing: a 256-token bucket takes the flash
            kernel at the attention layers' prefill).
        prefill_chunk: a prompt longer than the largest bucket pads to a
            multiple of this and admits through sequential prefills of this
            many columns (None: such a prompt is refused).
        pixel_transform: applied on the device to a multimodal wave's stacked
            pixels before the encode (e.g. uint8 -> normalized bf16, so the
            upload carries a quarter of the fp32 bytes).
        top_k / top_p / min_p / temp: the engine-wide sampler (temp 0: greedy).
        eos_ids / pad_id: end-of-sequence ids (None: ``pad_id``) and the pad
            a finished row emits.
        cache_dtype: the pool cache's dtype (default the model's).
        generator: ``torch.Generator`` on ``device`` driving the draws
            (default one seeded with 0).
        pipeline_depth: decode chunks kept in flight (1; "auto" means 1:
            module docstring).
        per_request_sampling: ``submit`` may override the sampler per request.
        return_logprobs: keep the raw-model logprob of each committed token.
        device: where the pool lives (None: the current CUDA device; raises
            without one).
    """

    @torch.inference_mode()
    def __init__(
        self, model, params, cfg, *, n_slots, max_len, decode_chunk=8, prefill_buckets=DEFAULT_BUCKETS,
        top_k=None, top_p=None, min_p=None, temp=0.0, eos_ids=None, pad_id=0, cache_dtype=None, generator=None,
        pipeline_depth=1, per_request_sampling=False, return_logprobs=False, device=None, mesh=None,
        param_rules=None, draft_model=None, draft_params=None, draft_cfg=None, gamma=None, draft_param_rules=None,
        prefill_chunk=None, pixel_transform=None,
    ):
        later = [name for name, value in (
            ("mesh", mesh), ("param_rules", param_rules), ("draft_model", draft_model),
            ("draft_params", draft_params), ("draft_cfg", draft_cfg), ("gamma", gamma),
            ("draft_param_rules", draft_param_rules), ('cfg["expert_parallel"]', cfg.get("expert_parallel")),
        ) if value is not None]
        if later:
            raise NotImplementedError(f"ContinuousBatchingEngine: {', '.join(later)} {LATER}")
        if top_p is not None and min_p is not None:
            raise ValueError("Cannot use top_p and min_p together")
        if max_len > cfg.get("context_length", max_len):
            raise ValueError(f"max_len {max_len} exceeds the RoPE tables' context_length {cfg['context_length']}")
        self.device = resolve_device(device)
        self.model, self.params, self.cfg = model, params, cfg
        self.n_slots, self.max_len = n_slots, max_len
        self.decode_chunk = decode_chunk
        self.buckets = tuple(sorted(b for b in prefill_buckets if b <= max_len))
        self.prefill_chunk = prefill_chunk
        self._pixel_transform = pixel_transform
        self.sample_kw = dict(top_k=top_k, top_p=top_p, min_p=min_p, temp=temp)
        self._row_sampling = per_request_sampling
        self._logprobs = return_logprobs
        self._default_sample = np.asarray(
            [temp, top_k or 0, 2.0 if top_p is None else top_p, min_p or 0.0], np.float32,
        )
        self._slot_sample = np.tile(self._default_sample, (n_slots, 1))
        self._sample_dev = self._upload(self._slot_sample)
        self.eos_arr = torch.tensor(_normalize_eos(eos_ids, pad_id), device=self.device)
        self.pad_id = pad_id
        self.cache_dtype = cache_dtype
        self.generator = generator if generator is not None else torch.Generator(device=self.device).manual_seed(0)

        cache = model.init_cache(cfg, n_slots, max_len, dtype=cache_dtype, device=self.device)
        cache["pos"] = torch.zeros(n_slots, dtype=torch.long, device=self.device)  # per-row column pointer
        self.state = {
            "cache": cache,
            "mask_buf": torch.zeros(n_slots, max_len, dtype=torch.bool, device=self.device),
            "last_logits": torch.zeros(n_slots, cfg["vocab_size"], dtype=torch.float32, device=self.device),
            "seqpos": torch.zeros(n_slots, dtype=torch.long, device=self.device),  # RoPE position a row
            "finished": torch.ones(n_slots, dtype=torch.bool, device=self.device),  # empty slots are finished
            # the generation budget left a slot: the device finishes a row at
            # 0, so max_gen retirement (like EOS) needs no write from the host
            "budget": torch.zeros(n_slots, dtype=torch.long, device=self.device),
        }
        self._rows = torch.arange(n_slots, device=self.device)
        on_card = self.device.type == "cuda"
        # the early exit's flags: one a step (and one for the chunk's start)
        self._flags = torch.zeros(decode_chunk + 1, dtype=torch.bool, pin_memory=on_card)
        self._flag_events = [torch.cuda.Event() if on_card else None for _ in range(decode_chunk + 1)]

        self._queue = deque()
        self._slot_req = [None] * n_slots
        self._requests = {}
        self._prefixes = {}  # pid -> (the prefilled b = 1 cache row, the prefix's length)
        self._next_rid = 0
        # observability counters (stats()): admit waves, decode chunks, and
        # per-chunk live-slot occupancy for utilization
        self._n_waves = 0
        self._n_chunks = 0
        self._busy_slot_steps = 0
        # decode chunks in flight: the oldest drains while newer ones run.
        # Finished rows are sticky on the device and each in-flight chunk
        # keeps the slot -> request map of its dispatch, so late admissions
        # never take earlier tokens
        self.pipeline_depth = 1 if pipeline_depth in (None, "auto") else max(1, int(pipeline_depth))
        self._inflight = deque()  # (pinned packed chunk, its event, slot map)

    # ------------------------------------------------------------ device I/O

    def _upload(self, arr):
        """A host array on the device: from pinned memory without blocking on
        the card (a pageable copy would wait for the queued chunks)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _to_host(self, t):
        """(pinned host copy, event marking its arrival); the event is None
        on the CPU."""
        if self.device.type != "cuda":
            return t.clone(), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _flag(self, j, finished):
        """Copy ``finished.all()`` into the j-th early-exit flag."""
        self._flags[j : j + 1].copy_(finished.all()[None], non_blocking=True)
        if self._flag_events[j] is not None:
            self._flag_events[j].record()

    def _all_finished(self, j):
        if self._flag_events[j] is not None:
            self._flag_events[j].synchronize()
        return bool(self._flags[j])

    # ------------------------------------------------------------- the device

    def _admit_rows(self, prompts, pmasks, slots, budgets, *, chunk=None, prefix=None, pixels=None,
                    position_ids=None, next_pos=None):
        """Prefill a wave (k, lb) on a b = k group cache and copy its rows
        into the pool at ``slots`` (k,). ``chunk``: prefill through
        sequential calls of ``chunk`` columns (lb a multiple of it);
        ``prefix``: (stored b = 1 cache, plen), whose row seeds every group
        row, the wave holding the suffixes; ``pixels`` (k, ...) with
        ``position_ids`` (3, k, lb) and ``next_pos`` (k,): a multimodal
        wave and its 3-D MRoPE positions."""
        st = self.state
        k, lb = prompts.shape
        if prefix is None:
            plen = 0
            grp_cache = self.model.init_cache(self.cfg, k, self.max_len, dtype=self.cache_dtype, device=self.device)
        else:
            pcache, plen = prefix
            grp_cache = _repeat_row(pcache, k)
        grp_mask = torch.zeros(k, self.max_len, dtype=torch.bool, device=self.device)
        grp_mask[:, :plen] = True
        grp_mask[:, plen : plen + lb] = pmasks
        real_len = pmasks.sum(dim=1)
        rows = torch.arange(k, device=self.device)
        step = chunk or lb
        kw = {}
        if pixels is not None:
            if self._pixel_transform is not None:
                pixels = self._pixel_transform(pixels)
            kw["image_pixels"] = pixels
        logits = None
        for c0 in range(0, lb, step):
            # text positions are passed, not left to the model: the VLM's
            # ``apply`` would count them from 0 rather than from the cache
            pos = position_ids if pixels is not None else (
                (plen + c0 + torch.arange(step, device=self.device))[None].expand(k, step))
            out, grp_cache, _ = self.model.apply(
                self.params, self.cfg, prompts[:, c0 : c0 + step], attn_mask=grp_mask, cache=grp_cache,
                position_ids=pos, **kw,
            )
            # each row's last-token logits come from the call that holds its
            # last real token (the rows of a chunked wave end in different chunks)
            loc = real_len - 1 - c0
            picked = out[rows, loc.clamp(0, step - 1)].float()
            logits = picked if logits is None else torch.where(((loc >= 0) & (loc < step))[:, None], picked, logits)
        # the column pointer of a row is its REAL length: decode overwrites
        # the masked bucket-pad columns, so columns stay contiguous with tokens
        grp_cache["pos"] = plen + real_len
        for name, big in st["cache"].items():
            _insert_rows(big, grp_cache[name], slots)
        st["mask_buf"][slots] = grp_mask
        st["last_logits"][slots] = logits
        st["seqpos"][slots] = plen + real_len if next_pos is None else next_pos
        st["finished"][slots] = False
        st["budget"][slots] = budgets

    def _sample(self, logits):
        if self._row_sampling:
            row = self._sample_dev
            return sampling_per_row(
                self.generator, logits, temp=row[:, 0], top_k=row[:, 1].long(), top_p=row[:, 2], min_p=row[:, 3],
                max_top_k=int(self._slot_sample[:, 1].max()),
            )
        return sampling(self.generator, logits, checked=False, **self.sample_kw)

    def _decode_step(self, i, eos, toks, lps):
        """One token for every slot; finished rows emit pads and keep their
        column, position and budget."""
        st = self.state
        finished, last = st["finished"], st["last_logits"]
        # a finished row's logits may be anything (an empty slot's are
        # zeros): it draws from zeros, and its draw is replaced by the pad
        sampled = self._sample(torch.where(finished[:, None], 0.0, last))
        token = torch.where(finished, self.pad_id, sampled)
        if lps is not None:
            # the raw model logprob of the committed token (before the
            # temperature and the filters)
            lps[i] = torch.log_softmax(last, dim=-1).gather(1, token[:, None])[:, 0]
        budget = st["budget"] - (~finished).long()
        finished = finished | _is_eos(token, eos) | (budget <= 0)
        cache = st["cache"]
        col = cache["pos"]  # where this token's K/V land
        st["mask_buf"][self._rows, col] = ~finished
        logits, cache, _ = self.model.apply(
            self.params, self.cfg, token[:, None], attn_mask=st["mask_buf"], cache=cache,
            position_ids=st["seqpos"][:, None],
        )
        live = (~finished).long()
        cache["pos"] = col + live
        st.update(cache=cache, last_logits=logits[:, 0].float(), seqpos=st["seqpos"] + live, finished=finished,
                  budget=budget)
        toks[i] = token

    def _decode_chunk(self, eos):
        """Up to ``decode_chunk`` steps, ending one step after the pool is all
        finished (module docstring). Returns the (n_slots, chunk·(1 or 2) + 1)
        int32 packing of the tokens, the bitcast logprobs and the finished
        column, still on the device."""
        W = self.decode_chunk
        toks = torch.full((W, self.n_slots), self.pad_id, dtype=torch.long, device=self.device)
        lps = torch.zeros(W, self.n_slots, dtype=torch.float32, device=self.device) if self._logprobs else None
        self._flag(0, self.state["finished"])
        for i in range(W):
            if i and self._all_finished(i - 1):
                break
            self._decode_step(i, eos, toks, lps)
            self._flag(i + 1, self.state["finished"])
        cols = [toks.T.int()]
        if lps is not None:
            cols.append(lps.T.contiguous().view(torch.int32))
        cols.append(self.state["finished"][:, None].int())
        return torch.cat(cols, dim=1)

    # ------------------------------------------------------------- scheduling

    @torch.inference_mode()
    def warmup(self, image_shape=None, image_dtype=np.float32):
        """Run every prompt bucket's admission (a wave of 1 and one of
        ``n_slots`` rows) and one full decode chunk on a scratch copy of the
        pool, so a live serve meets no first-call costs (kernel library load,
        the allocator's growth, cuBLAS's plans). ``image_shape``: one
        request's pixel shape (e.g. (3, 2, 384, 384)), in ``image_dtype``,
        to warm the multimodal admissions too. Everything the scratch
        admissions touch is restored after: the pool, the slot map, the
        request table, the per-slot sampler rows, the wave count and the
        generator."""
        saved = (self.state, self._slot_req, self._requests, self._slot_sample, self._sample_dev, self._n_waves)
        gen_state = self.generator.get_state()
        self.state = _clone(self.state)
        self._slot_req, self._requests, self._slot_sample = list(self._slot_req), {}, self._slot_sample.copy()
        if image_shape is not None:
            cfg = self.cfg
            n_vis = (image_shape[-2] // cfg["patch_size"]) * (image_shape[-1] // cfg["patch_size"])
            n_vis //= cfg["spatial_merge_size"] ** 2
            pixels = np.zeros(image_shape, image_dtype)
            pixels_dev = self._upload(pixels)
            for lb in self.buckets:
                ids = ([cfg["image_token_id"]] * min(n_vis, lb - 1) + [1] * lb)[:lb]
                for k in sorted({1, self.n_slots}):
                    reqs = [_Request(-1 - j, np.asarray(ids, np.int64), 1, pixels=pixels, pixels_dev=pixels_dev)
                            for j in range(k)]
                    self._admit_group(reqs, list(range(k)))
        for lb in self.buckets:
            for k in sorted({1, self.n_slots}):
                pmask = np.zeros((k, lb), bool)
                pmask[:, 0] = True  # real_len >= 1 (the admission reads column len - 1)
                self._admit_rows(
                    self._upload(np.full((k, lb), self.pad_id, np.int64)), self._upload(pmask),
                    self._upload(np.arange(k, dtype=np.int64)), self._upload(np.ones(k, np.int64)),
                )
        # every scratch row gets a budget past the chunk (the admissions gave
        # 1, which would end the chunk after one step) but inside its columns,
        # and the chunk an eos no token matches
        self.state["budget"].fill_(min(self.decode_chunk + 2, self.max_len - 1))
        self.state["finished"].zero_()
        self._decode_chunk(torch.full_like(self.eos_arr, -1))
        self._sync()
        self.state, self._slot_req, self._requests, self._slot_sample, self._sample_dev, self._n_waves = saved
        self.generator.set_state(gen_state)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bucket_len(self, prompt_len):
        for b in self.buckets:
            if prompt_len <= b:
                return b
        if self.prefill_chunk:  # chunked admission: a multiple of the chunk
            return -(-prompt_len // self.prefill_chunk) * self.prefill_chunk
        raise ValueError(f"prompt_len {prompt_len} exceeds largest bucket {self.buckets[-1]}")

    @torch.inference_mode()
    def register_prefix(self, ids, adapter=None):
        """Prefill a shared prompt prefix (a system prompt, a few-shot
        header) once into a b = 1 cache row; requests submitted with
        ``prefix=pid`` give only their suffix, and their wave copies that row
        and prefills the suffixes at query offset ``plen``, so its cost
        scales with the suffix. The hybrid resumes exactly: the suffix's
        conv taps are seeded from the stored ones and its recurrent state
        continues from the stored state. Returns the prefix id."""
        if adapter is not None:
            raise NotImplementedError(f"register_prefix(adapter=) {LATER}")
        ids = np.asarray(ids, np.int64).reshape(-1)
        if "image_token_id" in self.cfg and np.any(ids == self.cfg["image_token_id"]):
            raise ValueError(
                "prefixes must be pure text: suffix MRoPE positions are offset by the prefix LENGTH, "
                "which equals its position count only for text tokens"
            )
        plen = len(ids)
        if plen + min(self.buckets) >= self.max_len:
            raise ValueError(f"prefix of {plen} leaves no room in max_len {self.max_len}")
        cache = self.model.init_cache(self.cfg, 1, self.max_len, dtype=self.cache_dtype, device=self.device)
        mask = torch.zeros(1, self.max_len, dtype=torch.bool, device=self.device)
        mask[:, :plen] = True
        _, cache, _ = self.model.apply(
            self.params, self.cfg, self._upload(ids[None]), attn_mask=mask, cache=cache,
            position_ids=torch.arange(plen, device=self.device)[None],
        )
        cache["pos"] = plen  # suffix waves write from column plen
        pid = len(self._prefixes)
        self._prefixes[pid] = (cache, plen)
        return pid

    def submit(self, ids, max_gen, prefix=None, pixels=None, adapter=None, temp=None, top_k=None, top_p=None,
               min_p=None):
        """Queue a prompt; returns a request id. ``prefix``: an id from
        ``register_prefix``, ``ids`` being the suffix after it. ``pixels``:
        the image of a multimodal prompt whose ids carry its placeholders
        already expanded (the model's ``apply`` takes ``image_pixels``);
        encoded once, at admission. ``temp``/``top_k``/``top_p``/``min_p``:
        per-request sampler overrides (engine built with
        ``per_request_sampling=True``; unset knobs take the engine's)."""
        if adapter is not None:
            raise NotImplementedError(f"submit(adapter=) {LATER}")
        ids = np.asarray(ids, np.int64).reshape(-1)
        lb = self._bucket_len(len(ids))
        plen = self._prefixes[prefix][1] if prefix is not None else 0
        if plen + lb + max_gen > self.max_len:
            raise ValueError(f"prefix {plen} + bucket {lb} + max_gen {max_gen} exceeds max_len {self.max_len}")
        sample_row = None
        if any(v is not None for v in (temp, top_k, top_p, min_p)):
            if not self._row_sampling:
                raise ValueError("per-request sampler overrides need per_request_sampling=True")
            d = self._default_sample
            sample_row = np.asarray(
                [d[0] if temp is None else temp, d[1] if top_k is None else top_k,
                 d[2] if top_p is None else top_p, d[3] if min_p is None else min_p], np.float32,
            )
            if sample_row[2] < 1.0 and sample_row[3] > 0.0:  # the effective combination
                raise ValueError("Cannot use top_p and min_p together")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, ids, max_gen, prefix=prefix, pixels=None if pixels is None else np.asarray(pixels),
                       sample=sample_row, t_submit=time.monotonic())
        self._requests[rid] = req
        self._queue.append(req)
        if req.pixels is not None:
            self._feed_pixels()
        return rid

    def _feed_pixels(self):
        """Start the uploads of queued images, oldest first, while fewer
        than ``n_slots`` of them are on the device: each overlaps the decode
        chunks before its wave, and the device holds a bounded number."""
        on_device = sum(r.pixels_dev is not None for r in self._queue)
        for r in self._queue:
            if on_device >= self.n_slots:
                break
            if r.pixels is not None and r.pixels_dev is None:
                r.pixels_dev = self._upload(r.pixels)
                on_device += 1

    @torch.inference_mode()
    def _admit_group(self, reqs, slots):
        """Admit ``reqs``, one wave of one kind (``_admit_pending``), into
        ``slots``: right-padded to the group's largest bucket (shorter
        prompts' pads are masked); prompts past the largest bucket through
        chunks, a prefix's suffixes on its stored row, images with their
        3-D positions."""
        lb = max(self._bucket_len(len(r.ids)) for r in reqs)
        k = len(reqs)
        prompt = np.full((k, lb), self.pad_id, np.int64)
        pmask = np.zeros((k, lb), bool)
        for j, r in enumerate(reqs):
            prompt[j, : len(r.ids)] = r.ids
            pmask[j, : len(r.ids)] = True
        pid = reqs[0].prefix
        prefix = None if pid is None else self._prefixes[pid]
        kw = {}
        if reqs[0].pixels is not None:
            kw = self._image_wave(reqs, lb, 0 if prefix is None else prefix[1])
        elif prefix is None and lb > self.buckets[-1]:
            kw["chunk"] = self.prefill_chunk
        self._admit_rows(
            self._upload(prompt), self._upload(pmask), self._upload(np.asarray(slots, np.int64)),
            self._upload(np.asarray([r.max_gen for r in reqs], np.int64)), prefix=prefix, **kw,
        )
        for r in reqs:
            r.pixels_dev = None  # the wave holds the stacked copy
        self._mark_admitted(reqs, slots)

    def _image_wave(self, reqs, lb, plen):
        """A multimodal wave's stacked device pixels, (3, k, lb) MRoPE
        positions (a text prefix shifts them by ``plen``; bucket-pad columns
        continue sequentially, masked) and decode's first positions."""
        from llm_quest_tpu_torch.models.qwen3_5 import compute_3d_position_ids, get_feeds_3d_shape

        shape = reqs[0].pixels.shape
        if any(r.pixels.shape != shape for r in reqs):
            raise ValueError("a multimodal wave needs one image shape")
        feeds = get_feeds_3d_shape(self.cfg, (1,) + shape)
        pos = np.zeros((3, len(reqs), lb), np.int64)
        next_pos = np.empty(len(reqs), np.int64)
        for j, r in enumerate(reqs):
            n = len(r.ids)
            row = plen + compute_3d_position_ids(self.cfg, r.ids[None], feeds)[:, 0]
            next_pos[j] = int(row.max()) + 1
            pos[:, j, :n] = row
            pos[:, j, n:] = next_pos[j] + np.arange(lb - n)
        pixels = torch.stack([self._upload(r.pixels) if r.pixels_dev is None else r.pixels_dev for r in reqs])
        return {"pixels": pixels, "position_ids": self._upload(pos), "next_pos": self._upload(next_pos)}

    def _mark_admitted(self, reqs, slots):
        now = time.monotonic()
        for r, s in zip(reqs, slots):
            self._slot_req[s] = r
            r.t_admit = now
            if self._row_sampling:
                self._slot_sample[s] = self._default_sample if r.sample is None else r.sample
        if self._row_sampling:
            self._sample_dev = self._upload(self._slot_sample)
        self._n_waves += 1

    @torch.inference_mode()
    def _admit_pending(self):
        """Admit queued requests into the free slots: one wave per kind, in
        FIFO order of each kind's first request — plain, per registered
        prefix, chunked by chunk count, multimodal by (image shape,
        prefix)."""
        free = [s for s in range(self.n_slots) if self._slot_req[s] is None]
        if not (free and self._queue):
            return
        groups = {}
        for _ in range(min(len(free), len(self._queue))):
            r = self._queue.popleft()
            if r.pixels is not None:
                key = ("vlm", r.pixels.shape, r.prefix)
            elif r.prefix is None and len(r.ids) > self.buckets[-1]:
                key = ("chunked", self._bucket_len(len(r.ids)) // self.prefill_chunk)
            else:
                key = r.prefix
            groups.setdefault(key, []).append(r)
        for reqs in groups.values():
            slots, free = free[: len(reqs)], free[len(reqs) :]
            self._admit_group(reqs, slots)
        self._feed_pixels()

    def _drain_one(self):
        """Wait for the OLDEST in-flight chunk, credit its tokens to the
        requests resident at its dispatch, retire the finished ones (the
        device already flagged them: no write back is needed)."""
        host, event, smap = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        packed = host.numpy()
        now = time.monotonic()
        W = self.decode_chunk
        toks, finished, lps = packed[:, :W], packed[:, -1].astype(bool), None
        if self._logprobs:
            lps = np.ascontiguousarray(packed[:, W : 2 * W]).view(np.float32)
        for slot, req in enumerate(smap):
            if req is None or req.done:
                continue
            take = min(W, req.max_gen - len(req.tokens))
            req.tokens.extend(int(t) for t in toks[slot, :take])
            if lps is not None:
                req.logprobs.extend(float(v) for v in lps[slot, :take])
            if req.tokens and req.t_first == 0.0:
                # drain-time stamp: includes the pipeline's lag (depth 1 = true TTFT)
                req.t_first = now
            if finished[slot] or len(req.tokens) >= req.max_gen:
                req.done = True
                req.t_done = now
                if self._slot_req[slot] is req:
                    self._slot_req[slot] = None

    @torch.inference_mode()
    def step(self):
        """One scheduler iteration: drain the oldest in-flight chunk when the
        pipeline is full, refill freed slots, dispatch the next chunk.
        Returns True while work remains."""
        while len(self._inflight) >= self.pipeline_depth:
            self._drain_one()
        self._admit_pending()
        live = sum(r is not None for r in self._slot_req)
        if live:
            host, event = self._to_host(self._decode_chunk(self.eos_arr))
            self._inflight.append((host, event, tuple(self._slot_req)))
            self._n_chunks += 1
            self._busy_slot_steps += live
            return True
        if self._inflight:  # nothing live to dispatch: wind the pipeline down
            self._drain_one()
            return True
        return bool(self._queue)

    def cancel(self, rid):
        """Cancel request ``rid``: a queued one never admits; a resident one
        retires on the host (its slot frees for the next wave, tokens of
        chunks already dispatched are dropped; the device decodes the row on
        until the slot is reused). Returns True if it was still live."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        try:
            self._queue.remove(req)
            req.pixels_dev = None
            self._feed_pixels()
        except ValueError:
            pass  # already admitted: free its slot below
        req.done = True
        req.t_done = time.monotonic()
        for slot, r in enumerate(self._slot_req):
            if r is req:
                self._slot_req[slot] = None
        return True

    def result(self, rid):
        """``(tokens committed so far (a copy), done)`` of request ``rid``."""
        req = self._requests[rid]
        return list(req.tokens), req.done

    def request_logprobs(self, rid):
        """The raw-model logprobs of request ``rid``'s committed tokens
        (engine built with ``return_logprobs=True``), aligned with its tokens."""
        if not self._logprobs:
            raise ValueError("engine was not built with return_logprobs=True")
        req = self._requests[rid]
        return req.logprobs[: len(req.tokens)]

    def stats(self):
        """Host-side serving statistics: request counts, tokens, admit waves,
        decode chunks, slot utilization; once a request finished, TTFT,
        latency and queue-wait percentiles and generated tok/s. Stamps are
        taken when a chunk drains (with depth > 1 they include the
        pipeline's lag)."""
        done = [r for r in self._requests.values() if r.done]
        out = {
            "requests_submitted": len(self._requests),
            "requests_completed": len(done),
            "tokens_generated": sum(len(r.tokens) for r in self._requests.values()),
            "admit_waves": self._n_waves,
            "decode_chunks": self._n_chunks,
            "slot_utilization": (
                self._busy_slot_steps / (self._n_chunks * self.n_slots) if self._n_chunks else 0.0
            ),
        }
        if done:
            ttft = [r.t_first - r.t_submit for r in done if r.t_first]
            lat = [r.t_done - r.t_submit for r in done]
            wait = [r.t_admit - r.t_submit for r in done]
            span = max(r.t_done for r in done) - min(r.t_submit for r in done)
            out.update(
                ttft_p50_s=statistics.median(ttft) if ttft else None,
                latency_p50_s=statistics.median(lat),
                latency_max_s=max(lat),
                queue_wait_p50_s=statistics.median(wait),
                gen_tok_per_s=sum(len(r.tokens) for r in done) / span if span > 0 else None,
            )
        return out

    def serve(self, prompts):
        """Serve (ids, max_gen) pairs to completion; returns the generated
        token lists in submission order (EOS included, what follows it
        trimmed)."""
        rids = [self.submit(*req) for req in prompts]
        while self.step():
            pass
        eos_set = set(self.eos_arr.tolist())
        outs = []
        for rid in rids:
            toks = self._requests[rid].tokens
            for i, t in enumerate(toks):
                if t in eos_set:
                    toks = toks[: i + 1]
                    break
            outs.append(toks)
        return outs
