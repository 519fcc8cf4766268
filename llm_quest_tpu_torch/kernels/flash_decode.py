"""Flash-decode over an int8 KV cache (csrc/flash_decode_tc.cu for bf16 q,
csrc/flash_decode.cu for fp32 q) and its plain PyTorch version.

``flash_decode``: K10, one decode step of attention against the int8 cache;
replaces ``llm_quest_tpu/kernels/flash_decode.py::flash_decode``. The
dequantization is reassociated as in the TPU kernel and never written out:
the scores are s = (q·k_q)·(k_s·scale) + bias and the output is Σ (p·v_s)·v_q
over the softmax weights p.

The TPU grid walks the key blocks of one (batch, kv head) in order with the
running max, sum and output in scratch. Here blocks run unordered, and at
b = 1 one block per (batch, kv head) would fill 2 of the card's SMs, so the
keys are split (flash decoding). Routes by q's dtype:

- bf16 q takes the tensor-core kernel (``flash_decode_tc.cu``; counted in
  ``flash_decode.tc_launches``): ``plan`` splits each (batch, kv head)'s
  64-key tiles over a cluster of 1 to 16 blocks, rank r taking tiles
  [T r / split, T (r + 1) / split); in a
  block, warp w takes 16-key unit w % 4 of the tiles of parity w / 4 with an
  online softmax of its own; the warps' partials combine in warp order and
  the cluster's in rank order, through distributed shared memory: one
  launch, no scratch, the same bits every run. Both products run on the
  tensor cores in bf16 (int8 widened exactly), p·v_s rounded to bf16 as the
  value product's operand.
- fp32 q takes the SIMT kernel (``flash_decode.cu``): grid (b·hkv,
  n_splits), each split's partial into scratch, then a second kernel
  combines the splits in a fixed order.

Both mask the ragged tail themselves where JAX pads S to ``block_k``.

Plain version: ``flash_decode_plain``, the same arithmetic in one softmax
(the unnormalised p·v_s rounded to q's dtype before the value sum, as in the
TPU kernel). Device rule: a CUDA tensor launches a kernel (or raises), a CPU
tensor runs the plain version; ``plain=True`` forces the plain version
(comparisons only). ``flash_decode.launches`` counts launches.
"""

import ctypes
import functools

import torch

from llm_quest_tpu_torch.kernels import build

HEAD_DIMS = (128, 256)  # the head dims the kernels are instantiated for
MAX_GROUP = 8  # most q heads per kv head the kernels take
_SPLIT_MIN = 64  # fewest keys a split of the fp32 kernel takes

# the tensor-core kernel's schedule (csrc/flash_decode_tc.cu)
TILE = 64  # keys a stage
MAX_SPLIT = 16  # blocks a cluster
MIN_TILES = 4  # tiles a block of a split keeps at least


def supports_flash_decode(q, k_q, *, sink=None, softcap=None):
    """The router's guard (JAX's): a single query step on an int8 cache,
    128-multiple head dims, no sink or softcap, GQA-divisible heads."""
    return (
        k_q.dtype == torch.int8
        and q.shape[2] == 1
        and q.shape[-1] % 128 == 0
        and sink is None
        and softcap is None
        and q.shape[1] % k_q.shape[1] == 0
    )


def flash_decode_plain(q, k_q, k_s, v_q, v_s, bias, *, scale):
    b, hq, _, d = q.shape
    hkv, dv = v_q.shape[1], v_q.shape[-1]
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_q.float())
    s = s * (k_s.float() * scale)[:, :, None, :] + bias.float()[:, None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = (p * v_s.float()[:, :, None, :]).to(q.dtype).float()
    out = torch.einsum("bhgs,bhsd->bhgd", pv, v_q.float()) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, hq, 1, dv).to(q.dtype)


@functools.lru_cache(maxsize=256)
def plan(b, hkv, s_len, sms):
    """Blocks (a cluster) over which the tensor-core kernel splits each
    (batch, kv head)'s keys, from the shapes alone: doubled from 1 while the
    doubled grid stays within half the ``sms`` and each block keeps
    MIN_TILES tiles (two for each of its tile parities). On the H100 the
    loads alone stream fastest from 32 to 64 blocks (about 2.5 TB/s), and
    above that the products hide less well behind them: at b 16, S 8192
    64 blocks beat 128 (PERF.md). chip_smoke.py's ``k10_split_sweep``
    times the choices around it."""
    tiles = -(-s_len // TILE)
    split = 1
    while 2 * split <= MAX_SPLIT and b * hkv * 2 * split <= sms // 2 and tiles >= 2 * split * MIN_TILES:
        split *= 2
    return split


@functools.cache
def _sms(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.cache
def _tc_count():
    """The library's count of calls that launched the tensor-core kernel,
    read in place (no call into it)."""
    return ctypes.c_int.in_dll(build.library().cdll, "llmq_flash_decode_tc_launches")


def _splits(b, hkv, s_len, sms):
    """The fp32 kernel's (n_splits, keys per split): about two blocks per SM, at least _SPLIT_MIN keys a split."""
    n = max(1, min(-(-2 * sms // (b * hkv)), -(-s_len // _SPLIT_MIN)))
    split_len = -(-s_len // n)
    return -(-s_len // split_len), split_len


def flash_decode(q, k_q, k_s, v_q, v_s, bias, *, scale=None, sink=None, softcap=None, plain=False):
    """One decode step of attention against an int8 KV cache.

    q (b, hq, 1, d); k_q/v_q (b, hkv, S, d) int8 by strides (last dim
    contiguous; the int8 cache's layer views); k_s/v_s (b, hkv, S) fp32; bias
    (b, S) additive fp32 (0 valid / finfo.min/2 masked). Returns (b, hq, 1, d)
    in q's dtype. The kernels take d ∈ {128, 256}, dv == d and at most 8 q
    heads per kv head; a sink or a softcap raises on every device."""
    if sink is not None or softcap is not None:
        raise NotImplementedError("flash_decode: sinks and softcapping stay on the dequantized attention path")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if plain or not q.is_cuda:
        return flash_decode_plain(q, k_q, k_s, v_q, v_s, bias, scale=scale)
    build.require_no_grad("flash_decode", q)
    b, hq, sq, d = q.shape
    hkv, s_len, dv = k_q.shape[1], k_q.shape[2], v_q.shape[-1]
    build.require_cuda(q, k_q, k_s, v_q, v_s, bias)
    build.require(sq == 1, f"flash_decode takes one query position, got {sq}")
    build.require(d in HEAD_DIMS and dv == d, f"kernel head dims are {HEAD_DIMS} with dv == d, got d={d} dv={dv}")
    build.require(hq % hkv == 0 and hq // hkv <= MAX_GROUP, f"q heads {hq} must be 1-{MAX_GROUP} times kv heads {hkv}")
    build.require(k_q.dtype == torch.int8 and v_q.dtype == torch.int8, "k_q/v_q must be int8")
    build.require(k_q.shape == (b, hkv, s_len, d) and v_q.shape == k_q.shape, "k_q/v_q must be (b, hkv, S, d)")
    build.require(k_s.shape == (b, hkv, s_len) and v_s.shape == k_s.shape, "k_s/v_s must be (b, hkv, S)")
    build.require(k_s.dtype == torch.float32 and v_s.dtype == torch.float32, "k_s/v_s must be fp32")
    build.require(k_s.stride(-1) == 1 and v_s.stride(-1) == 1 and q.stride(-1) == 1, "k_s/v_s/q need a contiguous last dim")
    build.require(
        all(t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(st % 16 == 0 for st in t.stride()[:3])
            for t in (k_q, v_q)),
        "k_q/v_q need a contiguous last dim and 16-byte aligned rows",
    )
    build.require(bias.shape == (b, s_len) and bias.dtype == torch.float32 and bias.stride(-1) == 1,
                  "bias must be fp32 (b, S) with a contiguous last dim")
    sms = _sms(q.device.index)
    if q.dtype == torch.bfloat16:
        return _launch(q, k_q, k_s, v_q, v_s, bias, scale, split=plan(b, hkv, s_len, sms))
    return _launch(q, k_q, k_s, v_q, v_s, bias, scale, split=_splits(b, hkv, s_len, sms))


def _launch(q, k_q, k_s, v_q, v_s, bias, scale, *, split):
    """A kernel on checked inputs: bf16 q with ``split`` blocks a (batch,
    kv head) (1 to MAX_SPLIT, whatever ``plan`` would pick); fp32 q with
    ``split`` = (n_splits, keys per split) into scratch."""
    b, hq, _, d = q.shape
    hkv, s_len = k_q.shape[1], k_q.shape[2]
    out = torch.empty(b, hq, 1, d, dtype=q.dtype, device=q.device)
    if q.dtype == torch.bfloat16:
        n_splits, split_len, part_acc, part_ml = split, 0, None, None
    else:
        n_splits, split_len = split
        part_acc = torch.empty(b * hkv, n_splits, hq // hkv, d, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(b * hkv, n_splits, hq // hkv, 2, dtype=torch.float32, device=q.device)
    count = _tc_count()
    before = count.value
    build.launch(
        "llmq_flash_decode", build.dtype_code(q),
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), bias.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(), None if part_ml is None else part_ml.data_ptr(),
        out.data_ptr(), b, hq, hkv, s_len, d, n_splits, split_len,
        q.stride(0), q.stride(1), *k_q.stride()[:3], *k_s.stride()[:2], *v_q.stride()[:3], *v_s.stride()[:2],
        bias.stride(0), float(scale), build.stream_of(q),
    )
    del part_acc, part_ml  # freed to the caching allocator: only later work on this stream reuses them
    flash_decode.launches += 1
    flash_decode.tc_launches += count.value - before
    return out


flash_decode.launches = 0
flash_decode.tc_launches = 0  # the launches that took the bf16 tensor-core kernel
