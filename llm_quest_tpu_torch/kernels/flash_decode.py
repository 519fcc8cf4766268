"""Flash-decode over an int8 KV cache (csrc/flash_decode.cu) and its plain
PyTorch version.

``flash_decode``: K10, one decode step of attention against the int8 cache;
replaces ``llm_quest_tpu/kernels/flash_decode.py::flash_decode``. The
dequantization is reassociated as in the TPU kernel and never written out:
the scores are s = (q·k_q)·(k_s·scale) + bias and the output is Σ (p·v_s)·v_q
over the softmax weights p.

The TPU grid walks the key blocks of one (batch, kv head) in order with the
running max, sum and output in scratch. Here blocks run unordered, and at
b = 1 one block per (batch, kv head) would fill 2 of the card's SMs, so the
kernel splits the keys (flash decoding): grid (b·hkv, n_splits), each block
keeping its own online softmax over its key range, then a second small kernel
combines the splits in a fixed order (no atomics: deterministic). The kernel
masks the ragged tail itself where JAX pads S to ``block_k``.

Plain version: ``flash_decode_plain``, the same arithmetic in one softmax
(the unnormalised p·v_s rounded to q's dtype before the value sum, as in the
TPU kernel). Device rule: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version; ``plain=True`` forces the plain version
(comparisons only). ``flash_decode.launches`` counts launches.
"""

import torch

from llm_quest_tpu_torch.kernels import build

HEAD_DIMS = (128, 256)  # the head dims csrc/flash_decode.cu is instantiated for
MAX_GROUP = 8  # most q heads per kv head the kernel takes
_SPLIT_MIN = 64  # fewest keys a split takes


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


def _splits(q, b, hkv, s_len):
    """(n_splits, keys per split): about two blocks per SM, at least _SPLIT_MIN keys a split."""
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n = max(1, min(-(-2 * sms // (b * hkv)), -(-s_len // _SPLIT_MIN)))
    split_len = -(-s_len // n)
    return -(-s_len // split_len), split_len


def flash_decode(q, k_q, k_s, v_q, v_s, bias, *, scale=None, sink=None, softcap=None, plain=False):
    """One decode step of attention against an int8 KV cache.

    q (b, hq, 1, d); k_q/v_q (b, hkv, S, d) int8 by strides (last dim
    contiguous; the int8 cache's layer views); k_s/v_s (b, hkv, S) fp32; bias
    (b, S) additive fp32 (0 valid / finfo.min/2 masked). Returns (b, hq, 1, d)
    in q's dtype. The kernel takes d ∈ {128, 256}, dv == d and at most 8 q
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
    g = hq // hkv
    n_splits, split_len = _splits(q, b, hkv, s_len)
    part_acc = torch.empty(b * hkv, n_splits, g, d, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(b * hkv, n_splits, g, 2, dtype=torch.float32, device=q.device)
    out = torch.empty(b, hq, 1, d, dtype=q.dtype, device=q.device)
    build.launch(
        "llmq_flash_decode", build.dtype_code(q),
        q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(), v_s.data_ptr(), bias.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        b, hq, hkv, s_len, d, n_splits, split_len,
        q.stride(0), q.stride(1), *k_q.stride()[:3], *k_s.stride()[:2], *v_q.stride()[:3], *v_s.stride()[:2],
        bias.stride(0), float(scale), build.stream_of(q),
    )
    del part_acc, part_ml  # freed to the caching allocator: only later work on this stream reuses them
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

