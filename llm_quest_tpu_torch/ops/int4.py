"""int4 weights stored two a byte, and the integer values of a quantized
weight: the one rule that the quantizer (``ops/quantization.py``), the table
lookups (``ops/linear.py``) and K11's plain version
(``kernels/quantized_gmm.py``) share. It imports nothing of the package.

Packing runs along one axis (dim 1 of every quantized weight, the
contraction axis): element 2i goes in the low nibble and 2i + 1 in the high
one, two's complement; an odd length gets a zero pad nibble. The dtype tells
the two widths apart: int8 weights are ``int8``, packed int4 ones ``uint8``.
"""

import torch


def pack_int4(q, dim=1):
    """int8 values in [-8, 7] → ``uint8``, two a byte along ``dim``; an odd
    length gets a zero pad nibble."""
    q = q.movedim(dim, -1).to(torch.int16)
    if q.shape[-1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    packed = (q[..., 0::2] & 0xF) | ((q[..., 1::2] & 0xF) << 4)
    return packed.to(torch.uint8).movedim(-1, dim).contiguous()


def unpack_int4(packed, width, dim=1, dtype=torch.int8):
    """``pack_int4``'s inverse: ``packed`` (…, ⌈width/2⌉ on ``dim``, …) →
    the ``width`` values along ``dim`` in ``dtype`` (integers, exact in any
    float type). Written in place into one tensor of ``dtype``: no other
    copy of the weight is made."""
    s = packed.movedim(dim, -1).view(torch.int8)
    out = torch.empty(*s.shape[:-1], 2 * s.shape[-1], dtype=dtype, device=s.device)
    # the signed byte s is 16·hi + lo with lo's bits in [0, 15]: hi is s shifted right arithmetically, and lo
    # as a two's complement nibble is ((s + 8) mod 16) - 8
    out[..., 1::2].copy_(s).div_(16, rounding_mode="floor")
    out[..., 0::2].copy_(s).add_(8).remainder_(16).sub_(8)
    return out[..., :width].movedim(-1, dim)


def is_int4(w_q):
    """True for a packed int4 weight (``uint8``), False for int8."""
    return w_q.dtype == torch.uint8


def integer_weight(w_q, width, dtype):
    """The integer weight (``width`` wide along dim 1) in ``dtype``: int8
    converted, int4 unpacked."""
    return unpack_int4(w_q, width, dtype=dtype) if is_int4(w_q) else w_q.to(dtype)
