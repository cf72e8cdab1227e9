"""Plain PyTorch versions of the narrow-value kernels (counterpart:
``repro/kernels/narrow_value/ref.py``).

``required_bits_ref`` returns what the reference returns. The reference
computes a block's width in fp32 as ``ceil(log2(float(max|x|) + 1)) + 1``
(1 for an all-zero block), and that is not the exact two's-complement
width from 2^21 on: for a magnitude ``m = float(max|x|)`` just above
``2^k`` the rounded ``log2`` lands on ``k`` and the width comes out one
short. Which magnitudes do depends on the ``log2`` that evaluates it (jax
computes ``log(y) / log(2)`` on XLA:CPU; another library's fp32 ``log2``
rounds elsewhere near those points), so the port does not call a
``log2``: it takes the exact width of ``m`` and subtracts one where
``m - 2^k <= REFERENCE_SHORT[k]``, the reference's own windows. ``tests/test_torch_narrow_value.py`` holds
this against the reference over every fp32 magnitude an int32 block can
have. The CUDA kernel computes the same integer function.

The int4 pair is the port's plain ``kernels/common.py`` copy, as the
reference's oracle is its ``kernels/common.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import pack_int4, unpack_int4

# k -> the largest m - 2^k (m = float(max|x|) in [2^k, 2^(k+1))) for which
# the reference's fp32 formula returns k + 1 where the exact width is k + 2;
# every other magnitude gets its exact width (jax 0.9.0 on XLA:CPU, found by
# evaluating the reference at every fp32 value of an int32 magnitude)
REFERENCE_SHORT = {21: 1, 22: 1, 23: 7, 24: 16, 25: 48, 26: 0, 27: 64,
                   28: 256, 29: 768, 30: 0, 31: 0}


def magnitude_width(m: torch.Tensor) -> torch.Tensor:
    """The reference's width (int32) of fp32 magnitudes ``m``, each 0 or an
    integer in [1, 2^31] (the fp32 value of an int32's |x|): 1 for 0, else
    the bits of ``m`` plus a sign bit, one fewer in the windows of
    ``REFERENCE_SHORT``."""
    mi = m.to(torch.int64)
    k = (torch.frexp(m).exponent - 1).clamp(min=0).to(torch.int64)
    over = mi - torch.bitwise_left_shift(torch.ones_like(mi), k)
    short = torch.full_like(k, -1)
    for kk, d in REFERENCE_SHORT.items():
        short = torch.where(k == kk, d, short)
    bits = k + 2 - (over <= short).to(torch.int64)
    return torch.where(mi == 0, 1, bits).to(torch.int32)


def required_bits_ref(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """x int32 (N,), N % block == 0 -> the width of each block (N // block,)
    int32."""
    n = x.shape[0]
    m = x.reshape(n // block, block).float().abs().amax(dim=1)
    return magnitude_width(m)


def pack_int4_ref(v: torch.Tensor) -> torch.Tensor:
    return pack_int4(v)


def unpack_int4_ref(p: torch.Tensor) -> torch.Tensor:
    return unpack_int4(p)
