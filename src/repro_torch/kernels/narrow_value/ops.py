"""Narrow-value detection and int4 packing by device (counterpart:
``repro/kernels/narrow_value/ops.py``): the CUDA kernels for tensors on the
card, the plain versions for tensors on the CPU. There is no other switch.
The reference's shape asserts raise ``ValueError`` on either device."""
from __future__ import annotations

import torch

from repro_torch.kernels.narrow_value.kernel import (
    check_pack, check_required_bits, check_unpack, pack_int4_kernel,
    required_bits_kernel, unpack_int4_kernel)
from repro_torch.kernels.narrow_value.ref import (pack_int4_ref,
                                                  required_bits_ref,
                                                  unpack_int4_ref)


def required_bits(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """x int32 (N,), N % block == 0 -> widths (N // block,) int32."""
    if x.device.type == "cpu":
        check_required_bits(x, block)
        return required_bits_ref(x, block)
    return required_bits_kernel(x, block)


def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] (N,) -> packed (N // 2,) int8."""
    if v.device.type == "cpu":
        check_pack(v)
        return pack_int4_ref(v)
    return pack_int4_kernel(v)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Packed (N,) int8 -> sign-extended codes (2 N,) int8."""
    if p.device.type == "cpu":
        check_unpack(p)
        return unpack_int4_ref(p)
    return unpack_int4_kernel(p)
