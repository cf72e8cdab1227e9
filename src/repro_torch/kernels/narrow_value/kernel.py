"""ctypes wrappers of the narrow-value CUDA kernels.

Replaces the TPU kernels of ``repro/kernels/narrow_value/kernel.py`` with
their contracts:

* ``required_bits_kernel`` (``kernel.py:30``): x int32 ``(N,)`` with
  ``N % block == 0`` -> the width of each block ``(N // block,)`` int32, as
  the reference's fp32 formula gives it (see ``ref.py``);
* ``pack_int4_kernel`` (``kernel.py:62``): int8 codes ``(N,)``, N even and
  ``N % min(512, N) == 0`` -> ``(N // 2,)`` int8, the even element in the
  low nibble;
* ``unpack_int4_kernel`` (``kernel.py:79``): ``(N,)`` with
  ``N % min(256, N) == 0`` -> ``(2 N,)`` int8 codes in [-8, 7].

The shapes the reference asserts on raise ``ValueError`` here, on any
device. The CUDA source is ``csrc/narrow_value.cu``: 16-byte loads and
stores, one warp per block for the widths.

Bound on the H100: bytes (one read of the input, one write of the output).

Each wrapper launches its kernel or raises: on a tensor that is not on the
card, not of its dtype, not 1-D or not contiguous. ``ops.py`` chooses
between them and the plain versions by the device of the input.
``LAUNCHES`` counts launches, one per call that launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

LAUNCHES: Dict[str, int] = {"required_bits": 0, "pack_int4": 0,
                            "unpack_int4": 0}
# the blocks of the reference's pack / unpack grids
PACK_BLOCK = 512
UNPACK_BLOCK = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = build.library("narrow_value")
    if not _bound:
        lib.repro_required_bits.argtypes = [_P, _P, _L, _I, _I, _P]
        lib.repro_pack_int4.argtypes = [_P, _P, _L, _I, _P]
        lib.repro_unpack_int4.argtypes = [_P, _P, _L, _I, _P]
        for fn in (lib.repro_required_bits, lib.repro_pack_int4,
                   lib.repro_unpack_int4):
            fn.restype = _I
        _bound = True
    return lib


def check_required_bits(x: torch.Tensor, block: int) -> int:
    """Number of blocks, or ValueError where the reference asserts."""
    if x.dim() != 1:
        raise ValueError(f"expected x (N,); got {tuple(x.shape)}")
    if block < 1 or x.shape[0] % block:
        raise ValueError(f"N {x.shape[0]} is not a multiple of block {block}")
    return x.shape[0] // block


def check_pack(v: torch.Tensor) -> None:
    if v.dim() != 1:
        raise ValueError(f"expected codes (N,); got {tuple(v.shape)}")
    n = v.shape[0]
    if n == 0 or n % 2 or n % min(PACK_BLOCK, n):
        raise ValueError(f"N {n}: pack_int4 takes an even N > 0 that is a "
                         f"multiple of {PACK_BLOCK} or below it")


def check_unpack(p: torch.Tensor) -> None:
    if p.dim() != 1:
        raise ValueError(f"expected packed bytes (N,); got {tuple(p.shape)}")
    n = p.shape[0]
    if n == 0 or n % min(UNPACK_BLOCK, n):
        raise ValueError(f"N {n}: unpack_int4 takes N > 0 that is a multiple "
                         f"of {UNPACK_BLOCK} or below it")


def _check_cuda(name: str, t: torch.Tensor, dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}: the CUDA kernel takes "
                         "tensors on the card")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}: the CUDA kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(*ts) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def required_bits_kernel(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Widths (N // block,) int32 of the blocks of x (N,) int32 on the
    card."""
    nb = check_required_bits(x, block)
    _check_cuda("x", x, torch.int32)
    out = torch.empty(nb, dtype=torch.int32, device=x.device)
    lib = _lib()
    err = lib.repro_required_bits(x.data_ptr(), out.data_ptr(), nb, block,
                                  int(block % 4 == 0) & _aligned(x),
                                  _stream(x))
    build.check(lib, err, "required_bits")
    LAUNCHES["required_bits"] += 1
    return out


def pack_int4_kernel(v: torch.Tensor) -> torch.Tensor:
    """Packed bytes (N // 2,) int8 of codes v (N,) int8 on the card."""
    check_pack(v)
    _check_cuda("v", v, torch.int8)
    p = torch.empty(v.shape[0] // 2, dtype=torch.int8, device=v.device)
    lib = _lib()
    err = lib.repro_pack_int4(v.data_ptr(), p.data_ptr(), v.shape[0],
                              _aligned(v, p), _stream(v))
    build.check(lib, err, "pack_int4")
    LAUNCHES["pack_int4"] += 1
    return p


def unpack_int4_kernel(p: torch.Tensor) -> torch.Tensor:
    """Codes (2 N,) int8 in [-8, 7] of packed bytes p (N,) int8 on the
    card."""
    check_unpack(p)
    _check_cuda("p", p, torch.int8)
    v = torch.empty(2 * p.shape[0], dtype=torch.int8, device=p.device)
    lib = _lib()
    err = lib.repro_unpack_int4(p.data_ptr(), v.data_ptr(), p.shape[0],
                                _aligned(p, v), _stream(p))
    build.check(lib, err, "unpack_int4")
    LAUNCHES["unpack_int4"] += 1
    return v
