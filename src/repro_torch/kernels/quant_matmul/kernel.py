"""ctypes wrapper of the block-scaled int8 matmul CUDA kernel.

Replaces the TPU kernel ``quant_matmul_kernel`` of
``repro/kernels/quant_matmul/kernel.py`` (``:43``) with its contract: x
``(M, K)`` fp32 or bf16, codes ``(K, N)`` int8, scales ``(K // bk, N)``
fp32 -> ``(M, N)`` fp32, where ``bm, bn, bk = min(block_m, M),
min(block_n, N), min(block_k, K)`` must divide M, N and K (the reference's
asserts, ``ValueError`` here on any device). ``block_k`` fixes the scale
granularity; ``block_m`` and ``block_n`` are the reference's tiles and only
constrain the shapes: the CUDA tile (64 x 64) is the port's own. The CUDA
source is ``csrc/quant_matmul.cu``: per k-block an fp32 partial product,
then ``acc += partial * scale``, as the TPU kernel computes.

Bound on the H100: fp32 operations at prefill shapes, bytes at decode
shapes (``chip_smoke.py`` computes both).

:func:`quant_matmul_kernel` launches the kernel or raises: on a tensor that
is not on the card, of another dtype, or not contiguous. ``ops.py``
chooses between it and the plain version by the device of x. ``LAUNCHES``
counts launches, one per call that launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

LAUNCHES: Dict[str, int] = {"quant_matmul": 0}
X_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = build.library("quant_matmul")
    if not _bound:
        lib.repro_quant_matmul.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        lib.repro_quant_matmul.restype = _I
        _bound = True
    return lib


def check_quant_matmul(x: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, *, block_m: int = 128,
                       block_n: int = 128, block_k: int = 128) -> int:
    """The reference's shape contract; returns the scale granularity bk."""
    if x.dim() != 2 or codes.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"expected x (M, K), codes (K, N), scales (nkb, N); "
                         f"got {tuple(x.shape)}, {tuple(codes.shape)}, "
                         f"{tuple(scales.shape)}")
    (M, K), (K2, N) = x.shape, codes.shape
    if K != K2:
        raise ValueError(f"x {tuple(x.shape)} and codes {tuple(codes.shape)} "
                         "disagree on K")
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if bm < 1 or bn < 1 or bk < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"(M, N, K) = ({M}, {N}, {K}) must be multiples of "
                         f"the blocks ({bm}, {bn}, {bk})")
    if tuple(scales.shape) != (K // bk, N):
        raise ValueError(f"scales {tuple(scales.shape)}: expected "
                         f"({K // bk}, {N}) for block_k {bk}")
    return bk


def quant_matmul_kernel(x: torch.Tensor, codes: torch.Tensor,
                        scales: torch.Tensor, *, block_m: int = 128,
                        block_n: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """(M, N) fp32 of x @ codes with per-(k-block, column) scales, on the
    card."""
    bk = check_quant_matmul(x, codes, scales, block_m=block_m,
                            block_n=block_n, block_k=block_k)
    for name, t, dtypes in (("x", x, X_DTYPES), ("codes", codes, (torch.int8,)),
                            ("scales", scales, (torch.float32,))):
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the CUDA kernel takes "
                             "tensors on the card")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} is {t.dtype}: the CUDA kernel takes "
                            f"{dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({x.device, codes.device, scales.device}) != 1:
        raise ValueError(f"x on {x.device}, codes on {codes.device}, scales "
                         f"on {scales.device}")
    (M, K), N = x.shape, codes.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.repro_quant_matmul(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        M, N, K, bk, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    return out
