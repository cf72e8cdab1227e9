"""ctypes wrapper of the RG-LRU recurrence CUDA kernel.

Replaces the TPU kernel ``rglru_scan_kernel`` of
``repro/kernels/rglru/kernel.py`` with its contract: a, b ``(B, T, D)``
fp32 -> h ``(B, T, D)`` fp32, ``h_t = a_t * h_{t-1} + b_t``, ``h_{-1} = 0``
(a caller with an initial state folds it into ``b[:, 0]``). The CUDA source
is ``csrc/rglru.cu``: one thread per (b, d) channel with h in a register,
loads coalesced along d and unrolled ahead of the update chain.

Bound on the H100: bytes (two fp32 reads and one write per element).

:func:`rglru_scan_kernel` launches the kernel or raises: on a tensor that
is not on the card, not fp32, not contiguous or not 3-D. ``ops.rglru_scan``
chooses between it and the plain version by the device of the inputs.
``LAUNCHES`` counts launches, one per call that launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

LAUNCHES: Dict[str, int] = {"rglru_scan": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = build.library("rglru")
    if not _bound:
        lib.repro_rglru_scan.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.repro_rglru_scan.restype = _I
        _bound = True
    return lib


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h (B, T, D) fp32 of the recurrence over a, b (B, T, D) fp32 on the
    card."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b (B, T, D) of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the CUDA kernel takes "
                             "tensors on the card")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the CUDA kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    B, T, D = a.shape
    h = torch.empty_like(b)
    lib = _lib()
    err = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               B, T, D,
                               torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h
