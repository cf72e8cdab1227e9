"""The RG-LRU recurrence by device (counterpart:
``repro/kernels/rglru/ops.py``): the CUDA kernel for tensors on the card,
its plain version for tensors on the CPU. There is no other switch."""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan_kernel
from repro_torch.kernels.rglru.ref import rglru_scan_ref


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, T, D) fp32 -> h (B, T, D) fp32, ``h_t = a_t h_{t-1} + b_t``
    with ``h_{-1} = 0``."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_scan_ref(a, b)
    return rglru_scan_kernel(a, b)
