"""Plain PyTorch version of the RG-LRU recurrence kernel (counterpart of
``repro/kernels/rglru/ref.py``, whose oracle is an associative scan).

A sequential loop over t: ``h_t = a_t * h_{t-1} + b_t`` with ``h_{-1} = 0``,
a rounded multiply then a rounded add per step, which is the CUDA kernel's
arithmetic. ``ops.rglru_scan`` calls it for tensors that lie on the CPU;
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b (B, T, D) -> h (B, T, D), in their dtype."""
    h = torch.empty_like(b)
    state = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        state = a[:, t] * state + b[:, t]
        h[:, t] = state
    return h
