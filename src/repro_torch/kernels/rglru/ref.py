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


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                       dh: torch.Tensor) -> tuple:
    """(da, db) of the recurrence by a plain loop backwards in time, in the
    CUDA backward's arithmetic: ``g_t = a_{t+1} g_{t+1} + dh_t`` (a rounded
    multiply then a rounded add, from a zero state: the first step
    multiplies ``a_0`` by 0), ``db = g``, ``da_t = g_t h_{t-1}`` with
    ``h_{-1} = 0``."""
    T = dh.shape[1]
    g = torch.empty_like(dh)
    state = torch.zeros_like(dh[:, 0])
    for t in range(T - 1, -1, -1):
        state = a[:, (t + 1) % T] * state + dh[:, t]
        g[:, t] = state
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g
