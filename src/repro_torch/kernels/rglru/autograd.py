"""The RG-LRU recurrence under autograd (counterpart: the reference
differentiates its jnp ``associative_scan``, ``repro/models/rglru.py``;
it has no backward kernel, so no TPU kernel is ported here).

The adjoint of ``h_t = a_t h_{t-1} + b_t`` is the same recurrence run
backwards in time: ``g_t = dh_t + a_{t+1} g_{t+1}`` with
``g_{T-1} = dh_{T-1}``, then ``db_t = g_t`` and ``da_t = g_t h_{t-1}``
(``h_{-1} = 0``). :class:`RglruScanFn` computes ``g`` with the forward op
(``ops.rglru_scan``: the CUDA kernel on the card, its plain loop on the
CPU) over the time-reversed sequences ``a'_s = a_{T-s}`` (``a'_0`` is
multiplied by the zero start state; it holds ``a_0``) and
``b'_s = dh_{T-1-s}``, then flips ``g`` back. The kernel is bit for bit
its loop, so on the card the backward equals :func:`ref.rglru_scan_bwd_ref`
bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rglru.kernel import LAUNCHES
from repro_torch.kernels.rglru.ops import rglru_scan as rglru_scan_op


def reversed_inputs(a: torch.Tensor, dh: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a', b') of the backward recurrence: ``a'_s = a_{T-s}`` (``a'_0 =
    a_0``, never read) and ``b'_s = dh_{T-1-s}``, contiguous."""
    a_rev = torch.roll(torch.flip(a, dims=[1]), 1, dims=1)
    return a_rev, torch.flip(dh, dims=[1]).contiguous()


def grads_from_adjoint(g: torch.Tensor, h: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) from the adjoint ``g`` (in time order) and the forward's h:
    ``da_t = g_t h_{t-1}`` with ``h_{-1} = 0``, ``db = g``."""
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


class RglruScanFn(torch.autograd.Function):
    """h = rglru_scan(a, b) for a, b (B, T, D) fp32, differentiable in both:
    the forward op, and the backward by the same op on the reversed
    sequences. Used on every device, so the CPU runs the backward's code
    through the plain loop."""

    @staticmethod
    def forward(ctx, a, b):
        h = rglru_scan_op(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        g = rglru_scan_op(*reversed_inputs(a, dh.contiguous()))
        if g.is_cuda:
            # the kernel launched: the backward's own count beside the
            # kernel's
            LAUNCHES["rglru_scan_bwd"] += 1
        return grads_from_adjoint(torch.flip(g, dims=[1]), h)
