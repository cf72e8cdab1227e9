"""Plain PyTorch versions of the block-scaled quantized matmul (counterpart:
``repro/kernels/quant_matmul/ref.py``): quantize weights per (k-block,
column), dequantize, and ``x @ dequantize(codes, scales)`` in fp32.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes
equal the reference's. The scales equal those of the reference's public
``quantize_weights``, which is jitted: XLA turns its ``maxabs / qmax`` into
a product with the fp32 reciprocal of ``qmax``, so the port multiplies too
(the reference's unjitted oracle divides, and differs from it in the last
bit of some scales). The CUDA kernel applies each k-block's scale to its
fp32 partial sum instead of to each code, as the TPU kernel does: the two
differ by summation-order noise only. ``ops.quant_matmul`` calls
``quant_matmul_ref`` for tensors on the CPU; ``chip_smoke.py`` holds the
kernel against it on the card.

:func:`quant_matmul_route_ref` states the CUDA kernel's route in plain
PyTorch: x in exact bf16 parts (``kernels/common.py`` :func:`split_bf16`),
each part times the bf16 codes summed in fp32 per k-block, the partial
times the scale.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import split_bf16


def quantize_weights_ref(w: torch.Tensor, block_k: int = 128,
                         bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> (codes int8 (K, N), scales fp32 (K // block_k, N))."""
    K, N = w.shape
    if K % block_k:
        raise ValueError(f"K {K} is not a multiple of block_k {block_k}")
    qmax = float(2 ** (bits - 1) - 1)
    wb = w.reshape(K // block_k, block_k, N).float()
    maxabs = wb.abs().amax(dim=1)                          # (nkb, N)
    scale = torch.where(maxabs == 0, torch.ones_like(maxabs),
                        maxabs * (1.0 / qmax))
    codes = torch.clamp(torch.round(wb / scale[:, None, :]), -qmax - 1, qmax)
    return codes.reshape(K, N).to(torch.int8), scale


def dequantize_ref(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """codes (K, N) int8, scales (nkb, N) fp32 -> (K, N) fp32."""
    K, N = codes.shape
    nkb = scales.shape[0]
    cb = codes.reshape(nkb, K // nkb, N).float()
    return (cb * scales[:, None, :]).reshape(K, N)


def quant_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """x (M, K) float @ dequantized (K, N) -> (M, N) fp32."""
    return x.float() @ dequantize_ref(codes, scales)


def quant_matmul_route_ref(x: torch.Tensor, codes: torch.Tensor,
                           scales: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's arithmetic: per k-block of ``K // nkb`` rows an fp32
    partial of the exact products of x's bf16 parts (three for fp32 x, x
    itself for bf16) and the codes, then ``acc += partial * scale``."""
    K, N = codes.shape
    nkb = scales.shape[0]
    bk = K // nkb
    parts = split_bf16(x) if x.dtype == torch.float32 else (x,)
    acc = torch.zeros((x.shape[0], N), dtype=torch.float32, device=x.device)
    for kb in range(nkb):
        ks = slice(kb * bk, (kb + 1) * bk)
        cb = codes[ks].float()
        partial = sum(p[:, ks].float() @ cb for p in parts)
        acc = acc + partial * scales[kb]
    return acc
