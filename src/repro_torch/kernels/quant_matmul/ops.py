"""The Proteus quantized matmul by device (counterpart:
``repro/kernels/quant_matmul/ops.py``): the CUDA kernel for tensors on the
card, its plain version for tensors on the CPU (reported to a step counter
as the kernel's launch, ``kernels/accounting.py``; the kernel wrapper
reports on the card, and answers ``meta`` tensors under a counter). There
is no other switch.
``quantize_weights`` is plain PyTorch on either device, as it is jnp in the
reference."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import accounting
from repro_torch.kernels.quant_matmul.kernel import (check_quant_matmul,
                                                     quant_matmul_kernel, work)
from repro_torch.kernels.quant_matmul.ref import (quant_matmul_ref,
                                                  quantize_weights_ref)


def quantize_weights(w: torch.Tensor, block_k: int = 128,
                     bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (K, N) -> (codes int8 (K, N), scales fp32 (K // block_k, N))."""
    return quantize_weights_ref(w, block_k=block_k, bits=bits)


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                 *, block_m: int = 128, block_n: int = 128,
                 block_k: int = 128) -> torch.Tensor:
    """x (M, K) fp32 / bf16 @ codes (K, N) int8 with scales (K // bk, N)
    fp32 -> (M, N) fp32; the reference's block contract (see
    ``kernel.check_quant_matmul``)."""
    kw = dict(block_m=block_m, block_n=block_n, block_k=block_k)
    if x.device.type == "cpu":
        check_quant_matmul(x, codes, scales, **kw)
        with accounting.launch("quant_matmul", *work(x, codes, scales)):
            return quant_matmul_ref(x, codes, scales)
    return quant_matmul_kernel(x, codes, scales, **kw)
