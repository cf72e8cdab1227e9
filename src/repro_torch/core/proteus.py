"""Narrow-value detection of the Proteus runtime (counterpart:
``repro/core/proteus.py``, ``block_stats``, ``block_crest`` and
``required_bits_float``): the data-aware signal that ``kv_quant="auto"``
uses to pick the int4 or the int8 grid. The rest of Proteus is ported with
the paper layer.

Everything stays on the tensor's device: the results are 0-d tensors, so a
caller can branch on them with ``torch.where`` and no host sync.
"""
from __future__ import annotations

from typing import Tuple

import torch


def block_stats(x: torch.Tensor,
                block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """(maxabs, meanabs) per block of the flattened tensor; the zero padding
    of the last block is excluded from its mean."""
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, block).abs()
    counts = torch.clamp(
        n - torch.arange(blocks.shape[0], device=x.device) * block, 1, block)
    return blocks.amax(dim=1), blocks.sum(dim=1) / counts


def block_crest(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Worst per-block crest factor max|x| / mean|x| (>= 1; an all-zero
    block counts 1): about 1 for uniform magnitudes, large for spiky
    blocks."""
    maxabs, meanabs = block_stats(x, block)
    crest = torch.where(maxabs > 0,
                        maxabs / torch.clamp(meanabs, min=1e-30),
                        torch.ones_like(maxabs))
    return crest.amax()


def required_bits_float(x: torch.Tensor, block: int = 256,
                        rtol: float = 1e-2) -> torch.Tensor:
    """Bits so that the block-scaled quantization error stays under
    ``rtol`` times the block's mean |x|: with crest c,
    ``2^(b-1) >= c / (2 rtol) + 1``. int32, at least 2."""
    crest = block_crest(x, block)
    need = torch.ceil(torch.log2(crest / (2.0 * rtol) + 1.0)) + 1.0
    return torch.clamp(need, min=2.0).to(torch.int32)
