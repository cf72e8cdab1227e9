"""Model-layout wrappers of the flash-attention kernels (counterpart:
``repro/kernels/flash_attention/ops.py``).

q ``(B, S, Hq, D)``, k/v ``(B, T, Hkv, D)`` with ``Hq % Hkv == 0`` (query
head ``h`` belongs to kv head ``h // G``). The kernels take any S and T and
read strided views, so unlike the reference nothing is padded to a block
multiple and k/v are passed as transposed views, not copies.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_fwd,
                                                        flash_decode_fwd)

__all__ = ["flash_attention_gqa_fwd", "flash_decode"]


def _default_positions(B: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(B, n)


def _split_heads(q: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, S, Hq, D) -> (B, Hkv, G, S, D) view."""
    B, S, Hq, D = q.shape
    return q.reshape(B, S, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)


def _merge_heads(out5: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, G, S, D) -> (B, S, Hq, D)."""
    B, Hkv, G, S, D = out5.shape
    return out5.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G, D)


def _pos(p: torch.Tensor) -> torch.Tensor:
    return p.to(torch.int32).contiguous()


def flash_attention_gqa_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, softcap: float = 0.0,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward, any S/T. Returns (out (B, S, Hq, D),
    lse (B, Hkv, G, S) fp32)."""
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    q_pos = (_default_positions(B, S, q.device) if q_positions is None
             else q_positions)
    kv_pos = (_default_positions(B, T, q.device) if kv_positions is None
              else kv_positions)
    out5, lse = flash_attention_fwd(
        _split_heads(q, Hkv), k.transpose(1, 2), v.transpose(1, 2),
        _pos(q_pos), _pos(kv_pos), causal=causal, window=window,
        softcap=softcap)
    return _merge_heads(out5), lse


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                 causal: bool = True, window: int = 0,
                 softcap: float = 0.0) -> torch.Tensor:
    """Decode-step attention against a (ring) KV cache. q (B, S, Hq, D) with
    small S; k/v (B, T, Hkv, D); q_positions (B, S); kv_positions (B, T)
    (-1 = empty slot). Returns (B, S, Hq, D)."""
    Hkv = k.shape[2]
    out5 = flash_decode_fwd(
        _split_heads(q, Hkv), k.transpose(1, 2), v.transpose(1, 2),
        _pos(q_positions), _pos(kv_positions), causal=causal, window=window,
        softcap=softcap)
    return _merge_heads(out5)
