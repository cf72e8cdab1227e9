"""Plain PyTorch versions of the flash-attention kernels, in the kernels'
layout (counterpart of the TPU kernels' semantics in
``repro/kernels/flash_attention/kernel.py``: ``_tile_update`` and
``_tile_finalize``).

They compute in fp32 with the kernels' mask rule and fully-masked-row guard,
over the whole kv axis at once. The wrappers in ``kernel.py`` call them for
tensors that lie on the CPU; ``chip_smoke.py`` holds the CUDA kernels
against them on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def visible_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                 causal: bool, window: int) -> torch.Tensor:
    """(B, S, T) bool: which (q, kv) pairs attend. qp -1 marks a pad row,
    kp -1 an empty slot; causal and sliding windows act on positions."""
    qp = q_positions.to(torch.int32)[:, :, None]
    kp = kv_positions.to(torch.int32)[:, None, :]
    mask = (kp >= 0) & (qp >= 0)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    return mask


def _attend(q, k, v, q_positions, kv_positions, causal, window, softcap):
    D = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, kf) * (1.0 / math.sqrt(D))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    mask = visible_mask(q_positions, kv_positions, causal=causal,
                        window=window)[:, None, None]          # (B,1,1,S,T)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    safe_m = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - safe_m[..., None]),
                    torch.zeros_like(s))
    l = p.sum(dim=-1)
    lsafe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, vf) / lsafe[..., None]
    lse = torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF),
                      m + torch.log(lsafe))
    return out.to(q.dtype), lse


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            q_positions: torch.Tensor,
                            kv_positions: torch.Tensor, *, causal: bool = True,
                            window: int = 0, softcap: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hkv, G, S, D), k/v (B, Hkv, T, D), positions (B, S) / (B, T)
    -> (out like q, lse (B, Hkv, G, S) fp32)."""
    return _attend(q, k, v, q_positions, kv_positions, causal, window, softcap)


def flash_decode_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_positions: torch.Tensor, kv_positions: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Decode: the same function for a small q block; returns out only."""
    return _attend(q, k, v, q_positions, kv_positions, causal, window,
                   softcap)[0]
