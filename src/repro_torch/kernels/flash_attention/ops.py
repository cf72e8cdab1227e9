"""Model-layout wrappers of the flash-attention kernels (counterpart:
``repro/kernels/flash_attention/ops.py``).

q ``(B, S, Hq, D)``, k/v ``(B, T, Hkv, D)`` with ``Hq % Hkv == 0`` (query
head ``h`` belongs to kv head ``h // G``); quantized caches as codes
``(B, T, Hkv, Dc)`` and scales ``(B, T, Hkv)``; paged caches as pools in
their storage layout ``(P, ps, Hkv, ...)`` with a table ``(B, NP)``. The
kernels take any S and T and read strided views, so unlike the reference
nothing is padded to a block multiple and k/v, codes and scales are passed
as transposed views, not copies.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bh, flash_attention_fwd, flash_decode_fwd,
    flash_decode_paged_fwd, flash_decode_paged_quant_fwd,
    flash_decode_quant_fwd)

__all__ = ["flash_attention_gqa_fwd", "flash_decode", "flash_decode_quant",
           "flash_decode_paged", "flash_decode_paged_quant",
           "flash_attention_bh"]


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


def flash_decode_quant(q: torch.Tensor, k_codes: torch.Tensor,
                       k_scale: torch.Tensor, v_codes: torch.Tensor,
                       v_scale: torch.Tensor, q_positions: torch.Tensor,
                       kv_positions: torch.Tensor, *, causal: bool = True,
                       window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Decode-step attention against a quantized (ring) KV cache: codes
    (B, T, Hkv, Dc) int8 (Dc = D, or D // 2 nibble-packed int4), scales
    (B, T, Hkv) fp32, positions as in :func:`flash_decode`. Returns
    (B, S, Hq, D)."""
    Hkv = k_codes.shape[2]
    out5 = flash_decode_quant_fwd(
        _split_heads(q, Hkv), k_codes.transpose(1, 2), k_scale.transpose(1, 2),
        v_codes.transpose(1, 2), v_scale.transpose(1, 2), _pos(q_positions),
        _pos(kv_positions), causal=causal, window=window, softcap=softcap)
    return _merge_heads(out5)


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, table: torch.Tensor,
                       q_positions: torch.Tensor, kv_positions: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0) -> torch.Tensor:
    """Decode-step attention against a paged KV cache: pools
    (P, ps, Hkv, D) (pool row 0 is the trash page), table (B, NP) int32,
    kv_positions (B, NP * ps). Returns (B, S, Hq, D)."""
    Hkv = k_pages.shape[2]
    out5 = flash_decode_paged_fwd(
        _split_heads(q, Hkv), k_pages, v_pages, _pos(table), _pos(q_positions),
        _pos(kv_positions), causal=causal, window=window, softcap=softcap)
    return _merge_heads(out5)


def flash_decode_paged_quant(q: torch.Tensor, k_codes: torch.Tensor,
                             k_scale: torch.Tensor, v_codes: torch.Tensor,
                             v_scale: torch.Tensor, table: torch.Tensor,
                             q_positions: torch.Tensor,
                             kv_positions: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0) -> torch.Tensor:
    """Decode-step attention against a quantized paged KV cache: code pools
    (P, ps, Hkv, Dc) int8, scale pools (P, ps, Hkv) fp32, table and
    positions as in :func:`flash_decode_paged`. Returns (B, S, Hq, D)."""
    Hkv = k_codes.shape[2]
    out5 = flash_decode_paged_quant_fwd(
        _split_heads(q, Hkv), k_codes, k_scale, v_codes, v_scale, _pos(table),
        _pos(q_positions), _pos(kv_positions), causal=causal, window=window,
        softcap=softcap)
    return _merge_heads(out5)
