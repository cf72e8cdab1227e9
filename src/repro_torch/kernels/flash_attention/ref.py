"""Plain PyTorch versions of the flash-attention kernels, in the kernels'
layout (counterpart of the TPU kernels' semantics in
``repro/kernels/flash_attention/kernel.py``: ``_tile_update``,
``_tile_finalize`` and ``_dequant_rows``).

They compute in fp32 with the kernels' mask rule and fully-masked-row guard,
over the whole kv axis at once. The wrappers in ``kernel.py`` call them for
tensors that lie on the CPU; ``chip_smoke.py`` holds the CUDA kernels
against them on the card. :func:`fp32_route_ref` states the fp32 prefill
kernel's arithmetic (exact bf16 parts on the tensor cores) for the tests.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels.common import split_bf16, unpack_int4

NEG_INF = -1e30
# the fp32 prefill route's products: the pairs (i, j) of bf16 parts with
# i + j <= 2, smallest first, as csrc/flash_prefill.cu's pair_a / pair_b
# order them
FP32_ROUTE_PAIRS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


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
    # fp32 for fp32 / bf16 inputs; float64 stays float64 (gradcheck)
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
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


def attention_ref_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, S, D), k/v (BH, T, D) -> (BH, S, D) in q's dtype: quadratic
    softmax attention in fp32, q at positions 0..S-1 and k/v at 0..T-1
    (counterpart: ``repro/kernels/flash_attention/ref.py``
    ``attention_ref_bh``)."""
    BH, S, D = q.shape
    T = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.where(mask[None], torch.softmax(s, dim=-1), torch.zeros_like(s))
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def _pair_products(a_parts, b_parts, eq: str, pairs) -> torch.Tensor:
    """sum over ``pairs`` of einsum(eq, a_i, b_j), each product of bf16
    parts exact in fp32, summed in fp32 in the pairs' order."""
    out = None
    for i, j in pairs:
        t = torch.einsum(eq, a_parts[i].float(), b_parts[j].float())
        out = t if out is None else out + t
    return out


def fp32_route_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                   causal: bool = True, window: int = 0, softcap: float = 0.0,
                   block_k: int,
                   pairs: Sequence[Tuple[int, int]] = FP32_ROUTE_PAIRS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 prefill kernel's arithmetic in plain PyTorch, for the tests:
    q, k, v and p each as three exact bf16 parts (:func:`split_bf16`); q.k
    and p @ v as the sums of the products of ``pairs`` of parts in fp32;
    an fp32 online softmax over kv tiles of ``block_k`` rows (the kernel's
    tile at q's head_dim, ``kernel.FP32_PREFILL_TILES``); l summed from the
    fp32 p. Inputs in the kernel layout, fp32; returns (out, lse) fp32."""
    B, H, G, S, D = q.shape
    T = k.shape[2]
    qp, kp, vp = split_bf16(q), split_bf16(k), split_bf16(v)
    mask = visible_mask(q_positions, kv_positions, causal=causal,
                        window=window)[:, None, None]          # (B,1,1,S,T)
    m = torch.full((B, H, G, S), NEG_INF)
    l = torch.zeros(B, H, G, S)
    acc = torch.zeros(B, H, G, S, D)
    for t0 in range(0, T, block_k):
        tile = slice(t0, t0 + block_k)
        s = _pair_products(qp, [x[:, :, tile] for x in kp],
                           "bhgsd,bhtd->bhgst", pairs) * (1.0 / math.sqrt(D))
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[..., tile], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - safe))
        p = torch.exp(s - safe[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _pair_products(
            split_bf16(p), [x[:, :, tile] for x in vp], "bhgst,bhtd->bhgsd",
            pairs)
        m = m_new
    lsafe = torch.where(l == 0, 1.0, l)
    lse = torch.where(m <= NEG_INF / 2, NEG_INF, m + torch.log(lsafe))
    return acc / lsafe[..., None], lse


def bf16_route_limit(want: torch.Tensor,
                     abs_v_out: torch.Tensor) -> torch.Tensor:
    """Per-element limit of the bf16 prefill kernel's out against the plain
    version's ``want`` (bf16) on the same inputs. ``abs_v_out`` is the plain
    version's fp32 output with v replaced by |v|, i.e. sum_i p_i |v_i| / l.
    Two roundings differ by design: out is rounded to bf16 on both sides
    (at most one ulp apart, 2^-7 |want|), and the kernel rounds p to bf16
    before p @ v (at most 2^-8 of sum_i p_i |v_i| / l). Each term gets a
    further 2^-7 for its own rounding, and 1e-5 covers the order of the
    fp32 sums."""
    return ((1 + 2.0 ** -7) * (2.0 ** -7 * want.float().abs()
                                + 2.0 ** -8 * abs_v_out.float()) + 1e-5)


def dequant_rows(codes: torch.Tensor, scale: torch.Tensor,
                 d: int) -> torch.Tensor:
    """Codes (..., Dc) int8 and per-row scales (...) fp32 -> (..., d) fp32,
    ``codes * scale`` as the TPU kernel's ``_dequant_rows`` computes it (in
    fp32 whatever q's dtype). ``Dc == d // 2`` means nibble-packed int4."""
    if codes.shape[-1] != d:
        assert codes.shape[-1] * 2 == d, (tuple(codes.shape), d)
        codes = unpack_int4(codes)
    return codes.float() * scale[..., None]


def gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Pool (P, ps, Hkv, ...) through table (B, NP) -> the dense kernel
    layout (B, Hkv, NP * ps, ...)."""
    x = pool[table.long()]                          # (B, NP, ps, Hkv, ...)
    B, NP, ps = x.shape[:3]
    return x.reshape((B, NP * ps) + tuple(x.shape[3:])).transpose(1, 2)


def flash_decode_quant_fwd_ref(q, k_codes, k_scale, v_codes, v_scale,
                               q_positions, kv_positions, *,
                               causal: bool = True, window: int = 0,
                               softcap: float = 0.0) -> torch.Tensor:
    """Decode over a quantized cache: codes (B, Hkv, T, Dc) int8, scales
    (B, Hkv, T) fp32, dequantized in fp32, then :func:`flash_decode_fwd_ref`."""
    D = q.shape[-1]
    return _attend(q, dequant_rows(k_codes, k_scale, D),
                   dequant_rows(v_codes, v_scale, D), q_positions,
                   kv_positions, causal, window, softcap)[0]


def flash_decode_paged_fwd_ref(q, k_pages, v_pages, table, q_positions,
                               kv_positions, *, causal: bool = True,
                               window: int = 0,
                               softcap: float = 0.0) -> torch.Tensor:
    """Decode over pools (P, ps, Hkv, D) through table (B, NP): the pages
    gathered into the dense layout, then :func:`flash_decode_fwd_ref`."""
    return _attend(q, gather_pages(k_pages, table),
                   gather_pages(v_pages, table), q_positions, kv_positions,
                   causal, window, softcap)[0]


def flash_decode_paged_quant_fwd_ref(q, k_codes, k_scale, v_codes, v_scale,
                                     table, q_positions, kv_positions, *,
                                     causal: bool = True, window: int = 0,
                                     softcap: float = 0.0) -> torch.Tensor:
    """Decode over code pools (P, ps, Hkv, Dc) and scale pools (P, ps, Hkv):
    gathered, then :func:`flash_decode_quant_fwd_ref`."""
    return flash_decode_quant_fwd_ref(
        q, gather_pages(k_codes, table), gather_pages(k_scale, table),
        gather_pages(v_codes, table), gather_pages(v_scale, table),
        q_positions, kv_positions, causal=causal, window=window,
        softcap=softcap)
