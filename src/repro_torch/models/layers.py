"""Shared layers and the attention dispatch (counterpart:
``repro/models/layers.py``).

``chunked_attention`` is the single attention entry point of the dense
decoder. It routes a full causal sequence (prefill) to the flash-attention
forward kernel and every positional call (decode against the ring KV cache)
to the split-KV decode kernel. Which implementation runs follows the device
of the tensors: CUDA kernels on the card, their plain PyTorch versions on
the CPU. There is no backend knob.

The ring-cache writes update the cache in place (the reference returns new
arrays); callers own the cache they pass.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import (flash_attention_gqa_fwd,
                                                     flash_decode)

# ---------------------------------------------------------------------------
# Basic ops
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, subscripts: str) -> torch.Tensor:
    """einsum in x's (compute) dtype; the matmul accumulates in fp32."""
    return torch.einsum(subscripts, x, w.to(x.dtype))


def gated_mlp(x: torch.Tensor, wi_gate: torch.Tensor, wi_up: torch.Tensor,
              wo: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (silu(x W_g) * x W_u) W_o."""
    g = dense(x, wi_gate, "bsd,df->bsf")
    u = dense(x, wi_up, "bsd,df->bsf")
    return dense(F.silu(g) * u, wo, "bsf,fd->bsd")


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, D); positions (S,) or
    (B, S). Angles in fp32: [x1 cos - x2 sin, x2 cos + x1 sin]. ``theta``
    stays a Python scalar (a kernel argument): a tensor made from it would
    be a host-to-device copy that waits for the queued work."""
    half = x.shape[-1] // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, exps)
    ang = positions[..., None].float() * freq           # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def slot_isfinite(logits: torch.Tensor) -> torch.Tensor:
    """(B, ..., V) logits -> (B,) bool: every logit of the slot is finite."""
    return torch.isfinite(logits.reshape(logits.shape[0], -1)).all(dim=-1)


# ---------------------------------------------------------------------------
# Ring KV cache: slot p % T holds position p; position -1 marks an empty slot
# ---------------------------------------------------------------------------
def ring_cache_update(cache: torch.Tensor, new: torch.Tensor,
                      slot: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, S, ...) into ``cache`` (B, T, ...) at per-row slots,
    in place; ``slot`` is (B,) for S == 1 or (B, S). Returns ``cache``."""
    s = slot.long()
    if s.dim() == 1:
        s = s[:, None]
    b = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[b, s] = new.to(cache.dtype)
    return cache


def ring_cache_store(k: torch.Tensor, total: int,
                     cache_len: int) -> torch.Tensor:
    """The last min(total, cache_len) positions of ``k`` (B, S, ...) placed in
    a cache_len-slot ring so that slot p % cache_len holds position p; unused
    slots are zero."""
    S, T = total, cache_len
    keep = min(S, T)
    kk = k[:, S - keep:]
    if T > keep:
        pad = kk.new_zeros((kk.shape[0], T - keep) + tuple(kk.shape[2:]))
        kk = torch.cat([kk, pad], dim=1)
    shift = (S - keep) % T
    return torch.roll(kk, shift, dims=1) if shift else kk.contiguous()


def ring_position_ids(batch: int, total: int, cache_len: int,
                      device=None) -> torch.Tensor:
    """(batch, cache_len) absolute positions matching ``ring_cache_store``'s
    layout after a ``total``-token prefill; empty slots hold -1."""
    keep = min(total, cache_len)
    ids = torch.cat([
        torch.arange(total - keep, total, dtype=torch.int32, device=device),
        torch.full((cache_len - keep,), -1, dtype=torch.int32, device=device)])
    shift = (total - keep) % cache_len
    if shift:
        ids = torch.roll(ids, shift)
    return ids[None].repeat(batch, 1)


def _decode_positions(q_offset, kv_positions, kv_valid_len, B: int, S: int,
                      T: int, device):
    """Per-sequence (B, S) q positions and (B, T) kv positions for the decode
    kernel; kv_valid_len folds into the -1 sentinel."""
    q_off = torch.as_tensor(q_offset, dtype=torch.int32,
                            device=device).expand(B)
    q_pos = q_off[:, None] + torch.arange(S, dtype=torch.int32,
                                          device=device)[None, :]
    if kv_positions is None:
        kv_pos = torch.arange(T, dtype=torch.int32, device=device).expand(B, T)
    else:
        kv_pos = kv_positions.to(torch.int32).expand(B, T)
    if kv_valid_len is not None:
        valid = torch.as_tensor(kv_valid_len, dtype=torch.int32,
                                device=device).expand(B)
        kv_pos = torch.where(kv_pos < valid[:, None], kv_pos,
                             torch.full_like(kv_pos, -1))
    return q_pos.contiguous(), kv_pos.contiguous()


def chunked_attention(
    q: torch.Tensor,                    # (B, S, Hq, D)
    k: torch.Tensor,                    # (B, T, Hkv, D)
    v: torch.Tensor,                    # (B, T, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_positions: Optional[torch.Tensor] = None,   # (T,) or (B, T)
    kv_valid_len=None,
    attn_softcap: float = 0.0,
) -> torch.Tensor:
    """Attention with online softmax over contiguous k/v. A full sequence
    from position 0 (prefill) goes to the flash-attention forward kernel;
    every positional call (decode) goes to the split-KV decode kernel."""
    if not (isinstance(k, torch.Tensor) and isinstance(v, torch.Tensor)):
        raise NotImplementedError(
            "quantized or paged k/v caches are ported in a later slice")
    B, S, _, _ = q.shape
    T = k.shape[1]
    if (kv_positions is None and kv_valid_len is None and S > 1
            and isinstance(q_offset, int) and q_offset == 0):
        out, _ = flash_attention_gqa_fwd(q, k, v, causal=causal, window=window,
                                         softcap=attn_softcap)
        return out
    q_pos, kv_pos = _decode_positions(q_offset, kv_positions, kv_valid_len,
                                      B, S, T, q.device)
    return flash_decode(q, k, v, q_pos, kv_pos, causal=causal, window=window,
                        softcap=attn_softcap)
