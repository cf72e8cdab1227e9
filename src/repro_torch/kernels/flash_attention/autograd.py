"""The flash-attention forward kernel under autograd (counterpart:
``flash_attention_pallas`` and its VJP, ``repro/models/layers.py:974-995``,
with the backward ``_flash_vjp_bwd``, ``:864-944``).

Training runs the prefill kernel forward (``ops.flash_attention_gqa_fwd``:
the bf16 route for bf16 compute, the fp32 route for fp32, both in
``csrc/flash_prefill.cu``) and saves ``(q, k, v, out, lse)``. The backward
recomputes from them in plain PyTorch, in fp32, tile by tile as the
reference's jnp backward does: ``delta = rowsum(do * o)``; per (q-chunk,
kv-chunk) tile ``p = exp(s - lse)`` masked, ``dv += p^T do``,
``dp = do v^T``, ``ds = p (dp - delta)`` (times the softcap's derivative),
``dq += ds k``, ``dk += ds^T q``, every tile visited (the reference's
``block_skip`` is off on this path). The reference computes its backward
with jnp outside any Pallas kernel, so there is no TPU kernel to port
there.

:func:`flash_attention_train` is the train branch of the reference's
``chunked_attention``: q padded to a multiple of ``cq = min(chunk_q, S)``,
k and v to one of ``ck = min(chunk_kv, T)``, the padded kv rows masked by a
``kv_len`` (their positions -1), the output sliced back to S.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention_gqa_fwd
from repro_torch.kernels.flash_attention.ref import NEG_INF


def _tile_mask(q_pos: torch.Tensor, j: int, ck: int, causal: bool,
               window: int, kv_len: int) -> torch.Tensor:
    """(cq, ck) bool of kv tile ``j`` (the reference's ``_flash_mask``)."""
    k_pos = j * ck + torch.arange(ck, dtype=torch.int32, device=q_pos.device)
    mask = torch.ones((q_pos.shape[0], ck), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    if kv_len > 0:
        mask = mask & (k_pos < kv_len)[None, :]
    return mask


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal: bool,
                            window: int, softcap: float, cq: int, ck: int,
                            kv_len: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The recompute backward in plain PyTorch. q, out, do
    ``(B, S, Hkv, G, D)``; k, v ``(B, T, Hkv, D)``; lse ``(B, Hkv, G, S)``
    (the kernel's layout, viewed as the reference's ``(B, Hkv, G, nq,
    cq)``); S % cq == 0 and T % ck == 0. Returns (dq, dk, dv) in the
    inputs' dtypes, accumulated in fp32 (float64 for float64 inputs)."""
    B, S, Hkv, G, D = q.shape
    T = k.shape[1]
    nq, nk = S // cq, T // ck
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    lse5 = lse.to(acc).reshape(B, Hkv, G, nq, cq)
    # delta = rowsum(do * o): (B, S, K, G)
    delta = (dof * out.to(acc)).sum(-1)
    dq = torch.empty((B, S, Hkv, G, D), dtype=acc, device=q.device)
    dk = torch.zeros((B, T, Hkv, D), dtype=acc, device=q.device)
    dv = torch.zeros((B, T, Hkv, D), dtype=acc, device=q.device)
    for i in range(nq):
        rows = slice(i * cq, (i + 1) * cq)
        qc, doc = qf[:, rows], dof[:, rows]
        lse_i = lse5[:, :, :, i]                               # (B,K,G,cq)
        dlt_i = delta[:, rows].permute(0, 2, 3, 1)             # (B,K,G,cq)
        q_pos = i * cq + torch.arange(cq, dtype=torch.int32, device=q.device)
        dq_c = torch.zeros((B, cq, Hkv, G, D), dtype=acc, device=q.device)
        for j in range(nk):
            cols = slice(j * ck, (j + 1) * ck)
            kc, vc = kf[:, cols], vf[:, cols]
            mask = _tile_mask(q_pos, j, ck, causal, window, kv_len)
            s_raw = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * scale
            s = (softcap * torch.tanh(s_raw / softcap) if softcap > 0
                 else s_raw)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse_i[..., None])                # (B,K,G,q,s)
            p = torch.where(mask, p, 0.0)
            dv_t = torch.einsum("bkgqs,bqkgd->bskd", p, doc)
            dp = torch.einsum("bqkgd,bskd->bkgqs", doc, vc)
            ds = p * (dp - dlt_i[..., None])
            if softcap > 0:
                t = torch.tanh(s_raw / softcap)
                ds = ds * (1.0 - t * t)
            dq_t = torch.einsum("bkgqs,bskd->bqkgd", ds, kc) * scale
            dk_t = torch.einsum("bkgqs,bqkgd->bskd", ds, qc) * scale
            dk[:, cols] += dk_t
            dv[:, cols] += dv_t
            dq_c = dq_c + dq_t
        dq[:, rows] = dq_c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """out = attention(q, k, v) by the prefill kernel (its plain version on
    the CPU), gradients by :func:`flash_attention_bwd_ref`. q
    ``(B, S, Hq, D)`` and k/v ``(B, T, Hkv, D)``, already padded to the
    ``cq`` / ``ck`` multiples; kv positions at or past ``kv_len`` (when
    > 0) are masked."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, softcap: float,
                cq: int, ck: int, kv_len: int):
        B, S = q.shape[:2]
        T = k.shape[1]
        kv_pos = None
        if kv_len:
            ar = torch.arange(T, dtype=torch.int32, device=q.device)
            kv_pos = torch.where(ar < kv_len, ar, -1).expand(B, T).contiguous()
        out, lse = flash_attention_gqa_fwd(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           kv_positions=kv_pos)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, softcap, cq, ck, kv_len)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap, cq, ck, kv_len = ctx.args
        B, S, Hq, D = q.shape
        Hkv = k.shape[2]
        G = Hq // Hkv
        five = lambda t: t.reshape(B, S, Hkv, G, D)
        dq, dk, dv = flash_attention_bwd_ref(
            five(q), k, v, five(out), lse, five(do), causal=causal,
            window=window, softcap=softcap, cq=cq, ck=ck, kv_len=kv_len)
        return dq.reshape(B, S, Hq, D), dk, dv, None, None, None, None, \
            None, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, chunk_q: int = 512,
                          chunk_kv: int = 1024) -> torch.Tensor:
    """Differentiable full-sequence attention from position 0: q
    ``(B, S, Hq, D)``, k/v ``(B, T, Hkv, D)`` -> ``(B, S, Hq, D)``, padded
    and chunked as the reference's ``chunked_attention`` train branch."""
    S, T = q.shape[1], k.shape[1]
    cq, ck = min(chunk_q, S), min(chunk_kv, T)
    Sp, Tp = -(-S // cq) * cq, -(-T // ck) * ck
    pad = lambda t, n: F.pad(t, (0, 0, 0, 0, 0, n - t.shape[1])) \
        if n != t.shape[1] else t
    kv_len = 0 if Tp == T else T
    out = FlashAttentionFn.apply(pad(q, Sp), pad(k, Tp), pad(v, Tp), causal,
                                 window, softcap, cq, ck, kv_len)
    return out[:, :S] if Sp != S else out
