"""Shared layers and the attention dispatch (counterpart:
``repro/models/layers.py``).

``chunked_attention`` is the single attention entry point of the dense
decoder. It routes a full causal sequence (prefill) to the flash-attention
forward kernel and every positional call (decode against the KV cache) to
the split-KV decode kernel of the cache's layout: contiguous ring, Proteus
int8/int4 codes (:class:`QKVCache`), pages (:class:`PagedKVCache`), or
quantized pages. Which implementation runs follows the device of the
tensors: CUDA kernels on the card, their plain PyTorch versions on the CPU.
There is no backend knob, and the layout comes from explicit ``mode`` /
``page_size`` arguments, not from the environment.

The cache writes update the cache in place (the reference returns new
arrays); callers own the cache they pass.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.proteus import required_bits_float
from repro_torch.kernels.common import check_kv_quant, div_by, pack_int4
from repro_torch.kernels.flash_attention.ops import (flash_attention_gqa_fwd,
                                                     flash_decode,
                                                     flash_decode_paged,
                                                     flash_decode_paged_quant,
                                                     flash_decode_quant)
from repro_torch.kernels.flash_attention.autograd import flash_attention_train
from repro_torch.kernels.flash_attention.ref import dequant_rows, gather_pages

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


# ---------------------------------------------------------------------------
# Proteus-quantized KV cache (kv_quant = off | int8 | int4 | auto)
#
# Decode streams the whole KV cache once per generated token, so its bytes
# set the per-token time. K/V rows are stored as block-scaled int8 codes
# (int4: two codes per byte) with one fp32 scale per (slot, kv head) row
# (block = head_dim); the decode kernel dequantizes in fp32 after the load.
# ``auto`` keeps int8 storage and picks the grid per tensor from
# ``required_bits_float``: uniform-magnitude tensors take the int4 grid,
# spiky ones the int8 grid.
# ---------------------------------------------------------------------------
# auto mode's error target (per-element error vs the block's mean |x|):
# the loosest target at which the int4 grid is ever chosen while
# gaussian-crest rows still take the int8 grid
KV_QUANT_RTOL = 0.1

# worst |output| deviation vs the bf16 cache for unit-normal q/k/v
KV_ERROR_BUDGET = {"int8": 0.05, "int4": 0.25, "auto": 0.05}


@dataclass
class QKVCache:
    """Quantized KV-cache leaf: ``codes`` int8 ``(..., T, H, Dc)`` with
    ``Dc = D`` (int8/auto) or ``D // 2`` (nibble-packed int4), ``scale``
    fp32 ``(..., T, H)``."""

    codes: torch.Tensor
    scale: torch.Tensor

    @property
    def kv_len(self) -> int:
        return self.codes.shape[-3]

    @property
    def num_heads(self) -> int:
        return self.codes.shape[-2]

    def __getitem__(self, i) -> "QKVCache":
        return QKVCache(self.codes[i], self.scale[i])


def _kv_qmax(x: torch.Tensor, mode: str):
    if mode == "int8":
        return 127.0
    if mode == "int4":
        return 7.0
    # auto: one grid for the whole tensor, from its worst head_dim row; a
    # 0-d device tensor, so choosing costs no host sync
    bits = required_bits_float(x, block=x.shape[-1], rtol=KV_QUANT_RTOL)
    return torch.where(bits <= 4, 7.0, 127.0)


def kv_quantize(x: torch.Tensor, mode: str) -> QKVCache:
    """Symmetric per-row quantization of ``x`` (..., T, H, D): round half to
    even, clip to [-qmax - 1, qmax]; an all-zero row gets scale 1."""
    xf = x.float()
    qmax = _kv_qmax(xf, check_kv_quant(mode))
    maxabs = xf.abs().amax(dim=-1)
    q = div_by(maxabs, qmax) if isinstance(qmax, float) else maxabs / qmax
    scale = torch.where(maxabs == 0, torch.ones_like(maxabs), q)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -qmax - 1, qmax)
    codes = codes.to(torch.int8)
    if mode == "int4":
        codes = pack_int4(codes)
    return QKVCache(codes, scale)


def kv_dequantize(qkv: QKVCache, head_dim: int,
                  dtype=torch.float32) -> torch.Tensor:
    """``codes * scale`` in fp32 (the decode kernels' arithmetic), cast to
    ``dtype``."""
    return dequant_rows(qkv.codes, qkv.scale, head_dim).to(dtype)


# ---------------------------------------------------------------------------
# Paged KV cache (page_size > 0, block-table layout)
#
# One pool of fixed-size pages per leaf plus a per-slot int32 page table, so
# device memory committed to KV follows the tokens held, not slots x
# max_len. Physical page 0 is the trash page: unused and retired table rows
# point there, their writes land there, and its rows are always read
# masked.
# ---------------------------------------------------------------------------
TRASH_PAGE = 0


@dataclass
class PagedKVCache:
    """Paged KV-cache leaf: ``pages`` is the pool, a tensor
    ``(..., P, ps, H, D)`` or a :class:`QKVCache` of pooled codes and
    scales, and ``table`` int32 ``(..., B, NP)`` maps each slot's logical
    page to a pool row (0 = trash page). Leading dims (layers) are shared by
    pool and table."""

    pages: Union[torch.Tensor, QKVCache]
    table: torch.Tensor

    @property
    def _pool(self) -> torch.Tensor:
        return (self.pages.codes if isinstance(self.pages, QKVCache)
                else self.pages)

    @property
    def page_size(self) -> int:
        return self._pool.shape[-3]

    @property
    def num_pages(self) -> int:
        """Physical pool capacity P (the trash page included)."""
        return self._pool.shape[-4]

    @property
    def kv_len(self) -> int:
        """Logical per-slot capacity T = NP * page_size."""
        return self.table.shape[-1] * self.page_size

    @property
    def num_heads(self) -> int:
        return self._pool.shape[-2]

    def __getitem__(self, i) -> "PagedKVCache":
        return PagedKVCache(self.pages[i], self.table[i])


KVLeaf = Union[torch.Tensor, QKVCache, PagedKVCache]


def aligned_cache_len(n: int, page_size: int = 0) -> int:
    """``n`` rounded up to a whole number of pages (identity when not
    paged), so that the ring slot ``pos % T`` maps onto logical pages."""
    return n if page_size <= 0 else -(-n // page_size) * page_size


def _identity_table(batch: int, n_pages: int, lead: Tuple[int, ...] = (),
                    device=None) -> torch.Tensor:
    """Slot b's logical page i -> pool row 1 + b * NP + i (row 0 stays the
    trash page)."""
    t = (1 + torch.arange(batch * n_pages, dtype=torch.int32,
                          device=device)).reshape(batch, n_pages)
    return t.expand(lead + (batch, n_pages)).contiguous()


def paged_from_ring(ring: torch.Tensor, page_size: int,
                    mode: str = "off") -> PagedKVCache:
    """A ring cache ``(B, T, H, D)`` as a :class:`PagedKVCache`: slot b's
    pages at pool rows 1 + b * NP .. with the identity table."""
    B, T = ring.shape[:2]
    npg = T // page_size
    q = ring if check_kv_quant(mode) == "off" else kv_quantize(ring, mode)

    def to_pool(x):                     # (B, T, ...) -> (1 + B*NP, ps, ...)
        px = x.reshape((B * npg, page_size) + tuple(x.shape[2:]))
        return torch.cat([torch.zeros_like(px[:1]), px])

    pages = (QKVCache(to_pool(q.codes), to_pool(q.scale))
             if isinstance(q, QKVCache) else to_pool(q))
    return PagedKVCache(pages, _identity_table(B, npg, device=ring.device))


def paged_gather(cache: PagedKVCache) -> Union[torch.Tensor, QKVCache]:
    """The dense ``(B, T, H, D)`` layout (a tensor or a :class:`QKVCache`)
    of a paged cache, gathered through its table."""
    def g(pool):
        return gather_pages(pool, cache.table).transpose(1, 2)

    if isinstance(cache.pages, QKVCache):
        return QKVCache(g(cache.pages.codes), g(cache.pages.scale))
    return g(cache.pages)


def kv_zeros(shape: Tuple[int, ...], dtype, mode: str,
             device=None) -> Union[torch.Tensor, QKVCache]:
    """Zeros of logical shape ``(..., H, D)``: a tensor, or codes and
    scales."""
    if check_kv_quant(mode) == "off":
        return torch.zeros(shape, dtype=dtype, device=device)
    dc = shape[-1] // 2 if mode == "int4" else shape[-1]
    return QKVCache(
        torch.zeros(shape[:-1] + (dc,), dtype=torch.int8, device=device),
        torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def kv_cache_init(shape: Tuple[int, ...], dtype, mode: str = "off",
                  page_size: int = 0, device=None) -> KVLeaf:
    """Zeros KV-cache leaf of logical shape ``(..., B, T, H, D)``: a tensor
    or a :class:`QKVCache`, wrapped in a :class:`PagedKVCache` (identity
    table, one more page for the trash page) when ``page_size > 0``."""
    if page_size > 0:
        lead, (B, T, H, D) = tuple(shape[:-4]), tuple(shape[-4:])
        if T % page_size:
            raise ValueError(f"paged cache_len {T} is not a multiple of page "
                             f"size {page_size}; size it with "
                             "aligned_cache_len")
        npg = T // page_size
        pages = kv_zeros(lead + (B * npg + 1, page_size, H, D), dtype, mode,
                         device)
        return PagedKVCache(pages, _identity_table(B, npg, lead, device))
    return kv_zeros(tuple(shape), dtype, mode, device)


def kv_cache_axes(axes: Tuple, mode: str = "off", page_size: int = 0):
    """The logical axes of a leaf of :func:`kv_cache_init`'s structure
    (``axes`` name its dims ``(..., B, T, H, D)``): the tuple itself, a
    :class:`QKVCache` of the codes' axes and the scales' (the last dropped),
    or a :class:`PagedKVCache` whose pool has no batch axis (pages are shared
    by the slots: ``cache_pages``, ``cache_page_seq``, H, D) and whose table
    keeps the slot axis."""
    axes = tuple(axes)
    quant = check_kv_quant(mode) != "off"
    if page_size > 0:
        lead = axes[:-4]
        pool = lead + ("cache_pages", "cache_page_seq") + axes[-2:]
        pages = QKVCache(pool, pool[:-1]) if quant else pool
        return PagedKVCache(pages, lead + (axes[-4], "cache_pages"))
    return QKVCache(axes, axes[:-1]) if quant else axes


def kv_cache_store(k: torch.Tensor, total: int, cache_len: int,
                   mode: str = "off", page_size: int = 0) -> KVLeaf:
    """Prefill store: ring-place, then quantize and/or page."""
    ring = ring_cache_store(k, total, cache_len)
    if page_size > 0:
        return paged_from_ring(ring, page_size, mode)
    return ring if check_kv_quant(mode) == "off" else kv_quantize(ring, mode)


def paged_last_writers(cache: KVLeaf, slot: torch.Tensor
                       ) -> Optional[torch.Tensor]:
    """For a paged leaf, the (B * S,) index of the row, in (b, s) order,
    whose write a sequential scatter (the reference's on the CPU) leaves at
    each row's destination ``pool[table[b, slot // ps], slot % ps]``: the
    row's own, except where rows collide on the trash page, where it is the
    last of them. Gathering the rows by it before :func:`kv_cache_update`
    makes what the trash page holds independent of the order the card runs
    the writes in. None for a leaf that is not paged. Rows of a dense model
    never read another row's trash; an MoE model's free slots read it back
    and take expert capacity beside the live ones."""
    if not isinstance(cache, PagedKVCache):
        return None
    ps = cache.page_size
    s = slot.long()
    if s.dim() == 1:
        s = s[:, None]
    b = torch.arange(cache.table.shape[-2], device=s.device)[:, None]
    dest = (cache.table[b, s // ps].long() * ps + s % ps).flatten()
    rows = torch.arange(dest.numel(), device=dest.device)
    return torch.where(dest[:, None] == dest[None, :], rows, -1).amax(1)


def kv_cache_update(cache: KVLeaf, new: torch.Tensor, slot: torch.Tensor,
                    mode: str = "off") -> KVLeaf:
    """Write ``new`` (B, S, H, D) at ring slots ``slot`` ((B,) for S == 1,
    or (B, S)), in place: quantized row-wise first when the cache holds
    codes; through the table into ``pool[table[b, slot // ps], slot % ps]``
    when it is paged (rows whose table entry is the trash page collide
    there: :func:`paged_last_writers`). Returns ``cache``."""
    if isinstance(cache, PagedKVCache):
        ps = cache.page_size
        s = slot.long()
        if s.dim() == 1:
            s = s[:, None]
        b = torch.arange(cache.table.shape[-2], device=s.device)[:, None]
        phys = cache.table[b, s // ps].long()         # (B, S)
        off = s % ps
        pages = cache.pages
        if isinstance(pages, QKVCache):
            q = kv_quantize(new, mode)
            pages.codes[phys, off] = q.codes
            pages.scale[phys, off] = q.scale
        else:
            pages[phys, off] = new.to(pages.dtype)
        return cache
    if isinstance(cache, QKVCache):
        q = kv_quantize(new, mode)
        ring_cache_update(cache.codes, q.codes, slot)
        ring_cache_update(cache.scale, q.scale, slot)
        return cache
    return ring_cache_update(cache, new, slot)


def kv_cache_len(cache: KVLeaf) -> int:
    """Logical per-slot capacity T of a (stacked, quantized, paged) leaf."""
    if isinstance(cache, PagedKVCache):
        return cache.kv_len
    return (cache.codes if isinstance(cache, QKVCache) else cache).shape[-3]


def kv_cast(cache: KVLeaf, dtype) -> KVLeaf:
    """``cache.to(dtype)`` for a tensor; codes and scales pass unchanged
    (the decode kernels read them directly); into the pool when paged."""
    if isinstance(cache, PagedKVCache):
        return PagedKVCache(kv_cast(cache.pages, dtype), cache.table)
    return cache if isinstance(cache, QKVCache) else cache.to(dtype)


def stack_kv(leaves: List[KVLeaf]) -> KVLeaf:
    """Stack per-layer leaves of one structure along a new leading axis."""
    first = leaves[0]
    if isinstance(first, PagedKVCache):
        return PagedKVCache(stack_kv([l.pages for l in leaves]),
                            torch.stack([l.table for l in leaves]))
    if isinstance(first, QKVCache):
        return QKVCache(torch.stack([l.codes for l in leaves]),
                        torch.stack([l.scale for l in leaves]))
    return torch.stack(leaves)


def _decode_positions(q_offset, kv_positions, kv_valid_len, B: int, S: int,
                      T: int, device):
    """Per-sequence (B, S) q positions and (B, T) kv positions for the decode
    kernel; kv_valid_len folds into the -1 sentinel. A Python int offset
    (the cross-attention's 0) is added on the device: a tensor made from
    it would be a host-to-device copy, which a CUDA graph capture
    refuses."""
    steps = torch.arange(S, dtype=torch.int32, device=device)
    if isinstance(q_offset, int):
        q_pos = (steps + q_offset).expand(B, S)
    else:
        q_off = q_offset.to(device=device, dtype=torch.int32).expand(B)
        q_pos = q_off[:, None] + steps[None, :]
    if kv_positions is None:
        kv_pos = torch.arange(T, dtype=torch.int32, device=device).expand(B, T)
    else:
        kv_pos = kv_positions.to(torch.int32).expand(B, T)
    if kv_valid_len is not None:
        valid = (kv_valid_len if isinstance(kv_valid_len, int) else
                 kv_valid_len.to(device=device, dtype=torch.int32)
                 .expand(B)[:, None])
        kv_pos = torch.where(kv_pos < valid, kv_pos,
                             torch.full_like(kv_pos, -1))
    return q_pos.contiguous(), kv_pos.contiguous()


def chunked_attention(
    q: torch.Tensor,                    # (B, S, Hq, D)
    k: KVLeaf,                          # (B, T, Hkv, D), QKVCache or paged
    v: KVLeaf,                          # the same structure as k
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: Union[int, torch.Tensor] = 0,
    kv_positions: Optional[torch.Tensor] = None,   # (T,) or (B, T)
    kv_valid_len=None,
    attn_softcap: float = 0.0,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
) -> torch.Tensor:
    """Attention with online softmax. A full sequence from position 0 over
    plain k/v (prefill) goes to the flash-attention forward kernel; every
    positional call (decode) goes to the split-KV decode kernel of the
    cache's layout, which reads codes, scales and pages as they are stored.
    A full sequence that needs gradients (training) goes through the kernel
    under autograd (``flash_attention_train``), padded to the ``chunk_q`` /
    ``chunk_kv`` tiles of its plain backward as the reference pads it."""
    if not isinstance(k, (torch.Tensor, QKVCache, PagedKVCache)):
        raise TypeError(f"unsupported KV cache leaf {type(k).__name__}")
    if type(k) is not type(v):
        raise TypeError(f"k is a {type(k).__name__}, v a {type(v).__name__}")
    B, S, _, _ = q.shape
    T = kv_cache_len(k)
    dense_kv = isinstance(k, torch.Tensor)
    if (dense_kv and kv_positions is None and kv_valid_len is None and S > 1
            and isinstance(q_offset, int) and q_offset == 0):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention_train(q, k, v, causal=causal,
                                         window=window, softcap=attn_softcap,
                                         chunk_q=chunk_q, chunk_kv=chunk_kv)
        out, _ = flash_attention_gqa_fwd(q, k, v, causal=causal, window=window,
                                         softcap=attn_softcap)
        return out
    q_pos, kv_pos = _decode_positions(q_offset, kv_positions, kv_valid_len,
                                      B, S, T, q.device)
    kw = dict(causal=causal, window=window, softcap=attn_softcap)
    if isinstance(k, PagedKVCache):
        if isinstance(k.pages, QKVCache):
            return flash_decode_paged_quant(
                q, k.pages.codes, k.pages.scale, v.pages.codes, v.pages.scale,
                k.table, q_pos, kv_pos, **kw)
        return flash_decode_paged(q, k.pages, v.pages, k.table, q_pos, kv_pos,
                                  **kw)
    if isinstance(k, QKVCache):
        return flash_decode_quant(q, k.codes, k.scale, v.codes, v.scale,
                                  q_pos, kv_pos, **kw)
    return flash_decode(q, k, v, q_pos, kv_pos, **kw)


# ---------------------------------------------------------------------------
# Cross-entropy
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in fp32 (float64 for float64 logits).
    logits (B, S, V) of any float dtype; labels (B, S); ``mask`` (B, S)
    weights each position (the mean is over its sum, at least 1)."""
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
