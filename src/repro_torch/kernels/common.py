"""Shared kernel utilities (counterpart: ``repro/kernels/common.py``): the
KV-cache quantization mode names and the int4 nibble pack/unpack pair."""
from __future__ import annotations

import torch

KV_QUANT_MODES = ("off", "int8", "int4", "auto")


def check_kv_quant(mode: str) -> str:
    """``mode`` if it names a KV-cache representation, else ValueError."""
    if mode not in KV_QUANT_MODES:
        raise ValueError(f"kv_quant={mode!r}: expected one of {KV_QUANT_MODES}")
    return mode


def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """Pack int8-held int4 codes (pairs along the last axis) into one int8
    byte each: the even element in the low nibble, the odd one in the high
    nibble. Exact round trip with :func:`unpack_int4`."""
    assert v.shape[-1] % 2 == 0, v.shape
    lo = (v[..., 0::2] & 0x0F).to(torch.uint8)
    hi = (v[..., 1::2] & 0x0F).to(torch.uint8)
    return (lo | (hi << 4)).view(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: sign-extended int8 codes in [-8, 7]."""
    pu = p.view(torch.uint8)
    lo = (pu & 0x0F).to(torch.int8)
    hi = ((pu >> 4) & 0x0F).to(torch.int8)
    sx = lambda t: torch.where(t >= 8, t - 16, t)
    out = torch.stack([sx(lo), sx(hi)], dim=-1)
    return out.reshape(p.shape[:-1] + (p.shape[-1] * 2,))
