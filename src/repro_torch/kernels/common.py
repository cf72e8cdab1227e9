"""Shared kernel utilities (counterpart: ``repro/kernels/common.py``): the
KV-cache quantization and speculative-decoding mode names and their
validators (the reference reads the same values from ``REPRO_KV_QUANT``,
``REPRO_SPEC_DECODE``, ``REPRO_SPEC_K`` and ``REPRO_SPEC_DRAFT_LAYERS``; the
port takes them as arguments), the int4 nibble pack/unpack pair, and the
exact bf16 split of fp32 values that the tensor-core routes of
``quant_matmul`` and of the fp32 prefill kernel state in their plain
emulations."""
from __future__ import annotations

from typing import Tuple

import torch

KV_QUANT_MODES = ("off", "int8", "int4", "auto")
SPEC_DECODE_MODES = ("off", "ngram", "draft")
SPEC_K_DEFAULT = 3


def check_kv_quant(mode: str) -> str:
    """``mode`` if it names a KV-cache representation, else ValueError."""
    if mode not in KV_QUANT_MODES:
        raise ValueError(f"kv_quant={mode!r}: expected one of {KV_QUANT_MODES}")
    return mode


def check_spec_decode(mode: str) -> str:
    """``mode`` if it names a speculative-decoding drafter (``off``,
    ``ngram``: n-gram lookup over the slot's history, ``draft``: layer-skip
    self-drafting), else ValueError."""
    if mode not in SPEC_DECODE_MODES:
        raise ValueError(f"spec={mode!r}: expected one of {SPEC_DECODE_MODES}")
    return mode


def check_spec_k(k: int) -> int:
    """The draft length k (each iteration verifies a (k + 1)-token block)
    if it is a positive int, else ValueError."""
    if int(k) != k or k < 1:
        raise ValueError(f"spec_k={k!r}: expected a positive int")
    return int(k)


def check_draft_layers(n: int) -> int:
    """The ``draft`` mode's layer budget (0 = half the target's layers, at
    least one) if it is a non-negative int, else ValueError."""
    if int(n) != n or n < 0:
        raise ValueError(f"draft_layers={n!r}: expected a non-negative int")
    return int(n)


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


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """fp32 x -> bf16 (hi, mid, lo) with hi + mid + lo == x exactly, for
    2^-110 <= |x| and |x| below where bf16(x) rounds to infinity (about
    3.39e38), and for 0; hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
    hi - mid), each difference exact in fp32. Below 2^-110 lo can fall
    among bf16's subnormals and lose bits."""
    x = x.float()
    hi = x.bfloat16()
    r = x - hi.float()
    mid = r.bfloat16()
    lo = (r - mid.float()).bfloat16()
    return hi, mid, lo
