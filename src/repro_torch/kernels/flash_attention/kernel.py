"""ctypes wrappers of the flash-attention CUDA kernels.

Replaces the TPU kernels of ``repro/kernels/flash_attention/kernel.py``:
``flash_attention_fwd`` (prefill, ``kernel.py:126``) and ``flash_decode_fwd``
(decode, ``kernel.py:174``), with the same argument layout: q
``(B, Hkv, G, S, D)``, k/v ``(B, Hkv, T, D)``, ``q_positions`` ``(B, S)`` and
``kv_positions`` ``(B, T)`` int32 (-1 = masked). The CUDA source is
``csrc/flash_attention.cu``.

Bound on the H100: bytes. At the serving shapes the kernels stream q/k/v
once (decode: the whole K/V cache per launch), far below the ~295 bf16
operations per byte where the tensor cores would become the limit. The
kernels keep scores in shared memory, read each K/V tile once per kv head,
skip fully masked tiles, and split the decode kv axis over blocks so the
cache stream occupies every SM.

Selection is by the device of the inputs: CPU tensors go to the plain
versions in ``ref.py``; CUDA tensors launch the kernels or raise. Inputs may
be strided views with a contiguous last axis (the model passes its
``(B, T, Hkv, D)`` cache transposed, without a copy). ``LAUNCHES`` counts
kernel launches, one per wrapper call that launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (flash_attention_fwd_ref,
                                                     flash_decode_fwd_ref)

LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0, "flash_decode_fwd": 0}
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# decode split-KV: aim for this many blocks per launch (2 per SM on 132 SMs)
DECODE_TARGET_BLOCKS = 264
DECODE_SPLIT_MULTIPLE = 64        # the kernel's kv tile

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_STRIDES = [_L] * 10
_SHAPE = [_I] * 7                 # B, H, G, S, T, D, is_bf16
_MASK = [_I, _I, _F, _F, _P]      # causal, window, softcap, scale, stream
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = build.library("flash_attention")
    if not _bound:
        lib.repro_flash_attention_fwd.argtypes = [_P] * 7 + _STRIDES + _SHAPE + _MASK
        lib.repro_flash_attention_fwd.restype = _I
        lib.repro_flash_decode_fwd.argtypes = ([_P] * 9 + _STRIDES + _SHAPE
                                               + [_I, _I] + _MASK)
        lib.repro_flash_decode_fwd.restype = _I
        _bound = True
    return lib


def _check(q, k, v, q_positions, kv_positions) -> Tuple[int, ...]:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Hkv,G,S,D) and k/v (B,Hkv,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, G, S, D = q.shape
    T = k.shape[2]
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if tuple(q_positions.shape) != (B, S) or tuple(kv_positions.shape) != (B, T):
        raise ValueError(f"positions {tuple(q_positions.shape)}, "
                         f"{tuple(kv_positions.shape)}; expected ({B}, {S}), "
                         f"({B}, {T})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    devs = {t.device for t in (q, k, v, q_positions, kv_positions)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return B, H, G, S, T, D


def _check_cuda(q, k, v, q_positions, kv_positions, D) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the CUDA kernels take {KERNEL_HEAD_DIMS}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"dtype {q.dtype}: the CUDA kernels take {KERNEL_DTYPES}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last axis")
    for name, t in (("q_positions", q_positions), ("kv_positions", kv_positions)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")


def _operands(q, k, v, q_positions, kv_positions):
    return ([q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
             kv_positions.data_ptr()],
            [*q.stride()[:4], *k.stride()[:3], *v.stride()[:3]])


def _mask_args(causal, window, softcap, D):
    return [int(causal), int(window), float(softcap), 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill kernel: returns (out (B, Hkv, G, S, D) in q's dtype,
    lse (B, Hkv, G, S) fp32). Any S and T."""
    B, H, G, S, T, D = _check(q, k, v, q_positions, kv_positions)
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, q_positions, kv_positions,
                                       causal=causal, window=window,
                                       softcap=softcap)
    _check_cuda(q, k, v, q_positions, kv_positions, D)
    lib = _lib()
    out = torch.empty((B, H, G, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, G, S), dtype=torch.float32, device=q.device)
    ptrs, strides = _operands(q, k, v, q_positions, kv_positions)
    err = lib.repro_flash_attention_fwd(
        *ptrs, out.data_ptr(), lse.data_ptr(), *strides,
        B, H, G, S, T, D, int(q.dtype == torch.bfloat16),
        *_mask_args(causal, window, softcap, D))
    build.check(lib, err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def decode_splits(B: int, H: int, T: int) -> Tuple[int, int]:
    """(n_split, split_len) for the decode kernel: enough kv splits that
    B * H * n_split blocks fill the card, each a whole number of kv tiles.
    A function of the shapes only, so every call at one shape sums in the
    same order."""
    want = max(1, -(-DECODE_TARGET_BLOCKS // max(B * H, 1)))
    split_len = -(-max(T, 1) // want)
    split_len = -(-split_len // DECODE_SPLIT_MULTIPLE) * DECODE_SPLIT_MULTIPLE
    return -(-max(T, 1) // split_len), split_len


def flash_decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Decode kernel (flash-decoding split-KV + deterministic combine):
    returns out (B, Hkv, G, S, D) in q's dtype. Any G * S and T."""
    B, H, G, S, T, D = _check(q, k, v, q_positions, kv_positions)
    if q.device.type == "cpu":
        return flash_decode_fwd_ref(q, k, v, q_positions, kv_positions,
                                    causal=causal, window=window,
                                    softcap=softcap)
    _check_cuda(q, k, v, q_positions, kv_positions, D)
    lib = _lib()
    n_split, split_len = decode_splits(B, H, T)
    R = G * S
    out = torch.empty((B, H, G, S, D), dtype=q.dtype, device=q.device)
    pm = torch.empty((B, H, n_split, R), dtype=torch.float32, device=q.device)
    pl = torch.empty_like(pm)
    pacc = torch.empty((B, H, n_split, R, D), dtype=torch.float32,
                       device=q.device)
    ptrs, strides = _operands(q, k, v, q_positions, kv_positions)
    err = lib.repro_flash_decode_fwd(
        *ptrs, out.data_ptr(), pm.data_ptr(), pl.data_ptr(), pacc.data_ptr(),
        *strides, B, H, G, S, T, D, int(q.dtype == torch.bfloat16),
        n_split, split_len, *_mask_args(causal, window, softcap, D))
    build.check(lib, err, "flash_decode_fwd")
    LAUNCHES["flash_decode_fwd"] += 1
    return out
