"""ctypes wrapper of the RG-LRU recurrence CUDA kernel.

Replaces the TPU kernel ``rglru_scan_kernel`` of
``repro/kernels/rglru/kernel.py`` with its contract: a, b ``(B, T, D)``
fp32 -> h ``(B, T, D)`` fp32, ``h_t = a_t * h_{t-1} + b_t``, ``h_{-1} = 0``
(a caller with an initial state folds it into ``b[:, 0]``). The CUDA source
is ``csrc/rglru.cu``: one thread per (b, d) channel with h in a register,
the rounded multiply and add of the plain loop in time order (bit for bit
equal to it), one warp a block of 32 channels, a shared-memory ring of
time rows of a and b filled by TMA boxes and h written back as TMA boxes
(4-byte ``cp.async`` copies and stores where rows are not 16-byte
aligned); :func:`plan` lays it out.

Bound on the H100: bytes (two fp32 reads and one write per element).

:func:`rglru_scan_kernel` launches the kernel or raises: on a tensor that
is not on the card, not fp32, not contiguous or not 3-D. ``ops.rglru_scan``
chooses between it and the plain version by the device of the inputs.
``LAUNCHES`` counts launches, one per call that launches; of those, the
launches for the backward of ``autograd.RglruScanFn`` also count under
``rglru_scan_bwd``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES: Dict[str, int] = {"rglru_scan": 0, "rglru_scan_bwd": 0}

TILE = 32                    # channels a block: one warp, 128 bytes a row
ROWS = 32                    # time rows a ring stage
# the ring's depth: 3 stages in flight a block, 15.7 MB chip-wide at B 8 x
# D 2560, 3.9 MB at B 2 (deeper rings were slower there on the H100)
STAGES = 4
SMEM_LIMIT = 232448          # bytes a block may use on the H100 (227 KB)


class RglruPlan(NamedTuple):
    """Blocks of ``tile`` channels of one batch row; a shared-memory ring of
    ``stages`` stages of ``rows`` time rows of a and b, filled by TMA boxes
    where every row is 16-byte aligned (``vec`` 16), else by 4-byte
    ``cp.async`` copies (``vec`` 4); ``smem`` bytes of dynamic shared
    memory. The wrapper passes ``vec``; ``tile``, ``rows``, ``stages`` and
    ``smem`` are the CUDA source's constants, stated here for the CPU
    tests, and :func:`layout` reads the source's so a card test can hold
    the two equal."""
    tile: int
    rows: int
    stages: int
    vec: int
    blocks: int
    smem: int


def plan(B: int, T: int, D: int, aligned: bool = True) -> RglruPlan:
    """The kernel's plan; pure Python, so the CPU tests can check it."""
    blocks = B * -(-D // TILE)
    vec = 16 if aligned and D % 4 == 0 else 4
    # the ring, two h tiles, 128 bytes of alignment slack, an mbarrier a
    # stage
    smem = STAGES * ROWS * TILE * 2 * 4 + 2 * ROWS * TILE * 4 + 128 + 8 * STAGES
    return RglruPlan(TILE, ROWS, STAGES, vec, blocks, smem)


_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = build.library("rglru")
    if not _bound:
        lib.repro_rglru_scan.argtypes = [_P, _P, _P] + [_I] * 4 + [_P]
        lib.repro_rglru_scan.restype = _I
        lib.repro_rglru_layout.argtypes = [_P]
        lib.repro_rglru_layout.restype = None
        _bound = True
    return lib


def layout() -> Tuple[int, int, int, int]:
    """(tile, rows, stages, smem) as the CUDA source defines them (builds
    the library)."""
    out = (ctypes.c_int * 4)()
    _lib().repro_rglru_layout(out)
    return tuple(out)


def rglru_scan_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h (B, T, D) fp32 of the recurrence over a, b (B, T, D) fp32 on the
    card."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b (B, T, D) of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the CUDA kernel takes "
                             "tensors on the card")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the CUDA kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    B, T, D = a.shape
    h = torch.empty_like(b)
    p = plan(B, T, D,
             aligned=(a.data_ptr() | b.data_ptr() | h.data_ptr()) % 16 == 0)
    lib = _lib()
    err = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                               B, T, D, p.vec,
                               torch.cuda.current_stream(a.device).cuda_stream)
    build.check(lib, err, "rglru_scan")
    LAUNCHES["rglru_scan"] += 1
    return h
