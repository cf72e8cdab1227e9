"""ctypes wrapper of the block-scaled int8 matmul CUDA kernel.

Replaces the TPU kernel ``quant_matmul_kernel`` of
``repro/kernels/quant_matmul/kernel.py`` (``:43``) with its contract: x
``(M, K)`` fp32 or bf16, codes ``(K, N)`` int8, scales ``(K // bk, N)``
fp32 -> ``(M, N)`` fp32, where ``bm, bn, bk = min(block_m, M),
min(block_n, N), min(block_k, K)`` must divide M, N and K (the reference's
asserts, ``ValueError`` here on any device). ``block_k`` fixes the scale
granularity; ``block_m`` and ``block_n`` are the reference's tiles and only
constrain the shapes: the CUDA tiles are the port's own (:func:`plan`).

The CUDA source is ``csrc/quant_matmul.cu``: per k-block an fp32 partial
product, then ``acc += partial * scale``, as the TPU kernel computes, with
the products on the tensor cores (``wgmma``) in bf16: the codes are exact
in bf16 and an fp32 x is split into three bf16 parts whose sum is x, so
every product is exact and only the order of the sums departs from fp32
(``ref.quant_matmul_route_ref`` emulates the route). M above 64 takes the
"wide" route (128 x 128 output tiles); M up to 64 the "narrow" one, which
swaps the operands and splits K over blocks, merged by a second launch in
split order, so two calls on the same inputs give the same bits.

Bound on the H100: the route's tensor work (three bf16 passes for an fp32
x, one for a bf16 x) at prefill shapes, bytes at decode shapes
(``chip_smoke.py`` computes both, and the fp32 CUDA-core bound beside).

:func:`quant_matmul_kernel` launches the kernel or raises: on a tensor that
is not on the card, of another dtype, or not contiguous. ``ops.py``
chooses between it and the plain version by the device of x. ``LAUNCHES``
counts launches, one per call that launches (the merge of a split call is
part of it).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES: Dict[str, int] = {"quant_matmul": 0}
X_DTYPES = (torch.float32, torch.bfloat16)

# the kernel's tiles (csrc/quant_matmul.cu): k is staged KT rows at a time,
# a k-block of bk rows in ceil(bk / KT) stages
KT = 64
WIDE_BM, WIDE_BN = 128, 128
NARROW_MAX_M = 64            # M up to this takes the swapped (narrow) route
NARROW_BN = 64               # codes columns a block: the wgmma's 64 rows
NARROW_MP = (8, 16, 32, 64)  # x rows padded to the wgmma's n
TARGET_BLOCKS = 2 * 132      # narrow route: two blocks an SM stream codes
SMEM_LIMIT = 232448          # bytes a block may use on the H100 (227 KB)


class QmmPlan(NamedTuple):
    """How the kernel covers an (M, N, K) product with k-blocks of bk.

    ``route`` "wide": a pre-pass writes x's bf16 ``parts`` (three for an
    fp32 x, one for a bf16 x, skipped for a bf16 x that the TMA can read as
    it is) as ``(parts, M, kp)`` and the codes widened to bf16 as ``(kp,
    np)``, each k-block padded with zeros to a multiple of ``KT`` rows and
    N to a multiple of 8; then blocks of ``bm x bn`` outputs, a producer
    thread feeding a ``stages``-deep ring by TMA, two consumer warpgroups
    multiplying. "narrow": out^T = codes^T x^T, blocks of ``bn`` output
    columns x all ``M <= mp`` rows, the k-blocks cut into ``n_split`` runs
    on k-block boundaries (``split_kblocks``), merged in split order by a
    second launch when ``n_split > 1``; ``stages``: its ring's depth.
    ``smem``: the product's dynamic shared memory, 1024 bytes of it
    alignment slack.

    The wrapper passes the route, ``n_split`` and the buffers; ``mp``,
    ``stages`` and ``smem`` are the CUDA source's own constants
    (``NarrowSmem`` / ``WideSmem``), stated here for the CPU tests, and
    :func:`layout` reads the source's so a card test can hold the two
    equal."""
    route: str
    bm: int
    bn: int
    mp: int
    parts: int
    stages: int
    n_split: int
    blocks: int
    smem: int
    kp: int = 0
    np: int = 0


def split_kblocks(nkb: int, n_split: int, s: int) -> Tuple[int, int]:
    """The k-blocks [lo, hi) of split s (the kernel's formula)."""
    return s * nkb // n_split, (s + 1) * nkb // n_split


def plan(M: int, N: int, K: int, bk: int,
         x_dtype: torch.dtype = torch.float32) -> QmmPlan:
    """The kernel's plan; pure Python, so the CPU tests can check it."""
    esize = 4 if x_dtype == torch.float32 else 2
    parts = 3 if x_dtype == torch.float32 else 1
    nkb = K // bk
    if M <= NARROW_MAX_M:
        mp = next(m for m in NARROW_MP if M <= m)
        tiles = -(-N // NARROW_BN)
        n_split = max(1, min(nkb, -(-TARGET_BLOCKS // tiles)))
        stages = 8 if mp <= 16 else 4
        smem = (stages * (KT * NARROW_BN + mp * KT * esize + 8)
                + KT * NARROW_BN * 2 + parts * mp * KT * 2 + 1024)
        return QmmPlan("narrow", mp, NARROW_BN, mp, parts, stages, n_split,
                       tiles * n_split, smem)
    tiles = -(-M // WIDE_BM) * -(-N // WIDE_BN)
    stages = 3 if parts == 3 else 5
    # a stage: x's parts and the codes, 128 rows of KT bf16 each; a full and
    # an empty mbarrier a stage
    smem = stages * (parts + 1) * WIDE_BM * KT * 2 + 16 * stages + 1024
    kp = nkb * -(-bk // KT) * KT
    return QmmPlan("wide", WIDE_BM, WIDE_BN, 0, parts, stages, 1, tiles,
                   smem, kp, -(-N // 8) * 8)

_P = ctypes.c_void_p
_I = ctypes.c_int
_bound = False


def _lib() -> ctypes.CDLL:
    global _bound
    lib = build.library("quant_matmul")
    if not _bound:
        lib.repro_quant_matmul.argtypes = [_P] * 7 + [_I] * 7 + [_P]
        lib.repro_quant_matmul.restype = _I
        lib.repro_quant_matmul_layout.argtypes = [_I, _I, _P]
        lib.repro_quant_matmul_layout.restype = None
        _bound = True
    return lib


def layout(M: int, x_dtype: torch.dtype) -> Tuple[int, int, int]:
    """(mp, stages, smem) of the product that M rows of x launch, as the
    CUDA source defines them (builds the library)."""
    out = (ctypes.c_int * 3)()
    _lib().repro_quant_matmul_layout(M, int(x_dtype == torch.bfloat16), out)
    return tuple(out)


def check_quant_matmul(x: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, *, block_m: int = 128,
                       block_n: int = 128, block_k: int = 128) -> int:
    """The reference's shape contract; returns the scale granularity bk."""
    if x.dim() != 2 or codes.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"expected x (M, K), codes (K, N), scales (nkb, N); "
                         f"got {tuple(x.shape)}, {tuple(codes.shape)}, "
                         f"{tuple(scales.shape)}")
    (M, K), (K2, N) = x.shape, codes.shape
    if K != K2:
        raise ValueError(f"x {tuple(x.shape)} and codes {tuple(codes.shape)} "
                         "disagree on K")
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if bm < 1 or bn < 1 or bk < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"(M, N, K) = ({M}, {N}, {K}) must be multiples of "
                         f"the blocks ({bm}, {bn}, {bk})")
    if tuple(scales.shape) != (K // bk, N):
        raise ValueError(f"scales {tuple(scales.shape)}: expected "
                         f"({K // bk}, {N}) for block_k {bk}")
    return bk


def quant_matmul_kernel(x: torch.Tensor, codes: torch.Tensor,
                        scales: torch.Tensor, *, block_m: int = 128,
                        block_n: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """(M, N) fp32 of x @ codes with per-(k-block, column) scales, on the
    card."""
    bk = check_quant_matmul(x, codes, scales, block_m=block_m,
                            block_n=block_n, block_k=block_k)
    for name, t, dtypes in (("x", x, X_DTYPES), ("codes", codes, (torch.int8,)),
                            ("scales", scales, (torch.float32,))):
        if t.device.type != "cuda":
            raise ValueError(f"{name} on {t.device}: the CUDA kernel takes "
                             "tensors on the card")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} is {t.dtype}: the CUDA kernel takes "
                            f"{dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({x.device, codes.device, scales.device}) != 1:
        raise ValueError(f"x on {x.device}, codes on {codes.device}, scales "
                         f"on {scales.device}")
    (M, K), N = x.shape, codes.shape[1]
    p = plan(M, N, K, bk, x.dtype)
    dev = x.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    scratch = xp = cw = None
    if p.n_split > 1:
        scratch = torch.empty((p.n_split, M, N), dtype=torch.float32,
                              device=dev)
    if p.route == "wide":
        cw = torch.empty((p.kp, p.np), dtype=torch.bfloat16, device=dev)
        if not (x.dtype == torch.bfloat16 and bk % KT == 0
                and x.data_ptr() % 16 == 0):
            xp = torch.empty((p.parts, M, p.kp), dtype=torch.bfloat16,
                             device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    err = lib.repro_quant_matmul(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        ptr(scratch), ptr(xp), ptr(cw), M, N, K, bk,
        int(x.dtype == torch.bfloat16), int(p.route == "narrow"), p.n_split,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    return out
