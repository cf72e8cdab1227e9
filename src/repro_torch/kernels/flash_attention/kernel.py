"""ctypes wrappers of the flash-attention CUDA kernels.

Replaces the TPU kernels of ``repro/kernels/flash_attention/kernel.py`` with
their argument layouts:

* ``flash_attention_fwd`` (prefill, ``kernel.py:126``): q
  ``(B, Hkv, G, S, D)``, k/v ``(B, Hkv, T, D)``;
* ``flash_decode_fwd`` (decode, ``kernel.py:174``): the same operands, small
  S;
* ``flash_decode_quant_fwd`` (``kernel.py:262``): k/v as int8 codes
  ``(B, Hkv, T, Dc)`` (``Dc = D``, or ``D // 2`` nibble-packed int4) and
  fp32 scales ``(B, Hkv, T)``;
* ``flash_decode_paged_fwd`` (``kernel.py:359``): k/v as page pools
  ``(P, ps, Hkv, D)`` read through a table ``(B, NP)`` int32 (page 0 is the
  trash page);
* ``flash_decode_paged_quant_fwd`` (``kernel.py:443``): code pools
  ``(P, ps, Hkv, Dc)`` and scale pools ``(P, ps, Hkv)`` through the table;
* ``flash_attention_bh`` (``kernel.py:504``): the ``(BH, S, D)``
  multi-head adapter, no kernel of its own: it launches the prefill kernel
  with ``Hkv = BH`` and ``G = 1``.

``q_positions`` ``(B, S)`` and ``kv_positions`` ``(B, T)`` (``T = NP * ps``
when paged) are int32, -1 = masked. Head dims 64, 80, 112, 128 and 256 for
every kernel and layout (:data:`KERNEL_HEAD_DIMS`); any other raises
``ValueError``.

The prefill kernel has two routes, chosen by q's dtype (there is no knob),
both in ``csrc/flash_prefill.cu`` on the tensor cores (``wgmma``, fp32
accumulators and softmax):

* bf16: bf16 operands; p is rounded to bf16 before ``p @ v``. A block holds
  ``PREFILL_BLOCK_ROWS`` query rows, ``GG`` heads x ``BQ`` positions of one
  kv head, as :func:`prefill_plan` lays them out; :data:`BF16_PREFILL_TILES`
  its kv tile, ring and blocks an SM. A warp-specialised kernel (TMA loads,
  unpadded rows) runs it and stores out in the model's ``(B, S, Hkv, G,
  D)`` order: the ``(B, Hkv, G, S, D)`` out it returns is a view, and ops'
  merge of the heads copies nothing;
* fp32: q, k, v and p each as three exact bf16 parts and the six products
  of parts ``i + j <= 2`` (``ref.fp32_route_ref`` states it), which the
  fp32 parity checks hold to 2e-5; :data:`FP32_PREFILL_TILES` rows a block.
  A pre-pass splits K and V into their parts once per call, into a
  ``(6, B, Hkv, T, D)`` bf16 scratch that the wrapper allocates, and the
  product reads the parts' tiles by TMA (two launches, one count).

Every pointer and row stride of q, k and v must be 16-byte aligned on both
routes; anything else raises ``ValueError`` (nothing falls back).

The four decode wrappers launch one streaming kernel,
``csrc/flash_decode.cu``, that differs only in how it finds and decodes a
K/V row, so the paged kernels equal the dense and quantized ones on the
gathered pages bit for bit. :func:`decode_plan` lays the q rows and the kv
axis over its blocks: one-warp blocks at D 64 and 256 (a second launch
merges the splits), four-warp blocks at D 80, 112 and 128 that stream a
split once for all of a kv head's q rows and merge the splits themselves
(the last block of a kv head, by a ticket from a device's zeroed counters,
:func:`_tickets`). Every K/V pointer and row stride must be aligned to the
chunk the kernel copies a row in (:func:`copy_align`: 16 bytes, 8 for int4
rows of 40 or 56 bytes at D 80 and 112); anything else raises
``ValueError``.

Bound on the H100: decode and the bf16 prefill route are bound by bytes at
the serving shapes: they stream q and the K/V operands once (decode: the
visible cache rows per launch, as codes where the cache holds codes), below
the ~295 bf16 operations per byte where the tensor cores would become the
limit (bf16 prefill at head_dim 256 comes within 25% of it, and passes it
at Griffin's long prompt). The fp32 prefill route does six tensor passes of
the product work, which pass its bytes at every serving shape. The kernels
keep scores on chip, read each K/V tile once per block of all G heads of a
kv head, skip masked tiles (prefill) or rows (decode), and split the decode
kv axis over blocks so the cache stream occupies every SM.

Selection is by the device of the inputs: CPU tensors go to the plain
versions in ``ref.py``; CUDA tensors launch the kernels or raise; ``meta``
tensors get empty outputs under a step counter and raise outside one
(``kernels/accounting.py``). Under a counter every entry reports, once a
call, the work its function defines: ``4 D`` FLOPs (``q k`` and ``p v``)
for every (q row, kv row) pair of the shapes, masked pairs and empty cache
slots included (the positions are data; the report is the shapes', so a
``meta`` count equals the card's), and the bytes of every input read once
(a paged cache: the table's ``NP * ps`` rows a slot, not the pool) and every
output written once. Inputs may
be strided views with a contiguous last axis (the model passes its
``(B, T, Hkv, D)`` cache transposed, without a copy). ``LAUNCHES`` counts
kernel launches, one per wrapper call that launches;
``flash_attention_fwd`` counts both prefill routes and
``flash_attention_fwd_fp32`` the fp32 one alone.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import accounting, build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_fwd_ref, flash_decode_fwd_ref, flash_decode_paged_fwd_ref,
    flash_decode_paged_quant_fwd_ref, flash_decode_quant_fwd_ref)

LAUNCHES: Dict[str, int] = {
    "flash_attention_fwd": 0, "flash_attention_fwd_fp32": 0,
    "flash_decode_fwd": 0,
    "flash_decode_quant_fwd": 0, "flash_decode_paged_fwd": 0,
    "flash_decode_paged_quant_fwd": 0, "flash_attention_bh": 0,
}
KERNEL_HEAD_DIMS = (64, 80, 112, 128, 256)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_PAGE_SIZES = (8, 16, 32, 64)
# the bf16 prefill kernel's query rows per block
PREFILL_BLOCK_ROWS = 128
# the bf16 prefill route's (kv rows a tile, ring stages, blocks an SM) by
# head_dim, as csrc/flash_prefill.d<D>.cu instantiate its warp-specialised
# kernel (bf16_layout() reads the source's)
BF16_PREFILL_TILES = {64: (64, 4, 2), 80: (64, 4, 2), 112: (32, 4, 2),
                      128: (64, 4, 1), 256: (32, 4, 1)}
# the fp32 prefill kernel's (query rows a block, kv rows a tile) by
# head_dim, as csrc/flash_prefill.cu F32Tiles sets them (fp32_layout()
# reads the source's)
FP32_PREFILL_TILES = {64: (128, 128), 80: (128, 64), 112: (128, 64),
                      128: (128, 64), 256: (64, 32)}
# the byte alignment of every pointer and row stride that the prefill
# kernel (q, k, v) and the decode kernel (k, v) copy in 16-byte chunks;
# the decode kernel copies a row whose bytes are no multiple of 16 (int4
# codes at D 80 and 112: 40 and 56 bytes) in 8-byte chunks (copy_align)
COPY_ALIGN = 16
# decode at D 64 and 256: the q-row counts a one-warp block is built
# for (csrc/flash_decode.cuh NR); aim for this many blocks per launch (8
# per SM on 132 SMs); a split is a whole number of the kernel's largest
# ring stage (16 rows of int4 codes at D 64) and at most DECODE_MAX_SPLIT
# rows
DECODE_ROWS = (1, 2, 4)
DECODE_TARGET_BLOCKS = 1056
DECODE_SPLIT_MULTIPLE = 16
DECODE_MAX_SPLIT = 256
# decode at D 80, 112 and 128 (csrc/flash_decode.cuh namespace wide): a
# block of four warps streams its split once for WIDE_DECODE_ROWS q rows of
# a kv head (all of kimi-k2's 8; 2 rows run as 4, so that the library
# builds three row counts, not four); aim for 2 such blocks an SM (fewer,
# longer splits: less to merge; on an H100 kimi-k2's step ran 2.6 us
# faster than at 4), splits of whole 16-row ring stages, at most
# WIDE_DECODE_MAX_SPLIT rows. At D 64 its int8 routes ran slower than the
# one-warp kernel's on an H100, and D 256's rows overflow its static shared
# memory
WIDE_DECODE_DIMS = (80, 112, 128)
WIDE_DECODE_ROWS = (1, 4, 8)
WIDE_DECODE_TARGET_BLOCKS = 264
WIDE_DECODE_MAX_SPLIT = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_MASK = [_I, _I, _F, _F, _P]      # causal, window, softcap, scale, stream
_prefill_bound = False
_decode_bound = False


def _decode_lib() -> ctypes.CDLL:
    global _decode_bound
    lib = build.library("flash_decode")
    if not _decode_bound:
        # 13 pointers, 4 q + 3 x 4 operand strides, B H G S T D is_bf16
        # code_bits n_pages page_size n_pool, then the plan's rows groups
        # n_split split_len
        lib.repro_flash_decode.argtypes = ([_P] * 13 + [_L] * 16
                                           + [_I] * 15 + _MASK)
        lib.repro_flash_decode.restype = _I
        _decode_bound = True
    return lib


def _prefill_lib() -> ctypes.CDLL:
    global _prefill_bound
    lib = build.library("flash_prefill")
    if not _prefill_bound:
        # q k v, the positions, out lse (the fp32 route: and the K/V parts
        # scratch), the q / k / v strides, B H G S T D, the plan's GG BQ
        # groups blocks, the mask and the stream
        lib.repro_flash_prefill_bf16.argtypes = ([_P] * 7 + [_L] * 10
                                                 + [_I] * 10 + _MASK)
        lib.repro_flash_prefill_f32.argtypes = ([_P] * 8 + [_L] * 10
                                                + [_I] * 10 + _MASK)
        lib.repro_flash_prefill_bf16.restype = _I
        lib.repro_flash_prefill_f32.restype = _I
        lib.repro_flash_prefill_f32_layout.argtypes = [_I, _P]
        lib.repro_flash_prefill_f32_layout.restype = None
        lib.repro_flash_prefill_bf16_layout.argtypes = [_I, _P]
        lib.repro_flash_prefill_bf16_layout.restype = None
        _prefill_bound = True
    return lib


def fp32_layout(D: int) -> Tuple[int, int, int]:
    """(query rows a block, kv rows a tile, dynamic shared memory bytes) of
    the fp32 prefill route at head_dim D, as the CUDA source sets them
    (builds the library)."""
    out = (ctypes.c_int * 3)()
    _prefill_lib().repro_flash_prefill_f32_layout(D, out)
    return tuple(out)


def bf16_layout(D: int) -> Tuple[int, int, int, int, int]:
    """(query rows a block, kv rows a tile, ring stages, dynamic shared
    memory bytes, blocks an SM) of the bf16 prefill route at head_dim D, as
    the CUDA source sets them (builds the library)."""
    out = (ctypes.c_int * 5)()
    _prefill_lib().repro_flash_prefill_bf16_layout(D, out)
    return tuple(out)


def bf16_prefill_smem(D: int) -> int:
    """Dynamic shared memory bytes of a bf16 prefill block at head_dim D, as
    ``csrc/flash_prefill.cuh`` lays it out (``bf16_layout`` reads the
    source's; a card test compares): q's 128 rows, ``stages`` K and V
    tiles, all unpadded; the stages' kv positions and headers (8 bytes); an
    mbarrier for q and three a stage; 1 KiB to align the base."""
    bk, stages, _ = BF16_PREFILL_TILES[D]
    return (PREFILL_BLOCK_ROWS * D * 2 + stages * (2 * bk * D * 2 + bk * 4 + 8)
            + 8 * (1 + 3 * stages) + 1024)


class PrefillPlan(NamedTuple):
    """How the prefill kernel lays G query heads x S positions of one kv
    head over blocks of ``rows`` rows (``PREFILL_BLOCK_ROWS`` on the bf16
    route, ``FP32_PREFILL_TILES[D][0]`` on the fp32 one): block ``x`` of
    ``blocks`` takes heads ``gg * GG .. gg * GG + GG - 1`` at positions
    ``qt * BQ .. qt * BQ + BQ - 1``, with ``gg = x % groups`` and the q
    tiles in reverse (``qt = blocks // groups - 1 - x // groups``: the
    blocks with the most causal work start first); row ``r`` of it holds
    head ``gg * GG + r // BQ`` at position ``qt * BQ + r % BQ``
    (``block_row`` in ``csrc/flash_prefill.cu``). Rows past G, past S or
    past ``GG * BQ`` are unused. The kernel takes all four fields: it
    launches ``blocks`` blocks per kv head and refuses a plan that leaves a
    row uncovered or a block empty."""
    GG: int
    BQ: int
    groups: int
    blocks: int


def prefill_plan(G: int, S: int,
                 rows: int = PREFILL_BLOCK_ROWS) -> PrefillPlan:
    """All G heads of a kv head in one block where they fit (GG = G up to
    ``rows``), with as many positions as fill the block's ``rows`` rows."""
    GG = min(G, rows)
    BQ = rows // GG
    groups = -(-G // GG)
    return PrefillPlan(GG, BQ, groups, -(-S // BQ) * groups)


def _same_device(*ts) -> None:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _check_q(q, q_positions, kv_positions, T) -> Tuple[int, ...]:
    if q.dim() != 5:
        raise ValueError(f"expected q (B,Hkv,G,S,D); got {tuple(q.shape)}")
    B, H, G, S, D = q.shape
    if tuple(q_positions.shape) != (B, S) or tuple(kv_positions.shape) != (B, T):
        raise ValueError(f"positions {tuple(q_positions.shape)}, "
                         f"{tuple(kv_positions.shape)}; expected ({B}, {S}), "
                         f"({B}, {T})")
    return B, H, G, S, D


def _attn_flops(B, H, G, S, T, D) -> int:
    return 4 * B * H * G * S * T * D


def _row_bytes(B, H, T, x) -> int:
    """Bytes of the B x H x T rows of a K/V operand (values, codes or
    scales: the last axis is the row's, or none for scales) that a call
    reads."""
    per_row = x.shape[-1] if x.dim() == 4 else 1
    return B * H * T * per_row * x.element_size()


def _decode_work(q, k, v, k_scale, v_scale, table, q_positions,
                 kv_positions, T) -> Tuple[int, int]:
    """(FLOPs, bytes) of one decode call: q, the visible rows of k and v
    (and their scales), the positions and table read; out written."""
    B, H, G, S, D = q.shape
    moved = (2 * accounting.nbytes(q) + accounting.nbytes(
        q_positions, kv_positions, table)
             + sum(_row_bytes(B, H, T, x) for x in (k, v, k_scale, v_scale)
                   if x is not None))
    return _attn_flops(B, H, G, S, T, D), moved


def _check(q, k, v, q_positions, kv_positions) -> Tuple[int, ...]:
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Hkv,G,S,D) and k/v (B,Hkv,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    T = k.shape[2]
    B, H, G, S, D = _check_q(q, q_positions, kv_positions, T)
    if k.shape[0] != B or k.shape[1] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    _same_device(q, k, v, q_positions, kv_positions)
    return B, H, G, S, T, D


def _check_codes(D, codes, scales, lead) -> int:
    """Codes (*lead, Dc) int8 with Dc in (D, D // 2) and scales (*lead)
    fp32, for k and v alike; returns code_bits (8 or 4)."""
    (kc, vc), (ks, vs) = codes, scales
    if tuple(kc.shape[:-1]) != lead or kc.shape != vc.shape:
        raise ValueError(f"codes {tuple(kc.shape)}, {tuple(vc.shape)}; "
                         f"expected {lead} + (Dc,)")
    if tuple(ks.shape) != lead or ks.shape != vs.shape:
        raise ValueError(f"scales {tuple(ks.shape)}, {tuple(vs.shape)}; "
                         f"expected {lead}")
    if kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {kc.dtype}, {vc.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {ks.dtype}, {vs.dtype}")
    Dc = kc.shape[-1]
    if Dc not in (D, D // 2) or D % 2:
        raise ValueError(f"code width {Dc} for head_dim {D}: expected {D} "
                         f"(int8) or {D // 2} (int4)")
    return 8 if Dc == D else 4


def _check_table(table, B) -> int:
    if table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"table {tuple(table.shape)}: expected ({B}, NP)")
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    return table.shape[1]


def _check_cuda(q, D, operands=(), ints=()) -> None:
    """What the kernels take: a CUDA q of a kernel dtype and head_dim,
    operands with a contiguous last axis, contiguous int32 index arrays."""
    if not accounting.takes(q):
        raise ValueError(f"no kernel for device {q.device}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the CUDA kernels take "
                         f"{KERNEL_HEAD_DIMS}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"dtype {q.dtype}: the CUDA kernels take {KERNEL_DTYPES}")
    for name, t in (("q", q),) + tuple(operands):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last axis")
    for name, t in ints:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32")


def _mask_args(causal, window, softcap, D):
    return [int(causal), int(window), float(softcap), 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream]


def copy_align(row_bytes: int) -> int:
    """The chunk, in bytes, that the decode kernel copies a K/V row of
    ``row_bytes`` in (csrc/flash_decode.cu ``Layout::kCopyBytes``): 16, or 8
    where the row is no multiple of 16 bytes (int4 codes at D 80 and 112)."""
    return COPY_ALIGN if row_bytes % COPY_ALIGN == 0 else 8


def _check_aligned(operands, kernel: str, align: int = COPY_ALIGN) -> None:
    """``kernel`` copies ``align``-byte chunks: every pointer, and the
    stride of every axis longer than one but the last, must be a multiple
    of ``align`` bytes."""
    for name, t in operands:
        step = align // t.element_size()
        if t.data_ptr() % align or any(
                st % step for n, st in zip(t.shape[:-1], t.stride()[:-1])
                if n > 1):
            raise ValueError(
                f"{name}: the {kernel} kernel needs a {align}-byte "
                f"aligned pointer and row strides; got pointer "
                f"{t.data_ptr():#x}, strides {t.stride()}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, kv_positions: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill kernel: returns (out (B, Hkv, G, S, D) in q's dtype,
    lse (B, Hkv, G, S) fp32). Any S and T. bf16 and fp32 each run on their
    tensor-core route."""
    B, H, G, S, T, D = _check(q, k, v, q_positions, kv_positions)
    moved = (accounting.nbytes(q, k, v, q_positions, kv_positions)
             + accounting.nbytes(q) + 4 * B * H * G * S)
    with accounting.launch("flash_attention_fwd",
                           _attn_flops(B, H, G, S, T, D), moved):
        if q.device.type == "cpu":
            return flash_attention_fwd_ref(q, k, v, q_positions,
                                           kv_positions, causal=causal,
                                           window=window, softcap=softcap)
        return _prefill_cuda(q, k, v, q_positions, kv_positions, causal,
                             window, softcap)


def _prefill_cuda(q, k, v, q_positions, kv_positions, causal, window,
                  softcap) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, G, S, D = q.shape
    T = k.shape[2]
    _check_cuda(q, D, (("k", k), ("v", v)),
                (("q_positions", q_positions), ("kv_positions", kv_positions)))
    bf16 = q.dtype == torch.bfloat16
    _check_aligned((("q", q), ("k", k), ("v", v)),
                   "bf16 prefill" if bf16 else "fp32 prefill")
    if q.device.type == "meta":
        return accounting.meta_outputs((((B, H, G, S, D), q.dtype),
                                        ((B, H, G, S), torch.float32)))
    if bf16:
        # written in the model's (B, S, Hkv, G, D) order: ops' merge of the
        # heads is then a view, not a transpose
        out = torch.empty((B, S, H, G, D), dtype=q.dtype,
                          device=q.device).permute(0, 2, 3, 1, 4)
    else:
        out = torch.empty((B, H, G, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, G, S), dtype=torch.float32, device=q.device)
    lib = _prefill_lib()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), out.data_ptr(), lse.data_ptr()]
    if bf16:
        launch, rows = lib.repro_flash_prefill_bf16, PREFILL_BLOCK_ROWS
    else:
        # K's and V's three bf16 parts, split once per call by the pre-pass
        parts = torch.empty((6, B, H, T, D), dtype=torch.bfloat16,
                            device=q.device)
        launch, rows = lib.repro_flash_prefill_f32, FP32_PREFILL_TILES[D][0]
        ptrs.append(parts.data_ptr())
    err = launch(*ptrs, *q.stride()[:4], *k.stride()[:3], *v.stride()[:3],
                 B, H, G, S, T, D, *prefill_plan(G, S, rows),
                 *_mask_args(causal, window, softcap, D))
    build.check(lib, err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    if not bf16:
        LAUNCHES["flash_attention_fwd_fp32"] += 1
    return out, lse


class DecodePlan(NamedTuple):
    """How the decode kernel lays one launch over its blocks (one warp at D
    64 and 256, four at D 80, 112 and 128): the R = G * S q rows of a kv
    head in ``groups`` groups of ``rows`` (group ``rg`` takes rows
    ``rg * rows .. rg * rows + rows - 1``, those past R unused), and the kv
    axis in ``n_split`` splits of ``split_len`` rows (split ``x`` takes
    ``x * split_len .. x * split_len + split_len - 1``, those past T
    unused). Block ``(x, h * groups + rg, b)`` takes one split of one group
    of slot b, kv head h."""
    rows: int
    groups: int
    n_split: int
    split_len: int


def decode_splits(B: int, H: int, T: int, groups: int = 1,
                  D: int = 64) -> Tuple[int, int]:
    """(n_split, split_len): enough kv splits that B * H * groups * n_split
    blocks reach ``DECODE_TARGET_BLOCKS`` (``WIDE_DECODE_TARGET_BLOCKS`` at
    ``WIDE_DECODE_DIMS``) where T allows, each a whole number of
    ``DECODE_SPLIT_MULTIPLE`` rows and at most ``DECODE_MAX_SPLIT``
    (``WIDE_DECODE_MAX_SPLIT``). A function of the shapes only, so every
    call at one shape sums in the same order (and a paged call in the order
    of a contiguous one)."""
    wide = D in WIDE_DECODE_DIMS
    target = WIDE_DECODE_TARGET_BLOCKS if wide else DECODE_TARGET_BLOCKS
    want = max(1, -(-target // max(B * H * groups, 1)))
    split_len = -(-max(T, 1) // want)
    split_len = -(-split_len // DECODE_SPLIT_MULTIPLE) * DECODE_SPLIT_MULTIPLE
    split_len = min(split_len,
                    WIDE_DECODE_MAX_SPLIT if wide else DECODE_MAX_SPLIT)
    return -(-max(T, 1) // split_len), split_len


def decode_plan(B: int, H: int, R: int, T: int, D: int = 64) -> DecodePlan:
    """The smallest of ``DECODE_ROWS`` (``WIDE_DECODE_ROWS`` at
    ``WIDE_DECODE_DIMS``) that holds all R q rows of a kv head (else groups of the largest),
    and :func:`decode_splits` for that many groups."""
    sizes = WIDE_DECODE_ROWS if D in WIDE_DECODE_DIMS else DECODE_ROWS
    rows = next((n for n in sizes if n >= R), sizes[-1])
    groups = -(-max(R, 1) // rows)
    return DecodePlan(rows, groups, *decode_splits(B, H, T, groups, D))


# The split counters of the four-warp decode kernel, a device's int32
# zeros: the last block of a (slot, kv head, group) to finish its split
# merges the partials and sets its counter back to 0, so the zeros hold
# from launch to launch and through graph replays. One buffer a device
# serves every launch (the port runs no two decode launches on concurrent
# streams); a larger one is added when a launch needs it, never freed,
# since a captured graph holds the pointer it was captured with.
_TICKETS: Dict[torch.device, list] = {}


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    bufs = _TICKETS.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the four-warp decode kernel needs {n} split counters on "
                f"{device}, first allocated while a CUDA graph is being "
                "captured: run the step once eagerly before the capture")
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _rows3(x: torch.Tensor, paged: bool):
    """Element strides (b, h, t) of a K/V operand's rows: (B, Hkv, T, ...)
    contiguous-cache layout, or (P, ps, Hkv, ...) pools, whose "b" is the
    page and "t" the row inside it."""
    s = x.stride()
    return (s[0], s[2], s[1]) if paged else (s[0], s[1], s[2])


def _launch_decode(name: str, q, k, v, k_scale, v_scale, table, q_positions,
                   kv_positions, *, T: int, code_bits: int, page_size: int,
                   causal, window, softcap) -> torch.Tensor:
    B, H, G, S, D = q.shape
    paged = page_size > 0
    if paged and page_size not in KERNEL_PAGE_SIZES:
        raise ValueError(f"page size {page_size}: the CUDA kernels take "
                         f"{KERNEL_PAGE_SIZES}")
    ints = [("q_positions", q_positions), ("kv_positions", kv_positions)]
    if paged:
        ints.append(("table", table))
    _check_cuda(q, D, (("k", k), ("v", v)), ints)
    _check_aligned((("k", k), ("v", v)), "decode",
                   copy_align(k.shape[-1] * k.element_size()))
    if q.device.type == "meta":
        return accounting.meta_outputs(((tuple(q.shape), q.dtype),))[0]
    lib = _decode_lib()
    plan = decode_plan(B, H, G * S, T, D)
    R = G * S
    out = torch.empty((B, H, G, S, D), dtype=q.dtype, device=q.device)
    scratch = [None] * 4
    if plan.n_split > 1:
        # the partials' max and sum (held here until the launch is queued)
        ml = torch.empty((2, B, H, plan.n_split, R), dtype=torch.float32,
                         device=q.device)
        pacc = torch.empty((B, H, plan.n_split, R, D), dtype=torch.float32,
                           device=q.device)
        tickets = (_tickets(q.device, B * H * plan.groups).data_ptr()
                   if D in WIDE_DECODE_DIMS else None)
        scratch = [ml[0].data_ptr(), ml[1].data_ptr(), pacc.data_ptr(),
                   tickets]
    scaled = code_bits > 0
    err = lib.repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if scaled else None,
        v_scale.data_ptr() if scaled else None,
        table.data_ptr() if paged else None,
        q_positions.data_ptr(), kv_positions.data_ptr(), out.data_ptr(),
        *scratch,
        *q.stride()[:4], *_rows3(k, paged), *_rows3(v, paged),
        *(_rows3(k_scale, paged) if scaled else (0, 0, 0)),
        *(_rows3(v_scale, paged) if scaled else (0, 0, 0)),
        B, H, G, S, T, D, int(q.dtype == torch.bfloat16), code_bits,
        table.shape[1] if paged else 0, page_size,
        k.shape[0] if paged else 0, *plan,
        *_mask_args(causal, window, softcap, D))
    build.check(lib, err, name)
    LAUNCHES[name] += 1
    return out


def flash_decode_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Decode kernel (flash-decoding split-KV + deterministic combine):
    returns out (B, Hkv, G, S, D) in q's dtype. Any G * S and T."""
    B, H, G, S, T, D = _check(q, k, v, q_positions, kv_positions)
    kw = dict(causal=causal, window=window, softcap=softcap)
    with accounting.launch("flash_decode_fwd", *_decode_work(
            q, k, v, None, None, None, q_positions, kv_positions, T)):
        if q.device.type == "cpu":
            return flash_decode_fwd_ref(q, k, v, q_positions, kv_positions,
                                        **kw)
        return _launch_decode("flash_decode_fwd", q, k, v, None, None, None,
                              q_positions, kv_positions, T=T, code_bits=0,
                              page_size=0, **kw)


def flash_decode_quant_fwd(q: torch.Tensor, k_codes: torch.Tensor,
                           k_scale: torch.Tensor, v_codes: torch.Tensor,
                           v_scale: torch.Tensor, q_positions: torch.Tensor,
                           kv_positions: torch.Tensor, *, causal: bool = True,
                           window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Decode over a quantized ring cache: codes (B, Hkv, T, Dc) int8,
    scales (B, Hkv, T) fp32, dequantized in fp32 in the kernel. Returns out
    (B, Hkv, G, S, D) in q's dtype."""
    if k_codes.dim() != 4:
        raise ValueError(f"expected codes (B,Hkv,T,Dc); got "
                         f"{tuple(k_codes.shape)}")
    T = k_codes.shape[2]
    B, H, G, S, D = _check_q(q, q_positions, kv_positions, T)
    bits = _check_codes(D, (k_codes, v_codes), (k_scale, v_scale), (B, H, T))
    _same_device(q, k_codes, k_scale, v_codes, v_scale, q_positions,
                 kv_positions)
    kw = dict(causal=causal, window=window, softcap=softcap)
    with accounting.launch("flash_decode_quant_fwd", *_decode_work(
            q, k_codes, v_codes, k_scale, v_scale, None, q_positions,
            kv_positions, T)):
        if q.device.type == "cpu":
            return flash_decode_quant_fwd_ref(q, k_codes, k_scale, v_codes,
                                              v_scale, q_positions,
                                              kv_positions, **kw)
        return _launch_decode("flash_decode_quant_fwd", q, k_codes, v_codes,
                              k_scale, v_scale, None, q_positions,
                              kv_positions, T=T, code_bits=bits, page_size=0,
                              **kw)


def flash_decode_paged_fwd(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           q_positions: torch.Tensor,
                           kv_positions: torch.Tensor, *, causal: bool = True,
                           window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Decode over page pools (P, ps, Hkv, D) through table (B, NP) int32;
    kv_positions (B, NP * ps). Returns out (B, Hkv, G, S, D)."""
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"expected pools (P,ps,Hkv,D); got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    _, ps, Hp, Dp = k_pages.shape
    NP = _check_table(table, q.shape[0])
    B, H, G, S, D = _check_q(q, q_positions, kv_positions, NP * ps)
    if (Hp, Dp) != (H, D):
        raise ValueError(f"q {tuple(q.shape)} and pool "
                         f"{tuple(k_pages.shape)} disagree")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    _same_device(q, k_pages, v_pages, table, q_positions, kv_positions)
    kw = dict(causal=causal, window=window, softcap=softcap)
    with accounting.launch("flash_decode_paged_fwd", *_decode_work(
            q, k_pages, v_pages, None, None, table, q_positions,
            kv_positions, NP * ps)):
        if q.device.type == "cpu":
            return flash_decode_paged_fwd_ref(q, k_pages, v_pages, table,
                                              q_positions, kv_positions,
                                              **kw)
        return _launch_decode("flash_decode_paged_fwd", q, k_pages, v_pages,
                              None, None, table, q_positions, kv_positions,
                              T=NP * ps, code_bits=0, page_size=ps, **kw)


def flash_decode_paged_quant_fwd(q: torch.Tensor, k_codes: torch.Tensor,
                                 k_scale: torch.Tensor, v_codes: torch.Tensor,
                                 v_scale: torch.Tensor, table: torch.Tensor,
                                 q_positions: torch.Tensor,
                                 kv_positions: torch.Tensor, *,
                                 causal: bool = True, window: int = 0,
                                 softcap: float = 0.0) -> torch.Tensor:
    """Decode over code pools (P, ps, Hkv, Dc) int8 and scale pools
    (P, ps, Hkv) fp32 through table (B, NP) int32. Returns out
    (B, Hkv, G, S, D)."""
    if k_codes.dim() != 4:
        raise ValueError(f"expected code pools (P,ps,Hkv,Dc); got "
                         f"{tuple(k_codes.shape)}")
    P, ps, Hp, _ = k_codes.shape
    NP = _check_table(table, q.shape[0])
    B, H, G, S, D = _check_q(q, q_positions, kv_positions, NP * ps)
    if Hp != H:
        raise ValueError(f"q {tuple(q.shape)} and pool "
                         f"{tuple(k_codes.shape)} disagree")
    bits = _check_codes(D, (k_codes, v_codes), (k_scale, v_scale), (P, ps, H))
    _same_device(q, k_codes, k_scale, v_codes, v_scale, table, q_positions,
                 kv_positions)
    kw = dict(causal=causal, window=window, softcap=softcap)
    with accounting.launch("flash_decode_paged_quant_fwd", *_decode_work(
            q, k_codes, v_codes, k_scale, v_scale, table, q_positions,
            kv_positions, NP * ps)):
        if q.device.type == "cpu":
            return flash_decode_paged_quant_fwd_ref(
                q, k_codes, k_scale, v_codes, v_scale, table, q_positions,
                kv_positions, **kw)
        return _launch_decode("flash_decode_paged_quant_fwd", q, k_codes,
                              v_codes, k_scale, v_scale, table, q_positions,
                              kv_positions, T=NP * ps, code_bits=bits,
                              page_size=ps, **kw)


def flash_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (BH, S, D), k/v (BH, T, D) -> (BH, S, D) in q's dtype: every row
    of BH one head, q at positions 0..S-1 and k/v at 0..T-1. The reference
    pads S and T to its blocks and marks the padding -1; the prefill kernel
    takes any S and T, so nothing is padded and no position is -1.
    ``LAUNCHES["flash_attention_bh"]`` counts the calls that launched the
    prefill kernel (which counts its own launch too)."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (BH, S, D) and k/v (BH, T, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, _ = q.shape
    T = k.shape[1]
    q_pos = torch.arange(S, dtype=torch.int32, device=q.device).repeat(BH, 1)
    kv_pos = torch.arange(T, dtype=torch.int32, device=q.device).repeat(BH, 1)
    out, _ = flash_attention_fwd(q[:, None, None], k[:, None], v[:, None],
                                 q_pos, kv_pos, causal=causal, window=window)
    if q.device.type == "cuda":
        LAUNCHES["flash_attention_bh"] += 1
    return out[:, 0, 0]
