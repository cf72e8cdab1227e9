"""The Proteus data-aware precision runtime, host side (counterpart:
``repro/core/proteus.py``):

* narrow values (the dynamic bit-precision engine): ``block_maxabs``,
  ``block_stats``, ``block_crest``, ``required_bits_int`` and
  ``required_bits_float``, the signal ``kv_quant="auto"`` uses to pick the
  int4 or the int8 grid; the per-block widths of integer data are the
  ``required_bits`` kernel of ``kernels/narrow_value``;
* block-scaled quantization: ``QTensor``, ``quantize``, ``dequantize`` and
  the int4 nibble pair ``pack_int4`` / ``unpack_int4`` (re-exported from
  ``kernels/common.py``, as the reference re-exports its own);
* collective buckets (``bucketize``) and the µProgram select unit, a
  roofline cost model over ``REPRESENTATIONS`` (``CostModel``).

The reference's collectives inside ``shard_map`` (``proteus_psum``,
``cross_pod_psum``, ``maybe_compress_grads``) wait for the port's
``torch.distributed`` layer.

The statistics stay on the tensor's device: they are 0-d tensors, so a
caller can branch on them with ``torch.where`` and no host sync.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from repro_torch.kernels.common import pack_int4, unpack_int4  # noqa: F401
from repro_torch.kernels.narrow_value.ref import magnitude_width


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """x flattened to fp32 and zero-padded to (n_blocks, block)."""
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def block_maxabs(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Per-block max |x| of the flattened tensor (zero-padded)."""
    return _blocks(x, block).abs().amax(dim=1)


def block_stats(x: torch.Tensor,
                block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """(maxabs, meanabs) per block of the flattened tensor; the zero padding
    of the last block is excluded from its mean."""
    n = x.numel()
    blocks = _blocks(x, block).abs()
    counts = torch.clamp(
        n - torch.arange(blocks.shape[0], device=x.device) * block, 1, block)
    return blocks.amax(dim=1), blocks.sum(dim=1) / counts


def block_crest(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Worst per-block crest factor max|x| / mean|x| (>= 1; an all-zero
    block counts 1): about 1 for uniform magnitudes, large for spiky
    blocks."""
    maxabs, meanabs = block_stats(x, block)
    crest = torch.where(maxabs > 0,
                        maxabs / torch.clamp(meanabs, min=1e-30),
                        torch.ones_like(maxabs))
    return crest.amax()


def required_bits_int(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement width (0-d int32) of the widest element of integer
    data, as the reference returns it under jax's default 32-bit types: its
    int64 / float64 casts are int32 / float32 there, so ``|INT32_MIN|``
    wraps to a negative maximum whose log2 is NaN and the width comes out 1,
    and from 2^21 on the fp32 log2 can come out one short (``2^23`` gives
    24; see ``kernels/narrow_value/ref.py``)."""
    m = x.to(torch.int32).abs().amax()
    return torch.where(m < 0, 1, magnitude_width(m.float()))


def required_bits_float(x: torch.Tensor, block: int = 256,
                        rtol: float = 1e-2) -> torch.Tensor:
    """Bits so that the block-scaled quantization error stays under
    ``rtol`` times the block's mean |x|: with crest c,
    ``2^(b-1) >= c / (2 rtol) + 1``. int32, at least 2."""
    crest = block_crest(x, block)
    need = torch.ceil(torch.log2(crest / (2.0 * rtol) + 1.0)) + 1.0
    return torch.clamp(need, min=2.0).to(torch.int32)


# ---------------------------------------------------------------------------
# block-scaled quantization
# ---------------------------------------------------------------------------
@dataclass
class QTensor:
    values: torch.Tensor     # int8 codes (n_blocks, block); int4 in [-8, 7]
    scale: torch.Tensor      # (n_blocks,) fp32
    bits: int
    block: int
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes_payload(self) -> int:
        n = math.prod(self.shape)
        return (n * self.bits + 7) // 8 + self.scale.numel() * 4


def quantize(x: torch.Tensor, bits: int = 8, block: int = 256) -> QTensor:
    """Symmetric per-block quantization, bits in {4, 8}; ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: expected 4 or 8")
    qmax = float(2 ** (bits - 1) - 1)
    blocks = _blocks(x, block)
    maxabs = blocks.abs().amax(dim=1)
    scale = torch.where(maxabs == 0, torch.ones_like(maxabs), maxabs / qmax)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -qmax - 1, qmax)
    return QTensor(q.to(torch.int8), scale, bits, block, tuple(x.shape),
                   x.dtype)


def dequantize(qt: QTensor) -> torch.Tensor:
    blocks = qt.values.float() * qt.scale[:, None]
    flat = blocks.reshape(-1)[: math.prod(qt.shape)]
    return flat.reshape(qt.shape).to(qt.dtype)


# ---------------------------------------------------------------------------
# collective buckets
# ---------------------------------------------------------------------------
def _leaves_with_path(tree: Any, path: Tuple = ()):
    """(path, tensor) leaves of nested dicts, lists and tuples in the
    reference's pytree order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves_with_path(sub, path + (i,))
    elif tree is not None:
        yield path, tree


def bucketize(tree: Any, bucket_bytes: int = 4 << 20) -> List[List[Tuple]]:
    """Split a tree of tensors into collective buckets of (path, leaf), a
    new bucket whenever the next leaf would take the current one past
    ``bucket_bytes``; a path is the tuple of dict keys and sequence
    indices down to the leaf."""
    buckets: List[List[Tuple]] = [[]]
    acc = 0
    for path, leaf in _leaves_with_path(tree):
        sz = leaf.numel() * leaf.element_size()
        if acc + sz > bucket_bytes and buckets[-1]:
            buckets.append([])
            acc = 0
        buckets[-1].append((path, leaf))
        acc += sz
    return buckets


# ---------------------------------------------------------------------------
# µProgram select unit: roofline cost model
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Representation:
    name: str            # "bf16" | "int8" | "int4"
    bits: int
    rel_err: float       # worst-case per-element relative error vs block max


REPRESENTATIONS = (
    Representation("bf16", 16, 2 ** -8),
    Representation("int8", 8, 0.5 / 127.0),
    Representation("int4", 4, 0.5 / 7.0),
)


@dataclass
class CostModel:
    """The cheapest representation within an error budget. A collective of
    n elements at b bits over a link of ``link_bw`` bytes/s takes
    ``n b / 8 / link_bw``, plus ``3 n / vpu_rate`` to quantize and
    dequantize unless it stays bf16: small payloads favour wide formats,
    large ones narrow formats."""

    link_bw: float = 50e9
    vpu_rate: float = 4e12     # elementwise ops/s (quantize/dequantize cost)

    def latency(self, n_elems: int, rep: Representation) -> float:
        t_wire = n_elems * rep.bits / 8.0 / self.link_bw
        t_quant = 0.0 if rep.name == "bf16" else 3.0 * n_elems / self.vpu_rate
        return t_wire + t_quant

    def select(self, n_elems: int, err_budget: float) -> Representation:
        feasible = [r for r in REPRESENTATIONS if r.rel_err <= err_budget]
        if not feasible:
            feasible = [REPRESENTATIONS[0]]
        return min(feasible, key=lambda r: self.latency(n_elems, r))

    def select_for_tensor(self, x: torch.Tensor, block: int = 256,
                          err_budget: float = 5e-3) -> Representation:
        """Data-aware selection: a representation's worst error relative to
        typical magnitudes is ``rel_err * crest`` (worst block max|x| /
        mean|x|), so uniform tensors admit narrow formats and spiky ones
        force wide ones. Reads the crest to the host."""
        crest = float(block_crest(x, block))
        feasible = [r for r in REPRESENTATIONS
                    if r.rel_err * crest <= err_budget]
        if not feasible:
            feasible = [REPRESENTATIONS[0]]
        return min(feasible, key=lambda r: self.latency(x.numel(), r))
