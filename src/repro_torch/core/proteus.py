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
  roofline cost model over ``REPRESENTATIONS`` (``CostModel``);
* the quantized collectives over a mesh axis: ``proteus_psum`` (one fp32
  ``all_reduce(MAX)`` of the block maxima, then a ring of int8 codes over
  ``batch_isend_irecv``, summed in int32), ``cross_pod_psum`` over a tree
  and ``maybe_compress_grads``, the train step's switch. Every rank of the
  axis's process group calls them together (the reference's run inside
  ``shard_map``). ``quantize_hook`` is their one-pod equivalent, a
  ``grad_hook`` of the plain train step.

The statistics stay on the tensor's device: they are 0-d tensors, so a
caller can branch on them with ``torch.where`` and no host sync.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.kernels.common import div_by
from repro_torch.kernels.common import pack_int4, unpack_int4  # noqa: F401
from repro_torch.kernels.narrow_value.ref import magnitude_width
from repro_torch.tree import tree_map


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
    rounds half to even, as ``jnp.round`` does, and the scale
    ``maxabs / qmax`` is the correctly rounded quotient on every device."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: expected 4 or 8")
    qmax = float(2 ** (bits - 1) - 1)
    blocks = _blocks(x, block)
    maxabs = blocks.abs().amax(dim=1)
    scale = torch.where(maxabs == 0, torch.ones_like(maxabs),
                        div_by(maxabs, qmax))
    q = torch.clamp(torch.round(blocks / scale[:, None]), -qmax - 1, qmax)
    return QTensor(q.to(torch.int8), scale, bits, block, tuple(x.shape),
                   x.dtype)


def dequantize(qt: QTensor) -> torch.Tensor:
    blocks = qt.values.float() * qt.scale[:, None]
    flat = blocks.reshape(-1)[: math.prod(qt.shape)]
    return flat.reshape(qt.shape).to(qt.dtype)


# ---------------------------------------------------------------------------
# quantized collectives
# ---------------------------------------------------------------------------
def _axis_group(axis: str, mesh):
    """The process group of mesh axis ``axis`` (``mesh`` defaults to the
    active plan's)."""
    from repro_torch.core.mimdram import current_plan, mesh_shape
    if mesh is None:
        plan = current_plan()
        mesh = plan.mesh if plan is not None else None
    if mesh is None:
        raise ValueError(f"a collective over {axis!r} needs a mesh (or a "
                         "plan with one)")
    if axis not in mesh_shape(mesh):
        raise ValueError(f"no axis {axis!r} in the mesh "
                         f"{tuple(mesh_shape(mesh))}")
    return mesh.get_group(axis)


def proteus_psum(x: torch.Tensor, axis: str, *, bits: int = 8,
                 block: int = 256, mesh=None) -> torch.Tensor:
    """Quantized all-reduce of ``x`` over the mesh axis ``axis``: a shared
    per-block scale (one fp32 ``all_reduce(MAX)`` of the block maxima), the
    int8 codes ``round(blocks / scale)`` (half to even, unclipped, as the
    reference's) summed around a ring of n - 1 hops that each carry the
    codes, accumulated in int32, and dequantized as ``acc * scale``.

    The exact sum's error is at most n scale / 2 an element. A group of one
    rank does no hop. Returns a new tensor of ``x``'s shape and dtype."""
    import torch.distributed as dist
    group = _axis_group(axis, mesh)
    blocks = _blocks(x, block)
    qmax = float(2 ** (bits - 1) - 1)
    gmax = blocks.abs().amax(dim=1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(gmax == 0, torch.ones_like(gmax), div_by(gmax, qmax))
    codes = torch.round(blocks / scale[:, None]).to(torch.int8)
    acc = codes.to(torch.int32)
    n = dist.get_world_size(group)
    if n > 1:
        ranks = dist.get_process_group_ranks(group)
        i = dist.get_group_rank(group, dist.get_rank())
        buf = codes
        for _ in range(n - 1):
            nxt = torch.empty_like(buf)
            ops = [dist.P2POp(dist.isend, buf, ranks[(i + 1) % n], group),
                   dist.P2POp(dist.irecv, nxt, ranks[(i - 1) % n], group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            buf = nxt
            acc += buf.to(torch.int32)
    out = (acc.float() * scale[:, None]).reshape(-1)[: x.numel()]
    return out.reshape(x.shape).to(x.dtype)


def cross_pod_psum(tree: Any, pod_axis: str = "pod", *, bits: int = 8,
                   block: int = 256, mean: bool = False,
                   n_pods: Optional[int] = None, mesh=None) -> Any:
    """:func:`proteus_psum` over ``pod_axis`` of every leaf of a gradient
    tree, each leaf blocked on its own; with ``mean`` and ``n_pods``
    divided by ``n_pods``."""
    def red(g):
        y = proteus_psum(g, pod_axis, bits=bits, block=block, mesh=mesh)
        if mean and n_pods:
            y = y / n_pods
        return y
    return tree_map(red, tree)


def maybe_compress_grads(grads: Any, enabled: bool, pod_axis: Optional[str],
                         bits: int = 8, block: int = 256,
                         n_pods: Optional[int] = None, mesh=None) -> Any:
    """The quantized cross-pod mean of ``grads`` when ``enabled`` and there
    is a pod axis; else ``grads`` itself."""
    if not enabled or pod_axis is None:
        return grads
    return cross_pod_psum(grads, pod_axis, bits=bits, block=block,
                          mean=True, n_pods=n_pods, mesh=mesh)


def quantize_hook(run):
    """A ``grad_hook`` for ``make_train_step`` that passes every gradient
    leaf through ``quantize`` and ``dequantize`` at the run's
    ``proteus_grad_bits`` and ``proteus_block``: what a one-pod Proteus
    step does to the gradients, bit for bit (one pod: the global block max
    is the local one, and the ring makes no hop)."""
    def hook(loss, grads, arm):
        return loss, tree_map(lambda g: dequantize(quantize(
            g, run.proteus_grad_bits, run.proteus_block)), grads)
    return hook


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
