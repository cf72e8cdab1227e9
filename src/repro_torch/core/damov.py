"""DAMOV: workload characterization of the port's own steps (thesis ch. 4;
counterpart: ``repro/core/damov.py``).

The thesis's three steps, re-targeted from CPU simulators to eager
PyTorch steps on one card:

  Step 1 - bound identification: :func:`analyze_step` runs a step under a
           ``TorchDispatchMode`` and counts what every op does (FLOPs, bytes
           read and written, collective traffic); each hand-written kernel
           reports its own work (``kernels/accounting.py``), since ctypes
           launches are invisible to the mode.
  Step 2 - locality clustering: arithmetic intensity and the useful-FLOPs
           ratio (model FLOPs over counted FLOPs, the remat / redundancy
           detector).
  Step 3 - bottleneck classification into DAMOV's classes (1a memory
           bandwidth, 1b latency, 2a interconnect contention, 2c compute),
           :func:`classify`, with the card's figures (:class:`Hardware`).

The reference reads XLA's compiled HLO, so its counts are those of fused,
optimized programs; an eager step counts every op it dispatches, so its
bytes are larger (each op reads and writes its operands in memory).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import accounting


# ---------------------------------------------------------------------------
# Hardware figures
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Hardware:
    """A card's figures for the roofline: dense bf16 and fp32 peak FLOP/s,
    HBM bytes/s, and the bytes/s one device sends to the others, which the
    collective term divides the wire bytes by."""

    name: str
    peak_flops_bf16: float
    peak_flops_fp32: float
    hbm_bytes_per_s: float
    link_bytes_per_s: float


# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s dense bf16 tensor core, 67
# TFLOP/s fp32, 3.35 TB/s HBM3, NVLink 900 GB/s a card in both directions
# together; the collective term divides by the 450 GB/s one direction
# carries, since the wire bytes below are the bytes a device sends.
H100_SXM = Hardware("NVIDIA H100 SXM", peak_flops_bf16=989e12,
                    peak_flops_fp32=67e12, hbm_bytes_per_s=3.35e12,
                    link_bytes_per_s=450e9)


# ---------------------------------------------------------------------------
# Step statistics
# ---------------------------------------------------------------------------
@dataclass
class StepStats:
    """What one step does on one device (the reference's ``HloStats``,
    plus what an eager step can count besides: the matmul FLOPs apart,
    the kernels' reports and every op's count)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_operand_bytes: float = 0.0
    coll_wire_bytes: float = 0.0
    by_kind: Dict[str, float] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    n_collectives: int = 0
    n_dots: int = 0
    # the reference multiplies loop bodies by their trip counts; an eager
    # step runs every iteration, so nothing is multiplied and this stays
    # empty (kept for the reference's fields)
    trip_counts: List[int] = field(default_factory=list)
    dot_flops: float = 0.0
    kernels: Dict[str, int] = field(default_factory=dict)
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)


# aten counterparts of the reference's _ELEMWISE_FLOP_OPS (one FLOP per
# output element; in-place forms count too): add, subtract, multiply,
# divide, power, exponential, tanh, log, rsqrt, sqrt, maximum, minimum,
# negate, abs, floor, select, compare, convert (a dtype change), cosine,
# sine, logistic, exponential-minus-one, log-plus-one
ELEMWISE_FLOP_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "pow", "exp", "tanh", "log", "rsqrt",
    "sqrt", "maximum", "minimum", "clamp_min", "clamp_max", "neg", "abs",
    "floor", "where", "eq", "ne", "lt", "le", "gt", "ge", "_to_copy", "cos",
    "sin", "sigmoid", "expm1", "log1p",
})

# ops that move no element: allocations and metadata (views are found by
# their schema, ``OpOverload.is_view``)
NO_BYTES_OPS = frozenset({
    "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "set_", "resize_",
    "_local_scalar_dense", "is_same_size", "record_stream",
})

# c10d ops (what torch.distributed's collectives dispatch) -> the
# reference's collective kinds; the receiving side of a point-to-point
# pair is counted by its sender
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-broadcast",
    "send": "collective-permute",
}


def collective_bytes(kind: str, res_bytes: float, g: int
                     ) -> Tuple[float, float]:
    """(operand bytes, wire bytes a device sends) of one collective whose
    result on a device is ``res_bytes`` over a group of ``g``: the
    reference's formulas (ring all-reduce ``2 (g - 1) / g``)."""
    if kind == "all-gather":
        operand = res_bytes / max(g, 1)
        return operand, operand * max(g - 1, 0)
    if kind == "reduce-scatter":
        return res_bytes * g, res_bytes * max(g - 1, 0)
    if kind == "all-reduce":
        return res_bytes, 2.0 * res_bytes * (max(g - 1, 0) / max(g, 1))
    if kind == "all-to-all":
        return res_bytes, res_bytes * (max(g - 1, 0) / max(g, 1))
    return res_bytes, res_bytes          # permute / broadcast


def _tensors(x, out: Optional[List[torch.Tensor]] = None
             ) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (nested in tuples, lists
    and dicts)."""
    if out is None:
        out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _group_size(args) -> int:
    """The size of the process group among a c10d op's arguments."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return int(dist.ProcessGroup.unbox(a).size())
    raise ValueError("a c10d collective without a process group")


class _StepCounter(TorchDispatchMode):
    """Counts every op dispatched in its block into ``stats`` (see
    :func:`analyze_step`)."""

    def __init__(self):
        super().__init__()
        self.stats = StepStats()
        self._paused = 0

    # -- the kernels' side (kernels/accounting.py) ---------------------------
    def kernel_report(self, name: str, flops: float, nbytes: float) -> None:
        if self._paused:
            return                   # part of an enclosing launch
        st = self.stats
        st.flops += flops
        st.bytes += nbytes
        st.kernels[name] = st.kernels.get(name, 0) + 1
        st.kernel_flops[name] = st.kernel_flops.get(name, 0.0) + flops
        st.bytes_by_op[name] = st.bytes_by_op.get(name, 0.0) + nbytes

    def paused(self):
        counter = self

        class _Pause:
            def __enter__(self):
                counter._paused += 1

            def __exit__(self, *exc):
                counter._paused -= 1
        return _Pause()

    # -- the ops' side -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        st = self.stats
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        st.ops[name] = st.ops.get(name, 0) + 1
        outs = _tensors(out)
        ins = _tensors(args, _tensors(kwargs))
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            st.flops += f
            st.dot_flops += f
            st.n_dots += 1
        elif name.rstrip("_") in ELEMWISE_FLOP_OPS and outs:
            if name != "_to_copy" or (ins and ins[0].dtype != outs[0].dtype):
                st.flops += outs[0].numel()
        if ns == "c10d":
            if name in COLLECTIVE_KINDS:
                kind = COLLECTIVE_KINDS[name]
                res = accounting.nbytes(*(ins if name in (
                    "allreduce_", "broadcast_", "send") else outs))
                operand, wire = collective_bytes(kind, res, _group_size(args))
                st.coll_operand_bytes += operand
                st.coll_wire_bytes += wire
                st.by_kind[kind] = st.by_kind.get(kind, 0.0) + operand
                st.n_collectives += 1
            return
        if func.is_view or name in NO_BYTES_OPS:
            return
        moved = accounting.nbytes(*ins, *outs)
        st.bytes += moved
        st.bytes_by_op[name] = st.bytes_by_op.get(name, 0.0) + moved


def analyze_step(fn: Callable, *args, **kwargs) -> StepStats:
    """Run ``fn(*args, **kwargs)`` once and count what it does.

    - matmul FLOPs ``2 M N K`` (``torch.utils.flop_counter``'s formulas:
      mm, bmm, addmm, baddbmm, convolutions, SDPA), also apart as
      ``dot_flops`` and ``n_dots``;
    - one FLOP per output element of the aten counterparts of the
      reference's elementwise ops (:data:`ELEMWISE_FLOP_OPS`);
    - bytes: every op's tensor inputs read plus outputs written; views,
      allocations and metadata ops count nothing;
    - collectives: operand and wire bytes by the reference's formulas
      (:func:`collective_bytes`); 0 on one card;
    - each kernel launch: the FLOPs and bytes its entry reports
      (``kernels/accounting.py``), counted in ``kernels`` by name, and none
      of the ops its plain version runs on the CPU.

    The reference multiplies loop bodies by their trip counts; an eager
    step already runs every iteration, so nothing is multiplied. ``fn`` may
    run on ``meta`` tensors (full width, no memory; the kernel entries then
    return empty outputs), on the CPU or on the card; a step of the same
    shapes counts the same on each, since every count is the shapes'.
    """
    return count_step(fn, *args, **kwargs)[1]


def count_step(fn: Callable, *args, **kwargs) -> Tuple[Any, StepStats]:
    """(``fn``'s result, :func:`analyze_step`'s counts) of one run."""
    counter = _StepCounter()
    with accounting.counting(counter), counter:
        out = fn(*args, **kwargs)
    return out, counter.stats


# ---------------------------------------------------------------------------
# Roofline (step 1 output -> step 3 classification)
# ---------------------------------------------------------------------------
@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    bottleneck_class: str
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    coll_operand_bytes: float   # per device
    coll_wire_bytes: float
    model_flops: float          # global useful FLOPs (6ND / 2ND)
    useful_ratio: float
    arithmetic_intensity: float
    step_time_s: float
    roofline_fraction: float    # useful FLOPs rate / peak
    by_kind: Dict[str, float] = field(default_factory=dict)
    notes: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def classify(compute_s: float, memory_s: float, collective_s: float,
             mode: str) -> Tuple[str, str]:
    """(dominant term, DAMOV class): 2a interconnect contention, 2c
    compute (the tensor cores), 1b latency (decode), 1a memory bandwidth;
    the labels name the card's units."""
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    if dominant == "collective":
        clazz = "NVLINK_CONT (2a)"
    elif dominant == "compute":
        clazz = "TENSOR_CORE (2c)"
    else:
        clazz = "LAT (1b)" if mode == "decode" else "HBM_BW (1a)"
    return dominant, clazz


def make_roofline(arch: str, shape_name: str, mode: str, mesh_desc: str,
                  n_chips: int, stats: StepStats, model_flops: float,
                  notes: str = "", hw: Hardware = H100_SXM) -> Roofline:
    """The roofline of one counted step: compute at ``hw``'s bf16 peak,
    memory at its HBM rate, collectives' wire bytes at its link rate."""
    peak = hw.peak_flops_bf16
    compute_s = stats.flops / peak
    memory_s = stats.bytes / hw.hbm_bytes_per_s
    collective_s = stats.coll_wire_bytes / hw.link_bytes_per_s
    dominant, clazz = classify(compute_s, memory_s, collective_s, mode)
    step = max(compute_s, memory_s, collective_s)
    useful = model_flops / max(stats.flops * n_chips, 1.0)
    frac = (model_flops / max(step, 1e-12)) / (n_chips * peak)
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_desc, n_chips=n_chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, bottleneck_class=clazz,
        hlo_flops=stats.flops, hlo_bytes=stats.bytes,
        coll_operand_bytes=stats.coll_operand_bytes,
        coll_wire_bytes=stats.coll_wire_bytes,
        model_flops=model_flops, useful_ratio=useful,
        arithmetic_intensity=stats.flops / max(stats.bytes, 1.0),
        step_time_s=step, roofline_fraction=frac,
        by_kind=dict(stats.by_kind), notes=notes,
    )


def model_flops_for(cfg, shape, n_active_params: int) -> float:
    """Standard useful-FLOPs metric: 6*N*D train, 2*N*D forward-only."""
    if shape.mode == "train":
        per_tok = 6.0 * n_active_params
        toks = shape.global_batch * shape.seq_len
    elif shape.mode == "prefill":
        per_tok = 2.0 * n_active_params
        toks = shape.global_batch * shape.seq_len
    else:  # decode: one token per sequence
        per_tok = 2.0 * n_active_params
        toks = shape.global_batch
    return per_tok * toks


# ---------------------------------------------------------------------------
# Step 2/3 reporting
# ---------------------------------------------------------------------------
def what_would_help(r: Roofline) -> str:
    if r.dominant == "collective":
        big = max(r.by_kind, key=r.by_kind.get) if r.by_kind else "?"
        return (f"dominant collective is {big}: quantize payloads (Proteus int8 "
                f"halves the term) or re-map axes to keep that operand pod-local")
    if r.dominant == "compute":
        if r.useful_ratio < 0.5:
            return ("compute-bound but useful-ratio "
                    f"{r.useful_ratio:.2f}: cut redundant/replicated compute "
                    "(head padding for TP, causal block-skip, less remat)")
        return "near-roofline: only algorithmic change (sparsity, quantized matmul) helps"
    return ("memory-bound: fuse/quantize to cut HBM traffic, enlarge per-chip "
            "batch, or shard the dominant resident tensor (KV cache) further")


def render_table(rows: List[Roofline]) -> str:
    hdr = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
           "dominant | class | MF/HF | roofline_frac |")
    sep = "|" + "---|" * 10
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | {r.dominant} | "
            f"{r.bottleneck_class} | {r.useful_ratio:.3f} | "
            f"{r.roofline_fraction:.3f} |")
    return "\n".join(lines)
