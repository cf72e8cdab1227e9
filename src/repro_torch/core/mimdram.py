"""The MIMDRAM planner: which mesh axes each logical tensor axis uses
(counterpart: ``repro/core/mimdram.py``).

The thesis's fine-grained resource allocation, with the device mesh as the
row and its segments as the mats: the planner discovers each dimension's
available parallelism (the "vectorization factor", :func:`vf_report`),
gives each logical axis only the mesh axes that divide it
(:func:`plan_sharding` -> :class:`Plan`), puts MoE experts on separate
segments, reports the share of the mesh doing distinct work
(``segment_utilization``) and reduces across segments pod-local first
(:func:`reduce_hierarchical`).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``; its axis names
are its ``mesh_dim_names``. :meth:`Plan.spec` returns what the reference's
``PartitionSpec`` holds, a tuple with per tensor dim ``None``, one mesh axis
name or a tuple of them; :meth:`Plan.placements` turns the same assignment
into DTensor ``Shard`` / ``Replicate`` placements, one per mesh dim. The
planner is policy: it allocates no memory and starts no communication
(``reduce_hierarchical`` aside).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, param_count

# ---------------------------------------------------------------------------
# Logical axis vocabulary
# ---------------------------------------------------------------------------
# Parameters
PARAM_AXES = (
    "embed",       # d_model dim of weight matrices (FSDP shard target)
    "mlp",         # d_ff dim (TP shard target)
    "heads",       # q heads
    "kv",          # kv heads
    "head_dim",
    "vocab",
    "expert",      # MoE expert dim -> MIMD segments
    "layers",      # stacked layer dim
    "conv",        # temporal conv taps
)
# Activations / caches
ACT_AXES = (
    "act_batch",
    "act_seq",
    "act_embed",
    "act_heads",
    "act_kv",
    "act_hd",
    "act_ff",
    "act_vocab",
    "act_expert",
    "act_cap",      # MoE capacity slots
    "cache_seq",    # KV-cache sequence dim (decode)
)

Rules = Dict[str, Optional[Tuple[str, ...]]]
Spec = Tuple[Any, ...]

# Serving keeps parameters off the data axes unless the model axis's share
# of them passes this many bytes a device: half of the 80 GB of one NVIDIA
# H100 SXM, the rest left to the KV cache and activations.
SERVING_PARAM_BUDGET = 40e9


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (empty for ``None``)."""
    if mesh is None:
        return {}
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the planner needs a DeviceMesh with mesh_dim_names")
    return dict(zip(names, (int(n) for n in mesh.mesh.shape)))


def _axis_size(mesh, names: Optional[Tuple[str, ...]]) -> int:
    if mesh is None or not names:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in names:
        n *= shape.get(a, 1)
    return n


def _divides(total: int, mesh, names: Optional[Tuple[str, ...]]) -> bool:
    n = _axis_size(mesh, names)
    return n > 0 and total % n == 0


@dataclass
class Plan:
    """Resolved data mapping for one (model, shape, mesh) cell."""

    rules: Rules
    mesh: Any = None                 # a DeviceMesh, or None
    cfg: Optional[ModelConfig] = None
    shape: Optional[ShapeConfig] = None
    notes: Tuple[str, ...] = ()
    # thesis Fig 5.13 analogue: fraction of the mesh doing distinct work
    segment_utilization: float = 1.0
    segments: Dict[str, int] = field(default_factory=dict)

    def spec(self, *logical: Optional[str],
             dims: Optional[Tuple[int, ...]] = None) -> Spec:
        """Mesh axes of a tensor tagged with logical axis names, per dim
        ``None``, one name or a tuple of names.

        Two passes: (1) base assignments (a mesh axis is used once);
        (2) ZeRO-extra: the first ``embed``-tagged dim absorbs the mesh
        axes of ``rules['_embed_extra']`` that pass 1 left unused, so a
        parameter with no TP-shardable dim still shards fully.

        With ``dims`` (the tensor's shape), axes that do not divide their
        dimension are dropped right to left.
        """
        parts: list = []
        used: set = set()
        for name in logical:
            axes = self.rules.get(name) if name is not None else None
            if not axes:
                parts.append(None)
                continue
            ax = tuple(a for a in axes if a not in used)
            used.update(ax)
            parts.append(ax or None)
        extra = self.rules.get("_embed_extra") or ()
        free = tuple(a for a in extra if a not in used)
        if free and "embed" in logical:
            i = logical.index("embed")
            parts[i] = (parts[i] or ()) + free
        if dims is not None:
            for i, ax in enumerate(parts):
                while ax and dims[i] % _axis_size(self.mesh, ax) != 0:
                    ax = ax[:-1]
                parts[i] = ax or None
        return tuple(p[0] if p is not None and len(p) == 1 else p
                     for p in parts)

    def placements(self, *logical: Optional[str],
                   dims: Optional[Tuple[int, ...]] = None) -> tuple:
        """:meth:`spec` as DTensor placements, one per mesh dim: ``Shard(i)``
        where the mesh axis shards tensor dim ``i``, else ``Replicate()``.
        A tensor dim over several mesh axes is split in mesh order, as a
        DTensor splits it; a spec that lists them in another order raises
        ``ValueError``."""
        from torch.distributed.tensor import Replicate, Shard
        if self.mesh is None:
            raise ValueError("a plan without a mesh has no placements")
        names = list(mesh_shape(self.mesh))
        where: Dict[str, int] = {}
        for i, p in enumerate(self.spec(*logical, dims=dims)):
            ax = () if p is None else (p if isinstance(p, tuple) else (p,))
            order = [names.index(a) for a in ax]
            if order != sorted(order):
                raise ValueError(f"dim {i} over {ax}: not in the mesh's "
                                 f"order {tuple(names)}")
            where.update({a: i for a in ax})
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in names)


# ---------------------------------------------------------------------------
# Plan context (threaded through model code via `constrain`)
# ---------------------------------------------------------------------------
_state = threading.local()


def current_plan() -> Optional[Plan]:
    return getattr(_state, "plan", None)


@contextlib.contextmanager
def use_plan(plan: Optional[Plan]):
    prev = getattr(_state, "plan", None)
    _state.plan = plan
    try:
        yield plan
    finally:
        _state.plan = prev


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` laid out as the active plan says for its logical axes.

    Without a plan, or on a mesh of one device, ``x`` comes back as it is.
    A DTensor is redistributed to :meth:`Plan.placements`; a plain tensor
    is one rank's own data, placed by its caller, and comes back as it is.
    """
    plan = current_plan()
    if plan is None or plan.mesh is None or plan.mesh.size() == 1:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"rank {x.dim()} vs logical axes {logical}")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(plan.mesh, plan.placements(
        *logical, dims=tuple(x.shape)))


# ---------------------------------------------------------------------------
# The planner (thesis compiler-pass analogue)
# ---------------------------------------------------------------------------
def plan_sharding(
    cfg: ModelConfig,
    shape: Optional[ShapeConfig] = None,
    mesh=None,
    overrides: Optional[Mapping[str, Optional[Tuple[str, ...]]]] = None,
    serving_param_budget: float = SERVING_PARAM_BUDGET,
) -> Plan:
    """Allocate mesh axes to logical axes for one cell.

    In priority order (MIMDRAM's VF-driven allocation): the data-like axes
    (``pod``, ``data``) take the batch and spill to the sequence when the
    batch's VF is too small; the ``model`` axis takes experts (MoE MIMD
    segments), heads / d_ff, the vocab of the head, and the KV cache's
    heads or head_dim when serving. A rule is dropped (None) when the
    dimension does not divide its mesh extent.

    Serving keeps parameters off the data axes unless the model axis's
    share of them passes ``serving_param_budget`` bytes a device (default
    :data:`SERVING_PARAM_BUDGET`, half an H100's 80 GB); then it shards them
    over the data axes too (FSDP) and says so in ``notes``.
    """
    notes = []
    mesh_axes = mesh_shape(mesh)
    has_pod = "pod" in mesh_axes
    data_axes: Tuple[str, ...] = (("pod", "data") if has_pod else ("data",))
    data_axes = tuple(a for a in data_axes if a in mesh_axes)
    model_ax: Tuple[str, ...] = ("model",) if "model" in mesh_axes else ()

    n_data = _axis_size(mesh, data_axes)
    n_model = _axis_size(mesh, model_ax)

    gb = shape.global_batch if shape is not None else 0
    seq = shape.seq_len if shape is not None else 0
    mode = shape.mode if shape is not None else "train"

    # ---- batch / sequence onto data-like axes -----------------------------
    batch_axes: Optional[Tuple[str, ...]] = None
    seq_axes: Optional[Tuple[str, ...]] = None
    if gb and n_data > 1:
        if gb % n_data == 0:
            batch_axes = data_axes
        else:
            # partial allocation: the largest prefix that divides
            acc: Tuple[str, ...] = ()
            for a in data_axes:
                cand = acc + (a,)
                if gb % _axis_size(mesh, cand) == 0:
                    acc = cand
            batch_axes = acc or None
            rest = tuple(a for a in data_axes if a not in (batch_axes or ()))
            if rest and seq and _divides(seq, mesh, rest):
                seq_axes = rest  # sequence-parallel spill (SP)
                notes.append(f"SP: seq over {rest} (batch VF {gb} < {n_data})")
            elif rest:
                notes.append(f"idle data axes {rest}: batch VF {gb} too small")

    # ---- model axis --------------------------------------------------------
    eff_heads = cfg.tp_pad_heads or cfg.num_heads
    heads_ok = eff_heads % max(n_model, 1) == 0
    kv_ok = cfg.num_kv_heads % max(n_model, 1) == 0
    ff_ok = cfg.d_ff and cfg.d_ff % max(n_model, 1) == 0
    vocab_ok = cfg.vocab_size % max(n_model, 1) == 0
    expert_ok = cfg.num_experts and cfg.num_experts % max(n_model, 1) == 0

    # MoE capacity takes the model axis when the experts cannot
    cap_axes = model_ax if (cfg.num_experts and not expert_ok) else None

    serving = mode in ("prefill", "decode")
    dtype_bytes = 2 if serving or cfg.param_dtype == "bfloat16" else 4
    per_model_shard = param_count(cfg) * dtype_bytes / max(n_model, 1)
    serving_needs_fsdp = serving and per_model_shard > serving_param_budget
    fsdp_axes = (data_axes if (n_data > 1 and
                               (not serving or serving_needs_fsdp)) else None)
    if serving_needs_fsdp:
        notes.append("serving: params exceed model-axis HBM -> FSDP fallback")

    rules: Rules = {
        # params
        "embed": fsdp_axes,                           # FSDP (train only)
        "_embed_extra": model_ax,
        "mlp": model_ax if ff_ok else None,
        "heads": model_ax if heads_ok else None,
        "kv": model_ax if kv_ok else None,
        "head_dim": None,
        "vocab": model_ax if vocab_ok else None,
        "expert": model_ax if expert_ok else None,
        "layers": None,
        "conv": None,
        # activations
        "act_batch": batch_axes,
        "act_seq": seq_axes,
        "act_embed": None,
        "act_heads": model_ax if heads_ok else None,
        "act_kv": model_ax if kv_ok else None,
        "act_hd": None,
        "act_ff": model_ax if ff_ok else None,
        "act_vocab": model_ax if vocab_ok else None,
        "act_expert": model_ax if expert_ok else None,
        "act_cap": cap_axes,
        "cache_seq": None,
    }

    if cfg.num_experts and expert_ok:
        notes.append(
            f"MIMD segments: {cfg.num_experts} experts over {n_model}-wide model axis "
            f"({cfg.num_experts // max(n_model,1)} experts/segment)"
        )

    # serving: shard the KV cache on a dim whose in-place write stays
    # device-local: kv heads if they divide the model axis, else head_dim
    rules["cache_kv"] = model_ax if kv_ok else None
    rules["cache_hd"] = None
    if serving and n_model > 1 and not kv_ok:
        if cfg.resolved_head_dim % n_model == 0:
            rules["cache_hd"] = model_ax
            notes.append("serving: KV cache sharded over head_dim (model axis)")

    if not heads_ok and model_ax:
        notes.append(
            f"heads {eff_heads} !% model {n_model}: attention TP via d_ff/vocab only"
        )
    if not kv_ok and model_ax:
        notes.append(f"kv heads {cfg.num_kv_heads} !% model {n_model}: kv replicated")

    if overrides:
        rules.update(dict(overrides))

    # ---- segment utilization (thesis SIMD-utilization metric) --------------
    util = 1.0
    if mesh is not None:
        total = 1
        for s in mesh_axes.values():
            total *= s
        batch_used = _axis_size(mesh, rules.get("act_batch")) * _axis_size(
            mesh, rules.get("act_seq"))
        model_used = max(
            _axis_size(mesh, rules.get("act_expert")),
            _axis_size(mesh, rules.get("act_heads")),
            _axis_size(mesh, rules.get("act_ff")),
            _axis_size(mesh, rules.get("cache_seq")),
            1,
        )
        util = batch_used * model_used / max(total, 1)

    segs = {
        "expert_segments": min(cfg.num_experts or 1, n_model or 1),
        "data_ways": _axis_size(mesh, rules.get("act_batch")),
        "seq_ways": _axis_size(mesh, rules.get("act_seq")),
        "model_ways": n_model,
    }

    return Plan(rules=rules, mesh=mesh, cfg=cfg, shape=shape,
                notes=tuple(notes), segment_utilization=util, segments=segs)


# ---------------------------------------------------------------------------
# Native vector reduction (thesis §5.2: cross-mat reduction trees)
# ---------------------------------------------------------------------------
def _group(mesh, names: Tuple[str, ...]):
    """The process group of the mesh axes ``names`` (one group across
    several axes: the submesh flattened)."""
    if len(names) == 1:
        return mesh.get_group(names[0])
    order = list(mesh_shape(mesh))
    names = tuple(sorted(names, key=order.index))
    return mesh[names]._flatten().get_group()


def reduce_hierarchical(x: torch.Tensor, axes: Sequence[str], mesh=None,
                        pod_axis: str = "pod") -> torch.Tensor:
    """Sum ``x`` in place over the mesh axes ``axes``, pod-local first.

    MIMDRAM reduces within a mat, then across mats over the slower
    inter-mat links; here one ``all_reduce`` over the group of the
    non-``pod`` axes, then one over the ``pod`` group, so the slow hop
    carries one pre-reduced operand. ``mesh`` defaults to the active
    plan's. Every rank of the mesh calls it. Returns ``x``.
    """
    import torch.distributed as dist
    if mesh is None:
        plan = current_plan()
        mesh = plan.mesh if plan is not None else None
    if mesh is None:
        raise ValueError("reduce_hierarchical needs a mesh (or a plan "
                         "with one)")
    local = tuple(a for a in axes if a != pod_axis)
    if local:
        dist.all_reduce(x, group=_group(mesh, local))
    if pod_axis in axes:
        dist.all_reduce(x, group=_group(mesh, (pod_axis,)))
    return x


def vf_report(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, int]:
    """Available parallelism per logical dimension (thesis Fig 5.1
    analogue)."""
    return {
        "batch": shape.global_batch,
        "seq": shape.seq_len if shape.mode != "decode" else 1,
        "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads,
        "d_ff": cfg.d_ff,
        "experts": cfg.num_experts,
        "vocab": cfg.vocab_size,
    }
