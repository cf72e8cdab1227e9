"""DaPPA: the data-parallel pattern programming framework (thesis ch. 7;
counterpart: ``repro/core/dappa.py``).

The thesis's five pattern primitives, ``map``, ``zip``, ``reduce``,
``window`` and ``filter``, composed as a dataflow of :class:`Stream` s and
lowered by templates onto the data shards:

    UPMEM DaPPA                      ->  here
    -----------------------------------------------------------------
    CPU->DPU input transfer          ->  each rank holds its shard
    per-DPU kernel template          ->  per-shard PyTorch template
    inter-DPU merge via host         ->  all_reduce (SUM / MAX / MIN)
    window halo via host round-trip  ->  a ring of batch_isend_irecv
    DPU->CPU gather                  ->  streams stay sharded

Users write no collective; :func:`compile_pipeline` assembles the templates
into one function. The reference jits that function; the port runs it
eagerly, op by op, on its inputs' device (the module holds no kernel).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves_with_path, unflatten


# ---------------------------------------------------------------------------
# Dataflow graph
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Stream:
    """A lazy distributed stream (leading axis = data axis)."""

    kind: str                      # input | map | zip | window | filter
    parents: Tuple["Stream", ...] = ()
    fn: Optional[Callable] = None
    name: str = ""
    wsize: int = 0
    fill: Any = 0

    # -- pattern API (the five DaPPA primitives) -----------------------------
    def map(self, fn: Callable) -> "Stream":
        return Stream("map", (self,), fn)

    def zip(self, *others: "Stream") -> "Stream":
        return Stream("zip", (self,) + others)

    def window(self, w: int, fn: Callable) -> "Stream":
        """Sliding window of w elements -> fn over the window axis (last)."""
        return Stream("window", (self,), fn, wsize=w)

    def filter(self, pred: Callable, fill: Any = 0) -> "Stream":
        return Stream("filter", (self,), pred, fill=fill)

    def reduce(self, kind: str = "sum") -> "Reduction":
        return Reduction(self, kind)


@dataclass(frozen=True)
class Reduction:
    stream: Stream
    kind: str                      # sum | max | min | mean | count


def input_stream(name: str) -> Stream:
    return Stream("input", (), None, name=name)


def _is_pattern(x: Any) -> bool:
    return isinstance(x, (Stream, Reduction))


# ---------------------------------------------------------------------------
# Template-based lowering
# ---------------------------------------------------------------------------
@dataclass
class _Ctx:
    env: Dict[str, torch.Tensor]
    group: Any                     # the data axis's process group, or None
    n_shards: int
    shard: int
    cache: Dict[int, Tuple[Any, Optional[torch.Tensor]]] = field(
        default_factory=dict)


def _halo_from_next(x: torch.Tensor, w: int, ctx: _Ctx) -> torch.Tensor:
    """The first w rows of the next shard (ring: shard i sends its first w
    rows to shard i - 1)."""
    edge = x[:w].contiguous()
    if ctx.n_shards == 1:
        return edge.clone()
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(ctx.group)
    n, i = ctx.n_shards, ctx.shard
    halo = torch.empty_like(edge)
    ops = [dist.P2POp(dist.isend, edge, ranks[(i - 1) % n], ctx.group),
           dist.P2POp(dist.irecv, halo, ranks[(i + 1) % n], ctx.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return halo


def _eval(s: Stream, ctx: _Ctx) -> Tuple[Any, Optional[torch.Tensor]]:
    """Returns (values, validity_mask or None)."""
    key = id(s)
    if key in ctx.cache:
        return ctx.cache[key]
    if s.kind == "input":
        out = (ctx.env[s.name], None)
    elif s.kind == "map":
        v, m = _eval(s.parents[0], ctx)
        out = (s.fn(v), m)
    elif s.kind == "zip":
        vs, ms = zip(*[_eval(p, ctx) for p in s.parents])
        mask = None
        for m in ms:
            if m is not None:
                mask = m if mask is None else (mask & m)
        out = (torch.stack(vs, dim=-1)
               if all(v.dim() == vs[0].dim() for v in vs) else tuple(vs),
               mask)
    elif s.kind == "filter":
        v, m = _eval(s.parents[0], ctx)
        keep = s.fn(v).to(torch.bool)
        if keep.dim() > 1:
            keep = keep.reshape(keep.shape[0], -1).all(-1)
        mask = keep if m is None else (m & keep)
        out = (v, mask)
    elif s.kind == "window":
        v, m = _eval(s.parents[0], ctx)
        w = s.wsize
        n_local = v.shape[0]
        if ctx.group is not None:
            halo = _halo_from_next(v, w - 1, ctx)
            ext = torch.cat([v, halo], dim=0)
        else:
            pad = torch.zeros((w - 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device)
            ext = torch.cat([v, pad], dim=0)
        gpos = ctx.shard * n_local + torch.arange(n_local, device=v.device)
        n_total = n_local * ctx.n_shards
        # one gather with an (n_local, w) index matrix, not w shifted copies
        idx = (torch.arange(n_local, device=v.device)[:, None]
               + torch.arange(w, device=v.device)[None, :])
        wins = torch.movedim(ext[idx], 1, -1)
        valid = gpos <= (n_total - w)
        mask = valid if m is None else (m & valid)
        out = (s.fn(wins), mask)
    else:
        raise ValueError(s.kind)
    ctx.cache[key] = out
    return out


def _bmask(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    while m.dim() < v.dim():
        m = m[..., None]
    return m


def _all_reduce(x: torch.Tensor, kind: str, ctx: _Ctx) -> torch.Tensor:
    if ctx.group is None:
        return x
    import torch.distributed as dist
    op = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}.get(
        kind, dist.ReduceOp.SUM)
    x = x.clone()
    dist.all_reduce(x, op=op, group=ctx.group)
    return x


def _eval_reduction(r: Reduction, ctx: _Ctx) -> torch.Tensor:
    """The reduction in fp32, replicated over the shards."""
    v, m = _eval(r.stream, ctx)
    vf = v.to(torch.float32)
    if r.kind == "count":
        local = (m.to(torch.float32).sum() if m is not None
                 else torch.tensor(float(v.shape[0]), device=v.device))
    elif r.kind in ("sum", "mean"):
        if m is not None:
            vf = torch.where(_bmask(m, vf), vf, 0.0)
        local = vf.sum()
    elif r.kind == "max":
        if m is not None:
            vf = torch.where(_bmask(m, vf), vf, -torch.inf)
        local = vf.max()
    elif r.kind == "min":
        if m is not None:
            vf = torch.where(_bmask(m, vf), vf, torch.inf)
        local = vf.min()
    else:
        raise ValueError(r.kind)
    local = _all_reduce(local, r.kind, ctx)
    if r.kind == "mean":
        cnt = _eval_reduction(Reduction(r.stream, "count"), ctx)
        return local / torch.clamp(cnt, min=1.0)
    return local


# ---------------------------------------------------------------------------
# Pipeline compiler
# ---------------------------------------------------------------------------
def compile_pipeline(outputs: Any, mesh=None,
                     data_axis: str = "data") -> Callable:
    """Lower a dataflow of patterns into one function.

    ``outputs``: a Reduction / Stream or a tree (dicts, lists) of them.
    Returns ``f(**inputs)`` -> the matching tree of results, computed on
    the inputs' device. With a ``DeviceMesh``, every rank of its
    ``data_axis`` calls ``f`` on its own shard of each input (the leading
    dim); reductions come back replicated, streams sharded (each rank its
    rows of the output).
    """
    leaves = [leaf for _, leaf in leaves_with_path(outputs)]
    if not all(_is_pattern(leaf) for leaf in leaves):
        raise TypeError("outputs: a Stream, a Reduction or a tree of them")
    names = _collect_inputs(leaves)
    if mesh is None:
        group, n_shards, shard = None, 1, 0
    else:
        group = mesh.get_group(data_axis)
        n_shards = mesh.size(mesh.mesh_dim_names.index(data_axis))
        shard = mesh.get_local_rank(data_axis)

    def fn(**inputs):
        missing = [k for k in names if k not in inputs]
        if missing:
            raise KeyError(f"missing inputs {missing}")
        ctx = _Ctx(inputs, group, n_shards, shard)
        res = []
        for leaf in leaves:
            if isinstance(leaf, Reduction):
                res.append(_eval_reduction(leaf, ctx))
            else:
                v, m = _eval(leaf, ctx)
                res.append(v if m is None else torch.where(_bmask(m, v), v,
                                                           leaf.fill))
        return unflatten(outputs, res)

    return fn


def _collect_inputs(leaves: Sequence[Any]) -> List[str]:
    names: List[str] = []

    def walk(s: Stream):
        if s.kind == "input" and s.name not in names:
            names.append(s.name)
        for p in s.parents:
            walk(p)

    for leaf in leaves:
        walk(leaf.stream if isinstance(leaf, Reduction) else leaf)
    return names


# convenience namespace mirroring the thesis's API table
def map_(s: Stream, fn: Callable) -> Stream:
    return s.map(fn)


def zip_(*streams: Stream) -> Stream:
    return streams[0].zip(*streams[1:])
