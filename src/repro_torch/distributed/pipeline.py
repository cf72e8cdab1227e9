"""Pipeline parallelism over the ``pod`` axis, GPipe style (counterpart:
``repro/distributed/pipeline.py``).

The MIMDRAM segment story across pods: each pod runs a different stage
program, activations move stage to stage over the inter-pod links, and
microbatches fill the pipeline (bubble fraction (P - 1) / (P - 1 + M)).
Stage ``s`` owns layers ``[s L / P, (s + 1) L / P)``; a rank's stage is its
coordinate on the pod axis, and every rank of the mesh calls
:func:`pipelined_forward` together. Activations move over the pod group's
ring by ``batch_isend_irecv`` (a one-stage ring moves nothing), and one
``all_reduce(SUM)`` over the pod gives every rank the output, as the
reference's ``psum`` does. The arithmetic is ``block_fn``'s, run on the
device of its tensors.

Any per-layer ``block_fn(params_l, x) -> x`` works, with ``params_stacked``
a tree whose leaves carry the layer axis first.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_map


def _stage_slice(params_stacked: Any, stage: int, layers_per_stage: int):
    """This stage's layers, ``[stage * lps, (stage + 1) * lps)``, of the
    (L, ...) stacked tree."""
    lo = stage * layers_per_stage
    return tree_map(lambda a: a[lo:lo + layers_per_stage], params_stacked)


def _shift(cur: torch.Tensor, group, stage: int, n_stages: int):
    """``cur`` sent to the next stage; the previous stage's received."""
    import torch.distributed as dist
    ranks = dist.get_process_group_ranks(group)
    got = torch.empty_like(cur)
    ops = [dist.P2POp(dist.isend, cur.contiguous(),
                      ranks[(stage + 1) % n_stages], group),
           dist.P2POp(dist.irecv, got, ranks[(stage - 1) % n_stages], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def pipelined_forward(block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                      params_stacked: Any, x: torch.Tensor, *, mesh,
                      n_stages: int, n_layers: int,
                      pod_axis: str = "pod") -> torch.Tensor:
    """The layer stack over ``x`` (M, mb, ...) (M microbatches) as an
    ``n_stages`` pipeline over ``pod_axis``; returns the stack's output in
    the same layout, on every rank.

    M + P - 1 ticks: on tick t stage 0 takes microbatch t while any remain,
    each stage holding a microbatch applies its layers in order, the last
    stage retires microbatch t - (P - 1), and the activations move one
    stage forward."""
    import torch.distributed as dist

    from repro_torch.core.mimdram import mesh_shape
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         "stages")
    if mesh_shape(mesh).get(pod_axis) != n_stages:
        raise ValueError(f"{n_stages} stages on a {pod_axis!r} axis of "
                         f"{mesh_shape(mesh).get(pod_axis)}")
    lps = n_layers // n_stages
    M = x.shape[0]
    stage = mesh.get_local_rank(pod_axis)
    group = mesh.get_group(pod_axis)
    mine = _stage_slice(params_stacked, stage, lps)
    layers = [tree_map(lambda a: a[i], mine) for i in range(lps)]
    acc = torch.zeros_like(x)
    cur = torch.zeros_like(x[0])
    for t in range(M + n_stages - 1):
        if stage == 0 and t < M:
            cur = x[t]
        if 0 <= t - stage < M:
            for p in layers:
                cur = block_fn(p, cur)
        if stage == n_stages - 1 and t >= n_stages - 1:
            acc[t - (n_stages - 1)] = cur
        if n_stages > 1:
            cur = _shift(cur, group, stage, n_stages)
    dist.all_reduce(acc, group=group)
    return acc


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe's bubble overhead: (P - 1) / (P - 1 + M)."""
    return (n_stages - 1) / (n_stages - 1 + n_microbatches)
