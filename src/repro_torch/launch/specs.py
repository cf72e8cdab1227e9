"""Stand-ins for every input of a step, and how the planner lays them out
(counterpart: ``repro/launch/specs.py``).

* ``input_specs``: the batch template of one shape cell as
  :class:`InputSpec` s (shape, dtype). A ``prefill`` or ``train`` batch
  holds ``tokens`` (B, S) (and ``labels`` for train); a ``vlm`` batch
  reserves a patch prefix of ``P = min(num_patches, S // 2)`` positions
  inside the sequence: ``tokens`` (B, S - P) and ``patch_embeds`` (B, P,
  d_model); an ``audio`` batch adds the encoder's frames ``src_embeds``
  (B, ``int(S * src_len_ratio)``, d_model). A ``decode`` batch is one
  token a sequence, ``tokens`` (B, 1).
* ``param_spec_tree``: the parameter specs in the reference's tree layout
  (the layers stacked on a leading ``layers`` axis), the layout of the
  train step's parameters and optimizer state.
* ``cache_specs`` / ``prefill_cache_specs``: the cache as ``meta``
  tensors (the port's ``ShapeDtypeStruct``): from ``init_cache``, or from
  a prefill run on ``meta``, which gives the cross cache of an
  encoder-decoder its exact source length.
* ``batch_pspecs`` / ``cache_pspecs``: the planner's layout of the batch
  and of every cache leaf, as :meth:`Plan.spec` tuples (the reference's
  ``PartitionSpec`` s); :meth:`Plan.placements` of the same logical axes
  gives the DTensor form (``map_cache`` walks a cache's axes with its
  leaves).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


class InputSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, InputSpec]:
    """The batch template of one (arch x shape) cell."""
    B, S = shape.global_batch, shape.seq_len

    def tok(*s):
        return InputSpec(tuple(s), torch.int32)

    if shape.mode == "decode":
        return {"tokens": tok(B, 1)}
    if shape.mode not in ("prefill", "train"):
        raise ValueError(f"mode {shape.mode!r}: expected train, prefill or "
                         "decode")
    batch = {"tokens": tok(B, S)}
    if shape.mode == "train":
        batch["labels"] = tok(B, S)
    if cfg.family == "vlm":
        P = min(cfg.num_patches, S // 2)
        batch["tokens"] = tok(B, S - P)
        if shape.mode == "train":
            batch["labels"] = tok(B, S - P)
        batch["patch_embeds"] = InputSpec((B, P, cfg.d_model), torch.float32)
    if cfg.family == "audio":
        batch["src_embeds"] = InputSpec(
            (B, int(S * cfg.src_len_ratio), cfg.d_model), torch.float32)
    return batch


def meta_batch(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """``input_specs`` as empty ``meta`` tensors."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in input_specs(cfg, shape).items()}


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, plan) -> Dict:
    """The plan's layout of each ``input_specs`` entry: a (B, S) entry over
    ``act_batch`` and ``act_seq`` (a decode token only over ``act_batch``),
    a (B, S, D) one over ``act_batch``, ``act_seq`` and ``act_embed``."""
    return {k: plan.spec(*batch_axes(shape, len(v.shape)))
            for k, v in input_specs(cfg, shape).items()}


def batch_axes(shape: ShapeConfig, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axes of a batch entry of rank ``ndim``."""
    if ndim == 2:
        return ("act_batch", "act_seq" if shape.mode != "decode" else None)
    return ("act_batch", "act_seq", "act_embed")


def param_spec_tree(cfg: ModelConfig) -> Dict[str, Any]:
    """``param_specs(cfg)`` in the reference's tree layout: the layers of a
    stacked key joined on a leading dim of logical axis ``layers`` (never
    sharded), the family's list keys as lists."""
    from repro_torch.models import param_specs, reference_tree
    from repro_torch.models.model import model_class
    from repro_torch.models.module import ParamSpec

    def stack(specs):
        s = specs[0]
        return ParamSpec((len(specs),) + tuple(s.shape), s.dtype,
                         ("layers",) + tuple(s.logical_axes), s.init)
    return reference_tree(param_specs(cfg), model_class(cfg).LISTS, stack)


def _meta_model(model):
    """``model`` itself on ``meta``, or a ``meta`` twin in its KV layout
    (no weights are allocated)."""
    if model.device.type == "meta":
        return model
    from repro_torch.models import build_model
    return build_model(model.cfg, "meta", kv_quant=model.kv_quant,
                       page_size=model.page_size)


def cache_specs(model, shape: ShapeConfig, max_len: Optional[int] = None):
    """The ``init_cache`` tree of ``shape``'s batch as ``meta`` tensors
    (nothing allocated); ``max_len`` overrides the capacity (default the
    shape's sequence)."""
    return _meta_model(model).init_cache(shape.global_batch,
                                         max_len or shape.seq_len)


def prefill_cache_specs(model, cfg: ModelConfig, shape: ShapeConfig,
                        max_len: int):
    """The cache a prefill of ``shape``'s batch pre-sized for ``max_len``
    positions returns, as ``meta`` tensors: the prefill itself runs on
    ``meta`` (under a step counter, so the kernel entries take ``meta``),
    so the leaves that depend on the source length (an encoder-decoder's
    cross cache) get their exact shapes."""
    from repro_torch.core.damov import count_step
    m = _meta_model(model)
    batch = meta_batch(cfg, shape)
    tokens = batch.pop("tokens")
    (_, cache), _ = count_step(m.prefill, tokens, max_len, **batch)
    return cache


def map_cache(fn: Callable, axes: Any, *trees: Any) -> Any:
    """``fn(axes_tuple, *leaves)`` over a cache's logical-axes tree
    (``model.cache_logical_axes()``: dicts, lists, ``QKVCache`` /
    ``PagedKVCache`` nodes, tuples of axis names at the leaves) and the
    matching leaves of ``trees``, keeping the structure."""
    if isinstance(axes, tuple):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: map_cache(fn, axes[k], *(t[k] for t in trees))
                for k in axes}
    if isinstance(axes, list):
        return [map_cache(fn, a, *(t[i] for t in trees))
                for i, a in enumerate(axes)]
    return type(axes)(*(map_cache(fn, getattr(axes, f.name),
                                  *(getattr(t, f.name) for t in trees))
                        for f in dataclasses.fields(axes)))


def cache_leaves(tree: Any) -> list:
    """A cache's leaves (or its axes tree's tuples) in the reference's
    pytree order: dict keys sorted, lists in order, a ``QKVCache``'s codes
    then scales, a ``PagedKVCache``'s pages then table."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in cache_leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in cache_leaves(getattr(tree, f.name))]
    return [tree]


def cache_pspecs(model, plan, shape: Optional[ShapeConfig] = None) -> Any:
    """The plan's layout of every cache leaf: ``plan.spec`` of its logical
    axes, with ``shape`` dropping the mesh axes that do not divide the
    leaf's dims (the ``cache_specs`` of that shape)."""
    axes = model.cache_logical_axes()
    if shape is None:
        return map_cache(lambda a: plan.spec(*a), axes)
    return map_cache(lambda a, t: plan.spec(*a, dims=tuple(t.shape)), axes,
                     cache_specs(model, shape))
