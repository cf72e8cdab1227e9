"""Load the reference's parameters into a port model.

``load_jax_params(model, np_params)`` takes the reference's parameter tree
as numpy arrays (the caller runs ``tree_map(np.asarray, params)`` on the
reference side), unrolls the layer-stacked ``blocks`` ``[L, ...]`` into
``blocks.<i>.*`` and copies every array into the parameter of the same name.
Layouts are kept as they are (``w_q`` (d, h, e), ``w_o`` (h, e, d), ``head``
(d, V)). A missing, extra or misshaped key raises.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten_params(np_params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested reference tree -> flat ``name -> array`` with blocks unrolled."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any, out: Dict[str, np.ndarray]) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v, out)
        else:
            out[prefix] = np.asarray(node)

    for key, node in np_params.items():
        if key != "blocks":
            walk(str(key), node, flat)
            continue
        stacked: Dict[str, np.ndarray] = {}
        walk("", node, stacked)
        depths = {a.shape[0] for a in stacked.values()}
        if len(depths) != 1:
            raise ValueError(f"blocks have unequal layer axes: {depths}")
        for name, arr in stacked.items():
            for i in range(arr.shape[0]):
                flat[f"blocks.{i}.{name}"] = arr[i]
    return flat


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, np_params: Dict[str, Any]) -> None:
    flat = flatten_params(np_params)
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"parameter keys differ: missing {missing}, "
                       f"extra {extra}")
    for name, arr in flat.items():
        p = own[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
