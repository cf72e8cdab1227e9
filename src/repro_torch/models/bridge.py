"""Load the reference's parameters into a port model.

``load_jax_params(model, np_params)`` takes the reference's parameter tree
as numpy arrays (the caller runs ``tree_map(np.asarray, params)`` on the
reference side), unrolls the layer-stacked ``blocks`` ``[L, ...]`` (dense),
``groups`` ``[G, ...]`` (hybrid) and ``enc_blocks`` / ``dec_blocks``
(audio) into ``blocks.<i>.*``, ``groups.<g>.*``, ``enc_blocks.<i>.*`` ...,
spells list entries (the hybrid ``tail``, xLSTM's ``blocks``: a list of
unlike blocks, not a stack) as ``tail.<i>.*`` / ``blocks.<i>.*``, and
copies every array into the parameter of the same name.
Layouts are kept as they are (``w_q`` (d, h, e), ``w_o`` (h, e, d), ``head``
(d, V)). A missing, extra or misshaped key raises.

``reference_tree(named, lists=())`` goes the other way: the port's flat
``name -> tensor`` parameters as the reference's tree, the entries of a
``STACKED`` key stacked on a leading axis, those of a key in ``lists``
gathered into a list (xLSTM's ``blocks``, the hybrid ``tail``). The
training stack keeps its parameters, optimizer state and checkpoints in
that layout.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


# top-level keys whose leaves carry a leading layer (or group) axis
STACKED = ("blocks", "groups", "enc_blocks", "dec_blocks")


def flatten_params(np_params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested reference tree -> flat ``name -> array`` with the stacked
    axes unrolled and list entries numbered."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any, out: Dict[str, np.ndarray]) -> None:
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = np.asarray(node)
            return
        for k, v in items:
            walk(f"{prefix}.{k}" if prefix else str(k), v, out)

    for key, node in np_params.items():
        if key not in STACKED or isinstance(node, (list, tuple)):
            walk(str(key), node, flat)
            continue
        stacked: Dict[str, np.ndarray] = {}
        walk("", node, stacked)
        depths = {a.shape[0] for a in stacked.values()}
        if len(depths) != 1:
            raise ValueError(f"{key} have unequal layer axes: {depths}")
        for name, arr in stacked.items():
            for i in range(arr.shape[0]):
                flat[f"{key}.{i}.{name}"] = arr[i]
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


def reference_tree(named: Dict[str, Any], lists: Tuple[str, ...] = (),
                   stack: Callable[[List[Any]], Any] = torch.stack
                   ) -> Dict[str, Any]:
    """Flat ``name -> tensor`` (names as ``model.named_parameters()``
    gives them) -> the reference's nested tree: entries of ``STACKED`` keys
    joined on a new leading axis (by ``stack``, given the layers' entries
    in order; for leaves other than tensors, such as specs), entries of the
    keys in ``lists`` (which take precedence) gathered into a list by their
    index."""
    tree: Dict[str, Any] = {}
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in lists:
            _put(tree, parts, t)
        elif parts[0] in STACKED:
            key = (parts[0],) + tuple(parts[2:])
            stacks.setdefault(key, {})[int(parts[1])] = t
        else:
            _put(tree, parts, t)
    for key, by_layer in stacks.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{'.'.join(key)}: layers {sorted(by_layer)}")
        _put(tree, key, stack([by_layer[i] for i in range(len(by_layer))]))
    for key in lists:
        if key in tree:
            by_index = tree[key]
            if sorted(map(int, by_index)) != list(range(len(by_index))):
                raise ValueError(f"{key}: entries {sorted(by_index)}")
            tree[key] = [by_index[str(i)] for i in range(len(by_index))]
    return tree


def _put(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
