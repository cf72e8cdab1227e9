"""Nested trees of tensors in the reference's layout (counterpart: the parts
of ``jax.tree_util`` the reference's training stack uses).

A tree is a nest of dicts and lists whose leaves are tensors or arrays.
Leaves are visited as jax visits them: dict keys sorted, lists in order.
A leaf's key string is jax's ``keystr`` of its path (``['params']['embed']``,
``[0]`` for a list entry), which names the leaf in a checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _children(node: Any):
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def leaves_with_path(tree: Any) -> List[Tuple[str, Any]]:
    """(keystr, leaf) of every leaf, in jax's order."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix: str, node: Any) -> None:
        kids = _children(node)
        if kids is None:
            out.append((prefix, node))
            return
        for key, child in kids:
            walk(prefix + key, child)

    walk("", tree)
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``, trees of the same structure), keeping the structure; a node
    for which ``is_leaf`` holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(template: Any, values: List[Any]) -> Any:
    """``template``'s structure with its leaves replaced, in jax's order, by
    ``values``."""
    paths = [p for p, _ in leaves_with_path(template)]
    if len(paths) != len(values):
        raise ValueError(f"{len(values)} values for {len(paths)} leaves")
    by_path = dict(zip(paths, values))

    def build(prefix: str, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: build(prefix + f"[{k!r}]", v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(prefix + f"[{i}]", v)
                              for i, v in enumerate(node))
        return by_path[prefix]

    return build("", template)
