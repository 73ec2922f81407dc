"""Tree helpers over the port's parameter and optimizer trees.

Port of ``repro.utils.trees``.  A tree is a nested ``dict`` (keys in
sorted order, as JAX flattens dicts), ``list``/``tuple`` (by index) or
dataclass (by field, in declaration order, as JAX's registered dataclasses
such as ``AdamWState``); any other value is a leaf.  ``None`` is an empty
subtree, as in JAX.  The checkpointer names leaves by
``tree_flatten_with_paths``, spelled as JAX spells them
(``opt/mu/embed/tok``), so checkpoints pass between the two packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


def _children(tree: Any):
    """``[(name, child)]`` of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def tree_flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """``[("/"-joined path, leaf)]`` in JAX's flattening order."""
    out: list[tuple[str, Any]] = []

    def walk(node, prefix):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(prefix), node))
            return
        for name, child in kids:
            walk(child, prefix + [name])

    walk(tree, [])
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to trees of one structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    if isinstance(tree, dict):   # leaves visited in flattening (sorted) order
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return dataclasses.replace(tree, **{
        name: tree_map(fn, v, *(getattr(r, name) for r in rest)) for name, v in kids})


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` whose leaves, in flattening order, are
    ``leaves``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def tree_param_count(tree: Any) -> int:
    """Total number of array elements in a tree (params, opt state, ...)."""
    return int(sum(math.prod(_shape(leaf)) for leaf in tree_leaves(tree)))


def tree_bytes(tree: Any) -> int:
    """Total byte size of a tree of tensors and numpy arrays."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            total += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
    return total
