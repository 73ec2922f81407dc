"""Parameter definitions: one source of truth for shapes and initializers.

Port of ``repro.models.params``.  A model is a nested dict of ``ParamDef``s;
``init_params`` materializes it on a device and ``params_from_numpy`` takes
the JAX package's parameter tree (as numpy arrays, JAX's layout and key
names) so that both frameworks run the same weights.  ``abstract_params``
gives the tree's shapes and dtypes without allocating (``meta`` tensors).
The logical sharding axes are kept for parity with the JAX definitions
(``logical_axes``); the port does not shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]        # logical axis per dim (None = replicated)
    init: str = "normal"                   # normal | zeros | ones | embed | scaled
    scale: float = 1.0                     # extra multiplier on the init std
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


ParamTree = dict  # nested dict[str, ParamDef | ParamTree]


def _walk(tree: ParamTree, fn: Callable[[str, ParamDef], Any], prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, ParamDef):
            out[k] = fn(path, v)
        else:
            out[k] = _walk(v, fn, path)
    return out


def path_hash(path: str) -> int:
    """The JAX package's per-leaf hash of a parameter path."""
    h = 0
    for ch in path.encode():
        h = (h * 131 + ch) % (2**31)
    return h


def _init_std(d: ParamDef) -> float:
    """Fan-in scaled std; embeddings scale by ``d.scale`` alone.  As in JAX,
    the fan-in of a stacked leaf is read from the stacked shape."""
    if d.init == "embed":
        return d.scale
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    return d.scale / np.sqrt(max(fan_in, 1))


def init_params(defs: ParamTree, generator: torch.Generator, device) -> dict:
    """Materialize every parameter on ``device``.

    Each leaf draws from its own ``torch.Generator``, seeded from
    ``generator``'s seed and the leaf's path hash, so the result does not
    depend on dict order.  The law is JAX's: a normal truncated to [-2, 2]
    drawn in float32, times the fan-in scaled std, cast to the leaf's dtype.
    The bits are not ``jax.random``'s.  A leaf stacked over layers is drawn
    one layer at a time, scaled in place (one float32 layer of temporaries,
    not the stack).
    """
    base = generator.initial_seed()

    def leaf(path: str, d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed((base * 1_000_003 + path_hash(path)) % 2**63)
        stacked = d.axes[0] == "layers"
        inner = d.shape[1:] if stacked else d.shape
        std = _init_std(d)
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        for i in range(d.shape[0] if stacked else 1):
            x = torch.empty(inner, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
            (out[i] if stacked else out).copy_(x.mul_(std))
        return out

    return _walk(defs, leaf)


def abstract_params(defs: ParamTree) -> dict:
    """Every parameter as a tensor on the ``meta`` device, of its def's
    shape and dtype (JAX's ``ShapeDtypeStruct``s): nothing is allocated."""
    return _walk(defs, lambda _, d: torch.empty(d.shape, dtype=d.dtype, device="meta"))


def logical_axes(defs: ParamTree) -> dict:
    """Tree of logical-axis tuples, parallel to the params tree."""
    return _walk(defs, lambda _, d: d.axes)


def param_count(defs: ParamTree) -> int:
    total = 0

    def leaf(_, d: ParamDef):
        nonlocal total
        total += math.prod(d.shape)

    _walk(defs, leaf)
    return total


def stack_defs(defs: ParamTree, n: int, axis_name: str = "layers") -> ParamTree:
    """Prepend a stacked `layers` dim to every leaf (one slice per layer)."""

    def leaf(_, d: ParamDef):
        return ParamDef(
            shape=(n, *d.shape), axes=(axis_name, *d.axes),
            init=d.init, scale=d.scale, dtype=d.dtype,
        )

    return _walk(defs, leaf)


def tensor_from_numpy(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A numpy array as a tensor of ``dtype`` on ``device``.  A bfloat16
    array (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    travels as its ``uint16`` view, so its bits are kept exactly; a
    ``uint16`` array meant as ``dtype`` bfloat16 is taken as those bits."""
    a = np.array(a)  # a writable copy that torch may own
    if a.dtype.name == "bfloat16" or (a.dtype == np.uint16 and dtype == torch.bfloat16):
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg, device) -> dict:
    """The JAX package's parameter tree (numpy leaves, JAX's layout and key
    names) as the port's parameters of model ``cfg`` on ``device``, in the
    dtypes of ``model_param_defs(cfg)``; raises on a missing key or a shape
    that differs."""
    from repro_torch.models.model import model_param_defs  # model imports this module

    def leaf(path: str, d: ParamDef) -> torch.Tensor:
        node = tree
        for k in path.split("/"):
            node = node[k]
        a = np.asarray(node)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{path}: shape {a.shape}, expected {d.shape}")
        return tensor_from_numpy(a, d.dtype, device)

    return _walk(model_param_defs(cfg), leaf)
