"""AdamW with bfloat16 params and float32 moments (port of
``repro.optim.adamw``).

Plain functions on trees of tensors (``utils.trees``): ``adamw_update``
returns new tensors and leaves its inputs as they were, as JAX does.
``opt_state_to_numpy``/``opt_state_from_numpy`` carry an ``AdamWState``
between the two packages (numpy leaves in JAX's layout and key names).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: torch.Tensor   # int32 0-d
    mu: Any              # tree like params (float32)
    nu: Any              # tree like params (float32)


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=F32)   # a DTensor's keep its placements

    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares,
    the leaves added in flattening order."""
    total = None
    for g in tree_leaves(grads):
        s = g.to(F32).square().sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (new_params, new_state, metrics). Global-norm clipping.

    ``lr`` is a float or a float32 tensor.  The bias corrections take
    ``b1 ** step`` and ``b2 ** step`` in float32 (``step`` as a float32
    tensor), as JAX does; in Python doubles they would differ in the last
    bit.
    """
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.to(F32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=F32, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=F32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.to(F32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mhat = m / c1
        vhat = v / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m, v

    out = [upd(p.detach(), g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), {"grad_norm": gnorm}


def opt_state_to_numpy(state: AdamWState) -> dict:
    """``{"step": int32 array, "mu": {...}, "nu": {...}}`` of numpy arrays,
    the layout of JAX's ``AdamWState`` fields (mu/nu keyed like params)."""
    def host(t):
        return t.detach().cpu().numpy()

    return {"step": host(state.step), "mu": tree_map(host, state.mu),
            "nu": tree_map(host, state.nu)}


def opt_state_from_numpy(tree: dict, params, device) -> AdamWState:
    """The inverse of ``opt_state_to_numpy``: JAX's moments (numpy, keyed as
    ``params``) as float32 tensors on ``device``; raises on a shape that
    differs from the param's."""
    def moment(p, a):
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"moment shape {tuple(a.shape)} differs from the param's "
                             f"{tuple(p.shape)}")
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return AdamWState(
        step=torch.from_numpy(np.array(tree["step"], np.int32)).to(device),
        mu=tree_map(moment, params, tree["mu"]), nu=tree_map(moment, params, tree["nu"]))
