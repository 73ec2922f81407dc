"""Gradient compression for cross-pod links: top-k with error feedback,
and int8 (port of ``repro.optim.grad_compress``).

* ``compress_topk`` keeps the k largest-magnitude entries (flattened),
  carrying the rest in ``err`` to the next step;
* ``int8_quantize`` is symmetric per-tensor int8 with a float32 scale,
  with stochastic rounding from a ``torch.Generator`` when one is given.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

F32 = torch.float32


def compress_topk(g: torch.Tensor, k_frac: float, err: Optional[torch.Tensor] = None):
    """Returns (values, indices, new_err). ``g`` may carry error feedback ``err``."""
    flat = g.reshape(-1).to(F32)
    if err is not None:
        flat = flat + err.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    idx = torch.topk(flat.abs(), k).indices
    picked = flat[idx]
    new_err = flat.clone()
    new_err[idx] = 0.0
    return picked, idx.to(torch.int32), new_err.reshape(g.shape)


def decompress_topk(values: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros((math.prod(shape),), dtype=F32, device=values.device)
    out[idx.long()] = values
    return out.reshape(shape)


def int8_quantize(g: torch.Tensor, generator: Optional[torch.Generator] = None):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    absmax = torch.clamp(g.to(F32).abs().max(), min=1e-12)
    scale = absmax / 127.0
    x = g.to(F32) / scale
    if generator is not None:  # stochastic rounding
        x = torch.floor(x + torch.rand(g.shape, generator=generator, device=g.device))
    else:
        x = torch.round(x)
    return x.clamp(-127, 127).to(torch.int8), scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale
