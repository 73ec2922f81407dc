"""The comparison that decides ``correct``.

The program's per-tick ``TickMetrics`` series and its final state against
the reference's, element by element and bit for bit (floats by their bit
patterns).  Three numbers are compared, each against the limit 0: the
series entries, the cache-table elements, and the elements of the rest of
the state (the writer ring, the store, ``latest_ts``, the channel, the plan
state and the tick) that differ.  A path the reference has and the program
lacks, or holds in another shape, counts every element as differing.
"""
from __future__ import annotations

import torch

LIMITS = {"series_mismatch": 0, "caches_mismatch": 0, "ring_store_mismatch": 0}


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def differing(a: torch.Tensor | None, b: torch.Tensor) -> torch.Tensor:
    """Elementwise "differs" mask of ``a`` against the reference's ``b``."""
    if a is None or tuple(a.shape) != tuple(b.shape):
        return torch.ones(b.shape, dtype=torch.bool)
    return _bits(a.to(b.dtype)) != _bits(b)


def compare(prog_series: dict, ref_series: dict, prog_state: dict, ref_state: dict) -> dict:
    """(counts by ``LIMITS`` name, per-tick bool "row differs") on host tensors."""
    ticks = next(iter(ref_series.values())).shape[0]
    bad_tick = torch.zeros((ticks,), dtype=torch.bool)
    n_series = 0
    for name, want in ref_series.items():
        d = differing(prog_series.get(name), want)
        n_series += int(d.sum())
        bad_tick |= d.reshape(ticks, -1).any(dim=1)
    n_caches = n_rest = 0
    for path, want in ref_state.items():
        n = int(differing(prog_state.get(path), want).sum())
        if path.startswith("caches."):
            n_caches += n
        else:
            n_rest += n
    counts = {"series_mismatch": n_series, "caches_mismatch": n_caches,
              "ring_store_mismatch": n_rest}
    return counts, bad_tick


def verdict(counts: dict) -> bool:
    return all(counts[k] <= limit for k, limit in LIMITS.items())
