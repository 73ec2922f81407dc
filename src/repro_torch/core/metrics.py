"""Metric accounting of the fog simulation (port of ``repro.core.metrics``).

``TickMetrics`` keeps the JAX field order and dtypes (int32 counts, float32
byte and latency sums).  The windowed tick loop is a Python loop here.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TickMetrics:
    """Per-tick observables (stacked over time by ``stack``)."""

    wan_tx_bytes: torch.Tensor
    wan_rx_bytes: torch.Tensor
    lan_bytes: torch.Tensor
    reads: torch.Tensor
    hits_local: torch.Tensor
    hits_fog: torch.Tensor
    misses: torch.Tensor
    store_found: torch.Tensor
    store_missing: torch.Tensor
    writes_gen: torch.Tensor
    writes_drained: torch.Tensor
    queue_depth: torch.Tensor      # GAUGE: depth at end of tick
    queue_dropped: torch.Tensor    # cumulative counter
    store_txn_bytes: torch.Tensor
    store_txns: torch.Tensor
    read_latency_sum: torch.Tensor
    baseline_wan_bytes: torch.Tensor
    hits_queue: torch.Tensor
    ticks: torch.Tensor            # ticks aggregated into this row
    coherence_updates: torch.Tensor
    stale_reads: torch.Tensor
    writes_coalesced: torch.Tensor
    churn_rejoins: torch.Tensor
    wire_bytes: torch.Tensor       # embodiment field (0 on one device)


# Levels, not flows: a window keeps the LAST value instead of the sum.
GAUGE_FIELDS = ("queue_depth", "queue_dropped")
# Fields measuring the embodiment, excluded from the bitwise contract.
EMBODIMENT_FIELDS = ("wire_bytes",)
EMBODIMENT_SUMMARY_KEYS = ("wire_bytes_per_tick",)


def field_names() -> tuple[str, ...]:
    return tuple(f.name for f in dataclasses.fields(TickMetrics))


def allgather_bytes(p: int, n_elems: int, elem_bytes: int) -> float:
    """Modelled wire cost of a ring all_gather over ``p`` shards, each
    contributing ``n_elems`` elements: every block makes ``p - 1`` hops,
    ``p * (p - 1) * n_elems * elem_bytes`` in all.  Zero at ``p == 1``."""
    return float(p * (p - 1) * n_elems * elem_bytes)


def allreduce_bytes(p: int, n_elems: int, elem_bytes: int) -> float:
    """Modelled wire cost of a ring all_reduce over ``p`` shards of a tensor
    of ``n_elems`` elements: reduce-scatter and all-gather each move
    ``(p - 1) / p`` of it per shard, ``2 * (p - 1) * n_elems * elem_bytes`` in
    all.  Zero at ``p == 1``."""
    return float(2 * (p - 1) * n_elems * elem_bytes)


def accumulate(agg: TickMetrics, m: TickMetrics) -> TickMetrics:
    """Fold one tick into a window aggregate: flows summed, gauges last."""
    return TickMetrics(**{
        f: getattr(m, f) if f in GAUGE_FIELDS else getattr(agg, f) + getattr(m, f)
        for f in field_names()
    })


def stack(rows: list[TickMetrics]) -> TickMetrics:
    """A list of per-row metrics -> one TickMetrics of (T,) series."""
    return TickMetrics(**{
        f: torch.stack([getattr(r, f) for r in rows]) for f in field_names()
    })


def windowed_loop(step, state, ticks: int, metrics_every: int):
    """Run ``state -> (state, TickMetrics)`` for ``ticks`` steps; emit one
    ``accumulate``-aggregated row per ``metrics_every`` ticks.  Returns
    (state, stacked series)."""
    if ticks % metrics_every != 0:
        raise ValueError(
            f"metrics thinning aggregates fixed windows: ticks ({ticks}) "
            f"must be divisible by metrics_every ({metrics_every})"
        )
    rows = []
    for _ in range(ticks // metrics_every):
        agg = None
        for _ in range(metrics_every):
            state, m = step(state)
            agg = m if agg is None else accumulate(agg, m)
        rows.append(agg)
    return state, stack(rows)


def summarize(series: TickMetrics) -> dict:
    """Aggregate a stacked series into headline numbers (``repro``'s keys)."""
    tot = TickMetrics(**{
        f: getattr(series, f).sum(dim=0, dtype=getattr(series, f).dtype)
        for f in field_names()
    })
    ticks = int(tot.ticks)
    reads = torch.clamp(tot.reads, min=1)
    wan = tot.wan_tx_bytes + tot.wan_rx_bytes
    return {
        "ticks": ticks,
        "reads": int(tot.reads),
        "read_miss_ratio": float(tot.misses / reads),
        "hit_local_ratio": float(tot.hits_local / reads),
        "hit_fog_ratio": float(tot.hits_fog / reads),
        "hit_queue_ratio": float(tot.hits_queue / reads),
        "wan_bytes_per_tick": float(wan / ticks),
        "wan_tx_bytes_per_tick": float(tot.wan_tx_bytes / ticks),
        "wan_rx_bytes_per_tick": float(tot.wan_rx_bytes / ticks),
        "lan_bytes_per_tick": float(tot.lan_bytes / ticks),
        "baseline_wan_bytes_per_tick": float(tot.baseline_wan_bytes / ticks),
        "wan_reduction_vs_baseline": float(
            1.0 - wan / torch.clamp(tot.baseline_wan_bytes, min=1.0)
        ),
        "avg_store_txn_bytes": float(
            tot.store_txn_bytes / torch.clamp(tot.store_txns, min=1)
        ),
        "store_txns": int(tot.store_txns),
        "writes_gen": int(tot.writes_gen),
        "writes_drained": int(tot.writes_drained),
        "queue_dropped": int(series.queue_dropped[-1]),
        "final_queue_depth": int(series.queue_depth[-1]),
        "store_missing": int(tot.store_missing),
        "avg_read_latency_ticks": float(tot.read_latency_sum / reads),
        "sync_store_request_ratio": float(
            tot.misses / torch.clamp(tot.reads + tot.writes_gen, min=1)
        ),
        "coherence_updates": int(tot.coherence_updates),
        "writes_coalesced": int(tot.writes_coalesced),
        "churn_rejoins": int(tot.churn_rejoins),
        "stale_reads": int(tot.stale_reads),
        "stale_read_ratio": float(
            tot.stale_reads / torch.clamp(
                tot.hits_local + tot.hits_fog + tot.hits_queue + tot.store_found,
                min=1,
            )
        ),
        "wire_bytes_per_tick": float(tot.wire_bytes / ticks),
    }


def diff_summaries(a: dict, b: dict) -> dict:
    """Field-wise diff of two ``summarize`` dicts; empty iff equal."""
    keys = sorted(set(a) | set(b))
    return {k: (a.get(k), b.get(k)) for k in keys if a.get(k) != b.get(k)}
