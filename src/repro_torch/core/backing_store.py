"""Simulated cloud backing store (port of ``repro.core.backing_store``).

Contents are analytic: the FIFO writer drains rows in enqueue order, so the
store holds the first ``drained_total`` enqueued rows; mutable workloads add
a keyed table of the newest durable version per key.  Outages come from a
static schedule; while one is active no synchronous store read is tried.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.kernels.ref import max_drop


@dataclasses.dataclass(frozen=True)
class StoreState:
    drained_total: torch.Tensor  # int32 — rows durably in the store
    api_calls: torch.Tensor      # int32 — cumulative API calls
    read_bytes: torch.Tensor     # float32
    outage_until: torch.Tensor   # int32 — down while now < outage_until
    lost_writes: torch.Tensor    # int32 — rows clobbered by collisions
    table_ts: torch.Tensor       # (K,) int32 — keyed: newest durable data_ts


def init_store(key_universe: int = 0, device=None) -> StoreState:
    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return StoreState(
        drained_total=i32(0), api_calls=i32(0),
        read_bytes=torch.full((), 0.0, dtype=torch.float32, device=device),
        outage_until=i32(0), lost_writes=i32(0),
        table_ts=torch.full((key_universe,), -1, dtype=torch.int32, device=device),
    )


@dataclasses.dataclass(frozen=True)
class StoreProfile:
    """Static semantics of the backing store."""

    kind: Literal["sheets", "db"] = "sheets"
    row_bytes: int = 148
    api_rate_per_tick: float = 5.0
    api_burst: float = 100.0
    write_latency_ticks: float = 1.3
    read_latency_ticks: float = 0.9
    collision_prob: float = 0.0

    def read_txn_bytes(self, rows_in_store: torch.Tensor) -> torch.Tensor:
        """Bytes on the wire for ONE read request (sheets: the whole table)."""
        if self.kind == "sheets":
            return torch.clamp(rows_in_store, min=1).to(torch.float32) * self.row_bytes
        return torch.full((), float(self.row_bytes), dtype=torch.float32,
                          device=rows_in_store.device)

    def write_txn_bytes(self, n_rows: torch.Tensor) -> torch.Tensor:
        return n_rows.to(torch.float32) * self.row_bytes


def store_healthy(store: StoreState, now: int) -> torch.Tensor:
    return now >= store.outage_until


def inject_outage(store: StoreState, now: int, duration: int) -> StoreState:
    """Force an outage window [now, now + duration)."""
    return dataclasses.replace(
        store, outage_until=torch.full_like(store.outage_until, now + duration)
    )


def apply_outage_schedule(store: StoreState, now: int,
                          schedule: tuple[tuple[int, int], ...]) -> StoreState:
    """At ``now == start`` the store goes down until ``start + duration``,
    extending an outage already in effect, never shortening it.  ``now`` is
    the host tick, so the schedule costs no device work on other ticks."""
    until = store.outage_until
    for start, duration in schedule:
        if now == start:
            until = torch.clamp(until, min=start + duration)
    return dataclasses.replace(store, outage_until=until)


def commit_writes(store: StoreState, n_rows: torch.Tensor, n_calls: torch.Tensor,
                  u_coll: torch.Tensor | None, profile: StoreProfile) -> StoreState:
    """Durably apply ``n_rows`` drained writes in ``n_calls`` calls.  With
    ``collision_prob > 0`` the uniform ``u_coll`` decides whether one row of
    a multi-row batch is clobbered."""
    lost = torch.zeros_like(n_rows)
    if profile.collision_prob > 0.0 and u_coll is not None:
        collide = (u_coll < profile.collision_prob) & (n_rows > 1)
        lost = collide.to(torch.int32)
    return dataclasses.replace(
        store,
        drained_total=store.drained_total + n_rows - lost,
        api_calls=store.api_calls + n_calls,
        lost_writes=store.lost_writes + lost,
    )


def read_from_store(store: StoreState, enqueue_index, profile: StoreProfile
                    ) -> tuple[StoreState, torch.Tensor, torch.Tensor]:
    """One read request for the row that was enqueued at ``enqueue_index``.

    Returns (store, found, txn_bytes).  FIFO drain: present iff
    enqueue_index < drained_total.  Sheets semantics: the whole table
    crosses the wire whether or not the row is found; the store counts one
    more API call.
    """
    found = torch.as_tensor(enqueue_index, dtype=torch.int32,
                            device=store.drained_total.device) < store.drained_total
    txn = profile.read_txn_bytes(store.drained_total)
    store = dataclasses.replace(store, api_calls=store.api_calls + 1)
    return store, found, txn


def commit_keyed_rows(store: StoreState, key_ids, data_ts, mask) -> StoreState:
    """Fold a drained batch of keyed versions into the table (scatter-max)."""
    ku = store.table_ts.shape[0]
    return dataclasses.replace(
        store,
        table_ts=max_drop(store.table_ts, torch.where(mask, key_ids, ku), data_ts),
    )
