"""Write-behind queue: the single queued writer (port of ``repro.core.writeback``).

A fixed-size ring with monotone head/tail counters, drained by one writer
under a token bucket and binary exponential backoff.  The keyed mode
(``key_universe > 0``) adds a per-key slot map and coalesces a re-write of
a still-pending key into its ring slot.

JAX routes dead lanes of a scatter to an out-of-bounds slot that
``mode="drop"`` discards.  PyTorch has no such mode, so ``set_drop`` and
``max_drop`` scatter into one extra sink slot and slice it off.
"""
from __future__ import annotations

import dataclasses

import torch


def set_drop(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``buf.at[idx].set(vals, mode="drop")`` for indices in [0, len] — index
    ``len(buf)`` and above are dropped.  Live indices must be unique."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]])
    ext[idx.long().clamp(max=n)] = vals.to(buf.dtype)
    return ext[:n]


def max_drop(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``buf.at[idx].max(vals, mode="drop")`` for indices >= 0; index
    ``len(buf)`` and above are dropped.  Duplicates merge under max."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]])
    ext.scatter_reduce_(0, idx.long().clamp(max=n), vals.to(buf.dtype), "amax")
    return ext[:n]


def _sum_i32(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class WriteQueue:
    keys: torch.Tensor        # (Q,) int32 — key bit pattern (keyed: key id)
    data_ts: torch.Tensor     # (Q,) int32
    origin: torch.Tensor      # (Q,) int32
    head: torch.Tensor        # int32 — next slot to drain
    tail: torch.Tensor        # int32 — next slot to fill
    dropped: torch.Tensor     # int32 — enqueues rejected on a full ring
    backoff: torch.Tensor     # int32 — backoff window (ticks); 0 = healthy
    next_retry: torch.Tensor  # int32 — tick at which the writer may retry
    tokens: torch.Tensor      # float32 — API-call token bucket
    slot_of_key: torch.Tensor  # (K,) int32 — keyed: monotone index of the
    #                            key's newest entry (-1 = never enqueued)
    coalesced: torch.Tensor   # int32 — cumulative coalesced re-writes

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def key_universe(self) -> int:
        return self.slot_of_key.shape[0]

    def size(self) -> torch.Tensor:
        return self.tail - self.head


def empty_queue(capacity: int, key_universe: int = 0, device=None) -> WriteQueue:
    """A fresh ring; ``key_universe > 0`` enables the keyed/coalescing mode."""
    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return WriteQueue(
        keys=torch.zeros((capacity,), dtype=torch.int32, device=device),
        data_ts=torch.zeros((capacity,), dtype=torch.int32, device=device),
        origin=torch.zeros((capacity,), dtype=torch.int32, device=device),
        head=i32(0), tail=i32(0), dropped=i32(0), backoff=i32(0),
        next_retry=i32(0),
        tokens=torch.full((), 0.0, dtype=torch.float32, device=device),
        slot_of_key=torch.full((key_universe,), -1, dtype=torch.int32, device=device),
        coalesced=i32(0),
    )


def enqueue(q: WriteQueue, keys, data_ts, origin, mask):
    """Push the masked entries in order; overflow drops the newest.  Returns
    (queue, n_accepted)."""
    cap = q.capacity
    offs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    free = cap - (q.tail - q.head)
    accept = mask & (offs < free)
    n_accept = _sum_i32(accept)
    slots = torch.where(accept, (q.tail + offs) % cap, cap)
    return (
        dataclasses.replace(
            q,
            keys=set_drop(q.keys, slots, keys),
            data_ts=set_drop(q.data_ts, slots, data_ts),
            origin=set_drop(q.origin, slots, origin),
            tail=q.tail + n_accept,
            dropped=q.dropped + _sum_i32(mask & ~accept),
        ),
        n_accept,
    )


def drain(q: WriteQueue, now: int, store_ok: torch.Tensor, rate_per_tick: float,
          burst: float, max_per_tick: int, backoff_base: int = 1,
          backoff_max: int = 64):
    """One writer tick: drain one batch of up to ``max_per_tick`` rows (one
    API call).  On a failed attempt nothing drains and the backoff doubles.
    Returns (queue, n_rows_drained, n_api_calls)."""
    tokens = torch.clamp(q.tokens + rate_per_tick, max=burst)
    can_try = (now >= q.next_retry) & (tokens >= 1.0)
    size = q.size()
    attempt = can_try & (size > 0)
    ok = attempt & store_ok
    n = torch.where(ok, torch.clamp(size, max=max_per_tick), 0)
    calls = attempt.to(torch.int32)
    failed = attempt & ~store_ok
    new_backoff = torch.where(
        failed,
        torch.clamp(torch.clamp(q.backoff * 2, min=backoff_base), max=backoff_max),
        torch.where(ok, 0, q.backoff),
    )
    next_retry = torch.where(failed, now + new_backoff, q.next_retry)
    q = dataclasses.replace(
        q,
        head=q.head + n,
        tokens=tokens - calls.to(torch.float32),
        backoff=new_backoff,
        next_retry=next_retry,
    )
    return q, n, calls


def enqueue_keyed(q: WriteQueue, key_ids, data_ts, origin, mask):
    """Push keyed writes, coalescing re-writes of pending keys.

    Per masked lane: a later lane of the same key supersedes it; a key with
    a PENDING slot is updated in place; otherwise the write is appended and
    the slot map records its monotone index.  Returns (queue, n_appended).
    """
    cap = q.capacity
    ku = q.key_universe
    if ku <= 0:
        raise ValueError("enqueue_keyed requires empty_queue(..., key_universe=K)")
    kid = key_ids.to(torch.int32)
    r = kid.shape[0]
    order = torch.arange(r, dtype=torch.int32, device=kid.device)
    kid_safe = kid.clamp(0, ku - 1).long()

    # In-batch dedup: lane i survives iff it is the LAST masked lane of its key.
    last_of_key = max_drop(
        torch.full((ku,), -1, dtype=torch.int32, device=kid.device),
        torch.where(mask, kid, ku), order,
    )
    rep = mask & (last_of_key[kid_safe] == order)

    # Cross-tick coalesce: representative lanes whose key is still pending.
    slot = q.slot_of_key[kid_safe]
    pending = rep & (slot >= q.head) & (slot < q.tail)
    fresh = rep & ~pending
    upd_slot = torch.where(pending, slot % cap, cap)

    # Append the fresh representatives (the overflow policy of ``enqueue``).
    offs = torch.cumsum(fresh.to(torch.int32), 0, dtype=torch.int32) - 1
    free = cap - (q.tail - q.head)
    accept = fresh & (offs < free)
    n_accept = _sum_i32(accept)
    slots = torch.where(accept, (q.tail + offs) % cap, cap)

    def write(buf, vals):
        return set_drop(set_drop(buf, upd_slot, vals), slots, vals)

    n_coalesced = _sum_i32(mask & ~rep) + _sum_i32(pending)
    return (
        dataclasses.replace(
            q,
            keys=write(q.keys, kid),
            data_ts=write(q.data_ts, data_ts),
            origin=write(q.origin, origin),
            tail=q.tail + n_accept,
            dropped=q.dropped + _sum_i32(fresh & ~accept),
            slot_of_key=set_drop(q.slot_of_key, torch.where(accept, kid, ku),
                                 q.tail + offs),
            coalesced=q.coalesced + n_coalesced,
        ),
        n_accept,
    )


def ring_accounting(q: WriteQueue) -> dict:
    """Host-side components of the keyed ring's conservation law:
    ``writes_gen == appended + coalesced + dropped``, ``appended == drained
    + pending``."""
    return {
        "appended": int(q.tail),
        "pending": int(q.size()),
        "dropped": int(q.dropped),
        "coalesced": int(q.coalesced),
    }


def drained_entries(q: WriteQueue, n_drained: torch.Tensor, max_per_tick: int):
    """(key, data_ts, live) of the rows drained by the LAST ``drain``; ``q``
    is the queue after it.  Static shape ``(max_per_tick,)``."""
    lane = torch.arange(max_per_tick, dtype=torch.int32, device=q.keys.device)
    idx = ((q.head - n_drained + lane) % q.capacity).long()
    return q.keys[idx], q.data_ts[idx], lane < n_drained
