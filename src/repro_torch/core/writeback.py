"""Write-behind queue: the single queued writer (port of ``repro.core.writeback``).

A fixed-size ring with monotone head/tail counters, drained by one writer
under a token bucket and binary exponential backoff.  The keyed mode
(``key_universe > 0``) adds a per-key slot map and coalesces a re-write of
a still-pending key into its ring slot.

Each call is one entry of ``kernels/ops.py`` (``ring_enqueue``,
``ring_enqueue_keyed``, ``ring_drain``, ``ring_drained``): one launch of
``csrc/ring.cu`` on CUDA tensors, the plain versions of ``kernels/ref.py``
on CPU tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops


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
    new_keys, new_ts, new_origin, tail, dropped, n_accept = ops.ring_enqueue(
        q.keys, q.data_ts, q.origin, q.head, q.tail, q.dropped, keys, data_ts, origin, mask)
    return (dataclasses.replace(q, keys=new_keys, data_ts=new_ts, origin=new_origin, tail=tail,
                                dropped=dropped),
            n_accept)


def drain(q: WriteQueue, now: int, store_ok: torch.Tensor, rate_per_tick: float,
          burst: float, max_per_tick: int, backoff_base: int = 1,
          backoff_max: int = 64):
    """One writer tick: drain one batch of up to ``max_per_tick`` rows (one
    API call).  On a failed attempt nothing drains and the backoff doubles.
    Returns (queue, n_rows_drained, n_api_calls)."""
    head, tokens, backoff, next_retry, n, calls = ops.ring_drain(
        q.head, q.tail, q.tokens, q.backoff, q.next_retry, now, store_ok, rate_per_tick, burst,
        max_per_tick, backoff_base, backoff_max)
    return (dataclasses.replace(q, head=head, tokens=tokens, backoff=backoff,
                                next_retry=next_retry),
            n, calls)


def enqueue_keyed(q: WriteQueue, key_ids, data_ts, origin, mask):
    """Push keyed writes, coalescing re-writes of pending keys.

    Per masked lane: a later lane of the same key supersedes it; a key with
    a PENDING slot is updated in place; otherwise the write is appended and
    the slot map records its monotone index.  Returns (queue, n_appended).
    """
    if q.key_universe <= 0:
        raise ValueError("enqueue_keyed requires empty_queue(..., key_universe=K)")
    keys, ts, origin, tail, dropped, slot_of_key, coalesced, n_accept = ops.ring_enqueue_keyed(
        q.keys, q.data_ts, q.origin, q.head, q.tail, q.dropped, q.slot_of_key, q.coalesced,
        key_ids, data_ts, origin, mask)
    return (dataclasses.replace(q, keys=keys, data_ts=ts, origin=origin, tail=tail,
                                dropped=dropped, slot_of_key=slot_of_key, coalesced=coalesced),
            n_accept)


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
    return ops.ring_drained(q.keys, q.data_ts, q.head, n_drained, max_per_tick)
