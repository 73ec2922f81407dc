"""Batched FLIC cache primitives (port of the batched half of ``repro.core.flic``).

Each node of a batched ``CacheState`` (leading axis N) upserts one line
(``insert_rows``), and every cache applies the coherence sweep of R
broadcast rows (``update_rows``).  ``backend`` selects the formulation,
as ``SimConfig.probe_backend`` does for the whole tick:

* ``None``/``"fused"``: inline PyTorch, the port of JAX's inline path;
* ``"plain"`` (JAX's ``"xla"`` maps to it): the ``kernels/ref.py`` versions;
* ``"cuda"``: the hand-written kernels through ``kernels/ops.py``.  On CPU
  tensors those wrappers run the plain versions; on CUDA tensors they launch
  the kernel, which updates the cache tables IN PLACE.

The per-node scalar primitives (``insert``, ``local_lookup``,
``insert_batch``, ``fog_lookup``) come with the reference-engine slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cache_state import NULL_TAG, CacheLine, CacheState, set_index
from repro_torch.kernels import ops, ref

KERNEL_BACKENDS = {
    "plain": (ref.flic_insert_ref, ref.flic_update_ref, ref.flic_lookup_ref),
    "cuda": (ops.flic_insert, ops.flic_update, ops.flic_lookup),
}


def kernels(backend: str | None):
    """(insert, update, lookup) of a kernel backend; None for the inline path."""
    if backend in (None, "fused"):
        return None
    if backend == "xla":
        backend = "plain"
    if backend not in KERNEL_BACKENDS:
        raise ValueError(
            f"unknown probe_backend {backend!r}: use None/'fused', 'plain' "
            f"('xla') or 'cuda'; JAX's 'interpret' and 'pallas' have no "
            f"counterpart in the port"
        )
    return KERNEL_BACKENDS[backend]


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def insert_rows(caches: CacheState, lines: CacheLine, now: int,
                backend: str | None = None) -> tuple[CacheState, CacheLine | None]:
    """Upsert one line per node; returns (caches, evictions).

    First matching way on a hit, first invalid else LRU victim, a present key
    overwritten only by a strictly newer timestamp, dead lanes no-ops.  The
    kernel backends return ``evictions=None``, as the JAX kernel path does.
    """
    fns = kernels(backend)
    if fns is not None:
        return _insert_rows_kernel(caches, lines, now, fns[0]), None
    n = caches.tags.shape[0]
    keys = lines.key
    sidx = set_index(keys, caches.num_sets)
    rows = torch.arange(n, device=keys.device)
    tags_r = caches.tags[rows, sidx]
    valid_r = caches.valid[rows, sidx]
    way, present = ref.insert_way(tags_r, valid_r, caches.last_use[rows, sidx], keys)

    line = (rows, sidx, way)
    old_ts = caches.data_ts[line]
    do_write = lines.valid & ~(present & (lines.data_ts <= old_ts))
    displaced = do_write & ~present & valid_r[rows, way]
    evicted = CacheLine(
        key=torch.where(displaced, tags_r[rows, way], NULL_TAG),
        data_ts=torch.where(displaced, old_ts, -1),
        origin=torch.where(displaced, caches.origin[line], -1),
        data=torch.where(displaced[:, None], caches.data[line], 0.0),
        valid=displaced,
        dirty=displaced & caches.dirty[line],
    )

    # Each lane writes its own node's line, so targets never collide; a dead
    # lane writes its line's current value back (JAX drops it out of bounds).
    def wr(field, value):
        value = torch.as_tensor(value, dtype=field.dtype, device=field.device)
        mask = do_write.reshape((n,) + (1,) * (value.dim() - 1))
        return field.index_put(line, torch.where(mask, value, field[line]))

    now_n = torch.full((n,), now, dtype=torch.int32, device=keys.device)
    caches = CacheState(
        tags=wr(caches.tags, keys),
        data_ts=wr(caches.data_ts, lines.data_ts),
        ins_ts=wr(caches.ins_ts, now_n),
        origin=wr(caches.origin, lines.origin),
        valid=wr(caches.valid, torch.ones_like(do_write)),
        dirty=wr(caches.dirty, lines.dirty),
        last_use=wr(caches.last_use, now_n),
        data=wr(caches.data, lines.data),
    )
    return caches, evicted


def _insert_rows_kernel(caches: CacheState, lines: CacheLine, now: int, insert) -> CacheState:
    sidx = set_index(lines.key, caches.num_sets)
    tables = insert(
        caches.tags, caches.data_ts, caches.ins_ts, caches.origin, caches.valid,
        caches.dirty, caches.last_use, caches.data,
        _i32(lines.key), _i32(sidx), _i32(lines.data_ts), _i32(lines.origin),
        lines.dirty.contiguous(), lines.valid.contiguous(),
        lines.data.contiguous(), now,
    )
    return CacheState(*tables)


def update_rows(caches: CacheState, rows: CacheLine, delivered: torch.Tensor,
                now: int, node_ids: torch.Tensor | None = None,
                backend: str | None = None) -> tuple[CacheState, torch.Tensor]:
    """Coherence sweep: R broadcast rows against N caches.

    A hearer holding a row's key updates its copy in place iff the row is
    strictly newer than the copy was before the sweep; among several rows
    for one line the highest row index wins.  ``delivered`` is the (N, R)
    delivery mask; a row always reaches its origin.  Returns (caches,
    n_updates), the count of qualifying (hearer, row) pairs.

    JAX's inline sweep and its oracle are the same winner election, so the
    inline path here is the plain version.
    """
    n = caches.tags.shape[0]
    if node_ids is None:
        node_ids = torch.arange(n, dtype=torch.int32, device=rows.key.device)
    is_origin = rows.origin[None, :] == node_ids[:, None]
    live = rows.valid[None, :] & (delivered | is_origin)              # (N, R)
    fns = kernels(backend)
    update = ref.flic_update_ref if fns is None else fns[1]
    data_ts, last_use, data, counts = update(
        caches.tags, caches.data_ts, caches.valid, caches.last_use, caches.data,
        _i32(rows.key), _i32(set_index(rows.key, caches.num_sets)),
        _i32(rows.data_ts), rows.data.contiguous(), live.contiguous(), now,
    )
    caches = dataclasses.replace(caches, data_ts=data_ts, last_use=last_use, data=data)
    return caches, counts.sum(dtype=torch.int32)


def invalidate_nodes(caches: CacheState, node_mask: torch.Tensor) -> CacheState:
    """Cold-start the masked nodes' caches (every line becomes invalid)."""
    return dataclasses.replace(caches, valid=caches.valid & ~node_mask[:, None, None])
