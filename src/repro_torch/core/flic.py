"""FLIC cache primitives (port of ``repro.core.flic``).

The scalar half works on ONE node's ``CacheState`` (no leading axis):
``local_lookup``, ``insert`` (with its eviction record), ``insert_batch``
(R lines applied in order, as ``lax.scan`` does) and ``invalidate``.  The
reference engine ``vmap``s them over nodes (``torch.func.vmap``).

The batched half works on a ``CacheState`` with a leading node axis N: each
node upserts one line (``insert_rows``) or probes one key (``lookup_rows``),
every cache applies the coherence sweep of R broadcast rows
(``update_rows``), and ``fog_lookup`` broadcasts one read to all N.  For
``insert_rows`` and ``update_rows`` ``backend`` selects the formulation,
as ``SimConfig.probe_backend`` does for the whole tick:

* ``None``/``"fused"``: inline PyTorch, the port of JAX's inline path;
* ``"plain"`` (JAX's ``"xla"`` maps to it): the ``kernels/ref.py`` versions;
* ``"cuda"``: the hand-written kernels through ``kernels/ops.py``.  On CPU
  tensors those wrappers run the plain versions; on CUDA tensors they launch
  the kernel, which updates the cache tables IN PLACE.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cache_state import NULL_TAG, CacheLine, CacheState, set_index
from repro_torch.core.tracing import span
from repro_torch.kernels import ops, ref

I32 = torch.int32

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


@dataclasses.dataclass(frozen=True)
class LookupResult:
    hit: torch.Tensor       # bool
    data_ts: torch.Tensor   # int32 (-1 on a miss)
    origin: torch.Tensor    # int32 (-1 on a miss)
    data: torch.Tensor      # (..., D) float32, zeros on a miss


# --------------------------------------------------------------------------
# The scalar half: one node's cache, tables (S, W).
# --------------------------------------------------------------------------

def _select_way(cache: CacheState, sidx: torch.Tensor, tag: torch.Tensor):
    """(way to write, present) in the key's set: the first matching way if
    the key is present, else the first invalid way, else the least recently
    used way (the first on ties)."""
    set_valid = cache.valid[sidx]                                   # (W,)
    match = set_valid & (cache.tags[sidx] == tag)
    present = match.any()
    use = torch.where(set_valid, cache.last_use[sidx], ref.INT32_MAX)
    victim_way = torch.where((~set_valid).any(), ref._first_true(~set_valid).long(),
                             use.argmin())
    return torch.where(present, ref._first_true(match).long(), victim_way), present


def local_lookup(cache: CacheState, key: torch.Tensor, now,
                 update_lru: bool = True) -> tuple[CacheState, LookupResult]:
    """Probe one node's cache for ``key``; a hit refreshes its LRU stamp."""
    sidx = set_index(key, cache.num_sets)
    match = cache.valid[sidx] & (cache.tags[sidx] == key)
    hit = match.any()
    way = ref._first_true(match).long()
    line = (sidx, way)
    res = LookupResult(
        hit=hit,
        data_ts=torch.where(hit, cache.data_ts[line], -1),
        origin=torch.where(hit, cache.origin[line], -1),
        data=torch.where(hit, cache.data[line], 0.0),
    )
    if update_lru:
        now_t = torch.as_tensor(now, dtype=I32, device=key.device)
        cache = dataclasses.replace(cache, last_use=cache.last_use.index_put(
            line, torch.where(hit, now_t, cache.last_use[line])))
    return cache, res


def insert(cache: CacheState, line: CacheLine, now) -> tuple[CacheState, CacheLine]:
    """Soft-coherence upsert of one line; returns (cache, evicted line).

    A present key is overwritten only by a strictly newer ``data_ts``; an
    invalid ``line`` is a no-op.  The eviction is ``valid`` only when a
    different live line was displaced, and ``dirty`` if it still needs the
    store.
    """
    key = line.key
    now_t = torch.as_tensor(now, dtype=I32, device=key.device)
    sidx = set_index(key, cache.num_sets)
    way, present = _select_way(cache, sidx, key)
    at = (sidx, way)
    old_ts = cache.data_ts[at]
    do_write = line.valid & ~(present & (line.data_ts <= old_ts))
    displaced = do_write & ~present & cache.valid[at]
    evicted = CacheLine(
        key=torch.where(displaced, cache.tags[at], NULL_TAG),
        data_ts=torch.where(displaced, old_ts, -1),
        origin=torch.where(displaced, cache.origin[at], -1),
        data=torch.where(displaced, cache.data[at], 0.0),
        valid=displaced,
        dirty=displaced & cache.dirty[at],
    )

    def wr(field, value):
        value = torch.as_tensor(value, dtype=field.dtype, device=field.device)
        return field.index_put(at, torch.where(do_write, value, field[at]))

    cache = CacheState(
        tags=wr(cache.tags, key),
        data_ts=wr(cache.data_ts, line.data_ts),
        ins_ts=wr(cache.ins_ts, now_t),
        origin=wr(cache.origin, line.origin),
        valid=wr(cache.valid, True),
        dirty=wr(cache.dirty, line.dirty),
        last_use=wr(cache.last_use, now_t),
        data=wr(cache.data, line.data),
    )
    return cache, evicted


def insert_batch(cache: CacheState, lines: CacheLine, now) -> tuple[CacheState, CacheLine]:
    """Upsert R lines (leading axis R) one after the other, so same-set
    conflicts within the batch resolve in order; returns (cache, the R
    evictions stacked)."""
    evictions = []
    for r in range(lines.key.shape[0]):
        cache, ev = insert(cache, CacheLine(*(getattr(lines, f.name)[r]
                                               for f in dataclasses.fields(lines))), now)
        evictions.append(ev)
    return cache, CacheLine(*(torch.stack([getattr(e, f.name) for e in evictions])
                              for f in dataclasses.fields(CacheLine)))


def invalidate(cache: CacheState, key: torch.Tensor) -> CacheState:
    """Drop ``key`` from one node's cache if present."""
    sidx = set_index(key, cache.num_sets)
    set_valid = cache.valid[sidx]
    keep = set_valid & ~(set_valid & (cache.tags[sidx] == key))
    return dataclasses.replace(cache, valid=cache.valid.index_put((sidx,), keep))


def _flatten(x):
    """(tensors, rebuild) of a dataclass of tensors, a tuple of them, or a tensor."""
    if isinstance(x, tuple):
        parts = [_flatten(v) for v in x]
        sizes = [len(p[0]) for p in parts]

        def rebuild(ts):
            out, i = [], 0
            for (_, rb), k in zip(parts, sizes):
                out.append(rb(ts[i:i + k]))
                i += k
            return tuple(out)
        return [t for p in parts for t in p[0]], rebuild
    if dataclasses.is_dataclass(x):
        return [getattr(x, f.name) for f in dataclasses.fields(x)], lambda ts: type(x)(*ts)
    return [x], lambda ts: ts[0]


def vmap_nodes(fn):
    """``torch.func.vmap`` of ``fn`` over the leading node axis of every
    argument; arguments and results may be ``CacheState``/``CacheLine``/
    ``LookupResult`` dataclasses, tensors, or tuples of them."""
    def batched(*args):
        flat, rebuilds, sizes = [], [], []
        for a in args:
            ts, rb = _flatten(a)
            flat += ts
            rebuilds.append(rb)
            sizes.append(len(ts))
        shape = {}

        def flat_fn(*ts):
            parts, i = [], 0
            for rb, k in zip(rebuilds, sizes):
                parts.append(rb(list(ts[i:i + k])))
                i += k
            out, rb_out = _flatten(fn(*parts))
            shape["rebuild"] = rb_out
            return tuple(out)

        out = torch.func.vmap(flat_fn)(*flat)
        return shape["rebuild"](list(out))
    return batched


# --------------------------------------------------------------------------
# The batched half: a leading node axis N.
# --------------------------------------------------------------------------


def insert_rows(caches: CacheState, lines: CacheLine, now: int,
                backend: str | None = None, sidx: torch.Tensor | None = None,
                inplace: bool = False) -> tuple[CacheState, CacheLine | None]:
    """Upsert one line per node; returns (caches, evictions).

    First matching way on a hit, first invalid else LRU victim, a present key
    overwritten only by a strictly newer timestamp, dead lanes no-ops.  The
    kernel backends return ``evictions=None``, as the JAX kernel path does.
    ``sidx`` is the lines' set index (int32), where the caller has it.  With
    ``inplace`` the inline path writes into the tables it is given, as the
    CUDA kernel does.
    """
    if sidx is None:
        sidx = _i32(set_index(lines.key, caches.num_sets))
    fns = kernels(backend)
    if fns is not None:
        return _insert_rows_kernel(caches, lines, now, fns[0], sidx), None
    n, s_sets, w_ways = caches.tags.shape
    keys = lines.key
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
    flat = (rows * s_sets + sidx) * w_ways + way

    def wr(field, value):
        value = torch.as_tensor(value, dtype=field.dtype, device=field.device)
        mask = do_write.reshape((n,) + (1,) * (value.dim() - 1))
        lines_of = field.view(n * s_sets * w_ways, *field.shape[3:])
        put = lines_of.index_put_ if inplace else lines_of.index_put
        return put((flat,), torch.where(mask, value, lines_of[flat])).view(field.shape)

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


def _insert_rows_kernel(caches: CacheState, lines: CacheLine, now: int, insert,
                        sidx: torch.Tensor) -> CacheState:
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
    with span("flic.update"):
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


def lookup_rows(caches: CacheState, keys: torch.Tensor, now,
                update_lru: bool = True) -> tuple[CacheState, LookupResult]:
    """Probe one key per node (``local_lookup`` over the node axis)."""
    n = caches.tags.shape[0]
    sidx = set_index(keys, caches.num_sets)
    rows = torch.arange(n, device=keys.device)
    match = caches.valid[rows, sidx] & (caches.tags[rows, sidx] == keys[:, None])
    hit = match.any(dim=1)
    line = (rows, sidx, ref._first_true(match).long())
    res = LookupResult(
        hit=hit,
        data_ts=torch.where(hit, caches.data_ts[line], -1),
        origin=torch.where(hit, caches.origin[line], -1),
        data=torch.where(hit[:, None], caches.data[line], 0.0),
    )
    if update_lru:
        now_n = torch.full((n,), now, dtype=I32, device=keys.device)
        caches = dataclasses.replace(caches, last_use=caches.last_use.index_put(
            line, torch.where(hit, now_n, caches.last_use[line])))
    return caches, res


def fog_lookup(caches: CacheState, key: torch.Tensor, now,
               respond_mask: torch.Tensor | None = None
               ) -> tuple[CacheState, LookupResult, torch.Tensor]:
    """Broadcast a read of ``key`` to all N caches.

    Returns (caches, best, responders): ``best`` is the responding hit with
    the newest ``data_ts`` (the lowest node id on ties), ``responders`` the
    (N,) hits that answered.  ``respond_mask`` drops lost replies (None:
    reliable).  Every cache that holds the key refreshes its LRU stamp,
    answered or not.
    """
    n = caches.tags.shape[0]
    caches, res = lookup_rows(caches, key.reshape(1).expand(n), now)
    hits = res.hit if respond_mask is None else res.hit & respond_mask
    ts = torch.where(hits, res.data_ts, -1)
    best = ts.argmax()
    any_hit = hits.any()
    best_res = LookupResult(
        hit=any_hit,
        data_ts=torch.where(any_hit, ts[best], -1),
        origin=torch.where(any_hit, res.origin[best], -1),
        data=torch.where(any_hit, res.data[best], 0.0),
    )
    return caches, best_res, hits
