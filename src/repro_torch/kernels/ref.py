"""Plain PyTorch versions of the port's kernels.

Ports of ``repro.kernels.ref`` (``flic_lookup_ref``, ``flic_update_ref``,
``flic_insert_ref``, ``flic_merge_ref``, ``paged_attention_ref``,
``ssd_scan_ref``) with the same contracts, ``payload_hash_ref``, the
payload hash of ``core/workload.py``, and the ``ring_*_ref`` calls of the
writer ring (``core/writeback.py``, ``simulator._resolve_backstop{,_keyed}``;
the JAX package leaves both to XLA, with no Pallas kernel).  They are the
CPU path of the ``kernels.ops`` wrappers,
the ``probe_backend="plain"`` path of the simulator, the
``kernel_backend="plain"`` path of the serving engine, the Mamba2 model's
scan when it is given ``ssd_scan=ref.ssd_scan_ref``, and what
``chip_smoke.py`` (``payload_hash``: ``tests/test_torch_payload_hash.py``;
the ring: ``tests/test_torch_ring.py``) holds each CUDA kernel against on
the card.

Differences in form from the JAX oracles, none in result:

* tables are batched over a leading cache axis (the JAX oracles work on one
  cache and are vmapped); ``flic_update_ref`` takes the dense ``(N, R)``
  ``live`` mask and returns per-cache update counts ``(N,)``;
* tags and keys are int32 bit patterns, ``valid``/``dirty`` are bool;
* the plain versions are functional; the CUDA kernels update in place.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.utils.hashing import hash2_u32, hash2_u32_unsigned

INT32_MAX = 2**31 - 1


@functools.cache
def inv_sqrt(d: int) -> float:
    """``1 / sqrt(d)`` as JAX computes it, both steps in float32, returned
    as a Python float (exactly that float32 value): multiplying a float32
    tensor by it rounds as JAX does, and no device tensor is made from the
    host, which would make the host wait for the card.  Computed on the CPU
    with every dispatch mode set aside (a fake tensor mode has no values)."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        one = torch.ones((), dtype=torch.float32)
        return float(one / torch.sqrt(torch.tensor(float(d), dtype=torch.float32)))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none): argmax on
    an integer copy, because torch refuses argmax on bool."""
    return mask.to(torch.int32).argmax(dim=-1)


# ---------------------------------------------------------------------------
# flic_lookup: set-associative probe of C caches by Q shared queries
# ---------------------------------------------------------------------------

def flic_lookup_ref(tags, data_ts, valid, data, keys, sidx):
    """Probe every cache for every query.

    ``tags``/``data_ts``/``valid`` are ``(C, S, W)``, ``data`` ``(C, S, W, D)``,
    ``keys``/``sidx`` ``(Q,)``.  Returns (hit (C,Q) bool, ts (C,Q) int32,
    payload (C,Q,D) f32, way (C,Q) int32).  Among matching ways the one with
    the highest timestamp wins, the first on equal timestamps; on a miss
    ``ts`` is -1, ``way`` 0 and ``payload`` zeros.
    """
    s = sidx.long()
    c = tags.shape[0]
    match = valid[:, s] & (tags[:, s] == keys[None, :, None])   # (C, Q, W)
    hit = match.any(dim=-1)
    ts_m = torch.where(match, data_ts[:, s], -1)
    way = ts_m.argmax(dim=-1)                                    # first max
    ts = ts_m.amax(dim=-1)
    rows = torch.arange(c, device=tags.device)[:, None]
    payload = torch.where(hit[..., None], data[rows, s[None, :], way], 0.0)
    way = torch.where(hit, way, 0).to(torch.int32)
    return hit, ts, payload, way


# ---------------------------------------------------------------------------
# flic_update: coherence sweep of N caches by R broadcast rows
# ---------------------------------------------------------------------------

def update_winners(tags, data_ts, valid, keys, sidx, row_ts, live):
    """The sweep's election: (winr (N,S,W) int32, n_upd (N,) int32).

    A live row qualifies for a line if the line is valid, the tags match and
    the row's timestamp is strictly newer than the line's PRE-sweep one.
    ``winr`` is the highest qualifying row index per line (-1: none);
    ``n_upd`` counts, per cache, the rows that qualified for any way.
    """
    s = sidx.long()
    n, r = live.shape
    w = tags.shape[-1]
    match = valid[:, s] & (tags[:, s] == keys[None, :, None])    # (N, R, W)
    newer = row_ts[None, :, None] > data_ts[:, s]
    upd = match & newer & live[:, :, None]
    n_upd = upd.any(dim=2).sum(dim=1, dtype=torch.int32)
    ridx = torch.arange(r, dtype=torch.int32, device=tags.device)
    winr = torch.full(tags.shape, -1, dtype=torch.int32, device=tags.device)
    winr.scatter_reduce_(
        1, s[None, :, None].expand(n, r, w),
        torch.where(upd, ridx[None, :, None], -1), "amax",
    )
    return winr, n_upd


def flic_update_ref(tags, data_ts, valid, last_use, data, keys, sidx, row_ts,
                    row_data, live, now: int):
    """Apply the coherence sweep; returns (data_ts, last_use, data, n_upd).

    Each line with a winning row takes that row's timestamp and payload and
    ``last_use = now``; see ``update_winners`` for the election.
    """
    winr, n_upd = update_winners(tags, data_ts, valid, keys, sidx, row_ts, live)
    updated = winr >= 0
    wsafe = winr.clamp(min=0).long()
    return (
        torch.where(updated, row_ts[wsafe], data_ts),
        torch.where(updated, now, last_use),
        torch.where(updated[..., None], row_data[wsafe], data),
        n_upd,
    )


# ---------------------------------------------------------------------------
# flic_insert: one-line-per-node upsert across N caches
# ---------------------------------------------------------------------------

def insert_way(tags_r, valid_r, use_r, keys):
    """Way select over gathered set rows ``(N, W)``: the first matching
    valid way if the key is present, else the first invalid way, else the
    least recently used way.  Returns (way (N,) int64, present (N,) bool)."""
    match = valid_r & (tags_r == keys[:, None])
    present = match.any(dim=1)
    any_invalid = (~valid_r).any(dim=1)
    use = torch.where(valid_r, use_r, INT32_MAX)
    victim = torch.where(any_invalid, _first_true(~valid_r), use.argmin(dim=1))
    return torch.where(present, _first_true(match), victim), present


def insert_plan(tags, data_ts, valid, last_use, keys, sidx, line_ts, live):
    """(way, do_write) per node: the way each line goes to, and whether it
    is written (live, and not stale against a present copy)."""
    rows = torch.arange(tags.shape[0], device=tags.device)
    s = sidx.long()
    way, present = insert_way(tags[rows, s], valid[rows, s], last_use[rows, s], keys)
    stale = present & (line_ts <= data_ts[rows, s, way])
    return way, live & ~stale


def flic_insert_ref(tags, data_ts, ins_ts, origin, valid, dirty, last_use, data,
                    keys, sidx, line_ts, line_origin, line_dirty, live,
                    line_data, now: int):
    """Batched upsert, one line per node; returns the eight updated tables
    (tags, data_ts, ins_ts, origin, valid, dirty, last_use, data).

    A present line is overwritten only by a STRICTLY newer timestamp; dead
    lanes (``live`` False) never write.  No eviction record is produced.
    """
    n, _, w_ways = tags.shape
    rows = torch.arange(n, device=tags.device)
    s = sidx.long()
    way, do_write = insert_plan(tags, data_ts, valid, last_use, keys, sidx,
                                line_ts, live)
    onehot = do_write[:, None] & (
        torch.arange(w_ways, device=tags.device)[None, :] == way[:, None]
    )                                                            # (N, W)

    def wr(field, value):
        new = torch.where(onehot, value[:, None].to(field.dtype), field[rows, s])
        return field.index_put((rows, s), new)

    now_n = torch.full((n,), now, dtype=torch.int32, device=tags.device)
    return (
        wr(tags, keys),
        wr(data_ts, line_ts),
        wr(ins_ts, now_n),
        wr(origin, line_origin),
        wr(valid, torch.ones_like(live)),
        wr(dirty, line_dirty),
        wr(last_use, now_n),
        data.index_put(
            (rows, s),
            torch.where(onehot[..., None], line_data[:, None, :], data[rows, s]),
        ),
    )


# ---------------------------------------------------------------------------
# flic_merge: soft-coherence merge of two aligned cache shards
# ---------------------------------------------------------------------------

def flic_merge_ref(tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b):
    """Line-wise newest-timestamp-wins merge (paper §I.A.a).

    ``tags``/``ts`` ``(S, W)`` int32, ``valid`` ``(S, W)`` bool, ``data``
    ``(S, W, D)`` float32, for replicas A and B.  B's line replaces A's
    when B is valid and (A invalid or B strictly newer): on equal
    timestamps A is kept, and two invalid lines give A's fields.  Returns
    (tags, ts, valid, data) as new tensors; ``valid`` is ``valid_a |
    valid_b``.
    """
    take_b = valid_b & (~valid_a | (ts_b > ts_a))
    return (
        torch.where(take_b, tags_b, tags_a),
        torch.where(take_b, ts_b, ts_a),
        valid_a | valid_b,
        torch.where(take_b[..., None], data_b, data_a),
    )


# ---------------------------------------------------------------------------
# payload_hash: the payload lanes of cache rows from their keys
# ---------------------------------------------------------------------------

def payload_hash_ref(key, data_ts, dim: int):
    """Deterministic payload lanes ~ U[0, 1) of rows ``key`` (any integer
    dtype; its low 32 bits): row base ``a = hash2_u32(key, data_ts)`` for a
    version's timestamp ``data_ts`` (same shape), else ``a = key`` when
    ``data_ts`` is ``None``; lane ``d`` is ``hash2_u32(a, d)`` as float32
    over 2**32.  Returns ``key.shape + (dim,)`` float32."""
    if data_ts is not None:
        key = hash2_u32(key, data_ts)
    lanes = hash2_u32_unsigned(
        key[..., None], torch.arange(dim, dtype=torch.int64, device=key.device)
    )
    return lanes.to(torch.float32) / float(2**32)


# ---------------------------------------------------------------------------
# ring_*: the write-behind ring of the fog tick (core/writeback.py)
# ---------------------------------------------------------------------------
#
# A fixed-size ring of ``Q`` slots (``keys``, ``data_ts``, ``origin``, int32)
# with monotone int32 ``head``/``tail`` counters (0-d tensors); the keyed
# mode adds a ``(K,)`` slot map of each key's newest monotone index.  JAX
# routes dead lanes of a scatter to an out-of-bounds slot that
# ``mode="drop"`` discards.  PyTorch has no such mode, so ``set_drop`` and
# ``max_drop`` scatter into one extra sink slot and slice it off.

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


def ring_enqueue_ref(keys, data_ts, origin, head, tail, dropped, in_keys, in_ts, in_origin,
                     mask):
    """Push the masked lanes in order; overflow drops the newest.  Returns
    new (keys, data_ts, origin, tail, dropped, n_accepted)."""
    cap = keys.shape[0]
    offs = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    free = cap - (tail - head)
    accept = mask & (offs < free)
    n_accept = _sum_i32(accept)
    slots = torch.where(accept, (tail + offs) % cap, cap)
    return (
        set_drop(keys, slots, in_keys),
        set_drop(data_ts, slots, in_ts),
        set_drop(origin, slots, in_origin),
        tail + n_accept,
        dropped + _sum_i32(mask & ~accept),
        n_accept,
    )


def ring_enqueue_keyed_ref(keys, data_ts, origin, head, tail, dropped, slot_of_key, coalesced,
                           key_ids, in_ts, in_origin, mask):
    """Push keyed writes, coalescing re-writes of pending keys.

    Per masked lane: a later lane of the same key supersedes it; a key with
    a PENDING slot is updated in place; otherwise the write is appended and
    the slot map records its monotone index.  Returns new (keys, data_ts,
    origin, tail, dropped, slot_of_key, coalesced, n_appended).
    """
    cap = keys.shape[0]
    ku = slot_of_key.shape[0]
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
    slot = slot_of_key[kid_safe]
    pending = rep & (slot >= head) & (slot < tail)
    fresh = rep & ~pending
    upd_slot = torch.where(pending, slot % cap, cap)

    # Append the fresh representatives (the overflow policy of ``ring_enqueue_ref``).
    offs = torch.cumsum(fresh.to(torch.int32), 0, dtype=torch.int32) - 1
    free = cap - (tail - head)
    accept = fresh & (offs < free)
    n_accept = _sum_i32(accept)
    slots = torch.where(accept, (tail + offs) % cap, cap)

    def write(buf, vals):
        return set_drop(set_drop(buf, upd_slot, vals), slots, vals)

    n_coalesced = _sum_i32(mask & ~rep) + _sum_i32(pending)
    return (
        write(keys, kid),
        write(data_ts, in_ts),
        write(origin, in_origin),
        tail + n_accept,
        dropped + _sum_i32(fresh & ~accept),
        set_drop(slot_of_key, torch.where(accept, kid, ku), tail + offs),
        coalesced + n_coalesced,
        n_accept,
    )


def ring_backstop_ref(head, tail, capacity: int, healthy, drained_total, need_store, enq_idx):
    """Route fog-missed reads (FIFO index durability) through the ring of
    ``capacity`` slots and the store of ``drained_total`` rows: returns
    (queue_hit, store_read, failed, found, in_store)."""
    in_pending = (enq_idx >= head) & (enq_idx < tail)
    in_ring = (enq_idx >= tail - capacity) & (enq_idx < tail)
    queue_hit = need_store & (in_pending | (~healthy & in_ring))
    store_read = need_store & ~queue_hit & healthy
    failed = need_store & ~queue_hit & ~healthy
    in_store = enq_idx < drained_total
    return queue_hit, store_read, failed, store_read & in_store, in_store


def ring_backstop_keyed_ref(head, tail, slot_of_key, data_ts, healthy, table_ts, need_store,
                            key_ids):
    """Keyed-durability routing through the ring (its slot map and
    ``data_ts``) and the store's table: returns (queue_hit, store_read,
    failed, found, served_ts), ``served_ts`` the version served (-1: none)."""
    cap = data_ts.shape[0]
    ku = slot_of_key.shape[0]
    kid = key_ids.clamp(0, ku - 1).long()
    slot = slot_of_key[kid]
    in_pending = (slot >= head) & (slot < tail)
    in_ring = (slot >= 0) & (slot >= tail - cap) & (slot < tail)
    queue_hit = need_store & (in_pending | (~healthy & in_ring))
    store_read = need_store & ~queue_hit & healthy
    failed = need_store & ~queue_hit & ~healthy
    durable_ts = table_ts[kid]
    found = store_read & (durable_ts >= 0)
    ring_ts = data_ts[(slot.clamp(min=0) % cap).long()]
    served_ts = torch.where(queue_hit, ring_ts, torch.where(found, durable_ts, -1))
    return queue_hit, store_read, failed, found, served_ts


def ring_drain_ref(head, tail, tokens, backoff, next_retry, now: int, store_ok,
                   rate_per_tick: float, burst: float, max_per_tick: int, backoff_base: int,
                   backoff_max: int):
    """One writer tick: drain one batch of up to ``max_per_tick`` rows (one
    API call).  On a failed attempt nothing drains and the backoff doubles.
    Returns new (head, tokens, backoff, next_retry, n_rows_drained,
    n_api_calls)."""
    tokens = torch.clamp(tokens + rate_per_tick, max=burst)
    can_try = (now >= next_retry) & (tokens >= 1.0)
    size = tail - head
    attempt = can_try & (size > 0)
    ok = attempt & store_ok
    n = torch.where(ok, torch.clamp(size, max=max_per_tick), 0)
    calls = attempt.to(torch.int32)
    failed = attempt & ~store_ok
    new_backoff = torch.where(
        failed,
        torch.clamp(torch.clamp(backoff * 2, min=backoff_base), max=backoff_max),
        torch.where(ok, 0, backoff),
    )
    next_retry = torch.where(failed, now + new_backoff, next_retry)
    return head + n, tokens - calls.to(torch.float32), new_backoff, next_retry, n, calls


def ring_drained_ref(keys, data_ts, head, n_drained, max_per_tick: int):
    """(key, data_ts, live) of the rows drained by the LAST drain, from the
    ring and ``head`` after it.  Static shape ``(max_per_tick,)``."""
    lane = torch.arange(max_per_tick, dtype=torch.int32, device=keys.device)
    idx = ((head - n_drained + lane) % keys.shape[0]).long()
    return keys[idx], data_ts[idx], lane < n_drained


# ---------------------------------------------------------------------------
# paged_attention: decode attention through a FLIC page table
# ---------------------------------------------------------------------------

def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """One-token attention per (sequence, KV head) over KV pages.

    ``q`` (B, Hkv, G, D); ``k_pages``/``v_pages`` (P, page, Hkv, D);
    ``page_table`` (B, max_pages) int32; ``lengths`` (B,) int32.  Gathers
    each sequence's pages, masks positions at or past ``lengths[b]`` with
    -1e30, takes a full softmax in float32 and returns ``q``'s dtype.
    """
    b, hkv, g, d = q.shape
    page = k_pages.shape[1]
    max_pages = page_table.shape[1]
    table = page_table.long()
    k = k_pages[table].reshape(b, max_pages * page, hkv, d)
    v = v_pages[table].reshape(b, max_pages * page, hkv, d)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) * inv_sqrt(d)
    mask = torch.arange(max_pages * page, device=q.device)[None] < lengths[:, None]
    s = torch.where(mask[:, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", w, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# ssd_scan: Mamba2 inter-chunk state recurrence (exclusive scan)
# ---------------------------------------------------------------------------

def _scan_dtype(t):
    """float32, or float64 for float64 inputs."""
    return torch.promote_types(t.dtype, torch.float32)


def ssd_scan_ref(states, chunk_decay, init=None):
    """The SSD chunk recurrence ``S_c = decay_c * S_{c-1} + states_c``.

    ``states`` (B, C, H, P, N) chunk-local states, ``chunk_decay`` (B, C, H)
    and ``init`` (B, H, P, N) (``None``: zeros), all read as float32
    (float64 stays float64, for ``gradcheck``).
    Returns (prev (B,C,H,P,N), final (B,H,P,N)) in float32: ``prev[:, c]``
    is the state entering chunk c (an exclusive scan), ``final`` the state
    after the last chunk.  Each step rounds the product, then the sum (a
    multiply, then an add; no fused multiply-add), as the CUDA kernel does.
    """
    b, c, h, p, n = states.shape
    dt = _scan_dtype(states)
    states = states.to(dt)
    decay = chunk_decay.to(dt)
    carry = (torch.zeros((b, h, p, n), dtype=dt, device=states.device)
             if init is None else init.to(dt))
    prev = torch.empty_like(states)
    for i in range(c):
        prev[:, i] = carry
        carry = decay[:, i, :, None, None] * carry + states[:, i]
    return prev, carry


def ssd_scan_bwd_ref(g_prev, g_final, prev, chunk_decay, with_init: bool = True):
    """The gradient of ``ssd_scan_ref``: a reverse scan of the forward's form
    plus a reduction over (P, N).

    ``g_prev`` (B, C, H, P, N) and ``g_final`` (B, H, P, N), the gradients
    of ``prev`` and ``final``; ``prev`` the forward's entering states and
    ``chunk_decay`` (B, C, H), all read as float32.  With ``A_c`` the
    adjoint of the state after chunk c, ``A_{C-1} = g_final`` and
    ``A_{c-1} = g_prev[c] + decay[c] * A_c``.  Returns (g_states =
    ``A``, (B,C,H,P,N); g_decay[b, c, h] = sum over (p, n) of
    ``A_c * prev[c]``, (B,C,H); g_init = ``g_prev[0] + decay[0] * A_0``,
    (B,H,P,N), or ``None`` without ``with_init``), all float32.  Each step
    rounds the product, then the sum, as the CUDA kernel does; the (P, N)
    sums of ``g_decay`` are PyTorch's, whose order the kernel does not
    follow.  float64 inputs stay float64.
    """
    b, c, h, p, n = g_prev.shape
    dt = _scan_dtype(g_prev)
    g_prev = g_prev.to(dt)
    prev = prev.to(dt)
    decay = chunk_decay.to(dt)
    carry = g_final.to(dt).clone()
    g_states = torch.empty_like(g_prev)
    g_decay = torch.empty((b, c, h), dtype=dt, device=g_prev.device)
    for i in reversed(range(c)):
        g_states[:, i] = carry
        g_decay[:, i] = (carry * prev[:, i]).sum(dim=(-2, -1))
        carry = g_prev[:, i] + decay[:, i, :, None, None] * carry
    return g_states, g_decay, carry if with_init else None


def ssd_scan_bwd_decay_tol(g_states, prev, ulps: int = 64):
    """The stated tolerance of a ``g_decay`` whose (P, N) sums were taken in
    another order: ``ulps`` float32 units of roundoff (2**-24) times the sum
    of the products' magnitudes, per (b, c, h).  Any order of summing n
    terms errs by at most (its longest chain of additions) x 2**-24 x that
    magnitude sum; the kernel's chain is 5 shuffle levels + 8 warp sums +
    ceil(P*N / 256) block partials (45 at P*N = 8,192), and a random walk
    over a chain keeps far below its bound."""
    mag = (g_states.float().abs() * prev.float().abs()).sum(dim=(-2, -1))
    return ulps * 2.0**-24 * mag + torch.finfo(torch.float32).tiny
