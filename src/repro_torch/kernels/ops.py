"""Wrappers of the hand-written CUDA kernels, with their launch counts.

Each wrapper takes the arguments of its plain version in ``kernels/ref.py``.
On CPU tensors it returns the plain version's result; on CUDA tensors it
checks device, dtype, shape and contiguity, allocates outputs and scratch,
launches the kernel from ``csrc/`` on the current stream and raises if the
launch reports an error.  There is no fallback: a CUDA tensor either goes
through the kernel or the call raises.

The FLIC kernels update the cache tables IN PLACE (``flic_insert`` all
eight, ``flic_update`` ``data_ts``/``last_use``/``data``) and return those
same tensors; the plain versions return new ones.  ``flic_merge``,
``paged_attention``, ``ssd_scan``, ``payload_hash`` and the ``ring_*``
entries allocate their outputs.  ``payload_hash`` is the fog tick's payload
hash (``core/workload.py``'s ``payload_for`` and ``versioned_payload``); the
six ``ring_*`` entries of ``csrc/ring.cu`` are the calls of the fog tick's
writer ring (``core/writeback.py``, ``simulator._resolve_backstop{,_keyed}``).
Like ``ssd_scan_bwd`` they replace no Pallas kernel (XLA fuses them there).

``flic_insert``, ``flic_lookup`` and ``flic_merge`` launch the
instantiation of their kernel that ``insert_plan_for`` /
``lookup_plan_for`` / ``merge_plan_for`` pick from the arguments' shapes
and alignment; ``paged_attention`` copies K/V rows in the unit that
``paged_row_plan`` picks.

``LAUNCHES[name]`` counts the calls that launched kernel ``name``.
``ssd_scan_bwd`` (the gradient of ``ssd_scan``, through ``SSDScan``) is
the second entry of ``csrc/ssd_scan.cu``, counted under its own name, as
each ``ring_*`` entry of ``csrc/ring.cu`` is (``SOURCE``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

RING_ENTRIES = ("ring_enqueue", "ring_enqueue_keyed", "ring_backstop", "ring_backstop_keyed",
                "ring_drain", "ring_drained")
LAUNCHES: dict[str, int] = {
    "flic_insert": 0, "flic_update": 0, "flic_lookup": 0, "flic_merge": 0,
    "paged_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, "payload_hash": 0,
    **{name: 0 for name in RING_ENTRIES},
}
# Launch names whose entry lives in another kernel's source.
SOURCE = {"ssd_scan_bwd": "ssd_scan", **{name: "ring" for name in RING_ENTRIES}}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}: use 'cpu' or 'cuda'")
    return True


def _check(device, **tensors) -> None:
    """``name=(tensor, dtype, shape)`` -> raise on a mismatch."""
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _launcher(name: str, n_ptr: int, n_int: int):
    """The C launcher of kernel ``name``, resolved and typed once."""
    fn = getattr(build.library(SOURCE.get(name, name)), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device, tensors, ints) -> None:
    """Launch kernel ``name``; a ``None`` among ``tensors`` is a null pointer."""
    fn = _launcher(name, len(tensors), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in tensors], *ints, stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


I32, F32, BF16, BOOL = torch.int32, torch.float32, torch.bfloat16, torch.bool


# Ways with a compile-time instantiation of the FLIC row kernels
# (flic_insert, flic_lookup); other W take the runtime-W loop.
TEMPLATE_WAYS = (1, 2, 4, 8)


class RowPlan(NamedTuple):
    """An instantiation of the ``flic_insert`` or ``flic_lookup`` kernel.
    ``ways``: the compile-time W, or 0 for the runtime-W loop; ``row16``:
    set rows read as 16-byte words; ``pay16``: payload copied as float4."""
    ways: int
    row16: bool
    pay16: bool


def row_plan(w: int, d: int, aligned: bool) -> RowPlan:
    """The instantiation for W ways, D payload floats and ``aligned`` (the
    tensors the kernel reads and writes in 16-byte words start on 16-byte
    boundaries): compile-time W for W in ``TEMPLATE_WAYS``; 16-byte rows
    where aligned and W > 1; float4 payloads where aligned and D % 4 == 0."""
    ways = w if w in TEMPLATE_WAYS else 0
    return RowPlan(ways, aligned and ways > 1, aligned and d % 4 == 0)


def row_plans() -> list[RowPlan]:
    """Every instantiation of either kernel (what ``row_plan`` can return)."""
    return sorted({row_plan(w, d, a) for w in (*TEMPLATE_WAYS, 3) for d in (3, 8)
                   for a in (False, True)})


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def insert_plan_for(tags, data_ts, ins_ts, origin, valid, dirty, last_use, data,
                    keys, sidx, line_ts, line_origin, line_dirty, live, line_data,
                    now=None) -> RowPlan:
    """The instantiation ``flic_insert`` launches for these arguments:
    aligned where the eight tables and ``line_data`` are."""
    return row_plan(tags.shape[-1], data.shape[-1],
                    _aligned(tags, data_ts, ins_ts, origin, valid, dirty, last_use, data,
                             line_data))


def lookup_plan_for(tags, data_ts, valid, data, keys, sidx) -> RowPlan:
    """The instantiation ``flic_lookup`` launches for these arguments:
    aligned where the four tables are (its outputs are fresh, aligned)."""
    return row_plan(tags.shape[-1], data.shape[-1], _aligned(tags, data_ts, valid, data))


def insert_threads(n: int, n_sms: int) -> int:
    """Block size of ``flic_insert`` for N nodes: one warp a block while
    128-thread blocks would leave most SMs idle (N < 64 per SM), so that
    the row loads spread over more SMs; else 128."""
    return 128 if n >= 64 * n_sms else 32


def lookup_threads(q: int) -> int:
    """Block size of ``flic_lookup`` (queries of one cache a block): up to
    256, no more warps than Q needs."""
    return min(256, max(1, -(-q // 32)) * 32)


def flic_insert(tags, data_ts, ins_ts, origin, valid, dirty, last_use, data,
                keys, sidx, line_ts, line_origin, line_dirty, live, line_data,
                now: int):
    """One-line-per-node upsert; see ``ref.flic_insert_ref``.  Returns the
    eight tables (on CUDA: the input tensors, updated in place)."""
    if not _on_cuda(tags):
        return ref.flic_insert_ref(
            tags, data_ts, ins_ts, origin, valid, dirty, last_use, data, keys,
            sidx, line_ts, line_origin, line_dirty, live, line_data, now,
        )
    n, s, w = tags.shape
    d = data.shape[-1]
    tab, lane = (n, s, w), (n,)
    _check(
        tags.device,
        tags=(tags, I32, tab), data_ts=(data_ts, I32, tab), ins_ts=(ins_ts, I32, tab),
        origin=(origin, I32, tab), valid=(valid, BOOL, tab), dirty=(dirty, BOOL, tab),
        last_use=(last_use, I32, tab), data=(data, F32, (n, s, w, d)),
        keys=(keys, I32, lane), sidx=(sidx, I32, lane), line_ts=(line_ts, I32, lane),
        line_origin=(line_origin, I32, lane), line_dirty=(line_dirty, BOOL, lane),
        live=(live, BOOL, lane), line_data=(line_data, F32, (n, d)),
    )
    args = (tags, data_ts, ins_ts, origin, valid, dirty, last_use, data, keys, sidx,
            line_ts, line_origin, line_dirty, live, line_data)
    plan = insert_plan_for(*args)
    _launch(
        "flic_insert", tags.device, args,
        (int(now), n, s, w, d, plan.ways, int(plan.row16), int(plan.pay16),
         insert_threads(n, sm_count(tags.device))),
    )
    return tags, data_ts, ins_ts, origin, valid, dirty, last_use, data


def flic_update(tags, data_ts, valid, last_use, data, keys, sidx, row_ts,
                row_data, live, now: int):
    """Coherence sweep of N caches by R rows; see ``ref.flic_update_ref``.
    Returns (data_ts, last_use, data, n_upd (N,)); on CUDA the first three
    are the input tensors, updated in place."""
    if not _on_cuda(tags):
        return ref.flic_update_ref(
            tags, data_ts, valid, last_use, data, keys, sidx, row_ts, row_data,
            live, now,
        )
    n, s, w = tags.shape
    d = data.shape[-1]
    r = keys.shape[0]
    tab = (n, s, w)
    _check(
        tags.device,
        tags=(tags, I32, tab), data_ts=(data_ts, I32, tab), valid=(valid, BOOL, tab),
        last_use=(last_use, I32, tab), data=(data, F32, (n, s, w, d)),
        keys=(keys, I32, (r,)), sidx=(sidx, I32, (r,)), row_ts=(row_ts, I32, (r,)),
        row_data=(row_data, F32, (r, d)), live=(live, BOOL, (n, r)),
    )
    counts = torch.empty((n,), dtype=I32, device=tags.device)
    _launch(
        "flic_update", tags.device,
        (tags, data_ts, valid, last_use, data, keys, sidx, row_ts, row_data, live, counts),
        (int(now), n, r, s, w, d),
    )
    return data_ts, last_use, data, counts


def flic_lookup(tags, data_ts, valid, data, keys, sidx):
    """Probe of C caches by Q shared queries; see ``ref.flic_lookup_ref``.
    Returns (hit (C,Q), ts (C,Q), payload (C,Q,D), way (C,Q))."""
    if not _on_cuda(tags):
        return ref.flic_lookup_ref(tags, data_ts, valid, data, keys, sidx)
    c, s, w = tags.shape
    d = data.shape[-1]
    q = keys.shape[0]
    tab = (c, s, w)
    _check(
        tags.device,
        tags=(tags, I32, tab), data_ts=(data_ts, I32, tab), valid=(valid, BOOL, tab),
        data=(data, F32, (c, s, w, d)), keys=(keys, I32, (q,)), sidx=(sidx, I32, (q,)),
    )
    threads = lookup_threads(q)
    if -(-q // threads) > 65_535:
        raise ValueError(f"{q} queries exceed the kernel's grid limit")
    plan = lookup_plan_for(tags, data_ts, valid, data, keys, sidx)
    dev = tags.device
    hit = torch.empty((c, q), dtype=BOOL, device=dev)
    ts = torch.empty((c, q), dtype=I32, device=dev)
    payload = torch.empty((c, q, d), dtype=F32, device=dev)
    way = torch.empty((c, q), dtype=I32, device=dev)
    _launch(
        "flic_lookup", dev,
        (tags, data_ts, valid, data, keys, sidx, hit, ts, payload, way),
        (c, q, s, w, d, plan.ways, int(plan.row16), int(plan.pay16), threads),
    )
    return hit, ts, payload, way


class MergePlan(NamedTuple):
    """An instantiation of the ``flic_merge`` kernel.  ``ways``: the
    compile-time W, or 0 for the S * W lines taken one by one (any W);
    ``vec``: 16-byte metadata rows and payload chunks."""
    ways: int
    vec: bool


def merge_plan(w: int, d: int, aligned: bool) -> MergePlan:
    """The instantiation for W ways, D payload floats and ``aligned`` (all
    twelve tables start on 16-byte boundaries): 16-byte accesses at
    compile-time W where aligned, D % 4 == 0 and W is in
    ``TEMPLATE_WAYS``; else the lines one by one, in 4-byte words."""
    if aligned and d % 4 == 0 and w in TEMPLATE_WAYS:
        return MergePlan(w, True)
    return MergePlan(0, False)


def merge_plans() -> list[MergePlan]:
    """Every instantiation of the kernel (what ``merge_plan`` can return)."""
    return sorted({MergePlan(w, True) for w in TEMPLATE_WAYS} | {MergePlan(0, False)})


def merge_plan_for(tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b) -> MergePlan:
    """The instantiation ``flic_merge`` launches for these arguments:
    aligned where the eight inputs are (its outputs are fresh, aligned)."""
    return merge_plan(tags_a.shape[-1], data_a.shape[-1],
                      _aligned(tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b))


MERGE_SETS_PER_BLOCK = 16
MERGE_BLOCKS_PER_SM = 24


def merge_blocks(n_sets: int, n_sms: int) -> int:
    """Grid of ``flic_merge`` for ``n_sets`` sets of its plan (the lines,
    for ``ways`` 0): one-warp blocks of ``MERGE_SETS_PER_BLOCK`` sets, so
    that a small merge spreads over as many SMs as it has warps; at most
    ``MERGE_BLOCKS_PER_SM`` blocks an SM, which walk the rest by a grid
    stride."""
    return max(1, min(-(-n_sets // MERGE_SETS_PER_BLOCK), MERGE_BLOCKS_PER_SM * n_sms))


def flic_merge(tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b):
    """Newest-timestamp-wins merge of two aligned cache shards; see
    ``ref.flic_merge_ref``.  ``(S, W)`` int32 tags and timestamps, bool
    valid flags, ``(S, W, D)`` float32 payloads; any S, W and D.  Returns
    new (tags, ts, valid, data)."""
    if not _on_cuda(tags_a):
        return ref.flic_merge_ref(tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b)
    s, w = tags_a.shape
    d = data_a.shape[-1]
    tab, pay = (s, w), (s, w, d)
    _check(
        tags_a.device,
        tags_a=(tags_a, I32, tab), ts_a=(ts_a, I32, tab), valid_a=(valid_a, BOOL, tab),
        data_a=(data_a, F32, pay), tags_b=(tags_b, I32, tab), ts_b=(ts_b, I32, tab),
        valid_b=(valid_b, BOOL, tab), data_b=(data_b, F32, pay),
    )
    args = (tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b)
    plan = merge_plan_for(*args)
    out = tuple(torch.empty_like(t) for t in args[:4])
    sets = s if plan.ways else s * w
    _launch(
        "flic_merge", tags_a.device, (*args, *out),
        (s, w, d, plan.ways, int(plan.vec), merge_blocks(sets, sm_count(tags_a.device))),
    )
    return out


def payload_hash(key, data_ts, dim: int):
    """The payload lanes of rows ``key`` at version ``data_ts`` (``None``:
    an immutable key's payload); see ``ref.payload_hash_ref``.  ``key`` of
    any integer dtype and shape (only its low 32 bits matter: on CUDA
    another dtype is cast to int32), ``data_ts`` of its shape.  Returns
    ``key.shape + (dim,)`` float32, on CUDA bit for bit the plain
    version's.  On CUDA, int32 contiguous inputs launch the kernel and
    nothing else."""
    if not _on_cuda(key):
        return ref.payload_hash_ref(key, data_ts, dim)
    if data_ts is not None and data_ts.shape != key.shape:
        raise ValueError(f"data_ts has shape {tuple(data_ts.shape)}, expected {tuple(key.shape)}")
    m = key.numel()
    if m > ref.INT32_MAX:
        raise ValueError(f"{m} rows exceed the kernel's limit of 2**31 - 1")
    rows = {"key": _i32_rows(key)}
    if data_ts is not None:
        rows["data_ts"] = _i32_rows(data_ts)
    _check(key.device, **{name: (t, I32, (m,)) for name, t in rows.items()})
    out = torch.empty((*key.shape, dim), dtype=F32, device=key.device)
    _launch("payload_hash", key.device, (rows["key"], rows.get("data_ts"), out), (m, dim))
    return out


def _i32_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a 1-D int32 tensor: a view where it is int32 and contiguous."""
    return (t if t.dtype == I32 else t.to(I32)).contiguous().view(-1)


# The writer ring (csrc/ring.cu).  Each entry takes the ring's tensors and
# returns new ones (the parent ring is never written): on CUDA, views of an
# output buffer for the ring's arrays and of a small one for its scalars
# (a tick's metrics keep scalars; they must not keep the ring).  Lane values
# the plain version casts to int32 are cast here too (no launch where they
# are int32 already).

def _scalars(**scalars) -> dict:
    """``name=(tensor, dtype)`` of 0-d tensors -> the ``_check`` entries."""
    return {name: (t, dtype, ()) for name, (t, dtype) in scalars.items()}


def ring_enqueue(keys, data_ts, origin, head, tail, dropped, in_keys, in_ts, in_origin, mask):
    """FIFO push of the masked lanes, overflow dropping the newest; see
    ``ref.ring_enqueue_ref``.  Returns new (keys, data_ts, origin, tail,
    dropped, n_accepted)."""
    if not _on_cuda(keys):
        return ref.ring_enqueue_ref(keys, data_ts, origin, head, tail, dropped, in_keys, in_ts,
                                    in_origin, mask)
    q, r = keys.shape[0], mask.shape[0]
    in_keys, in_ts, in_origin = (_i32_rows(t) for t in (in_keys, in_ts, in_origin))
    dev = keys.device
    _check(dev, keys=(keys, I32, (q,)), data_ts=(data_ts, I32, (q,)), origin=(origin, I32, (q,)),
           in_keys=(in_keys, I32, (r,)), in_ts=(in_ts, I32, (r,)),
           in_origin=(in_origin, I32, (r,)), mask=(mask, BOOL, (r,)),
           **_scalars(head=(head, I32), tail=(tail, I32), dropped=(dropped, I32)))
    ring = torch.empty((3, q), dtype=I32, device=dev)
    scalars = torch.empty((3,), dtype=I32, device=dev)
    _launch("ring_enqueue", dev,
            (keys, data_ts, origin, head, tail, dropped, in_keys, in_ts, in_origin, mask, ring,
             scalars),
            (q, r))
    return (*ring.unbind(), *scalars.unbind())


def ring_enqueue_keyed(keys, data_ts, origin, head, tail, dropped, slot_of_key, coalesced,
                       key_ids, in_ts, in_origin, mask):
    """Keyed push: in-batch dedup, coalescing into pending slots, append;
    see ``ref.ring_enqueue_keyed_ref``.  Returns new (keys, data_ts, origin,
    tail, dropped, slot_of_key, coalesced, n_appended).  On CUDA at most
    393,216 lanes (the kernel keeps a bit a lane in 48 KB of shared memory;
    its launcher refuses more)."""
    if not _on_cuda(keys):
        return ref.ring_enqueue_keyed_ref(keys, data_ts, origin, head, tail, dropped,
                                          slot_of_key, coalesced, key_ids, in_ts, in_origin,
                                          mask)
    q, ku, r = keys.shape[0], slot_of_key.shape[0], mask.shape[0]
    key_ids, in_ts, in_origin = (_i32_rows(t) for t in (key_ids, in_ts, in_origin))
    dev = keys.device
    _check(dev, keys=(keys, I32, (q,)), data_ts=(data_ts, I32, (q,)), origin=(origin, I32, (q,)),
           slot_of_key=(slot_of_key, I32, (ku,)), key_ids=(key_ids, I32, (r,)),
           in_ts=(in_ts, I32, (r,)), in_origin=(in_origin, I32, (r,)), mask=(mask, BOOL, (r,)),
           **_scalars(head=(head, I32), tail=(tail, I32), dropped=(dropped, I32),
                      coalesced=(coalesced, I32)))
    ring = torch.empty((3 * q + ku,), dtype=I32, device=dev)
    scalars = torch.empty((4,), dtype=I32, device=dev)
    _launch("ring_enqueue_keyed", dev,
            (keys, data_ts, origin, head, tail, dropped, slot_of_key, coalesced, key_ids, in_ts,
             in_origin, mask, ring, scalars),
            (q, ku, r))
    k, ts, org, slots = ring.split((q, q, q, ku))
    tail, dropped, coalesced, n_accept = scalars.unbind()
    return k, ts, org, tail, dropped, slots, coalesced, n_accept


def ring_backstop(head, tail, capacity: int, healthy, drained_total, need_store, enq_idx):
    """Fog-missed reads against the FIFO ring and the store; see
    ``ref.ring_backstop_ref``.  Returns (queue_hit, store_read, failed,
    found, in_store), (R,) bool."""
    if not _on_cuda(need_store):
        return ref.ring_backstop_ref(head, tail, capacity, healthy, drained_total, need_store,
                                     enq_idx)
    r = need_store.shape[0]
    dev = need_store.device
    _check(dev, need_store=(need_store, BOOL, (r,)), enq_idx=(enq_idx, I32, (r,)),
           **_scalars(head=(head, I32), tail=(tail, I32), healthy=(healthy, BOOL),
                      drained_total=(drained_total, I32)))
    out = torch.empty((5, r), dtype=BOOL, device=dev)
    _launch("ring_backstop", dev, (head, tail, healthy, drained_total, need_store, enq_idx, out),
            (int(capacity), r))
    return out.unbind()


def ring_backstop_keyed(head, tail, slot_of_key, data_ts, healthy, table_ts, need_store,
                        key_ids):
    """Fog-missed reads against the keyed ring (its slot map and
    ``data_ts``) and the store's ``(K,)`` table; see
    ``ref.ring_backstop_keyed_ref``.  Returns (queue_hit, store_read,
    failed, found) (R,) bool and served_ts (R,) int32."""
    if not _on_cuda(need_store):
        return ref.ring_backstop_keyed_ref(head, tail, slot_of_key, data_ts, healthy, table_ts,
                                           need_store, key_ids)
    q, ku, r = data_ts.shape[0], slot_of_key.shape[0], need_store.shape[0]
    dev = need_store.device
    _check(dev, slot_of_key=(slot_of_key, I32, (ku,)), data_ts=(data_ts, I32, (q,)),
           table_ts=(table_ts, I32, (ku,)), need_store=(need_store, BOOL, (r,)),
           key_ids=(key_ids, I32, (r,)),
           **_scalars(head=(head, I32), tail=(tail, I32), healthy=(healthy, BOOL)))
    flags = torch.empty((4, r), dtype=BOOL, device=dev)
    served_ts = torch.empty((r,), dtype=I32, device=dev)
    _launch("ring_backstop_keyed", dev,
            (head, tail, slot_of_key, data_ts, healthy, table_ts, need_store, key_ids, flags,
             served_ts),
            (q, ku, r))
    return (*flags.unbind(), served_ts)


def _f32_bits(x: float) -> int:
    """The bit pattern of ``x`` rounded to float32, as PyTorch rounds a
    Python scalar into a float32 op, as a signed 32-bit int."""
    return int(np.float32(x).view(np.int32))


def _i32_arg(name: str, v: int) -> int:
    if not -2**31 <= int(v) < 2**31:
        raise ValueError(f"{name} = {v} is outside int32")
    return int(v)


def ring_drain(head, tail, tokens, backoff, next_retry, now: int, store_ok,
               rate_per_tick: float, burst: float, max_per_tick: int, backoff_base: int,
               backoff_max: int):
    """One writer tick; see ``ref.ring_drain_ref``.  Returns new (head,
    tokens, backoff, next_retry, n_rows_drained, n_api_calls)."""
    if not _on_cuda(head):
        return ref.ring_drain_ref(head, tail, tokens, backoff, next_retry, now, store_ok,
                                  rate_per_tick, burst, max_per_tick, backoff_base, backoff_max)
    dev = head.device
    _check(dev, **_scalars(head=(head, I32), tail=(tail, I32), tokens=(tokens, F32),
                           backoff=(backoff, I32), next_retry=(next_retry, I32),
                           store_ok=(store_ok, BOOL)))
    out = torch.empty((5,), dtype=I32, device=dev)
    tokens_out = torch.empty((), dtype=F32, device=dev)
    _launch("ring_drain", dev, (head, tail, tokens, backoff, next_retry, store_ok, out, tokens_out),
            (_i32_arg("now", now), _f32_bits(rate_per_tick), _f32_bits(burst),
             _i32_arg("max_per_tick", max_per_tick), _i32_arg("backoff_base", backoff_base),
             _i32_arg("backoff_max", backoff_max)))
    head, backoff, next_retry, n, calls = out.unbind()
    return head, tokens_out, backoff, next_retry, n, calls


def ring_drained(keys, data_ts, head, n_drained, max_per_tick: int):
    """(key, data_ts, live) of the rows the last drain took; see
    ``ref.ring_drained_ref``.  Static shape ``(max_per_tick,)``."""
    if not _on_cuda(keys):
        return ref.ring_drained_ref(keys, data_ts, head, n_drained, max_per_tick)
    q, m = keys.shape[0], int(max_per_tick)
    dev = keys.device
    _check(dev, keys=(keys, I32, (q,)), data_ts=(data_ts, I32, (q,)),
           **_scalars(head=(head, I32), n_drained=(n_drained, I32)))
    rows = torch.empty((2, m), dtype=I32, device=dev)
    live = torch.empty((m,), dtype=BOOL, device=dev)
    _launch("ring_drained", dev, (keys, data_ts, head, n_drained, rows, live), (q, m))
    return (*rows.unbind(), live)


# The paged_attention kernel's split over the KV length: the blocks per SM a
# plan aims for, and the fewest and the most page slots of one split (a
# block stages its page ids in shared memory).
SPLIT_BLOCKS_PER_SM = 16
SPLIT_MIN_PAGES = 4
SPLIT_MAX_PAGES = 512


def paged_split_plan(b: int, hkv: int, max_pages: int, n_sms: int) -> tuple[int, int]:
    """(splits, pages_per_split) of ``paged_attention`` over the KV length.

    From the shapes alone, never ``lengths`` (reading them would make the
    host wait for the card): enough splits that the B * Hkv (sequence, KV
    head) pairs make about ``SPLIT_BLOCKS_PER_SM`` blocks per SM, with
    ``SPLIT_MIN_PAGES`` to ``SPLIT_MAX_PAGES`` page slots a split (fewer
    only where the table has fewer).  Split ``s`` takes slots
    ``[s * pages_per_split, (s + 1) * pages_per_split)``; the ranges cover
    the ``max_pages`` slots once and none is empty.
    """
    want = -(-SPLIT_BLOCKS_PER_SM * n_sms // max(1, b * hkv))
    per = max(-(-max_pages // want), min(SPLIT_MIN_PAGES, max_pages))
    per = min(per, SPLIT_MAX_PAGES)
    return -(-max_pages // per), per


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# The paged_attention kernel's arrival counters, by (device index, stream).
_ARRIVALS: dict[tuple[int, int], torch.Tensor] = {}


def _arrivals(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of the ``paged_attention``
    kernel for calls on ``stream`` (a stream handle, or any key) of
    ``device``, zero between calls (each call leaves them at 0); allocated
    once for each stream and grown when a call needs more.  Calls on one
    stream run one after another, so they share a buffer; calls on two
    streams may overlap, so they never do."""
    key = (device.index or 0, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[key] = torch.zeros(max(n, 4096), dtype=I32, device=device)
    return buf


PAGED_MAX_ROW_BYTES = 512


def _ptr_align(*tensors) -> int:
    """The largest power of two up to 16 that divides every address."""
    addr = 16
    for t in tensors:
        addr |= t.data_ptr()
    return addr & -addr


def paged_row_plan(d: int, itemsize: int, ptr_align: int) -> int:
    """The unit, in bytes, in which ``paged_attention`` copies a K/V row of
    D values of ``itemsize`` bytes from pages whose addresses are multiples
    of ``ptr_align``: the largest of 16 (``cp.async.cg``), 8, 4
    (``cp.async.ca``) and 2 (ordinary loads) that divides both the row's
    bytes and ``ptr_align`` (every row starts a multiple of its own size
    past the pages' start).  Rows above ``PAGED_MAX_ROW_BYTES`` (D > 256 in
    bfloat16, D > 128 in float32; no config of the repo has one) are
    refused: the kernel keeps a sub-tile's rows in shared memory and a
    lane's share of a row in registers."""
    row = d * itemsize
    if not 0 < row <= PAGED_MAX_ROW_BYTES:
        raise ValueError(f"K/V rows of {row} bytes: the kernel takes 1 to "
                         f"{PAGED_MAX_ROW_BYTES} bytes")
    unit = 16
    while row % unit or ptr_align % unit:
        unit //= 2
    return unit


def paged_row_plan_for(q, k_pages, v_pages, page_table, lengths) -> int:
    """The unit of the row copies ``paged_attention`` makes for these
    arguments (``paged_row_plan`` of their D, K/V dtype and alignment)."""
    return paged_row_plan(q.shape[-1], k_pages.element_size(), _ptr_align(k_pages, v_pages))


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """Decode attention through a page table; see ``ref.paged_attention_ref``.

    ``q`` (B, Hkv, G, D) and ``k_pages``/``v_pages`` (P, page, Hkv, D) in
    bfloat16 or float32 (K and V alike; on CUDA not a bfloat16 ``q`` over
    float32 pages), ``page_table`` (B, max_pages) and ``lengths`` (B,)
    int32.  Returns (B, Hkv, G, D) in ``q``'s dtype.
    On CUDA, a K/V row (D * bytes of a value) must be at most 512 bytes
    (``paged_row_plan``, which also picks the unit of the row copies from
    the row's size and the pages' alignment), every page id must lie in
    [0, P) (a (sequence, head) with one outside gets NaN), and B <= 65,535.
    The kernel splits each sequence's page slots over blocks
    (``paged_split_plan``); the last split of a (sequence, head) to finish
    merges the splits' partial softmax states in split order, counted in on
    counters that this module keeps for each stream (``_arrivals``).
    """
    if not _on_cuda(q):
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table, lengths)
    b, hkv, g, d = q.shape
    n_pool, page = k_pages.shape[:2]
    max_pages = page_table.shape[-1]
    if (q.dtype, k_pages.dtype) not in ((BF16, BF16), (F32, BF16), (F32, F32)):
        raise ValueError(f"q and K/V dtypes {q.dtype}, {k_pages.dtype}: the kernel takes "
                         "bfloat16/bfloat16, float32/bfloat16 or float32/float32")
    kv = (n_pool, page, hkv, d)
    _check(
        q.device,
        q=(q, q.dtype, (b, hkv, g, d)), k_pages=(k_pages, k_pages.dtype, kv),
        v_pages=(v_pages, k_pages.dtype, kv), page_table=(page_table, I32, (b, max_pages)),
        lengths=(lengths, I32, (b,)),
    )
    chunk = paged_row_plan_for(q, k_pages, v_pages, page_table, lengths)
    if b > 65_535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65,535")
    if max_pages == 0:
        raise ValueError("page_table has no page slots")
    out = torch.empty_like(q)
    splits, per = paged_split_plan(b, hkv, max_pages, sm_count(q.device))
    part = arrivals = None
    if splits > 1:
        part = torch.empty(b * hkv * splits * g * (d + 2), dtype=F32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        arrivals = _arrivals(q.device, stream, b * hkv * -(-g // 4))
    _launch(
        "paged_attention", q.device,
        (q, k_pages, v_pages, page_table, lengths, out, part, arrivals),
        (b, hkv, g, d, page, n_pool, max_pages, splits, per, int(q.dtype == BF16),
         int(k_pages.dtype == BF16), chunk),
    )
    return out


def ssd_scan(states, chunk_decay, init=None):
    """The Mamba2 inter-chunk recurrence; see ``ref.ssd_scan_ref``.

    ``states`` (B, C, H, P, N), ``chunk_decay`` (B, C, H) and ``init``
    (B, H, P, N) or ``None`` (zeros); on CUDA all float32 and contiguous.
    Returns (prev (B,C,H,P,N), final (B,H,P,N)) in float32.  Where a
    gradient is required (grad mode on and an input that requires one) the
    call goes through ``SSDScan``, whose backward is ``ssd_scan_bwd``; the
    outputs are the same.

    DTensor inputs (under a plan of ``repro_torch.shard``) run under
    ``local_map``: each rank scans its own batch rows and heads, laid out
    as the plan's ``batch`` and ``act_ssm`` say (``_scan_placements``).
    The recurrence is independent per head, so sharding heads is exact.
    """
    if _is_dtensor(states):
        from repro_torch.shard.partition import on_ranks

        pl = _scan_placements(states)
        return on_ranks(ssd_scan, out_placements=(pl["states"], pl["init"]),
                        in_placements=(pl["states"], pl["decay"],
                                       pl["init"] if init is not None else None))(
            states, chunk_decay, init)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (states, chunk_decay, init)):
        return SSDScan.apply(states, chunk_decay, init)
    return _ssd_scan_fwd(states, chunk_decay, init)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _scan_placements(states):
    """The placements of the scan's tensors under the active plan:
    batch rows as ``batch``, heads as ``act_ssm``, fitted to the shapes;
    keys ``states`` (B,C,H,P,N), ``decay`` (B,C,H) and ``init`` (B,H,P,N)."""
    from repro_torch.shard.partition import current_rules, placements_for

    mesh, plan = current_rules()
    if mesh is None:
        raise ValueError("DTensor scan inputs need a plan: run under shard.use_rules")
    b, c, h, p, n = states.shape
    return {
        "states": placements_for(("batch", None, "act_ssm", None, None), (b, c, h, p, n), mesh,
                                 plan),
        "decay": placements_for(("batch", None, "act_ssm"), (b, c, h), mesh, plan),
        "init": placements_for(("batch", "act_ssm", None, None), (b, h, p, n), mesh, plan),
    }


def _ssd_scan_fwd(states, chunk_decay, init):
    if not _on_cuda(states):
        return ref.ssd_scan_ref(states, chunk_decay, init)
    b, c, h, p, n = states.shape
    checks = dict(states=(states, F32, (b, c, h, p, n)), chunk_decay=(chunk_decay, F32, (b, c, h)))
    if init is not None:
        checks["init"] = (init, F32, (b, h, p, n))
    _check(states.device, **checks)
    prev = torch.empty_like(states)
    final = torch.empty((b, h, p, n), dtype=F32, device=states.device)
    _launch("ssd_scan", states.device, (states, chunk_decay, init, prev, final),
            (b, c, h, p * n))
    return prev, final


SSD_BWD_THREADS = 256   # lanes of one block of ssd_scan_bwd (kBwdThreads in ssd_scan.cu)


def ssd_scan_bwd(g_prev, g_final, prev, chunk_decay, with_init: bool = True):
    """The gradient of ``ssd_scan``; see ``ref.ssd_scan_bwd_ref``.

    ``g_prev``/``prev`` (B, C, H, P, N), ``g_final`` (B, H, P, N),
    ``chunk_decay`` (B, C, H); on CUDA all float32 and contiguous, B * H
    <= 65,535.  Returns (g_states, g_decay (B,C,H), g_init or ``None``
    without ``with_init``) in float32.  On CUDA ``g_states`` and ``g_init``
    equal the plain version bitwise; ``g_decay``'s (P, N) sums are taken in
    the kernel's fixed order (``ref.ssd_scan_bwd_decay_tol``), the same
    bits on every call.  DTensor inputs run under ``local_map`` with
    ``ssd_scan``'s placements.
    """
    if _is_dtensor(g_prev):
        from repro_torch.shard.partition import on_ranks

        pl = _scan_placements(g_prev)
        return on_ranks(ssd_scan_bwd, out_placements=(pl["states"], pl["decay"],
                                                       pl["init"] if with_init else None),
                        in_placements=(pl["states"], pl["init"], pl["states"], pl["decay"], None))(
            g_prev, g_final, prev, chunk_decay, with_init)
    if not _on_cuda(g_prev):
        return ref.ssd_scan_bwd_ref(g_prev, g_final, prev, chunk_decay, with_init)
    b, c, h, p, n = g_prev.shape
    _check(g_prev.device, g_prev=(g_prev, F32, (b, c, h, p, n)),
           g_final=(g_final, F32, (b, h, p, n)), prev=(prev, F32, (b, c, h, p, n)),
           chunk_decay=(chunk_decay, F32, (b, c, h)))
    if b * h > 65_535:
        raise ValueError(f"batch x heads = {b * h} exceeds the kernel's grid limit of 65,535")
    cols = -(-(p * n) // SSD_BWD_THREADS)
    g_states = torch.empty_like(g_prev)
    g_decay = torch.empty((b, c, h), dtype=F32, device=g_prev.device)
    g_init = torch.empty_like(g_final) if with_init else None
    partial = torch.empty((b * c * h * cols,), dtype=F32, device=g_prev.device)
    _launch("ssd_scan_bwd", g_prev.device,
            (g_prev, g_final, prev, chunk_decay, g_states, g_decay, g_init, partial),
            (b, c, h, p * n, cols))
    return g_states, g_decay, g_init



class SSDScan(torch.autograd.Function):
    """``ssd_scan`` with its gradient: the forward kernel (or the plain
    version on CPU tensors), saving ``prev`` and ``chunk_decay``; the
    backward ``ssd_scan_bwd``.  No gradient for ``init`` when it is
    ``None``."""

    @staticmethod
    def forward(ctx, states, chunk_decay, init):
        prev, final = _ssd_scan_fwd(states, chunk_decay, init)
        ctx.save_for_backward(prev, chunk_decay)
        ctx.with_init = init is not None
        return prev, final

    @staticmethod
    def backward(ctx, g_prev, g_final):
        prev, chunk_decay = ctx.saved_tensors
        g_states, g_decay, g_init = ssd_scan_bwd(
            g_prev.contiguous(), g_final.contiguous(), prev, chunk_decay.contiguous(),
            ctx.with_init)
        return g_states, g_decay, g_init
