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
``paged_attention`` and ``ssd_scan`` allocate their outputs.

``LAUNCHES[name]`` counts the calls that launched kernel ``name``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

LAUNCHES: dict[str, int] = {
    "flic_insert": 0, "flic_update": 0, "flic_lookup": 0, "flic_merge": 0,
    "paged_attention": 0, "ssd_scan": 0,
}


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
    fn = getattr(build.library(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, n_int: int, device, tensors, ints) -> None:
    """Launch kernel ``name``; a ``None`` among ``tensors`` is a null pointer."""
    fn = _launcher(name, len(tensors), n_int)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in tensors], *ints, stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


I32, F32, BF16, BOOL = torch.int32, torch.float32, torch.bfloat16, torch.bool


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
    _launch(
        "flic_insert", 5, tags.device,
        (tags, data_ts, ins_ts, origin, valid, dirty, last_use, data, keys, sidx,
         line_ts, line_origin, line_dirty, live, line_data),
        (int(now), n, s, w, d),
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
        "flic_update", 6, tags.device,
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
    dev = tags.device
    hit = torch.empty((c, q), dtype=BOOL, device=dev)
    ts = torch.empty((c, q), dtype=I32, device=dev)
    payload = torch.empty((c, q, d), dtype=F32, device=dev)
    way = torch.empty((c, q), dtype=I32, device=dev)
    _launch(
        "flic_lookup", 5, dev,
        (tags, data_ts, valid, data, keys, sidx, hit, ts, payload, way),
        (c, q, s, w, d),
    )
    return hit, ts, payload, way


def flic_merge(tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b):
    """Newest-timestamp-wins merge of two aligned cache shards; see
    ``ref.flic_merge_ref``.  ``(S, W)`` int32 tags and timestamps, bool
    valid flags, ``(S, W, D)`` float32 payloads; any S.  Returns new
    (tags, ts, valid, data)."""
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
    out = (torch.empty_like(tags_a), torch.empty_like(ts_a), torch.empty_like(valid_a),
           torch.empty_like(data_a))
    _launch(
        "flic_merge", 3, tags_a.device,
        (tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b, *out),
        (s, w, d),
    )
    return out


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


_ARRIVALS: dict[int, torch.Tensor] = {}


def _arrivals(device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of the ``paged_attention``
    kernel on ``device``, zero between calls (each call leaves them at 0);
    allocated once and grown when a call needs more."""
    index = device.index or 0
    buf = _ARRIVALS.get(index)
    if buf is None or buf.numel() < n:
        buf = _ARRIVALS[index] = torch.zeros(max(n, 4096), dtype=I32, device=device)
    return buf


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """Decode attention through a page table; see ``ref.paged_attention_ref``.

    ``q`` (B, Hkv, G, D) and ``k_pages``/``v_pages`` (P, page, Hkv, D) in
    bfloat16 or float32 (K and V alike; on CUDA not a bfloat16 ``q`` over
    float32 pages), ``page_table`` (B, max_pages) and ``lengths`` (B,)
    int32.  Returns (B, Hkv, G, D) in ``q``'s dtype.
    On CUDA, D * (bytes of a K/V value) must be a multiple of 16 and at most
    512 (the kernel reads K/V in 16-byte chunks, a lane's chunk of a row),
    every page id must lie in [0, P) (a (sequence, head) with one outside
    gets NaN), and B <= 65,535.  The kernel splits each sequence's page
    slots over blocks (``paged_split_plan``); the last split of a (sequence,
    head) to finish merges the splits' partial softmax states in split
    order, counted in on counters that this module keeps per device, so two
    calls on one device must not run at once on two streams.
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
    row_bytes = d * k_pages.element_size()
    if row_bytes % 16 or row_bytes > 512 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("K/V rows must be 16-byte multiples of at most 512 bytes on 16-byte "
                         "aligned storage")
    if b > 65_535:
        raise ValueError(f"batch {b} exceeds the kernel's grid limit of 65,535")
    if max_pages == 0:
        raise ValueError("page_table has no page slots")
    out = torch.empty_like(q)
    splits, per = paged_split_plan(b, hkv, max_pages, sm_count(q.device))
    part = arrivals = None
    if splits > 1:
        part = torch.empty(b * hkv * splits * g * (d + 2), dtype=F32, device=q.device)
        arrivals = _arrivals(q.device, b * hkv * -(-g // 4))
    _launch(
        "paged_attention", 11, q.device,
        (q, k_pages, v_pages, page_table, lengths, out, part, arrivals),
        (b, hkv, g, d, page, n_pool, max_pages, splits, per, int(q.dtype == BF16),
         int(k_pages.dtype == BF16)),
    )
    return out


def ssd_scan(states, chunk_decay, init=None):
    """The Mamba2 inter-chunk recurrence; see ``ref.ssd_scan_ref``.

    ``states`` (B, C, H, P, N), ``chunk_decay`` (B, C, H) and ``init``
    (B, H, P, N) or ``None`` (zeros); on CUDA all float32 and contiguous.
    Returns (prev (B,C,H,P,N), final (B,H,P,N)) in float32.
    """
    if not _on_cuda(states):
        return ref.ssd_scan_ref(states, chunk_decay, init)
    b, c, h, p, n = states.shape
    checks = dict(states=(states, F32, (b, c, h, p, n)), chunk_decay=(chunk_decay, F32, (b, c, h)))
    if init is not None:
        checks["init"] = (init, F32, (b, h, p, n))
    _check(states.device, **checks)
    prev = torch.empty_like(states)
    final = torch.empty((b, h, p, n), dtype=F32, device=states.device)
    _launch("ssd_scan", 4, states.device, (states, chunk_decay, init, prev, final),
            (b, c, h, p * n))
    return prev, final
