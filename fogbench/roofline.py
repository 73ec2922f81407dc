"""The H100's peaks and the work each measured kernel must do.

A kernel's least time is the larger of its bytes over the memory rate and
its operations over the 32-bit rate outside the tensor cores (NVIDIA's data
sheet, H100 SXM at 700 W; the FLIC kernels do integer compares, no matmul).
Its roofline share is that least time over its measured time, in percent.

The counts are what the OPERATION needs from the inputs it is given, each
input byte read once and each output byte written once, counting only what
the data needs (frozen from ``chip_smoke.py``'s ``update_work`` and
``lookup_work``, with two changes so that a kernel which stops
materializing a block still reads under 100%):

* the sweep counts the delivery information at its source's size: the
  (N, R) mask under dense gossip, the (N, K) lanes under fan-out, although
  the kernel is handed an (N, R) mask either way;
* the probe counts hit, timestamp and way per (cache, query), which the
  election and the LRU touch read, but the payload only of each query's
  answer: the fog tick reads one payload a query, never the (C, Q, D) block.

The (N, R, W) and (C, Q, W) intermediates are formed in blocks of rows.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
NON_TENSOR_OPS_PER_S = 67e12    # H100 SXM 32-bit rate outside the tensor cores
BLOCK_ELEMS = 2**27


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / NON_TENSOR_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lines_of(mask, sidx, n_sets: int):
    """(B, S * W) bool: the lines a (B, Q, W) ``mask`` of queries to sets
    ``sidx`` (Q,) touches."""
    b, q, w = mask.shape
    idx = (sidx[None, :, None] * w + torch.arange(w, device=mask.device)).expand(b, q, w)
    out = torch.zeros((b, n_sets * w), dtype=torch.int32, device=mask.device)
    return out.scatter_reduce_(1, idx.reshape(b, -1), mask.to(torch.int32).reshape(b, -1),
                               "amax") > 0


def update_work(tags, data_ts, valid, last_use, data, keys, sidx, row_ts, row_data, live,
                now, fanout=None) -> tuple[int, int]:
    """(bytes, operations) of the coherence sweep of N caches by R rows.

    Delivery: N x R mask bytes under dense gossip, N x K lane bytes under
    fan-out.  Read: the key and set of a row some hearer takes, the
    timestamp of a row that matches a line, the valid flags of each set a
    live row falls in, the tags of its valid ways, the timestamp of each
    matched line, the payload of each winning row.  Written: the updated
    lines' timestamp, last use and payload; the per-cache counts.
    Operations: three compares a way a live (hearer, row) pair.
    """
    n, n_sets, w = tags.shape
    d = data.shape[-1]
    r = keys.shape[0]
    s = sidx.long()
    dev = tags.device
    ridx = torch.arange(r, dtype=torch.int32, device=dev)
    row_live = torch.zeros((r,), dtype=torch.bool, device=dev)
    row_match = torch.zeros((r,), dtype=torch.bool, device=dev)
    row_won = torch.zeros((r,), dtype=torch.bool, device=dev)
    pairs = sets = tag_reads = lines = updated = 0
    step = max(1, BLOCK_ELEMS // max(1, r * w))
    for h0 in range(0, n, step):
        h1 = min(n, h0 + step)
        lv = live[h0:h1]
        pairs += int(lv.sum())
        row_live |= lv.any(dim=0)
        touched = torch.zeros((h1 - h0, n_sets), dtype=torch.int32, device=dev).scatter_reduce_(
            1, s[None, :].expand(h1 - h0, r), lv.to(torch.int32), "amax") > 0
        sets += int(touched.sum())
        tag_reads += int((valid[h0:h1] & touched[..., None]).sum())
        match = valid[h0:h1][:, s] & (tags[h0:h1][:, s] == keys[None, :, None]) & lv[..., None]
        row_match |= match.any(dim=2).any(dim=0)
        lines += int(_lines_of(match, s, n_sets).sum())
        upd = match & (row_ts[None, :, None] > data_ts[h0:h1][:, s])
        b = h1 - h0
        idx = (s[None, :, None] * w + torch.arange(w, device=dev)).expand(b, r, w).reshape(b, -1)
        winr = torch.full((b, n_sets * w), -1, dtype=torch.int32, device=dev).scatter_reduce_(
            1, idx, torch.where(upd, ridx[None, :, None], -1).reshape(b, -1), "amax")
        won = winr >= 0
        updated += int(won.sum())
        row_won[winr[won].long()] = True
    delivery = n * r if fanout is None else n * fanout
    nbytes = (delivery + int(row_live.sum()) * 8 + int(row_match.sum()) * 4 + sets * w
              + tag_reads * 4 + lines * 4 + int(row_won.sum()) * 4 * d
              + updated * (8 + 4 * d) + n * 4)
    return nbytes, pairs * w * 3


def lookup_work(tags, data_ts, valid, data, keys, sidx) -> tuple[int, int]:
    """(bytes, operations) of the probe of C caches by Q queries.

    Read: each query's key and set, the valid flags of each queried set of
    every cache, the tags of its valid ways, the timestamp of each matched
    line, one payload per distinct key that some cache holds.  Written:
    hit, timestamp and way per (cache, query); one payload per query that
    some cache answers.  Operations: three compares a way a (cache, query).
    """
    c, n_sets, w = tags.shape
    d = data.shape[-1]
    q = keys.shape[0]
    s = sidx.long()
    dev = tags.device
    queried = torch.zeros((n_sets,), dtype=torch.bool, device=dev)
    queried[s] = True
    hit_q = torch.zeros((q,), dtype=torch.bool, device=dev)
    lines = 0
    step = max(1, BLOCK_ELEMS // max(1, q * w))
    for c0 in range(0, c, step):
        c1 = min(c, c0 + step)
        match = valid[c0:c1][:, s] & (tags[c0:c1][:, s] == keys[None, :, None])
        hit_q |= match.any(dim=2).any(dim=0)
        lines += int(_lines_of(match, s, n_sets).sum())
    answered_keys = int(torch.unique(keys[hit_q]).numel())
    nbytes = (q * 8 + c * int(queried.sum()) * w
              + int((valid & queried[None, :, None]).sum()) * 4 + lines * 4
              + answered_keys * 4 * d + int(hit_q.sum()) * 4 * d + c * q * 9)
    return nbytes, c * q * w * 3


def share(view, kernel: str) -> float | None:
    """The kernel's roofline share in percent: its mean least time over its
    mean measured time; None where the trace or the count has nothing."""
    got = describe(view).get(kernel)
    return None if got is None else got["roofline_pct"]


def describe(view) -> dict:
    """Per counted kernel: its mean bytes, operations, least ms, bound and
    measured ms, and the share."""
    out = {}
    for kernel, counts in (view.captured or {}).items():
        runs = view.named(kernel)
        if not counts or not runs:
            continue
        least = [bound(b, o) for b, o in counts]
        least_s = sum(x[0] for x in least) / len(least)
        kernel_s = sum(o.dur for o in runs) / len(runs) / 1e6
        out[kernel] = dict(
            bytes=sum(b for b, _ in counts) / len(counts),
            operations=sum(o for _, o in counts) / len(counts),
            least_ms=least_s * 1e3, bound=least[-1][1], kernel_ms=kernel_s * 1e3,
            launches=len(runs), roofline_pct=100.0 * least_s / kernel_s,
        )
    return out
