"""Plain PyTorch reference of the FLIC fog tick.

A frozen rewrite of the port's per-pass tick (``core/simulator_ref.py``) and
of the modules it uses (the cache primitives, the loss channel, the writer
ring, the store, the metrics).  It imports nothing of the port and takes
nothing that the program made: it starts from an empty fog and works out its
own state from the benchmark's draws (``fogbench/traffic/generator.py``).

The semantics, per tick:

* writes: every valid write is upserted into its node's own cache (the key's
  set; the first matching way, else the first invalid way, else the least
  recently used one; a present copy only by a strictly newer timestamp); on
  mutable workloads a coherence sweep then lets every hearer that holds a
  written key take a strictly newer row (the highest row index wins a line),
  and every write goes to the keyed writer ring, coalescing a pending key;
* reads resolve local -> fog -> ring -> store: a local hit refreshes its LRU
  stamp; a local miss asks the fog (every cache under dense gossip, the K ring
  neighbours under fan-out), where the responding copy with the NEWEST
  timestamp answers (the lowest node id on ties) and every responding line is
  touched; a fog miss is served from the ring, else the store when it is up;
  a served read is filled into the reader's cache;
* the writer drains up to ``writer_max_per_tick`` rows per API call under a
  token bucket, with exponential backoff while the store is down.

State is a flat dict keyed by field path (``caches.tags``, ``queue.head``,
...), the names of the port's ``SimState`` fields.  The heavy passes run in
blocks of caches, so an (N, N) fog of tens of thousands fits the card.
"""
from __future__ import annotations

import numpy as np
import torch

I32, F32, BOOL = torch.int32, torch.float32, torch.bool
INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)
NULL_TAG = -1
KEY_SALT = 0x5A1FCA5E
MASK32 = 0xFFFFFFFF
_M1, _M2, _GOLDEN = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9

METRICS = (
    "wan_tx_bytes", "wan_rx_bytes", "lan_bytes", "reads", "hits_local", "hits_fog",
    "misses", "store_found", "store_missing", "writes_gen", "writes_drained",
    "queue_depth", "queue_dropped", "store_txn_bytes", "store_txns", "read_latency_sum",
    "baseline_wan_bytes", "hits_queue", "ticks", "coherence_updates", "stale_reads",
    "writes_coalesced", "churn_rejoins", "wire_bytes",
)
# Caches probed or swept per block: bounds the (block, N, W) intermediates.
BLOCK_ELEMS = 2**27
# The Gilbert-Elliott channel of ``loss_model = "gilbert_elliott"``: fixed
# constants, as in the system (no configuration sets them).  Flip
# probabilities good -> bad and bad -> good, and the loss in each state.
GE_P_G2B, GE_P_B2G, GE_LOSS_GOOD, GE_LOSS_BAD = 0.05, 0.4, 0.01, 0.5


# --------------------------------------------------------------------------
# Hashes and payloads.
# --------------------------------------------------------------------------

def _mul32(x, m):
    return ((x * (m & 0xFFFF)) + (((x * (m >> 16)) & 0xFFFF) << 16)) & MASK32


def _mix(x):
    x = (x + _GOLDEN) & MASK32
    x = _mul32(x ^ (x >> 16), _M1)
    x = _mul32(x ^ (x >> 13), _M2)
    return x ^ (x >> 16)


def _hash2(a, b):
    """Unsigned 32-bit hash of two 32-bit arrays, as int64."""
    a = a.to(torch.int64) & MASK32
    b = b.to(torch.int64) & MASK32
    return _mix(_mix(a) ^ ((b + _GOLDEN + ((a << 6) & MASK32) + (a >> 2)) & MASK32))


def set_of(keys, sets: int):
    """The set of each key: its unsigned value mod ``sets`` (int64)."""
    return (keys.to(torch.int64) & MASK32) % sets


def payload_for(keys, dim: int):
    lanes = _hash2(keys[..., None], torch.arange(dim, dtype=torch.int64, device=keys.device))
    return lanes.to(F32) / float(2**32)


def versioned_payload(keys, ts, dim: int):
    return payload_for(_hash2(keys, ts), dim)


def first_true(mask):
    return mask.to(I32).argmax(dim=-1)


def _sum(mask):
    return mask.sum(dtype=I32)


def _fma32(x, y: float, z):
    """float32 ``x * y + z`` rounded once (a fused multiply-add)."""
    return (x.to(torch.float64) * float(np.float32(y)) + z.to(torch.float64)).to(F32)


def set_drop(buf, idx, vals):
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]])
    ext[idx.long().clamp(max=n)] = vals.to(buf.dtype)
    return ext[:n]


def max_drop(buf, idx, vals):
    n = buf.shape[0]
    ext = torch.cat([buf, buf[:1]])
    ext.scatter_reduce_(0, idx.long().clamp(max=n), vals.to(buf.dtype), "amax")
    return ext[:n]


# --------------------------------------------------------------------------
# State.
# --------------------------------------------------------------------------

def init_state(cfg: dict, device) -> dict:
    """The empty fog of ``cfg`` (``config``)."""
    n, s, w, d = cfg["n_nodes"], cfg["sets"], cfg["cache_ways"], cfg["payload_dim"]
    ku = cfg["key_universe"] if cfg["mutable"] else 0
    dev = torch.device(device)

    def full(shape, v, dtype=I32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    st = {
        "caches.tags": full((n, s, w), NULL_TAG), "caches.data_ts": full((n, s, w), -1),
        "caches.ins_ts": full((n, s, w), -1), "caches.origin": full((n, s, w), -1),
        "caches.valid": full((n, s, w), False, BOOL), "caches.dirty": full((n, s, w), False, BOOL),
        "caches.last_use": full((n, s, w), -1), "caches.data": full((n, s, w, d), 0.0, F32),
    }
    cap = cfg["queue_capacity"]
    for f in ("keys", "data_ts", "origin"):
        st[f"queue.{f}"] = full((cap,), 0)
    for f in ("head", "tail", "dropped", "backoff", "next_retry"):
        st[f"queue.{f}"] = full((), 0)
    st["queue.tokens"] = full((), 0.0, F32)
    st["queue.slot_of_key"] = full((ku,), -1)
    st["queue.coalesced"] = full((), 0)
    for f in ("drained_total", "api_calls"):
        st[f"store.{f}"] = full((), 0)
    st["store.read_bytes"] = full((), 0.0, F32)
    st["store.outage_until"] = full((), 0)
    st["store.lost_writes"] = full((), 0)
    st["store.table_ts"] = full((ku,), -1)
    st["channel.bad"] = full((n,), False, BOOL)
    st["tick"] = full((), 0)
    st["latest_ts"] = full((ku,), -1)
    shape = (cfg["window_ticks"], n) if cfg["stream_indexed"] else (0, 0)
    st["plan.cum_writes"] = full((), 0)
    st["plan.enq_window"] = full(shape, -1)
    return st


def config(sim: dict, workload: dict, device, elect: str = "newest") -> dict:
    """The reference's view of a cell: the configuration file's fields and
    the traffic file's ``workload`` group, with what the tick derives from
    them.  ``elect`` is which responding copy answers a fog read: "newest"
    (the guarantee) or "oldest" (the control that breaks it)."""
    popularity = workload.get("popularity", "stream")
    rate = workload.get("rate", "steady")
    churn = workload.get("churn_period", 0) > 0
    n, k = sim["n_nodes"], sim.get("fanout")
    cfg = dict(sim)
    cfg.update(
        sets=sim["cache_lines"] // sim["cache_ways"],
        mutable=popularity in ("zipf", "trace"),
        key_universe=workload.get("key_universe", 4096),
        churn=churn,
        stream_indexed=popularity == "stream" and (rate != "steady" or churn),
        window_ticks=max(1, round(sim["read_window_keys"] / n)),
        outage_schedule=tuple(tuple(x) for x in sim.get("outage_schedule", ())),
        fanout=k,
        elect=elect,
    )
    if cfg["mutable"]:
        ku = cfg["key_universe"]
        hashes = _hash2(torch.arange(ku, device=device), torch.full((ku,), KEY_SALT, device=device))
        hashes = ((hashes ^ 0x80000000) - 0x80000000).to(I32)      # the tags' int32 bit pattern
        vals, order = torch.sort(hashes)
        if int(torch.unique(vals).numel()) != ku:
            raise ValueError("two key ids of the universe hash to one tag")
        cfg["key_tags"] = (vals, order)
    if k is not None:
        j = torch.arange(k, dtype=torch.int64, device=device)
        offs = (j // 2 + 1) * (1 - 2 * (j % 2))
        cfg["nbr"] = (torch.arange(n, dtype=torch.int64, device=device)[:, None] + offs) % n
    return cfg


def _block(n_other: int, ways: int) -> int:
    return max(1, BLOCK_ELEMS // max(1, n_other * ways))


# --------------------------------------------------------------------------
# Cache primitives.
# --------------------------------------------------------------------------

def insert_lines(st, cfg, key, ts, origin, data, valid, dirty, now: int):
    """Each node upserts one line into its own cache."""
    nodes = torch.arange(key.shape[0], device=key.device)
    s = set_of(key, cfg["sets"])
    tv = st["caches.valid"][nodes, s]
    tt = st["caches.tags"][nodes, s]
    match = tv & (tt == key[:, None])
    present = match.any(dim=1)
    use = torch.where(tv, st["caches.last_use"][nodes, s], INT32_MAX)
    victim = torch.where((~tv).any(dim=1), first_true(~tv), use.argmin(dim=1))
    way = torch.where(present, first_true(match), victim)
    at = (nodes, s, way)
    write = valid & ~(present & (ts <= st["caches.data_ts"][at]))
    now_n = torch.full_like(ts, now)
    for name, value in (("tags", key), ("data_ts", ts), ("ins_ts", now_n),
                        ("origin", origin), ("valid", torch.ones_like(valid)),
                        ("dirty", dirty), ("last_use", now_n), ("data", data)):
        table = st["caches." + name]
        mask = write if value.dim() == 1 else write[:, None]
        table[at] = torch.where(mask, value.to(table.dtype), table[at])


def _lane_loss(cfg, channel_bad, u, receivers):
    """Delivered (True) per lane from uniforms ``u`` (receivers leading)."""
    if cfg["loss_model"] == "none":
        return torch.ones(u.shape, dtype=BOOL, device=u.device)
    if cfg["loss_model"] == "bernoulli":
        return u >= cfg["loss_prob"]
    p = torch.where(channel_bad, GE_LOSS_BAD, GE_LOSS_GOOD)[receivers.long()]
    return u >= p.reshape((u.shape[0],) + (1,) * (u.dim() - 1))


class KeyIndex:
    """Where each cache holds each key id, on mutable workloads (every tag is
    a key id's hash, and a valid copy of a key sits in one way of one cache
    at most): ``way`` (N, key_universe) int8, -1 where not held; ``ts`` the
    held copy's timestamp, INT32_MAX where not held; ``kid`` (N, S * W) the
    key id of each line, key_universe where the line is invalid."""

    def __init__(self, st, cfg):
        vals, order = cfg["key_tags"]
        n, ku = cfg["n_nodes"], cfg["key_universe"]
        tags = st["caches.tags"].reshape(n, -1)
        pos = torch.searchsorted(vals, tags).clamp(max=ku - 1)
        found = st["caches.valid"].reshape(n, -1) & (vals[pos] == tags)
        self.kid = torch.where(found, order[pos], ku)
        ways = torch.arange(cfg["cache_ways"], dtype=torch.int8, device=tags.device)
        self.way = torch.full((n, ku + 1), -1, dtype=torch.int8, device=tags.device).scatter_(
            1, self.kid, ways.repeat(cfg["sets"])[None, :].expand(n, -1))[:, :ku]
        self.ts = torch.full((n, ku + 1), INT32_MAX, dtype=I32, device=tags.device).scatter_(
            1, self.kid, st["caches.data_ts"].reshape(n, -1))[:, :ku]


def sweep(st, cfg, rows, delivered_fn, now: int):
    """Coherence sweep of the wave ``rows`` into every cache; returns the
    count of (hearer, row) pairs that updated a line.  ``delivered_fn(h0,
    h1)`` gives hearers [h0, h1)'s delivery: an (h, R) mask under dense
    gossip, an (h, K) lane mask under fan-out.  A row reaches its origin
    always; a hearer takes a live row whose key it holds iff the row is
    strictly newer than its copy was before the sweep; the highest such row
    index wins the line."""
    n, s_sets, w = cfg["n_nodes"], cfg["sets"], cfg["cache_ways"]
    ku = cfg["key_universe"]
    dev = rows["key"].device
    index = KeyIndex(st, cfg)
    winr = torch.full((n, s_sets * w), -1, dtype=I32, device=dev)
    total = torch.zeros((), dtype=I32, device=dev)
    k = cfg["fanout"]
    if k is None:
        valid_rows = rows["valid"].nonzero()[:, 0]          # no hearer takes an invalid row
        width = valid_rows.numel()
    else:
        width = k + 1
    step = _block(width, 1)
    for h0 in range(0, n, step):
        h1 = min(n, h0 + step)
        hearers = torch.arange(h0, h1, device=dev)[:, None]
        if k is None:
            cand = valid_rows[None, :]                              # every hearer's candidates
            heard = delivered_fn(h0, h1)[:, valid_rows]
        else:
            cand = torch.cat([hearers, cfg["nbr"][h0:h1]], dim=1)     # its own row first
            heard = torch.cat([torch.zeros((h1 - h0, 1), dtype=BOOL, device=dev),
                               delivered_fn(h0, h1)], dim=1)
        kid = rows["kid"][cand].long().expand(h1 - h0, -1)
        live = (heard | (rows["origin"][cand] == hearers.to(I32))) & rows["valid"][cand]
        takes = live & (rows["data_ts"][cand] > index.ts[h0:h1].gather(1, kid))
        total = total + _sum(takes)
        win_key = torch.full((h1 - h0, ku), -1, dtype=I32, device=dev).scatter_reduce_(
            1, kid, torch.where(takes, cand.to(I32), -1), "amax")
        line_kid = index.kid[h0:h1]
        winr[h0:h1] = torch.where(line_kid < ku, win_key.gather(1, line_kid.clamp(max=ku - 1)), -1)
    winr = winr.view(n, s_sets, w)
    updated = winr >= 0
    wsafe = winr.clamp(min=0).long()
    st["caches.data_ts"] = torch.where(updated, rows["data_ts"][wsafe], st["caches.data_ts"])
    st["caches.last_use"] = torch.where(updated, now, st["caches.last_use"])
    st["caches.data"] = torch.where(updated[..., None], rows["data"][wsafe], st["caches.data"])
    return total


def merge_replicate(st, cfg, rows, delivered, now: int):
    """The replicate policy: every node upserts every row it heard, in row
    order; only the origin keeps a row dirty."""
    n = cfg["n_nodes"]
    dev = rows["key"].device
    nodes = torch.arange(n, dtype=I32, device=dev)
    for r in range(rows["key"].shape[0]):
        own = rows["origin"][r] == nodes
        insert_lines(
            st, cfg, rows["key"][r].expand(n), rows["data_ts"][r].expand(n),
            rows["origin"][r].expand(n), rows["data"][r].expand(n, -1),
            rows["valid"][r] & (delivered[:, r] | own), rows["dirty"][r] & own, now)


# --------------------------------------------------------------------------
# The writer ring and the store.
# --------------------------------------------------------------------------

def enqueue(st, keys, ts, origin, mask):
    cap = st["queue.keys"].shape[0]
    offs = torch.cumsum(mask.to(I32), 0, dtype=I32) - 1
    free = cap - (st["queue.tail"] - st["queue.head"])
    accept = mask & (offs < free)
    slots = torch.where(accept, (st["queue.tail"] + offs) % cap, cap)
    for f, v in (("keys", keys), ("data_ts", ts), ("origin", origin)):
        st["queue." + f] = set_drop(st["queue." + f], slots, v)
    st["queue.tail"] = st["queue.tail"] + _sum(accept)
    st["queue.dropped"] = st["queue.dropped"] + _sum(mask & ~accept)


def enqueue_keyed(st, kids, ts, origin, mask):
    cap = st["queue.keys"].shape[0]
    ku = st["queue.slot_of_key"].shape[0]
    kid = kids.to(I32)
    order = torch.arange(kid.shape[0], dtype=I32, device=kid.device)
    kid_safe = kid.clamp(0, ku - 1).long()
    last = max_drop(torch.full((ku,), -1, dtype=I32, device=kid.device),
                    torch.where(mask, kid, ku), order)
    rep = mask & (last[kid_safe] == order)
    slot = st["queue.slot_of_key"][kid_safe]
    pending = rep & (slot >= st["queue.head"]) & (slot < st["queue.tail"])
    fresh = rep & ~pending
    upd_slot = torch.where(pending, slot % cap, cap)
    offs = torch.cumsum(fresh.to(I32), 0, dtype=I32) - 1
    free = cap - (st["queue.tail"] - st["queue.head"])
    accept = fresh & (offs < free)
    slots = torch.where(accept, (st["queue.tail"] + offs) % cap, cap)
    for f, v in (("keys", kid), ("data_ts", ts), ("origin", origin)):
        st["queue." + f] = set_drop(set_drop(st["queue." + f], upd_slot, v), slots, v)
    st["queue.slot_of_key"] = set_drop(st["queue.slot_of_key"], torch.where(accept, kid, ku),
                                       st["queue.tail"] + offs)
    st["queue.tail"] = st["queue.tail"] + _sum(accept)
    st["queue.dropped"] = st["queue.dropped"] + _sum(fresh & ~accept)
    st["queue.coalesced"] = st["queue.coalesced"] + _sum(mask & ~rep) + _sum(pending)


def drain(st, cfg, now: int, healthy):
    """One writer tick; returns (rows drained, API calls)."""
    store = cfg["store"]
    tokens = torch.clamp(st["queue.tokens"] + store["api_rate_per_tick"], max=store["api_burst"])
    size = st["queue.tail"] - st["queue.head"]
    attempt = (now >= st["queue.next_retry"]) & (tokens >= 1.0) & (size > 0)
    ok = attempt & healthy
    n = torch.where(ok, torch.clamp(size, max=cfg["writer_max_per_tick"]), 0)
    calls = attempt.to(I32)
    failed = attempt & ~healthy
    backoff = torch.where(failed, torch.clamp(torch.clamp(st["queue.backoff"] * 2, min=1), max=64),
                          torch.where(ok, 0, st["queue.backoff"]))
    st["queue.next_retry"] = torch.where(failed, now + backoff, st["queue.next_retry"])
    st["queue.head"] = st["queue.head"] + n
    st["queue.tokens"] = tokens - calls.to(F32)
    st["queue.backoff"] = backoff
    return n, calls


def read_txn_bytes(cfg, rows_in_store):
    store = cfg["store"]
    if store["kind"] == "sheets":
        return torch.clamp(rows_in_store, min=1).to(F32) * store["row_bytes"]
    return torch.full((), float(store["row_bytes"]), dtype=F32, device=rows_in_store.device)


# --------------------------------------------------------------------------
# The fog probe.
# --------------------------------------------------------------------------

def _score(cfg, ts):
    """What the fog election maximises among responding copies: the
    timestamp (the newest copy answers); the control breaks that guarantee
    and lets the oldest answer."""
    return ts if cfg["elect"] == "newest" else INT32_MAX - ts


def _probe_dense(st, cfg, keys, kids, need_fog, resp, online, t):
    """Every cache answers each local miss (``need_fog``); ``resp`` is the
    (reader, responder) response mask or None.  Returns (fog_hit, best_ts,
    best_payload, n_responses) by node and touches every responding line."""
    n, s_sets, w, d = cfg["n_nodes"], cfg["sets"], cfg["cache_ways"], cfg["payload_dim"]
    dev = keys.device
    fog_hit = torch.zeros((n,), dtype=BOOL, device=dev)
    best = torch.full((n,), -1, dtype=I32, device=dev)
    payload = torch.zeros((n, d), dtype=F32, device=dev)
    n_resp = torch.zeros((), dtype=I32, device=dev)
    ask = need_fog.nonzero()[:, 0]
    q = ask.numel()
    if q == 0:
        return fog_hit, best, payload, n_resp
    kq = keys[ask]
    sq = set_of(kq, s_sets)
    qi = torch.arange(q, device=dev)
    index = KeyIndex(st, cfg) if cfg["mutable"] else None
    kid_q = kids[ask].long()
    resp_q = None if resp is None else resp[ask]                      # (q, N)
    best_ts = torch.full((q,), -1, dtype=I32, device=dev)
    best_score = torch.full((q,), -1, dtype=I32, device=dev)
    best_c = torch.zeros((q,), dtype=torch.int64, device=dev)
    best_way = torch.zeros((q,), dtype=torch.int64, device=dev)
    any_hit = torch.zeros((q,), dtype=BOOL, device=dev)
    step = _block(q, 1 if index is not None else w)
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        if index is not None:
            way = index.way[c0:c1][:, kid_q].long()                      # (B, q)
            hit = way >= 0
            way = way.clamp(min=0)
            ts = torch.where(hit, index.ts[c0:c1][:, kid_q], -1)
        else:
            match = (st["caches.valid"][c0:c1][:, sq]
                     & (st["caches.tags"][c0:c1][:, sq] == kq[None, :, None]))
            hit = match.any(dim=2)
            way = first_true(match).long()
            ts = torch.where(hit, st["caches.data_ts"][c0:c1][:, sq].gather(2, way[..., None])[..., 0], -1)
        if resp_q is not None:
            hit = hit & resp_q[:, c0:c1].T
        if online is not None:
            hit = hit & online[c0:c1, None]
        score = torch.where(hit, _score(cfg, ts), -1)
        blk_c = score.argmax(dim=0)                       # the first cache of the block on ties
        blk_score = score[blk_c, qi]
        better = blk_score > best_score                   # earlier blocks win ties
        best_score = torch.where(better, blk_score, best_score)
        best_ts = torch.where(better, ts[blk_c, qi], best_ts)
        best_c = torch.where(better, blk_c + c0, best_c)
        best_way = torch.where(better, way[blk_c, qi], best_way)
        any_hit = any_hit | hit.any(dim=0)
        n_resp = n_resp + _sum(hit)
        lu = st["caches.last_use"][c0:c1].view(c1 - c0, s_sets * w)
        lu.scatter_reduce_(1, sq[None, :] * w + way, torch.where(hit, t, INT32_MIN).to(I32), "amax")
    fog_hit[ask] = any_hit
    best[ask] = torch.where(any_hit, best_ts, -1)
    payload[ask] = st["caches.data"][best_c, sq, best_way]
    return fog_hit, best, payload, n_resp


def _probe_lanes(st, cfg, keys, need_fog, resp_lane, online, t):
    """Under fan-out each local miss asks its K ring neighbours."""
    s_sets, w = cfg["sets"], cfg["cache_ways"]
    dev = keys.device
    nbr = cfg["nbr"]                                                  # (N, K)
    sq = set_of(keys, s_sets)
    lines = sq[:, None].expand_as(nbr)
    match = st["caches.valid"][nbr, lines] & (st["caches.tags"][nbr, lines] == keys[:, None, None])
    hit = match.any(dim=2)                                            # (N, K)
    way = first_true(match).long()
    ts = st["caches.data_ts"][nbr, lines, way]
    hit = hit & resp_lane
    if online is not None:
        hit = hit & online[nbr]
    hit = hit & need_fog[:, None]
    score = torch.where(hit, _score(cfg, ts), -1)
    top = score.max(dim=1).values
    at_top = hit & (score == top[:, None])
    node = torch.where(at_top, nbr, INT32_MAX).min(dim=1).values      # lowest node id on ties
    lane = first_true(at_top & (nbr == node[:, None]))
    rows = torch.arange(keys.shape[0], device=dev)
    fog_hit = need_fog & hit.any(dim=1)
    payload = st["caches.data"][nbr[rows, lane], sq, way[rows, lane]]
    top = ts[rows, lane]
    flat = (nbr * s_sets + lines) * w + way
    lu = st["caches.last_use"].view(-1)
    lu.scatter_reduce_(0, flat.reshape(-1), torch.where(hit, t, INT32_MIN).to(I32).reshape(-1),
                       "amax")
    return fog_hit, torch.where(fog_hit, top, -1), payload, _sum(hit)


# --------------------------------------------------------------------------
# One tick.
# --------------------------------------------------------------------------

def tick(st: dict, cfg: dict, t: int, plan: dict, u: dict) -> dict:
    """Advance ``st`` (in place) by tick ``t`` of ``plan``/``u``; returns the
    tick's metrics by ``METRICS`` name."""
    n = cfg["n_nodes"]
    dev = st["tick"].device
    d = cfg["payload_dim"]
    store = cfg["store"]
    zero = torch.zeros((), dtype=I32, device=dev)
    coalesced_before = st["queue.coalesced"]
    for start, duration in cfg["outage_schedule"]:
        if t == start:
            st["store.outage_until"] = torch.clamp(st["store.outage_until"], min=start + duration)
    outage_until = st["store.outage_until"]
    healthy = t >= outage_until

    # ---- churn ----------------------------------------------------------------
    churn = cfg["churn"]
    online = plan["online"] if churn else None
    if churn:
        st["caches.valid"] = st["caches.valid"] & ~plan["rejoin"][:, None, None]
        n_rejoin = _sum(plan["rejoin"])
    else:
        n_rejoin = zero

    # ---- writes -----------------------------------------------------------------
    node_ids = torch.arange(n, dtype=I32, device=dev)
    waves = []
    for p in range(plan["w_keys"].shape[0]):
        keys = plan["w_keys"][p]
        ts = torch.full((n,), t, dtype=I32, device=dev)
        data = versioned_payload(keys, ts, d) if cfg["mutable"] else payload_for(keys, d)
        waves.append(dict(key=keys, kid=plan["w_kids"][p], data_ts=ts, origin=node_ids, data=data,
                          valid=plan["w_valid"][p], dirty=torch.zeros((n,), dtype=BOOL, device=dev)))
    n_writes = _sum(plan["w_valid"])

    if cfg["loss_model"] == "gilbert_elliott":
        bad = st["channel.bad"]
        st["channel.bad"] = torch.where(bad, ~(u["u_ge_dn"] < GE_P_B2G), u["u_ge_up"] < GE_P_G2B)
    bad = st["channel.bad"]

    def delivered_rows(h0, h1):
        hearers = torch.arange(h0, h1, device=dev)
        if cfg["loss_model"] == "none":
            cols = n if cfg["fanout"] is None else cfg["fanout"]
            m = torch.ones((h1 - h0, cols), dtype=BOOL, device=dev)
        else:
            m = _lane_loss(cfg, bad, u["u_deliver"][h0:h1], hearers)
        if churn:
            m = m & plan["online"][h0:h1, None]
        return m

    n_coh = zero
    for rows in waves:
        if cfg["insert_policy"] != "directory":
            if cfg["fanout"] is None:
                delivered = delivered_rows(0, n)
            else:
                delivered = torch.zeros((n, n), dtype=BOOL, device=dev).scatter_(
                    1, cfg["nbr"], delivered_rows(0, n))
            merge_replicate(st, cfg, rows, delivered, t)
            continue
        insert_lines(st, cfg, rows["key"], rows["data_ts"], rows["origin"], rows["data"],
                     rows["valid"], rows["dirty"], t)
        if cfg["mutable"]:
            n_coh = n_coh + sweep(st, cfg, rows, delivered_rows, t)
    lan = n_writes.to(F32) * cfg["row_bytes"]

    # ---- the writer ring ----------------------------------------------------------
    ku = cfg["key_universe"]
    if cfg["mutable"]:
        for p, rows in enumerate(waves):
            enqueue_keyed(st, plan["w_kids"][p], rows["data_ts"], rows["origin"], plan["w_valid"][p])
            st["latest_ts"] = max_drop(st["latest_ts"],
                                       torch.where(plan["w_valid"][p], plan["w_kids"][p], ku),
                                       rows["data_ts"])
    else:
        rows = waves[0]
        enqueue(st, rows["key"], rows["data_ts"], rows["origin"], plan["w_valid"][0])

    # ---- reads: local ---------------------------------------------------------------
    reading = plan["reading"]
    r_keys = plan["r_keys"]
    rows_n = torch.arange(n, device=dev)
    sq = set_of(r_keys, cfg["sets"])
    match = st["caches.valid"][rows_n, sq] & (st["caches.tags"][rows_n, sq] == r_keys[:, None])
    hit_local = match.any(dim=1) & reading
    lway = first_true(match).long()
    at = (rows_n, sq, lway)
    ts_local = torch.where(hit_local, st["caches.data_ts"][at], -1)
    old = st["caches.last_use"][at]
    st["caches.last_use"][at] = torch.where(hit_local, torch.clamp(old, min=t), old)
    need_fog = reading & ~hit_local

    # ---- reads: the fog, with response loss on the readers' rows ----------------
    slot_rows = plan["slot_id"]
    if cfg["fanout"] is None:
        if cfg["loss_model"] == "none":
            resp = None
        else:
            compact = _lane_loss(cfg, bad, u["u_resp"], plan["slot_nid"])
            resp = set_drop(torch.zeros((n, n), dtype=BOOL, device=dev), slot_rows, compact)
        fog_hit, best_ts, best_payload, n_responses = _probe_dense(
            st, cfg, r_keys, plan["r_kids"], need_fog, resp, online, t)
    else:
        k = cfg["fanout"]
        if cfg["loss_model"] == "none":
            compact = torch.ones((slot_rows.shape[0], k), dtype=BOOL, device=dev)
        else:
            compact = _lane_loss(cfg, bad, u["u_resp"], plan["slot_nid"])
        resp_lane = set_drop(torch.zeros((n, k), dtype=BOOL, device=dev), slot_rows, compact)
        fog_hit, best_ts, best_payload, n_responses = _probe_lanes(
            st, cfg, r_keys, need_fog, resp_lane, online, t)
    n_fog_queries = _sum(need_fog)

    # ---- reads: ring, then store -------------------------------------------------------
    head, tail = st["queue.head"], st["queue.tail"]
    cap = st["queue.keys"].shape[0]
    need_store = need_fog & ~fog_hit
    if cfg["mutable"]:
        kid = plan["r_kids"].clamp(0, ku - 1).long()
        slot = st["queue.slot_of_key"][kid]
        in_pending = (slot >= head) & (slot < tail)
        in_ring = (slot >= 0) & (slot >= tail - cap) & (slot < tail)
        queue_hit = need_store & (in_pending | (~healthy & in_ring))
        store_read = need_store & ~queue_hit & healthy
        failed = need_store & ~queue_hit & ~healthy
        durable_ts = st["store.table_ts"][kid]
        found = store_read & (durable_ts >= 0)
        ring_ts = st["queue.data_ts"][(slot.clamp(min=0) % cap).long()]
        served_ts = torch.where(queue_hit, ring_ts, torch.where(found, durable_ts, -1))
    else:
        idx = plan["r_enq_idx"]
        in_pending = (idx >= head) & (idx < tail)
        in_ring = (idx >= tail - cap) & (idx < tail)
        queue_hit = need_store & (in_pending | (~healthy & in_ring))
        store_read = need_store & ~queue_hit & healthy
        failed = need_store & ~queue_hit & ~healthy
        found = store_read & (idx < st["store.drained_total"])
    n_store_reads = _sum(store_read)
    n_queue_hits = _sum(queue_hit)
    n_failed = _sum(failed)
    lan = lan + n_fog_queries * cfg["query_bytes"] + (n_responses + n_queue_hits) * cfg["row_bytes"]
    wan_rx = n_store_reads.to(F32) * read_txn_bytes(cfg, st["store.drained_total"])
    st["store.api_calls"] = st["store.api_calls"] + n_store_reads

    # ---- fills --------------------------------------------------------------------
    fill_ok = fog_hit | queue_hit | found
    zeros_b = torch.zeros((n,), dtype=BOOL, device=dev)
    if cfg["mutable"]:
        insert_lines(st, cfg, r_keys, torch.where(fog_hit, best_ts, served_ts),
                     torch.full((n,), -1, dtype=I32, device=dev),
                     torch.where(fog_hit[:, None], best_payload,
                                 versioned_payload(r_keys, served_ts, d)),
                     fill_ok, zeros_b, t)
        served = hit_local | fog_hit | queue_hit | found
        got_ts = torch.where(hit_local, ts_local, torch.where(fog_hit, best_ts, served_ts))
        truth = st["latest_ts"][plan["r_kids"].clamp(0, ku - 1).long()]
        n_stale = _sum(served & (got_ts < truth))
    else:
        insert_lines(st, cfg, r_keys, torch.where(fog_hit, best_ts, plan["r_fill_ts"]),
                     plan["r_src"],
                     torch.where(fog_hit[:, None], best_payload, payload_for(r_keys, d)),
                     fill_ok, zeros_b, t)
        n_stale = zero

    # ---- drain and commit ---------------------------------------------------------------
    n_drained, n_calls = drain(st, cfg, t, healthy)
    lost = torch.zeros_like(n_drained)
    if store["collision_prob"] > 0.0:
        lost = ((u["u_coll"] < store["collision_prob"]) & (n_drained > 1)).to(I32)
    st["store.drained_total"] = st["store.drained_total"] + n_drained - lost
    st["store.api_calls"] = st["store.api_calls"] + n_calls
    st["store.lost_writes"] = st["store.lost_writes"] + lost
    if cfg["mutable"]:
        lane = torch.arange(cfg["writer_max_per_tick"], dtype=I32, device=dev)
        idx = ((st["queue.head"] - n_drained + lane) % cap).long()
        st["store.table_ts"] = max_drop(
            st["store.table_ts"], torch.where(lane < n_drained, st["queue.keys"][idx], ku),
            st["queue.data_ts"][idx])
    wan_tx = n_drained.to(F32) * store["row_bytes"]

    # ---- latency and the no-cache baseline ----------------------------------------------
    n_reads = _sum(reading)
    n_hits_local = _sum(hit_local)
    n_fog_hits = _sum(fog_hit)
    lat_lan = (n_fog_hits + n_queue_hits).to(F32) * (cfg["lat_lan_base"] + cfg["lat_lan_per_node"] * n)
    lat = _fma32((n_store_reads + n_failed).to(F32), cfg["lat_store"],
                 _fma32(n_hits_local.to(F32), cfg["lat_local"], lat_lan))
    baseline_rows = st["queue.tail"] + st["queue.dropped"] + st["queue.coalesced"]
    baseline = n_writes.to(F32) * cfg["row_bytes"] + n_reads.to(F32) * read_txn_bytes(cfg, baseline_rows)

    st["tick"] = st["tick"] + 1
    st["plan.cum_writes"] = plan["state_next"]["cum_writes"]
    st["plan.enq_window"] = plan["state_next"]["enq_window"]
    return dict(
        wan_tx_bytes=wan_tx, wan_rx_bytes=wan_rx, lan_bytes=lan, reads=n_reads,
        hits_local=n_hits_local, hits_fog=n_fog_hits, misses=n_store_reads + n_failed,
        store_found=_sum(found), store_missing=_sum(store_read & ~found),
        writes_gen=n_writes, writes_drained=n_drained,
        queue_depth=st["queue.tail"] - st["queue.head"], queue_dropped=st["queue.dropped"],
        store_txn_bytes=wan_rx + wan_tx, store_txns=n_store_reads + n_calls,
        read_latency_sum=lat, baseline_wan_bytes=baseline, hits_queue=n_queue_hits,
        ticks=torch.ones((), dtype=I32, device=dev), coherence_updates=n_coh,
        stale_reads=n_stale, writes_coalesced=st["queue.coalesced"] - coalesced_before,
        churn_rejoins=n_rejoin, wire_bytes=torch.zeros((), dtype=F32, device=dev),
    )
