"""The bandwidth-lean fog on ``torch.distributed`` (port of
``repro.core.sharded``, engine #4).

The parity engine (``core/distributed.py``) buys bit-identity with the
single-host engines by evaluating every global singleton replicated and
reducing dense (n,) tensors every tick.  This engine spends that identity
to keep traffic local, the paper's headline claim (>50% fewer bytes on
the wire):

* **Per-shard streams.**  Each rank draws from its own ``torch.Generator``,
  seeded with ``shard_seed(seed, rank)``: the first word of numpy's
  ``SeedSequence((seed, rank))``, the counterpart of JAX's
  ``fold_in(PRNGKey(seed), rank)``.  The plan quantities that use no
  randomness (the staggered read schedule, the rate, online and rejoin
  masks) are functions of (spec, t, node id) and agree exactly with the
  other engines; the rest is held to the tolerance tier of
  ``tests/conformance.py`` (exact reads / writes_gen / churn_rejoins, write
  conservation, eps bounds on the miss and stale ratios).
* **Consistent-hash routing** (``workload.route_keys``): every key has a
  home node, its first online ring candidate, agreed with no
  communication.  Writes travel to the key's home shard (bounded
  ``ppermute`` buckets), which owns its writer-ring entry, durable commit
  and staleness truth; reads that miss in their own shard are routed to the
  home shard instead of broadcast fog-wide.
* **Shard-local gossip** with ``min(fanout, n_local - 1)`` ring neighbours.
* **One stacked psum** of the scalar metric partials a tick.

The buckets go through the ``all_reduce`` form of ``ppermute``
(``distributed.ppermute``).  What crosses the wire is static, so
``wire_bytes`` is a constant per tick (``sharded_wire_bytes``).

Supported: mutable zipf-cadence workloads under the directory policy;
anything else raises as JAX's engine does (``validate_sharded``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backing_store as bs
from repro_torch.core import workload as wl
from repro_torch.core import writeback as wb
from repro_torch.core.cache_state import CacheLine, CacheState, empty_cache, set_index
from repro_torch.core.coherence import GilbertElliott, gilbert_elliott_advance
from repro_torch.core.distributed import (
    FogGroup,
    _probe,
    _self_probe,
    _touch,
    ppermute,
    psum,
)
from repro_torch.core.flic import insert_rows, invalidate_nodes, update_rows
from repro_torch.core.metrics import TickMetrics, allreduce_bytes, windowed_loop
from repro_torch.core.simulator import (
    SimConfig,
    _expand_lanes_dense,
    _fma32,
    _loss_mask,
    _resolve_backstop_keyed,
    _sum,
    resolve_device,
)
from repro_torch.kernels.ref import max_drop, set_drop

I32, F32 = torch.int32, torch.float32
N_PARTIALS = 22   # scalars in the closing psum


@dataclasses.dataclass(frozen=True)
class ShardedFogState:
    """One rank's state: nothing is replicated but the tick."""

    caches: CacheState       # (n_local, S, W, ...): this shard's nodes
    queue: wb.WriteQueue     # this shard's writer ring (keys homed here)
    store: bs.StoreState     # this shard's view of the store
    channel: GilbertElliott  # (n_local,) receiver states
    tick: torch.Tensor       # int32
    latest_ts: torch.Tensor  # (K,) int32 newest write ts this shard saw


@dataclasses.dataclass(frozen=True)
class ShardDraws:
    """Everything random one shard's tick consumes (float32 uniforms where
    the loss model or the store draws them)."""

    t: int
    w_kids: torch.Tensor                      # (n_local,) write key ids
    r_kids: torch.Tensor                      # (n_local,) read key ids
    u_ge_up: torch.Tensor | None = None       # (n_local,) Gilbert-Elliott advance
    u_ge_dn: torch.Tensor | None = None
    u_gossip: torch.Tensor | None = None      # (n_local, k_g) shard-local delivery
    u_resp: torch.Tensor | None = None        # (n_local, n_local) [reader, responder]
    u_coll: torch.Tensor | None = None        # () store collision


def shard_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: the first 63-bit word of
    ``np.random.SeedSequence((seed, rank))``, distinct for each pair."""
    word = np.random.SeedSequence((seed, rank)).generate_state(1, np.uint64)[0]
    return int(word >> np.uint64(1))


def gossip_fanout(cfg: SimConfig, n_local: int) -> int:
    """Ring neighbours of the shard-local gossip (0: a one-node shard)."""
    if n_local <= 1:
        return 0
    return n_local - 1 if cfg.workload.fanout is None else min(cfg.workload.fanout, n_local - 1)


def draw_shard_tick(cfg: SimConfig, n_local: int, t: int, gen: torch.Generator) -> ShardDraws:
    """One shard's draws for tick ``t``, from its own generator."""
    dev = gen.device
    spec = cfg.workload
    w_kids = wl.sample_key_ids(spec, gen, (n_local,))
    u = {}
    if cfg.loss_model == "gilbert_elliott":
        u["u_ge_up"] = torch.rand((n_local,), generator=gen, device=dev)
        u["u_ge_dn"] = torch.rand((n_local,), generator=gen, device=dev)
    k_g = gossip_fanout(cfg, n_local)
    if cfg.loss_model != "none" and k_g:
        u["u_gossip"] = torch.rand((n_local, k_g), generator=gen, device=dev)
    r_kids = wl.sample_key_ids(spec, gen, (n_local,))
    if cfg.loss_model != "none":
        u["u_resp"] = torch.rand((n_local, n_local), generator=gen, device=dev)
    if cfg.store.collision_prob > 0.0:
        u["u_coll"] = torch.rand((), generator=gen, device=dev)
    return ShardDraws(t=t, w_kids=w_kids, r_kids=r_kids, **u)


SHARD_DRAW_FIELDS = ("w_kids", "r_kids", "u_ge_up", "u_ge_dn", "u_gossip", "u_resp", "u_coll")


def shard_draws_from_arrays(arrays: dict, device) -> list[ShardDraws]:
    """One rank's injected draws: ``t`` (T,) and the ``ShardDraws`` fields
    that its config consumes, each stacked over ticks as a numpy array, as
    one ``ShardDraws`` per tick on ``device``."""
    stacked = {k: torch.from_numpy(np.array(arrays[k])).to(device)
               for k in SHARD_DRAW_FIELDS if k in arrays}
    return [ShardDraws(t=int(t), **{k: v[i] for k, v in stacked.items()})
            for i, t in enumerate(np.asarray(arrays["t"]).tolist())]


def sharded_wire_bytes(cfg: SimConfig, p: int) -> float:
    """Modelled wire bytes a tick over ``p`` ranks: (p - 1) write-forward
    buckets of n_local rows x 5 B (key id + live flag), (p - 1) routed-query
    and (p - 1) response buckets of ceil(n_local / read_period) rows x 5 B,
    and the stacked psum."""
    n_local = cfg.n_nodes // p
    c_r = max(1, -(-n_local // cfg.read_period))
    return (p * (p - 1) * n_local * 5 + 2 * p * (p - 1) * c_r * 5
            + allreduce_bytes(p, N_PARTIALS, 4))


def _buckets(mask: torch.Tensor, dest: torch.Tensor, p: int, cap: int):
    """(send, slot), each (p, L): lane l goes in bucket ``dest[l]`` (the ring
    offset of its target) where ``mask``; bucket 0 stays empty; ``slot`` is
    its packed position, ``cap`` (dropped) for lanes not sent."""
    offs = torch.arange(p, device=mask.device)[:, None]
    send = mask[None, :] & (dest[None, :] == offs) & (offs > 0)
    return send, torch.where(send, torch.cumsum(send.to(I32), 1) - 1, cap)


def _pack(slot: torch.Tensor, cap: int, values: torch.Tensor, flags=None,
          fill: int = 0) -> torch.Tensor:
    """``(p, 2, cap)`` int32 buckets: row 0 the ``values`` at their slots
    (``fill`` elsewhere), row 1 the ``flags`` (0 elsewhere)."""
    p, lanes = slot.shape
    out = torch.full((p, 2, cap + 1), fill, dtype=I32, device=slot.device)
    out[:, 1] = 0
    rows = torch.arange(p, device=slot.device)[:, None].expand(p, lanes)
    out[rows, 0, slot.long()] = values.to(I32).expand(p, lanes)
    if flags is not None:
        out[rows, 1, slot.long()] = flags.to(I32)
    return out[..., :cap]


def _lines_at(lines: CacheLine, idx: torch.Tensor, valid: torch.Tensor) -> CacheLine:
    return dataclasses.replace(
        CacheLine(*(getattr(lines, f.name)[idx] for f in dataclasses.fields(CacheLine))),
        valid=valid)


def insert_in_order(caches: CacheState, lines: CacheLine, node: torch.Tensor, now: int,
                    backend: str | None = None) -> CacheState:
    """Upsert ``B`` lines, line b into cache ``node[b]``, as if one after the
    other in the order b = 0..B-1 (JAX's scan of scalar inserts), through
    one-line-per-node ``insert_rows`` calls.

    Lines into different (node, set) pairs touch disjoint lines, so they
    commute.  The lines all carry ``data_ts = now`` and a payload pure in
    (key, ts): a line whose key repeats the previous live line of its (node,
    set) finds that key present and not older, so it is a no-op.  Only the
    first line of each such run is applied: round j upserts, for each
    node, its j-th remaining line, so the calls number the most runs any
    node holds (one host read for that count).
    """
    n_local, n_sets = caches.tags.shape[0], caches.num_sets
    b = lines.key.shape[0]
    dev = lines.key.device
    bucket = torch.where(lines.valid, node.long() * n_sets + set_index(lines.key, n_sets),
                         n_local * n_sets)
    order = torch.sort(bucket, stable=True).indices
    g, k = bucket[order], lines.key[order]
    repeat = torch.zeros((b,), dtype=torch.bool, device=dev)
    repeat[1:] = (g[1:] == g[:-1]) & (k[1:] == k[:-1])
    head = torch.zeros((b,), dtype=torch.bool, device=dev)
    head[order] = lines.valid[order] & ~repeat
    owner = torch.where(head, node.long(), n_local)
    by_node = torch.sort(owner, stable=True).indices      # heads grouped by node, in order
    counts = torch.bincount(owner, minlength=n_local + 1)[:n_local]
    starts = torch.cumsum(counts, 0) - counts
    for j in range(int(counts.max())):
        live = counts > j
        idx = by_node[(starts + j).clamp(max=b - 1)]
        caches, _ = insert_rows(caches, _lines_at(lines, idx, live), now, backend=backend)
    return caches


def sharded_fog_tick(cfg: SimConfig, group: FogGroup, state: ShardedFogState,
                     draws: ShardDraws) -> tuple[ShardedFogState, TickMetrics]:
    """One tick of the bandwidth-lean fog; every rank returns the same global
    ``TickMetrics`` row (after the closing psum)."""
    n_local = state.caches.tags.shape[0]
    n = cfg.n_nodes
    p, rank = group.world, group.rank
    spec = cfg.workload
    ku = spec.key_universe
    t = draws.t
    dev = state.tick.device
    lo, hi = rank * n_local, (rank + 1) * n_local
    node_ids = torch.arange(lo, hi, dtype=I32, device=dev)
    t_full = torch.full((n_local,), t, dtype=I32, device=dev)
    no_origin = torch.full((n_local,), -1, dtype=I32, device=dev)
    clean = torch.zeros((n_local,), dtype=torch.bool, device=dev)
    caches = state.caches
    latest_ts = state.latest_ts
    store_in = state.store
    if cfg.outage_schedule:
        store_in = bs.apply_outage_schedule(store_in, t, cfg.outage_schedule)

    # ---- 0. deterministic membership + churn cold-start --------------------
    if spec.has_churn:
        online_l = wl.online_mask(spec, n, t, dev)[lo:hi]
        rejoin_l = wl.rejoin_mask(spec, n, t, dev)[lo:hi]
        caches = invalidate_nodes(caches, rejoin_l)
        n_rejoin_l = _sum(rejoin_l)
    else:
        online_l = torch.ones((n_local,), dtype=torch.bool, device=dev)
        n_rejoin_l = torch.zeros((), dtype=I32, device=dev)
    rate_l = wl.rate_mask(spec, n, t, dev)[lo:hi]

    # ---- 1. writes: this shard's draws; which nodes write is deterministic --
    kids_w = draws.w_kids
    w_valid = rate_l & online_l
    keys_w = wl.key_hash(kids_w)
    rows_l = CacheLine(key=keys_w, data_ts=t_full, origin=node_ids,
                       data=wl.versioned_payload(keys_w, t_full, cfg.payload_dim),
                       valid=w_valid, dirty=clean)
    caches, _ = insert_rows(caches, rows_l, t, backend=cfg.probe_backend)
    n_writes_l = _sum(w_valid)

    # ---- 2. shard-local fan-out-bounded gossip (never crosses ranks) -------
    channel = state.channel
    if cfg.loss_model == "gilbert_elliott":
        channel = gilbert_elliott_advance(channel, draws.u_ge_up, draws.u_ge_dn)
    n_coh_l = torch.zeros((), dtype=I32, device=dev)
    k_g = gossip_fanout(cfg, n_local)
    if k_g:
        nbr_l = wl.neighbor_table(n_local, k_g, dev)
        lanes = _loss_mask(cfg, channel, draws.u_gossip, (n_local, k_g), dev)
        delivered = _expand_lanes_dense(lanes, nbr_l, n_local) & online_l[:, None]
        caches, n_coh_l = update_rows(caches, rows_l, delivered, t, node_ids=node_ids,
                                      backend=cfg.probe_backend)

    # ---- 3. route writes to their home shard (bounded buckets) -------------
    # Only (key id, live flag) travel: the write's ts is the tick and its
    # payload is pure in (key, ts).
    home_w = wl.route_keys(spec, n, t, kids_w)
    dest_w = (torch.div(home_w, n_local, rounding_mode="floor") - rank) % p
    hk, hv = kids_w, w_valid & (dest_w == 0)
    if p > 1:
        # Bucket o holds, packed in order, the writes homed o ranks on.
        send, slot = _buckets(w_valid, dest_w, p, n_local)
        arrived = ppermute(group, _pack(slot, n_local, kids_w, send))[1:]   # (p-1, 2, n_local)
        hk = torch.cat([hk, arrived[:, 0].reshape(-1)])
        hv = torch.cat([hv, arrived[:, 1].reshape(-1) != 0])

    # The home owns the key's ring entry, durable commit and staleness truth.
    h_home = wl.route_keys(spec, n, t, hk)
    h_ts = torch.full(hk.shape, t, dtype=I32, device=dev)
    queue, _ = wb.enqueue_keyed(state.queue, hk, h_ts, h_home, hv)
    latest_ts = max_drop(latest_ts, torch.where(hv, hk, ku), h_ts)
    # ... and a lower-bound truth for this shard's own writes, homed anywhere.
    latest_ts = max_drop(latest_ts, torch.where(w_valid, kids_w, ku), t_full)

    # The home node caches the key, so reads routed here find it.
    h_keys = wl.key_hash(hk)
    h_lines = CacheLine(key=h_keys, data_ts=h_ts, origin=torch.full_like(hk, -1),
                        data=wl.versioned_payload(h_keys, h_ts, cfg.payload_dim),
                        valid=hv, dirty=torch.zeros_like(hv))
    caches = insert_in_order(caches, h_lines, (h_home - lo).clamp(0, n_local - 1), t,
                             backend=cfg.probe_backend)

    # ---- 4. reads: own cache -> shard-local fog -> the key's home ----------
    reading_l = ((t + node_ids) % cfg.read_period == 0) & (t > 0) & online_l
    r_kids = draws.r_kids
    r_keys = wl.key_hash(r_kids)
    sidx = set_index(r_keys, cfg.cache_sets)
    caches, hit_local_l, ts_local_l = _self_probe(caches, r_keys, reading_l, t)
    need_fog_l = reading_l & ~hit_local_l

    # 4b. shard-local fog probe: n_local queries x n_local caches.
    hits_qc, way_qc, ts_qc = _probe(caches, r_keys, sidx)            # (caches, queries)
    if cfg.loss_model != "none":
        resp_rq = _loss_mask(cfg, channel, draws.u_resp, (n_local, n_local), dev)
        hits_qc = hits_qc & resp_rq.T
    hits_qc = hits_qc & online_l[:, None] & need_fog_l[None, :]
    ts_masked = torch.where(hits_qc, ts_qc, -1)
    q_slots = torch.arange(n_local, device=dev)
    best_c = ts_masked.argmax(dim=0)
    fog_hit_l = hits_qc.any(dim=0)
    best_ts_l = torch.where(fog_hit_l, ts_masked[best_c, q_slots], -1)
    best_data_l = caches.data[best_c, sidx, way_qc[best_c, q_slots]]
    caches = _touch(caches, hits_qc, way_qc, sidx, t)
    n_responses_l = _sum(hits_qc)

    # 4c. misses go to the key's home shard.
    healthy = bs.store_healthy(store_in, t)
    need_home_l = need_fog_l & ~fog_hit_l
    rdest = (torch.div(wl.route_keys(spec, n, t, r_kids), n_local, rounding_mode="floor")
             - rank) % p
    truth_l = latest_ts[r_kids.clamp(0, ku - 1).long()]

    # Readers homed here already probed every cache of their home shard:
    # straight to the writer ring / store backstop.
    need0 = need_home_l & (rdest == 0)
    qh0, sr0, fl0, fd0, sts0 = _resolve_backstop_keyed(queue, store_in, healthy, need0, r_kids)
    home_served_l, home_ts_l = qh0 | fd0, sts0
    n_queue_hits_l, n_store_reads_l, n_failed_l = _sum(qh0), _sum(sr0), _sum(fl0)
    n_found_l, n_store_missing_l = _sum(fd0), _sum(sr0 & ~fd0)
    n_stale_l = _sum(home_served_l & (sts0 < truth_l))
    n_fog_hits_l = _sum(fog_hit_l)
    n_fog_queries_l = _sum(need_fog_l)

    # One bucket per ring offset, sized by the shard's static reader bound.
    c_r = max(1, -(-n_local // cfg.read_period))
    if p > 1:
        send, slot = _buckets(need_home_l, rdest, p, c_r)
        n_fog_queries_l = n_fog_queries_l + _sum(send)
        queries = _pack(slot, c_r, r_kids, send)                          # (p, 2, c_r)
        q_rdr = _pack(slot, c_r, q_slots.to(I32), fill=n_local)[:, 0]     # reader of each slot
        arrived = ppermute(group, queries)[1:]                            # (p-1, 2, c_r)
        a_kid, a_live = arrived[:, 0].reshape(-1), arrived[:, 1].reshape(-1) != 0

        # Home side, every arrived bucket at once: probe every local cache,
        # then the backstop.  Store reads, hits and staleness (exact: the
        # home owns the truth) count HERE; only (served, version) returns.
        a_keys = wl.key_hash(a_kid)
        a_hits, _, a_ts = _probe(caches, a_keys, set_index(a_keys, cfg.cache_sets))
        a_hits = a_hits & online_l[:, None] & a_live[None, :]
        a_fog = a_hits.any(dim=0)
        a_fog_ts = torch.where(a_hits, a_ts, -1).amax(dim=0)
        aqh, asr, afl, afd, asts = _resolve_backstop_keyed(queue, store_in, healthy,
                                                           a_live & ~a_fog, a_kid)
        a_served = a_fog | aqh | afd
        a_served_ts = torch.where(a_fog, a_fog_ts, asts)
        a_truth = latest_ts[a_kid.clamp(0, ku - 1).long()]
        n_fog_hits_l = n_fog_hits_l + _sum(a_fog)
        n_responses_l = n_responses_l + _sum(a_hits)
        n_queue_hits_l = n_queue_hits_l + _sum(aqh)
        n_store_reads_l = n_store_reads_l + _sum(asr)
        n_failed_l = n_failed_l + _sum(afl)
        n_found_l = n_found_l + _sum(afd)
        n_store_missing_l = n_store_missing_l + _sum(asr & ~afd)
        n_stale_l = n_stale_l + _sum(a_served & (a_served_ts < a_truth))
        store_in = dataclasses.replace(store_in, api_calls=store_in.api_calls + _sum(asr))

        # Answers go back the inverse hop: bucket o's travels p - o on.
        back = torch.zeros((p, 2, c_r), dtype=I32, device=dev)
        back[p - torch.arange(1, p, device=dev)] = torch.stack(
            [a_served.to(I32).reshape(p - 1, c_r), a_served_ts.reshape(p - 1, c_r)], dim=1)
        answers = ppermute(group, back)[p - torch.arange(1, p, device=dev)]   # my bucket o's
        live = queries[1:, 1] != 0
        home_served_l = set_drop(home_served_l, q_rdr[1:].reshape(-1),
                                 ((answers[:, 0] != 0) & live).reshape(-1))
        home_ts_l = set_drop(home_ts_l, q_rdr[1:].reshape(-1), answers[:, 1].reshape(-1))

    store = dataclasses.replace(store_in, api_calls=store_in.api_calls + _sum(sr0))
    wan_rx_l = n_store_reads_l.to(F32) * cfg.store.read_txn_bytes(store_in.drained_total)

    # 4d. fill the readers from fog / home responses.
    fill_ts = torch.where(fog_hit_l, best_ts_l, home_ts_l)
    fill_lines = CacheLine(
        key=r_keys, data_ts=fill_ts, origin=no_origin,
        data=torch.where(fog_hit_l[:, None], best_data_l,
                         wl.versioned_payload(r_keys, fill_ts, cfg.payload_dim)),
        valid=fog_hit_l | home_served_l, dirty=clean,
    )
    caches, _ = insert_rows(caches, fill_lines, t, backend=cfg.probe_backend)

    # Staleness of reads served in the shard, against its lower-bound truth.
    got_ts_l = torch.where(hit_local_l, ts_local_l, best_ts_l)
    n_stale_l = n_stale_l + _sum((hit_local_l | fog_hit_l) & (got_ts_l < truth_l))

    # ---- 5. this shard's writer; the API budget is split over the ranks ----
    queue, n_drained_l, n_calls_l = wb.drain(
        queue, t, healthy,
        rate_per_tick=cfg.store.api_rate_per_tick / p,
        burst=max(cfg.store.api_burst / p, 1.0),
        max_per_tick=cfg.writer_max_per_tick,
    )
    store = bs.commit_writes(store, n_drained_l, n_calls_l, draws.u_coll, cfg.store)
    d_kids, d_ts, d_live = wb.drained_entries(queue, n_drained_l, cfg.writer_max_per_tick)
    store = bs.commit_keyed_rows(store, d_kids, d_ts, d_live)
    wan_tx_l = cfg.store.write_txn_bytes(n_drained_l)

    # ---- 6. one stacked psum of the partials; global expressions after -----
    n_reads_l = _sum(reading_l)
    baseline_l = (
        n_writes_l.to(F32) * cfg.row_bytes
        + n_reads_l.to(F32) * cfg.store.read_txn_bytes(queue.tail + queue.dropped
                                                       + queue.coalesced)
    )
    partials = torch.stack([x.to(F32) for x in (
        n_rejoin_l, n_writes_l, n_coh_l, n_reads_l, _sum(hit_local_l), n_fog_hits_l,
        n_queue_hits_l, n_store_reads_l, n_failed_l, n_found_l, n_store_missing_l,
        n_drained_l, n_calls_l, n_stale_l, n_fog_queries_l, n_responses_l,
        queue.coalesced - state.queue.coalesced, queue.size(), queue.dropped,
        wan_tx_l, wan_rx_l, baseline_l,
    )])
    (g_rejoin, g_writes, g_coh, g_reads, g_hits_local, g_fog_hits, g_queue_hits,
     g_store_reads, g_failed, g_found, g_store_missing, g_drained, g_calls, g_stale,
     g_fog_queries, g_responses, g_coalesced, g_depth, g_dropped, g_wan_tx, g_wan_rx,
     g_baseline) = psum(group, partials).unbind()

    lan = (g_writes * cfg.row_bytes + g_fog_queries * cfg.query_bytes
           + (g_responses + g_queue_hits) * cfg.row_bytes)
    lat = _fma32(g_store_reads + g_failed, cfg.lat_store,
                 _fma32(g_hits_local, cfg.lat_local,
                        (g_fog_hits + g_queue_hits)
                        * (cfg.lat_lan_base + cfg.lat_lan_per_node * n)))
    metrics = TickMetrics(
        wan_tx_bytes=g_wan_tx,
        wan_rx_bytes=g_wan_rx,
        lan_bytes=lan,
        reads=g_reads.to(I32),
        hits_local=g_hits_local.to(I32),
        hits_fog=g_fog_hits.to(I32),
        misses=(g_store_reads + g_failed).to(I32),
        store_found=g_found.to(I32),
        store_missing=g_store_missing.to(I32),
        writes_gen=g_writes.to(I32),
        writes_drained=g_drained.to(I32),
        queue_depth=g_depth.to(I32),
        queue_dropped=g_dropped.to(I32),
        store_txn_bytes=g_wan_rx + g_wan_tx,
        store_txns=(g_store_reads + g_calls).to(I32),
        read_latency_sum=lat,
        baseline_wan_bytes=g_baseline,
        hits_queue=g_queue_hits.to(I32),
        ticks=torch.ones((), dtype=I32, device=dev),
        coherence_updates=g_coh.to(I32),
        stale_reads=g_stale.to(I32),
        writes_coalesced=g_coalesced.to(I32),
        churn_rejoins=g_rejoin.to(I32),
        wire_bytes=torch.full((), sharded_wire_bytes(cfg, p), dtype=F32, device=dev),
    )
    new_state = ShardedFogState(caches=caches, queue=queue, store=store, channel=channel,
                                tick=state.tick + 1, latest_ts=latest_ts)
    return new_state, metrics


def validate_sharded(cfg: SimConfig) -> None:
    """Reject workloads outside the sharded engine's family, as JAX does."""
    spec = cfg.workload
    if not (spec.mutable and spec.popularity == "zipf" and spec.arrivals == "cadence"):
        raise ValueError(
            f"engine='sharded' supports mutable zipf-cadence workloads "
            f"(popularity='zipf', arrivals='cadence'); got "
            f"popularity={spec.popularity!r}, arrivals={spec.arrivals!r}. "
            f"The consistent-hash routing ring homes KEY IDS, which the "
            f"stream/trace/poisson request shapes don't provide per lane — "
            f"use engine='distributed' (bit-identical parity) for those."
        )
    if cfg.insert_policy != "directory":
        raise ValueError(
            "engine='sharded' supports insert_policy='directory' only: the "
            "replicate ablation broadcasts every payload fog-wide, which is "
            "exactly the traffic this engine exists to avoid — use "
            "engine='distributed' for the replicate ablation."
        )


def init_sharded_fog(cfg: SimConfig, n_local: int, device=None) -> ShardedFogState:
    """One rank's fresh state."""
    device = resolve_device(device)
    ku = cfg.workload.key_universe
    return ShardedFogState(
        caches=empty_cache(cfg.cache_sets, cfg.cache_ways, cfg.payload_dim,
                           batch=(n_local,), device=device),
        queue=wb.empty_queue(cfg.queue_capacity, key_universe=ku, device=device),
        store=bs.init_store(key_universe=ku, device=device),
        channel=GilbertElliott.init(n_local, device=device),
        tick=torch.zeros((), dtype=I32, device=device),
        latest_ts=torch.full((ku,), -1, dtype=I32, device=device),
    )


def _merge_sharded_states(ranks: list[dict]) -> dict:
    """Caches and channel concatenated in node order, the tick from rank 0,
    the per-shard rest stacked with a leading (p,) axis (JAX's layout)."""
    out = {}
    for path in ranks[0]:
        parts = [r[path] for r in ranks]
        if path.startswith(("caches.", "channel.")):
            out[path] = np.concatenate(parts)
        else:
            out[path] = parts[0] if path == "tick" else np.stack(parts)
    return out


def _run_sharded_rank(cfg: SimConfig, group: FogGroup, ticks: int, seed: int,
                      metrics_every: int, draws):
    """One rank's tick loop on its own stream (``shard_seed(seed, rank)``),
    or on its series of injected ``draws`` (one arrays dict per rank)."""
    n_local = cfg.n_nodes // group.world
    ticks_host = iter(range(ticks))
    if draws is None:
        gen = torch.Generator(device=group.device)
        gen.manual_seed(shard_seed(seed, group.rank))

        def source(t: int) -> ShardDraws:
            return draw_shard_tick(cfg, n_local, t, gen)
    else:
        replay = iter(shard_draws_from_arrays(draws[group.rank], group.device))

        def source(t: int) -> ShardDraws:
            d = next(replay)
            if d.t != t:
                raise ValueError(f"draws hold tick {d.t} where tick {t} is due")
            return d

    def step(s):
        return sharded_fog_tick(cfg, group, s, source(next(ticks_host)))

    return windowed_loop(step, init_sharded_fog(cfg, n_local, group.device), ticks,
                         metrics_every)


def run_sharded_sim(cfg: SimConfig, ticks: int, *, world: int, backend: str, seed: int = 0,
                    device=None, metrics_every: int = 1, draws=None,
                    timeout: float = 1800.0) -> tuple[ShardedFogState, TickMetrics]:
    """Run the bandwidth-lean fog for ``ticks`` over ``world`` ranks.

    Returns (final state: caches and channel in node order, the per-shard
    rest stacked (p, ...); rank 0's ``TickMetrics`` series).  With native
    draws (``draws=None``: each rank draws its own stream) the series is
    held to the tolerance tier, not bitwise; ``draws`` (one arrays dict per
    rank, ``shard_draws_from_arrays``) replays injected per-shard draws,
    such as JAX's sharded engine's, tick for tick.
    """
    from repro_torch.core.distributed import EngineRun, run_group

    res = run_group([EngineRun("sharded", cfg, ticks, seed, metrics_every, draws)],
                    world=world, backend=backend, device=device, timeout=timeout)[0]
    return res.state, res.series
