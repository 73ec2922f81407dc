"""Reference (pre-fusion) fog tick, kept per-pass (port of
``repro.core.simulator_ref``).

The simulator in the shape it had before the fused engine (DESIGN.md §3):
the scalar ``flic.insert`` mapped over nodes (``torch.func.vmap``) for the
own-row writes and the read fills, the replicate merge as
``coherence.merge_broadcasts``, a separate local probe, the full (C, N, W)
fog probe, a second pass that touches the responders' LRU stamps, and the
coherence sweep run on EVERY tick, write-once workloads included (there it
is a counted no-op, which is what makes the fused engine's skip a checked
claim).  Of the fused engine's batched primitives it calls only
``flic.update_rows`` and ``flic.invalidate_nodes``, as JAX's reference does.

It executes the same ``TickDraws`` as ``simulator.sim_tick`` and must emit
the same ``TickMetrics`` series bit for bit.  Do not "optimize" this file.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import backing_store as bs
from repro_torch.core import workload as wl
from repro_torch.core import writeback as wb
from repro_torch.core.cache_state import CacheLine, set_index
from repro_torch.core.coherence import gilbert_elliott_advance, merge_broadcasts
from repro_torch.core.flic import insert, invalidate_nodes, update_rows, vmap_nodes
from repro_torch.core.metrics import TickMetrics
from repro_torch.core.simulator import (
    SimConfig,
    SimState,
    TickDraws,
    _delivery_mask_dense,
    _fma32,
    _insert_own_rows,
    _neighbor_index,
    _resolve_backstop,
    _resolve_backstop_keyed,
    _response_mask_dense,
    _sum,
    needs_delivery_mask,
)
from repro_torch.kernels.ref import _first_true, max_drop

I32, F32 = torch.int32, torch.float32


def sim_tick_ref(cfg: SimConfig, state: SimState, draws: TickDraws) -> tuple[SimState, TickMetrics]:
    """One tick of the reference engine on the draws of tick ``draws.t``."""
    n = cfg.n_nodes
    spec = cfg.workload
    t = draws.t
    plan = draws.plan
    dev = state.tick.device
    caches = state.caches
    latest_ts = state.latest_ts
    store_in = state.store
    if cfg.outage_schedule:
        store_in = bs.apply_outage_schedule(store_in, t, cfg.outage_schedule)

    # ---- 0. churn: rejoining nodes cold-start -----------------------------
    online = plan.online
    if spec.has_churn:
        caches = invalidate_nodes(caches, plan.rejoin)
        n_rejoin = _sum(plan.rejoin)
    else:
        n_rejoin = torch.zeros((), dtype=I32, device=dev)

    # ---- 1. the plan's write waves -----------------------------------------
    rows_waves = [wl.plan_write_rows(cfg, plan, p, t) for p in range(spec.plan_waves)]
    n_writes = _sum(plan.w_valid)

    # ---- 2. fog broadcast under the loss model -----------------------------
    # The delivery mask is drawn only where a consumer exists; on the
    # write-once directory path the sweep below is a counted no-op, so full
    # delivery stands in for it.
    nbr = _neighbor_index(cfg, dev)
    channel = state.channel
    if cfg.loss_model == "gilbert_elliott":
        channel = gilbert_elliott_advance(channel, draws.u_ge_up, draws.u_ge_dn)
    if needs_delivery_mask(cfg):
        delivered = _delivery_mask_dense(cfg, channel, draws.u_deliver, nbr, dev)
    else:
        delivered = torch.ones((n, n), dtype=torch.bool, device=dev)
    if spec.has_churn:
        delivered = delivered & online[:, None]
    n_coh = torch.zeros((), dtype=I32, device=dev)
    if cfg.insert_policy == "directory":
        for rows in rows_waves:
            caches = _insert_own_rows(caches, rows, t)
            # The per-tick coherence sweep, ALWAYS run here.
            caches, n_coh_p = update_rows(caches, rows, delivered, t)
            n_coh = n_coh + n_coh_p
    else:
        for rows in rows_waves:
            caches, _ = merge_broadcasts(caches, rows, delivered, t)
    lan = n_writes.to(F32) * cfg.row_bytes

    # ---- 3. write-behind enqueue (single writer, §I.A.b) -------------------
    queue = state.queue
    if spec.mutable:
        for p, rows in enumerate(rows_waves):
            queue, _ = wb.enqueue_keyed(queue, plan.w_kids[p], rows.data_ts,
                                        rows.origin, plan.w_valid[p])
            latest_ts = max_drop(
                latest_ts, torch.where(plan.w_valid[p], plan.w_kids[p], spec.key_universe),
                rows.data_ts,
            )
    else:
        rows = rows_waves[0]
        queue, _ = wb.enqueue(queue, rows.key, rows.data_ts, rows.origin, plan.w_valid[0])

    # ---- 4. reads: execute the plan's read lanes ---------------------------
    reading = plan.reading
    r_keys = plan.r_keys

    # 4a. local probe, node by node; LRU refreshed only for nodes reading.
    def self_probe(cache, key, is_reading):
        sidx = set_index(key, cache.num_sets)
        match = cache.valid[sidx] & (cache.tags[sidx] == key)
        hit = match.any() & is_reading
        way = _first_true(match).long()
        line = (sidx, way)
        ts = torch.where(hit, cache.data_ts[line], -1)
        old = cache.last_use[line]
        cache = dataclasses.replace(cache, last_use=cache.last_use.index_put(
            line, torch.where(hit, torch.clamp(old, min=t), old)))
        return cache, hit, ts

    caches, hit_local, ts_local = vmap_nodes(self_probe)(caches, r_keys, reading)

    # 4b. fog query for local misses: reader q probes every cache c.
    need_fog = reading & ~hit_local
    sidx_q = set_index(r_keys, cfg.cache_sets)                             # (N,)
    tags_cq = caches.tags[:, sidx_q]                                       # (C, Q, W)
    match_cq = caches.valid[:, sidx_q] & (tags_cq == r_keys[None, :, None])
    hits_cq = match_cq.any(dim=2)
    way_cq = _first_true(match_cq).long()
    c_ids = torch.arange(n, device=dev)
    q_ids = torch.arange(n, device=dev)
    ts_cq = torch.where(hits_cq, caches.data_ts[c_ids[:, None], sidx_q[None, :], way_cq], -1)
    data_cq = caches.data[c_ids[:, None], sidx_q[None, :], way_cq]          # (C, Q, D)
    hits_qc = hits_cq.T
    ts_qc = ts_cq.T
    # Response loss: the compact reader-row draw expanded to the dense
    # [reader, responder] view; non-reader rows are never consumed.
    resp_dense = _response_mask_dense(cfg, channel, plan, nbr, draws.u_resp)
    if resp_dense is not None:
        hits_qc = hits_qc & resp_dense
        ts_qc = torch.where(hits_qc, ts_qc, -1)
    if spec.has_churn:
        hits_qc = hits_qc & online[None, :]   # offline responders are silent
    best_c = torch.where(hits_qc, ts_qc, -1).argmax(dim=1)                 # (Q,)
    fog_hit = need_fog & hits_qc.any(dim=1)
    best_payload = data_cq[best_c, q_ids]                                  # (Q, D)
    best_ts = torch.where(fog_hit, ts_qc[q_ids, best_c], -1)

    # LRU refresh at responders: every line that served a query is touched.
    live_cq = (hits_qc & need_fog[:, None]).T                              # (C, Q)
    flat = sidx_q[None, :] * cfg.cache_ways + way_cq
    src = torch.where(live_cq, t, torch.iinfo(I32).min).to(I32)
    caches = dataclasses.replace(
        caches,
        last_use=caches.last_use.reshape(n, -1)
        .scatter_reduce(1, flat, src, "amax")
        .reshape(caches.last_use.shape),
    )

    n_fog_queries = _sum(need_fog)
    n_responses = _sum(hits_qc & need_fog[:, None])

    # 4c. writer-buffer forwarding, then the backing store (§VI).
    healthy = bs.store_healthy(store_in, t)
    need_store = need_fog & ~fog_hit
    if spec.mutable:
        queue_hit, store_read, failed, found, served_ts = _resolve_backstop_keyed(
            queue, store_in, healthy, need_store, plan.r_kids)
    else:
        queue_hit, store_read, failed, found, _ = _resolve_backstop(
            queue, store_in, healthy, need_store, plan.r_enq_idx)
    n_store_reads = _sum(store_read)
    n_queue_hits = _sum(queue_hit)
    n_failed = _sum(failed)
    lan = lan + n_fog_queries * cfg.query_bytes + (n_responses + n_queue_hits) * cfg.row_bytes
    txn = cfg.store.read_txn_bytes(store_in.drained_total)
    wan_rx = n_store_reads.to(F32) * txn
    store = dataclasses.replace(store_in, api_calls=store_in.api_calls + n_store_reads)

    # 4d. fill the reader's local cache from fog/queue/store responses.
    fill_ok = fog_hit | queue_hit | found
    if spec.mutable:
        fill_lines = CacheLine(
            key=r_keys,
            data_ts=torch.where(fog_hit, best_ts, served_ts),
            origin=torch.full((n,), -1, dtype=I32, device=dev),
            data=torch.where(fog_hit[:, None], best_payload,
                             wl.versioned_payload(r_keys, served_ts, cfg.payload_dim)),
            valid=fill_ok,
            dirty=torch.zeros((n,), dtype=torch.bool, device=dev),
        )
    else:
        fill_lines = CacheLine(
            key=r_keys,
            data_ts=torch.where(fog_hit, best_ts, plan.r_fill_ts),
            origin=plan.r_src,
            data=torch.where(fog_hit[:, None], best_payload,
                             wl.payload_for(r_keys, cfg.payload_dim)),
            valid=fill_ok,
            dirty=torch.zeros((n,), dtype=torch.bool, device=dev),
        )
    caches = vmap_nodes(lambda cache, line: insert(cache, line, t)[0])(caches, fill_lines)

    # 4e. staleness: served reads older than the key's newest write.
    if spec.mutable:
        served = hit_local | fog_hit | queue_hit | found
        got_ts = torch.where(hit_local, ts_local, torch.where(fog_hit, best_ts, served_ts))
        truth = latest_ts[plan.r_kids.clamp(0, spec.key_universe - 1).long()]
        n_stale = _sum(served & (got_ts < truth))
    else:
        n_stale = torch.zeros((), dtype=I32, device=dev)

    # ---- 5. writer drain + store commit ------------------------------------
    queue, n_drained, n_calls = wb.drain(
        queue, t, healthy,
        rate_per_tick=cfg.store.api_rate_per_tick,
        burst=cfg.store.api_burst,
        max_per_tick=cfg.writer_max_per_tick,
    )
    store = bs.commit_writes(store, n_drained, n_calls, draws.u_coll, cfg.store)
    if spec.mutable:
        d_kids, d_ts, d_live = wb.drained_entries(queue, n_drained, cfg.writer_max_per_tick)
        store = bs.commit_keyed_rows(store, d_kids, d_ts, d_live)
    wan_tx = cfg.store.write_txn_bytes(n_drained)

    # ---- 6. latency model + baseline accounting ----------------------------
    n_reads = _sum(reading)
    n_hits_local = _sum(hit_local)
    n_fog_hits = _sum(fog_hit)
    # The sum XLA on the CPU compiles: fma(c, lat_store, fma(a, lat_local, b*lat_lan)).
    lat_lan = (n_fog_hits + n_queue_hits).to(F32) * (cfg.lat_lan_base + cfg.lat_lan_per_node * n)
    lat = _fma32((n_store_reads + n_failed).to(F32), cfg.lat_store,
                 _fma32(n_hits_local.to(F32), cfg.lat_local, lat_lan))
    baseline_table_rows = queue.tail + queue.dropped + queue.coalesced
    baseline = (
        n_writes.to(F32) * cfg.row_bytes
        + n_reads.to(F32) * cfg.store.read_txn_bytes(baseline_table_rows)
    )

    metrics = TickMetrics(
        wan_tx_bytes=wan_tx,
        wan_rx_bytes=wan_rx,
        lan_bytes=lan,
        reads=n_reads,
        hits_local=n_hits_local,
        hits_fog=n_fog_hits,
        misses=n_store_reads + n_failed,
        store_found=_sum(found),
        store_missing=_sum(store_read & ~found),
        writes_gen=n_writes,
        writes_drained=n_drained,
        queue_depth=queue.size(),
        queue_dropped=queue.dropped,
        store_txn_bytes=wan_rx + wan_tx,
        store_txns=n_store_reads + n_calls,
        read_latency_sum=lat,
        baseline_wan_bytes=baseline,
        hits_queue=n_queue_hits,
        ticks=torch.ones((), dtype=I32, device=dev),
        coherence_updates=n_coh,
        stale_reads=n_stale,
        writes_coalesced=queue.coalesced - state.queue.coalesced,
        churn_rejoins=n_rejoin,
        wire_bytes=torch.zeros((), dtype=F32, device=dev),
    )
    new_state = SimState(
        caches=caches, queue=queue, store=store, channel=channel,
        tick=state.tick + 1, latest_ts=latest_ts, plan=plan.state_next,
    )
    return new_state, metrics
