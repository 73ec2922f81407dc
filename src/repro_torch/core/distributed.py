"""The distributed fog on ``torch.distributed``: full §VI parity (port of
``repro.core.distributed``).

Fog nodes are split over ``world`` ranks, ``n_nodes / world`` each; a rank
holds only its nodes' caches.  Everything else is a global singleton
evaluated REPLICATED, as JAX's ``shard_map`` engine evaluates it: every
rank executes the same ``TickDraws`` (a replayed JAX run, or the native
planner from a generator seeded identically on every rank), so the plan,
the loss channel, the writer's ring, the store and every metric agree with
no communication.  Only the results that are truly sharded cross ranks:

* the fog read-request flags (``all_gather``, the broadcast of the query);
* the newest responding timestamp and, at it, the highest responder id
  (one ``pmax`` of the pair packed in an int64), which make the winner of
  each query unique;
* the winner's payload (``psum``: one non-zero addend, so the sum is exact);
* the counts of responses, local hits, coherence updates and stale reads
  (one stacked psum).

Hence the conformance contract: the ``TickMetrics`` series equals the fused
engine's bit for bit, at every world size, except ``wire_bytes``, the
modelled ring cost of those collectives (``parity_wire_bytes``).

The group and its collectives
-----------------------------
``FogGroup`` stands in for the mesh axis and ``psum``/``pmax``/
``all_gather``/``ppermute`` for ``jax.lax``'s (``ppermute`` moves a block
at every ring offset in one call).  All four use
``dist.all_reduce`` alone (SUM or MAX), because gloo offers only
``all_reduce`` and ``broadcast`` on CUDA tensors, and several ranks on one
card must use gloo: NCCL refuses two ranks on one GPU.  Flags travel as
int32.  ``"nccl"`` puts rank r on ``cuda:r``; ``"gloo"`` puts every rank on
the one device the caller names.  There is no automatic switch.

The launcher
------------
``run_group`` spawns one process per rank (``torch.multiprocessing``,
spawn), each running ``_rank_main`` over a list of ``EngineRun``; it joins
them with a timeout, and any rank's exception or non-zero exit raises in
the caller.  The parent builds the CUDA kernels first, so the ranks only
load them.  ``run_distributed_sim`` and ``sharded.run_sharded_sim`` are its
one-run forms.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue as queue_mod
import socket
import time
import traceback
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import backing_store as bs
from repro_torch.core import workload as wl
from repro_torch.core import writeback as wb
from repro_torch.core.cache_state import CacheLine, CacheState, empty_cache, set_index
from repro_torch.core.coherence import GilbertElliott, gilbert_elliott_advance
from repro_torch.core.flic import insert_rows, invalidate_nodes, kernels, update_rows
from repro_torch.core.metrics import (
    TickMetrics,
    allgather_bytes,
    allreduce_bytes,
    field_names,
    windowed_loop,
)
from repro_torch.core.simulator import (
    SimConfig,
    TickDraws,
    _delivery_mask_dense,
    _fma32,
    _leaves,
    _merge_replicate,
    _neighbor_index,
    _resolve_backstop,
    _resolve_backstop_keyed,
    _response_mask_dense,
    _sum,
    draw_tick,
    needs_delivery_mask,
    resolve_device,
)
from repro_torch.kernels.ref import _first_true, max_drop

I32, F32 = torch.int32, torch.float32
BACKENDS = ("gloo", "nccl")


# --------------------------------------------------------------------------
# The group and its collectives (the counterparts of jax.lax's).
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FogGroup:
    """One rank's view of the fog's process group."""

    rank: int
    world: int
    group: dist.ProcessGroup
    device: torch.device


def _all_reduce(g: FogGroup, x: torch.Tensor, op) -> torch.Tensor:
    """``x`` reduced over the group; bool travels as int32 and comes back bool."""
    buf = x.to(I32) if x.dtype == torch.bool else x.clone()
    dist.all_reduce(buf, op=op, group=g.group)
    return buf != 0 if x.dtype == torch.bool else buf


def psum(g: FogGroup, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(g, x, dist.ReduceOp.SUM)


def pmax(g: FogGroup, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(g, x, dist.ReduceOp.MAX)


def all_gather(g: FogGroup, x: torch.Tensor) -> torch.Tensor:
    """Tiled all-gather: rank r's ``(m, ...)`` block lands at rows
    ``[r*m, (r+1)*m)`` of a zeroed ``(world*m, ...)`` buffer, then SUM."""
    m = x.shape[0]
    dtype = I32 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((g.world * m, *x.shape[1:]), dtype=dtype, device=x.device)
    buf[g.rank * m:(g.rank + 1) * m] = x
    return _all_reduce(g, buf, dist.ReduceOp.SUM).to(x.dtype)


def ppermute(g: FogGroup, blocks: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ppermute`` round the ring, every offset in one call:
    ``blocks[o]`` travels from rank r to rank ``(r + o) % world``, and
    ``out[o]`` is the block that rank ``(r - o) % world`` sent at offset o
    (``out[0] = blocks[0]`` stays).  Each rank writes its ``(world, ...)``
    blocks into row ``rank`` of a zeroed ``(world, world, ...)`` buffer,
    SUM, then reads ``buf[(rank - o) % world, o]``."""
    p = g.world
    dtype = I32 if blocks.dtype == torch.bool else blocks.dtype
    buf = torch.zeros((p, *blocks.shape), dtype=dtype, device=blocks.device)
    buf[g.rank] = blocks
    buf = _all_reduce(g, buf, dist.ReduceOp.SUM)
    src = (g.rank - torch.arange(p, device=blocks.device)) % p
    return buf[src, torch.arange(p, device=blocks.device)].to(blocks.dtype)


# --------------------------------------------------------------------------
# Probes shared with the sharded engine.
# --------------------------------------------------------------------------

def _self_probe(caches: CacheState, keys, reading, now: int):
    """Each node probes its own cache for its key (the first matching way);
    a reading hit refreshes the line's LRU stamp.  Returns (caches, hit, ts)."""
    rows = torch.arange(keys.shape[0], device=keys.device)
    sidx = set_index(keys, caches.num_sets)
    match = caches.valid[rows, sidx] & (caches.tags[rows, sidx] == keys[:, None])
    hit = match.any(dim=1) & reading
    line = (rows, sidx, _first_true(match).long())
    ts = torch.where(hit, caches.data_ts[line], -1)
    old = caches.last_use[line]
    last_use = caches.last_use.index_put(line, torch.where(hit, old.clamp(min=now), old))
    return dataclasses.replace(caches, last_use=last_use), hit, ts


def _probe(caches: CacheState, keys_q, sidx_q):
    """Every cache probed for every query: (hit, way, ts), each (C, Q); the
    first matching way, ts -1 on a miss."""
    match = caches.valid[:, sidx_q] & (caches.tags[:, sidx_q] == keys_q[None, :, None])
    hit = match.any(dim=-1)
    way = _first_true(match).long()
    ts = caches.data_ts[:, sidx_q].gather(-1, way[..., None])[..., 0]
    return hit, way, torch.where(hit, ts, -1)


def _touch(caches: CacheState, hits_cq, way_cq, sidx_q, now: int) -> CacheState:
    """LRU refresh of every line that answered: last_use = max(last_use, now)."""
    c = caches.tags.shape[0]
    flat = sidx_q[None, :] * caches.num_ways + way_cq
    src = torch.where(hits_cq, now, torch.iinfo(I32).min).to(I32)
    return dataclasses.replace(
        caches,
        last_use=caches.last_use.reshape(c, -1)
        .scatter_reduce(1, flat, src, "amax").reshape(caches.last_use.shape),
    )


# --------------------------------------------------------------------------
# The parity engine.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FogShardState:
    """One rank's nodes' caches and the replicated global state."""

    caches: CacheState       # (n_local, S, W, ...): this rank's nodes
    queue: wb.WriteQueue     # replicated
    store: bs.StoreState     # replicated
    channel: GilbertElliott  # replicated (N,) receiver states
    tick: torch.Tensor       # replicated int32
    latest_ts: torch.Tensor  # replicated (K,) int32 newest write per key id
    plan: wl.PlanState       # replicated


def init_fog_shard(cfg: SimConfig, n_local: int, device=None) -> FogShardState:
    device = resolve_device(device)
    ku = cfg.workload.key_universe if cfg.workload.mutable else 0
    return FogShardState(
        caches=empty_cache(cfg.cache_sets, cfg.cache_ways, cfg.payload_dim,
                           batch=(n_local,), device=device),
        queue=wb.empty_queue(cfg.queue_capacity, key_universe=ku, device=device),
        store=bs.init_store(key_universe=ku, device=device),
        channel=GilbertElliott.init(cfg.n_nodes, device=device),
        tick=torch.zeros((), dtype=I32, device=device),
        latest_ts=torch.full((ku,), -1, dtype=I32, device=device),
        plan=wl.init_plan_state(cfg, device=device),
    )


def parity_wire_bytes(cfg: SimConfig, p: int) -> float:
    """The parity tick's modelled wire bytes over ``p`` ranks: its collectives
    are dense and static, so the figure is a constant per tick."""
    n = cfg.n_nodes
    wire = (
        allgather_bytes(p, n // p, 1)                  # q_need broadcast (bool)
        + allreduce_bytes(p, n, 4)                     # win_ts pmax (i32) and
        + allreduce_bytes(p, n, 4)                     # win_node pmax (i32): one i64 here
        + allreduce_bytes(p, n * cfg.payload_dim, 4)   # win_data psum
        + allreduce_bytes(p, 1, 4)                     # n_responses psum
        + allreduce_bytes(p, 1, 4)                     # n_hits_local psum
    )
    if cfg.workload.mutable:
        wire += allreduce_bytes(p, 1, 4) + allreduce_bytes(p, 1, 4)   # n_coh, n_stale
    return wire


def _rows_slice(rows: CacheLine, lo: int, hi: int) -> CacheLine:
    return CacheLine(*(getattr(rows, f.name)[lo:hi] for f in dataclasses.fields(CacheLine)))


def fog_shard_tick(cfg: SimConfig, group: FogGroup, state: FogShardState,
                   draws: TickDraws) -> tuple[FogShardState, TickMetrics]:
    """One tick of the distributed fog on the draws of tick ``draws.t``: the
    fused engine's ``TickMetrics`` bit for bit (``wire_bytes`` aside)."""
    n_local = state.caches.tags.shape[0]
    n = cfg.n_nodes
    spec = cfg.workload
    t = draws.t
    plan = draws.plan
    dev = state.tick.device
    lo, hi = group.rank * n_local, (group.rank + 1) * n_local
    node_ids = torch.arange(lo, hi, dtype=I32, device=dev)
    zero = torch.zeros((), dtype=I32, device=dev)
    caches = state.caches
    latest_ts = state.latest_ts
    store_in = state.store
    if cfg.outage_schedule:
        store_in = bs.apply_outage_schedule(store_in, t, cfg.outage_schedule)

    def my(xs):
        """This rank's node slice of a replicated leading-(n,) tensor."""
        return xs[lo:hi]

    # ---- 0. churn: rejoining shard nodes cold-start ------------------------
    online = plan.online
    if spec.has_churn:
        caches = invalidate_nodes(caches, my(plan.rejoin))
        n_rejoin = _sum(plan.rejoin)
    else:
        n_rejoin = zero

    # ---- 1. the plan's write waves (replicated) -----------------------------
    rows_waves = [wl.plan_write_rows(cfg, plan, p, t) for p in range(spec.plan_waves)]
    n_writes = _sum(plan.w_valid)

    # ---- 2. fog broadcast under the loss model; the shard's merge ----------
    nbr = _neighbor_index(cfg, dev)
    channel = state.channel
    if cfg.loss_model == "gilbert_elliott":
        channel = gilbert_elliott_advance(channel, draws.u_ge_up, draws.u_ge_dn)
    delivered = None
    if needs_delivery_mask(cfg):
        delivered = _delivery_mask_dense(cfg, channel, draws.u_deliver, nbr, dev)
        if spec.has_churn:
            delivered = delivered & online[:, None]     # offline nodes hear nothing
    n_coh_l = zero
    if cfg.insert_policy == "directory":
        for rows in rows_waves:
            # Each node upserts its own row: JAX maps the scalar insert over
            # the shard's nodes; ``insert_rows`` is its batched form.
            caches, _ = insert_rows(caches, _rows_slice(rows, lo, hi), t,
                                    backend=cfg.probe_backend)
            if spec.mutable:
                # The live sweep: all n rows against this shard's caches.
                caches, n_coh_p = update_rows(caches, rows, my(delivered), t,
                                              node_ids=node_ids, backend=cfg.probe_backend)
                n_coh_l = n_coh_l + n_coh_p
    else:
        for rows in rows_waves:
            caches = _merge_replicate(caches, rows, my(delivered), t, cfg.probe_backend,
                                      node_ids=node_ids)
    lan = n_writes.to(F32) * cfg.row_bytes

    # ---- 3. write-behind enqueue (the replicated single writer) -------------
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

    # ---- 4. reads: replicated plan lanes, sharded probes --------------------
    r_keys = plan.r_keys
    r_keys_l = my(r_keys)

    # 4a. this shard's readers probe themselves.
    caches, hit_local_l, ts_local_l = _self_probe(caches, r_keys_l, my(plan.reading), t)
    need_fog_l = my(plan.reading) & ~hit_local_l
    q_need = all_gather(group, need_fog_l)                             # (n,)

    # 4b. the fog probe: all n queries against this shard's caches.
    sidx_q = set_index(r_keys, cfg.cache_sets)
    hits_qc, way_qc, ts_qc = _probe(caches, r_keys, sidx_q)             # (nl, n)
    resp_dense = _response_mask_dense(cfg, channel, plan, nbr, draws.u_resp)
    if resp_dense is not None:
        hits_qc = hits_qc & resp_dense[:, lo:hi].T     # (reader, responder) -> local responders
    if spec.has_churn:
        hits_qc = hits_qc & my(online)[:, None]       # offline responders are silent
    hits_qc = hits_qc & q_need[None, :]

    # Soft coherence across ranks: the newest ts wins, then the highest
    # responder id at it (payloads are pure in (key, ts), so the direction of
    # that tie-break is unobservable, and the payload psum has one addend).
    # JAX's two-stage election (pmax of ts, then of node ids at it) in one
    # pmax: the max of ts * 2**32 + node id is the newest ts and, at it, the
    # highest node.
    bid = torch.where(hits_qc, (ts_qc.long() << 32) | node_ids[:, None].long(), -1)
    win = pmax(group, bid.amax(dim=0))                                 # (n,) int64
    fog_hit_q = win >= 0
    win_ts = torch.where(fog_hit_q, win >> 32, -1).to(I32)
    win_node = (win & 0xFFFFFFFF).to(I32)
    mine = fog_hit_q & (win_node >= lo) & (win_node < hi)              # the winner is here
    c_win = (win_node - lo).clamp(0, n_local - 1).long()
    q_ids = torch.arange(n, device=dev)
    win_data = caches.data[c_win, sidx_q, way_qc[c_win, q_ids]]
    win_data = psum(group, torch.where(mine[:, None], win_data, 0.0))  # (n, D)

    caches = _touch(caches, hits_qc, way_qc, sidx_q, t)                # responders' LRU
    n_fog_queries = _sum(q_need)

    # 4c. §VI: writer-ring forwarding, then the store (replicated).
    healthy = bs.store_healthy(store_in, t)
    need_store = q_need & ~fog_hit_q
    if spec.mutable:
        queue_hit, store_read, failed, found, served_ts = _resolve_backstop_keyed(
            queue, store_in, healthy, need_store, plan.r_kids)
    else:
        queue_hit, store_read, failed, found, _ = _resolve_backstop(
            queue, store_in, healthy, need_store, plan.r_enq_idx)
    n_store_reads = _sum(store_read)
    n_queue_hits = _sum(queue_hit)
    n_failed = _sum(failed)
    txn = cfg.store.read_txn_bytes(store_in.drained_total)
    wan_rx = n_store_reads.to(F32) * txn
    store = dataclasses.replace(store_in, api_calls=store_in.api_calls + n_store_reads)

    # 4d. fill this shard's readers (one line a node, as in 2).
    fog_hit_l = my(fog_hit_q)
    win_ts_l = my(win_ts)
    fill_ok_l = fog_hit_l | my(queue_hit) | my(found)
    no_origin = torch.full((n_local,), -1, dtype=I32, device=dev)
    clean = torch.zeros((n_local,), dtype=torch.bool, device=dev)
    if spec.mutable:
        served_ts_l = my(served_ts)
        fill_lines = CacheLine(
            key=r_keys_l, data_ts=torch.where(fog_hit_l, win_ts_l, served_ts_l),
            origin=no_origin,
            data=torch.where(fog_hit_l[:, None], my(win_data),
                             wl.versioned_payload(r_keys_l, served_ts_l, cfg.payload_dim)),
            valid=fill_ok_l, dirty=clean,
        )
    else:
        fill_lines = CacheLine(
            key=r_keys_l, data_ts=torch.where(fog_hit_l, win_ts_l, my(plan.r_fill_ts)),
            origin=my(plan.r_src),
            data=torch.where(fog_hit_l[:, None], my(win_data),
                             wl.payload_for(r_keys_l, cfg.payload_dim)),
            valid=fill_ok_l, dirty=clean,
        )
    caches, _ = insert_rows(caches, fill_lines, t, backend=cfg.probe_backend)

    # 4e. staleness of this shard's served reads.
    if spec.mutable:
        served_l = hit_local_l | fog_hit_l | my(queue_hit) | my(found)
        got_ts_l = torch.where(hit_local_l, ts_local_l,
                               torch.where(fog_hit_l, win_ts_l, served_ts_l))
        truth_l = latest_ts[my(plan.r_kids).clamp(0, spec.key_universe - 1).long()]
        n_stale_l = _sum(served_l & (got_ts_l < truth_l))

    # The shard's counts, summed over the group in one psum.
    counts = [_sum(hits_qc), _sum(hit_local_l)]
    if spec.mutable:
        counts += [n_coh_l, n_stale_l]
    n_responses, n_hits_local, *rest = psum(group, torch.stack(counts)).unbind()
    n_coh, n_stale = rest if spec.mutable else (zero, zero)
    lan = lan + n_fog_queries * cfg.query_bytes + (n_responses + n_queue_hits) * cfg.row_bytes

    # ---- 5. writer drain + store commit (replicated) ------------------------
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

    # ---- 6. metrics: the fused engine's expressions -------------------------
    n_reads = _sum(plan.reading)
    n_fog_hits = _sum(fog_hit_q)
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
        wire_bytes=torch.full((), parity_wire_bytes(cfg, group.world), dtype=F32, device=dev),
    )
    new_state = FogShardState(
        caches=caches, queue=queue, store=store, channel=channel,
        tick=state.tick + 1, latest_ts=latest_ts, plan=plan.state_next,
    )
    return new_state, metrics


def _run_distributed_rank(cfg: SimConfig, group: FogGroup, ticks: int, seed: int,
                          metrics_every: int, draws):
    """One rank's tick loop: replayed ``draws`` (``replay.draws_to_arrays``'s
    arrays), or native draws from a generator seeded with ``seed`` (the same
    on every rank)."""
    from repro_torch.core.replay import draws_from_arrays

    state = init_fog_shard(cfg, cfg.n_nodes // group.world, group.device)
    ticks_host = iter(range(ticks))
    if draws is not None:
        draws = draws_from_arrays(cfg, draws, group.device)
    if draws is None:
        gen = torch.Generator(device=group.device)
        gen.manual_seed(seed)

        def source(s: FogShardState, t: int) -> TickDraws:
            return draw_tick(cfg, s.plan, t, gen)
    else:
        replay = iter(draws)

        def source(s: FogShardState, t: int) -> TickDraws:
            d = next(replay)
            if d.t != t:
                raise ValueError(f"draws hold tick {d.t} where tick {t} is due")
            return d

    def step(s):
        return fog_shard_tick(cfg, group, s, source(s, next(ticks_host)))

    return windowed_loop(step, state, ticks, metrics_every)


# --------------------------------------------------------------------------
# The launcher: one process per rank.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EngineRun:
    """One run of a multi-rank engine: ``engine`` is ``"distributed"`` or
    ``"sharded"``; ``draws`` replays injected draws instead of drawing
    natively from ``seed``: for ``"distributed"`` one ``TickDraws`` per
    tick, for ``"sharded"`` one dict per rank of every tick's ``ShardDraws``
    fields stacked as numpy arrays (``sharded.shard_draws_from_arrays``);
    ``profile`` runs it under ``torch.profiler`` on the card to read each
    rank's device time."""

    engine: str
    cfg: SimConfig
    ticks: int
    seed: int = 0
    metrics_every: int = 1
    draws: Optional[list] = None
    profile: bool = False


@dataclasses.dataclass(frozen=True)
class RunResult:
    """What ``run_group`` returns for one ``EngineRun``."""

    state: object                  # FogShardState / ShardedFogState, caches in node order
    series: TickMetrics            # rank 0's (every rank's is checked equal)
    launches: list[dict]           # per rank: kernel launches in the run
    host_s: list[float]            # per rank: the tick loop, ending in a synchronize
    peak_bytes: list[Optional[int]]  # per rank: peak device memory (None on the CPU)
    device_busy_s: list[Optional[float]]  # per rank: its kernels' time (profiled runs)


def _engine(name: str):
    """(per-rank run function, state template, how to merge rank states)."""
    if name == "distributed":
        return _run_distributed_rank, init_fog_shard, _merge_parity_states
    if name == "sharded":
        from repro_torch.core import sharded

        return sharded._run_sharded_rank, sharded.init_sharded_fog, sharded._merge_sharded_states
    raise ValueError(f"unknown multi-rank engine {name!r}: use 'distributed' or 'sharded'")


def _validate(run: EngineRun, world: int) -> None:
    cfg = run.cfg
    if cfg.n_nodes % world != 0:
        raise ValueError(f"n_nodes ({cfg.n_nodes}) must divide over the {world} ranks")
    if run.ticks % run.metrics_every != 0:
        raise ValueError(
            f"{run.engine} metrics thinning aggregates fixed windows: ticks "
            f"({run.ticks}) must be divisible by metrics_every ({run.metrics_every})"
        )
    kernels(cfg.probe_backend)      # reject an unknown backend before any spawn
    wl.validate_run(cfg, run.ticks)
    _engine(run.engine)
    if run.engine == "sharded":
        from repro_torch.core.sharded import validate_sharded

        validate_sharded(cfg)
        if run.draws is not None and len(run.draws) != world:
            raise ValueError(f"{len(run.draws)} per-rank draw series for {world} ranks")
        for arrays in run.draws or ():
            if len(arrays["t"]) != run.ticks:
                raise ValueError(f"{len(arrays['t'])} draws for {run.ticks} ticks")
    elif run.draws is not None and len(run.draws) != run.ticks:
        raise ValueError(f"{len(run.draws)} draws for {run.ticks} ticks")


def _rebuild(template, arrays: dict, device, prefix=""):
    """A dataclass shaped like ``template`` whose leaves are ``arrays[path]``."""
    vals = {}
    for f in dataclasses.fields(template):
        value = getattr(template, f.name)
        path = prefix + f.name
        vals[f.name] = (_rebuild(value, arrays, device, path + ".")
                        if dataclasses.is_dataclass(value)
                        else torch.from_numpy(arrays[path]).to(device))
    return type(template)(**vals)


def _merge_parity_states(ranks: list[dict]) -> dict:
    """Caches concatenated in node order; the replicated rest from rank 0."""
    return {path: np.concatenate([r[path] for r in ranks]) if path.startswith("caches.")
            else a for path, a in ranks[0].items()}


def _rank_main(rank: int, world: int, backend: str, device: Optional[str], port: int,
               runs: list, timeout_s: float, results) -> None:
    """Entry of one spawned rank: join the group, execute every run, put each
    result (numpy) on ``results``; on any exception put its traceback."""
    try:
        torch.set_num_threads(1)
        dev = torch.device(f"cuda:{rank}") if backend == "nccl" else torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        group = FogGroup(rank, world, dist.group.WORLD, dev)
        from repro_torch.kernels import ops

        for i, run in enumerate(runs):
            cfg = run["cfg"]
            draws = run["draws"]
            fn, _, _ = _engine(run["engine"])
            ops.reset_launches()
            profiled = run["profile"] and dev.type == "cuda"
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                  if profiled else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                state, series = fn(cfg, group, run["ticks"], run["seed"],
                                   run["metrics_every"], draws)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                host_s = time.perf_counter() - t0
            busy_s = None
            if profiled:
                busy_s = sum(e.self_device_time_total for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
            results.put(("run", rank, i, dict(
                state={path: t.detach().cpu().numpy() for path, t in _leaves(state)},
                series={f: getattr(series, f).cpu().numpy() for f in field_names()},
                launches=dict(ops.LAUNCHES), host_s=host_s, device_busy_s=busy_s,
                peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            )))
        dist.destroy_process_group()
        results.put(("done", rank, None, None))
    except BaseException:
        results.put(("error", rank, None, traceback.format_exc()))
        raise


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


def run_group(runs: list[EngineRun], *, world: int, backend: str, device=None,
              timeout: float = 1800.0) -> list[RunResult]:
    """Execute ``runs`` in order on one group of ``world`` spawned ranks.

    ``backend="nccl"`` puts rank r on ``cuda:r`` (and raises if the host has
    fewer than ``world`` cards); ``"gloo"`` puts every rank on ``device``
    (the card by default, or ``"cpu"``).  ``timeout`` bounds the whole group
    in seconds: a rank that has not finished by then is killed and the call
    raises, as it does for any rank's exception or non-zero exit.
    """
    from repro_torch.kernels import build

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use 'gloo' or 'nccl'")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if backend == "nccl":
        if world > torch.cuda.device_count():
            raise RuntimeError(
                f"backend='nccl' puts one rank on each card: world={world} needs "
                f"{world} CUDA devices, {torch.cuda.device_count()} are visible "
                f"(several ranks on one card take backend='gloo')")
        out_device = torch.device("cuda")
        rank_device = None              # rank r takes cuda:r
    else:
        out_device = resolve_device(device)
        if out_device.type == "cuda" and out_device.index is None:
            out_device = torch.device("cuda", torch.cuda.current_device())
        rank_device = str(out_device)
    for run in runs:
        _validate(run, world)
    if out_device.type == "cuda" and any(r.cfg.probe_backend == "cuda" for r in runs):
        build.build_all()       # once here: the ranks only load the libraries

    from repro_torch.core.replay import draws_to_arrays

    payload = [dict(engine=r.engine, cfg=r.cfg, ticks=r.ticks, seed=r.seed,
                    metrics_every=r.metrics_every, profile=r.profile,
                    draws=r.draws if r.draws is None or r.engine == "sharded"
                    else draws_to_arrays(r.draws))
               for r in runs]
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(rank, world, backend, rank_device, port, payload,
                               timeout, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    done: set = set()
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the {world} ranks did not finish in {timeout} s")
            try:
                kind, rank, i, body = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks exited without a result: {dead}")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {rank} of {world} failed:\n{body}")
            if kind == "run":
                got[rank, i] = body
            else:
                done.add(rank)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with (rank, code) {bad}")
    finally:
        _stop(procs)

    out = []
    for i, run in enumerate(runs):
        bodies = [got[rank, i] for rank in range(world)]
        s0 = bodies[0]["series"]
        for rank, b in enumerate(bodies[1:], 1):
            for f in field_names():
                if not np.array_equal(b["series"][f], s0[f]):
                    raise AssertionError(f"{run.engine}: rank {rank}'s {f} differs from rank 0's")
        _, init, merge = _engine(run.engine)
        template = init(run.cfg, 1, torch.device("cpu"))
        out.append(RunResult(
            state=_rebuild(template, merge([b["state"] for b in bodies]), out_device),
            series=TickMetrics(**{f: torch.from_numpy(s0[f]).to(out_device)
                                  for f in field_names()}),
            launches=[b["launches"] for b in bodies],
            host_s=[b["host_s"] for b in bodies],
            peak_bytes=[b["peak_bytes"] for b in bodies],
            device_busy_s=[b["device_busy_s"] for b in bodies],
        ))
    return out


def run_distributed_sim(cfg: SimConfig, ticks: int, *, world: int, backend: str,
                        seed: int = 0, device=None, metrics_every: int = 1,
                        draws: Optional[list] = None,
                        timeout: float = 1800.0) -> tuple[FogShardState, TickMetrics]:
    """Run the distributed fog for ``ticks`` over ``world`` ranks.

    ``cfg.n_nodes`` must divide over the ranks.  Returns (final state with
    the caches gathered in node order, rank 0's ``TickMetrics`` series);
    the series equals the fused engine's on the same draws bit for bit,
    ``wire_bytes`` aside.  ``metrics_every`` thins it as the fused engine
    does (``metrics.windowed_loop``); the collectives still run every tick,
    because the float metrics are per-tick expressions of the reduced counts.
    """
    res = run_group([EngineRun("distributed", cfg, ticks, seed, metrics_every, draws)],
                    world=world, backend=backend, device=device, timeout=timeout)[0]
    return res.state, res.series
