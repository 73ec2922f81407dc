"""The fused N-node fog simulation (port of ``repro.core.simulator``).

``sim_tick`` executes one tick of the fused engine (DESIGN.md §3): one
batched probe serves the local check, the fog query and the LRU touch; the
own-row writes and the read fills are batched upserts; mutable workloads
run the coherence sweep and keyed durability.  ``run_sim`` loops it.

Every random number a tick consumes arrives in its ``TickDraws``: the
request plan and the uniforms of the loss channel and the store.  They come
from the native planner (``draw_tick``, a ``torch.Generator``) or from
JAX, replayed bit for bit (``tests/torch_parity.py``, ``core/replay.py``),
which is how the port is held to JAX's ``TickMetrics`` series bitwise.

No host synchronisation happens inside ``sim_tick``: the tick is a host
``int`` in the loop (and an int32 tensor in the state), every branch is on
static configuration, and every count stays on the device.

With ``probe_backend="cuda"`` on CUDA tensors the kernels update the cache
tables of the state passed in IN PLACE (the port's counterpart of JAX's
buffer donation); ``run_sim`` never reuses a state it has stepped.

Under ``insert_policy="replicate"`` every hearer upserts every broadcast
row (``_merge_replicate``): R batched upserts a write wave, so R
``flic_insert`` launches on the card.  ``run_any_engine`` also runs the
reference engine (``core/simulator_ref.py``) and the two multi-rank engines
(``core/distributed.py``, ``core/sharded.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Literal, Optional

import numpy as np
import torch

from repro_torch.core import backing_store as bs
from repro_torch.core import workload as wl
from repro_torch.core import writeback as wb
from repro_torch.core.cache_state import CacheLine, CacheState, empty_cache, set_index
from repro_torch.core.coherence import (
    GilbertElliott,
    bernoulli_loss_mask,
    gilbert_elliott_advance,
    gilbert_elliott_mask,
)
from repro_torch.core.flic import (
    insert,
    insert_rows,
    invalidate_nodes,
    kernels,
    update_rows,
    vmap_nodes,
)
from repro_torch.core.metrics import TickMetrics, windowed_loop
from repro_torch.core.tracing import span
from repro_torch.kernels import ops
from repro_torch.kernels.ref import max_drop, set_drop

I32, F32 = torch.int32, torch.float32


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration of one fog simulation (the JAX field names)."""

    n_nodes: int = 50
    cache_lines: int = 200
    cache_ways: int = 4
    payload_dim: int = 8
    row_bytes: int = 148
    query_bytes: int = 32
    read_period: int = 15
    read_window_keys: int = 2000
    loss_model: Literal["none", "bernoulli", "gilbert_elliott"] = "bernoulli"
    loss_prob: float = 0.02
    insert_policy: Literal["directory", "replicate"] = "directory"
    queue_capacity: int = 8192
    writer_max_per_tick: int = 64
    store: bs.StoreProfile = dataclasses.field(default_factory=bs.StoreProfile)
    outage_schedule: tuple[tuple[int, int], ...] = ()
    # None/"fused": inline torch; "plain" (or "xla"): kernels/ref.py;
    # "cuda": the hand-written kernels (kernels/ops.py).
    probe_backend: Optional[str] = None
    workload: wl.WorkloadSpec = dataclasses.field(default_factory=wl.WorkloadSpec)
    lat_local: float = 1e-4
    lat_lan_base: float = 2e-3
    lat_lan_per_node: float = 1.2e-4
    lat_store: float = 1.1
    seed: int = 0

    @property
    def cache_sets(self) -> int:
        if self.cache_lines % self.cache_ways != 0:
            raise ValueError("cache_lines must be a multiple of cache_ways")
        return self.cache_lines // self.cache_ways

    @property
    def window_ticks(self) -> int:
        return max(1, round(self.read_window_keys / self.n_nodes))

    @property
    def readers_per_tick(self) -> int:
        if self.workload.popularity == "trace":
            return self.n_nodes
        return -(-self.n_nodes // self.read_period)


@dataclasses.dataclass(frozen=True)
class SimState:
    caches: CacheState          # batched (N, S, W, ...)
    queue: wb.WriteQueue
    store: bs.StoreState
    channel: GilbertElliott
    tick: torch.Tensor          # int32
    latest_ts: torch.Tensor     # (K,) int32 newest write tick per key id
    plan: wl.PlanState


@dataclasses.dataclass(frozen=True)
class TickDraws:
    """Everything random one tick consumes.

    ``u_*`` are float32 uniforms in [0, 1), present only where JAX draws
    them: the Gilbert-Elliott advance (``u_ge_up``/``u_ge_dn`` (N,)), the
    write-delivery mask when a sweep consumes it and loss is on
    (``u_deliver`` (N, N), or (N, K) under fan-out), the response mask when
    loss is on (``u_resp`` (R, N) or (R, K)), and the store collision when
    ``collision_prob > 0`` (``u_coll`` ()).
    """

    t: int
    plan: wl.RequestPlan
    u_ge_up: Optional[torch.Tensor] = None
    u_ge_dn: Optional[torch.Tensor] = None
    u_deliver: Optional[torch.Tensor] = None
    u_resp: Optional[torch.Tensor] = None
    u_coll: Optional[torch.Tensor] = None


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one, ask the caller to choose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: pass device='cpu' to run the port "
                "on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def init_sim(cfg: SimConfig, device=None) -> SimState:
    device = resolve_device(device)
    ku = cfg.workload.key_universe if cfg.workload.mutable else 0
    return SimState(
        caches=empty_cache(cfg.cache_sets, cfg.cache_ways, cfg.payload_dim,
                           batch=(cfg.n_nodes,), device=device),
        queue=wb.empty_queue(cfg.queue_capacity, key_universe=ku, device=device),
        store=bs.init_store(key_universe=ku, device=device),
        channel=GilbertElliott.init(cfg.n_nodes, device=device),
        tick=torch.zeros((), dtype=I32, device=device),
        latest_ts=torch.full((ku,), -1, dtype=I32, device=device),
        plan=wl.init_plan_state(cfg, device=device),
    )


# --------------------------------------------------------------------------
# The channel: which uniforms a tick draws, and the masks they make.
# --------------------------------------------------------------------------

def needs_delivery_mask(cfg: SimConfig) -> bool:
    """The mutable sweep (or a replicate merge) consumes the delivery mask;
    the write-once directory path never does, so it is not drawn."""
    return cfg.insert_policy != "directory" or cfg.workload.mutable


def draw_shapes(cfg: SimConfig) -> dict[str, tuple[int, ...]]:
    """Name -> shape of each uniform a tick of ``cfg`` consumes."""
    n, k = cfg.n_nodes, cfg.workload.fanout
    cols = n if k is None else k
    shapes = {}
    if cfg.loss_model == "gilbert_elliott":
        shapes["u_ge_up"] = (n,)
        shapes["u_ge_dn"] = (n,)
    if cfg.loss_model != "none":
        if needs_delivery_mask(cfg):
            shapes["u_deliver"] = (n, cols)
        shapes["u_resp"] = (cfg.readers_per_tick, cols)
    if cfg.store.collision_prob > 0.0:
        shapes["u_coll"] = ()
    return shapes


def draw_tick(cfg: SimConfig, plan_state: wl.PlanState, t: int,
              gen: torch.Generator) -> TickDraws:
    """The native source of a tick's draws: plan, then channel uniforms."""
    plan = wl.plan_tick(cfg, plan_state, t, gen)
    uniforms = {
        name: torch.rand(shape, generator=gen, device=gen.device)
        for name, shape in draw_shapes(cfg).items()
    }
    return TickDraws(t=t, plan=plan, **uniforms)


def _loss_mask(cfg: SimConfig, channel, u, shape, device, receivers=None):
    if cfg.loss_model == "none":
        return torch.ones(shape, dtype=torch.bool, device=device)
    if cfg.loss_model == "bernoulli":
        return bernoulli_loss_mask(u, cfg.loss_prob)
    return gilbert_elliott_mask(channel, u, receivers=receivers)


def _expand_lanes_dense(lanes: torch.Tensor, nbr: torch.Tensor, n: int) -> torch.Tensor:
    """(N, K) neighbour-lane values -> dense (N, n); non-neighbours False."""
    base = torch.zeros((lanes.shape[0], n), dtype=lanes.dtype, device=lanes.device)
    return base.scatter_(1, nbr, lanes)


def _delivery_mask_dense(cfg: SimConfig, channel, u, nbr, device):
    n = cfg.n_nodes
    if nbr is None:
        return _loss_mask(cfg, channel, u, (n, n), device)
    lanes = _loss_mask(cfg, channel, u, (n, cfg.workload.fanout), device)
    return _expand_lanes_dense(lanes, nbr, n)


def _response_mask_compact(cfg: SimConfig, channel, u, slot_nid):
    if cfg.loss_model == "none":
        return None
    return _loss_mask(cfg, channel, u, u.shape, u.device, receivers=slot_nid)


def _neighbor_index(cfg: SimConfig, device) -> torch.Tensor | None:
    """The static (N, K) ring neighbour table, or None when gossip is dense."""
    if cfg.workload.fanout is None:
        return None
    return wl.neighbor_table(cfg.n_nodes, cfg.workload.fanout, device)


def _response_mask_dense(cfg: SimConfig, channel, plan: wl.RequestPlan, nbr,
                         u_resp) -> torch.Tensor | None:
    """Dense (n, n) [reader, responder] response mask for the per-pass
    engine: the compact draw scattered to the readers' rows (dead slots
    dropped), non-neighbour responders False under fan-out.  None: apply
    no mask (dense gossip, loss off)."""
    n = cfg.n_nodes
    compact = _response_mask_compact(cfg, channel, u_resp, plan.slot_nid.long())
    if nbr is None:
        if compact is None:
            return None
        rows = compact
    else:
        lanes = compact
        if lanes is None:
            lanes = torch.ones((plan.slot_nid.shape[0], cfg.workload.fanout),
                               dtype=torch.bool, device=plan.slot_nid.device)
        rows = _expand_lanes_dense(lanes, nbr[plan.slot_nid.long()], n)
    return set_drop(torch.zeros((n, n), dtype=torch.bool, device=rows.device),
                    plan.slot_id, rows)


# --------------------------------------------------------------------------
# Writer-ring forwarding and the store (§VI).
# --------------------------------------------------------------------------

def _resolve_backstop(queue: wb.WriteQueue, store: bs.StoreState, healthy,
                      need_store, enq_idx):
    """Route fog-missed reads (FIFO index durability): returns (queue_hit,
    store_read, failed, found, in_store).  One ``ops.ring_backstop``."""
    return ops.ring_backstop(queue.head, queue.tail, queue.capacity, healthy,
                             store.drained_total, need_store, enq_idx)


def _resolve_backstop_keyed(queue: wb.WriteQueue, store: bs.StoreState, healthy,
                            need_store, key_ids):
    """Keyed-durability routing: returns (queue_hit, store_read, failed,
    found, served_ts), ``served_ts`` the version served (-1: none).  One
    ``ops.ring_backstop_keyed``."""
    return ops.ring_backstop_keyed(queue.head, queue.tail, queue.slot_of_key, queue.data_ts,
                                   healthy, store.table_ts, need_store, key_ids)


# --------------------------------------------------------------------------
# Broadcast merge under the two insert policies.
# --------------------------------------------------------------------------

def _insert_own_rows(caches: CacheState, rows: CacheLine, now) -> CacheState:
    """Each node upserts its own row: the scalar ``insert`` over the node
    axis (the reference engine's form; the fused engine uses
    ``insert_rows``)."""
    return vmap_nodes(lambda cache, line: insert(cache, line, now)[0])(caches, rows)


def _merge_replicate(caches: CacheState, rows: CacheLine, delivered: torch.Tensor,
                     now, backend: str | None = None,
                     node_ids: torch.Tensor | None = None) -> CacheState:
    """The replicate policy's gossip round as R batched upserts.

    ``coherence.merge_broadcasts`` upserts the R rows at each node in order
    r = 0..R-1, and node i's r-th upsert reads only node i's cache; so R
    calls of ``insert_rows`` compute the same caches.  Call r gives node i
    row r, live where it was delivered or node i is its origin, dirty only
    at its origin.  ``node_ids`` is the global id of each cache lane (a
    shard of the distributed engine passes its own; default ``arange(N)``).
    The evictions are dropped, as JAX's engine drops them.
    """
    n = caches.tags.shape[0]
    r = rows.key.shape[0]
    dev = rows.key.device
    if node_ids is None:
        node_ids = torch.arange(n, dtype=I32, device=dev)
    own = rows.origin[:, None] == node_ids.to(I32)[None, :]                       # (R, N)
    valid = rows.valid[:, None] & (delivered.T | own)
    dirty = rows.dirty[:, None] & own

    def per_row(x):            # (R, ...) -> (R, N, ...), each row one call's lanes
        return x[:, None].expand(r, n, *x.shape[1:]).contiguous()

    sidx = set_index(rows.key, caches.num_sets).to(I32)
    keys, ts, origin, data, sidx = (per_row(x) for x in (rows.key, rows.data_ts, rows.origin,
                                                         rows.data, sidx))
    # One copy of the tables a wave, then R upserts into it in place.
    caches = CacheState(*(getattr(caches, f.name).clone()
                          for f in dataclasses.fields(CacheState)))
    for i in range(r):
        caches, _ = insert_rows(
            caches, CacheLine(key=keys[i], data_ts=ts[i], origin=origin[i], data=data[i],
                              valid=valid[i], dirty=dirty[i]),
            now, backend=backend, sidx=sidx[i], inplace=True)
    return caches


# --------------------------------------------------------------------------
# The fused fog probe.
# --------------------------------------------------------------------------

def _probe_all_caches(cfg: SimConfig, caches: CacheState, keys_q, sidx_q):
    """Probe R queries against every cache: (hit (C,R), way (C,R), ts (C,R),
    payload(best_c, slot) -> (R, D))."""
    fns = kernels(cfg.probe_backend)
    if fns is None:
        tags_cq = caches.tags[:, sidx_q]                         # (C, R, W)
        match = caches.valid[:, sidx_q] & (tags_cq == keys_q[None, :, None])
        hit = match.any(dim=-1)
        way = match.to(I32).argmax(dim=-1)                       # first way
        ts_cq = caches.data_ts[:, sidx_q].gather(-1, way[..., None])[..., 0]
        ts = torch.where(hit, ts_cq, -1)

        def payload(best_c, slot):
            return caches.data[best_c, sidx_q, way[best_c, slot]]

        return hit, way.to(I32), ts, payload

    # The kernels take Q as it is: no padding to a block.
    hit, ts, pay, way = fns[2](
        caches.tags, caches.data_ts, caches.valid, caches.data,
        keys_q.to(I32).contiguous(), sidx_q.to(I32).contiguous(),
    )

    def payload(best_c, slot):
        return pay[best_c, slot]

    return hit, way, ts, payload


def _sum(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=I32)


def _fma32(x: torch.Tensor, y: float, z: torch.Tensor) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once, like a fused multiply-add.  The
    product of two float32 values is exact in float64, so only the sum
    rounds; for the small counts of a tick that float64 sum is exact too."""
    return (x.to(torch.float64) * float(np.float32(y)) + z.to(torch.float64)).to(F32)


# --------------------------------------------------------------------------
# One tick.
# --------------------------------------------------------------------------

def sim_tick(cfg: SimConfig, state: SimState, draws: TickDraws) -> tuple[SimState, TickMetrics]:
    """One tick of the fused engine on the draws of tick ``draws.t``.

    Each numbered stage runs inside a ``tick.*`` span (``core/tracing.py``),
    and each call into the writer ring inside a ``ring.*`` span of its stage."""
    n = cfg.n_nodes
    spec = cfg.workload
    t = draws.t
    plan = draws.plan
    dev = state.tick.device
    caches = state.caches
    latest_ts = state.latest_ts

    # ---- 0. outage schedule; churn: rejoining nodes cold-start -------------
    with span("tick.start"):
        store_in = state.store
        if cfg.outage_schedule:
            store_in = bs.apply_outage_schedule(store_in, t, cfg.outage_schedule)
        online = plan.online
        if spec.has_churn:
            caches = invalidate_nodes(caches, plan.rejoin)
            n_rejoin = _sum(plan.rejoin)
        else:
            n_rejoin = torch.zeros((), dtype=I32, device=dev)

    # ---- 1. the plan's write waves -----------------------------------------
    with span("tick.write_rows"):
        rows_waves = [wl.plan_write_rows(cfg, plan, p, t) for p in range(spec.plan_waves)]
        n_writes = _sum(plan.w_valid)

    # ---- 2. fog broadcast under the loss model -----------------------------
    with span("tick.delivery"):
        nbr = _neighbor_index(cfg, dev)
        channel = state.channel
        if cfg.loss_model == "gilbert_elliott":
            channel = gilbert_elliott_advance(channel, draws.u_ge_up, draws.u_ge_dn)
        delivered = None
        if needs_delivery_mask(cfg):
            delivered = _delivery_mask_dense(cfg, channel, draws.u_deliver, nbr, dev)
            if spec.has_churn:
                delivered = delivered & online[:, None]
    with span("tick.writes"):
        n_coh = torch.zeros((), dtype=I32, device=dev)
        for rows in rows_waves:
            if cfg.insert_policy != "directory":
                caches = _merge_replicate(caches, rows, delivered, t, cfg.probe_backend)
                continue
            caches, _ = insert_rows(caches, rows, t, backend=cfg.probe_backend)
            if spec.mutable:
                caches, n_coh_p = update_rows(caches, rows, delivered, t,
                                              backend=cfg.probe_backend)
                n_coh = n_coh + n_coh_p
        lan = n_writes.to(F32) * cfg.row_bytes

    # ---- 3. write-behind enqueue -------------------------------------------
    with span("tick.enqueue"):
        queue = state.queue
        if spec.mutable:
            for p, rows in enumerate(rows_waves):
                with span("ring.enqueue"):
                    queue, _ = wb.enqueue_keyed(queue, plan.w_kids[p], rows.data_ts,
                                                rows.origin, plan.w_valid[p])
                latest_ts = max_drop(
                    latest_ts, torch.where(plan.w_valid[p], plan.w_kids[p], spec.key_universe),
                    rows.data_ts,
                )
        else:
            rows = rows_waves[0]
            with span("ring.enqueue"):
                queue, _ = wb.enqueue(queue, rows.key, rows.data_ts, rows.origin,
                                      plan.w_valid[0])

    # ---- 4. reads ------------------------------------------------------------
    with span("tick.probe"):
        r_keys = plan.r_keys
        r_slots = plan.slot_ok.shape[0]
        r_ids = plan.slot_id
        slot_ok = plan.slot_ok
        r_gidx = plan.slot_nid.long()
        keys_q = r_keys[r_gidx]
        sidx_q = set_index(keys_q, cfg.cache_sets)
        slots = torch.arange(r_slots, device=dev)
        w_ids = torch.arange(cfg.cache_ways, dtype=I32, device=dev)

        if nbr is None:
            # Dense: ONE probe of the R queries against all C caches serves the
            # local check, the fog query and the LRU touch.
            hit_cq, way_cq, ts_cq, payload_of = _probe_all_caches(cfg, caches, keys_q, sidx_q)
            hit_local_slot = hit_cq[r_gidx, slots] & slot_ok
            need_fog_slot = slot_ok & ~hit_local_slot
            ts_local_slot = ts_cq[r_gidx, slots]

            hit_fog_cq = hit_cq
            resp_rq = _response_mask_compact(cfg, channel, draws.u_resp, r_gidx)
            if resp_rq is not None:
                hit_fog_cq = hit_fog_cq & resp_rq.T
            if spec.has_churn:
                hit_fog_cq = hit_fog_cq & online[:, None]
            hit_fog_cq = hit_fog_cq & need_fog_slot[None, :]
            ts_fog = torch.where(hit_fog_cq, ts_cq, -1)

            best_c = ts_fog.argmax(dim=0)                              # lowest node id on ties
            fog_hit_slot = hit_fog_cq.any(dim=0)
            best_ts_slot = torch.where(fog_hit_slot, ts_fog[best_c, slots], -1)
            best_payload_slot = payload_of(best_c, slots)

            # LRU refresh in one scatter-max along the shared query set indices.
            touch_cq = hit_fog_cq.index_put(
                (r_gidx, slots), hit_fog_cq[r_gidx, slots] | hit_local_slot
            )
            touch_w = touch_cq[:, :, None] & (w_ids[None, None, :] == way_cq[:, :, None])
            c = caches.tags.shape[0]
            caches = dataclasses.replace(
                caches,
                last_use=caches.last_use.scatter_reduce(
                    1, sidx_q[None, :, None].expand(c, r_slots, cfg.cache_ways),
                    torch.where(touch_w, t, -1).to(I32), "amax",
                ),
            )
            n_responses = _sum(hit_fog_cq)
        else:
            # Fan-out: the reader probes itself (lane 0) and its K ring
            # neighbours; ties break by lane.
            cols = torch.cat([r_gidx[:, None], nbr[r_gidx]], dim=1)    # (R, K+1)
            line_sets = sidx_q[:, None]
            match_l = caches.valid[cols, line_sets] & (
                caches.tags[cols, line_sets] == keys_q[:, None, None]
            )
            hit_l = match_l.any(dim=-1)
            way_l = match_l.to(I32).argmax(dim=-1)
            ts_raw_l = caches.data_ts[cols, line_sets].gather(-1, way_l[..., None])[..., 0]

            hit_local_slot = hit_l[:, 0] & slot_ok
            need_fog_slot = slot_ok & ~hit_local_slot
            ts_local_slot = torch.where(hit_l[:, 0], ts_raw_l[:, 0], -1)

            hit_fog_l = hit_l[:, 1:]
            resp_l = _response_mask_compact(cfg, channel, draws.u_resp, r_gidx)
            if resp_l is not None:
                hit_fog_l = hit_fog_l & resp_l
            if spec.has_churn:
                hit_fog_l = hit_fog_l & online[cols[:, 1:]]
            hit_fog_l = hit_fog_l & need_fog_slot[:, None]
            ts_fog_l = torch.where(hit_fog_l, ts_raw_l[:, 1:], -1)

            best_lane = ts_fog_l.argmax(dim=1)
            fog_hit_slot = hit_fog_l.any(dim=1)
            best_ts_slot = torch.where(fog_hit_slot, ts_fog_l[slots, best_lane], -1)
            best_payload_slot = caches.data[
                cols[slots, 1 + best_lane], sidx_q, way_l[slots, 1 + best_lane]
            ]

            # LRU refresh: flat scatter-max over the touched lines; untouched
            # lanes carry INT32_MIN, a no-op under max (JAX drops them).
            touch_l = torch.cat([hit_local_slot[:, None], hit_fog_l], dim=1)
            flat = (cols * cfg.cache_sets + sidx_q[:, None]) * cfg.cache_ways + way_l
            src = torch.where(touch_l, t, torch.iinfo(I32).min).to(I32)
            caches = dataclasses.replace(
                caches,
                last_use=caches.last_use.reshape(-1)
                .scatter_reduce(0, flat.reshape(-1), src.reshape(-1), "amax")
                .reshape(caches.last_use.shape),
            )
            n_responses = _sum(hit_fog_l)

        n_fog_queries = _sum(need_fog_slot)

    # 4c. writer-buffer forwarding, then the backing store (§VI).
    with span("tick.backstop"):
        healthy = bs.store_healthy(store_in, t)
        need_store_slot = need_fog_slot & ~fog_hit_slot
        with span("ring.backstop"):
            if spec.mutable:
                kids_q = plan.r_kids[r_gidx]
                (queue_hit_slot, store_read_slot, failed_slot, found_slot,
                 served_ts_slot) = _resolve_backstop_keyed(queue, store_in, healthy,
                                                           need_store_slot, kids_q)
            else:
                queue_hit_slot, store_read_slot, failed_slot, found_slot, _ = _resolve_backstop(
                    queue, store_in, healthy, need_store_slot, plan.r_enq_idx[r_gidx]
                )
        n_store_reads = _sum(store_read_slot)
        n_queue_hits = _sum(queue_hit_slot)
        n_failed = _sum(failed_slot)
        lan = lan + n_fog_queries * cfg.query_bytes + (n_responses + n_queue_hits) * cfg.row_bytes
        txn = cfg.store.read_txn_bytes(store_in.drained_total)
        wan_rx = n_store_reads.to(F32) * txn
        store = dataclasses.replace(store_in, api_calls=store_in.api_calls + n_store_reads)

    # 4d. fill the reader's local cache from fog/queue/store responses.
    with span("tick.fill"):
        fill_ok_slot = fog_hit_slot | queue_hit_slot | found_slot
        if spec.mutable:
            slot_payload = torch.where(
                fog_hit_slot[:, None], best_payload_slot,
                wl.versioned_payload(keys_q, served_ts_slot, cfg.payload_dim),
            )
            fill_ts = set_drop(
                torch.full((n,), -1, dtype=I32, device=dev), r_ids,
                torch.where(fog_hit_slot, best_ts_slot, served_ts_slot),
            )
            fill_origin = torch.full((n,), -1, dtype=I32, device=dev)
        else:
            slot_payload = torch.where(
                fog_hit_slot[:, None], best_payload_slot,
                wl.payload_for(keys_q, cfg.payload_dim),
            )
            fill_ts = set_drop(
                plan.r_fill_ts, r_ids,
                torch.where(fog_hit_slot, best_ts_slot, plan.r_fill_ts[r_gidx]),
            )
            fill_origin = plan.r_src
        fill_lines = CacheLine(
            key=r_keys,
            data_ts=fill_ts,
            origin=fill_origin,
            data=set_drop(torch.zeros((n, cfg.payload_dim), dtype=F32, device=dev),
                          r_ids, slot_payload),
            valid=set_drop(torch.zeros((n,), dtype=torch.bool, device=dev), r_ids,
                           fill_ok_slot),
            dirty=torch.zeros((n,), dtype=torch.bool, device=dev),
        )
        caches, _ = insert_rows(caches, fill_lines, t, backend=cfg.probe_backend)

    # 4e. staleness: served reads older than the key's newest write.
    with span("tick.stale"):
        if spec.mutable:
            served_slot = hit_local_slot | fog_hit_slot | queue_hit_slot | found_slot
            got_ts_slot = torch.where(
                hit_local_slot, ts_local_slot,
                torch.where(fog_hit_slot, best_ts_slot, served_ts_slot),
            )
            truth_slot = latest_ts[kids_q.clamp(0, spec.key_universe - 1).long()]
            n_stale = _sum(served_slot & (got_ts_slot < truth_slot))
        else:
            n_stale = torch.zeros((), dtype=I32, device=dev)

    # ---- 5. writer drain + store commit ------------------------------------
    with span("tick.drain"):
        with span("ring.drain"):
            queue, n_drained, n_calls = wb.drain(
                queue, t, healthy,
                rate_per_tick=cfg.store.api_rate_per_tick,
                burst=cfg.store.api_burst,
                max_per_tick=cfg.writer_max_per_tick,
            )
        store = bs.commit_writes(store, n_drained, n_calls, draws.u_coll, cfg.store)
        if spec.mutable:
            with span("ring.drain"):
                d_kids, d_ts, d_live = wb.drained_entries(queue, n_drained,
                                                          cfg.writer_max_per_tick)
            store = bs.commit_keyed_rows(store, d_kids, d_ts, d_live)
        wan_tx = cfg.store.write_txn_bytes(n_drained)

    # ---- 6. latency model + baseline accounting ----------------------------
    with span("tick.metrics"):
        n_reads = _sum(plan.reading)
        n_hits_local = _sum(hit_local_slot)
        n_fog_hits = _sum(fog_hit_slot)
        # JAX writes a*lat_local + b*lat_lan + c*lat_store; XLA on the CPU
        # compiles it as fma(c, lat_store, fma(a, lat_local, b*lat_lan)).
        lat_lan = (n_fog_hits + n_queue_hits).to(F32) * (cfg.lat_lan_base
                                                         + cfg.lat_lan_per_node * n)
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
            store_found=_sum(found_slot),
            store_missing=_sum(store_read_slot & ~found_slot),
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


# --------------------------------------------------------------------------
# The tick loop.
# --------------------------------------------------------------------------

def _tick_fn(engine: str):
    if engine == "reference":
        from repro_torch.core.simulator_ref import sim_tick_ref

        return sim_tick_ref
    if engine != "fused":
        raise ValueError(f"unknown engine {engine!r}; use 'fused' or 'reference'")
    return sim_tick


def run_sim(cfg: SimConfig, ticks: int, seed: int = 0, *, device=None,
            metrics_every: int = 1, draws: Optional[Iterable[TickDraws]] = None,
            state: Optional[SimState] = None,
            engine: str = "fused") -> tuple[SimState, TickMetrics]:
    """Run ``ticks`` ticks; returns (final_state, metric series).

    ``device`` defaults to the card; ``device="cpu"`` runs on the CPU.
    ``draws`` replays one ``TickDraws`` per tick (their tensors must be on
    ``device``); without it the native planner draws from a generator
    seeded with ``seed``.  ``state`` continues a run (for example one carried
    over from JAX by ``state_from_numpy``); the default is ``init_sim``.
    ``metrics_every`` emits one aggregated row per that many ticks.
    ``engine``: ``"fused"`` (``sim_tick``) or ``"reference"`` (the per-pass
    ``simulator_ref.sim_tick_ref``); both execute the same draws.
    """
    device = resolve_device(device)
    tick_fn = _tick_fn(engine)
    kernels(cfg.probe_backend)  # reject an unknown backend before any work
    wl.validate_run(cfg, ticks)
    if state is None:
        state = init_sim(cfg, device)
    first = int(state.tick)     # the one host read, before the loop
    ticks_host = iter(range(first, first + ticks))
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def source(s: SimState, t: int) -> TickDraws:
            return draw_tick(cfg, s.plan, t, gen)
    else:
        replay = iter(draws)

        def source(s: SimState, t: int) -> TickDraws:
            d = next(replay, None)
            if d is None:
                raise ValueError(f"draws ran out at tick {t}")
            if d.t != t:
                raise ValueError(f"draws hold tick {d.t} where tick {t} is due")
            return d

    def step(s: SimState):
        d = source(s, next(ticks_host))
        with span("sim.tick"):
            return tick_fn(cfg, s, d)

    return windowed_loop(step, state, ticks, metrics_every)


def run_any_engine(cfg: SimConfig, ticks: int, seed: int = 0, *, engine: str = "fused",
                   metrics_every: int = 1, draws: Optional[Iterable[TickDraws]] = None,
                   device=None, world: Optional[int] = None,
                   backend: Optional[str] = None):
    """Engine-agnostic runner of the conformance contract (DESIGN.md §8).

    ``"fused"`` and ``"reference"`` run here through ``run_sim``;
    ``"distributed"`` (bitwise, ``core/distributed.py``) and ``"sharded"``
    (tolerance tier, ``core/sharded.py``) run over ``world`` spawned ranks
    on ``backend`` ("gloo" or "nccl"), both of which they require.  Every
    engine returns (final state, ``TickMetrics`` series), and on every
    engine ``ticks`` must be a multiple of ``metrics_every``.
    """
    if metrics_every != 1 and ticks % metrics_every != 0:
        raise ValueError(
            f"metrics thinning aggregates fixed windows on every engine "
            f"(including distributed): ticks ({ticks}) must be divisible by "
            f"metrics_every ({metrics_every})"
        )
    if engine in ("distributed", "sharded"):
        if world is None or backend is None:
            raise ValueError(f"engine={engine!r} needs world= and backend= ('gloo' or 'nccl')")
        from repro_torch.core.distributed import EngineRun, run_group

        res = run_group([EngineRun(engine, cfg, ticks, seed, metrics_every,
                                   None if draws is None else list(draws))],
                        world=world, backend=backend, device=device)[0]
        return res.state, res.series
    return run_sim(cfg, ticks, seed, device=device, metrics_every=metrics_every,
                   draws=draws, engine=engine)


# --------------------------------------------------------------------------
# State carried across frameworks: flat numpy dicts keyed by field path.
# --------------------------------------------------------------------------

# Fields the JAX package stores as uint32; the port keeps their bit pattern.
U32_PATHS = ("caches.tags", "queue.keys")


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        path = prefix + f.name
        if dataclasses.is_dataclass(value):
            yield from _leaves(value, path + ".")
        else:
            yield path, value


def state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    """``{"caches.tags": ..., "queue.head": ..., ...}`` with the JAX dtypes."""
    out = {}
    for path, t in _leaves(state):
        a = t.detach().cpu().numpy()
        out[path] = a.view(np.uint32) if path in U32_PATHS else a
    return out


def state_from_numpy(arrays: dict[str, np.ndarray], cfg: SimConfig, device=None) -> SimState:
    """The port's ``SimState`` from a JAX ``SimState`` flattened by field
    path (extra paths such as JAX's ``rng`` are ignored)."""
    device = resolve_device(device)
    template = init_sim(cfg, device=torch.device("cpu"))

    def build(obj, prefix=""):
        vals = {}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            path = prefix + f.name
            if dataclasses.is_dataclass(value):
                vals[f.name] = build(value, path + ".")
                continue
            a = np.asarray(arrays[path])
            if path in U32_PATHS:
                a = a.view(np.int32)
            if a.shape != tuple(value.shape):
                raise ValueError(f"{path}: shape {a.shape}, config expects {tuple(value.shape)}")
            vals[f.name] = torch.from_numpy(np.array(a)).to(device=device,
                                                                        dtype=value.dtype)
        return type(obj)(**vals)

    return build(template)
