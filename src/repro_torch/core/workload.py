"""Scenario-driven workload layer (port of ``repro.core.workload``).

The scenario dataclasses (``TraceSpec``, ``WorkloadSpec``, ``SCENARIOS``)
are copies with the same field names and validation.  The deterministic
parts (payload derivation, key hashing, the ring neighbour table, the rate,
membership and rejoin masks, ``plan_write_rows``) are ported verbatim.

The plan stage: ``RequestPlan`` holds one tick's requests as fixed-shape
tensors, exactly the JAX plan minus its PRNG keys.  An engine executes a
plan; it never generates one.  Plans come from two sources:

* the native ``plan_tick`` here, which draws from a ``torch.Generator``.
  It samples the same distributions as JAX, not the same numbers; a trace
  plan draws nothing, so its fields are JAX's bit for bit;
* JAX's own ``plan_tick``, replayed through ``simulator.TickDraws``.

The trace generators (``materialize_trace``) are host numpy, seeded as
JAX's, so a ``(T, N)`` trace is the same array in both packages.  So is
the sharded engine's consistent-hash ring (``hash_ring``,
``ring_candidates``: host numpy), and ``route_keys`` homes key ids on it
with JAX's bits.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Literal, Optional

import numpy as np
import torch

from repro_torch.core.cache_state import CacheLine
from repro_torch.core.tracing import span
from repro_torch.kernels import ops
from repro_torch.utils.hashing import hash2_u32

KEY_SALT = 0x5A1FCA5E
WRITE_SALT = 0x57A9
POISSON_SALT = 0x9015
OP_WRITE = 0
OP_READ = 1
# Durability-index sentinel: the read's target row was never generated.
NO_ROW = 2**30


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Static description of a replayable ``(T, N)`` request trace."""

    source: Literal["ycsb", "globetraff", "npz"] = "ycsb"
    length: int = 512
    read_fraction: float = 0.5
    zipf_alpha: float = 0.99
    p2p_fraction: float = 0.3
    path: str = ""
    seed: int = 0

    def __post_init__(self):
        if self.source == "npz":
            if not self.path:
                raise ValueError(
                    "TraceSpec(source='npz') needs path=<file.npz> holding "
                    "'key_ids' and 'ops' arrays of shape (T, N)"
                )
        elif self.length < 1:
            raise ValueError(
                f"TraceSpec.length must be >= 1 (got {self.length}): it is "
                "the number of ticks the synthetic trace covers"
            )
        if not (0.0 <= self.read_fraction <= 1.0):
            raise ValueError(
                f"TraceSpec.read_fraction must be in [0, 1] (got {self.read_fraction})"
            )
        if not (0.0 <= self.p2p_fraction <= 1.0):
            raise ValueError(
                f"TraceSpec.p2p_fraction must be in [0, 1] (got {self.p2p_fraction})"
            )


def _poisson_truncation_prob(lam: float, lanes: int) -> float:
    """P[X > lanes] for X ~ Poisson(lam)."""
    return 1.0 - sum(
        math.exp(-lam) * lam**k / math.factorial(k) for k in range(lanes + 1)
    )


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Static description of one scenario."""

    popularity: Literal["stream", "zipf", "trace"] = "stream"
    key_universe: int = 4096
    zipf_alpha: float = 0.9
    rate: Literal["steady", "bursty", "diurnal"] = "steady"
    rate_period: int = 60
    rate_duty: float = 0.5
    rate_floor: float = 0.25
    churn_period: int = 0
    churn_fraction: float = 0.2
    arrivals: Literal["cadence", "poisson"] = "cadence"
    poisson_rate: float = 1.0
    max_requests_per_tick: int = 1
    trace: Optional[TraceSpec] = None
    fanout: Optional[int] = None

    def __post_init__(self):
        if self.fanout is not None and self.fanout < 1:
            raise ValueError(
                f"fanout must be >= 1 (got {self.fanout}): each node gossips "
                "with a ring neighborhood of K distinct peers — use "
                "fanout=None for dense all-pairs gossip"
            )
        if self.popularity == "trace":
            if self.trace is None:
                raise ValueError(
                    "popularity='trace' needs a TraceSpec: "
                    "WorkloadSpec(popularity='trace', trace=TraceSpec(...))"
                )
        elif self.trace is not None:
            raise ValueError(
                f"trace=TraceSpec(...) is only meaningful with "
                f"popularity='trace' (got popularity={self.popularity!r})"
            )
        if self.mutable and self.key_universe < 2:
            raise ValueError("zipf/trace key_universe must be >= 2")
        if self.arrivals == "poisson":
            if self.popularity != "zipf":
                raise ValueError("arrivals='poisson' requires popularity='zipf'")
            if not self.poisson_rate > 0.0:
                raise ValueError(
                    f"poisson_rate must be > 0 (got {self.poisson_rate})"
                )
        if self.max_requests_per_tick < 1:
            raise ValueError(
                f"max_requests_per_tick must be >= 1 (got "
                f"{self.max_requests_per_tick})"
            )
        if self.arrivals == "poisson":
            p_trunc = _poisson_truncation_prob(
                self.poisson_rate, self.max_requests_per_tick
            )
            if p_trunc > 0.05:
                need = self.max_requests_per_tick
                while _poisson_truncation_prob(self.poisson_rate, need) > 0.05:
                    need += 1
                raise ValueError(
                    f"Poisson({self.poisson_rate}) overflows "
                    f"max_requests_per_tick={self.max_requests_per_tick} on "
                    f"{p_trunc:.1%} of node-ticks (> 5%); raise it to >= {need} "
                    f"or lower poisson_rate"
                )
        if self.churn_period > 0 and not (0.0 < self.churn_fraction < 1.0):
            raise ValueError("churn_fraction must be in (0, 1) when churn is on")

    @property
    def mutable(self) -> bool:
        """Keys can be re-written -> live coherence pass + keyed durability."""
        return self.popularity in ("zipf", "trace")

    @property
    def has_churn(self) -> bool:
        return self.churn_period > 0

    @property
    def stream_indexed(self) -> bool:
        """Stream durability needs the carried cumulative-write index."""
        return self.popularity == "stream" and (
            self.rate != "steady" or self.churn_period > 0
        )

    @property
    def plan_waves(self) -> int:
        """Static number of padded write lanes per node per tick (P)."""
        return self.max_requests_per_tick if self.arrivals == "poisson" else 1


SCENARIOS: dict[str, WorkloadSpec] = {
    "paper": WorkloadSpec(),
    "zipf": WorkloadSpec(popularity="zipf", key_universe=4096, zipf_alpha=0.9),
    "zipf_hot": WorkloadSpec(popularity="zipf", key_universe=512, zipf_alpha=1.2),
    "bursty": WorkloadSpec(
        popularity="zipf", key_universe=2048, zipf_alpha=0.9,
        rate="bursty", rate_period=60, rate_duty=0.33,
    ),
    "diurnal": WorkloadSpec(
        popularity="zipf", key_universe=2048, zipf_alpha=0.9,
        rate="diurnal", rate_period=240, rate_floor=0.25,
    ),
    "churn": WorkloadSpec(
        popularity="zipf", key_universe=2048, zipf_alpha=0.9,
        churn_period=120, churn_fraction=0.2,
    ),
    "storm": WorkloadSpec(
        popularity="zipf", key_universe=1024, zipf_alpha=1.1,
        rate="bursty", rate_period=80, rate_duty=0.5,
        churn_period=100, churn_fraction=0.25,
    ),
    "poisson": WorkloadSpec(
        popularity="zipf", key_universe=1024, zipf_alpha=0.9,
        arrivals="poisson", poisson_rate=1.0, max_requests_per_tick=4,
    ),
    "trace_ycsb": WorkloadSpec(
        popularity="trace", key_universe=1024,
        trace=TraceSpec(source="ycsb", length=600, read_fraction=0.5,
                        zipf_alpha=0.99, seed=0),
    ),
    "stream_churn": WorkloadSpec(churn_period=120, churn_fraction=0.2),
}


# --------------------------------------------------------------------------
# Payloads and keys.
# --------------------------------------------------------------------------

def payload_for(key: torch.Tensor, dim: int) -> torch.Tensor:
    """Deterministic payload lanes ~ U[0, 1) from a key hash
    (``kernels.ops.payload_hash``: the kernel on the card)."""
    with span("wl.payload"):
        return ops.payload_hash(key, None, dim)


def versioned_payload(key: torch.Tensor, data_ts: torch.Tensor, dim: int) -> torch.Tensor:
    """Payload of version ``data_ts`` of a mutable key (pure in (key, ts))."""
    with span("wl.payload"):
        return ops.payload_hash(key, data_ts, dim)


def zipf_cdf(spec: WorkloadSpec, device=None) -> torch.Tensor:
    """CDF of the truncated Zipf(alpha) pmf over ``key_universe`` ids (f32)."""
    ranks = torch.arange(1, spec.key_universe + 1, dtype=torch.float32, device=device)
    w = ranks ** (-spec.zipf_alpha)
    return torch.cumsum(w, 0) / torch.sum(w)


def key_hash(key_ids: torch.Tensor) -> torch.Tensor:
    """The cache-line key (int32 bit pattern) of a zipf/trace key id."""
    return hash2_u32(key_ids, torch.full_like(key_ids, KEY_SALT, dtype=torch.int64))


def poisson_counts(spec: WorkloadSpec, gen: torch.Generator, n: int) -> torch.Tensor:
    """Per-node Poisson(``poisson_rate``) write-request counts for one tick,
    drawn from ``gen`` (JAX's distribution, not its numbers)."""
    rate = torch.full((n,), spec.poisson_rate, dtype=torch.float32, device=gen.device)
    return torch.poisson(rate, generator=gen).to(torch.int32)


# --------------------------------------------------------------------------
# Trace replay: synthetic YCSB/Globetraff-style generators + npz loading.
# --------------------------------------------------------------------------

def materialize_trace(spec: WorkloadSpec, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Build (or load) the ``(T, n)`` (key_ids, ops) arrays of a trace spec.

    Host-side numpy, deterministic in ``(spec, n)``.  Key ids are validated
    against ``spec.key_universe``; ops against {OP_WRITE, OP_READ}.
    """
    ts = spec.trace
    if ts is None:
        raise ValueError("materialize_trace needs popularity='trace'")
    if ts.source == "npz":
        with np.load(ts.path) as data:
            for field in ("key_ids", "ops"):
                if field not in data:
                    raise ValueError(
                        f"trace file {ts.path!r} is missing array "
                        f"{field!r}; expected 'key_ids' and 'ops' of shape "
                        f"(T, {n})"
                    )
            kids = np.asarray(data["key_ids"], dtype=np.int64)
            ops = np.asarray(data["ops"], dtype=np.int64)
        if kids.shape != ops.shape or kids.ndim != 2:
            raise ValueError(
                f"trace arrays must both be (T, N); got key_ids "
                f"{kids.shape} vs ops {ops.shape} in {ts.path!r}"
            )
        if kids.shape[1] != n:
            raise ValueError(
                f"trace {ts.path!r} covers {kids.shape[1]} nodes but the "
                f"simulation has n_nodes={n}; regenerate the trace or "
                f"change n_nodes"
            )
        if kids.min() < 0 or kids.max() >= spec.key_universe:
            raise ValueError(
                f"trace key_ids must lie in [0, key_universe="
                f"{spec.key_universe}); got range "
                f"[{kids.min()}, {kids.max()}] in {ts.path!r}"
            )
        if not np.isin(ops, (OP_WRITE, OP_READ)).all():
            raise ValueError(
                f"trace ops must be {OP_WRITE} (write) or {OP_READ} (read); "
                f"{ts.path!r} contains other values"
            )
        return kids.astype(np.int32), ops.astype(np.int32)

    # One independent generator per component, so each (T, n) array is
    # prefix-stable in T: TraceSpec(length=2T) replays TraceSpec(length=T)
    # for the first T ticks.
    src_tag = 0 if ts.source == "ycsb" else 1

    def _rng(component: int):
        return np.random.default_rng([int(ts.seed), src_tag, component])

    shape = (ts.length, n)
    ranks = np.arange(1, spec.key_universe + 1, dtype=np.float64)
    w = ranks ** -float(ts.zipf_alpha)
    cdf = np.cumsum(w) / np.sum(w)
    zipf_ids = np.minimum(
        np.searchsorted(cdf, _rng(0).random(shape)), spec.key_universe - 1
    )
    if ts.source == "ycsb":
        kids = zipf_ids
    else:  # globetraff: zipfian web traffic blended with uniform P2P
        p2p = _rng(1).random(shape) < ts.p2p_fraction
        uniform_ids = _rng(2).integers(0, spec.key_universe, shape)
        kids = np.where(p2p, uniform_ids, zipf_ids)
    ops = np.where(_rng(3).random(shape) < ts.read_fraction, OP_READ, OP_WRITE)
    return kids.astype(np.int32), ops.astype(np.int32)


def _trace_stamp(spec: WorkloadSpec) -> Optional[tuple]:
    """``(mtime, size)`` of an npz trace file (None for synthetic traces):
    part of the cache key, so a rewritten file is read and checked again
    and an unchanged one costs no I/O."""
    if spec.trace is None or spec.trace.source != "npz":
        return None
    try:
        st = os.stat(spec.trace.path)
    except OSError as e:
        raise ValueError(f"trace file {spec.trace.path!r} is not readable: {e}") from e
    return (st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=32)
def _trace_arrays_cached(spec: WorkloadSpec, n: int, stamp) -> tuple[np.ndarray, np.ndarray]:
    return materialize_trace(spec, n)


def _trace_arrays(spec: WorkloadSpec, n: int) -> tuple[np.ndarray, np.ndarray]:
    return _trace_arrays_cached(spec, n, _trace_stamp(spec))


@functools.lru_cache(maxsize=32)
def _trace_tensors_cached(spec: WorkloadSpec, n: int, stamp, device: torch.device):
    kids, ops = _trace_arrays_cached(spec, n, stamp)
    return torch.from_numpy(kids).to(device), torch.from_numpy(ops).to(device)


def trace_tensors(spec: WorkloadSpec, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The trace's (key_ids, ops) as int32 ``(T, n)`` tensors on ``device``,
    uploaded once and then shared."""
    return _trace_tensors_cached(spec, n, _trace_stamp(spec), torch.device(device))


def trace_length(spec: WorkloadSpec, n: int) -> int:
    """Ticks covered by the (materialized) trace of ``spec``."""
    return _trace_arrays(spec, n)[0].shape[0]


def save_trace_npz(path: str, key_ids: np.ndarray, ops: np.ndarray) -> None:
    """Write a ``(T, N)`` trace in the ``TraceSpec(source='npz')`` format."""
    np.savez(path, key_ids=np.asarray(key_ids, np.int32), ops=np.asarray(ops, np.int32))


# --------------------------------------------------------------------------
# Static topology and run checks.
# --------------------------------------------------------------------------

def validate_run(cfg, ticks: int) -> None:
    """Run-length invariants that need ``ticks`` (called by every runner)."""
    spec = cfg.workload
    if spec.popularity == "trace":
        t_len = trace_length(spec, cfg.n_nodes)
        if t_len < ticks:
            raise ValueError(
                f"trace covers {t_len} ticks but the run asks for {ticks}; "
                f"extend the trace (TraceSpec(length=...) for synthetic "
                f"sources, or regenerate the npz) or shorten the run"
            )
    if spec.fanout is not None:
        if spec.fanout > cfg.n_nodes - 1:
            raise ValueError(
                f"fanout={spec.fanout} exceeds the {cfg.n_nodes - 1} distinct "
                f"peers of an N={cfg.n_nodes} fog: lower fanout to <= N-1 or "
                "use fanout=None for dense gossip"
            )
        if cfg.readers_per_tick < 1:
            raise ValueError(
                f"fanout={spec.fanout} needs reader compaction, but "
                f"readers_per_tick={cfg.readers_per_tick}"
            )


def neighbor_table(n: int, k: int, device=None) -> torch.Tensor:
    """Static ring neighbourhood ``nbr[i, j] = (i + off_j) mod n`` with
    offsets +1, -1, +2, -2, ..., as an int64 index tensor on ``device``.

    Built once per (n, k, device) and shared: callers only index with it.
    """
    if not 1 <= k <= n - 1:
        raise ValueError(f"neighbor_table needs 1 <= k <= n-1 (got k={k}, n={n})")
    return _neighbor_table(n, k, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=16)
def _neighbor_table(n: int, k: int, device: torch.device) -> torch.Tensor:
    j = torch.arange(k, dtype=torch.int64, device=device)
    offs = (j // 2 + 1) * (1 - 2 * (j % 2))
    return (torch.arange(n, dtype=torch.int64, device=device)[:, None] + offs[None, :]) % n


# --------------------------------------------------------------------------
# Consistent-hash key -> node routing (the sharded engine).
#
# Host numpy, deterministic in its arguments, built once per shape: every
# shard agrees on every route with no communication, and a churn epoch
# remaps only the keys whose first online candidate changed.
# --------------------------------------------------------------------------

RING_SALT = 0x0C0F5A1E   # separates ring positions from the key-hash domain
RING_VNODES = 16         # virtual positions per node on the ring
RING_DEPTH = 4           # fallback owners kept per key


def _splitmix32_np(x) -> np.ndarray:
    """numpy ``splitmix32`` (the bits of ``utils.hashing``)."""
    x = np.asarray(x, np.uint32)
    x = (x + np.uint32(0x9E3779B9)).astype(np.uint32)
    x = ((x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x = ((x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return (x ^ (x >> np.uint32(16))).astype(np.uint32)


def _hash2_np(a, b) -> np.ndarray:
    """numpy ``hash2_u32`` (the bits of ``utils.hashing``)."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    mix = (b + np.uint32(0x9E3779B9)
           + (a << np.uint32(6)) + (a >> np.uint32(2))).astype(np.uint32)
    return _splitmix32_np(_splitmix32_np(a) ^ mix)


@functools.lru_cache(maxsize=32)
def hash_ring(n: int, vnodes: int = RING_VNODES) -> tuple[np.ndarray, np.ndarray]:
    """The sorted virtual-node ring of an N-node fog: ``(positions, owners)``,
    ``n * vnodes`` uint32 positions in ascending order and the int32 owner
    of each."""
    if n < 1 or vnodes < 1:
        raise ValueError(f"hash_ring needs n >= 1, vnodes >= 1 (got {n}, {vnodes})")
    node = np.repeat(np.arange(n, dtype=np.uint32), vnodes)
    vidx = np.tile(np.arange(vnodes, dtype=np.uint32), n)
    pos = _hash2_np(_hash2_np(node, vidx), np.uint32(RING_SALT))
    order = np.argsort(pos, kind="stable")
    return pos[order], node[order].astype(np.int32)


@functools.lru_cache(maxsize=32)
def ring_candidates(n: int, key_universe: int, vnodes: int = RING_VNODES,
                    depth: int = RING_DEPTH) -> np.ndarray:
    """``(K, L)`` int32: for each key id the first ``L = min(depth, n)``
    distinct nodes clockwise from its hashed position on the ring, its home
    first and then its failover order."""
    depth = min(depth, n)
    pos, owner = hash_ring(n, vnodes)
    v = pos.shape[0]
    kpos = _hash2_np(np.arange(key_universe, dtype=np.uint32), np.uint32(RING_SALT))
    start = np.searchsorted(pos, kpos, side="left") % v
    cand = np.full((key_universe, depth), -1, np.int64)
    count = np.zeros(key_universe, np.int64)
    for j in range(v):
        o = owner[(start + j) % v].astype(np.int64)
        fresh = (cand != o[:, None]).all(axis=1) & (count < depth)
        rows = np.nonzero(fresh)[0]
        cand[rows, count[rows]] = o[rows]
        count[rows] += 1
        if count.min() >= depth:
            break
    if (cand < 0).any():
        raise AssertionError("the ring walk must reach depth distinct owners")
    return cand.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _ring_candidates_on(n: int, key_universe: int, vnodes: int, depth: int,
                        device: torch.device) -> torch.Tensor:
    return torch.from_numpy(ring_candidates(n, key_universe, vnodes, depth)).long().to(device)


def route_keys(spec: WorkloadSpec, n: int, t: int, key_ids: torch.Tensor,
               vnodes: int = RING_VNODES, depth: int = RING_DEPTH) -> torch.Tensor:
    """Home node id (int32) of each key id at tick ``t``: its first ONLINE
    ring candidate, else the first online node overall."""
    dev = key_ids.device
    cand = _ring_candidates_on(n, spec.key_universe, vnodes, depth, dev)
    c = cand[key_ids.long().clamp(0, spec.key_universe - 1)]        # (..., L)
    online = online_mask(spec, n, t, dev)
    ok = online[c]
    pick = ok.to(torch.int32).argmax(dim=-1)                        # first online
    home = c.gather(-1, pick[..., None])[..., 0]
    fallback = online.to(torch.int32).argmax()
    return torch.where(ok.any(dim=-1), home, fallback).to(torch.int32)


# --------------------------------------------------------------------------
# Deterministic node-activity masks (``t`` is the host tick).
# --------------------------------------------------------------------------

def rate_mask(spec: WorkloadSpec, n: int, t: int, device=None) -> torch.Tensor:
    """Which nodes generate a write this tick."""
    if spec.rate == "steady":
        return torch.ones((n,), dtype=torch.bool, device=device)
    if spec.rate == "bursty":
        on_ticks = max(1, int(round(spec.rate_period * spec.rate_duty)))
        return torch.full((n,), (t % spec.rate_period) < on_ticks,
                          dtype=torch.bool, device=device)
    # diurnal: the first active(t) node ids write, in float32 as in JAX.
    phase = np.float32(2.0 * np.pi) * (np.float32(t) / np.float32(spec.rate_period))
    frac = np.float32(spec.rate_floor) + np.float32(1.0 - spec.rate_floor) * \
        np.float32(0.5) * (np.float32(1.0) + np.sin(phase))
    active = int(np.ceil(np.float32(n) * frac))
    return torch.arange(n, device=device) < active


def online_mask(spec: WorkloadSpec, n: int, t: int, device=None) -> torch.Tensor:
    """Which nodes are fog members this tick (a rotating offline block)."""
    if not spec.has_churn:
        return torch.ones((n,), dtype=torch.bool, device=device)
    m = max(1, min(n - 1, int(round(n * spec.churn_fraction))))
    start = ((t // spec.churn_period) * m) % n
    return (torch.arange(n, device=device) - start) % n >= m


def rejoin_mask(spec: WorkloadSpec, n: int, t: int, device=None) -> torch.Tensor:
    """Nodes that came back online THIS tick (they cold-start)."""
    if not spec.has_churn or t <= 0:
        return torch.zeros((n,), dtype=torch.bool, device=device)
    return online_mask(spec, n, t, device) & ~online_mask(spec, n, t - 1, device)


# --------------------------------------------------------------------------
# The plan stage.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanState:
    """Carried plan-stage state: the cumulative write count and, on
    stream-indexed specs, the ring index of each recent (tick, node) write."""

    cum_writes: torch.Tensor   # int32
    enq_window: torch.Tensor   # (window_ticks, N) int32, or (0, 0)


@dataclasses.dataclass(frozen=True)
class RequestPlan:
    """One tick's materialized workload (the JAX plan minus its PRNG keys)."""

    online: torch.Tensor       # (N,) bool
    rejoin: torch.Tensor       # (N,) bool
    w_keys: torch.Tensor       # (P, N) int32 key bit patterns
    w_kids: torch.Tensor       # (P, N) int32 key ids (mutable specs)
    w_valid: torch.Tensor      # (P, N) bool
    reading: torch.Tensor      # (N,) bool
    r_keys: torch.Tensor       # (N,) int32
    r_kids: torch.Tensor       # (N,) int32
    r_enq_idx: torch.Tensor    # (N,) int32 stream durability index
    r_fill_ts: torch.Tensor    # (N,) int32
    r_src: torch.Tensor        # (N,) int32
    slot_id: torch.Tensor      # (R,) int32 raw slot node id (may be >= N)
    slot_nid: torch.Tensor     # (R,) int32 clipped slot node id
    slot_ok: torch.Tensor      # (R,) bool
    state_next: PlanState


def init_plan_state(cfg, device=None) -> PlanState:
    shape = (cfg.window_ticks, cfg.n_nodes) if cfg.workload.stream_indexed else (0, 0)
    return PlanState(
        cum_writes=torch.zeros((), dtype=torch.int32, device=device),
        enq_window=torch.full(shape, -1, dtype=torch.int32, device=device),
    )


def sample_key_ids(spec: WorkloadSpec, gen: torch.Generator, shape) -> torch.Tensor:
    """Zipf-distributed key ids in [0, key_universe) by inverse CDF."""
    cdf = zipf_cdf(spec, gen.device)
    u = torch.rand(shape, generator=gen, device=gen.device)
    ids = torch.searchsorted(cdf, u)
    return ids.clamp(0, spec.key_universe - 1).to(torch.int32)


def _trace_tick(spec: WorkloadSpec, n: int, t: int, device):
    """The trace's (key_ids, ops) row for tick ``t``, the last row past T."""
    kids, ops = trace_tensors(spec, n, device)
    row = min(t, kids.shape[0] - 1)
    return kids[row], ops[row]


def plan_tick(cfg, plan_state: PlanState, t: int, gen: torch.Generator) -> RequestPlan:
    """Materialize tick ``t``'s workload, drawing from ``gen``.

    The tensors live on ``gen.device``.  ``t`` is the host tick, so no bound
    depends on a device value and the plan needs no synchronisation.  A
    trace plan reads row ``t`` of the trace (the last row past its end) and
    draws nothing.
    """
    spec = cfg.workload
    n = cfg.n_nodes
    dev = gen.device
    i32 = torch.int32
    node_ids = torch.arange(n, dtype=i32, device=dev)
    online = online_mask(spec, n, t, dev)
    rejoin = rejoin_mask(spec, n, t, dev)

    # ---- writes ------------------------------------------------------------
    if spec.popularity == "trace":
        trace_kids, trace_ops = _trace_tick(spec, n, t, dev)
        w_kids = trace_kids[None, :]
        w_keys = key_hash(trace_kids)[None, :]
        w_valid = ((trace_ops == OP_WRITE) & rate_mask(spec, n, t, dev) & online)[None, :]
    elif spec.arrivals == "poisson":
        counts = poisson_counts(spec, gen, n)
        p_lanes = spec.max_requests_per_tick
        lane = torch.arange(p_lanes, dtype=i32, device=dev)
        lane_ok = lane[:, None] < counts.clamp(max=p_lanes)[None, :]
        w_kids = sample_key_ids(spec, gen, (p_lanes, n))
        w_keys = key_hash(w_kids)
        w_valid = lane_ok & (rate_mask(spec, n, t, dev) & online)[None, :]
    elif spec.mutable:
        kids = sample_key_ids(spec, gen, (n,))
        w_kids = kids[None, :]
        w_keys = key_hash(kids)[None, :]
        w_valid = (rate_mask(spec, n, t, dev) & online)[None, :]
    else:
        w_keys = hash2_u32(torch.full((n,), t, dtype=torch.int64, device=dev),
                           node_ids)[None, :]
        w_kids = torch.zeros((1, n), dtype=i32, device=dev)
        if spec.stream_indexed:
            w_valid = (rate_mask(spec, n, t, dev) & online)[None, :]
        else:
            w_valid = torch.ones((1, n), dtype=torch.bool, device=dev)

    # ---- cumulative-write ring indexing ------------------------------------
    n_new = w_valid.sum(dtype=i32)
    enq_window = plan_state.enq_window
    if spec.stream_indexed:
        v = w_valid[0]
        rank = torch.cumsum(v.to(i32), 0, dtype=i32) - 1
        enq_window = enq_window.clone()
        enq_window[t % cfg.window_ticks] = torch.where(v, plan_state.cum_writes + rank, -1)
    state_next = PlanState(cum_writes=plan_state.cum_writes + n_new,
                           enq_window=enq_window)

    # ---- reads -------------------------------------------------------------
    cadence = ((t + node_ids) % cfg.read_period == 0) & (t > 0)
    minus_one = torch.full((n,), -1, dtype=i32, device=dev)
    zeros = torch.zeros((n,), dtype=i32, device=dev)
    if spec.popularity == "trace":
        reading = (trace_ops == OP_READ) & online
        r_kids = trace_kids
        r_keys = key_hash(trace_kids)
        r_enq_idx, r_fill_ts, r_src = zeros, minus_one, minus_one
    elif spec.mutable:
        reading = cadence & online
        r_kids = sample_key_ids(spec, gen, (n,))
        r_keys = key_hash(r_kids)
        r_enq_idx, r_fill_ts, r_src = zeros, minus_one, minus_one
    else:
        reading = cadence & online if spec.has_churn else cadence
        window = min(cfg.window_ticks, max(t, 1))
        ages = torch.randint(0, window, (n,), generator=gen, device=dev, dtype=i32)
        ages = ages.clamp(max=t)
        src = torch.randint(0, n, (n,), generator=gen, device=dev, dtype=i32)
        r_tick = t - ages
        r_keys = hash2_u32(r_tick, src)
        r_kids = zeros
        if spec.stream_indexed:
            idx = enq_window[(r_tick % cfg.window_ticks).long(), src.long()]
            r_enq_idx = torch.where(idx >= 0, idx, NO_ROW)
        else:
            r_enq_idx = r_tick * n + src
        r_fill_ts, r_src = r_tick, src

    # ---- reader-compaction slots ---------------------------------------------
    if spec.popularity == "trace":
        # any subset of the nodes may read: one slot per node, R = N
        slot_id = slot_nid = node_ids
        slot_ok = reading
    else:
        # the stagger activates exactly the nodes = -t (mod read_period)
        p = cfg.read_period
        slot_id = (-t) % p + p * torch.arange(cfg.readers_per_tick, dtype=i32, device=dev)
        slot_ok = (slot_id < n) & (t > 0)
        slot_nid = slot_id.clamp(max=n - 1)
        if spec.has_churn:
            slot_ok = slot_ok & online[slot_nid.long()]

    return RequestPlan(
        online=online, rejoin=rejoin,
        w_keys=w_keys, w_kids=w_kids, w_valid=w_valid,
        reading=reading, r_keys=r_keys, r_kids=r_kids,
        r_enq_idx=r_enq_idx, r_fill_ts=r_fill_ts, r_src=r_src,
        slot_id=slot_id, slot_nid=slot_nid, slot_ok=slot_ok,
        state_next=state_next,
    )


def plan_write_rows(cfg, plan: RequestPlan, wave: int, t: int) -> CacheLine:
    """Write wave ``wave`` of a plan as full-fog ``CacheLine``s."""
    n = cfg.n_nodes
    keys = plan.w_keys[wave]
    dev = keys.device
    ts = torch.full((n,), t, dtype=torch.int32, device=dev)
    if cfg.workload.mutable:
        data = versioned_payload(keys, ts, cfg.payload_dim)
    else:
        data = payload_for(keys, cfg.payload_dim)
    return CacheLine(
        key=keys,
        data_ts=ts,
        origin=torch.arange(n, dtype=torch.int32, device=dev),
        data=data,
        valid=plan.w_valid[wave],
        dirty=torch.zeros((n,), dtype=torch.bool, device=dev),
    )
