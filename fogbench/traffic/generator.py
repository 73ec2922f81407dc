"""The benchmark's traffic: each tick's request plan and channel uniforms.

A frozen copy of the port's planner (``core/workload.py::plan_tick`` and
what it uses, ``materialize_trace``) and of its channel draws
(``core/simulator.py::draw_tick``/``draw_shapes``).  It imports nothing of
the port, so a change to the program cannot change the randomness, and the
program and the reference execute the same draws.

``Traffic(sim, workload, seed, device)`` takes the cell's simulation fields
(``cells.sim_fields``) and the traffic file's ``workload`` group.  Each call
of ``tick(t)`` makes tick ``t``'s plan and uniforms on ``device`` from one
``torch.Generator`` seeded with ``seed``; ticks must be asked for in order,
each once.  A trace mix draws its ``(T, N)`` rows from the seed on the host,
in blocks, as ``materialize_trace`` would for any ``T`` (its generators are
prefix-stable), and uploads them before they are due (``prepare``).

Plans are plain dicts of tensors with ``RequestPlan``'s field names
(``state_next`` a dict with ``PlanState``'s); uniforms a dict with
``TickDraws``' ``u_*`` names.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9

KEY_SALT = 0x5A1FCA5E
OP_WRITE = 0
OP_READ = 1
NO_ROW = 2**30
I32 = torch.int32


# --------------------------------------------------------------------------
# 32-bit hashing on int64 holding unsigned values (``utils/hashing.py``).
# --------------------------------------------------------------------------

def _as_u32(x):
    return x.to(torch.int64) & MASK32


def _to_i32(u):
    return ((u ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul32(x, m: int):
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _splitmix(x):
    x = (x + _GOLDEN) & MASK32
    x = _mul32(x ^ (x >> 16), _M1)
    x = _mul32(x ^ (x >> 13), _M2)
    return x ^ (x >> 16)


def hash2_u32(a, b):
    """Order-sensitive hash of two 32-bit arrays; int32 bit pattern."""
    a = _as_u32(a)
    b = _as_u32(b)
    mix = (b + _GOLDEN + ((a << 6) & MASK32) + (a >> 2)) & MASK32
    return _to_i32(_splitmix(_splitmix(a) ^ mix))


def key_hash(key_ids):
    """Cache-line key of a zipf/trace key id."""
    return hash2_u32(key_ids, torch.full_like(key_ids, KEY_SALT, dtype=torch.int64))


# --------------------------------------------------------------------------
# The workload parameters (``WorkloadSpec``'s fields, with its defaults).
# --------------------------------------------------------------------------

SPEC_DEFAULTS = dict(
    popularity="stream", key_universe=4096, zipf_alpha=0.9, rate="steady",
    rate_period=60, rate_duty=0.5, rate_floor=0.25, churn_period=0,
    churn_fraction=0.2, arrivals="cadence", poisson_rate=1.0,
    max_requests_per_tick=1, trace=None, fanout=None,
)
TRACE_DEFAULTS = dict(source="ycsb", length=512, read_fraction=0.5, zipf_alpha=0.99,
                      p2p_fraction=0.3, path="", seed=0)


class Spec:
    """A workload's parameters with the properties the planner branches on."""

    def __init__(self, workload: dict, fanout=None):
        unknown = set(workload) - set(SPEC_DEFAULTS)
        if unknown:
            raise ValueError(f"unknown workload parameters {sorted(unknown)}")
        self.__dict__.update(SPEC_DEFAULTS, **workload)
        self.fanout = fanout
        if self.trace is not None:
            bad = set(self.trace) - set(TRACE_DEFAULTS)
            if bad:
                raise ValueError(f"unknown trace parameters {sorted(bad)}")
            self.trace = dict(TRACE_DEFAULTS, **self.trace)

    @property
    def mutable(self) -> bool:
        return self.popularity in ("zipf", "trace")

    @property
    def has_churn(self) -> bool:
        return self.churn_period > 0

    @property
    def stream_indexed(self) -> bool:
        return self.popularity == "stream" and (self.rate != "steady" or self.churn_period > 0)


def readers_per_tick(sim: dict, spec: Spec) -> int:
    if spec.popularity == "trace":
        return sim["n_nodes"]
    return -(-sim["n_nodes"] // sim["read_period"])


def window_ticks(sim: dict) -> int:
    return max(1, round(sim["read_window_keys"] / sim["n_nodes"]))


def needs_delivery_mask(sim: dict, spec: Spec) -> bool:
    return sim["insert_policy"] != "directory" or spec.mutable


def draw_shapes(sim: dict, spec: Spec) -> dict:
    """Name -> shape of each uniform a tick consumes."""
    n, k = sim["n_nodes"], spec.fanout
    cols = n if k is None else k
    shapes = {}
    if sim["loss_model"] == "gilbert_elliott":
        shapes["u_ge_up"] = (n,)
        shapes["u_ge_dn"] = (n,)
    if sim["loss_model"] != "none":
        if needs_delivery_mask(sim, spec):
            shapes["u_deliver"] = (n, cols)
        shapes["u_resp"] = (readers_per_tick(sim, spec), cols)
    if sim["store"]["collision_prob"] > 0.0:
        shapes["u_coll"] = ()
    return shapes


# --------------------------------------------------------------------------
# Keys, rates and membership.
# --------------------------------------------------------------------------

def zipf_cdf(spec: Spec, device) -> torch.Tensor:
    ranks = torch.arange(1, spec.key_universe + 1, dtype=torch.float32, device=device)
    w = ranks ** (-spec.zipf_alpha)
    return torch.cumsum(w, 0) / torch.sum(w)


def sample_key_ids(spec: Spec, gen: torch.Generator, shape, cdf) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return torch.searchsorted(cdf, u).clamp(0, spec.key_universe - 1).to(I32)


def rate_mask(spec: Spec, n: int, t: int, device) -> torch.Tensor:
    if spec.rate == "steady":
        return torch.ones((n,), dtype=torch.bool, device=device)
    if spec.rate == "bursty":
        on_ticks = max(1, int(round(spec.rate_period * spec.rate_duty)))
        return torch.full((n,), (t % spec.rate_period) < on_ticks, dtype=torch.bool,
                          device=device)
    phase = np.float32(2.0 * np.pi) * (np.float32(t) / np.float32(spec.rate_period))
    frac = np.float32(spec.rate_floor) + np.float32(1.0 - spec.rate_floor) * \
        np.float32(0.5) * (np.float32(1.0) + np.sin(phase))
    active = int(np.ceil(np.float32(n) * frac))
    return torch.arange(n, device=device) < active


def online_mask(spec: Spec, n: int, t: int, device) -> torch.Tensor:
    if not spec.has_churn:
        return torch.ones((n,), dtype=torch.bool, device=device)
    m = max(1, min(n - 1, int(round(n * spec.churn_fraction))))
    start = ((t // spec.churn_period) * m) % n
    return (torch.arange(n, device=device) - start) % n >= m


def rejoin_mask(spec: Spec, n: int, t: int, device) -> torch.Tensor:
    if not spec.has_churn or t <= 0:
        return torch.zeros((n,), dtype=torch.bool, device=device)
    return online_mask(spec, n, t, device) & ~online_mask(spec, n, t - 1, device)


# --------------------------------------------------------------------------
# Trace rows (``materialize_trace``), drawn block by block.
# --------------------------------------------------------------------------

class TraceRows:
    """The ``(T, n)`` (key_ids, ops) arrays of a trace mix, row block by row
    block.  Synthetic sources draw from one numpy generator per component
    (seeded ``[seed, source, component]``), so rows ``[a, b)`` are those of
    ``materialize_trace`` for any ``T >= b``; an npz source is read whole."""

    def __init__(self, spec: Spec, n: int):
        tr = spec.trace
        self.n = n
        self.ku = spec.key_universe
        self.tr = tr
        self.done = 0
        if tr["source"] == "npz":
            with np.load(tr["path"]) as data:
                self.kids = np.asarray(data["key_ids"], dtype=np.int32)
                self.ops = np.asarray(data["ops"], dtype=np.int32)
            if self.kids.shape != self.ops.shape or self.kids.shape[1:] != (n,):
                raise ValueError(f"trace {tr['path']!r} must hold (T, {n}) arrays")
            return
        src = 0 if tr["source"] == "ycsb" else 1
        self.rngs = {c: np.random.default_rng([int(tr["seed"]), src, c]) for c in range(4)}
        ranks = np.arange(1, self.ku + 1, dtype=np.float64)
        w = ranks ** -float(tr["zipf_alpha"])
        self.cdf = np.cumsum(w) / np.sum(w)

    def next_rows(self, rows: int) -> tuple[np.ndarray, np.ndarray]:
        """The next ``rows`` rows as int32 (key_ids, ops)."""
        a, self.done = self.done, self.done + rows
        if self.tr["source"] == "npz":
            last = self.kids.shape[0] - 1
            idx = np.minimum(np.arange(a, self.done), last)
            return self.kids[idx], self.ops[idx]
        shape = (rows, self.n)
        zipf_ids = np.minimum(np.searchsorted(self.cdf, self.rngs[0].random(shape)), self.ku - 1)
        if self.tr["source"] == "ycsb":
            kids = zipf_ids
        else:
            p2p = self.rngs[1].random(shape) < self.tr["p2p_fraction"]
            uniform_ids = self.rngs[2].integers(0, self.ku, shape)
            kids = np.where(p2p, uniform_ids, zipf_ids)
        ops = np.where(self.rngs[3].random(shape) < self.tr["read_fraction"], OP_READ, OP_WRITE)
        return kids.astype(np.int32), ops.astype(np.int32)


# --------------------------------------------------------------------------
# The generator.
# --------------------------------------------------------------------------

class Traffic:
    """Tick-by-tick plans and uniforms of one cell's traffic from one seed."""

    def __init__(self, sim: dict, workload: dict, seed: int, device):
        self.sim = sim
        self.spec = Spec(workload, sim.get("fanout"))
        self.n = sim["n_nodes"]
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.shapes = draw_shapes(sim, self.spec)
        self.cdf = zipf_cdf(self.spec, self.device) if self.spec.mutable else None
        self.window = window_ticks(sim)
        shape = (self.window, self.n) if self.spec.stream_indexed else (0, 0)
        self.cum_writes = torch.zeros((), dtype=I32, device=self.device)
        self.enq_window = torch.full(shape, -1, dtype=I32, device=self.device)
        self.trace = None
        if self.spec.popularity == "trace":
            self.spec.trace["seed"] = int(seed)
            self.trace = TraceRows(self.spec, self.n)
            self.rows = {}        # tick -> (key_ids, ops) on the device
        self.next_t = 0

    def prepare(self, upto: int) -> None:
        """Upload the trace rows of every tick before ``upto``."""
        if self.trace is None or self.trace.done >= upto:
            return
        first = self.trace.done
        kids, ops = self.trace.next_rows(upto - first)
        kids_d = torch.from_numpy(kids).to(self.device)
        ops_d = torch.from_numpy(ops).to(self.device)
        for i in range(upto - first):
            self.rows[first + i] = (kids_d[i], ops_d[i])

    def ops_of(self, plan: dict) -> torch.Tensor:
        """Fog operations a plan asks for: its valid writes and its reads."""
        return plan["w_valid"].sum(dtype=torch.int64) + plan["reading"].sum(dtype=torch.int64)

    def tick(self, t: int) -> tuple[dict, dict]:
        """(plan, uniforms) of tick ``t``: ``plan_tick`` then ``draw_tick``'s
        uniforms, in that order on the one generator."""
        if t != self.next_t:
            raise ValueError(f"traffic asked for tick {t} where tick {self.next_t} is due")
        self.next_t += 1
        plan = self._plan(t)
        uniforms = {name: torch.rand(shape, generator=self.gen, device=self.device)
                    for name, shape in self.shapes.items()}
        return plan, uniforms

    def _trace_tick(self, t: int):
        self.prepare(t + 1)
        return self.rows.pop(t)

    def _plan(self, t: int) -> dict:
        spec, n, dev, gen = self.spec, self.n, self.device, self.gen
        node_ids = torch.arange(n, dtype=I32, device=dev)
        online = online_mask(spec, n, t, dev)
        rejoin = rejoin_mask(spec, n, t, dev)

        # ---- writes ---------------------------------------------------------
        if spec.popularity == "trace":
            trace_kids, trace_ops = self._trace_tick(t)
            w_kids = trace_kids[None, :]
            w_keys = key_hash(trace_kids)[None, :]
            w_valid = ((trace_ops == OP_WRITE) & rate_mask(spec, n, t, dev) & online)[None, :]
        elif spec.arrivals == "poisson":
            rate = torch.full((n,), spec.poisson_rate, dtype=torch.float32, device=dev)
            counts = torch.poisson(rate, generator=gen).to(I32)
            p_lanes = spec.max_requests_per_tick
            lane = torch.arange(p_lanes, dtype=I32, device=dev)
            lane_ok = lane[:, None] < counts.clamp(max=p_lanes)[None, :]
            w_kids = sample_key_ids(spec, gen, (p_lanes, n), self.cdf)
            w_keys = key_hash(w_kids)
            w_valid = lane_ok & (rate_mask(spec, n, t, dev) & online)[None, :]
        elif spec.mutable:
            kids = sample_key_ids(spec, gen, (n,), self.cdf)
            w_kids = kids[None, :]
            w_keys = key_hash(kids)[None, :]
            w_valid = (rate_mask(spec, n, t, dev) & online)[None, :]
        else:
            w_keys = hash2_u32(torch.full((n,), t, dtype=torch.int64, device=dev),
                               node_ids)[None, :]
            w_kids = torch.zeros((1, n), dtype=I32, device=dev)
            if spec.stream_indexed:
                w_valid = (rate_mask(spec, n, t, dev) & online)[None, :]
            else:
                w_valid = torch.ones((1, n), dtype=torch.bool, device=dev)

        # ---- cumulative-write ring indexing ---------------------------------
        n_new = w_valid.sum(dtype=I32)
        enq_window = self.enq_window
        if spec.stream_indexed:
            v = w_valid[0]
            rank = torch.cumsum(v.to(I32), 0, dtype=I32) - 1
            enq_window = enq_window.clone()
            enq_window[t % self.window] = torch.where(v, self.cum_writes + rank, -1)
        self.cum_writes = self.cum_writes + n_new
        self.enq_window = enq_window

        # ---- reads ----------------------------------------------------------
        cadence = ((t + node_ids) % self.sim["read_period"] == 0) & (t > 0)
        minus_one = torch.full((n,), -1, dtype=I32, device=dev)
        zeros = torch.zeros((n,), dtype=I32, device=dev)
        if spec.popularity == "trace":
            reading = (trace_ops == OP_READ) & online
            r_kids = trace_kids
            r_keys = key_hash(trace_kids)
            r_enq_idx, r_fill_ts, r_src = zeros, minus_one, minus_one
        elif spec.mutable:
            reading = cadence & online
            r_kids = sample_key_ids(spec, gen, (n,), self.cdf)
            r_keys = key_hash(r_kids)
            r_enq_idx, r_fill_ts, r_src = zeros, minus_one, minus_one
        else:
            reading = cadence & online if spec.has_churn else cadence
            window = min(self.window, max(t, 1))
            ages = torch.randint(0, window, (n,), generator=gen, device=dev, dtype=I32)
            ages = ages.clamp(max=t)
            src = torch.randint(0, n, (n,), generator=gen, device=dev, dtype=I32)
            r_tick = t - ages
            r_keys = hash2_u32(r_tick, src)
            r_kids = zeros
            if spec.stream_indexed:
                idx = enq_window[(r_tick % self.window).long(), src.long()]
                r_enq_idx = torch.where(idx >= 0, idx, NO_ROW)
            else:
                r_enq_idx = r_tick * n + src
            r_fill_ts, r_src = r_tick, src

        # ---- reader-compaction slots ----------------------------------------
        if spec.popularity == "trace":
            slot_id = slot_nid = node_ids
            slot_ok = reading
        else:
            p = self.sim["read_period"]
            slot_id = (-t) % p + p * torch.arange(readers_per_tick(self.sim, spec),
                                                  dtype=I32, device=dev)
            slot_ok = (slot_id < n) & (t > 0)
            slot_nid = slot_id.clamp(max=n - 1)
            if spec.has_churn:
                slot_ok = slot_ok & online[slot_nid.long()]

        return dict(
            online=online, rejoin=rejoin, w_keys=w_keys, w_kids=w_kids, w_valid=w_valid,
            reading=reading, r_keys=r_keys, r_kids=r_kids, r_enq_idx=r_enq_idx,
            r_fill_ts=r_fill_ts, r_src=r_src, slot_id=slot_id, slot_nid=slot_nid,
            slot_ok=slot_ok,
            state_next=dict(cum_writes=self.cum_writes, enq_window=enq_window),
        )
