#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FLIC fog cache on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, then runs these phases, each printing one JSON line:

1. ``device``: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions;
2. ``build``: the build time of the kernels and ``ptxas``'s resource lines;
3. ``kernels``: each kernel against its plain PyTorch version (bitwise),
   first on the inputs the main path gives it (copied from one tick of the
   dense and the city cell), then on arbitrary states at the same shapes;
   with the median time of 20 runs of each and the card's time bound for
   the bytes that those inputs need;
4. ``replay``: the committed JAX replays (``src/repro_torch/testdata``)
   through ``run_sim`` with the kernels; the ``TickMetrics`` series must
   equal JAX's bitwise;
5. ``dense``: the main path, N=1,000 nodes, dense gossip, the ``zipf_hot``
   workload (the coherence sweep is live), Gilbert-Elliott loss and a store
   outage, 600 ticks, with the kernels and with the inline path; the two
   series must be equal and each kernel must have launched;
6. ``city``: the paper's stream at N=10,000 nodes with fan-out 32, 120
   ticks, with the kernels and with the inline path; equal series.

After ``dense`` and ``city`` a ``profile`` line checks that a tick never
synchronises the host and says where its time goes on the card.

Then one line lists every kernel with its numbers, one line holds
``nvidia-smi``'s name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device, or without the port beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM 32-bit rate outside the tensor cores
TIMED_RUNS = 20
MAX_SPIN_MS = 2_000.0
KERNELS = ("flic_insert", "flic_update", "flic_lookup")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time in ms the card could take: bytes over memory rate vs
    operations over the 32-bit non-tensor rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms of device time."""
    torch.cuda._sleep(1_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(torch, fn, make_args, cycles_per_ms: float) -> float:
    """Median device time of ``fn(*make_args())`` over TIMED_RUNS runs.

    Arguments are made fresh for each run (the kernels update in place),
    outside the timed span.  A spin kernel queued ahead of the start event
    keeps the card busy while the host enqueues the call, so the span
    measures the card, not the host.  The spin lasts four times the host's
    enqueue time of a warm-up call (at least 1 ms); a run whose enqueue took
    more than half its spin is thrown away and run again with twice the spin.
    """
    args = make_args()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn(*args)
    spin_ms = max(1.0, 4e3 * (time.perf_counter() - h0))
    torch.cuda.synchronize()
    times = []
    while len(times) < TIMED_RUNS:
        if spin_ms > MAX_SPIN_MS:
            raise RuntimeError(f"{fn.__name__}: the host enqueue outlasts a {MAX_SPIN_MS} ms spin")
        args = make_args()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        fn(*args)
        end.record()
        host_ms = 1e3 * (time.perf_counter() - h0)
        torch.cuda.synchronize()
        if host_ms > 0.5 * spin_ms:
            spin_ms *= 2
            continue
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _count(mask) -> int:
    return int(mask.sum())


def _lines_touched(torch, match, sidx, n_sets):
    """(C, S, W) bool: the lines of the (C, Q, W) ``match`` mask, whose
    queries go to sets ``sidx`` (Q,)."""
    c, q, w = match.shape
    out = torch.zeros((c, n_sets, w), dtype=torch.int32, device=match.device)
    return out.scatter_reduce(1, sidx.long()[None, :, None].expand(c, q, w),
                              match.to(torch.int32), "amax") > 0


# The bytes each function must move on the data it is given, each input
# read once and each output written once, counting only what the data
# needs: a dead lane reads its live flag alone, a tag is read only where
# its way is valid, a timestamp only where the tag matches, last_use only
# where an insert falls back to the LRU way, a payload only where it is
# copied.  Operations: the compares of the way loop.  Each returns (bytes,
# operations, what the count rests on).

def insert_work(torch, tags, data_ts, ins_ts, origin, valid, dirty, last_use, data,
                keys, sidx, line_ts, line_origin, line_dirty, live, line_data, now):
    from repro_torch.kernels import ref

    n, _, w = tags.shape
    d = data.shape[-1]
    rows = torch.arange(n, device=tags.device)
    s = sidx.long()
    valid_r = valid[rows, s] & live[:, None]
    present = (valid_r & (tags[rows, s] == keys[:, None])).any(dim=1)
    lru = live & ~present & valid_r.all(dim=1)
    _, do_write = ref.insert_plan(tags, data_ts, valid, last_use, keys, sidx, line_ts, live)
    new = do_write & ~present
    nbytes = (
        n                                  # live
        + _count(live) * (8 + w)           # key, set index, the set's valid flags
        + _count(valid_r) * 4              # tags of its valid ways
        + _count(present) * 8              # line_ts and the present copy's data_ts
        + _count(lru) * 4 * w              # last_use of a full set
        + _count(new) * 4                  # line_ts of a new line
        + _count(do_write) * (5 + 4 * d)   # line_origin, line_dirty, line_data
        + _count(do_write) * (17 + 4 * d)  # written: data_ts, ins_ts, origin, dirty, last_use, data
        + _count(new) * 5                  # written too where the line is new: tag, valid
    )
    info = dict(N=n, S=tags.shape[1], W=w, D=d, lanes_live=_count(live),
                lanes_present=_count(present), lanes_lru=_count(lru),
                lines_written=_count(do_write))
    return nbytes, _count(live) * w * 4, info


def update_work(torch, tags, data_ts, valid, last_use, data, keys, sidx, row_ts,
                row_data, live, now):
    from repro_torch.kernels import ref

    n, n_sets, w = tags.shape
    d = data.shape[-1]
    r = keys.shape[0]
    s = sidx.long()
    touched = _lines_touched(torch, live[:, :, None], sidx, n_sets)[..., 0]   # (N, S)
    match = valid[:, s] & (tags[:, s] == keys[None, :, None]) & live[:, :, None]
    winr, _ = ref.update_winners(tags, data_ts, valid, keys, sidx, row_ts, live)
    updated = winr >= 0
    nbytes = (
        n * r                                             # live
        + _count(live.any(dim=0)) * 8                     # key, set index of a live row
        + _count(match.any(dim=2).any(dim=0)) * 4         # row_ts of a matching row
        + _count(touched) * w                             # valid flags of a touched set
        + _count(valid & touched[..., None]) * 4          # tags of its valid ways
        + _count(_lines_touched(torch, match, sidx, n_sets)) * 4   # data_ts of a matched line
        + int(torch.unique(winr[updated]).numel()) * 4 * d         # a winning row's payload
        + _count(updated) * (8 + 4 * d)                   # written: data_ts, last_use, data
        + n * 4                                           # counts
    )
    info = dict(N=n, R=r, S=n_sets, W=w, D=d, live_pairs=_count(live),
                sets_touched=_count(touched), lines_updated=_count(updated))
    return nbytes, _count(live) * w * 3, info


def lookup_work(torch, tags, data_ts, valid, data, keys, sidx):
    from repro_torch.kernels import ref

    c, n_sets, w = tags.shape
    d = data.shape[-1]
    q = keys.shape[0]
    s = sidx.long()
    sets = torch.zeros((n_sets,), dtype=torch.bool, device=tags.device)
    sets[s] = True
    match = valid[:, s] & (tags[:, s] == keys[None, :, None])                 # (C, Q, W)
    hit, _, _, way = ref.flic_lookup_ref(tags, data_ts, valid, data, keys, sidx)
    cache = torch.arange(c, device=tags.device)[:, None]
    hit_lines = ((cache * n_sets + s[None, :]) * w + way)[hit]
    nbytes = (
        q * 8                                             # keys, set indices
        + c * _count(sets) * w                            # valid flags of each queried set
        + _count(valid & sets[None, :, None]) * 4         # tags of its valid ways
        + _count(_lines_touched(torch, match, sidx, n_sets)) * 4   # data_ts of a matched line
        + int(torch.unique(hit_lines).numel()) * 4 * d    # payload of a line that answers
        + c * q * (9 + 4 * d)                             # written: hit, ts, way, payload
    )
    info = dict(C=c, Q=q, S=n_sets, W=w, D=d, hits=_count(hit))
    return nbytes, c * q * w * 3, info


WORK = {"flic_insert": insert_work, "flic_update": update_work, "flic_lookup": lookup_work}


def check_and_time(torch, name: str, args, cycles_per_ms: float) -> dict:
    """One call of kernel ``name`` held bitwise against its plain version
    on the same inputs, then both timed."""
    from repro_torch.kernels import ops, ref

    kernel, plain = getattr(ops, name), getattr(ref, f"{name}_ref")

    def fresh():
        return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    got = kernel(*fresh())
    torch.cuda.synchronize()
    want = plain(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain version")
    nbytes, ops_n, info = WORK[name](torch, *args)
    b_ms, b_by = bound(nbytes, ops_n)
    return dict(
        info, ms=time_ms(torch, kernel, fresh, cycles_per_ms),
        plain_ms=time_ms(torch, plain, fresh, cycles_per_ms),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n,
    )


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version.
# ---------------------------------------------------------------------------

def capture_main_path(torch, device, cfg, ticks: int, at: dict) -> dict:
    """Inputs of chosen kernel calls in a native run of ``cfg`` with the
    kernels: ``at[name]`` lists the indices, among that kernel's calls in
    the run, of the calls to copy.  Returns ``{(name, index): args}``."""
    from repro_torch.core import flic
    from repro_torch.core.simulator import run_sim

    real = flic.KERNEL_BACKENDS["cuda"]
    calls = {name: 0 for name in KERNELS}
    got = {}

    def spy(name, fn):
        def call(*args):
            if calls[name] in at.get(name, ()):
                got[name, calls[name]] = [
                    a.clone() if isinstance(a, torch.Tensor) else a for a in args
                ]
            calls[name] += 1
            return fn(*args)
        return call

    flic.KERNEL_BACKENDS["cuda"] = tuple(spy(n, f) for n, f in zip(KERNELS, real))
    try:
        run_sim(dataclasses.replace(cfg, probe_backend="cuda"), ticks, seed=0, device=device)
    finally:
        flic.KERNEL_BACKENDS["cuda"] = real
    missing = [(n, i) for n, idx in at.items() for i in idx if (n, i) not in got]
    if missing:
        raise AssertionError(f"the run never made kernel calls {missing}")
    return got


def random_tables(torch, gen, n, s, w, d, pool):
    """Arbitrary cache tables: tags from a small key pool, so sets hold
    duplicate tags and queries hit and miss."""
    dev = gen.device

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    shape = (n, s, w)
    return [
        pool[ri(0, pool.numel(), shape).long()],        # tags
        ri(-1, 20, shape),                              # data_ts
        ri(-1, 20, shape),                              # ins_ts
        ri(-1, n, shape),                               # origin
        torch.rand(shape, generator=gen, device=dev) < 0.7,   # valid
        torch.rand(shape, generator=gen, device=dev) < 0.3,   # dirty
        ri(-1, 30, shape),                              # last_use
        torch.rand((*shape, d), generator=gen, device=dev),   # data
    ]


def random_cases(torch, device) -> dict:
    """Arbitrary states at the main path's shapes, with duplicate tags in a
    set, duplicate rows and queries, dead lanes and a Q that is not a
    multiple of 32: ``{name: {label: args}}``."""
    from repro_torch.core.cache_state import set_index

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    pool = torch.randint(-2**31, 2**31 - 1, (32,), generator=gen, device=device,
                         dtype=torch.int32)
    s, w, d = 50, 4, 8

    def queries(q):
        keys = pool[torch.randint(0, pool.numel(), (q,), generator=gen, device=device)]
        return [keys, set_index(keys, s).to(torch.int32)]

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    n = 10_000
    tags, data_ts, ins_ts, origin, valid, dirty, last_use, data = random_tables(
        torch, gen, n, s, w, d, pool)
    insert = [tags, data_ts, ins_ts, origin, valid, dirty, last_use, data, *queries(n),
              ri(-1, 25, (n,)), ri(0, n, (n,)),
              torch.rand(n, generator=gen, device=device) < 0.5,
              torch.rand(n, generator=gen, device=device) < 0.8,
              torch.rand((n, d), generator=gen, device=device), 30]

    n = r = 1_000
    tags, data_ts, _, _, valid, _, last_use, data = random_tables(torch, gen, n, s, w, d, pool)
    update = [tags, data_ts, valid, last_use, data, *queries(r), ri(-1, 25, (r,)),
              torch.rand((r, d), generator=gen, device=device),
              torch.rand((n, r), generator=gen, device=device) < 0.5, 30]

    tags, data_ts, _, _, valid, _, _, data = random_tables(torch, gen, 1_000, s, w, d, pool)
    lookup = {f"random_q{q}": [tags, data_ts, valid, data, *queries(q)] for q in (67, 1_000)}
    return {"flic_insert": {"random": insert}, "flic_update": {"random": update},
            "flic_lookup": lookup}


def kernel_phase(torch, device, dense_cfg, city_cfg, cycles_per_ms) -> dict:
    """Each kernel on the inputs the main path gives it (copied from one
    tick of each cell: dense tick 200, before the outage; city tick 60) and
    on arbitrary states; bitwise against the plain version, timed, bound.
    The first main-path case of each kernel is its headline."""
    dense = capture_main_path(torch, device, dense_cfg, 201, {
        "flic_update": (200,), "flic_lookup": (200,), "flic_insert": (400,)})
    city = capture_main_path(torch, device, city_cfg, 61, {"flic_insert": (120, 121)})
    cases = {
        "flic_insert": {"city_t60_writes": city["flic_insert", 120],
                        "city_t60_fills": city["flic_insert", 121],
                        "dense_t200_writes": dense["flic_insert", 400]},
        "flic_update": {"dense_t200": dense["flic_update", 200]},
        "flic_lookup": {"dense_t200": dense["flic_lookup", 200]},
    }
    for name, more in random_cases(torch, device).items():
        cases[name].update(more)
    return {
        name: {label: check_and_time(torch, name, args, cycles_per_ms)
               for label, args in by_label.items()}
        for name, by_label in cases.items()
    }


# ---------------------------------------------------------------------------
# Phases 4-6: the engine.
# ---------------------------------------------------------------------------

def series_equal(torch, a, b, label: str) -> None:
    from repro_torch.core.metrics import EMBODIMENT_FIELDS, field_names

    for f in field_names():
        if f in EMBODIMENT_FIELDS:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: TickMetrics.{f} diverged")


def timed_run(torch, cfg, ticks, backend, device):
    from repro_torch.core.simulator import run_sim
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(cfg, probe_backend=backend)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, series = run_sim(cfg, ticks, seed=0, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return series, ticks / secs, dict(ops.LAUNCHES)


def replay_phase(torch, device) -> None:
    import numpy as np

    from repro_torch.core.metrics import EMBODIMENT_FIELDS
    from repro_torch.core.replay import load_replay
    from repro_torch.core.simulator import run_sim
    from repro_torch.kernels import ops

    for path in sorted((ROOT / "src" / "repro_torch" / "testdata").glob("replay_*.npz")):
        cfg, draws, expected = load_replay(path, device)
        cfg = dataclasses.replace(cfg, probe_backend="cuda")
        ops.reset_launches()
        _, series = run_sim(cfg, len(draws), device=device, draws=draws)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        for f, want in expected.items():
            if f in EMBODIMENT_FIELDS:
                continue
            got = getattr(series, f).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"replay {path.name}: TickMetrics.{f} diverged from JAX")
        if launches["flic_insert"] == 0 or launches["flic_lookup"] == 0:
            raise AssertionError(f"replay {path.name}: kernels not launched: {launches}")
        emit("replay", file=path.name, ticks=len(draws), equal_to_jax=True,
             launches=launches)


def tick_profile(torch, device, cfg, ticks_per_s: float, ticks: int = 20) -> dict:
    """Where a tick's time goes, with the kernels.

    Steps ``sim_tick`` on the native planner's draws: 5 warm-up ticks, 5
    under ``torch.cuda.set_sync_debug_mode("error")`` (any host
    synchronisation inside the tick raises), then ``ticks`` under
    ``torch.profiler``.  Device busy time is the sum of the CUDA kernels'
    time; the idle share compares it with the unprofiled tick time.
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simulator import draw_tick, init_sim, sim_tick

    cfg = dataclasses.replace(cfg, probe_backend="cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_sim(cfg, device)
    for t in range(5):
        state, _ = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(5, 10):
            state, _ = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(10, 10 + ticks):
            state, _ = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return dict(sync_free=True, device_busy_ms_per_tick="not measured")
    tick_ms = 1e3 / ticks_per_s
    busy_ms = busy_us / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        sync_free=True, tick_ms=tick_ms, device_busy_ms_per_tick=busy_ms,
        device_idle_share=1.0 - busy_ms / tick_ms,
        kernel_launches_per_tick=sum(e.count for e in kernels) / ticks,
        hand_kernels_ms_per_tick={
            name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / ticks
            for name in ("flic_insert", "flic_update", "flic_lookup")
        },
        top_kernels_ms_per_tick=[[e.key[:80], e.self_device_time_total / 1e3 / ticks]
                                 for e in top],
    )


HEADLINE = ("read_miss_ratio", "hit_local_ratio", "hit_fog_ratio", "hit_queue_ratio",
            "sync_store_request_ratio", "wan_reduction_vs_baseline",
            "coherence_updates", "stale_read_ratio", "writes_gen", "writes_drained",
            "queue_dropped")


def engine_phase(torch, device, name, cfg, ticks, must_launch):
    from repro_torch.core.metrics import summarize

    s_cuda, rate_cuda, launches = timed_run(torch, cfg, ticks, "cuda", device)
    s_inline, rate_inline, _ = timed_run(torch, cfg, ticks, None, device)
    series_equal(torch, s_cuda, s_inline, f"{name}: cuda vs inline")
    if s_cuda.reads.shape != (ticks,) or not all(
            bool(torch.isfinite(getattr(s_cuda, f)).all())
            for f in ("lan_bytes", "wan_rx_bytes", "read_latency_sum")):
        raise AssertionError(f"{name}: series has the wrong shape or non-finite values")
    missing = [k for k in must_launch if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} were not launched: {launches}")
    summary = summarize(s_cuda)
    emit(name, n_nodes=cfg.n_nodes, ticks=ticks, fanout=cfg.workload.fanout,
         ticks_per_s_cuda=rate_cuda, ticks_per_s_inline=rate_inline,
         series_equal=True, launches=launches,
         summary={k: summary[k] for k in HEADLINE})
    emit("profile", cell=name, **tick_profile(torch, device, cfg, rate_cuda))
    return launches, summary


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port (src/repro_torch) is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import workload as wl
    from repro_torch.core.simulator import SimConfig
    from repro_torch.kernels import build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    logs = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         ptxas={k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
                for k, v in logs.items()})

    dense_cfg = SimConfig(
        n_nodes=1000, cache_lines=200, loss_model="gilbert_elliott",
        workload=wl.SCENARIOS["zipf_hot"], outage_schedule=((300, 120),),
    )
    city_cfg = SimConfig(n_nodes=10_000, cache_lines=200,
                         workload=dataclasses.replace(wl.SCENARIOS["paper"], fanout=32))

    cycles_per_ms = spin_cycles_per_ms(torch)
    kres = kernel_phase(torch, device, dense_cfg, city_cfg, cycles_per_ms)
    emit("kernels", bitwise_equal=True, spin_cycles_per_ms=cycles_per_ms, **kres)

    replay_phase(torch, device)

    dense_launches, _ = engine_phase(torch, device, "dense", dense_cfg, 600, KERNELS)
    city_launches, city = engine_phase(torch, device, "city", city_cfg, 120, ("flic_insert",))
    if city["queue_dropped"] <= 0:
        raise AssertionError("city: the writer ring was expected to overflow")

    src = {
        "flic_insert": "src/repro/kernels/flic_insert.py:122",
        "flic_update": "src/repro/kernels/flic_update.py:77",
        "flic_lookup": "src/repro/kernels/flic_lookup.py:61",
    }
    # Headline case of each kernel: the first main-path case of the kernels
    # phase.  Launches: both main-path runs (dense, then city), each counted
    # from 0.  max_abs_err is 0: every kernel passed a bitwise comparison.
    lines = []
    for name in KERNELS:
        head = next(iter(kres[name].values()))
        lines.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": src[name],
            "launches": dense_launches[name] + city_launches[name],
            "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": lines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
