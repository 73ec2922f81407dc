"""One run of one cell: set-up, the measured window, the traced stretch and
the comparison with the reference.

``run_cell`` drives everything after the look for a chip, on any device, so
the CPU tests run it at small sizes.  The cell, its configuration, its
traffic and its metrics are found by name (``cells.py``); the program is
reached only through ``program.py``.

A run, in order:

1. set-up: the kernels' build (or load), ``init_sim``, the trace rows of a
   trace mix, and ``warmup_ticks`` ticks of the cell's own traffic through
   ``run_sim``, then one tick under the window's configuration;
2. ``--trace 0``: the window, ONE call of ``run_sim`` for
   ``window_ticks_per_s x seconds`` ticks (a fixed amount of work, which
   lasts about ``seconds`` on one H100's host), its host time ending in a
   synchronize; ``--trace 1``: first
   ``count_ticks`` ticks with the kernels' inputs counted (rooflines), then
   ``profile_ticks`` ticks under ``torch.profiler``;
3. the program's series and state to the host, its memory freed; the
   reference replays every tick from an empty fog on the same draws, and
   the two are compared (``check.py``).
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

import torch

from fogbench import cells, check, program, roofline, trace
from fogbench.reference import fog
from fogbench.traffic.generator import Traffic

DRAWS_SPAN = "fogbench.draws"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(tag: str, **fields) -> None:
    """An earlier line of the run's standard output."""
    print(f"fogbench {tag} " + json.dumps(fields, default=float), flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Feed:
    """The traffic as ``run_sim``'s ``draws``: each tick made on demand under
    the benchmark's own span, its fog operations counted from the draws into
    one device buffer a call (no object kept a tick)."""

    def __init__(self, traffic: Traffic):
        self.traffic = traffic
        self.segments = []     # consecutive calls' (count,) int64 device buffers

    def ticks(self, first: int, count: int):
        ops = torch.zeros((count,), dtype=torch.int64, device=self.traffic.device)
        self.segments.append(ops)
        for i, t in enumerate(range(first, first + count)):
            with torch.profiler.record_function(DRAWS_SPAN):
                plan, uniforms = self.traffic.tick(t)
                ops[i] = self.traffic.ops_of(plan)
                draws = program.tick_draws(t, plan, uniforms)
            yield draws

    def ops_per_tick(self) -> torch.Tensor:
        """Fog operations of every tick so far, on the host."""
        return torch.cat(self.segments).cpu()


def replay_reference(cell: cells.Cell, seed: int, ticks: int, device, elect: str = "newest"):
    """The reference over ``ticks`` ticks of the cell's traffic from an empty
    fog: (series, state), both on the host."""
    traffic = Traffic(cell.config, cell.workload, seed, device)
    cfg = fog.config(cell.config, cell.workload, device, elect=elect)
    st = fog.init_state(cfg, device)
    rows = {name: [] for name in fog.METRICS}
    for t in range(ticks):
        plan, u = traffic.tick(t)
        m = fog.tick(st, cfg, t, plan, u)
        for name in fog.METRICS:
            rows[name].append(m[name])
    series = {name: torch.stack(v).cpu() for name, v in rows.items()}
    return series, program.to_host(st)


def summarize(series: dict) -> dict:
    """The paper's ratios of a series (``core/metrics.py::summarize``)."""
    tot = {k: v.sum() for k, v in series.items()}
    reads = max(int(tot["reads"]), 1)
    wan = float(tot["wan_tx_bytes"]) + float(tot["wan_rx_bytes"])
    return {
        "ticks": int(tot["ticks"]),
        "read_miss_ratio": int(tot["misses"]) / reads,
        "sync_store_request_ratio": int(tot["misses"]) / max(int(tot["reads"]) + int(tot["writes_gen"]), 1),
        "wan_reduction_vs_baseline": 1.0 - wan / max(float(tot["baseline_wan_bytes"]), 1.0),
        "hit_local_ratio": int(tot["hits_local"]) / reads,
        "hit_fog_ratio": int(tot["hits_fog"]) / reads,
        "stale_reads": int(tot["stale_reads"]),
        "coherence_updates": int(tot["coherence_updates"]),
    }


def _series_host(chunks: list) -> dict:
    out = {}
    for f in chunks[0]:
        out[f] = torch.cat([c[f] for c in chunks]).cpu()
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, cell: cells.Cell | None = None) -> dict:
    """One run; returns the result line's object.  ``cell`` replaces the
    cell read from ``root`` (the tests shrink it)."""
    device = torch.device(device)
    cell = cell or cells.load(root, workload)
    tr = cell.traffic
    on_card = device.type == "cuda"
    if on_card:
        program.build()
    built_s = time.perf_counter() - t_start
    traffic = Traffic(cell.config, cell.workload, seed, device)
    feed = Feed(traffic)
    warm = tr["warmup_ticks"]
    chunks = []

    # ---- set-up: the fog filled by the cell's own traffic -------------------
    cfg = program.sim_config(cell.config, cell.workload, seed, trace_ticks=warm)
    state = program.init(cfg, device)
    traffic.prepare(warm)
    h0 = time.perf_counter()
    state, s = program.run(cfg, warm, feed.ticks(0, warm), state, device)
    chunks.append(program.flat(s))
    _sync(device)
    rate = warm / (time.perf_counter() - h0)
    t = warm
    # A fixed amount of work from the traffic: the window's ticks do not
    # follow the host's speed, so neither do its peak and its reference.
    window = tr["profile_ticks"] if traced else max(1, round(tr["window_ticks_per_s"] * seconds))
    cfg = program.sim_config(cell.config, cell.workload, seed,
                             trace_ticks=max(window, tr["count_ticks"]))
    state, s = program.run(cfg, 1, feed.ticks(t, 1), state, device)
    chunks.append(program.flat(s))
    t += 1
    occupancy = float(state.caches.valid.float().mean())
    log("setup", warmup_ticks=t, warmup_ticks_per_s=rate, window_ticks=window,
        occupancy=occupancy, built_at_s=built_s, warm_at_s=time.perf_counter() - t_start)

    result = {"device": device_info(device)}
    view = None
    if traced:
        # Count the kernels' work from their inputs on a stretch of its own.
        readers = cells.layer_readers(cell)
        capture = {r.KERNEL: r for r in readers.values() if hasattr(r, "KERNEL")}
        counted = {name: [] for name in capture}

        def on_call(name, args):
            counted[name].append(capture[name].work(args, cell))

        traffic.prepare(t + tr["count_ticks"] + window)
        with program.spy(tuple(capture), on_call):
            state, s = program.run(cfg, tr["count_ticks"], feed.ticks(t, tr["count_ticks"]),
                                   state, device)
        chunks.append(program.flat(s))
        t += tr["count_ticks"]
        first = t
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        state, s, view = trace.traced_window(
            lambda: program.run(cfg, window, feed.ticks(first, window), state, device),
            device, window, root / "build" / "fogbench" / f"{workload}.trace.json.gz",
            DRAWS_SPAN, program.hand_kernel_names())
        chunks.append(program.flat(s))
        t += window
        view.captured = counted
        view.cell = cell
    else:
        traffic.prepare(t + window)
        first = t
        program.reset_launch_counts()
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        # What set-up made (the warm-up's series, the trace rows) is not
        # rescanned by the collector inside the window.
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - t_start
        h0 = time.perf_counter()
        state, s = program.run(cfg, window, feed.ticks(first, window), state, device)
        _sync(device)
        window_s = time.perf_counter() - h0
        gc.unfreeze()
        chunks.append(program.flat(s))
        t += window
        launches = program.launch_counts()
        log("window", ticks=window, seconds=window_s, ticks_per_s=window / window_s,
            hand_kernel_launches_per_tick={k: v / window for k, v in launches.items() if v})
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    result["device"]["memory_peak_bytes"] = peak

    # ---- the fog operations of the window, from the benchmark's draws -------
    ops_tick = feed.ops_per_tick()
    window_ops = int(ops_tick[first:first + window].sum())
    derived = cells.derived_ops(cell, first, window)
    log("ops", window_ops=window_ops, per_tick=window_ops / window, derived_from_traffic=derived)
    if derived is not None and derived != window_ops:
        raise RuntimeError(f"the draws hold {window_ops} operations, the traffic {derived}")

    # ---- correctness: the reference replays every tick ------------------------
    prog_series = _series_host(chunks)
    prog_state = program.to_host(program.flat(state))
    del state, s, chunks
    program.empty_device_cache()
    h0 = time.perf_counter()
    ref_series, ref_state = replay_reference(cell, seed, t, device)
    ref_s = time.perf_counter() - h0
    counts, bad_tick = check.compare(prog_series, ref_series, prog_state, ref_state)
    win = slice(first, first + window)
    log("ratios", window=summarize({k: v[win] for k, v in prog_series.items()}),
        reference_window=summarize({k: v[win] for k, v in ref_series.items()}))
    log("reference", ticks=t, seconds=ref_s)
    # Failed: the operations of the window's ticks whose row differs from the
    # reference's; all of them where only the final state differs.
    failed = int(ops_tick[first:first + window][bad_tick[win]].sum())
    if failed == 0 and not check.verdict(counts):
        failed = window_ops

    metrics = {}
    if traced:
        values = {name: r.read(view) for name, r in readers.items()}
        log("trace", ticks=window, seconds=view.window_s, busy_s=view.busy_s,
            draws_ms_per_tick=sum(o.dur for o in view.ops if o.draws) / 1e3 / window,
            trace_bytes=view.path.stat().st_size)
        log("rooflines", power_limit=result["device"].get("power_limit"),
            **roofline.describe(view))
        result["device"]["busy_s"] = view.busy_s
        result["device"]["window_s"] = view.window_s
        result["breakdown"] = view.breakdown()
    else:
        run = cells.WindowRun(window_s=window_s, ops=window_ops, peak_bytes=peak,
                              setup_s=setup_s, ticks=window)
        values = cells.read_end_to_end(cell, run)
    for m in (cell.per_layer if traced else cell.end_to_end):
        if values.get(m["name"]) is not None:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result.update(correct=check.verdict(counts), attempted=window_ops, failed=failed,
                  metrics=metrics)
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in counts.items()}
    return result


def device_info(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    limit = trace.power_limit()
    if limit is not None:
        info["power_limit"] = limit
    return info
