"""End-to-end driver: a city-scale fog deployment, the paper's own scenario
(port of ``examples/cityscale_cache_sim.py``).

Run on the card, or on the host::

    PYTHONPATH=src python -m repro_torch.examples.cityscale_cache_sim --nodes 100 \\
        [--scenario zipf] [--trace requests.npz] [--engine fused]
    PYTHONPATH=src python -m repro_torch.examples.cityscale_cache_sim --device cpu \\
        --nodes 20 --minutes 1 --outage-at 20 --outage-s 20

Simulates a metropolitan sensor fleet (default 100 nodes, ~30 simulated
minutes): every node logs one reading per second, shares it with the fog
under a bursty (Gilbert-Elliott) radio channel, and the single queued writer
trickles durable rows to the cloud under API rate limits — including a
3-minute cloud outage in the middle, which FLIC rides out (paper §VI).
Prints the paper's evaluation metrics plus a tick-by-tick outage trace.

``--scenario`` selects a workload preset (``repro_torch.core.workload.
SCENARIOS``); ``--trace`` replays a recorded ``(T, N)`` request tensor
instead: an ``.npz`` file with ``key_ids`` and ``ops`` (0=write, 1=read)
arrays, e.g. one written by ``workload.save_trace_npz``.

``--engine`` picks the simulation engine (``run_any_engine``, DESIGN.md
§8): the default ``reference`` keeps the tick-by-tick outage trace below
(a per-tick loop of the fused ``sim_tick``, as in the JAX driver); the
other engines (``fused``, ``distributed``, ``sharded``) run the whole span
with the outage on ``cfg.outage_schedule``.  ``distributed`` and
``sharded`` run on ``--world`` spawned ranks over ``torch.distributed``
(``--world`` must divide ``--nodes``; NCCL when each rank has a card of
its own, else gloo, which also runs several ranks on one card or on the
host).  ``sharded`` is the bandwidth-lean engine
(DESIGN.md §10): it needs a mutable zipf scenario (e.g. ``--scenario
zipf``) and its ``wire_bytes_per_tick`` line shows the on-wire traffic the
consistent-hash routing saves versus ``distributed``.  The port draws from
``torch.Generator`` seed 0, not JAX's threefry: the metrics follow the same
distributions, not the same numbers.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import backing_store as bs
from repro_torch.core import workload as wl
from repro_torch.core.metrics import stack, summarize
from repro_torch.core.simulator import (
    SimConfig,
    draw_tick,
    init_sim,
    resolve_device,
    run_any_engine,
    sim_tick,
)


def _pick_workload(args, ticks: int) -> wl.WorkloadSpec:
    if args.trace:
        with np.load(args.trace) as data:
            if "key_ids" not in data or data["key_ids"].size == 0:
                raise SystemExit(
                    f"--trace {args.trace}: expected a non-empty 'key_ids' "
                    f"array of shape (T, N) (see workload.save_trace_npz)"
                )
            key_universe = int(data["key_ids"].max()) + 1
        return wl.WorkloadSpec(
            popularity="trace", key_universe=max(2, key_universe),
            trace=wl.TraceSpec(source="npz", path=args.trace),
        )
    spec = wl.SCENARIOS[args.scenario]
    if spec.popularity == "trace" and spec.trace.source != "npz" \
            and spec.trace.length < ticks:
        # synthetic preset traces cover the benchmark length; stretch them
        # to this run so validate_run's trace-length floor holds
        spec = dataclasses.replace(
            spec, trace=dataclasses.replace(spec.trace, length=ticks)
        )
    return spec


def _backend(world: int, dev: torch.device) -> str:
    """NCCL when each rank has a card of its own; gloo otherwise (NCCL
    refuses two ranks on one card)."""
    return "nccl" if dev.type == "cuda" and world <= torch.cuda.device_count() else "gloo"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--minutes", type=int, default=30)
    ap.add_argument("--cache-lines", type=int, default=200)
    ap.add_argument("--outage-at", type=int, default=900)
    ap.add_argument("--outage-s", type=int, default=180)
    ap.add_argument("--scenario", choices=sorted(wl.SCENARIOS), default="paper",
                    help="workload preset (see repro_torch.core.workload.SCENARIOS)")
    ap.add_argument("--trace", default=None, metavar="NPZ",
                    help="replay a recorded (T, N) trace: npz file with "
                         "'key_ids' and 'ops' arrays (overrides --scenario)")
    ap.add_argument("--engine", default="reference",
                    choices=("reference", "fused", "distributed", "sharded"),
                    help="simulation engine (DESIGN.md §8); 'sharded' is the "
                         "bandwidth-lean engine and needs a mutable zipf "
                         "scenario, e.g. --scenario zipf")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of the distributed/sharded engines (divides --nodes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ticks = args.minutes * 60
    spec = _pick_workload(args, ticks)
    cfg = SimConfig(
        n_nodes=args.nodes,
        cache_lines=args.cache_lines,
        loss_model="gilbert_elliott",
        queue_capacity=65536,
        writer_max_per_tick=256,
        workload=spec,
    )
    wl.validate_run(cfg, ticks)

    if args.engine == "reference":
        # Per-tick loop: keeps the live outage trace printed below.
        state = init_sim(cfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        series = []
        for t in range(ticks):
            if t == args.outage_at:
                state = dataclasses.replace(
                    state, store=bs.inject_outage(state.store, t, args.outage_s)
                )
                print(f"[t={t:5d}] *** cloud outage injected ({args.outage_s}s) ***")
            state, m = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
            series.append(m)
            if t % 300 == 0 or (args.outage_at <= t < args.outage_at + args.outage_s + 60
                                and t % 60 == 0):
                print(
                    f"[t={t:5d}] queue={int(m.queue_depth):6d} "
                    f"missed_reads={int(m.misses):3d} "
                    f"wan_B/s={float(m.wan_tx_bytes + m.wan_rx_bytes):12.0f}"
                )
        stacked = stack(series)
    else:
        # Whole-span engines: the outage rides on cfg.outage_schedule.
        cfg = dataclasses.replace(
            cfg, outage_schedule=((args.outage_at, args.outage_s),)
        )
        if args.engine == "sharded" and not cfg.workload.mutable:
            raise SystemExit(
                f"--engine sharded needs a mutable zipf scenario, not "
                f"'{args.scenario}': try --scenario zipf (or zipf_hot)"
            )
        print(f"[engine={args.engine}] running {ticks} ticks in one scan "
              f"(outage at t={args.outage_at} for {args.outage_s}s)")
        ranks = {}
        if args.engine in ("distributed", "sharded"):
            ranks = dict(world=args.world, backend=_backend(args.world, dev))
        _, stacked = run_any_engine(cfg, ticks, engine=args.engine, device=dev, **ranks)
    s = summarize(stacked)
    what = f"trace '{args.trace}'" if args.trace else f"scenario '{args.scenario}'"
    print(f"\n=== {args.minutes}-minute city-scale run — {what} ===")
    keys = ["read_miss_ratio", "sync_store_request_ratio",
            "wan_reduction_vs_baseline", "wan_bytes_per_tick",
            "lan_bytes_per_tick", "wire_bytes_per_tick", "writes_gen",
            "writes_drained", "final_queue_depth", "queue_dropped",
            "store_missing"]
    if cfg.workload.mutable:
        keys += ["coherence_updates", "writes_coalesced", "stale_reads",
                 "stale_read_ratio", "churn_rejoins"]
    for k in keys:
        print(f"{k:30s} {s[k]}")
    # Write-behind conservation: re-writes coalesced in the ring and
    # overflow drops are the only writes that never reach the drain.
    if (s["writes_drained"] + s["final_queue_depth"] + s["queue_dropped"]
            + s["writes_coalesced"] != s["writes_gen"]):
        raise AssertionError("write-behind conservation violated")
    print("\nFLIC rode out the outage: reads stayed fog-served, the queue "
          "absorbed writes, and the writer drained the backlog after recovery.")


if __name__ == "__main__":
    main()
