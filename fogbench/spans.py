"""The program's own spans in a traced stretch, read from its Chrome trace.

The port marks its tick with ``torch.profiler.record_function`` spans
(``repro_torch/core/tracing.py``) while a profiler records: ``sim.tick``
once a tick in ``run_sim``, one top-level ``tick.<stage>`` span a stage of
``sim_tick``, ``flic.update`` around the coherence sweep and ``wl.payload``
around the payload hash.  The benchmark's feed makes each tick's draws
inside its own ``fogbench.draws`` span (``harness.DRAWS_SPAN``).  They land
in the trace as ``user_annotation`` events, on the clock of the device
operations.  Kineto also copies each span onto the device's timeline as
``gpu_user_annotation``; those copies are not spans and are left out.

A device operation belongs to the spans its launch lies in: its CUDA
runtime call, matched by the profiler's correlation id.  Where
the program has no such span (a program before the spans), or no device
operation ran (the CPU), the readers of ``fogbench/layer_metrics/`` find
nothing and return None.

    python3 -m fogbench.spans <trace.json.gz> ...

prints, for each trace, what ``summary`` gives: the stages' host ms and the
card's idle ms a tick by the stage the host was in, and how far the spans
cover the tick and its launches.
"""
from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
import sys
from pathlib import Path

from fogbench import trace
from fogbench.harness import DRAWS_SPAN as DRAWS

TICK = "sim.tick"
STAGE = "tick."
SPAN_CAT = "user_annotation"
HOST_OP_CATS = ("cpu_op", "cuda_runtime")
LAUNCH_CAT = "cuda_runtime"


@dataclasses.dataclass
class DeviceOp:
    name: str
    cat: str
    ts: float              # us
    dur: float             # us
    launch: float | None   # us: its launch call's start, None where unmatched


@dataclasses.dataclass
class Spans:
    spans: dict            # name -> sorted [(start, end)] in us
    host_ops: list         # sorted [(start, end)]: aten ops and CUDA API calls
    device: list           # [DeviceOp]

    def of(self, *names) -> list:
        return sorted(iv for n in names for iv in self.spans.get(n, ()))

    def stages(self) -> list:
        """The ``tick.*`` spans (disjoint: the program nests none), as sorted
        [(start, end, name)]."""
        return sorted((a, b, n) for n, ivs in self.spans.items() if n.startswith(STAGE)
                      for a, b in ivs)

    def launched_in(self, *names) -> list:
        """The device operations whose launch lies in a span of ``names``."""
        spans = union(self.of(*names))
        return [o for o in self.device if o.launch is not None and inside(o.launch, spans)]


def union(intervals) -> list:
    """The union of intervals as sorted, disjoint (start, end) pairs."""
    return [tuple(iv) for iv in trace._union(intervals)]


def inside(x: float, disjoint: list) -> bool:
    """Whether ``x`` lies in one of the sorted, disjoint intervals."""
    i = bisect.bisect_right(disjoint, (x, float("inf"))) - 1
    return i >= 0 and disjoint[i][0] <= x <= disjoint[i][1]


def covered(disjoint: list, a: float, b: float) -> float:
    """Length of ``[a, b]`` that the sorted, disjoint intervals cover."""
    i = max(bisect.bisect_right(disjoint, (a, float("inf"))) - 1, 0)
    total = 0.0
    for lo, hi in disjoint[i:]:
        if lo >= b:
            break
        total += max(0.0, min(hi, b) - max(lo, a))
    return total


_CACHE: dict = {}


def load(path) -> Spans | None:
    """The spans of the gzipped Chrome trace at ``path``, parsed once per
    file; None where there is no trace."""
    if path is None or not Path(path).is_file():
        return None
    st = Path(path).stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = _parse(path)
    return _CACHE[key]


def _parse(path) -> Spans:
    with gzip.open(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans, host, launches, device = {}, [], {}, []
    for e in events:
        cat, a = e.get("cat"), float(e["ts"])
        b = a + float(e.get("dur", 0))
        if cat == SPAN_CAT:
            spans.setdefault(e["name"], []).append((a, b))
        elif cat in HOST_OP_CATS:
            host.append((a, b))
            if cat == LAUNCH_CAT and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = a
        elif cat in trace.DEVICE_CATS:
            device.append((e, a, b - a))
    ops = [DeviceOp(e["name"], e["cat"], a, dur,
                    launches.get(e.get("args", {}).get("correlation")))
           for e, a, dur in device]
    return Spans(spans={n: sorted(v) for n, v in spans.items()}, host_ops=sorted(host),
                 device=ops)


def device_ms_per_tick(ops: list, ticks: int) -> float | None:
    return sum(o.dur for o in ops) / 1e3 / ticks if ops else None


def summary(sp: Spans) -> dict:
    """What the spans say of a stretch: ms a tick of each stage's host time
    and of the card's idle time by the stage the host was in (``draws``:
    inside the feed's ``fogbench.draws``; ``loop``: outside every stage and the draws), and
    the checks that the spans cover the tick and its launches."""
    ticks = sp.of(TICK)
    n = max(len(ticks), 1)
    stages = sp.stages()
    host_ms = {}
    for a, b, name in stages:
        host_ms[name] = host_ms.get(name, 0.0) + (b - a) / 1e3 / n
    busy = union((o.ts, o.ts + o.dur) for o in sp.device)
    starts = [a for a, _ in sp.host_ops] + [a for a, _ in sp.of(TICK, DRAWS)]
    ends = [b for _, b in sp.host_ops] + [b for _, b in sp.of(TICK, DRAWS)]
    idle = []
    if starts:
        lo, hi = min(starts), max(ends)
        edges = [(lo, lo)] + [iv for iv in busy if iv[1] > lo and iv[0] < hi] + [(hi, hi)]
        idle = [(max(a, lo), min(b, hi)) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
    idle_ms = {}
    where = [(a, b, name) for a, b, name in stages] + [(a, b, "draws") for a, b in sp.of(DRAWS)]
    for a, b, name in where:
        idle_ms[name] = idle_ms.get(name, 0.0) + covered(idle, a, b) / 1e3 / n
    idle_ms["loop"] = sum(b - a for a, b in idle) / 1e3 / n - sum(idle_ms.values())

    # Of the program's device operations (not the draws'), the share whose
    # launch lies in a stage span (they are disjoint: in exactly one); those
    # that start before their launch would say the two clocks differ.
    draws = union(sp.of(DRAWS))
    mine = [o for o in sp.device if o.launch is not None and not inside(o.launch, draws)]
    stage_ivs = [(a, b) for a, b, _ in stages]
    in_one = sum(1 for o in mine if inside(o.launch, stage_ivs))
    stage_sum = [sum(max(0.0, min(sb, b) - max(sa, a)) for sa, sb, _ in stages) / (b - a)
                 for a, b in ticks if b > a]
    return {
        "ticks": len(ticks),
        "tick_host_ms": [(b - a) / 1e3 for a, b in ticks],
        "stage_host_ms_per_tick": host_ms,
        "idle_ms_per_tick_by_stage": idle_ms,
        "stages_over_tick": [min(stage_sum), max(stage_sum)] if stage_sum else None,
        "program_ops": len(mine),
        "launched_in_one_stage": in_one / len(mine) if mine else None,
        "unmatched_ops": sum(1 for o in sp.device if o.launch is None),
        "ops_before_launch": sum(1 for o in sp.device
                                 if o.launch is not None and o.ts < o.launch),
    }


def main(argv) -> int:
    for path in argv:
        sp = load(path)
        print(json.dumps({"trace": path, **summary(sp)}, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
