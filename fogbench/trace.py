"""The traced stretch: ``torch.profiler`` over a few ticks of ``run_sim``,
read back from its Chrome trace.

``traced_window`` runs the stretch, writes the trace, gzipped, into the
checkout's ``build/fogbench/`` and returns a ``View`` of it: every device operation
(kernels, copies, fills) with its time, whether the benchmark's own draws
launched it (its launch lies inside the draws span, matched by the
profiler's correlation id) and whether it is one of the program's
hand-written kernels (by name); the device's busy time (the union of the
operations' intervals) and the host time of the stretch.  The per-layer
readers (``fogbench/layer_metrics/``) take their numbers from it.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import subprocess
import time
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    ts: float        # us
    dur: float       # us
    draws: bool      # launched inside the benchmark's draws span
    hand: bool       # one of the program's hand-written kernels


@dataclasses.dataclass
class View:
    ticks: int
    window_s: float
    ops: list
    busy_s: float
    gaps: list            # [(label, seconds)] the longest device idle stretches
    path: Path = None
    captured: dict = dataclasses.field(default_factory=dict)
    cell: object = None

    def kernels(self) -> list:
        """The program's kernels: those the benchmark's draws launched left out."""
        return [o for o in self.ops if o.cat == "kernel" and not o.draws]

    def named(self, part: str) -> list:
        return [o for o in self.ops if o.cat == "kernel" and part in o.name]

    def breakdown(self) -> dict:
        by_name = {}
        for o in self.ops:
            by_name[o.name] = by_name.get(o.name, 0.0) + o.dur / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:160], s] for name, s in top],
                "idle_gaps": [[label[:160], s] for label, s in self.gaps[:TOP]]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def parse(path: Path, ticks: int, window_s: float, draws_span: str, hand_names) -> View:
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == draws_span]
    launched_in_draws = set()
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            if any(a <= e["ts"] <= b for a, b in spans):
                launched_in_draws.add(e["args"]["correlation"])
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            corr = e.get("args", {}).get("correlation")
            ops.append(Op(name=e["name"], cat=e["cat"], ts=float(e["ts"]), dur=float(e["dur"]),
                          draws=corr in launched_in_draws,
                          hand=any(h in e["name"] for h in hand_names)))
    busy = _union([(o.ts, o.ts + o.dur) for o in ops])
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                   for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"),
                  key=lambda x: x[0])
    gaps = []
    if busy and host:
        edges = [(host[0][0], host[0][0])] + busy + [(max(h[1] for h in host),) * 2]
        idle = sorted(((b - a, a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a),
                      reverse=True)[:TOP]
        for length, a, b in idle:
            # What the host was doing: the innermost op or span around the gap's middle.
            mid = (a + b) / 2
            inside = [h for h in host if h[0] <= mid <= h[1]]
            label = min(inside, key=lambda h: h[1] - h[0])[2] if inside else "host: between ops"
            gaps.append((label, length / 1e6))
    return View(ticks=ticks, window_s=window_s, ops=ops,
                busy_s=sum(b - a for a, b in busy) / 1e6, gaps=gaps, path=Path(path))


def traced_window(fn, device, ticks: int, path: Path, draws_span: str, hand_names):
    """Run ``fn()`` (``ticks`` ticks; returns (state, series)) under the
    profiler; returns (state, series, view)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        h0 = time.perf_counter()
        state, series = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - h0
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return state, series, parse(path, ticks, window_s, draws_span, hand_names)


def power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, else None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
