"""Cells, configurations, traffic mixes and metrics, found by name.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix.  A configuration is the JSON file its entry names; a traffic mix is
``fogbench/traffic/<traffic>.json``; an end-to-end metric is read by
``fogbench/end_to_end/<name>.py`` and a per-layer metric by
``fogbench/layer_metrics/<name>.py``, each a module with ``read(x)`` that
returns the value or ``None`` where it finds nothing to read.  A per-layer
reader that counts a kernel's work names the kernel (``KERNEL``) and counts
it from the kernel's arguments (``work(args, cell)``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict          # the configuration file as it is run
    traffic: dict         # the traffic file
    end_to_end: list      # BENCHMARK.json's metrics this cell reports
    per_layer: list

    @property
    def workload(self) -> dict:
        return self.traffic["workload"]


@dataclasses.dataclass
class WindowRun:
    """What a measured window gives the end-to-end readers."""
    window_s: float
    ops: int
    peak_bytes: int
    setup_s: float
    ticks: int


def benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, name: str) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(
        name=name, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def _module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(f"{prefix}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_readers(cell: Cell) -> dict:
    """Name -> reader module of each per-layer metric the cell reports."""
    return {m["name"]: _module(HERE / "layer_metrics" / f"{m['name']}.py", "fogbench_layer")
            for m in cell.per_layer}


def read_end_to_end(cell: Cell, run: WindowRun) -> dict:
    return {m["name"]: _module(HERE / "end_to_end" / f"{m['name']}.py", "fogbench_e2e").read(run)
            for m in cell.end_to_end}


def derived_ops(cell: Cell, first: int, ticks: int) -> int | None:
    """Fog operations of ticks ``[first, first + ticks)`` worked out from the
    traffic's parameters alone, where they fix the count: one operation a
    node a tick on a trace; on a steady, churn-free cadence one write a node
    a tick plus the nodes whose read falls due.  None where the count is
    drawn (Poisson arrivals) or varies with the rate or membership."""
    wl = cell.workload
    n = cell.config["n_nodes"]
    steady = wl.get("rate", "steady") == "steady" and wl.get("churn_period", 0) == 0
    if not steady or wl.get("arrivals", "cadence") != "cadence":
        return None
    if wl.get("popularity") == "trace":
        return n * ticks
    p = cell.config["read_period"]
    # node i reads at tick t > 0 iff (t + i) % p == 0: the ids -t mod p, + p, ...
    reads = sum((n - 1 - (-t) % p) // p + 1 for t in range(max(first, 1), first + ticks)
                if (-t) % p < n)
    return n * ticks + reads
