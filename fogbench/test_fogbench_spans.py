"""The span readers (``fogbench/spans.py`` and the six per-layer metrics that
read the program's spans) on a hand-written Chrome trace, and on a traced
CPU run of each small cell.

The hand-written stretch has three ticks, each laid out as below (us from
the tick's offset; ``[a, b]`` a span or aten op; each launch a CUDA call
of 0.5 us whose device operation is matched to it by correlation id):

* the feed's ``fogbench.draws`` [0, 6 | 8 | 10], holding a launch at 2 (its
  kernel is the draws');
* ``sim.tick`` [10, 50 | 60 | 70]:
  ``tick.write_rows`` [10, 11] holds ``wl.payload`` [10, 11] and, nested,
  ``wl.payload`` [10.2, 10.8]: launches at 10.1 and 10.5 (kernels at 11
  and 12, 1 us each) and at 10.3 (a fill);
  ``tick.delivery`` [11, 15]: aten op [11, 13], launch at 12, a kernel at 14 of 2 us;
  ``tick.writes`` [15, 30] holds ``flic.update`` [16, 29]: aten ops [17, 20]
  and [17.5, 19], launch at 18, a kernel of 3 us; launch at 25 of the
  ``flic_update`` kernel, 4 us;
  ``tick.probe`` [30, 45]: aten op [31, 34], launch at 32 of ``flic_lookup``,
  2 us; launch at 34, a copy of 0.5 us; aten op [41, 42], launch at 41, a
  kernel of 1.5 us;
  ``tick.metrics`` [45, end].
"""
from __future__ import annotations

import gzip
import json
import time
from pathlib import Path

import pytest

from fogbench import cells, harness, spans, trace
from fogbench.test_fogbench_harness import small_cell

ROOT = Path(__file__).resolve().parent.parent
NEW = ("tick_host_ms", "tick_dispatch_ms", "draws_host_ms_per_tick",
       "payload_hash_launches_per_tick", "sweep_inline_ms_per_tick", "probe_inline_ms_per_tick")
HOST = NEW[:3]
HAND = ("flic_insert", "flic_update", "flic_lookup")


def stretch(ticks=((6, 40), (8, 50), (10, 60)), program_spans=True):
    """Chrome trace events of the stretch; each tick (draws length, tick
    length) at offset 100 us x its index."""
    events = []
    corr = [0]

    def x(cat, name, a, b, **args):
        events.append({"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "args": args})

    def launch(at, kind, name, ts, dur):
        corr[0] += 1
        x("cuda_runtime", "cudaLaunchKernel", at, at + 0.5, correlation=corr[0])
        x(kind, name, ts, ts + dur, correlation=corr[0])

    def span(name, a, b):
        if program_spans:
            x("user_annotation", name, a, b)
            x("gpu_user_annotation", name, a + 1, b + 1)   # kineto's copy: not a span

    for i, (draws, length) in enumerate(ticks):
        o = 100.0 * i
        x("user_annotation", "fogbench.draws", o, o + draws)
        launch(o + 2, "kernel", "draws_kernel", o + 3, 1)
        span("sim.tick", o + 10, o + 10 + length)
        span("tick.write_rows", o + 10, o + 11)
        span("wl.payload", o + 10, o + 11)
        span("wl.payload", o + 10.2, o + 10.8)
        launch(o + 10.1, "kernel", "to_float", o + 11, 1)
        launch(o + 10.3, "gpu_memset", "Memset", o + 11.5, 0.2)
        launch(o + 10.5, "kernel", "hash_and", o + 12, 1)
        span("tick.delivery", o + 11, o + 15)
        x("cpu_op", "aten::ne", o + 11, o + 13)
        launch(o + 12, "kernel", "mask_and", o + 14, 2)
        span("tick.writes", o + 15, o + 30)
        span("flic.update", o + 16, o + 29)
        x("cpu_op", "aten::eq", o + 17, o + 20)
        x("cpu_op", "aten::empty", o + 17.5, o + 19)
        launch(o + 18, "kernel", "is_origin_eq", o + 20, 3)
        launch(o + 25, "kernel", "flic_update_sweep", o + 26, 4)
        span("tick.probe", o + 30, o + 45)
        x("cpu_op", "aten::index", o + 31, o + 34)
        launch(o + 32, "kernel", "flic_lookup_probe", o + 35, 2)
        launch(o + 34, "gpu_memcpy", "Memcpy DtoD", o + 38, 0.5)
        x("cpu_op", "aten::scatter_reduce", o + 41, o + 42)
        launch(o + 41, "kernel", "scatter_gather", o + 46, 1.5)
        span("tick.metrics", o + 45, o + 10 + length)
    return events


def view_of(tmp_path, events, ticks=3):
    path = tmp_path / "stretch.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return trace.parse(path, ticks, 1e-3, harness.DRAWS_SPAN, HAND)


def readers():
    return {k: v for k, v in cells.layer_readers(cells.load(ROOT, "dense1k_ycsb_a")).items()
            if k in NEW}


@pytest.mark.parametrize("name, value", [
    ("tick_host_ms", 0.050),                      # median of 40, 50, 60 us
    ("tick_dispatch_ms", 0.0109),                 # 0.9 + 2 + 3 + 0.5 + 3.5 + 1 us
    ("draws_host_ms_per_tick", 0.008),            # (6 + 8 + 10) us over 3 ticks
    ("payload_hash_launches_per_tick", 2.0),      # two kernels; the fill is no kernel
    ("sweep_inline_ms_per_tick", 0.005),          # 2 + 3 us; not flic_update's 4
    ("probe_inline_ms_per_tick", 0.002),          # 0.5 + 1.5 us; not flic_lookup's 2
])
def test_reader_on_a_hand_written_trace(tmp_path, name, value):
    assert readers()[name].read(view_of(tmp_path, stretch())) == pytest.approx(value, rel=1e-9)


def test_readers_find_nothing_without_the_program_spans(tmp_path):
    view = view_of(tmp_path, stretch(program_spans=False))
    assert view.ops and view.kernels()        # the device ops are there, the spans not
    # The feed's span is the benchmark's own: a program without spans has it.
    assert {name: r.read(view) for name, r in readers().items()} == dict(
        dict.fromkeys(NEW), draws_host_ms_per_tick=pytest.approx(0.008))
    view.path = None
    assert {name: r.read(view) for name, r in readers().items()} == dict.fromkeys(NEW)


def test_device_readers_find_nothing_without_device_ops(tmp_path):
    host_only = [e for e in stretch() if e["cat"] in ("user_annotation", "cpu_op")]
    values = {name: r.read(view_of(tmp_path, host_only)) for name, r in readers().items()}
    assert values["tick_host_ms"] == pytest.approx(0.050)
    assert values["tick_dispatch_ms"] == pytest.approx(0.009)    # the aten ops alone
    assert values["draws_host_ms_per_tick"] == pytest.approx(0.008)
    assert [values[n] for n in NEW[3:]] == [None] * 3


def test_summary_and_parse_once(tmp_path):
    view = view_of(tmp_path, stretch())
    sp = spans.load(view.path)
    assert spans.load(view.path) is sp
    assert sorted(sp.spans) == sorted(
        ["sim.tick", "tick.write_rows", "tick.delivery", "tick.writes", "tick.probe",
         "tick.metrics", "wl.payload", "flic.update", "fogbench.draws"])
    s = spans.summary(sp)
    assert s["ticks"] == 3 and s["tick_host_ms"] == pytest.approx([0.04, 0.05, 0.06])
    assert s["stages_over_tick"] == pytest.approx([1.0, 1.0])
    assert s["program_ops"] == 27 and s["launched_in_one_stage"] == 1.0
    assert s["unmatched_ops"] == 0 and s["ops_before_launch"] == 0
    assert s["stage_host_ms_per_tick"]["tick.probe"] == pytest.approx(0.015)
    # In tick.delivery [11, 15] the card runs [11, 13] (launched in the
    # payload hash) and [14, 16]: idle [13, 14], 1 us a tick.
    assert s["idle_ms_per_tick_by_stage"]["tick.delivery"] == pytest.approx(0.001)


@pytest.mark.parametrize("name", ["dense1k_ycsb_a", "city10k_zipf"])
def test_traced_cpu_run_reports_the_host_spans(name, tmp_path):
    cell = small_cell(name)
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    # Its own root: the trace goes under it, not where the harness tests write theirs.
    res = harness.run_cell(tmp_path, name, 2_900_000_017, 0.05, True, "cpu", time.perf_counter(),
                           cell=cell)
    assert (tmp_path / "build" / "fogbench" / f"{name}.trace.json.gz").is_file()
    assert res["correct"] is True
    for metric in HOST:
        assert res["metrics"][metric]["value"] > 0, metric
    assert res["metrics"]["tick_dispatch_ms"]["value"] < res["metrics"]["tick_host_ms"]["value"]
