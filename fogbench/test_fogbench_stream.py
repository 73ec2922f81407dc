"""The write-once stream cell (``dense1k_stream``) on the CPU at a small size,
its control, and the two readers of the writer ring's spans.

At N = 64 the configured ring (8,192 rows, 64 a call) would never fill: 64
rows arrive and 64 drain each tick.  So the small cell also cuts the ring,
keeping the deployment's ratios: 16 rows arrive for each one an API call
drains (1,000 / 64 at full size) and the ring holds 8 ticks of writes
(8,192 / 1,000).  It saturates within a few ticks and then drops, as at
full size, so the FIFO overflow path runs every tick.

The hand-written stretch of the readers has two ticks, each laid out as
below (us from the tick's offset of 100 x its index; each launch a CUDA
call of 0.5 us whose device operation is matched to it by correlation id):

* ``sim.tick`` [10, 60];
* ``tick.enqueue`` [10, 20] holds ``ring.enqueue`` [11, 17]: launches at
  12 (a kernel of 2 us) and 15 (a copy of 0.5 us); a launch at 18 (a kernel
  of 3 us) lies outside the ring's span;
* ``tick.backstop`` [20, 30] holds ``ring.backstop`` [21, 25]: a launch at
  22, a kernel of 1 us;
* ``tick.drain`` [30, 50] holds ``ring.drain`` [31, 35] (a launch at 32, a
  kernel of 1.5 us) and ``ring.drain`` [40, 44] (a launch at 41, a fill of
  0.5 us); a launch at 37, a kernel of 4 us, lies between them.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import pytest

from fogbench import cells, check, control, control_stream, harness
from fogbench.test_fogbench_reference import cell_of, program_run
from fogbench.test_fogbench_spans import stretch, view_of

ROOT = Path(__file__).resolve().parent.parent
NAME = "dense1k_stream"
# The small ring: 8 ticks of 64 writes, 4 rows an API call.
SATURATING = dict(queue_capacity=512, writer_max_per_tick=4)
RING = ("ring_inline_ms_per_tick", "ring_host_ms_per_tick")
SEED = 4_200_000_131


def small_cell():
    cell = cells.load(ROOT, NAME)
    return dataclasses.replace(
        cell, config=dict(cell.config, n_nodes=64, **SATURATING),
        traffic=dict(cell.traffic, warmup_ticks=30, window_ticks_per_s=200, profile_ticks=3))


def test_cell_is_the_dense_deployment_under_the_paper_stream():
    bench = cells.benchmark(ROOT)
    cell, dense = cells.load(ROOT, NAME), cells.load(ROOT, "dense1k_ycsb_a")
    drop = ("guarantees", "assumed")
    assert ({k: v for k, v in cell.config.items() if k not in drop}
            == {k: v for k, v in dense.config.items() if k not in drop})
    assert cell.workload == {"popularity": "stream"}
    entry = next(w for w in bench["workloads"] if w["name"] == NAME)
    assert entry["chips"] == 1
    # Every per-layer metric with no list of cells, the ring's two among them.
    assert {m["name"] for m in cell.per_layer} == {
        m["name"] for m in bench["per_layer"] if "workloads" not in m}
    assert set(RING) <= {m["name"] for m in cell.per_layer}
    # 1,000 writes a tick and the due readers: 66 or 67, 1,066.67 a tick on average.
    assert cells.derived_ops(cell, 801, 15) == 15 * 1000 + 1000


@pytest.mark.parametrize("traced", [False, True])
def test_small_cell_is_correct_and_counts_its_ops(traced, tmp_path):
    cell = small_cell()
    res = harness.run_cell(tmp_path, NAME, SEED, 0.05, traced, "cpu", time.perf_counter(),
                           cell=cell)
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    first = cell.traffic["warmup_ticks"] + 1 + (cell.traffic["count_ticks"] if traced else 0)
    window = cell.traffic["profile_ticks"] if traced else 10
    assert res["attempted"] == cells.derived_ops(cell, first, window)
    if traced:
        # The host spans are read on the CPU; no device op ran, so the device reader is silent.
        assert res["metrics"]["ring_host_ms_per_tick"]["value"] > 0
        assert "ring_inline_ms_per_tick" not in res["metrics"]


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("ring", ["configured", "saturating"])
def test_reference_equals_run_sim(ring, backend):
    cell = cell_of("fog_dense_1k_stream", "stream", 64,
                   **(SATURATING if ring == "saturating" else {}))
    ticks = 40
    ref_series, ref_state = harness.replay_reference(cell, SEED, ticks, "cpu")
    series, state = program_run(cell, SEED, ticks, backend)
    counts, _ = check.compare(series, ref_series, state, ref_state)
    assert counts == {k: 0 for k in check.LIMITS}, counts
    assert int(ref_series["hits_fog"].sum()) > 0
    assert int(ref_series["coherence_updates"].sum()) == 0     # write-once: no sweep
    dropped = int(ref_series["queue_dropped"][-1])
    assert (dropped > 0) == (ring == "saturating"), dropped


def test_stream_control_fails_where_the_newest_copy_control_cannot():
    cell = small_cell()
    counts = control_stream.control_counts(cell, SEED, 60, "cpu")
    assert not check.verdict(counts)
    assert counts["series_mismatch"] > 0 and counts["ring_store_mismatch"] > 0, counts
    # control.py's fault lets the oldest responding copy answer; a write-once
    # row carries one timestamp in every copy, so the oldest copy is the newest.
    assert control.control_counts(cell, SEED, 60, "cpu") == {k: 0 for k in check.LIMITS}


def test_stream_control_leaves_the_reference_as_it_was():
    from fogbench.reference import fog

    saved = fog.enqueue
    with control_stream.overwriting_ring():
        assert fog.enqueue is control_stream.enqueue_overwriting
    assert fog.enqueue is saved


def ring_stretch():
    events = []
    corr = [0]

    def x(cat, name, a, b, **args):
        events.append({"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "args": args})

    def launch(at, kind, name, ts, dur):
        corr[0] += 1
        x("cuda_runtime", "cudaLaunchKernel", at, at + 0.5, correlation=corr[0])
        x(kind, name, ts, ts + dur, correlation=corr[0])

    def span(name, a, b):
        x("user_annotation", name, a, b)
        x("gpu_user_annotation", name, a + 1, b + 1)      # kineto's copy: not a span

    for i in range(2):
        o = 100.0 * i
        span("sim.tick", o + 10, o + 60)
        span("tick.enqueue", o + 10, o + 20)
        span("ring.enqueue", o + 11, o + 17)
        launch(o + 12, "kernel", "cumsum", o + 13, 2)
        launch(o + 15, "gpu_memcpy", "Memcpy DtoD", o + 16, 0.5)
        launch(o + 18, "kernel", "latest_ts_scatter", o + 19, 3)
        span("tick.backstop", o + 20, o + 30)
        span("ring.backstop", o + 21, o + 25)
        launch(o + 22, "kernel", "in_pending_and", o + 23, 1)
        span("tick.drain", o + 30, o + 50)
        span("ring.drain", o + 31, o + 35)
        launch(o + 32, "kernel", "drain_where", o + 33, 1.5)
        launch(o + 37, "kernel", "commit_writes", o + 38, 4)
        span("ring.drain", o + 40, o + 44)
        launch(o + 41, "gpu_memset", "Memset", o + 42, 0.5)
    return events


def readers():
    return {k: v for k, v in cells.layer_readers(cells.load(ROOT, NAME)).items() if k in RING}


@pytest.mark.parametrize("name, value", [
    ("ring_inline_ms_per_tick", 0.0055),       # 2 + 0.5 + 1 + 1.5 + 0.5 us; not 3 or 4
    ("ring_host_ms_per_tick", 0.018),          # 6 + 4 + 4 + 4 us
])
def test_ring_reader_on_a_hand_written_trace(tmp_path, name, value):
    view = view_of(tmp_path, ring_stretch(), ticks=2)
    assert readers()[name].read(view) == pytest.approx(value, rel=1e-9)


def test_ring_readers_find_nothing_without_the_ring_spans(tmp_path):
    # The stretch of a program with the stage spans and no ring spans (one before them).
    view = view_of(tmp_path, stretch())
    assert view.kernels()
    assert {name: r.read(view) for name, r in readers().items()} == dict.fromkeys(RING)
    view.path = None
    assert {name: r.read(view) for name, r in readers().items()} == dict.fromkeys(RING)
