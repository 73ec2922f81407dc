"""The port's spans (``repro_torch/core/tracing.py``) under ``torch.profiler``.

One tick of a small fog, traced on the CPU, holds one ``sim.tick`` span,
the eleven ``tick.*`` stages in order inside it, and the coherence sweep's,
the payload hash's and the writer ring's spans inside the stages that call
them.  The stages
cover the tick: every aten op of the tick lies in exactly one of them.
Traced or not, a run computes the same bits, and with no profiler a span
is one shared null context that never enters ``record_function``.
"""
from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import simulator as tsim
from repro_torch.core import tracing
from repro_torch.core import workload as wl

STAGES = ["tick.start", "tick.write_rows", "tick.delivery", "tick.writes", "tick.enqueue",
          "tick.probe", "tick.backstop", "tick.fill", "tick.stale", "tick.drain",
          "tick.metrics"]
# Where each layer's span may sit: the spans that may hold it directly.
LAYER_PARENTS = {
    "flic.update": {"tick.writes"},
    "wl.payload": {"tick.write_rows", "tick.fill", "wl.payload"},
    "ring.enqueue": {"tick.enqueue"},
    "ring.backstop": {"tick.backstop"},
    "ring.drain": {"tick.drain"},
}
CASES = {
    "dense_zipf": dict(popularity="zipf", key_universe=256),
    "fanout_zipf": dict(popularity="zipf", key_universe=256, fanout=4),
    "dense_stream": dict(),
}


def config(case, backend=None):
    return tsim.SimConfig(n_nodes=24, cache_lines=16, workload=wl.WorkloadSpec(**CASES[case]),
                          probe_backend=backend)


def traced_tick(cfg, tmp_path):
    """The spans and aten ops of tick 3 (readers are due), as
    [(start_ns, end_ns, name, cat)] sorted by start, then longest first."""
    state, _ = tsim.run_sim(cfg, 3, seed=11, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tsim.run_sim(cfg, 1, seed=12, device="cpu", state=state)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op"):
            a = round(float(e["ts"]) * 1000)
            out.append((a, a + round(float(e.get("dur", 0)) * 1000), e["name"], e["cat"]))
    return sorted(out, key=lambda x: (x[0], -x[1]))


def parent(ev, spans):
    """The innermost span that holds ``ev``, or None."""
    holders = [s for s in spans if s is not ev and s[0] <= ev[0] and ev[1] <= s[1]]
    return min(holders, key=lambda s: s[1] - s[0])[2] if holders else None


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tick_holds_its_spans_nested(case, backend, tmp_path):
    cfg = config(case, backend)
    spans = [e for e in traced_tick(cfg, tmp_path) if e[3] == "user_annotation"]
    names = [s[2] for s in spans]
    assert names.count("sim.tick") == 1
    assert parent(spans[names.index("sim.tick")], spans) is None
    assert [n for n in names if n.startswith("tick.")] == STAGES
    assert {parent(s, spans) for s in spans if s[2].startswith("tick.")} == {"sim.tick"}

    layers = {n: {parent(s, spans) for s in spans if s[2] == n} for n in LAYER_PARENTS}
    expected = {"wl.payload", "ring.enqueue", "ring.backstop", "ring.drain"}
    if cfg.workload.mutable:
        expected.add("flic.update")
    assert {n for n, held in layers.items() if held} == expected
    for n in expected:
        assert layers[n] <= LAYER_PARENTS[n], (n, layers[n])


@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_cover_every_op_of_the_tick(case, tmp_path):
    events = traced_tick(config(case), tmp_path)
    (tick,) = [e for e in events if e[2] == "sim.tick"]
    stages = [e for e in events if e[2] in STAGES]
    ops = [e for e in events if e[3] == "cpu_op" and tick[0] <= e[0] and e[1] <= tick[1]]
    assert len(ops) > 100
    for op in ops:
        holders = [s[2] for s in stages if s[0] <= op[0] and op[1] <= s[1]]
        assert len(holders) == 1, (op, holders)


@pytest.mark.parametrize("case", ["dense_zipf", "fanout_zipf"])
def test_traced_run_is_bitwise_the_untraced_one(case):
    cfg = config(case, "plain")
    plain_state, plain_series = tsim.run_sim(cfg, 6, seed=21, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        state, series = tsim.run_sim(cfg, 6, seed=21, device="cpu")
    for f in plain_series.__dataclass_fields__:
        a, b = getattr(plain_series, f), getattr(series, f)
        assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                  b.view(-1).view(torch.uint8)), f
    want, got = tsim.state_to_numpy(plain_state), tsim.state_to_numpy(state)
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(want[k].reshape(-1).view(np.uint8),
                                      got[k].reshape(-1).view(np.uint8), err_msg=k)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("sim.tick") is tracing.span("tick.probe")
    assert isinstance(tracing.span("sim.tick"), contextlib.nullcontext)
    for case in CASES:
        tsim.run_sim(config(case, "plain"), 2, device="cpu")


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        assert isinstance(tracing.span("sim.tick"), torch.profiler.record_function)
    assert not torch.autograd._profiler_enabled()
