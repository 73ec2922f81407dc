"""The benchmark's traffic generator against the port's planner, on the CPU.

The generator is a frozen copy of ``core/workload.py::plan_tick`` and of
``core/simulator.py::draw_tick``: on one seed both give the same plans and
uniforms, bit for bit, on every kind of mix; a trace's rows drawn block by
block are ``materialize_trace``'s.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fogbench import program
from fogbench.traffic.generator import TraceRows, Spec, Traffic

ROOT = Path(__file__).resolve().parent.parent
MIXES = {
    "zipf": {"popularity": "zipf", "key_universe": 512, "zipf_alpha": 0.9},
    "ycsb": {"popularity": "trace", "key_universe": 256,
             "trace": {"source": "ycsb", "read_fraction": 0.5, "zipf_alpha": 0.99}},
    "globetraff": {"popularity": "trace", "key_universe": 256,
                   "trace": {"source": "globetraff", "read_fraction": 0.3, "zipf_alpha": 0.9}},
    "poisson": {"popularity": "zipf", "key_universe": 256, "arrivals": "poisson",
                "poisson_rate": 1.0, "max_requests_per_tick": 4},
    "stream": {},
    "stream_churn": {"churn_period": 7, "churn_fraction": 0.2},
    "storm": {"popularity": "zipf", "key_universe": 128, "zipf_alpha": 1.1, "rate": "bursty",
              "rate_period": 8, "rate_duty": 0.5, "churn_period": 6, "churn_fraction": 0.25},
    "diurnal": {"popularity": "zipf", "key_universe": 128, "rate": "diurnal", "rate_period": 12},
}


def small_config(loss="gilbert_elliott", fanout=None, n=48):
    config = json.loads((ROOT / "fogbench/configs/fog_dense_1k.json").read_text())
    config.update(n_nodes=n, loss_model=loss, fanout=fanout, read_window_keys=200)
    config["store"] = dict(config["store"], collision_prob=0.1)
    return config


@pytest.mark.parametrize("fanout", [None, 6])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_generator_equals_the_port_planner(mix, fanout):
    from repro_torch.core import simulator as sim

    config = small_config(fanout=fanout)
    workload = MIXES[mix]
    seed = 2**31 + 12345
    ticks = 20
    cfg = program.sim_config(config, workload, seed, trace_ticks=ticks)
    traffic = Traffic(config, workload, seed, "cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    plan_state = sim.init_sim(cfg, "cpu").plan
    for t in range(ticks):
        want = sim.draw_tick(cfg, plan_state, t, gen)
        plan, uniforms = traffic.tick(t)
        got = program.tick_draws(t, plan, uniforms)
        got_fields = program.flat(got)
        for name, a in program.flat(want).items():
            b = got_fields[name]
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (mix, t, name)
            else:
                assert a == b, (mix, t, name)
        plan_state = want.plan.state_next


@pytest.mark.parametrize("mix", ["ycsb", "globetraff"])
def test_trace_rows_in_blocks_equal_materialize_trace(mix):
    from repro_torch.core import workload as wl

    n, seed = 37, 987654321012
    spec = Spec(dict(MIXES[mix], trace=dict(MIXES[mix]["trace"], seed=seed)))
    rows = TraceRows(spec, n)
    parts = [rows.next_rows(k) for k in (1, 5, 1, 13)]
    kids = np.concatenate([p[0] for p in parts])
    ops = np.concatenate([p[1] for p in parts])
    trace = wl.TraceSpec(**dict(MIXES[mix]["trace"], length=20, seed=seed))
    want = wl.materialize_trace(wl.WorkloadSpec(popularity="trace", key_universe=256,
                                                trace=trace), n)
    np.testing.assert_array_equal(kids, want[0])
    np.testing.assert_array_equal(ops, want[1])


def test_ticks_come_in_order():
    traffic = Traffic(small_config(), MIXES["zipf"], 1, "cpu")
    traffic.tick(0)
    with pytest.raises(ValueError):
        traffic.tick(2)
