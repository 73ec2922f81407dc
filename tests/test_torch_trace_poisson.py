"""The port's native Poisson and trace planning against ``repro.core.workload``.

The trace generators are host numpy seeded as JAX's, so a trace and every
field of a trace plan are JAX's bit for bit.  Poisson counts come from
``torch.poisson`` (JAX's distribution, not its numbers), so the Poisson and
trace runs are held to the tolerance tier of ``tests/conformance.py``:
PRNG-free counts exact, every generated write accounted for, ``writes_gen``
within 5 standard deviations, and the loss-coupled ratios within epsilons
set at about twice the largest delta measured at seeds 0 and 1 (Poisson:
miss 0.0952, stale 0.0143; trace: miss 0.0042, stale 0.0062).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from torch_parity import as_numpy, jax_draw_arrays, torch_config

from repro.core import metrics as jmet
from repro.core import simulator as jsim
from repro.core import workload as jwl
from repro_torch.core import simulator as tsim
from repro_torch.core import workload as twl
from repro_torch.core.metrics import summarize

N = 16


def _specs(source, **kw):
    trace = dict(source=source, length=40, read_fraction=0.4, zipf_alpha=0.99,
                 p2p_fraction=0.3, seed=3)
    trace.update(kw)
    return (jwl.WorkloadSpec(popularity="trace", key_universe=300, trace=jwl.TraceSpec(**trace)),
            twl.WorkloadSpec(popularity="trace", key_universe=300, trace=twl.TraceSpec(**trace)))


@pytest.mark.parametrize("n", [1, 16, 37])
@pytest.mark.parametrize("source", ["ycsb", "globetraff"])
def test_materialize_trace_bitwise(source, n):
    jspec, tspec = _specs(source)
    for want, got in zip(jwl.materialize_trace(jspec, n), twl.materialize_trace(tspec, n)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert twl.trace_length(tspec, n) == jwl.trace_length(jspec, n) == 40


def test_scenario_trace_is_jax_trace():
    spec = twl.SCENARIOS["trace_ycsb"]
    for want, got in zip(jwl.materialize_trace(jwl.SCENARIOS["trace_ycsb"], N),
                         twl.materialize_trace(spec, N)):
        np.testing.assert_array_equal(got, want)
    kids, ops = twl.trace_tensors(spec, N, "cpu")
    assert kids.dtype == ops.dtype == torch.int32 and kids.shape == (600, N)
    assert twl.trace_tensors(spec, N, "cpu")[0] is kids      # uploaded once


def test_npz_round_trip(tmp_path):
    _, tspec = _specs("globetraff")
    kids, ops = twl.materialize_trace(tspec, 5)
    path = str(tmp_path / "trace.npz")
    twl.save_trace_npz(path, kids, ops)
    jspec, tspec = _specs("npz", path=path)
    for want, got, orig in zip(jwl.materialize_trace(jspec, 5),
                               twl.materialize_trace(tspec, 5), (kids, ops)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, orig)
    assert twl.trace_length(tspec, 5) == 40
    # a rewritten file is read again (the cache key holds its mtime and size)
    twl.save_trace_npz(path, kids[:25], ops[:25])
    assert twl.trace_length(tspec, 5) == 25 == jwl.trace_length(jspec, 5)


def _bad_npz(tmp_path, case):
    path = str(tmp_path / f"{case}.npz")
    kids = np.zeros((6, 4), np.int32)
    ops = np.ones((6, 4), np.int32)
    if case == "missing":
        np.savez(path, key_ids=kids)
        return path
    if case == "shape":
        ops = ops[:5]
    elif case == "nodes":
        kids, ops = kids[:, :3], ops[:, :3]
    elif case == "range":
        kids[2, 1] = 300
    elif case == "ops":
        ops[0, 0] = 2
    np.savez(path, key_ids=kids, ops=ops)
    return path


@pytest.mark.parametrize("case", ["missing", "shape", "nodes", "range", "ops", "unreadable"])
def test_npz_loader_errors_match_jax(tmp_path, case):
    path = str(tmp_path / "absent.npz") if case == "unreadable" else _bad_npz(tmp_path, case)
    jspec, tspec = _specs("npz", path=path)
    with pytest.raises(ValueError) as want:
        jwl.trace_length(jspec, 4)
    with pytest.raises(ValueError) as got:
        twl.trace_length(tspec, 4)
    assert str(got.value) == str(want.value)


def test_validate_run_refuses_a_run_past_the_trace():
    jspec, tspec = _specs("ycsb")
    jcfg = jsim.SimConfig(n_nodes=4, workload=jspec)
    tcfg = torch_config(jcfg)
    twl.validate_run(tcfg, 40)
    with pytest.raises(ValueError) as want:
        jwl.validate_run(jcfg, 41)
    with pytest.raises(ValueError) as got:
        tsim.run_sim(tcfg, 41, device="cpu")
    assert str(got.value) == str(want.value)


PLAN_FIELDS = ("online", "rejoin", "w_keys", "w_kids", "w_valid", "reading", "r_keys",
               "r_kids", "r_enq_idx", "r_fill_ts", "r_src", "slot_id", "slot_nid", "slot_ok")


def test_trace_plan_fields_are_jax_plans():
    """The native plan of the ``trace`` conformance case draws nothing: every
    field equals the plan JAX's ``plan_tick`` made, tick by tick."""
    from conformance import CASES

    c = CASES["trace"]
    want = jax_draw_arrays(c.cfg, c.ticks, seed=0)
    tcfg = torch_config(c.cfg)
    gen = torch.Generator().manual_seed(0)
    state = twl.init_plan_state(tcfg, "cpu")
    for i, t in enumerate(want["t"].tolist()):
        plan = twl.plan_tick(tcfg, state, t, gen)
        for f in PLAN_FIELDS:
            w = want[f"plan.{f}"][i]
            np.testing.assert_array_equal(as_numpy(getattr(plan, f), like=w), w,
                                          err_msg=f"tick {t}: plan.{f}")
        for f in ("cum_writes", "enq_window"):
            np.testing.assert_array_equal(getattr(plan.state_next, f).numpy(),
                                          want[f"plan.state_next.{f}"][i], err_msg=f)
        state = plan.state_next


def test_trace_plan_past_the_end_repeats_the_last_row():
    """Past T the plan reads row T-1, as ``dynamic_index_in_dim`` clamps."""
    jspec, tspec = _specs("ycsb", length=5)
    jcfg = jsim.SimConfig(n_nodes=6, workload=jspec)
    tcfg = torch_config(jcfg)
    import jax

    jstate = jwl.init_plan_state(jcfg)
    for t in (4, 5, 9):
        jp = jwl.plan_tick(jcfg, jstate, t, jax.random.PRNGKey(0))
        tp = twl.plan_tick(tcfg, twl.init_plan_state(tcfg, "cpu"), t,
                           torch.Generator().manual_seed(0))
        for f in ("w_kids", "w_valid", "reading", "r_kids", "slot_ok"):
            w = np.asarray(getattr(jp, f))
            np.testing.assert_array_equal(as_numpy(getattr(tp, f), like=w), w, err_msg=f)


def test_poisson_counts_have_the_rate_as_mean():
    spec = twl.SCENARIOS["poisson"]
    gen = torch.Generator().manual_seed(0)
    counts = twl.poisson_counts(spec, gen, 100_000)
    assert counts.dtype == torch.int32 and int(counts.min()) >= 0
    se = math.sqrt(spec.poisson_rate / counts.numel())
    assert abs(float(counts.double().mean()) - spec.poisson_rate) <= 4 * se


def test_poisson_plan_fills_a_prefix_of_lanes():
    cfg = torch_config(jsim.SimConfig(n_nodes=64, workload=jwl.SCENARIOS["poisson"]))
    gen = torch.Generator().manual_seed(1)
    plan = twl.plan_tick(cfg, twl.init_plan_state(cfg, "cpu"), 3, gen)
    p = cfg.workload.max_requests_per_tick
    assert plan.w_valid.shape == plan.w_kids.shape == (p, 64)
    lanes = plan.w_valid.to(torch.int32)
    assert torch.equal(lanes, lanes.cummin(dim=0).values)       # a prefix per node
    assert 0 < int(lanes.sum()) < p * 64
    assert int(plan.w_kids.min()) >= 0 and int(plan.w_kids.max()) < cfg.workload.key_universe


# (miss, stale) epsilons: about twice the largest delta at seeds 0 and 1.
TOLERANCE = {"poisson": (0.19, 0.03), "trace": (0.009, 0.013)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["poisson", "trace"])
def test_native_run_within_tolerance_of_jax(case, seed):
    from conformance import CASES

    c = CASES[case]
    want = jmet.summarize(jsim.run_sim(c.cfg, c.ticks, seed)[1])
    got = summarize(tsim.run_sim(torch_config(c.cfg), c.ticks, seed, device="cpu")[1])
    for k in ("ticks", "reads", "churn_rejoins"):
        assert got[k] == want[k], k
    assert got["writes_gen"] == (got["writes_drained"] + got["final_queue_depth"]
                                 + got["queue_dropped"] + got["writes_coalesced"])
    if case == "trace":
        assert got["writes_gen"] == want["writes_gen"]
    else:
        rate = c.cfg.workload.poisson_rate
        assert abs(got["writes_gen"] - want["writes_gen"]) <= 5 * math.sqrt(
            2 * c.cfg.n_nodes * c.ticks * rate)
    miss_eps, stale_eps = TOLERANCE[case]
    assert abs(got["read_miss_ratio"] - want["read_miss_ratio"]) <= miss_eps
    assert abs(got["stale_read_ratio"] - want["stale_read_ratio"]) <= stale_eps
    assert got["coherence_updates"] > 0 and got["reads"] > 0


def test_run_any_engine_windows_and_mesh_engines():
    cfg = torch_config(jsim.SimConfig(n_nodes=8, cache_lines=32))
    with pytest.raises(ValueError, match="divisible by metrics_every"):
        tsim.run_any_engine(cfg, 10, engine="reference", metrics_every=3, device="cpu")
    for engine in ("distributed", "sharded"):
        with pytest.raises(ValueError, match="needs world= and backend="):
            tsim.run_any_engine(cfg, 10, engine=engine, device="cpu")
    with pytest.raises(ValueError, match="supports mutable zipf-cadence"):
        tsim.run_any_engine(cfg, 10, engine="sharded", world=2, backend="gloo", device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        tsim.run_any_engine(cfg, 10, engine="pipelined", device="cpu")
    _, a = tsim.run_any_engine(cfg, 10, 2, engine="reference", metrics_every=5, device="cpu")
    _, b = tsim.run_any_engine(cfg, 10, 2, engine="fused", metrics_every=5, device="cpu")
    _, c = tsim.run_any_engine(cfg, 10, 2, engine="distributed", metrics_every=5,
                               world=2, backend="gloo", device="cpu")
    assert a.reads.shape == (2,)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
        if f.name != "wire_bytes":
            assert torch.equal(getattr(c, f.name), getattr(b, f.name)), f.name
