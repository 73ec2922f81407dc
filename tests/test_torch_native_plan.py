"""The port's native planner (a ``torch.Generator``, not JAX's PRNG).

It samples the same distributions as JAX, not the same numbers, so it is
held to what no random draw decides: the tick and read counts and the
writes generated are exact, and every generated write is accounted for.
Poisson arrivals, whose write counts are drawn, are held in
``test_torch_trace_poisson.py``.
"""
import dataclasses

import pytest
import torch
from torch_parity import torch_config

from repro.core import metrics as jmet
from repro.core import simulator as jsim
from repro.core import workload as jwl
from repro_torch.core import simulator as tsim
from repro_torch.core import workload as twl
from repro_torch.core.metrics import summarize

NATIVE = ("paper", "zipf_hot", "zipf", "bursty", "churn", "storm", "stream_churn",
          "trace_ycsb")


def _cfg(scenario, **kw):
    return jsim.SimConfig(n_nodes=16, cache_lines=64, workload=jwl.SCENARIOS[scenario], **kw)


@pytest.mark.parametrize("scenario", NATIVE)
def test_native_plan_counts_match_jax(scenario):
    jcfg = _cfg(scenario, outage_schedule=((30, 20),))
    ticks = 120
    _, js = jsim.run_sim(jcfg, ticks, seed=0)
    want = jmet.summarize(js)
    _, ts = tsim.run_sim(torch_config(jcfg), ticks, seed=0, device="cpu")
    got = summarize(ts)
    for k in ("ticks", "reads", "writes_gen", "churn_rejoins"):
        assert got[k] == want[k], k
    assert got["writes_gen"] == (got["writes_drained"] + got["final_queue_depth"]
                                 + got["queue_dropped"] + got["writes_coalesced"])
    assert got["reads"] > 0


def test_native_plan_is_reproducible_per_seed():
    cfg = torch_config(_cfg("zipf_hot"))
    a = tsim.run_sim(cfg, 30, seed=3, device="cpu")[1]
    b = tsim.run_sim(cfg, 30, seed=3, device="cpu")[1]
    c = tsim.run_sim(cfg, 30, seed=4, device="cpu")[1]
    assert torch.equal(a.hits_fog, b.hits_fog) and torch.equal(a.lan_bytes, b.lan_bytes)
    assert not torch.equal(a.coherence_updates, c.coherence_updates)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.run_sim(tsim.SimConfig(n_nodes=4), 1)


def test_diurnal_rate_mask_matches_jax():
    spec = twl.SCENARIOS["diurnal"]
    jspec = jwl.SCENARIOS["diurnal"]
    for t in range(0, 480, 7):
        want = jwl.rate_mask(jspec, 50, t)
        assert twl.rate_mask(spec, 50, t, "cpu").tolist() == [bool(x) for x in want], t


@pytest.mark.parametrize("scenario", ["churn", "storm", "stream_churn"])
def test_membership_masks_match_jax(scenario):
    spec, jspec = twl.SCENARIOS[scenario], jwl.SCENARIOS[scenario]
    for t in range(0, 260, 5):
        for fn, jfn in ((twl.online_mask, jwl.online_mask), (twl.rejoin_mask, jwl.rejoin_mask),
                        (twl.rate_mask, jwl.rate_mask)):
            assert fn(spec, 20, t, "cpu").tolist() == [bool(x) for x in jfn(jspec, 20, t)]


def test_workload_specs_are_copies():
    assert {k: dataclasses.asdict(v) for k, v in twl.SCENARIOS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jwl.SCENARIOS.items()}
    with pytest.raises(ValueError, match="fanout"):
        twl.WorkloadSpec(fanout=0)
