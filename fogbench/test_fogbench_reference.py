"""The benchmark's reference against the port's ``run_sim``, on the CPU.

At a small N, both configurations' traffic and the mixes that later cells
will bring (the write-once stream, churn and bursts, Poisson waves, the
replicate policy, an outage, store collisions, the Gilbert-Elliott channel) run through the program's
fused engine (``probe_backend`` None and "plain") and through the reference
on the same draws: the per-tick series and the final state are equal, bit
for bit.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from fogbench import check, harness, program
from fogbench.cells import Cell
from fogbench.traffic.generator import Traffic

ROOT = Path(__file__).resolve().parent.parent


def cell_of(config_name, traffic_name, n, fanout=None, **config_changes):
    config = json.loads((ROOT / "fogbench/configs" / f"{config_name}.json").read_text())
    config.update(n_nodes=n, **config_changes)
    if fanout is not None or "fanout" in config_changes:
        config["fanout"] = fanout
    traffic = json.loads((ROOT / "fogbench/traffic" / f"{traffic_name}.json").read_text())
    return Cell(name=f"{config_name}.{traffic_name}", config=config, traffic=traffic,
                end_to_end=[], per_layer=[])


def with_workload(cell, **workload):
    return dataclasses.replace(cell, traffic=dict(cell.traffic, workload=workload))


CASES = {
    "dense1k_ycsb_a": lambda: cell_of("fog_dense_1k", "ycsb_a", 64),
    "city10k_zipf": lambda: cell_of("fog_city_10k_k32", "zipf", 64, fanout=8),
    "dense_gilbert_elliott": lambda: cell_of("fog_dense_1k", "ycsb_a", 48,
                                             loss_model="gilbert_elliott"),
    "city_stream": lambda: with_workload(cell_of("fog_city_10k_k32", "zipf", 64, fanout=8)),
    "dense_storm": lambda: with_workload(
        cell_of("fog_dense_1k", "ycsb_a", 48), popularity="zipf", key_universe=128,
        zipf_alpha=1.1, rate="bursty", rate_period=8, rate_duty=0.5, churn_period=10,
        churn_fraction=0.25),
    "city_storm": lambda: with_workload(
        cell_of("fog_city_10k_k32", "zipf", 48, fanout=6), popularity="zipf",
        key_universe=128, zipf_alpha=1.1, rate="bursty", rate_period=8, rate_duty=0.5,
        churn_period=10, churn_fraction=0.25),
    "dense_poisson_outage": lambda: with_workload(
        cell_of("fog_dense_1k", "ycsb_a", 40, outage_schedule=[[12, 9]]),
        popularity="zipf", key_universe=96, arrivals="poisson", poisson_rate=1.0,
        max_requests_per_tick=4),
    "dense_replicate": lambda: with_workload(
        cell_of("fog_dense_1k", "ycsb_a", 24, insert_policy="replicate",
                loss_model="bernoulli", loss_prob=0.1)),
    "stream_churn_collisions": lambda: with_workload(
        cell_of("fog_dense_1k", "ycsb_a", 40, loss_model="none",
                store=dict(kind="db", row_bytes=148, api_rate_per_tick=0.5, api_burst=3.0,
                           write_latency_ticks=1.3, read_latency_ticks=0.9,
                           collision_prob=0.3)),
        churn_period=9, churn_fraction=0.2),
}


def program_run(cell, seed, ticks, backend):
    cfg = dataclasses.replace(program.sim_config(cell.config, cell.workload, seed, ticks),
                              probe_backend=backend)
    traffic = Traffic(cell.config, cell.workload, seed, "cpu")
    feed = harness.Feed(traffic)
    state, series = program.run(cfg, ticks, feed.ticks(0, ticks), None, "cpu")
    return program.to_host(program.flat(series)), program.to_host(program.flat(state))


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_run_sim(case, backend):
    cell = CASES[case]()
    seed, ticks = 3_000_000_007, 40
    ref_series, ref_state = harness.replay_reference(cell, seed, ticks, "cpu")
    series, state = program_run(cell, seed, ticks, backend)
    counts, _ = check.compare(series, ref_series, state, ref_state)
    assert counts == {k: 0 for k in check.LIMITS}, counts
    assert int(ref_series["reads"].sum()) > 0 and int(ref_series["writes_gen"].sum()) > 0
    if cell.workload.get("popularity") in ("zipf", "trace"):
        assert int(ref_series["coherence_updates"].sum()) > 0
        assert int(ref_series["hits_fog"].sum()) > 0


def test_oldest_election_differs():
    """The control (the oldest responding copy answers) reads other series
    and tables than the reference on the same draws."""
    cell = CASES["dense1k_ycsb_a"]()
    ref = harness.replay_reference(cell, 5, 60, "cpu")
    ctl = harness.replay_reference(cell, 5, 60, "cpu", elect="oldest")
    counts, _ = check.compare(ctl[0], ref[0], ctl[1], ref[1])
    assert counts["series_mismatch"] > 0 and counts["caches_mismatch"] > 0


def test_check_counts_bits_and_missing_paths():
    a = {"x": torch.tensor([0.0, 1.0]), "n": torch.tensor([1, 2], dtype=torch.int32)}
    b = {"x": torch.tensor([-0.0, 1.0]), "n": torch.tensor([1, 2], dtype=torch.int32)}
    counts, bad = check.compare(a, b, {"caches.tags": torch.zeros(3)},
                                {"caches.tags": torch.zeros(3), "queue.head": torch.zeros(())})
    assert counts == {"series_mismatch": 1, "caches_mismatch": 0, "ring_store_mismatch": 1}
    assert bad.tolist() == [True, False]
