"""A run of the benchmark on the CPU at a small size, and what makes it fail.

``harness.run_cell`` drives a whole run (set-up, window, traced stretch,
reference, comparison) past the look for a chip.  A sound program comes out
correct; the control (the oldest copy answers fog reads) and each fault of
the timed path that a cell can have come out not correct: a tick that
returns its state unchanged, half of the nodes' requests left out, an answer
altered where it is produced.  The command itself exits non-zero, printing
no result, without a card and without the program.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from fogbench import cells, control, harness

ROOT = Path(__file__).resolve().parent.parent
SMALL = {"dense1k_ycsb_a": dict(n_nodes=48), "city10k_zipf": dict(n_nodes=48, fanout=6)}


def small_cell(name):
    cell = cells.load(ROOT, name)
    return dataclasses.replace(
        cell, config=dict(cell.config, **SMALL[name]),
        traffic=dict(cell.traffic, warmup_ticks=30, window_ticks_per_s=200, profile_ticks=3))


def run(name, traced=False, seed=4_100_000_123):
    return harness.run_cell(ROOT, name, seed, 0.05, traced, "cpu", time.perf_counter(),
                            cell=small_cell(name))


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name, traced):
    res = run(name, traced)
    assert res["correct"] is True
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    if not traced:
        assert set(res["metrics"]) == {"ops_per_s", "setup_s"}   # no device peak on the CPU
        assert res["metrics"]["ops_per_s"]["value"] > 0


def test_control_is_not_correct():
    for name in SMALL:
        counts = control.control_counts(small_cell(name), 77, 60, "cpu")
        assert counts["series_mismatch"] > 0 and counts["caches_mismatch"] > 0, (name, counts)


def _state_unchanged(tick):
    # Only the tick count moves: run_sim numbers the next call's ticks by it.
    def broken(cfg, state, draws):
        _, metrics = tick(cfg, state, draws)
        return dataclasses.replace(state, tick=state.tick + 1), metrics
    return broken


def _half_left_out(tick):
    def broken(cfg, state, draws):
        plan = draws.plan
        half = torch.arange(plan.w_valid.shape[-1]) < plan.w_valid.shape[-1] // 2
        plan = dataclasses.replace(plan, w_valid=plan.w_valid & half, reading=plan.reading & half,
                                   slot_ok=plan.slot_ok & half[plan.slot_nid.long()])
        return tick(cfg, state, dataclasses.replace(draws, plan=plan))
    return broken


def _answer_altered(tick):
    def broken(cfg, state, draws):
        state, metrics = tick(cfg, state, draws)
        return state, dataclasses.replace(metrics, hits_fog=metrics.hits_fog + 1)
    return broken


def _payload_altered(tick):
    def broken(cfg, state, draws):
        state, metrics = tick(cfg, state, draws)
        data = state.caches.data.clone()
        data[0, 0, 0, 0] += 1.0
        return dataclasses.replace(state, caches=dataclasses.replace(state.caches, data=data)), metrics
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _answer_altered,
                                   _payload_altered])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_is_not_correct(name, fault, monkeypatch):
    from repro_torch.core import simulator

    monkeypatch.setattr(simulator, "sim_tick", fault(simulator.sim_tick))
    res = run(name)
    assert res["correct"] is False
    assert res["failed"] > 0


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "fogbench/run.py", "--workload", "city10k_zipf",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_command_without_a_card_prints_no_result():
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_command_with_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "fogbench", tmp_path / "fogbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_file_names_existing_files():
    bench = cells.benchmark(ROOT)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        json.loads((ROOT / c["file"]).read_text())
    for w in bench["workloads"]:
        assert (ROOT / "fogbench/traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"]:
        assert (ROOT / "fogbench/end_to_end" / f"{m['name']}.py").is_file()
    for m in bench["per_layer"]:
        assert (ROOT / "fogbench/layer_metrics" / f"{m['name']}.py").is_file()
