"""The example drivers on the port (``repro_torch.examples``) against the
JAX package's (``examples/*.py``), each run in this process at its
smallest arguments with ``--device cpu``, its standard output compared
line by line with the JAX driver's.

Lines that depend on no draw are equal.  Where the numbers come from the
simulator's draws, which torch does not replay (JAX's threefry), they are
held to the native-draw tolerance tier of ``tests/conformance.py``: counts
that depend on no draw exact, every generated write accounted for, and the
loss-coupled ratios within epsilons (the tier's ``SHARDED_CASES`` rows for
the city runs; 0.01 for the quickstart's three ratios, at least 5x the
deltas measured at seed 0).  The weights of ``serve_paged`` and ``train_lm`` come
from ``torch.Generator``, so their tokens and losses are not JAX's; their
counts, schedules and the page manager's stats are.  ``train_lm`` is held in
``test_torch_examples_train.py``, so the test workers run the two side by
side.
"""
import re

import pytest
import torch_threads  # noqa: F401  (sizes this worker's torch thread pool)
from torch_examples import jax_example as _jax_example
from torch_examples import port_example as _port_example

from repro_torch.examples import cityscale_cache_sim, quickstart, serve_paged


def _value(lines: list[str], label: str) -> float:
    """The number after ``label`` on its line (a percentage as a ratio)."""
    line = next(x for x in lines if x.strip().startswith(label))
    m = re.search(r"(-?[\d.]+)(%?)", line[line.index(label) + len(label):])
    return float(m.group(1)) / (100 if m.group(2) else 1)


def _summary(lines: list[str]) -> dict:
    """``cityscale_cache_sim``'s closing table: ``{key: value}``."""
    out = {}
    for x in lines[lines.index(next(x for x in lines if x.startswith("=== "))) + 1:]:
        parts = x.split()
        if len(parts) == 2 and re.fullmatch(r"-?[\d.e+-]+", parts[1]):
            out[parts[0]] = float(parts[1])
    return out


def test_quickstart_prints_what_jax_prints():
    """Parts 1 and 2 (one cache, one lossy gossip round) equal; part 3's
    ratios within 0.01 (measured: miss 0.0005, sync 0.00003, WAN 0.002)."""
    want = _jax_example("quickstart", [])
    got = _port_example(quickstart, [])
    assert len(got) == len(want) == 6
    assert got[:3] == want[:3]
    for label, eps in (("read miss ratio", 0.01), ("sync store requests", 0.01),
                       ("WAN bytes vs no-cache", 0.01)):
        assert abs(_value(got, label) - _value(want, label)) <= eps, label
        assert [x.split(label)[0] for x in got if label in x] == \
               [x.split(label)[0] for x in want if label in x]
    assert _value(got, "read miss ratio") < 0.02


# (args, miss eps, stale eps): the tick-by-tick loop on the paper's stream
# with an outage, and the fused engine on the mutable zipf workload
CITY = {
    "reference": (["--nodes", "20", "--minutes", "2", "--outage-at", "40", "--outage-s", "30"],
                  0.12, 0.0),
    "fused": (["--nodes", "20", "--minutes", "2", "--outage-at", "40", "--outage-s", "30",
               "--engine", "fused", "--scenario", "zipf"], 0.25, 0.10),
}


@pytest.fixture(scope="module")
def city_runs():
    return {name: (_jax_example("cityscale_cache_sim", args),
                   _port_example(cityscale_cache_sim, args))
            for name, (args, _, _) in CITY.items()}


@pytest.mark.parametrize("engine", sorted(CITY))
def test_cityscale_cache_sim_prints_what_jax_prints(city_runs, engine):
    """The same lines in the same order (the outage trace's ticks, the
    summary's keys, the closing line); counts that depend on no draw
    exact; writes conserved; miss and stale ratios within the tier's
    epsilons (``zipf`` 0.25 and 0.10; the paper stream 0.12, the
    ``zipf_hot`` row's, and it has no stale reads).  Measured at seed 0:
    miss 0.032 (reference) and 0.063 (fused), stale 0.035."""
    want, got = city_runs[engine]
    _, miss_eps, stale_eps = CITY[engine]

    def shape(lines):
        return [re.sub(r"[-\d.e+]+", "#", x) for x in lines]

    assert shape(got) == shape(want)
    assert got[-1] == want[-1]
    s, w = _summary(got), _summary(want)
    assert sorted(s) == sorted(w)
    for k in ("writes_gen", "wire_bytes_per_tick", "churn_rejoins"):
        assert s.get(k) == w.get(k), k
    assert s["writes_gen"] == (s["writes_drained"] + s["final_queue_depth"]
                               + s["queue_dropped"] + s.get("writes_coalesced", 0))
    assert abs(s["read_miss_ratio"] - w["read_miss_ratio"]) <= miss_eps
    assert abs(s.get("stale_read_ratio", 0) - w.get("stale_read_ratio", 0)) <= stale_eps


def test_cityscale_distributed_engine_equals_fused(city_runs):
    """``--engine distributed --world 2`` (two spawned ranks over gloo)
    prints the fused run's summary but for the modelled wire bytes."""
    args = CITY["fused"][0]
    fused = _summary(city_runs["fused"][1])
    dist = _summary(_port_example(cityscale_cache_sim, args[:-4] + [
        "--engine", "distributed", "--world", "2", "--scenario", "zipf"]))
    assert dist.pop("wire_bytes_per_tick") > 0
    fused.pop("wire_bytes_per_tick")
    assert dist == fused


def test_serve_paged_prints_what_jax_prints():
    """Requests, tokens, prefix reuse and the page manager's stats equal;
    the tokens come from other weights, so only their count is JAX's."""
    want = _jax_example("serve_paged", [])
    got = _port_example(serve_paged, [])

    def untimed(lines):
        return [re.sub(r"[\d.]+s\b", "#s", x) for x in lines]

    assert untimed(got) == untimed(want)
    assert "prefill reused: 4/4" in got[1] and got[2].endswith("True")
