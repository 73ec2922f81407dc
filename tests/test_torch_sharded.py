"""The port's bandwidth-lean engine (``repro_torch.core.sharded``) on the
CPU, over gloo, against JAX.

* The consistent-hash ring (``hash_ring``, ``ring_candidates``,
  ``route_keys``) bitwise equal to JAX's, churned membership included.
* ``insert_in_order`` (the home inserts as rounds of batched upserts)
  bitwise equal to the scalar upserts applied one after the other.
* The tolerance tier of ``tests/conformance.py``: the 4 ``SHARDED_CASES``
  at seeds 0 and 1 and world 4 (one spawned group) against JAX's fused
  series from the committed replays: exact reads / writes_gen /
  churn_rejoins, write conservation, the eps bounds, liveness.
* ``wire_bytes_per_tick`` equal to JAX's sharded engine at 4 forced host
  devices, and at most half the parity engine's at worlds 4 and 8.
* ``validate_sharded`` rejects what JAX's rejects, with its message.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conformance import CASES, SHARDED_CASES
from torch_parity import arbitrary_tables, as_torch, fixture_path, key_pool, torch_config

from repro.core import sharded as jsh
from repro.core import workload as jwl
from repro.core.simulator import SimConfig as JSimConfig
from repro_torch.core import workload as twl
from repro_torch.core.cache_state import CacheLine, CacheState
from repro_torch.core.distributed import EngineRun, run_group
from repro_torch.core.flic import insert
from repro_torch.core.metrics import TickMetrics, summarize
from repro_torch.core.replay import load_replay
from repro_torch.core.sharded import insert_in_order, run_sharded_sim, validate_sharded

GROUP_TIMEOUT = 300.0
TIER_SEEDS = (0, 1)
WIRE_N = 48          # the N of the repo's own halving gate (tests/test_distributed.py)
WIRE_TICKS = 15


@pytest.mark.parametrize("n, k", [(16, 4096), (48, 512), (7, 100), (1000, 512)])
def test_ring_tables_match_jax(n, k):
    for got, want in zip(twl.hash_ring(n), jwl.hash_ring(n)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twl.ring_candidates(n, k), jwl.ring_candidates(n, k))


@pytest.mark.parametrize("scenario, n", [("zipf_hot", 16), ("churn", 16), ("storm", 48),
                                         ("churn", 1000)])
def test_route_keys_match_jax(scenario, n):
    rng = np.random.default_rng(n)
    tspec, jspec = twl.SCENARIOS[scenario], jwl.SCENARIOS[scenario]
    for t in (0, 1, 119, 120, 241, 999):
        kids = rng.integers(-5, jspec.key_universe + 5, (64,)).astype(np.int32)
        want = np.asarray(jwl.route_keys(jspec, n, t, jnp.asarray(kids)))
        got = twl.route_keys(tspec, n, t, torch.from_numpy(kids)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"{scenario} n={n} t={t}")


@pytest.mark.parametrize("backend", [None, "cuda"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_insert_in_order_equals_scalar_upserts_in_order(seed, backend):
    """B lines of a small key pool into few nodes: same-set collisions,
    repeated keys in and out of runs, dead lines; all at ts ``now`` with the
    payload pure in (key, ts), as the home inserts are."""
    rng = np.random.default_rng(seed)
    n, s, w, d, b, now = 5, 3, 2, 4, 60, 20
    pool = key_pool(rng, 8)
    tables = {k: as_torch(v) for k, v in arbitrary_tables(rng, n, s, w, d, pool).items()}
    caches = CacheState(**tables)
    keys = as_torch(pool[rng.integers(0, len(pool), b)])
    ts = torch.full((b,), now, dtype=torch.int32)
    lines = CacheLine(key=keys, data_ts=ts, origin=torch.full((b,), -1, dtype=torch.int32),
                      data=twl.versioned_payload(keys, ts, d),
                      valid=torch.from_numpy(rng.random(b) < 0.8),
                      dirty=torch.zeros((b,), dtype=torch.bool))
    node = torch.from_numpy(rng.integers(0, n, b).astype(np.int32))
    got = insert_in_order(caches, lines, node, now, backend=backend)

    want = {f.name: getattr(caches, f.name).clone() for f in dataclasses.fields(CacheState)}
    for i in range(b):
        c = int(node[i])
        one = CacheState(**{k: v[c] for k, v in want.items()})
        line = CacheLine(*(getattr(lines, f.name)[i] for f in dataclasses.fields(CacheLine)))
        one, _ = insert(one, line, now)
        for k in want:
            want[k][c] = getattr(one, k)
    for k, v in want.items():
        assert torch.equal(getattr(got, k), v), k


@pytest.fixture(scope="module")
def tier_runs():
    """The 4 SHARDED_CASES at seeds 0 and 1, world 4: one spawned group."""
    keys = [(case, seed) for seed in TIER_SEEDS for case in SHARDED_CASES]
    runs = [EngineRun("sharded", torch_config(CASES[case].cfg), CASES[case].ticks, seed)
            for case, seed in keys]
    return dict(zip(keys, run_group(runs, world=4, backend="gloo", device="cpu",
                                    timeout=GROUP_TIMEOUT)))


@pytest.mark.parametrize("seed", TIER_SEEDS)
@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_tolerance_tier_against_jax_fused(tier_runs, case, seed):
    """``conformance.sharded_case_report``'s checks, the fused side from the
    committed replay of JAX's run."""
    tol = SHARDED_CASES[case]
    _, _, expected = load_replay(fixture_path(case, seed), "cpu")
    fs = summarize(TickMetrics(**{f: torch.from_numpy(v) for f, v in expected.items()}))
    ss = summarize(tier_runs[case, seed].series)
    label = f"sharded:{case}/seed{seed}"
    for field in ("ticks", "reads", "writes_gen", "churn_rejoins"):
        assert ss[field] == fs[field], (label, field, ss[field], fs[field])
    assert ss["writes_gen"] == (ss["writes_drained"] + ss["final_queue_depth"]
                                + ss["queue_dropped"] + ss["writes_coalesced"]), label
    d_miss = abs(ss["read_miss_ratio"] - fs["read_miss_ratio"])
    assert d_miss <= tol.miss_ratio_eps, (label, d_miss, ss["read_miss_ratio"],
                                          fs["read_miss_ratio"])
    d_stale = abs(ss["stale_read_ratio"] - fs["stale_read_ratio"])
    assert d_stale <= tol.stale_ratio_eps, (label, d_stale)
    for field in ("reads",) + tol.expect_positive:
        assert ss[field] > 0, (label, field)
    assert ss["wire_bytes_per_tick"] > 0, label


@pytest.fixture(scope="module")
def jax_sharded_wire(forced_devices_run):
    """JAX's sharded engine at 4 forced host devices: wire bytes per tick
    of ``zipf_hot`` at the conformance N and at ``WIRE_N``."""
    out = forced_devices_run(f"""
        import dataclasses, jax, json, numpy as np
        from jax.sharding import Mesh
        from conformance import CASES
        from repro.core.metrics import summarize
        from repro.core.sharded import run_sharded_sim
        mesh = Mesh(np.asarray(jax.devices()[:4]), ('data',))
        cfg = CASES['zipf_hot'].cfg
        rec = {{}}
        for n in (cfg.n_nodes, {WIRE_N}):
            c = dataclasses.replace(cfg, n_nodes=n)
            _, series = run_sharded_sim(mesh, c, {WIRE_TICKS}, axis='data', seed=0)
            rec[n] = summarize(series)['wire_bytes_per_tick']
        print('WIRE=' + json.dumps(rec))
    """, timeout=300, n_devices=4)
    line = [x for x in out.splitlines() if x.startswith("WIRE=")][-1]
    return {int(k): v for k, v in json.loads(line[len("WIRE="):]).items()}


@pytest.fixture(scope="module")
def wire_runs():
    """Parity and sharded engines on ``zipf_hot`` at N = ``WIRE_N`` and the
    conformance N, worlds 4 and 8."""
    base = torch_config(CASES["zipf_hot"].cfg)
    out = {}
    for world in (4, 8):
        cfgs = [dataclasses.replace(base, n_nodes=n) for n in (WIRE_N, base.n_nodes)]
        runs = [EngineRun(engine, cfg, WIRE_TICKS) for cfg in cfgs
                for engine in ("distributed", "sharded")]
        res = run_group(runs, world=world, backend="gloo", device="cpu", timeout=GROUP_TIMEOUT)
        for run, r in zip(runs, res):
            out[run.engine, run.cfg.n_nodes, world] = summarize(r.series)["wire_bytes_per_tick"]
    return out


@pytest.mark.parametrize("n", [16, WIRE_N])
def test_wire_bytes_equal_jax_sharded_engine(jax_sharded_wire, wire_runs, n):
    assert wire_runs["sharded", n, 4] == jax_sharded_wire[n]


@pytest.mark.parametrize("world", [4, 8])
def test_sharded_moves_at_most_half_the_parity_bytes(wire_runs, world):
    parity, lean = wire_runs["distributed", WIRE_N, world], wire_runs["sharded", WIRE_N, world]
    assert parity > 0 and lean > 0
    assert lean <= 0.5 * parity, (world, lean, parity)


VALIDATE_CASES = {
    "zipf": {}, "zipf_hot": {}, "churn": {}, "paper": {}, "stream_churn": {},
    "poisson": {}, "trace_ycsb": {}, "replicate": {"insert_policy": "replicate"},
}


@pytest.mark.parametrize("name", list(VALIDATE_CASES))
def test_validate_sharded_rejects_what_jax_rejects(name):
    scenario = "zipf" if name == "replicate" else name
    jcfg = JSimConfig(n_nodes=16, workload=jwl.SCENARIOS[scenario], **VALIDATE_CASES[name])
    try:
        jsh.validate_sharded(jcfg)
        want = None
    except ValueError as e:
        want = str(e)
    tcfg = torch_config(jcfg)
    if want is None:
        validate_sharded(tcfg)
        return
    with pytest.raises(ValueError) as got:
        validate_sharded(tcfg)
    assert str(got.value) == want
    with pytest.raises(ValueError):
        run_sharded_sim(tcfg, 4, world=2, backend="gloo", device="cpu")
