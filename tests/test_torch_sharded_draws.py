"""The port's sharded engine on JAX's own per-shard draws, against JAX's
sharded engine, bitwise.

``torch_parity.jax_shard_draw_arrays`` steps the key chain of every rank of
``repro.core.sharded`` in-process and hands each rank's draws to the port's
tick loop (``EngineRun(draws=...)``).  JAX's ``run_sharded_sim`` runs the
same cases at 4 forced host devices in a subprocess.  With the draws
equal, every ``TickMetrics`` field of every tick must be equal: this is
what tells a fault of the port's sharded tick from the seed-to-seed spread
that its native-draw tolerance tier (``test_torch_sharded.py``) allows.
"""
import json

import numpy as np
import pytest
from conformance import CASES, SHARDED_CASES
from torch_parity import jax_shard_draw_arrays, torch_config

from repro_torch.core.distributed import EngineRun, run_group
from repro_torch.core.metrics import field_names

WORLD = 4
SEEDS = (0, 1)
KEYS = [(case, seed) for seed in SEEDS for case in SHARDED_CASES]


@pytest.fixture(scope="module")
def jax_sharded_series(forced_devices_run, tmp_path_factory):
    """JAX's sharded engine on every (case, seed) at 4 forced devices."""
    out = tmp_path_factory.mktemp("jax_sharded")
    forced_devices_run(f"""
        import jax, numpy as np
        from jax.sharding import Mesh
        from conformance import CASES
        from repro.core.sharded import run_sharded_sim
        mesh = Mesh(np.asarray(jax.devices()[:{WORLD}]), ('data',))
        for case, seed in {KEYS!r}:
            _, series = run_sharded_sim(mesh, CASES[case].cfg, CASES[case].ticks,
                                        axis='data', seed=seed)
            np.savez({str(out)!r} + f'/{{case}}_{{seed}}.npz',
                     **{{k: np.asarray(v) for k, v in vars(series).items()}})
    """, timeout=600, n_devices=WORLD)
    return {(case, seed): dict(np.load(out / f"{case}_{seed}.npz")) for case, seed in KEYS}


@pytest.fixture(scope="module")
def port_sharded_series():
    """The port's sharded engine on JAX's draws: one spawned group."""
    runs = [EngineRun("sharded", torch_config(CASES[case].cfg), CASES[case].ticks, seed,
                      draws=jax_shard_draw_arrays(CASES[case].cfg, CASES[case].ticks, seed,
                                                  WORLD))
            for case, seed in KEYS]
    res = run_group(runs, world=WORLD, backend="gloo", device="cpu", timeout=300.0)
    return dict(zip(KEYS, res))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_engine_on_jax_draws_equals_jax_sharded_engine(
        jax_sharded_series, port_sharded_series, case, seed):
    want = jax_sharded_series[case, seed]
    got = port_sharded_series[case, seed].series
    diffs = {}
    for f in field_names():
        g, w = getattr(got, f).numpy(), want[f]
        assert g.shape == w.shape, (f, g.shape, w.shape)
        if not np.array_equal(g, w):
            first = int(np.flatnonzero(g != w)[0])
            diffs[f] = dict(first_tick=first, got=g[first].item(), want=w[first].item())
    assert not diffs, json.dumps(diffs)
