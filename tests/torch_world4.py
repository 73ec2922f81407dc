"""The committed replays at world 4 through the port's distributed engine,
shared by ``test_torch_distributed.py`` (seed 0, and the thinned case) and
``test_torch_distributed_s1.py`` (seed 1): each module spawns its own group
of four gloo ranks, so the test workers run the two side by side.  Not a
test module."""
import numpy as np
from torch_parity import FIXTURE_CASES, fixture_path

from repro_torch.core.distributed import EngineRun, run_group
from repro_torch.core.metrics import EMBODIMENT_FIELDS, field_names
from repro_torch.core.replay import load_replay

GROUP_TIMEOUT = 300.0          # seconds for one spawned group


def replay(case, seed=0):
    return load_replay(fixture_path(case, seed), "cpu")


def assert_series(got, want: dict, label: str, skip=EMBODIMENT_FIELDS):
    for f in field_names():
        if f not in skip:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)), want[f],
                                          err_msg=f"{label}: TickMetrics.{f}")


def world4_group(seed: int, extra: dict | None = None) -> dict:
    """Every committed replay of ``seed`` at world 4, keyed ``(case,
    seed)``, and the ``extra`` runs (``{key: EngineRun}``), all in ONE
    spawned group."""
    keys, runs = [], []
    for case in FIXTURE_CASES:
        cfg, draws, _ = replay(case, seed)
        keys.append((case, seed))
        runs.append(EngineRun("distributed", cfg, len(draws), draws=draws))
    for key, run in (extra or {}).items():
        keys.append(key)
        runs.append(run)
    return dict(zip(keys, run_group(runs, world=4, backend="gloo", device="cpu",
                                    timeout=GROUP_TIMEOUT)))


def check_replay_at_world4(res, case: str, seed: int) -> None:
    """The group's run of a replay equals JAX's series bitwise; four ranks
    timed their loops; on the CPU no kernel launched and no device memory
    is reported."""
    cfg, _, expected = replay(case, seed)
    assert_series(res.series, expected, f"{case}/seed{seed}")
    assert res.state.caches.tags.shape[0] == cfg.n_nodes
    assert len(res.host_s) == 4 and all(s > 0 for s in res.host_s)
    assert all(sum(launch.values()) == 0 for launch in res.launches)
    assert res.peak_bytes == [None] * 4
