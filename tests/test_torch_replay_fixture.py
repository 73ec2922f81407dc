"""The committed JAX replays that ``chip_smoke.py`` runs on the card.

Regenerated here from the JAX package and compared with the committed
files, so the fixture cannot go stale; and replayed through the port on the
CPU, where the kernel wrappers run their plain versions.
"""
import dataclasses
import os

import numpy as np
import pytest
from torch_parity import FIXTURE_CASES, FIXTURE_DIR, replay_fixture_arrays

from repro_torch.core.metrics import EMBODIMENT_FIELDS
from repro_torch.core.replay import config_to_json, load_replay
from repro_torch.core.simulator import run_sim


def _path(case):
    return os.path.join(FIXTURE_DIR, f"replay_{case}.npz")


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_committed_fixture_equals_regenerated(case):
    tcfg, arrays = replay_fixture_arrays(case)
    with np.load(_path(case)) as z:
        committed = {k: z[k] for k in z.files}
    assert str(committed.pop("config")) == config_to_json(tcfg)
    assert sorted(committed) == sorted(arrays)
    for k, v in arrays.items():
        assert committed[k].dtype == v.dtype, k
        np.testing.assert_array_equal(committed[k], v, err_msg=k)


def test_fixtures_are_small():
    assert sum(os.path.getsize(_path(c)) for c in FIXTURE_CASES) < 1_000_000


@pytest.mark.parametrize("backend", ["cuda", None])
@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_fixture_replays_bitwise_on_cpu(case, backend):
    cfg, draws, expected = load_replay(_path(case), "cpu")
    cfg = dataclasses.replace(cfg, probe_backend=backend)
    _, series = run_sim(cfg, len(draws), device="cpu", draws=draws)
    for f, want in expected.items():
        if f not in EMBODIMENT_FIELDS:
            np.testing.assert_array_equal(getattr(series, f).numpy(), want, err_msg=f)
