"""Checks of the committed replay fixtures, shared by the two fixture test
modules (one a seed, so the test workers share them out).  Not a test
module."""
import dataclasses
import os

import numpy as np
from torch_parity import FIXTURE_CASES, fixture_path, replay_fixture_arrays

from repro_torch.core.metrics import EMBODIMENT_FIELDS
from repro_torch.core.replay import config_to_json, load_replay
from repro_torch.core.simulator import run_sim

MAX_FIXTURE_BYTES = 300_000


def check_fixture_current(case: str, seed: int) -> None:
    """The committed file equals the one the JAX package writes now."""
    tcfg, arrays = replay_fixture_arrays(case, seed)
    with np.load(fixture_path(case, seed)) as z:
        committed = {k: z[k] for k in z.files}
    assert str(committed.pop("config")) == config_to_json(tcfg)
    assert sorted(committed) == sorted(arrays)
    for k, v in arrays.items():
        assert committed[k].dtype == v.dtype, k
        np.testing.assert_array_equal(committed[k], v, err_msg=k)


def check_fixtures_small(seed: int) -> None:
    for case in FIXTURE_CASES:
        size = os.path.getsize(fixture_path(case, seed))
        assert size < MAX_FIXTURE_BYTES, (case, size)


def check_fixture_replays(case: str, seed: int, backend) -> None:
    """The port replays the file on the CPU to JAX's series, bitwise."""
    cfg, draws, expected = load_replay(fixture_path(case, seed), "cpu")
    cfg = dataclasses.replace(cfg, probe_backend=backend)
    _, series = run_sim(cfg, len(draws), device="cpu", draws=draws)
    for f, want in expected.items():
        if f not in EMBODIMENT_FIELDS:
            np.testing.assert_array_equal(getattr(series, f).numpy(), want, err_msg=f)
