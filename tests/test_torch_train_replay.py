"""The committed JAX training fixtures (``train_<arch>_smoke.npz``) that
``chip_smoke.py`` replays on the card: regenerated from the JAX package
and compared (so a stale file fails), small enough, and replayed here on
the CPU within ``repro_torch.train.replay.train_tol`` (``TRAIN_TOL``, and
the hybrid family's wider entries).
"""
import dataclasses
import os

import numpy as np
import pytest
from torch_parity import TRAIN_FIXTURES, train_fixture

from repro_torch.kernels import ref
from repro_torch.models.replay import load_model_replay
from repro_torch.train.replay import (
    TRACKED,
    compare_train_case,
    replay_train_case,
    train_case_ok,
    train_tol,
)

ARCHS = sorted(TRAIN_FIXTURES)


@pytest.mark.parametrize("arch", ARCHS)
def test_committed_train_fixture_equals_regenerated(arch):
    jcfg, flat, cases = train_fixture(arch)
    cfg, tree, committed = load_model_replay(TRAIN_FIXTURES[arch])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    stored = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + [k])
            else:
                stored["/".join(prefix + [k])] = v
    walk(tree, [])
    assert sorted(stored) == sorted(flat)
    for k, want in flat.items():
        want = want.view(np.uint16) if want.dtype.name == "bfloat16" else want
        assert stored[k].dtype == want.dtype, k
        np.testing.assert_array_equal(stored[k], want, err_msg=k)
    assert sorted(committed) == sorted(cases) == ["bfloat16", "float32"]
    for name, fields in cases.items():
        assert sorted(committed[name]) == sorted(fields)
        assert {f"grad/{k}" for k in TRACKED[cfg.family]} <= set(fields)
        for k, v in fields.items():
            assert committed[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(committed[name][k], v, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_fixture_is_small(arch):
    assert os.path.getsize(TRAIN_FIXTURES[arch]) < 300_000


# (arch, dtype, scan): ``None`` is the model's default (``ops.ssd_scan``
# through ``SSDScan``), "plain" the plain scan differentiated by autograd;
# the Mamba2 and Jamba stacks run a chunk scan.
REPLAYS = [(arch, dtype, None) for arch in ARCHS for dtype in ("float32", "bfloat16")] + [
    ("mamba2_370m", dtype, "plain") for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch, dtype, scan", REPLAYS)
def test_train_fixture_replays_on_cpu(arch, dtype, scan):
    cfg, tree, cases = load_model_replay(TRAIN_FIXTURES[arch])
    kw = {} if scan is None else {"ssd_scan": ref.ssd_scan_ref}
    got = replay_train_case(cfg, tree, dtype, cases[dtype], "cpu", **kw)
    res = compare_train_case(cases[dtype], got)
    assert train_case_ok(res, train_tol(cfg.family, dtype)), res
    losses = cases[dtype]["loss"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
