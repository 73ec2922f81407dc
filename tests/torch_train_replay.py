"""Checks of the committed JAX training fixtures (``train_<arch>_smoke.npz``)
that ``chip_smoke.py`` replays on the card, shared by the
``test_torch_train_replay*.py`` modules (one a family, so the test workers
share them out): regenerated from the JAX package and compared (so a stale
file fails), small enough, and replayed here on the CPU within
``repro_torch.train.replay.train_tol`` (``TRAIN_TOL``, and the wider
entries of some families).  Not a test module."""
import dataclasses
import os

import numpy as np
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

DTYPES = ("float32", "bfloat16")


def replays(archs, plain_scan=()) -> list:
    """(arch, dtype, scan) cases: ``None`` is the model's default scan
    (``ops.ssd_scan`` through ``SSDScan``), "plain" the plain scan
    differentiated by autograd, for the archs in ``plain_scan``."""
    return ([(arch, dtype, None) for arch in archs for dtype in DTYPES]
            + [(arch, dtype, "plain") for arch in plain_scan for dtype in DTYPES])


def check_train_fixture_current(arch: str) -> None:
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


def check_train_fixture_small(arch: str) -> None:
    assert os.path.getsize(TRAIN_FIXTURES[arch]) < 300_000


def check_train_fixture_replays(arch: str, dtype: str, scan, learns: bool = True) -> None:
    """The port's replay within ``train_tol``; JAX's losses finite and, where
    ``learns``, lower after the last step than before the first."""
    cfg, tree, cases = load_model_replay(TRAIN_FIXTURES[arch])
    kw = {} if scan is None else {"ssd_scan": ref.ssd_scan_ref}
    got = replay_train_case(cfg, tree, dtype, cases[dtype], "cpu", **kw)
    res = compare_train_case(cases[dtype], got)
    assert train_case_ok(res, train_tol(cfg.family, dtype)), res
    losses = cases[dtype]["loss"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] or not learns, losses
