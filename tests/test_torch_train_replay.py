"""The committed JAX training fixtures of the dense and SSM families,
Granite-8B's and Mamba2-370M's smoke configs
(``train_granite_8b_smoke.npz``, ``train_mamba2_370m_smoke.npz``):
regenerated from the JAX package and compared (so a stale file fails), small
enough, and replayed here on the CPU within
``repro_torch.train.replay.train_tol``; Mamba2 also with the plain scan
differentiated by autograd. The other families' files are checked in the
other ``test_torch_train_replay*.py`` modules, so the test workers share
them out.
"""
import pytest
from torch_train_replay import (
    check_train_fixture_current,
    check_train_fixture_replays,
    check_train_fixture_small,
    replays,
)

ARCHS = ['granite_8b', 'mamba2_370m']


@pytest.mark.parametrize("arch", ARCHS)
def test_committed_train_fixture_equals_regenerated(arch):
    check_train_fixture_current(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_fixture_is_small(arch):
    check_train_fixture_small(arch)


@pytest.mark.parametrize("arch, dtype, scan", replays(ARCHS, plain_scan=["mamba2_370m"]))
def test_train_fixture_replays_on_cpu(arch, dtype, scan):
    check_train_fixture_replays(arch, dtype, scan)
