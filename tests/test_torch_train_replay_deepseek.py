"""The committed JAX training fixture of the MoE family, DeepSeek-V2-Lite's
smoke config (``train_deepseek_v2_lite_16b_smoke.npz``): regenerated from
the JAX package and compared (so a stale file fails), small enough, and
replayed here on the CPU within ``repro_torch.train.replay.train_tol``. The
other families' files are checked in the other
``test_torch_train_replay*.py`` modules, so the test workers share them out.
"""
import pytest
from torch_train_replay import (
    check_train_fixture_current,
    check_train_fixture_replays,
    check_train_fixture_small,
    replays,
)

ARCHS = ['deepseek_v2_lite_16b']


@pytest.mark.parametrize("arch", ARCHS)
def test_committed_train_fixture_equals_regenerated(arch):
    check_train_fixture_current(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_fixture_is_small(arch):
    check_train_fixture_small(arch)


@pytest.mark.parametrize("arch, dtype, scan", replays(ARCHS))
def test_train_fixture_replays_on_cpu(arch, dtype, scan):
    check_train_fixture_replays(arch, dtype, scan)
