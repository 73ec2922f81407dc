"""The committed JAX training fixture of the encoder-decoder family,
SeamlessM4T-medium's smoke config (``train_seamless_m4t_medium_smoke.npz``):
regenerated from the JAX package and compared (so a stale file fails),
small enough, and replayed here on the CPU within
``repro_torch.train.replay.train_tol`` (the family's wider entries), the
encoder frames of each step drawn again by ``synthetic_batch``.  The other
families' files are checked in the other ``test_torch_train_replay*.py``
modules, so the test workers share them out.
"""
import pytest
from torch_train_replay import (
    check_train_fixture_current,
    check_train_fixture_replays,
    check_train_fixture_small,
    replays,
)

ARCHS = ['seamless_m4t_medium']


@pytest.mark.parametrize("arch", ARCHS)
def test_committed_train_fixture_equals_regenerated(arch):
    check_train_fixture_current(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_fixture_is_small(arch):
    check_train_fixture_small(arch)


# Three steps on three synthetic batches: the batch-to-batch spread hides
# the learning (JAX's float32 losses read 5.900, 5.950, 5.953 at the
# fixture's lr 3e-3, and rise as well at 3e-4 and 1e-2), so the losses are
# held to JAX's, not to a fall.
@pytest.mark.parametrize("arch, dtype, scan", replays(ARCHS))
def test_train_fixture_replays_on_cpu(arch, dtype, scan):
    check_train_fixture_replays(arch, dtype, scan, learns=False)
