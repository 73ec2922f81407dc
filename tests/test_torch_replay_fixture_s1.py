"""The committed JAX replays that ``chip_smoke.py`` runs on the card, at
seed 1 (``test_torch_replay_fixture.py``: seed 0).

Regenerated here from the JAX package and compared with the committed
files, so the fixture cannot go stale; and replayed through the port on the
CPU, where the kernel wrappers run their plain versions.
"""
import pytest
from torch_parity import FIXTURE_CASES
from torch_replay import check_fixture_current, check_fixture_replays, check_fixtures_small

SEED = 1


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_committed_fixture_equals_regenerated(case):
    check_fixture_current(case, SEED)


def test_fixtures_are_small():
    check_fixtures_small(SEED)


@pytest.mark.parametrize("backend", ["cuda", None])
@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_fixture_replays_bitwise_on_cpu(case, backend):
    check_fixture_replays(case, SEED, backend)
