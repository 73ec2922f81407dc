"""The port's distributed engine on the 17 committed seed-1 replays at world
4 (``test_torch_distributed.py``: seed 0 and the rest): spawned ranks over
gloo on the CPU, held bitwise against JAX's series, all in ONE spawned
group of its own (a module fixture), one test per fixture.  The group has
a timeout, so a hang fails its tests.
"""
import pytest
from torch_parity import FIXTURE_CASES, case_seeds
from torch_world4 import check_replay_at_world4, world4_group

SEED = 1


@pytest.fixture(scope="module")
def world4():
    return world4_group(SEED)


@pytest.mark.parametrize("case, seed", [p for p in case_seeds(FIXTURE_CASES)
                                        if p.values[1] == SEED])
def test_fixture_replays_bitwise_at_world4(world4, case, seed):
    check_replay_at_world4(world4[case, seed], case, seed)
