"""The port's fused engine and its reference engine against JAX's, bitwise,
on replayed draws at seeds 0 and 1: the write-once stream cases (see ``torch_parity``)."""
import pytest
from torch_parity import STREAM, case_seeds, check_reference, check_series, check_summary


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("case,seed", case_seeds(STREAM))
def test_series_bitwise(case, seed, backend):
    check_series(case, backend, seed)


@pytest.mark.parametrize("case,seed", case_seeds(STREAM))
def test_summary(case, seed):
    check_summary(case, seed)


@pytest.mark.parametrize("case,seed", case_seeds(STREAM))
def test_reference_engine_bitwise(case, seed):
    check_reference(case, seed)


def test_groups_cover_every_directory_policy_case():
    from conformance import CASES
    from torch_parity import MODULATED, POLICY, ZIPF

    groups = STREAM + ZIPF + MODULATED + POLICY
    assert len(groups) == len(set(groups)) == 17
    assert set(groups) == set(CASES)
    assert {k for k in POLICY} == {k for k, c in CASES.items()
                                   if c.cfg.insert_policy == "replicate"}
