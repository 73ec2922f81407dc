"""The port's fused engine against JAX's, bitwise, on replayed draws:
the write-once stream cases (see ``torch_parity``)."""
import pytest
from torch_parity import STREAM, check_series, check_summary


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("case", STREAM)
def test_series_bitwise(case, backend):
    check_series(case, backend)


@pytest.mark.parametrize("case", STREAM)
def test_summary(case):
    check_summary(case)


def test_groups_cover_every_directory_policy_case():
    from conformance import CASES
    from torch_parity import MODULATED, ZIPF

    groups = STREAM + ZIPF + MODULATED
    assert len(groups) == len(set(groups)) == 16
    assert set(groups) == {k for k, c in CASES.items() if c.cfg.insert_policy == "directory"}
