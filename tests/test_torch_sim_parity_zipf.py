"""The port's fused engine against JAX's, bitwise, on replayed draws:
the zipf cases (see ``torch_parity``)."""
import pytest
from torch_parity import ZIPF, check_series, check_summary


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("case", ZIPF)
def test_series_bitwise(case, backend):
    check_series(case, backend)


@pytest.mark.parametrize("case", ZIPF)
def test_summary(case):
    check_summary(case)
