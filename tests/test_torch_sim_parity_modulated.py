"""The port's fused engine and its reference engine against JAX's, bitwise,
on replayed draws at seeds 0 and 1: the rate-modulated and churn cases (see ``torch_parity``)."""
import pytest
from torch_parity import MODULATED, case_seeds, check_reference, check_series, check_summary


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("case,seed", case_seeds(MODULATED))
def test_series_bitwise(case, seed, backend):
    check_series(case, backend, seed)


@pytest.mark.parametrize("case,seed", case_seeds(MODULATED))
def test_summary(case, seed):
    check_summary(case, seed)


@pytest.mark.parametrize("case,seed", case_seeds(MODULATED))
def test_reference_engine_bitwise(case, seed):
    check_reference(case, seed)
