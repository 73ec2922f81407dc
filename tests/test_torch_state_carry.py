"""A JAX run's state carried into the port continues bitwise.

JAX runs 40 ticks; its state crosses over by ``state_from_numpy``; then both
engines run 40 more ticks on the same draws.  The series and the final
states must be equal.
"""
import dataclasses
import functools

import numpy as np
import pytest
from conformance import CASES
from torch_parity import (
    assert_series_equal,
    jax_draw_arrays,
    jax_series,
    jax_state_arrays,
    torch_config,
    torch_draws,
)

from repro.core import simulator as jsim
from repro_torch.core import simulator as tsim

HALF = 40


@functools.lru_cache(maxsize=None)
def _jax_halves(case):
    cfg = CASES[case].cfg
    mid, _ = jsim.run_sim(cfg, HALF, seed=0)
    mid_arrays = jax_state_arrays(mid)
    draws = jax_draw_arrays(cfg, HALF, start=mid)
    end, series = jsim.run_sim(cfg, 2 * HALF, seed=0)
    second = {k: v[HALF:] for k, v in jax_series(series).items()}
    return mid_arrays, draws, second, jax_state_arrays(end)


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("case", ["zipf_outage", "stream_churn", "paper_ge"])
def test_state_carry_continues_bitwise(case, backend):
    mid, draws, second, end = _jax_halves(case)
    tcfg = torch_config(CASES[case].cfg, probe_backend=backend)
    state = tsim.state_from_numpy(mid, tcfg, device="cpu")
    assert int(state.tick) == HALF
    final, series = tsim.run_sim(tcfg, HALF, device="cpu", state=state,
                                 draws=torch_draws(tcfg, draws))
    assert_series_equal(second, series, f"{case}/{backend}")
    got = tsim.state_to_numpy(final)
    assert set(got) == set(end) - {"rng"}
    for path, want in got.items():
        np.testing.assert_array_equal(want, end[path], err_msg=path)
        assert want.dtype == end[path].dtype, path


def test_state_round_trip_keeps_bit_patterns():
    mid, _, _, _ = _jax_halves("zipf_outage")
    tcfg = torch_config(CASES["zipf_outage"].cfg)
    back = tsim.state_to_numpy(tsim.state_from_numpy(mid, tcfg, device="cpu"))
    for path, a in back.items():
        np.testing.assert_array_equal(a, mid[path], err_msg=path)
    assert (back["caches.tags"] >= 2**31).any()


def test_state_shapes_are_checked():
    mid, _, _, _ = _jax_halves("zipf_outage")
    wrong = torch_config(dataclasses.replace(CASES["zipf_outage"].cfg, n_nodes=8))
    with pytest.raises(ValueError, match="shape"):
        tsim.state_from_numpy(mid, wrong, device="cpu")
