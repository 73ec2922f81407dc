"""The port's batched cache primitives against ``repro.core.flic``, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import arbitrary_tables, as_numpy, as_torch, key_pool

from repro.core import cache_state as jcs
from repro.core import flic as jflic
from repro_torch.core import cache_state as tcs
from repro_torch.core import flic as tflic

S, W, D = 8, 4, 3
FIELDS = ("tags", "data_ts", "ins_ts", "origin", "valid", "dirty", "last_use", "data")


def _states(seed, n):
    rng = np.random.default_rng(seed)
    pool = key_pool(rng, 16)
    tab = arbitrary_tables(rng, n, S, W, D, pool)
    jc = jcs.CacheState(**{k: jnp.asarray(v) for k, v in tab.items()})
    tc = tcs.CacheState(**{k: as_torch(v) for k, v in tab.items()})
    return rng, pool, jc, tc


def _lines(rng, pool, n):
    arr = dict(
        key=pool[rng.integers(0, len(pool), n)],
        data_ts=rng.integers(-1, 14, n).astype(np.int32),
        origin=rng.integers(0, n, n).astype(np.int32),
        data=rng.random((n, D)).astype(np.float32),
        valid=rng.random(n) < 0.75,
        dirty=rng.random(n) < 0.4,
    )
    return (jcs.CacheLine(**{k: jnp.asarray(v) for k, v in arr.items()}),
            tcs.CacheLine(**{k: as_torch(v) for k, v in arr.items()}))


def _assert_caches(got, want):
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(as_numpy(getattr(got, f), like=w), w, err_msg=f)


@pytest.mark.parametrize("backend", [None, "plain", "cuda"])
@pytest.mark.parametrize("seed", range(4))
def test_insert_rows_matches_jax(seed, backend):
    rng, pool, jc, tc = _states(seed, 7)
    jl, tl = _lines(rng, pool, 7)
    want, j_ev = jflic.insert_rows(jc, jl, jnp.int32(17))
    got, t_ev = tflic.insert_rows(tc, tl, 17, backend=backend)
    _assert_caches(got, want)
    if backend is None:
        for f in ("key", "data_ts", "origin", "data", "valid", "dirty"):
            w = np.asarray(getattr(j_ev, f))
            np.testing.assert_array_equal(as_numpy(getattr(t_ev, f), like=w), w, err_msg=f)
    else:
        assert t_ev is None


@pytest.mark.parametrize("backend", [None, "plain", "cuda"])
@pytest.mark.parametrize("seed", range(4))
def test_update_rows_matches_jax(seed, backend):
    n = 6
    rng, pool, jc, tc = _states(seed, n)
    jl, tl = _lines(rng, pool, n)
    delivered = rng.random((n, n)) < 0.6
    want, j_cnt = jflic.update_rows(jc, jl, jnp.asarray(delivered), jnp.int32(23))
    got, t_cnt = tflic.update_rows(tc, tl, as_torch(delivered), 23, backend=backend)
    _assert_caches(got, want)
    assert int(t_cnt) == int(j_cnt)
    assert t_cnt.dtype == torch.int32


def test_update_rows_counts_live_sweeps():
    """Rows that re-write keys the hearers hold, with newer timestamps."""
    n = 4
    rng, pool, jc, tc = _states(11, n)
    keys = np.asarray(jc.tags)[np.arange(n), 0, 0]       # keys resident somewhere
    arr = dict(key=keys, data_ts=np.full(n, 50, np.int32),
               origin=np.arange(n, dtype=np.int32),
               data=rng.random((n, D)).astype(np.float32),
               valid=np.ones(n, bool), dirty=np.zeros(n, bool))
    jl = jcs.CacheLine(**{k: jnp.asarray(v) for k, v in arr.items()})
    tl = tcs.CacheLine(**{k: as_torch(v) for k, v in arr.items()})
    delivered = np.ones((n, n), bool)
    want, j_cnt = jflic.update_rows(jc, jl, jnp.asarray(delivered), jnp.int32(60))
    got, t_cnt = tflic.update_rows(tc, tl, as_torch(delivered), 60)
    _assert_caches(got, want)
    assert int(t_cnt) == int(j_cnt) > 0


def test_invalidate_nodes_matches_jax():
    rng, _, jc, tc = _states(5, 6)
    mask = rng.random(6) < 0.5
    want = jflic.invalidate_nodes(jc, jnp.asarray(mask))
    got = tflic.invalidate_nodes(tc, as_torch(mask))
    _assert_caches(got, want)


def test_unknown_backends_are_refused():
    for name in ("interpret", "pallas", "triton"):
        with pytest.raises(ValueError, match="probe_backend"):
            tflic.kernels(name)
    assert tflic.kernels("xla") is tflic.KERNEL_BACKENDS["plain"]
