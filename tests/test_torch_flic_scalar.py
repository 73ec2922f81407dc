"""The port's scalar cache primitives, the replicate merge and the loss
bounds against ``repro.core.flic``/``repro.core.coherence``, exactly, on
arbitrary states (duplicate tags in a set, tied timestamps), evictions
included."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import arbitrary_tables, as_numpy, as_torch, key_pool

from repro.core import cache_state as jcs
from repro.core import coherence as jco
from repro.core import flic as jflic
from repro_torch.core import cache_state as tcs
from repro_torch.core import coherence as tco
from repro_torch.core import flic as tflic
from repro_torch.core.simulator import _merge_replicate

S, W, D = 8, 4, 3


def _states(seed, n):
    rng = np.random.default_rng(seed)
    pool = key_pool(rng, 16)
    tab = arbitrary_tables(rng, n, S, W, D, pool)
    jc = jcs.CacheState(**{k: jnp.asarray(v) for k, v in tab.items()})
    tc = tcs.CacheState(**{k: as_torch(v) for k, v in tab.items()})
    return rng, pool, jc, tc


def _lines(rng, pool, r, n_origins):
    arr = dict(
        key=pool[rng.integers(0, len(pool), r)],
        data_ts=rng.integers(-1, 14, r).astype(np.int32),
        origin=rng.integers(0, n_origins, r).astype(np.int32),
        data=rng.random((r, D)).astype(np.float32),
        valid=rng.random(r) < 0.8,
        dirty=rng.random(r) < 0.5,
    )
    return (jcs.CacheLine(**{k: jnp.asarray(v) for k, v in arr.items()}),
            tcs.CacheLine(**{k: as_torch(v) for k, v in arr.items()}))


def _node(c, i):
    return type(c)(*(getattr(c, f.name)[i] for f in dataclasses.fields(c)))


def _assert_same(got, want, label=""):
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name)
        assert tuple(g.shape) == w.shape, f"{label}.{f.name}"
        np.testing.assert_array_equal(as_numpy(g, like=w), w, err_msg=f"{label}.{f.name}")


@pytest.mark.parametrize("seed", range(6))
def test_insert_matches_jax(seed):
    n = 6
    rng, pool, jc, tc = _states(seed, n)
    jl, tl = _lines(rng, pool, n, n)
    for i in range(n):
        want, j_ev = jflic.insert(_node(jc, i), _node(jl, i), jnp.int32(20 + i))
        got, t_ev = tflic.insert(_node(tc, i), _node(tl, i), 20 + i)
        _assert_same(got, want, f"node{i}")
        _assert_same(t_ev, j_ev, f"evicted{i}")


@pytest.mark.parametrize("seed", range(4))
def test_insert_batch_matches_jax(seed):
    """Twelve lines into one cache in order: same-set conflicts resolve
    line by line, evictions stacked (R,)."""
    rng, pool, jc, tc = _states(seed, 1)
    jl, tl = _lines(rng, pool, 12, 4)
    want, j_ev = jflic.insert_batch(_node(jc, 0), jl, jnp.int32(31))
    got, t_ev = tflic.insert_batch(_node(tc, 0), tl, 31)
    _assert_same(got, want)
    _assert_same(t_ev, j_ev, "evictions")
    assert bool(t_ev.valid.any())


@pytest.mark.parametrize("update_lru", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_local_lookup_and_lookup_rows_match_jax(seed, update_lru):
    n = 6
    rng, pool, jc, tc = _states(seed, n)
    keys = pool[rng.integers(0, len(pool), n)]
    tags, valid = np.asarray(jc.tags), np.asarray(jc.valid)
    for i in range(0, n, 2):          # every other node probes a key it holds, if any
        held = [k for k in pool if (valid[i, k % S] & (tags[i, k % S] == k)).any()]
        keys[i] = held[0] if held else keys[i]
    for i in range(n):
        want, j_res = jflic.local_lookup(_node(jc, i), jnp.uint32(keys[i]), jnp.int32(40),
                                         update_lru)
        got, t_res = tflic.local_lookup(_node(tc, i), as_torch(keys[i:i + 1])[0], 40,
                                        update_lru)
        _assert_same(got, want, f"node{i}")
        _assert_same(t_res, j_res, f"result{i}")
    want, j_res = jflic.lookup_rows(jc, jnp.asarray(keys), jnp.int32(41), update_lru)
    got, t_res = tflic.lookup_rows(tc, as_torch(keys), 41, update_lru)
    _assert_same(got, want)
    _assert_same(t_res, j_res, "rows")
    assert bool(t_res.hit.any())


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_fog_lookup_matches_jax(seed, lossy):
    n = 7
    rng, pool, jc, tc = _states(seed, n)
    mask = rng.random(n) < 0.6 if lossy else None
    for key in pool[:6]:
        want, j_best, j_resp = jflic.fog_lookup(
            jc, jnp.uint32(key), jnp.int32(50), None if mask is None else jnp.asarray(mask))
        got, t_best, t_resp = tflic.fog_lookup(
            tc, as_torch(np.asarray([key]))[0], 50, None if mask is None else as_torch(mask))
        _assert_same(got, want, f"key {key}")
        _assert_same(t_best, j_best, f"best {key}")
        np.testing.assert_array_equal(t_resp.numpy(), np.asarray(j_resp))


@pytest.mark.parametrize("seed", range(3))
def test_invalidate_matches_jax(seed):
    rng, pool, jc, tc = _states(seed, 1)
    for key in pool:
        want = jflic.invalidate(_node(jc, 0), jnp.uint32(key))
        got = tflic.invalidate(_node(tc, 0), as_torch(np.asarray([key]))[0])
        _assert_same(got, want, f"key {key}")


@pytest.mark.parametrize("backend", [None, "plain"])
@pytest.mark.parametrize("seed", range(4))
def test_insert_rows_equals_insert_line_by_line(seed, backend):
    """The batched upsert and the scalar one agree on every field (``ins_ts``,
    ``last_use``, ``dirty``, the first-invalid-else-LRU victim) and, inline,
    on the evictions."""
    n = 8
    rng, pool, _, tc = _states(seed, n)
    _, tl = _lines(rng, pool, n, n)
    got, ev = tflic.insert_rows(tc, tl, 27, backend=backend)
    for i in range(n):
        want_i, ev_i = tflic.insert(_node(tc, i), _node(tl, i), 27)
        _assert_equal(_node(got, i), want_i, f"node{i}")
        if backend is None:
            _assert_equal(_node(ev, i), ev_i, f"evicted{i}")


def _assert_equal(got, want, label=""):
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f"{label}.{f.name}"


@pytest.mark.parametrize("self_always", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_merge_broadcasts_matches_jax(seed, self_always):
    n, r = 5, 7
    rng, pool, jc, tc = _states(seed, n)
    jl, tl = _lines(rng, pool, r, n + 3)
    delivered = rng.random((n, r)) < 0.5
    node_ids = np.asarray([3, 4, 5, 6, 7], np.int32)    # a shard's global ids
    for ids in (None, node_ids):
        want, j_ev = jco.merge_broadcasts(
            jc, jl, jnp.asarray(delivered), jnp.int32(33), self_always=self_always,
            node_ids=None if ids is None else jnp.asarray(ids))
        got, t_ev = tco.merge_broadcasts(
            tc, tl, as_torch(delivered), 33, self_always=self_always,
            node_ids=None if ids is None else as_torch(ids))
        _assert_same(got, want, f"ids={ids}")
        _assert_same(t_ev, j_ev, f"evictions ids={ids}")
        assert tuple(t_ev.key.shape) == (n, r)


@pytest.mark.parametrize("backend", [None, "plain", "cuda"])
@pytest.mark.parametrize("seed", range(4))
def test_merge_replicate_equals_merge_broadcasts(seed, backend):
    """The fused engine's R batched upserts equal the scalar merge, with the
    delivery mask cut by membership (offline nodes hear only themselves)."""
    n = 6
    rng, pool, _, tc = _states(seed, n)
    _, tl = _lines(rng, pool, n, n)
    tl = dataclasses.replace(tl, origin=torch.arange(n, dtype=torch.int32))
    online = as_torch(rng.random(n) < 0.7)
    delivered = as_torch(rng.random((n, n)) < 0.6) & online[:, None]
    want, _ = tco.merge_broadcasts(tc, tl, delivered, 44)
    _assert_equal(_merge_replicate(tc, tl, delivered, 44, backend), want)


@pytest.mark.parametrize("n_nodes", [1, 2, 5, 16, 1000])
@pytest.mark.parametrize("p", [0.0, 0.02, 0.1, 0.5, 0.99, 1.0])
def test_loss_bounds_match_jax(p, n_nodes):
    assert tco.markov_loss_bound(p, n_nodes) == jco.markov_loss_bound(p, n_nodes)
    assert tco.exact_total_loss_prob(p, n_nodes) == jco.exact_total_loss_prob(p, n_nodes)
    assert tco.exact_total_loss_prob(p, n_nodes) <= tco.markov_loss_bound(p, n_nodes)
