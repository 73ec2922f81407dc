"""The plain versions of the three kernels against the JAX oracles, exactly.

States are arbitrary (duplicate tags in a set, tied timestamps, dead lanes),
as the JAX oracles' own tests use.  The lookup is also held against the
port's inline probe, but only on states that inserts can reach: the two
break ties differently where a set holds two copies of a key (DESIGN.md §4).
The wrappers of ``kernels/ops.py`` are checked to give the plain result on
CPU tensors; the CUDA kernels themselves are held against the plain
versions on the card by ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import arbitrary_tables, as_numpy, as_torch, key_pool

from repro.kernels import ref as jref
from repro_torch.core import simulator as tsim
from repro_torch.core.cache_state import CacheLine, CacheState, empty_cache, set_index
from repro_torch.core.flic import insert_rows
from repro_torch.kernels import ops, ref

S, W, D = 8, 4, 3


def _queries(rng, pool, q):
    keys = pool[rng.integers(0, len(pool), q)]
    return keys, (keys % np.uint32(S)).astype(np.int32)


def _check(got, want, names):
    for g, w, name in zip(got, want, names):
        w = np.asarray(w)
        np.testing.assert_array_equal(as_numpy(g, like=w), w, err_msg=name)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("q", [1, 13, 67])
def test_lookup_plain_matches_jax_oracle(seed, q):
    rng = np.random.default_rng(seed)
    pool = key_pool(rng)
    tab = arbitrary_tables(rng, 6, S, W, D, pool)
    keys, sidx = _queries(rng, pool, q)
    want = jax.vmap(jref.flic_lookup_ref, in_axes=(0, 0, 0, 0, None, None))(
        jnp.asarray(tab["tags"].view(np.int32)), tab["data_ts"], tab["valid"],
        tab["data"], jnp.asarray(keys.view(np.int32)), sidx,
    )
    args = [as_torch(tab[k]) for k in ("tags", "data_ts", "valid", "data")]
    got = ref.flic_lookup_ref(*args, as_torch(keys), as_torch(sidx))
    _check(got, want, ("hit", "ts", "payload", "way"))
    _check(ops.flic_lookup(*args, as_torch(keys), as_torch(sidx)), want,
           ("hit", "ts", "payload", "way"))


def _hot_key_rows(rng, tab, pool, r):
    """Rows that all carry one of 2 hot keys, which 90% of the nodes hold
    (ways 0 and 1 of their sets) with old timestamps: a line of such a node
    qualifies for about half the rows."""
    hot = pool[:2]
    holds = rng.random(tab["tags"].shape[0]) < 0.9
    for way, key in enumerate(hot):
        s = int(key % np.uint32(S))
        tab["tags"][holds, s, way] = key
        tab["valid"][holds, s, way] = True
        tab["data_ts"][holds, s, way] = rng.integers(-1, 3, int(holds.sum()))
    keys = hot[rng.integers(0, 2, r)]
    return keys, (keys % np.uint32(S)).astype(np.int32)


UPDATE_CASES = [(seed, False) for seed in range(6)] + [(seed, True) for seed in range(3)]


@pytest.mark.parametrize("seed,hot", UPDATE_CASES,
                         ids=[f"hot{s}" if hot else str(s) for s, hot in UPDATE_CASES])
def test_update_plain_matches_jax_oracle(seed, hot):
    rng = np.random.default_rng(seed)
    pool = key_pool(rng, 12)
    n, r = 5, 17
    tab = arbitrary_tables(rng, n, S, W, D, pool)
    if hot:
        keys, sidx = _hot_key_rows(rng, tab, pool, r)
    else:
        keys, sidx = _queries(rng, pool, r)      # duplicate rows are common
    row_ts = rng.integers(-1, 14, r).astype(np.int32)
    row_data = rng.random((r, D)).astype(np.float32)
    live = rng.random((n, r)) < 0.6
    now = 21
    want = jax.vmap(
        jref.flic_update_ref,
        in_axes=(0, 0, 0, 0, 0, None, None, None, None, 0, None),
    )(*map(jnp.asarray, (tab["tags"].view(np.int32), tab["data_ts"], tab["valid"],
                          tab["last_use"], tab["data"], keys.view(np.int32), sidx,
                          row_ts, row_data, live)),
      jnp.full((1,), now, jnp.int32))
    args = [as_torch(tab[k]) for k in ("tags", "data_ts", "valid", "last_use", "data")]
    rows = [as_torch(x) for x in (keys, sidx, row_ts, row_data, live)]
    for fn in (ref.flic_update_ref, ops.flic_update):
        got = fn(*args, *rows, now)
        _check(got, want, ("data_ts", "last_use", "data", "n_updates"))
    assert int(np.asarray(want[3]).sum()) > 0


@pytest.mark.parametrize("seed", range(6))
def test_insert_plain_matches_jax_oracle(seed):
    rng = np.random.default_rng(seed)
    pool = key_pool(rng, 12)
    n = 9
    tab = arbitrary_tables(rng, n, S, W, D, pool)
    keys, sidx = _queries(rng, pool, n)
    lanes = dict(
        keys=keys, sidx=sidx,
        line_ts=rng.integers(-1, 14, n).astype(np.int32),
        line_origin=rng.integers(0, n, n).astype(np.int32),
        line_dirty=rng.random(n) < 0.5,
        live=rng.random(n) < 0.75,
        line_data=rng.random((n, D)).astype(np.float32),
    )
    names = ("tags", "data_ts", "ins_ts", "origin", "valid", "dirty", "last_use", "data")
    jargs = [jnp.asarray(tab[k].view(np.int32) if k == "tags" else tab[k]) for k in names]
    jlanes = [jnp.asarray(v.view(np.int32) if k == "keys" else v) for k, v in lanes.items()]
    want = jref.flic_insert_ref(*jargs, *jlanes, jnp.int32(13))
    targs = [as_torch(tab[k]) for k in names] + [as_torch(v) for v in lanes.values()]
    for fn in (ref.flic_insert_ref, ops.flic_insert):
        _check(fn(*targs, 13), want, names)


def _reachable_state(seed, n=6, rounds=30):
    """Caches filled only through insert_rows (one copy of a key per set)."""
    rng = np.random.default_rng(seed)
    pool = key_pool(rng, 40)
    caches = empty_cache(S, W, D, batch=(n,), device="cpu")
    for t in range(rounds):
        keys = as_torch(pool[rng.integers(0, len(pool), n)])
        lines = CacheLine(
            key=keys,
            data_ts=torch.from_numpy(rng.integers(0, t + 1, n).astype(np.int32)),
            origin=torch.arange(n, dtype=torch.int32),
            data=torch.from_numpy(rng.random((n, D)).astype(np.float32)),
            valid=torch.from_numpy(rng.random(n) < 0.9),
            dirty=torch.zeros(n, dtype=torch.bool),
        )
        caches, _ = insert_rows(caches, lines, t)
    return caches, pool, rng


@pytest.mark.parametrize("seed", range(3))
def test_lookup_plain_matches_inline_probe_on_reachable_states(seed):
    caches, pool, rng = _reachable_state(seed)
    keys = as_torch(pool[rng.integers(0, len(pool), 11)])
    sidx = set_index(keys, S)
    results = {}
    for backend in (None, "plain"):
        cfg = tsim.SimConfig(n_nodes=6, cache_lines=S * W, payload_dim=D,
                             probe_backend=backend)
        hit, way, ts, payload_of = tsim._probe_all_caches(cfg, caches, keys, sidx)
        slots = torch.arange(keys.shape[0])
        pays = torch.stack([payload_of(torch.full_like(slots, c), slots) for c in range(6)])
        results[backend] = (hit, torch.where(hit, way, 0), ts, torch.where(hit[..., None], pays, 0.0))
    assert bool(results[None][0].any())
    for a, b in zip(results[None], results["plain"]):
        assert torch.equal(a, b)


def test_wrappers_reject_other_devices():
    t = torch.zeros((1, 1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flic_lookup(t, t, t, t, t[0, 0], t[0, 0])


def test_cache_state_fields_are_the_kernel_tables():
    names = [f.name for f in dataclasses.fields(CacheState)]
    assert names == ["tags", "data_ts", "ins_ts", "origin", "valid", "dirty", "last_use", "data"]
