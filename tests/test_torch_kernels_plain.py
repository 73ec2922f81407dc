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


# (W, D) of the kernels' instantiations: W = 1, 2, 4, 8 have their own, D
# % 4 == 0 moves the payload as float4.  (4, 3) is the original shape.
SHAPES = [(1, 3), (2, 8), (4, 3), (4, 8), (8, 8)]
LOOKUP_CASES = ([(q, seed, 4, 3) for q in (1, 13, 67) for seed in range(4)]
                + [(q, seed, w, d) for w, d in SHAPES if (w, d) != (4, 3)
                   for q in (13, 67) for seed in range(2)])


def _shape_id(w, d):
    return "" if (w, d) == (4, 3) else f"w{w}d{d}-"


@pytest.mark.parametrize("q,seed,w,d", LOOKUP_CASES,
                         ids=[f"{_shape_id(w, d)}{q}-{seed}" for q, seed, w, d in LOOKUP_CASES])
def test_lookup_plain_matches_jax_oracle(q, seed, w, d):
    rng = np.random.default_rng(seed)
    pool = key_pool(rng)
    tab = arbitrary_tables(rng, 6, S, w, d, pool)
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


INSERT_CASES = ([(seed, 4, 3) for seed in range(6)]
                + [(seed, w, d) for w, d in SHAPES if (w, d) != (4, 3) for seed in range(3)])


@pytest.mark.parametrize("seed,w,d", INSERT_CASES,
                         ids=[f"{_shape_id(w, d)}{seed}" for seed, w, d in INSERT_CASES])
def test_insert_plain_matches_jax_oracle(seed, w, d):
    rng = np.random.default_rng(seed)
    pool = key_pool(rng, 12)
    n = 9
    tab = arbitrary_tables(rng, n, S, w, d, pool)
    keys, sidx = _queries(rng, pool, n)
    lanes = dict(
        keys=keys, sidx=sidx,
        line_ts=rng.integers(-1, 14, n).astype(np.int32),
        line_origin=rng.integers(0, n, n).astype(np.int32),
        line_dirty=rng.random(n) < 0.5,
        live=rng.random(n) < 0.75,
        line_data=rng.random((n, d)).astype(np.float32),
    )
    names = ("tags", "data_ts", "ins_ts", "origin", "valid", "dirty", "last_use", "data")
    jargs = [jnp.asarray(tab[k].view(np.int32) if k == "tags" else tab[k]) for k in names]
    jlanes = [jnp.asarray(v.view(np.int32) if k == "keys" else v) for k, v in lanes.items()]
    want = jref.flic_insert_ref(*jargs, *jlanes, jnp.int32(13))
    targs = [as_torch(tab[k]) for k in names] + [as_torch(v) for v in lanes.values()]
    for fn in (ref.flic_insert_ref, ops.flic_insert):
        _check(fn(*targs, 13), want, names)


# (W, D, aligned) -> the instantiation both wrappers pick: a 16-byte row
# needs aligned tables and W > 1, a float4 payload aligned storage and
# D % 4 == 0; W outside (1, 2, 4, 8) takes the runtime-W loop (ways 0).
PLAN_CASES = {
    "w4_d8_aligned": ((4, 8, True), ops.RowPlan(4, True, True)),
    "w4_d8_offset": ((4, 8, False), ops.RowPlan(4, False, False)),
    "w3_d8_aligned": ((3, 8, True), ops.RowPlan(0, False, True)),
    "w4_d3_aligned": ((4, 3, True), ops.RowPlan(4, True, False)),
    "w1_d8_aligned": ((1, 8, True), ops.RowPlan(1, False, True)),
}


def _at(t, aligned):
    """``t`` itself, or a contiguous copy 4 bytes past a 16-byte boundary
    (a view into a larger buffer, reshaped)."""
    assert t.data_ptr() % 16 == 0
    if aligned:
        return t
    skip = 4 // t.element_size()
    buf = torch.zeros(t.numel() + skip, dtype=t.dtype)
    view = buf[skip:].view(t.shape)
    view.copy_(t)
    return view


def _tables(rng, n, n_sets, w, d):
    tab = arbitrary_tables(rng, n, n_sets, w, d, key_pool(rng))
    return [as_torch(tab[k]) for k in ("tags", "data_ts", "ins_ts", "origin", "valid",
                                        "dirty", "last_use", "data")]


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_insert_plan_picks_the_instantiation(case):
    (w, d, aligned), want = PLAN_CASES[case]
    assert ops.row_plan(w, d, aligned) == want
    assert want in ops.row_plans()
    rng = np.random.default_rng(0)
    n = 5
    tables = [_at(t, aligned) for t in _tables(rng, n, 6, w, d)]
    lanes = [torch.zeros(n, dtype=torch.int32)] * 5 + [torch.ones(n, dtype=torch.bool)]
    line_data = _at(torch.zeros((n, d)), aligned)
    assert ops.insert_plan_for(*tables, *lanes, line_data, 3) == want
    # one misaligned input is enough to take the scalar path
    mixed = ops.insert_plan_for(*tables, *lanes, _at(line_data.clone(), False), 3)
    assert mixed == ops.row_plan(w, d, False)


@pytest.mark.parametrize("case", list(PLAN_CASES))
@pytest.mark.parametrize("n_sets,q", [(50, 1000), (50, 67), (8192, 1000)])
def test_lookup_plan_picks_the_instantiation(case, n_sets, q):
    """The lookup takes the insert's rule, whatever S and Q."""
    (w, d, aligned), want = PLAN_CASES[case]
    rng = np.random.default_rng(1)
    tags, data_ts, _, _, valid, _, _, data = _tables(rng, 1, n_sets, w, d)
    keys = torch.zeros(q, dtype=torch.int32)
    args = [_at(t, aligned) for t in (tags, data_ts, valid, data)]
    assert ops.lookup_plan_for(*args, keys, keys) == want
    if aligned:
        args[2] = _at(args[2], False)   # the valid flags alone off a boundary
        assert ops.lookup_plan_for(*args, keys, keys) == ops.row_plan(w, d, False)


def test_plans_stay_within_the_instantiations():
    plans = set(ops.row_plans())
    for w in range(1, 41):
        for d in range(1, 17):
            for aligned in (False, True):
                assert ops.row_plan(w, d, aligned) in plans
    assert len(plans) == 13


@pytest.mark.parametrize("n,threads", [(1, 32), (1000, 32), (8447, 32), (8448, 128), (10_000, 128)])
def test_insert_block_size(n, threads):
    assert ops.insert_threads(n, 132) == threads


@pytest.mark.parametrize("q,threads", [(1, 32), (32, 32), (67, 96), (256, 256), (1000, 256)])
def test_lookup_block_size(q, threads):
    assert ops.lookup_threads(q) == threads


def test_alignment_of_offset_views():
    buf = torch.zeros(65, dtype=torch.float32)
    assert ops._aligned(buf)
    view = buf[1:].view(4, 16)
    assert view.is_contiguous() and not ops._aligned(view)
    assert not ops._aligned(buf, view)


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
