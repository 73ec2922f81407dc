"""The port's channel, writer ring, store and metrics against the JAX modules."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_numpy, as_torch, jax_series, torch_config

from repro.core import backing_store as jbs
from repro.core import coherence as jco
from repro.core import metrics as jmet
from repro.core import simulator as jsim
from repro.core import workload as jwl
from repro.core import writeback as jwb
from repro_torch.core import backing_store as tbs
from repro_torch.core import coherence as tco
from repro_torch.core import metrics as tmet
from repro_torch.core import writeback as twb


def _assert_fields(got, want, label=""):
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        np.testing.assert_array_equal(
            as_numpy(getattr(got, f.name), like=w), w, err_msg=f"{label}.{f.name}"
        )


# ---------------------------------------------------------------------------
# Loss channel: masks from replayed uniforms equal JAX's masks.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.02, 0.5, 1.0])
def test_bernoulli_mask_from_replayed_uniforms(p):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jco.bernoulli_loss_mask(key, (40, 33), p))
    u = np.asarray(jax.random.uniform(key, (40, 33)))
    np.testing.assert_array_equal(tco.bernoulli_loss_mask(as_torch(u), p).numpy(), want)


@pytest.mark.parametrize("seed", range(3))
def test_gilbert_elliott_from_replayed_uniforms(seed):
    n, r = 24, 5
    jstate = jco.GilbertElliott(bad=jnp.asarray(np.random.default_rng(seed).random(n) < 0.3))
    tstate = tco.GilbertElliott(bad=as_torch(np.asarray(jstate.bad)))
    key = jax.random.PRNGKey(seed)
    for _ in range(5):
        key, k = jax.random.split(key)
        jstate, k_mask = jco.gilbert_elliott_advance(jstate, k)
        k_up, k_dn, _ = jax.random.split(k, 3)
        tstate = tco.gilbert_elliott_advance(
            tstate, as_torch(np.asarray(jax.random.uniform(k_up, (n,)))),
            as_torch(np.asarray(jax.random.uniform(k_dn, (n,)))),
        )
        np.testing.assert_array_equal(tstate.bad.numpy(), np.asarray(jstate.bad))
        receivers = np.random.default_rng(seed).integers(0, n, r).astype(np.int32)
        want = jco.gilbert_elliott_mask(jstate, k_mask, (r, n), receivers=jnp.asarray(receivers))
        u = np.asarray(jax.random.uniform(k_mask, (r, n)))
        got = tco.gilbert_elliott_mask(tstate, as_torch(u), receivers=as_torch(receivers))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        dense = jco.gilbert_elliott_mask(jstate, k_mask, (n, n))
        u = np.asarray(jax.random.uniform(k_mask, (n, n)))
        np.testing.assert_array_equal(
            tco.gilbert_elliott_mask(tstate, as_torch(u)).numpy(), np.asarray(dense)
        )


# ---------------------------------------------------------------------------
# The writer ring over random sequences.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_enqueue_and_drain_match_over_random_sequences(seed):
    rng = np.random.default_rng(seed)
    cap, lanes = 24, 9
    jq, tq = jwb.empty_queue(cap), twb.empty_queue(cap, device="cpu")
    for t in range(40):
        keys = rng.integers(0, 2**32, lanes, dtype=np.uint64).astype(np.uint32)
        ts = np.full(lanes, t, np.int32)
        org = np.arange(lanes, dtype=np.int32)
        mask = rng.random(lanes) < 0.6
        jq, j_acc = jwb.enqueue(jq, keys, ts, org, mask)
        tq, t_acc = twb.enqueue(tq, as_torch(keys), as_torch(ts), as_torch(org), as_torch(mask))
        assert int(t_acc) == int(j_acc)
        ok = bool(rng.random() < 0.7)
        jq, jn, jc = jwb.drain(jq, t, jnp.asarray(ok), 0.7, 3.0, 5)
        tq, tn, tc = twb.drain(tq, t, torch.tensor(ok), 0.7, 3.0, 5)
        assert (int(tn), int(tc)) == (int(jn), int(jc))
        _assert_fields(tq, jq, f"t={t}")


@pytest.mark.parametrize("seed", range(3))
def test_keyed_enqueue_coalesces_like_jax(seed):
    rng = np.random.default_rng(seed)
    cap, ku, lanes = 16, 12, 10
    jq = jwb.empty_queue(cap, key_universe=ku)
    tq = twb.empty_queue(cap, key_universe=ku, device="cpu")
    coalesced = 0
    for t in range(40):
        kids = rng.integers(0, ku, lanes).astype(np.int32)
        ts = np.full(lanes, t, np.int32)
        org = np.arange(lanes, dtype=np.int32)
        mask = rng.random(lanes) < 0.7
        jq, j_acc = jwb.enqueue_keyed(jq, kids, ts, org, mask)
        tq, t_acc = twb.enqueue_keyed(tq, as_torch(kids), as_torch(ts), as_torch(org),
                                      as_torch(mask))
        assert int(t_acc) == int(j_acc)
        jq, jn, _ = jwb.drain(jq, t, jnp.asarray(t % 7 != 3), 1.0, 2.0, 3)
        tq, tn, _ = twb.drain(tq, t, torch.tensor(t % 7 != 3), 1.0, 2.0, 3)
        _assert_fields(tq, jq, f"t={t}")
        want = jwb.drained_entries(jq, jn, 3)
        got = twb.drained_entries(tq, tn, 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        coalesced = int(tq.coalesced)
    assert coalesced > 0
    assert twb.ring_accounting(tq) == jwb.ring_accounting(jq)


# ---------------------------------------------------------------------------
# The store.
# ---------------------------------------------------------------------------

def test_outage_schedule_matches():
    sched = ((3, 4), (5, 10), (20, 2))
    js, ts = jbs.init_store(), tbs.init_store(device="cpu")
    for t in range(30):
        js = jbs.apply_outage_schedule(js, t, sched)
        ts = tbs.apply_outage_schedule(ts, t, sched)
        assert int(ts.outage_until) == int(js.outage_until)
        assert bool(tbs.store_healthy(ts, t)) == bool(jbs.store_healthy(js, t))
    ts = tbs.inject_outage(ts, 40, 5)
    assert int(ts.outage_until) == int(jbs.inject_outage(js, 40, 5).outage_until) == 45


def test_keyed_commits_and_collisions_match():
    rng = np.random.default_rng(3)
    prof = jbs.StoreProfile(collision_prob=0.5)
    tprof = tbs.StoreProfile(collision_prob=0.5)
    js, ts = jbs.init_store(key_universe=10), tbs.init_store(key_universe=10, device="cpu")
    key = jax.random.PRNGKey(0)
    for t in range(25):
        key, k = jax.random.split(key)
        rows = np.int32(rng.integers(0, 4))
        js = jbs.commit_writes(js, rows, 1, k, prof)
        ts = tbs.commit_writes(ts, torch.tensor(rows), torch.tensor(1, dtype=torch.int32),
                               as_torch(np.asarray(jax.random.uniform(k, ()))), tprof)
        kids = rng.integers(0, 10, 4).astype(np.int32)
        vers = rng.integers(0, 30, 4).astype(np.int32)
        mask = rng.random(4) < 0.7
        js = jbs.commit_keyed_rows(js, kids, vers, mask)
        ts = tbs.commit_keyed_rows(ts, as_torch(kids), as_torch(vers), as_torch(mask))
        _assert_fields(ts, js, f"t={t}")
    assert int(ts.lost_writes) > 0


@pytest.mark.parametrize("kind", ["sheets", "db"])
def test_transaction_bytes_match(kind):
    rows = np.array([0, 1, 7, 123456], np.int32)
    jp, tp_ = jbs.StoreProfile(kind=kind), tbs.StoreProfile(kind=kind)
    np.testing.assert_array_equal(
        np.broadcast_to(tp_.read_txn_bytes(as_torch(rows)).numpy(), rows.shape),
        np.broadcast_to(np.asarray(jp.read_txn_bytes(jnp.asarray(rows))), rows.shape))
    np.testing.assert_array_equal(tp_.write_txn_bytes(as_torch(rows)).numpy(),
                                  np.asarray(jp.write_txn_bytes(jnp.asarray(rows))))


# ---------------------------------------------------------------------------
# Metrics.
# ---------------------------------------------------------------------------

def test_tick_metrics_field_order_matches():
    assert tmet.field_names() == tuple(f.name for f in dataclasses.fields(jmet.TickMetrics))
    assert tmet.GAUGE_FIELDS == jmet.GAUGE_FIELDS
    assert tmet.EMBODIMENT_FIELDS == jmet.EMBODIMENT_FIELDS


@pytest.mark.parametrize("scenario", ["paper", "zipf_hot"])
def test_summarize_matches_jax(scenario):
    """Integer fields exactly; float fields to rtol 1e-6, because the two
    frameworks may add up a float32 series in different orders."""
    cfg = jsim.SimConfig(n_nodes=12, cache_lines=32, workload=jwl.SCENARIOS[scenario],
                         outage_schedule=((10, 8),))
    _, series = jsim.run_sim(cfg, 40, seed=0)
    arrays = jax_series(series)
    want = jmet.summarize(series)
    got = tmet.summarize(tmet.TickMetrics(**{k: as_torch(v) for k, v in arrays.items()}))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, k
        else:
            assert got[k] == pytest.approx(w, rel=1e-6, abs=0.0), k
    assert tmet.diff_summaries(got, got) == {}
    assert torch_config(cfg).cache_sets == cfg.cache_sets


def test_latency_sum_follows_xla_contraction():
    """XLA on the CPU compiles ``a*lat_local + b*lat_lan + c*lat_store`` with
    fused multiply-adds; the port's ``_fma32`` chain must give the same
    float32 values, where separate roundings do not."""
    from repro_torch.core.simulator import _fma32

    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(0, 40, 200_000).astype(np.int32) for _ in range(3))
    cfg = jsim.SimConfig(n_nodes=16)
    lat_lan = cfg.lat_lan_base + cfg.lat_lan_per_node * cfg.n_nodes
    want = np.asarray(jax.jit(lambda a, b, c: (
        a.astype(jnp.float32) * cfg.lat_local
        + b.astype(jnp.float32) * lat_lan
        + c.astype(jnp.float32) * cfg.lat_store
    ))(a, b, c))
    ta, tb, tc = (as_torch(x).to(torch.float32) for x in (a, b, c))
    got = _fma32(tc, cfg.lat_store, _fma32(ta, cfg.lat_local, tb * lat_lan))
    np.testing.assert_array_equal(got.numpy(), want)
    separate = ta * cfg.lat_local + tb * lat_lan + tc * cfg.lat_store
    assert (separate.numpy() != want).any()
