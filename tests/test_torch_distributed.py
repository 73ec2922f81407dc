"""The port's distributed engine (``repro_torch.core.distributed``) on the
CPU: spawned ranks over gloo, held bitwise against JAX.

* The 17 committed seed-0 replays at world 4, and the thinned case, all in
  ONE spawned group (a module fixture), one test per fixture; the seed-1
  replays spawn their own group in ``test_torch_distributed_s1.py``.
* World 1, 2 and 4 give the same series, ``wire_bytes`` aside, which must
  equal the ring model at each world.
* JAX's own ``run_distributed_sim`` at 4 forced host devices: its series,
  ``wire_bytes`` and final caches equal the port's on the same draws.
* ``metrics_every`` thins as the fused engine does; bad worlds, backends and
  a failing rank raise.
* ``simulator._merge_replicate`` on a 2-shard split equals the unsplit merge.

Every group has a timeout, so a hang fails its test.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import FIXTURE_CASES, as_numpy, case_seeds
from torch_world4 import GROUP_TIMEOUT, assert_series, check_replay_at_world4, world4_group
from torch_world4 import replay as _replay

from repro_torch.core import workload as wl
from repro_torch.core.distributed import EngineRun, run_distributed_sim, run_group
from repro_torch.core.metrics import field_names
from repro_torch.core.simulator import (
    _delivery_mask_dense,
    _merge_replicate,
    _neighbor_index,
    run_sim,
)

WORLD_CASES = ("paper_outage", "churn_outage", "fanout_topk")
THINNED = ("zipf_thinned", 5)  # case, metrics_every


def _series_dict(series) -> dict:
    return {f: getattr(series, f).numpy() for f in field_names()}


def ring_wire_bytes(cfg, p: int) -> float:
    """The parity tick's collectives under the ring model, written out: the
    (n/p)-flag all-gather, two (n,) int32 pmax, the (n, D) float32 psum and
    2 scalar psums (4 when the workload is mutable)."""
    n, d = cfg.n_nodes, cfg.payload_dim
    scalars = 4 if cfg.workload.mutable else 2
    return float(p * (p - 1) * (n // p) + 2 * (p - 1) * 4 * (2 * n + n * d + scalars))


@pytest.fixture(scope="module")
def world4():
    """Every committed seed-0 replay, and the thinned case, at world 4: one
    group."""
    case, k = THINNED
    cfg, draws, _ = _replay(case)
    return world4_group(0, {"thinned": EngineRun("distributed", cfg, len(draws),
                                                 metrics_every=k, draws=draws)})


@pytest.fixture(scope="module")
def other_worlds():
    """The ``WORLD_CASES`` seed-0 replays at worlds 1 and 2."""
    out = {}
    for world in (1, 2):
        runs = [EngineRun("distributed", cfg, len(draws), draws=draws)
                for cfg, draws, _ in map(_replay, WORLD_CASES)]
        res = run_group(runs, world=world, backend="gloo", device="cpu", timeout=GROUP_TIMEOUT)
        out.update({(case, world): r for case, r in zip(WORLD_CASES, res)})
    return out


@pytest.mark.parametrize("case, seed", [p for p in case_seeds(FIXTURE_CASES) if p.values[1] == 0])
def test_fixture_replays_bitwise_at_world4(world4, case, seed):
    check_replay_at_world4(world4[case, seed], case, seed)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("case", WORLD_CASES)
def test_worlds_agree_and_wire_bytes_follow_the_ring_model(world4, other_worlds, case, world):
    cfg, _, expected = _replay(case)
    res = world4[case, 0] if world == 4 else other_worlds[case, world]
    assert_series(res.series, _series_dict(world4[case, 0].series), f"{case}/world{world}")
    assert_series(res.series, expected, f"{case}/world{world} vs JAX")
    np.testing.assert_array_equal(res.series.wire_bytes.numpy(),
                                  np.full(len(expected["reads"]), ring_wire_bytes(cfg, world),
                                          np.float32))
    if world == 1:
        assert float(res.series.wire_bytes.sum()) == 0.0


@pytest.fixture(scope="module")
def jax_distributed(forced_devices_run, tmp_path_factory):
    """JAX's ``run_distributed_sim`` on 4 forced host devices, the
    ``WORLD_CASES`` at seed 0: series (wire_bytes too) and final caches."""
    path = tmp_path_factory.mktemp("jax_distributed") / "runs.npz"
    forced_devices_run(f"""
        import dataclasses, jax, numpy as np
        from jax.sharding import Mesh
        from conformance import CASES
        from repro.core.distributed import run_distributed_sim
        mesh = Mesh(np.asarray(jax.devices()[:4]), ('data',))
        out = {{}}
        for case in {WORLD_CASES!r}:
            c = CASES[case]
            final, series = run_distributed_sim(mesh, c.cfg, c.ticks, axis='data', seed=0)
            for f in dataclasses.fields(series):
                out[f'{{case}}/metrics.{{f.name}}'] = np.asarray(getattr(series, f.name))
            for f in dataclasses.fields(final.caches):
                out[f'{{case}}/caches.{{f.name}}'] = np.asarray(getattr(final.caches, f.name))
        np.savez({str(path)!r}, **out)
    """, timeout=300, n_devices=4)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("case", WORLD_CASES)
def test_matches_jax_distributed_engine(world4, jax_distributed, case):
    """Series (``wire_bytes`` included) and every field of the final caches,
    gathered in node order, equal JAX's run at 4 devices."""
    res = world4[case, 0]
    want = {k.split("metrics.", 1)[1]: v for k, v in jax_distributed.items()
            if k.startswith(f"{case}/metrics.")}
    assert_series(res.series, want, f"{case} vs JAX distributed", skip=())
    for f in dataclasses.fields(res.state.caches):
        jx = jax_distributed[f"{case}/caches.{f.name}"]
        np.testing.assert_array_equal(as_numpy(getattr(res.state.caches, f.name), jx), jx,
                                      err_msg=f"{case}: caches.{f.name}")


def test_thinned_series_matches_the_fused_engine(world4):
    case, k = THINNED
    cfg, draws, _ = _replay(case)
    _, fused = run_sim(cfg, len(draws), device="cpu", draws=draws, metrics_every=k)
    got = world4["thinned"].series
    assert got.reads.shape == (len(draws) // k,)
    assert_series(got, _series_dict(fused), f"{case} thinned by {k}")


def test_bad_world_backend_and_metrics_window_raise():
    cfg, draws, _ = _replay("paper")
    with pytest.raises(ValueError, match="must divide"):
        run_distributed_sim(cfg, 4, world=3, backend="gloo", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        run_distributed_sim(cfg, 4, world=torch.cuda.device_count() + 1, backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        run_distributed_sim(cfg, 4, world=2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="divisible by metrics_every"):
        run_distributed_sim(cfg, 10, world=2, backend="gloo", device="cpu", metrics_every=3)


def test_a_failing_rank_raises_in_the_caller():
    cfg, draws, _ = _replay("paper")
    shifted = [dataclasses.replace(d, t=d.t + 1) for d in draws[:3]]
    with pytest.raises(RuntimeError, match="rank .* failed"):
        run_distributed_sim(cfg, 3, world=2, backend="gloo", device="cpu", draws=shifted,
                            timeout=GROUP_TIMEOUT)


def test_merge_replicate_on_two_shards_equals_the_unsplit_merge():
    """A ``paper_replicate`` tick's merge run on each half of the fog with
    the half's node ids equals the merge of the whole fog, bitwise."""
    cfg, draws, _ = _replay("paper_replicate")
    state, _ = run_sim(cfg, 20, device="cpu", draws=draws[:20])
    d = draws[20]
    half = cfg.n_nodes // 2
    rows = wl.plan_write_rows(cfg, d.plan, 0, d.t)
    delivered = _delivery_mask_dense(cfg, state.channel, d.u_deliver,
                                     _neighbor_index(cfg, "cpu"), "cpu")
    assert bool(delivered.any()) and not bool(delivered.all())
    whole = _merge_replicate(state.caches, rows, delivered, d.t)
    parts = []
    for lo in (0, half):
        shard = type(state.caches)(*(getattr(state.caches, f.name)[lo:lo + half].clone()
                                     for f in dataclasses.fields(state.caches)))
        parts.append(_merge_replicate(shard, rows, delivered[lo:lo + half], d.t,
                                      node_ids=torch.arange(lo, lo + half, dtype=torch.int32)))
    for f in dataclasses.fields(whole):
        got = torch.cat([getattr(p, f.name) for p in parts])
        assert torch.equal(got, getattr(whole, f.name)), f.name
    # Without the shard's ids the second half takes rows of nodes 0-7 as its
    # own (live though lost) and its own rows as others' (lost where lost).
    second = type(state.caches)(*(getattr(state.caches, f.name)[half:].clone()
                                  for f in dataclasses.fields(state.caches)))
    wrong = _merge_replicate(second, rows, delivered[half:], d.t)
    assert any(not torch.equal(getattr(wrong, f.name), getattr(whole, f.name)[half:])
               for f in dataclasses.fields(whole))
