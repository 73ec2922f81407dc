"""The writer ring (``core/writeback.py``, ``simulator._resolve_backstop{,_keyed}``)
and its CUDA kernels (``kernels/ops.py::ring_*``, ``csrc/ring.cu``).

On the CPU the ring's calls run the plain versions (``kernels/ref.py``):
``DIGESTS`` are sha256 digests of what the six calls returned before the
kernels existed, over seeded random sequences that cross the ring's edges
(overflow drops, coalescing, several lanes of one key, the monotone index
past capacity and past 2**31, failed stores and the backoff, out-of-range
key ids).  The tests marked ``card`` hold each kernel bit for bit against
its plain version on the card and skip without one; run them there with
``python -m pytest -q -m card tests/test_torch_ring.py``.  No JAX here: the
file runs on the card.
"""
import collections
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import backing_store as bs
from repro_torch.core import replay
from repro_torch.core import simulator as sim
from repro_torch.core import workload as wl
from repro_torch.core import writeback as wb
from repro_torch.kernels import ops, ref

I32 = torch.int32


def _feed(h, *tensors) -> None:
    for t in tensors:
        t = torch.as_tensor(t).detach().cpu()
        h.update(str(t.dtype).encode() + str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())


def _queue_fields(q: wb.WriteQueue):
    return [getattr(q, f.name) for f in dataclasses.fields(q)]


def _t(a, device, dtype=I32):
    return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)


def _lanes(rng, r, lo, hi, device):
    return _t(rng.integers(lo, hi, r, dtype=np.int64), device)


# Drain arguments per step: (rate_per_tick, burst, max_per_tick, backoff_base, backoff_max).
DRAIN_ARGS = ((0.7, 3.0, 5, 1, 64), (1 / 3, 2.5, 7, 2, 16), (5.0, 100.0, 64, 1, 64),
              (0.1, 1.0, 3, 1, 4))


def _start(q: wb.WriteQueue, start: int, device) -> wb.WriteQueue:
    """``q`` with head and tail moved to the monotone index ``start``."""
    s = torch.full((), start, dtype=I32, device=device)
    return dataclasses.replace(q, head=s, tail=s.clone())


def _store_ok(rng, step: int, device) -> torch.Tensor:
    """The store's health at ``step``: down through steps 30-59 (the backoff
    doubles to its cap, the tokens fill to the burst), else up 60% of steps."""
    return _t(not 30 <= step < 60 and rng.random() < 0.6, device, torch.bool)


def fifo_digest(device, start: int = 0, steps: int = 90, cap: int = 64, r: int = 40,
                drain_args=DRAIN_ARGS) -> str:
    """Digest of the FIFO ring's calls (``enqueue``, ``drain``,
    ``_resolve_backstop``) over a seeded sequence from index ``start``, on
    a ring of ``cap`` slots and ``r`` lanes."""
    rng = np.random.default_rng(2900 + (start & 0xFFFF))
    q = _start(wb.empty_queue(cap, device=device), start, device)
    store = bs.init_store(device=device)
    h = hashlib.sha256()
    for step in range(steps):
        p_write = (0.0, 0.3, 1.0, 0.6)[step % 4]
        q, n_acc = wb.enqueue(
            q, _lanes(rng, r, -2**31, 2**31, device), _lanes(rng, r, 0, 2**31, device),
            _lanes(rng, r, -1, 1000, device), _t(rng.random(r) < p_write, device, torch.bool))
        _feed(h, *_queue_fields(q), n_acc)
        rate, burst, most, base, bmax = drain_args[step % len(drain_args)]
        q, n, calls = wb.drain(q, start + step, _store_ok(rng, step, device), rate, burst,
                               most, base, bmax)
        _feed(h, *_queue_fields(q), n, calls)
        tail = int(q.tail)
        store = dataclasses.replace(
            store, drained_total=_t(int(q.head) - int(rng.integers(0, 20)), device))
        enq_idx = _lanes(rng, r, max(-2**31, tail - 2 * cap), min(2**31, tail + 8), device)
        out = sim._resolve_backstop(q, store, _t(rng.random() < 0.7, device, torch.bool),
                                    _t(rng.random(r) < 0.6, device, torch.bool), enq_idx)
        _feed(h, *out)
    return h.hexdigest()


def keyed_digest(device, start: int = 0, steps: int = 90, cap: int = 32, ku: int = 48,
                 r: int = 40, drain_args=DRAIN_ARGS) -> str:
    """Digest of the keyed ring's calls (``enqueue_keyed``, ``drain``,
    ``drained_entries``, ``_resolve_backstop_keyed``) over a seeded
    sequence from index ``start``, on a ring of ``cap`` slots, ``ku`` keys
    and ``r`` lanes; key ids run past the universe (those lanes are masked
    off below 0, where the plain scatter refuses them)."""
    rng = np.random.default_rng(2901 + (start & 0xFFFF))
    q = _start(wb.empty_queue(cap, key_universe=ku, device=device), start, device)
    store = bs.init_store(ku, device=device)
    h = hashlib.sha256()
    for step in range(steps):
        p_write = (0.0, 0.3, 1.0, 0.6)[step % 4]
        kids = rng.integers(-3, ku + 3, r)
        mask = (rng.random(r) < p_write) & (kids >= 0)
        q, n_acc = wb.enqueue_keyed(q, _t(kids, device), _lanes(rng, r, 0, 2**31, device),
                                    _lanes(rng, r, -1, 1000, device),
                                    _t(mask, device, torch.bool))
        _feed(h, *_queue_fields(q), n_acc)
        rate, burst, most, base, bmax = drain_args[step % len(drain_args)]
        q, n, calls = wb.drain(q, start + step, _store_ok(rng, step, device), rate, burst,
                               most, base, bmax)
        _feed(h, *_queue_fields(q), n, calls)
        _feed(h, *wb.drained_entries(q, n, most))
        store = dataclasses.replace(store, table_ts=_lanes(rng, ku, -1, 100, device))
        out = sim._resolve_backstop_keyed(
            q, store, _t(rng.random() < 0.7, device, torch.bool),
            _t(rng.random(r) < 0.6, device, torch.bool), _lanes(rng, r, -3, ku + 3, device))
        _feed(h, *out)
    return h.hexdigest()


SEQUENCES = {
    "fifo": lambda dev: fifo_digest(dev),
    "fifo_past_int32": lambda dev: fifo_digest(dev, start=2**31 - 300),
    "keyed": lambda dev: keyed_digest(dev),
    "keyed_past_int32": lambda dev: keyed_digest(dev, start=2**31 - 300),
}

DIGESTS = {
    "fifo": "bc0090c620fb98617d23feed8b77158593a3118128d8dc2d1389b87dd2f5c699",
    "fifo_past_int32": "c4e06eecc62fc59a9b611a4c632ed7da429cf2c1bb9a7f35c80ea029e6e760ff",
    "keyed": "49f8e5a11341e1fe82bf1692d3dc197926de0f927a7d2e7322bb97572e1cb589",
    "keyed_past_int32": "6f8d830d6a2a06a45e49aa11f9964f925911dbb470d537b331eb3d8f9c699f50",
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ring_calls_unchanged_on_cpu(name):
    assert SEQUENCES[name]("cpu") == DIGESTS[name]


def _snapshot(q: wb.WriteQueue) -> list:
    return [t.clone() for t in _queue_fields(q)]


def _unchanged(q: wb.WriteQueue, snapshot: list) -> bool:
    return all(_same(a, b) for a, b in zip(_queue_fields(q), snapshot))


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal dtype, shape and bits."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.float32:
        got, want = got.view(I32), want.view(I32)
    return torch.equal(got.cpu(), want.cpu())


def _busy_ring(device, keyed: bool) -> tuple[wb.WriteQueue, bs.StoreState]:
    """A ring with pending rows, drained rows and (keyed) a slot map, from
    a few seeded enqueues and drains."""
    rng = np.random.default_rng(29)
    cap, ku, r = 64, 48, 40
    q = wb.empty_queue(cap, key_universe=ku if keyed else 0, device=device)
    for step in range(6):
        mask = _t(rng.random(r) < 0.7, device, torch.bool)
        ts, org = _lanes(rng, r, 0, 100, device), _lanes(rng, r, 0, 100, device)
        if keyed:
            q, _ = wb.enqueue_keyed(q, _lanes(rng, r, 0, ku, device), ts, org, mask)
        else:
            q, _ = wb.enqueue(q, _lanes(rng, r, -2**31, 2**31, device), ts, org, mask)
        q, _, _ = wb.drain(q, step, _t(True, device, torch.bool), 5.0, 100.0, 7)
    store = dataclasses.replace(bs.init_store(ku if keyed else 0, device=device),
                                drained_total=q.head.clone())
    return q, store


def _every_call(q: wb.WriteQueue, store: bs.StoreState, device) -> None:
    """Each of the ring's calls on ``q`` once (the keyed or the FIFO ones)."""
    rng = np.random.default_rng(30)
    r = 40
    mask = _t(rng.random(r) < 0.7, device, torch.bool)
    ts, org = _lanes(rng, r, 0, 100, device), _lanes(rng, r, 0, 100, device)
    need = _t(rng.random(r) < 0.6, device, torch.bool)
    healthy = _t(False, device, torch.bool)
    if q.key_universe:
        kids = _lanes(rng, r, 0, q.key_universe, device)
        wb.enqueue_keyed(q, kids, ts, org, mask)
        sim._resolve_backstop_keyed(q, store, healthy, need, kids)
        wb.drained_entries(q, _t(3, device), 7)
    else:
        wb.enqueue(q, _lanes(rng, r, -2**31, 2**31, device), ts, org, mask)
        sim._resolve_backstop(q, store, healthy, need, _lanes(rng, r, 0, int(q.tail), device))
    wb.drain(q, 100, healthy, 0.7, 3.0, 5)


@pytest.mark.parametrize("keyed", (False, True), ids=("fifo", "keyed"))
def test_calls_leave_the_parent_ring_unchanged_on_cpu(keyed):
    q, store = _busy_ring("cpu", keyed)
    before = _snapshot(q)
    _every_call(q, store, "cpu")
    assert _unchanged(q, before)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    ops.reset_launches()
    return torch.device("cuda")


@pytest.fixture
def held(cuda, monkeypatch):
    """Every ``ops.ring_*`` call on CUDA tensors, wherever it comes from,
    held to its plain version on the same inputs: one launch of its own
    kernel and no other, every output bit for bit, the inputs unchanged.
    Counts those calls (calls on CPU tensors pass as they are)."""
    calls = collections.Counter()

    def holding(name):
        kernel, plain = getattr(ops, name), getattr(ref, f"{name}_ref")

        def call(*args):
            if not any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                return kernel(*args)
            before = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            launches = dict(ops.LAUNCHES)
            got = kernel(*args)
            torch.cuda.synchronize()
            launched = {k: v - launches[k] for k, v in ops.LAUNCHES.items() if v != launches[k]}
            assert launched == {name: 1}, (name, launched)
            want = plain(*args)
            assert len(got) == len(want), name
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.device == w.device and _same(g, w), (name, i)
            for i, (a, b) in enumerate(zip(args, before)):
                assert not isinstance(a, torch.Tensor) or _same(a, b), (name, "input", i)
            calls[name] += 1
            return got

        return call

    for name in ops.RING_ENTRIES:
        monkeypatch.setattr(ops, name, holding(name))
    return calls


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ring_calls_unchanged_on_the_card(held, cuda, name):
    assert SEQUENCES[name](cuda) == DIGESTS[name]
    keyed = name.startswith("keyed")
    engaged = {"ring_drain", *(("ring_enqueue_keyed", "ring_backstop_keyed", "ring_drained")
                              if keyed else ("ring_enqueue", "ring_backstop"))}
    assert set(held) == engaged and all(n >= 90 for n in held.values())


# The cells' shapes: an 8,192-slot ring drained 64 rows an API call; 1,000
# lanes (the dense cells) or 10,000 (the city); 1,024 or 4,096 keys.
CELL_DRAIN = ((5.0, 100.0, 64, 1, 64), (0.7, 3.0, 64, 1, 64), (1 / 3, 2.5, 64, 2, 16))
CELL_SHAPES = {
    "fifo_r1000": lambda dev: fifo_digest(dev, start=5, steps=40, cap=8192, r=1000,
                                          drain_args=CELL_DRAIN),
    "fifo_r1000_past_int32": lambda dev: fifo_digest(dev, start=2**31 - 20_000, steps=40,
                                                     cap=8192, r=1000, drain_args=CELL_DRAIN),
    "keyed_k1024_r1000": lambda dev: keyed_digest(dev, start=5, steps=40, cap=8192, ku=1024,
                                                  r=1000, drain_args=CELL_DRAIN),
    "keyed_k4096_r10000": lambda dev: keyed_digest(dev, start=6, steps=40, cap=8192, ku=4096,
                                                   r=10_000, drain_args=CELL_DRAIN),
    "keyed_k4096_r10000_past_int32": lambda dev: keyed_digest(
        dev, start=2**31 - 20_000, steps=40, cap=8192, ku=4096, r=10_000,
        drain_args=CELL_DRAIN),
}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELL_SHAPES))
def test_kernels_match_plain_at_the_cells_shapes(held, cuda, name):
    assert CELL_SHAPES[name](cuda) == CELL_SHAPES[name]("cpu")
    assert held["ring_drain"] == 40


def _wrap(v):
    """Python ints as int32 bit patterns (the monotone counters wrap)."""
    return (np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31


def _queue(device, cap: int, ku: int, head: int, size: int, seed: int) -> wb.WriteQueue:
    """A ring of ``size`` pending rows from monotone index ``head``; keyed:
    distinct keys hold distinct indices of the ring's last ``cap + size``
    (drained or pending), the rest -1, as a ring reaches."""
    rng = np.random.default_rng(seed)
    q = wb.empty_queue(cap, key_universe=ku, device=device)
    fields = dict(keys=_lanes(rng, cap, 0, max(ku, 2), device),
                  data_ts=_lanes(rng, cap, 0, 1000, device),
                  origin=_lanes(rng, cap, 0, 1000, device),
                  head=_t(_wrap(head), device), tail=_t(_wrap(head + size), device))
    if ku:
        slots = np.full(ku, -1, np.int64)
        held_keys = rng.permutation(ku)[:min(ku, cap + size)]
        slots[held_keys] = head - cap + rng.permutation(cap + size)[:len(held_keys)]
        slots[rng.random(ku) < 0.2] = -1
        fields["slot_of_key"] = _t(_wrap(slots), device)
    return dataclasses.replace(q, **fields)


EDGE_CASES = ("full", "room_5", "all_masked_off", "no_lanes", "one_key_many_lanes",
              "pending_keys", "past_capacity", "past_int32", "out_of_range_keys")


def _edge(case: str, device, keyed: bool):
    """(queue, keys or key ids, mask) of one edge case of an enqueue."""
    cap, ku, r = 64, (96 if keyed else 0), 40
    rng = np.random.default_rng(EDGE_CASES.index(case))
    head, size = {"full": (0, cap), "room_5": (3, cap - 5), "past_capacity": (10 * cap + 5, 20),
                  "past_int32": (2**31 - 30, 20)}.get(case, (7, 20))
    q = _queue(device, cap, ku, head, size, seed=EDGE_CASES.index(case))
    kids = rng.integers(0, ku if keyed else 2**31, r)
    mask = rng.random(r) < 0.8
    if case == "all_masked_off":
        mask[:] = False
    if case == "no_lanes":
        kids, mask = kids[:0], mask[:0]
    if case == "one_key_many_lanes":
        kids[::3] = kids[0]
    if case == "pending_keys" and keyed:
        slots = q.slot_of_key.cpu().numpy()
        pending = np.flatnonzero((slots >= head) & (slots < head + size))[:r]
        assert len(pending) > 0
        kids[:len(pending)] = pending
    if case == "out_of_range_keys" and keyed:
        kids[::4] = ku + np.arange(len(kids[::4]))          # masked or not: dropped
        kids[1::4] = -1 - np.arange(len(kids[1::4]))
        mask[1::4] = False                                    # the plain scatter refuses these
    return q, _t(kids, device), _t(mask, device, torch.bool)


@pytest.mark.card
@pytest.mark.parametrize("keyed", (False, True), ids=("fifo", "keyed"))
@pytest.mark.parametrize("case", EDGE_CASES)
def test_enqueue_edge_cases(held, cuda, case, keyed):
    q, kids, mask = _edge(case, cuda, keyed)
    r = kids.shape[0]
    ts, org = _t(np.arange(r) + 7, cuda), _t(np.arange(r) % 5, cuda)
    if keyed:
        q2, n = wb.enqueue_keyed(q, kids, ts, org, mask)
    else:
        q2, n = wb.enqueue(q, kids, ts, org, mask)
    assert held == {("ring_enqueue_keyed" if keyed else "ring_enqueue"): 1}
    if case == "full":
        assert int(n) == 0 and int(q2.tail) == int(q.tail)
    store = dataclasses.replace(bs.init_store(q.key_universe, device=cuda),
                                drained_total=q.head.clone(),
                                table_ts=_lanes(np.random.default_rng(1), q.key_universe, -1, 50,
                                                cuda))
    need = _t(np.ones(r, bool), cuda, torch.bool)
    for healthy in (True, False):
        ok = _t(healthy, cuda, torch.bool)
        if keyed:
            sim._resolve_backstop_keyed(q2, store, ok, need, kids)
        else:
            sim._resolve_backstop(q2, store, ok, need, q2.tail - 1 - _t(np.arange(r) * 3, cuda))
        wb.drained_entries(q2, _t(min(r, 5), cuda), 8)


DRAIN_CASES = {
    # (tokens, backoff, next_retry, store_ok, now, rate, burst, most, base, bmax)
    "failed_store_doubles": (5.0, 8, 0, False, 10, 0.7, 3.0, 5, 1, 64),
    "failed_store_at_cap": (5.0, 48, 0, False, 10, 0.7, 3.0, 5, 1, 64),
    "failed_from_healthy": (5.0, 0, 0, False, 10, 0.7, 3.0, 5, 2, 16),
    "before_retry": (5.0, 8, 12, True, 10, 0.7, 3.0, 5, 1, 64),
    "tokens_at_burst": (3.0, 0, 0, True, 10, 0.7, 3.0, 5, 1, 64),
    "tokens_short": (0.2, 0, 0, True, 10, 0.7, 3.0, 5, 1, 64),
    "rate_rounds": (0.0, 0, 0, True, 10, 1 / 3, 2.5, 64, 1, 64),
    "retry_succeeds": (5.0, 16, 10, True, 10, 5.0, 100.0, 64, 1, 64),
}


@pytest.mark.card
@pytest.mark.parametrize("size", (0, 3, 200))
@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_drain_edge_cases(held, cuda, case, size):
    tokens, backoff, retry, ok, now, rate, burst, most, base, bmax = DRAIN_CASES[case]
    q = dataclasses.replace(_queue(cuda, 256, 0, 2**31 - 100, size, seed=size),
                            tokens=torch.tensor(tokens, dtype=torch.float32, device=cuda),
                            backoff=_t(backoff, cuda), next_retry=_t(retry, cuda))
    q2, n, calls = wb.drain(q, now, _t(ok, cuda, torch.bool), rate, burst, most, base, bmax)
    wb.drained_entries(q2, n, most)
    assert held == {"ring_drain": 1, "ring_drained": 1}
    if case.startswith("failed") and size:
        assert int(q2.backoff) == min(max(2 * backoff, base), bmax) and int(n) == 0


# ---------------------------------------------------------------------------
# The tick on the card against the tick on the CPU.
# ---------------------------------------------------------------------------

TICKS = 200


def cell_config(cell: str, n: int = 64):
    """The cells' configurations at N = ``n`` nodes, their ring cut to 512
    rows drained 4 a call so that it saturates and coalesces as theirs do."""
    spec = {
        "dense1k_ycsb_a": wl.WorkloadSpec(
            popularity="trace", key_universe=1024,
            trace=wl.TraceSpec(source="ycsb", read_fraction=0.5, zipf_alpha=0.99, length=TICKS,
                               seed=29)),
        "city10k_zipf": wl.WorkloadSpec(popularity="zipf", key_universe=4096, zipf_alpha=0.9,
                                        fanout=32),
        "dense1k_stream": wl.WorkloadSpec(popularity="stream"),
    }[cell]
    return sim.SimConfig(n_nodes=n, insert_policy="directory", queue_capacity=512,
                         writer_max_per_tick=4, workload=spec, probe_backend="cuda")


def _cpu_draws(cfg, ticks: int, seed: int) -> list:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    plan = sim.init_sim(cfg, "cpu").plan
    draws = []
    for t in range(ticks):
        draws.append(sim.draw_tick(cfg, plan, t, gen))
        plan = draws[-1].plan.state_next
    return draws


@pytest.mark.card
@pytest.mark.parametrize("cell", ("dense1k_ycsb_a", "city10k_zipf", "dense1k_stream"))
def test_run_sim_on_the_card_equals_the_cpu(cuda, cell):
    cfg = cell_config(cell)
    draws = _cpu_draws(cfg, TICKS, seed=2029)
    state_cpu, series_cpu = sim.run_sim(cfg, TICKS, device="cpu", draws=draws)
    on_card = replay.draws_from_arrays(cfg, replay.draws_to_arrays(draws), cuda)
    ops.reset_launches()
    state, series = sim.run_sim(cfg, TICKS, device=cuda, draws=on_card)
    torch.cuda.synchronize()
    for f in dataclasses.fields(series):
        assert _same(getattr(series, f.name), getattr(series_cpu, f.name)), f.name
    want = sim.state_to_numpy(state_cpu)
    for path, got in sim.state_to_numpy(state).items():
        assert got.dtype == want[path].dtype and np.array_equal(
            np.atleast_1d(got).view(np.uint8), np.atleast_1d(want[path]).view(np.uint8)), path
    keyed = cfg.workload.mutable
    engaged = ({"ring_enqueue_keyed", "ring_backstop_keyed", "ring_drain", "ring_drained"}
               if keyed else {"ring_enqueue", "ring_backstop", "ring_drain"})
    ring = {k: ops.LAUNCHES[k] for k in ops.RING_ENTRIES}
    waves = cfg.workload.plan_waves
    assert ring == {k: (TICKS * (waves if "enqueue" in k else 1) if k in engaged else 0)
                    for k in ops.RING_ENTRIES}
    assert int(state.queue.dropped) > 0 and (not keyed or int(state.queue.coalesced) > 0)
