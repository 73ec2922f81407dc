#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FLIC fog cache, its serving engine
and its Mamba2 model on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, then runs these phases, each printing one JSON line:

1. ``device``: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions;
2. ``build``: the build time of the kernels and ``ptxas``'s resource lines;
3. ``kernels``: each kernel against its plain PyTorch version (bitwise),
   first on the inputs the main path gives it (copied from one tick of the
   dense and the city cell), then on arbitrary states at the same shapes
   (for ``flic_update`` also a hot-key state, where ~R rows race for one
   line, and a table too large for the kernel's shared memory, swept in
   ranges of sets); with the median time of 20 runs of each and the card's
   time bound for the bytes that those inputs need;
4. ``replay``: the committed JAX replays (``src/repro_torch/testdata``)
   through ``run_sim`` with the kernels; the ``TickMetrics`` series must
   equal JAX's bitwise;
5. ``dense``: the main path, N=1,000 nodes, dense gossip, the ``zipf_hot``
   workload (the coherence sweep is live), Gilbert-Elliott loss and a store
   outage, 600 ticks, with the kernels and with the inline path; the two
   series must be equal and each kernel must have launched;
6. ``city``: the paper's stream at N=10,000 nodes with fan-out 32, 120
   ticks, with the kernels and with the inline path; equal series;
7. ``serve``: the second main path, Granite-8B at full width (random
   bfloat16 weights from seed 0) serving 8 requests (4 prompts of 512
   tokens, each twice, 32 new tokens, 4 slots, page 16) through
   ``ServeEngine`` with the ``paged_attention`` kernel, which must launch
   once per layer and decode step; again with every kernel call held
   against the plain version on the same inputs; then teacher-forced with
   the plain version and with a contiguous-cache ``decode_step`` oracle,
   which must agree within ``SERVE_TOL``; prefill and decode times, a
   profile of one decode step, peak memory and the page manager's stats;
8. ``kernels`` (``paged_attention``): the kernel against its plain version
   on the serve run's inputs (decode step 20, layer 0), on a long context
   (16 sequences of up to 32,768 positions), on edge cases and on lengths
   placed against the kernel's split plan (on and inside split boundaries,
   0, fewer live splits; a float32 long context), on shapes that reach the
   kernel's other instances, with times, bounds and a
   ``scaled_dot_product_attention`` yardstick; two calls give the same
   bits, and a bad page id in the first or the last live slot gives NaN
   for its sequence alone;
9. ``serve_replay``: the committed JAX serving fixture through the port
   with the kernel, teacher-forced, including a tight pool that evicts,
   spills and fetches pages back; the page manager's stats must equal
   JAX's;
10. ``merge``: ``flic_merge``'s path, its entry ``ops.flic_merge``
    reconciling the dense cell's tables frozen at the outage's start (tick
    300) with those at its end (tick 420), launched once;
11. ``kernels`` (``flic_merge``): the kernel against its plain version
    (bitwise) on that catch-up, on ``kernels_bench.py``'s geometry and on
    random replicas with ties and invalid lines, timed and bound;
12. ``ssm``: the third main path, Mamba2-370M at full width (random
    weights from seed 0), 4 prompts of 2,048 tokens prefilled and decoded
    32 greedy steps with the ``ssd_scan`` kernel (48 launches, one a layer
    of the prefill); the plain scan must give the same prefill logits,
    states and tokens bit for bit, and every kernel call equals the plain
    version on its inputs; one more prefill with Mamba2's published
    ``a_log``/``dt_bias`` draws, whose chunk decays are not 0, held kernel
    against plain in the same way; prefill and decode times, profiles of a decode
    step and a prefill, peak memory, the share of chunk decays that are 0,
    and decode step k against a prefill of the prompt and k tokens;
13. ``kernels`` (``ssd_scan``): the kernel against its plain version
    (bitwise) on the served prefill's layer 0, a 128-chunk long context,
    random decays with an initial state and ``kernels_bench.py``'s
    geometry, timed and bound;
14. ``ssm_replay``: the committed JAX Mamba2 fixture (float32 and
    bfloat16) through the port with the kernel, teacher-forced, within the
    CPU tests' tolerances.

After ``dense`` and ``city`` a ``profile`` line checks that a tick never
synchronises the host and says where its time goes on the card.

Then one line lists every kernel with its numbers, one line holds
``nvidia-smi``'s name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device, or without the port beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM 32-bit rate outside the tensor cores
TIMED_RUNS = 20
MAX_SPIN_MS = 2_000.0
FLIC_KERNELS = ("flic_insert", "flic_update", "flic_lookup")
PAGED = "paged_attention"
REPLACES = {   # the TPU kernel each CUDA kernel replaces (the def of its pallas_call)
    "flic_insert": "src/repro/kernels/flic_insert.py:122",
    "flic_update": "src/repro/kernels/flic_update.py:77",
    "flic_lookup": "src/repro/kernels/flic_lookup.py:61",
    "paged_attention": "src/repro/kernels/paged_attention.py:74",
    "flic_merge": "src/repro/kernels/flic_merge.py:36",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:45",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """Least time in ms the card could take: bytes over memory rate vs
    operations over the 32-bit non-tensor rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per ms of device time."""
    torch.cuda._sleep(1_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(torch, fn, make_args, cycles_per_ms: float) -> float:
    """Median device time of ``fn(*make_args())`` over TIMED_RUNS runs.

    Arguments are made fresh for each run (the kernels update in place),
    outside the timed span.  A spin kernel queued ahead of the start event
    keeps the card busy while the host enqueues the call, so the span
    measures the card, not the host.  The spin lasts four times the host's
    enqueue time of a warm-up call (at least 1 ms); a run whose enqueue took
    more than half its spin is thrown away and run again with twice the spin.
    """
    args = make_args()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn(*args)
    spin_ms = max(1.0, 4e3 * (time.perf_counter() - h0))
    torch.cuda.synchronize()
    times = []
    while len(times) < TIMED_RUNS:
        if spin_ms > MAX_SPIN_MS:
            raise RuntimeError(f"{fn.__name__}: the host enqueue outlasts a {MAX_SPIN_MS} ms spin")
        args = make_args()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        torch.cuda._sleep(int(spin_ms * cycles_per_ms))
        start.record()
        fn(*args)
        end.record()
        host_ms = 1e3 * (time.perf_counter() - h0)
        torch.cuda.synchronize()
        if host_ms > 0.5 * spin_ms:
            spin_ms *= 2
            continue
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _count(mask) -> int:
    return int(mask.sum())


def _lines_touched(torch, match, sidx, n_sets):
    """(C, S, W) bool: the lines of the (C, Q, W) ``match`` mask, whose
    queries go to sets ``sidx`` (Q,)."""
    c, q, w = match.shape
    out = torch.zeros((c, n_sets, w), dtype=torch.int32, device=match.device)
    return out.scatter_reduce(1, sidx.long()[None, :, None].expand(c, q, w),
                              match.to(torch.int32), "amax") > 0


# The bytes each function must move on the data it is given, each input
# read once and each output written once, counting only what the data
# needs: a dead lane reads its live flag alone, a tag is read only where
# its way is valid, a timestamp only where the tag matches, last_use only
# where an insert falls back to the LRU way, a payload only where it is
# copied.  Operations: the compares of the way loop.  Each returns (bytes,
# operations, what the count rests on).

def insert_work(torch, tags, data_ts, ins_ts, origin, valid, dirty, last_use, data,
                keys, sidx, line_ts, line_origin, line_dirty, live, line_data, now):
    from repro_torch.kernels import ref

    n, _, w = tags.shape
    d = data.shape[-1]
    rows = torch.arange(n, device=tags.device)
    s = sidx.long()
    valid_r = valid[rows, s] & live[:, None]
    present = (valid_r & (tags[rows, s] == keys[:, None])).any(dim=1)
    lru = live & ~present & valid_r.all(dim=1)
    _, do_write = ref.insert_plan(tags, data_ts, valid, last_use, keys, sidx, line_ts, live)
    new = do_write & ~present
    nbytes = (
        n                                  # live
        + _count(live) * (8 + w)           # key, set index, the set's valid flags
        + _count(valid_r) * 4              # tags of its valid ways
        + _count(present) * 8              # line_ts and the present copy's data_ts
        + _count(lru) * 4 * w              # last_use of a full set
        + _count(new) * 4                  # line_ts of a new line
        + _count(do_write) * (5 + 4 * d)   # line_origin, line_dirty, line_data
        + _count(do_write) * (17 + 4 * d)  # written: data_ts, ins_ts, origin, dirty, last_use, data
        + _count(new) * 5                  # written too where the line is new: tag, valid
    )
    info = dict(N=n, S=tags.shape[1], W=w, D=d, lanes_live=_count(live),
                lanes_present=_count(present), lanes_lru=_count(lru),
                lines_written=_count(do_write))
    return nbytes, _count(live) * w * 4, info


def update_work(torch, tags, data_ts, valid, last_use, data, keys, sidx, row_ts,
                row_data, live, now):
    from repro_torch.kernels import ref

    n, n_sets, w = tags.shape
    d = data.shape[-1]
    r = keys.shape[0]
    s = sidx.long()
    touched = _lines_touched(torch, live[:, :, None], sidx, n_sets)[..., 0]   # (N, S)
    match = valid[:, s] & (tags[:, s] == keys[None, :, None]) & live[:, :, None]
    winr, _ = ref.update_winners(tags, data_ts, valid, keys, sidx, row_ts, live)
    updated = winr >= 0
    nbytes = (
        n * r                                             # live
        + _count(live.any(dim=0)) * 8                     # key, set index of a live row
        + _count(match.any(dim=2).any(dim=0)) * 4         # row_ts of a matching row
        + _count(touched) * w                             # valid flags of a touched set
        + _count(valid & touched[..., None]) * 4          # tags of its valid ways
        + _count(_lines_touched(torch, match, sidx, n_sets)) * 4   # data_ts of a matched line
        + int(torch.unique(winr[updated]).numel()) * 4 * d         # a winning row's payload
        + _count(updated) * (8 + 4 * d)                   # written: data_ts, last_use, data
        + n * 4                                           # counts
    )
    info = dict(N=n, R=r, S=n_sets, W=w, D=d, live_pairs=_count(live),
                sets_touched=_count(touched), lines_updated=_count(updated))
    return nbytes, _count(live) * w * 3, info


def lookup_work(torch, tags, data_ts, valid, data, keys, sidx):
    from repro_torch.kernels import ref

    c, n_sets, w = tags.shape
    d = data.shape[-1]
    q = keys.shape[0]
    s = sidx.long()
    sets = torch.zeros((n_sets,), dtype=torch.bool, device=tags.device)
    sets[s] = True
    match = valid[:, s] & (tags[:, s] == keys[None, :, None])                 # (C, Q, W)
    hit, _, _, way = ref.flic_lookup_ref(tags, data_ts, valid, data, keys, sidx)
    cache = torch.arange(c, device=tags.device)[:, None]
    hit_lines = ((cache * n_sets + s[None, :]) * w + way)[hit]
    nbytes = (
        q * 8                                             # keys, set indices
        + c * _count(sets) * w                            # valid flags of each queried set
        + _count(valid & sets[None, :, None]) * 4         # tags of its valid ways
        + _count(_lines_touched(torch, match, sidx, n_sets)) * 4   # data_ts of a matched line
        + int(torch.unique(hit_lines).numel()) * 4 * d    # payload of a line that answers
        + c * q * (9 + 4 * d)                             # written: hit, ts, way, payload
    )
    info = dict(C=c, Q=q, S=n_sets, W=w, D=d, hits=_count(hit))
    return nbytes, c * q * w * 3, info


WORK = {"flic_insert": insert_work, "flic_update": update_work, "flic_lookup": lookup_work}


def check_and_time(torch, name: str, args, cycles_per_ms: float) -> dict:
    """One call of kernel ``name`` held bitwise against its plain version
    on the same inputs, then both timed."""
    from repro_torch.kernels import ops, ref

    kernel, plain = getattr(ops, name), getattr(ref, f"{name}_ref")

    def fresh():
        return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    got = kernel(*fresh())
    torch.cuda.synchronize()
    want = plain(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain version")
    nbytes, ops_n, info = WORK[name](torch, *args)
    b_ms, b_by = bound(nbytes, ops_n)
    return dict(
        info, ms=time_ms(torch, kernel, fresh, cycles_per_ms),
        plain_ms=time_ms(torch, plain, fresh, cycles_per_ms),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n,
    )


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version.
# ---------------------------------------------------------------------------

def capture_main_path(torch, device, cfg, ticks: int, at: dict) -> dict:
    """Inputs of chosen kernel calls in a native run of ``cfg`` with the
    kernels: ``at[name]`` lists the indices, among that kernel's calls in
    the run, of the calls to copy.  Returns ``{(name, index): args}``."""
    from repro_torch.core import flic
    from repro_torch.core.simulator import run_sim

    real = flic.KERNEL_BACKENDS["cuda"]
    calls = {name: 0 for name in FLIC_KERNELS}
    got = {}

    def spy(name, fn):
        def call(*args):
            if calls[name] in at.get(name, ()):
                got[name, calls[name]] = [
                    a.clone() if isinstance(a, torch.Tensor) else a for a in args
                ]
            calls[name] += 1
            return fn(*args)
        return call

    flic.KERNEL_BACKENDS["cuda"] = tuple(spy(n, f) for n, f in zip(FLIC_KERNELS, real))
    try:
        run_sim(dataclasses.replace(cfg, probe_backend="cuda"), ticks, seed=0, device=device)
    finally:
        flic.KERNEL_BACKENDS["cuda"] = real
    missing = [(n, i) for n, idx in at.items() for i in idx if (n, i) not in got]
    if missing:
        raise AssertionError(f"the run never made kernel calls {missing}")
    return got


def random_tables(torch, gen, n, s, w, d, pool):
    """Arbitrary cache tables: tags from a small key pool, so sets hold
    duplicate tags and queries hit and miss."""
    dev = gen.device

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    shape = (n, s, w)
    return [
        pool[ri(0, pool.numel(), shape).long()],        # tags
        ri(-1, 20, shape),                              # data_ts
        ri(-1, 20, shape),                              # ins_ts
        ri(-1, n, shape),                               # origin
        torch.rand(shape, generator=gen, device=dev) < 0.7,   # valid
        torch.rand(shape, generator=gen, device=dev) < 0.3,   # dirty
        ri(-1, 30, shape),                              # last_use
        torch.rand((*shape, d), generator=gen, device=dev),   # data
    ]


def random_cases(torch, device) -> dict:
    """Arbitrary states at the main path's shapes, with duplicate tags in a
    set, duplicate rows and queries, dead lanes and a Q that is not a
    multiple of 32: ``{name: {label: args}}``."""
    from repro_torch.core.cache_state import set_index

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    pool = torch.randint(-2**31, 2**31 - 1, (32,), generator=gen, device=device,
                         dtype=torch.int32)
    s, w, d = 50, 4, 8

    def queries(q):
        keys = pool[torch.randint(0, pool.numel(), (q,), generator=gen, device=device)]
        return [keys, set_index(keys, s).to(torch.int32)]

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    n = 10_000
    tags, data_ts, ins_ts, origin, valid, dirty, last_use, data = random_tables(
        torch, gen, n, s, w, d, pool)
    insert = [tags, data_ts, ins_ts, origin, valid, dirty, last_use, data, *queries(n),
              ri(-1, 25, (n,)), ri(0, n, (n,)),
              torch.rand(n, generator=gen, device=device) < 0.5,
              torch.rand(n, generator=gen, device=device) < 0.8,
              torch.rand((n, d), generator=gen, device=device), 30]

    n = r = 1_000
    tags, data_ts, _, _, valid, _, last_use, data = random_tables(torch, gen, n, s, w, d, pool)
    update = [tags, data_ts, valid, last_use, data, *queries(r), ri(-1, 25, (r,)),
              torch.rand((r, d), generator=gen, device=device),
              torch.rand((n, r), generator=gen, device=device) < 0.5, 30]

    tags, data_ts, _, _, valid, _, _, data = random_tables(torch, gen, 1_000, s, w, d, pool)
    lookup = {f"random_q{q}": [tags, data_ts, valid, data, *queries(q)] for q in (67, 1_000)}
    return {"flic_insert": {"random": insert},
            "flic_update": {"random": update, "hot_key": hot_key_update(torch, gen, pool),
                            "large_table_s8192": large_table_update(torch, gen)},
            "flic_lookup": lookup}


def hot_key_update(torch, gen, pool):
    """The dense shape (N=R=1,000, S=50, W=4, D=8) where every row carries
    one of 2 keys and 90% of the nodes hold both, older than the rows: one
    line of such a node has ~R/2 qualifying rows, all racing for its winner."""
    from repro_torch.core.cache_state import set_index

    dev = gen.device
    n = r = 1_000
    s, w, d = 50, 4, 8
    tags, data_ts, _, _, valid, _, last_use, data = random_tables(torch, gen, n, s, w, d, pool)
    hot = pool[:2]
    hot_sets = set_index(hot, s)
    holds = torch.rand(n, generator=gen, device=dev) < 0.9
    for way, (key, st) in enumerate(zip(hot, hot_sets)):
        tags[holds, st, way] = key
        valid[holds, st, way] = True
        data_ts[holds, st, way] = torch.randint(-1, 5, (int(holds.sum()),), generator=gen,
                                                device=dev, dtype=torch.int32)
    keys = hot[torch.randint(0, 2, (r,), generator=gen, device=dev)]
    return [tags, data_ts, valid, last_use, data, keys, set_index(keys, s).to(torch.int32),
            torch.randint(0, 100, (r,), generator=gen, device=dev, dtype=torch.int32),
            torch.rand((r, d), generator=gen, device=dev),
            torch.rand((n, r), generator=gen, device=dev) < 0.9, 30]


def large_table_update(torch, gen):
    """N=8 tables of S=8,192 sets x 4 ways (32,768 lines, beyond the
    kernel's shared budget, so it sweeps them in ranges of sets), R=1,000
    rows of 512 keys; half the (node, row) pairs find their key in the
    row's set (at way row % 4)."""
    from repro_torch.core.cache_state import set_index

    dev = gen.device
    n, r, s, w, d = 8, 1_000, 8_192, 4, 8
    pool = torch.randint(-2**31, 2**31 - 1, (512,), generator=gen, device=dev,
                         dtype=torch.int32)
    tags, data_ts, _, _, valid, _, last_use, data = random_tables(torch, gen, n, s, w, d, pool)
    keys = pool[torch.randint(0, pool.numel(), (r,), generator=gen, device=dev)]
    sidx = set_index(keys, s)
    plant = torch.rand((n, r), generator=gen, device=dev) < 0.5
    node, row = plant.nonzero(as_tuple=True)
    tags[node, sidx[row], row % w] = keys[row]
    valid[node, sidx[row], row % w] = True
    return [tags, data_ts, valid, last_use, data, keys, sidx.to(torch.int32),
            torch.randint(-1, 25, (r,), generator=gen, device=dev, dtype=torch.int32),
            torch.rand((r, d), generator=gen, device=dev),
            torch.rand((n, r), generator=gen, device=dev) < 0.7, 30]


def kernel_phase(torch, device, dense_cfg, city_cfg, cycles_per_ms) -> dict:
    """Each kernel on the inputs the main path gives it (copied from one
    tick of each cell: dense tick 200, before the outage; city tick 60) and
    on arbitrary states; bitwise against the plain version, timed, bound.
    The first main-path case of each kernel is its headline."""
    dense = capture_main_path(torch, device, dense_cfg, 201, {
        "flic_update": (200,), "flic_lookup": (200,), "flic_insert": (400,)})
    city = capture_main_path(torch, device, city_cfg, 61, {"flic_insert": (120, 121)})
    cases = {
        "flic_insert": {"city_t60_writes": city["flic_insert", 120],
                        "city_t60_fills": city["flic_insert", 121],
                        "dense_t200_writes": dense["flic_insert", 400]},
        "flic_update": {"dense_t200": dense["flic_update", 200]},
        "flic_lookup": {"dense_t200": dense["flic_lookup", 200]},
    }
    for name, more in random_cases(torch, device).items():
        cases[name].update(more)
    return {
        name: {label: check_and_time(torch, name, args, cycles_per_ms)
               for label, args in by_label.items()}
        for name, by_label in cases.items()
    }


# ---------------------------------------------------------------------------
# Phases 4-6: the engine.
# ---------------------------------------------------------------------------

def series_equal(torch, a, b, label: str) -> None:
    from repro_torch.core.metrics import EMBODIMENT_FIELDS, field_names

    for f in field_names():
        if f in EMBODIMENT_FIELDS:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if not torch.equal(x, y):
            raise AssertionError(f"{label}: TickMetrics.{f} diverged")


def timed_run(torch, cfg, ticks, backend, device):
    from repro_torch.core.simulator import run_sim
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(cfg, probe_backend=backend)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, series = run_sim(cfg, ticks, seed=0, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return series, ticks / secs, dict(ops.LAUNCHES)


def replay_phase(torch, device) -> None:
    import numpy as np

    from repro_torch.core.metrics import EMBODIMENT_FIELDS
    from repro_torch.core.replay import load_replay
    from repro_torch.core.simulator import run_sim
    from repro_torch.kernels import ops

    for path in sorted((ROOT / "src" / "repro_torch" / "testdata").glob("replay_*.npz")):
        cfg, draws, expected = load_replay(path, device)
        cfg = dataclasses.replace(cfg, probe_backend="cuda")
        ops.reset_launches()
        _, series = run_sim(cfg, len(draws), device=device, draws=draws)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        for f, want in expected.items():
            if f in EMBODIMENT_FIELDS:
                continue
            got = getattr(series, f).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"replay {path.name}: TickMetrics.{f} diverged from JAX")
        if launches["flic_insert"] == 0 or launches["flic_lookup"] == 0:
            raise AssertionError(f"replay {path.name}: kernels not launched: {launches}")
        emit("replay", file=path.name, ticks=len(draws), equal_to_jax=True,
             launches=launches)


def tick_profile(torch, device, cfg, ticks_per_s: float, ticks: int = 20) -> dict:
    """Where a tick's time goes, with the kernels.

    Steps ``sim_tick`` on the native planner's draws: 5 warm-up ticks, 5
    under ``torch.cuda.set_sync_debug_mode("error")`` (any host
    synchronisation inside the tick raises), then ``ticks`` under
    ``torch.profiler``.  Device busy time is the sum of the CUDA kernels'
    time; the idle share compares it with the unprofiled tick time.
    """
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.simulator import draw_tick, init_sim, sim_tick

    cfg = dataclasses.replace(cfg, probe_backend="cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_sim(cfg, device)
    for t in range(5):
        state, _ = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(5, 10):
            state, _ = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(10, 10 + ticks):
            state, _ = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        return dict(sync_free=True, device_busy_ms_per_tick="not measured")
    tick_ms = 1e3 / ticks_per_s
    busy_ms = busy_us / 1e3 / ticks
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        sync_free=True, tick_ms=tick_ms, device_busy_ms_per_tick=busy_ms,
        device_idle_share=1.0 - busy_ms / tick_ms,
        kernel_launches_per_tick=sum(e.count for e in kernels) / ticks,
        hand_kernels_ms_per_tick={
            name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / ticks
            for name in ("flic_insert", "flic_update", "flic_lookup")
        },
        top_kernels_ms_per_tick=[[e.key[:80], e.self_device_time_total / 1e3 / ticks]
                                 for e in top],
    )


HEADLINE = ("read_miss_ratio", "hit_local_ratio", "hit_fog_ratio", "hit_queue_ratio",
            "sync_store_request_ratio", "wan_reduction_vs_baseline",
            "coherence_updates", "stale_read_ratio", "writes_gen", "writes_drained",
            "queue_dropped")


def engine_phase(torch, device, name, cfg, ticks, must_launch):
    from repro_torch.core.metrics import summarize

    s_cuda, rate_cuda, launches = timed_run(torch, cfg, ticks, "cuda", device)
    s_inline, rate_inline, _ = timed_run(torch, cfg, ticks, None, device)
    series_equal(torch, s_cuda, s_inline, f"{name}: cuda vs inline")
    if s_cuda.reads.shape != (ticks,) or not all(
            bool(torch.isfinite(getattr(s_cuda, f)).all())
            for f in ("lan_bytes", "wan_rx_bytes", "read_latency_sum")):
        raise AssertionError(f"{name}: series has the wrong shape or non-finite values")
    missing = [k for k in must_launch if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels {missing} were not launched: {launches}")
    summary = summarize(s_cuda)
    emit(name, n_nodes=cfg.n_nodes, ticks=ticks, fanout=cfg.workload.fanout,
         ticks_per_s_cuda=rate_cuda, ticks_per_s_inline=rate_inline,
         series_equal=True, launches=launches,
         summary={k: summary[k] for k in HEADLINE})
    emit("profile", cell=name, **tick_profile(torch, device, cfg, rate_cuda))
    return launches, summary


# ---------------------------------------------------------------------------
# Phases 7-9: Granite-8B served through the paged_attention kernel.
# ---------------------------------------------------------------------------

# Serve cell: 4 distinct prompts of 512 tokens (whole pages, so prefix
# reuse is live), each submitted twice, 32 new tokens, 4 slots, page 16.
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_MAX_NEW = 4, 512, 32
SERVE_BATCH, SERVE_PAGE = 4, 16
SERVE_MAX_SEQ = SERVE_PROMPT_LEN + SERVE_MAX_NEW + SERVE_PAGE   # launch/serve.py's rule
CAPTURE_STEP = 20   # decode step whose layer-0 paged_attention inputs the kernels phase reuses
# Teacher-forced logits of the plain paged run against the contiguous-cache
# oracle (both plain PyTorch; they differ in how K/V are laid out and
# gathered): 0.25 is 8 bfloat16 ulps at |logit| 4.  The kernel run is not
# held to a logit tolerance at full width: with the JAX package's random
# weight law (fan-in read from the head axis, so q and k are ~20x larger
# than a trained model's) attention is near-argmax over scores ~600 apart
# by less than 1, and one bfloat16 ulp of one attention output element moves
# the logits by O(1) (``one_ulp_sensitivity``).  The kernel is held instead
# to the plain version on the identical inputs of every call of the run
# (``paged_verdict``), and at smoke width to JAX's logits (serve_replay).
SERVE_TOL = 0.25
# The JAX fixture in bfloat16: tests/test_torch_serving.py's BF16_TOL and
# its reason (the frameworks round bfloat16 intermediates at other places).
REPLAY_TOL = 0.25


def serve_prompts(vocab: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(0)
    uniq = [[int(t) for t in rng.integers(0, vocab, SERVE_PROMPT_LEN)]
            for _ in range(SERVE_PROMPTS)]
    return [uniq[i % SERVE_PROMPTS] for i in range(2 * SERVE_PROMPTS)]


def serve_run(torch, cfg, params, device, prompts, backend, script=None, capture=None,
              shadow=None):
    """One run of the engine (``TeacherForcedEngine``, which records each
    step's logits) with the launch counts set to 0 just before it.  Times
    each prefill and each decode step on the host clock between
    synchronisations.  With ``capture`` (a dict), copies the inputs of
    decode step ``CAPTURE_STEP`` and of its layer-0 ``paged_attention``.
    With ``shadow`` (a dict), holds every kernel call against the plain
    version on the same inputs (``paged_verdict``), on the card without
    synchronising: ``shadow["max_err"]`` (largest |kernel - plain|) and
    ``shadow["excess"]`` are device scalars, ``shadow["calls"]`` counts."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving import engine as em

    eng = em.TeacherForcedEngine(
        cfg, params, script=script, max_batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
        page_size=SERVE_PAGE, kernel_backend=backend, device=device)
    for p in prompts:
        eng.submit(p, max_new=SERVE_MAX_NEW)
    prefill_ms, decode_ms = [], []
    real_prefill, real_step = em.model_prefill, em.paged_decode_step
    kernel_attn = ops.paged_attention

    def shadow_attn(*args):
        got = kernel_attn(*args)
        diff, excess = paged_verdict(torch, got, ref.paged_attention_ref(*args), args)
        shadow["max_err"] = torch.maximum(shadow["max_err"], diff)
        shadow["excess"] = torch.maximum(shadow["excess"], excess)
        shadow["calls"] += 1
        return got

    attn = kernel_attn if shadow is None else shadow_attn

    def spy_attn(*args):
        if "attn_args" not in capture:
            capture["attn_args"] = [a.clone() for a in args]
        return attn(*args)

    def timed(fn, sink):
        def call(*args, **kw):
            if capture is not None and fn is real_step and len(sink) == CAPTURE_STEP:
                capture["step_args"] = [a.clone() for a in (args[2], args[3], args[6])]
                ops.paged_attention = spy_attn
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
            finally:
                ops.paged_attention = attn
            sink.append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    em.model_prefill, em.paged_decode_step = timed(real_prefill, prefill_ms), timed(real_step, decode_ms)
    ops.paged_attention = attn
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        eng.run()
        torch.cuda.synchronize()
    finally:
        em.model_prefill, em.paged_decode_step = real_prefill, real_step
        ops.paged_attention = kernel_attn
    wall = time.perf_counter() - t0
    return eng, dict(wall_s=wall, prefill_ms=prefill_ms, decode_ms=decode_ms,
                     launches=dict(ops.LAUNCHES))


def contiguous_oracle(torch, cfg, params, device, prompts, scripts):
    """JAX's serving oracle (tests/test_train_ckpt.py:105-134) at batch 4:
    each prompt prefilled alone, its K/V copied into a contiguous
    ``decode_cache_specs`` cache, then ``decode_step`` fed the last prompt
    token and then ``scripts`` (teacher forcing).  Returns (4, steps, V)."""
    from repro_torch.models.model import decode_cache_specs, decode_step, prefill

    spec = decode_cache_specs(cfg, len(prompts), SERVE_MAX_SEQ)[0]["blk0"]
    caches = [{"blk0": {n: torch.zeros(s.shape, dtype=s.dtype, device=device)
                        for n, s in spec.items()}}]
    for b, p in enumerate(prompts):
        _, c = prefill(params, cfg, {"tokens": torch.tensor([p], dtype=torch.int32, device=device)})
        for n in ("k", "v"):
            caches[0]["blk0"][n][:, b, :len(p)] = c[0]["blk0"][n][:, 0].to(spec[n].dtype)
    tok = torch.tensor([[p[-1]] for p in prompts], dtype=torch.int32, device=device)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=device)
    out = []
    for i in range(len(scripts[0])):
        logits, caches = decode_step(params, cfg, tok, pos, caches)
        out.append(logits[:, 0])
        tok = torch.tensor([[s[i]] for s in scripts], dtype=torch.int32, device=device)
        pos = pos + 1
    return torch.stack(out, dim=1)


def decode_profile(torch, cfg, params, pools, step_args, steps: int = 3) -> dict:
    """Where one decode step's time goes: ``paged_decode_step`` on the
    inputs of decode step ``CAPTURE_STEP`` (the pools as the run left
    them), 2 warm-up steps, ``steps`` timed on the host clock, then
    ``steps`` under ``torch.profiler``; device busy = the CUDA kernels'
    summed time, the idle share compares it with the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.serve_step import paged_decode_step

    tok, pos, table = step_args

    def step():
        return paged_decode_step(params, cfg, tok, pos, pools[0], pools[1], table)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy_ms <= 0:
        return dict(step_ms=step_ms, device_busy_ms="not measured")
    pa_ms = sum(e.self_device_time_total for e in kernels
                if "paged_attention" in e.key) / 1e3 / steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        step_ms=step_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / step_ms,
        paged_attention_ms=pa_ms, paged_attention_share_of_busy=pa_ms / busy_ms,
        kernel_launches_per_step=sum(e.count for e in kernels) / steps,
        top_kernels_ms_per_step=[[e.key[:80], e.self_device_time_total / 1e3 / steps]
                                 for e in top],
    )


def logit_diff(torch, a: dict, b, rids) -> float:
    """Largest |difference| between the recorded logits of ``rids`` in
    ``a`` (engine logits by rid) and ``b`` (a dict by rid, or a callable)."""
    worst = 0.0
    for r in rids:
        x = torch.stack(a[r]).float()
        y = b(r) if callable(b) else torch.stack(b[r]).float()
        if x.shape != y.shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"request {r}: logits of shape {tuple(x.shape)} "
                                 f"against {tuple(y.shape)}, or not finite")
        worst = max(worst, float((x - y).abs().max()))
    return worst


def one_ulp_sensitivity(torch, cfg, params, pools, step_args) -> float:
    """The largest logit change of one plain decode step (the inputs of
    step ``CAPTURE_STEP``) when one element of layer 0's attention output,
    in an active slot, moves by one bfloat16 ulp: how far the model carries
    the smallest difference the kernel may make."""
    from repro_torch.kernels import ref
    from repro_torch.serving.serve_step import paged_decode_step

    tok, pos, table = step_args

    def step():
        return paged_decode_step(params, cfg, tok, pos, pools[0], pools[1], table,
                                 kernel_backend="plain")[0]

    base = step()
    plain, calls = ref.paged_attention_ref, []

    def nudged(*args):
        out = plain(*args)
        if not calls:
            out[0, 0, 0, 0] += bf16_ulp(torch, out[0, 0, 0, 0])
        calls.append(1)
        return out

    ref.paged_attention_ref = nudged
    try:
        moved = step()
    finally:
        ref.paged_attention_ref = plain
    return float((moved - base).abs().max())


def serve_phase(torch, device) -> dict:
    """The port's second main path: ``granite_8b`` at full width, random
    bfloat16 weights from ``torch.Generator`` seed 0, 8 requests through
    ``ServeEngine`` with the kernel (timed, counted); again with every
    kernel call held against the plain version on its inputs; then
    teacher-forced with the plain version and with the contiguous-cache
    oracle, which must agree within ``SERVE_TOL``."""
    from repro_torch.config import get_arch
    from repro_torch.models.model import init_model, model_param_defs
    from repro_torch.models.params import param_count

    cfg = get_arch("granite_8b")
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    capture: dict = {}
    keng, kinfo = serve_run(torch, cfg, params, device, prompts, None, capture=capture)
    peak = torch.cuda.max_memory_allocated()
    steps = len(kinfo["decode_ms"])
    launches = kinfo["launches"]["paged_attention"]
    if launches != cfg.num_layers * steps or steps == 0:
        raise AssertionError(f"serve: paged_attention launched {launches} times in "
                             f"{steps} decode steps of {cfg.num_layers} layers")
    by_rid = {r.rid: r for r in keng.finished}
    n = len(prompts)
    if sorted(by_rid) != list(range(1, n + 1)) or any(
            len(r.tokens) != SERVE_MAX_NEW for r in keng.finished):
        raise AssertionError("serve: not every request finished with its tokens")
    reused = [by_rid[r].reused_prefill for r in range(1, n + 1)]
    if reused != [False] * SERVE_PROMPTS + [True] * SERVE_PROMPTS:
        raise AssertionError(f"serve: prefix reuse {reused}, expected the second wave reused")
    script = {r: by_rid[r].tokens for r in by_rid}

    shadow = {"max_err": torch.zeros((), device=device),
              "excess": torch.full((), -float("inf"), device=device), "calls": 0}
    seng, _ = serve_run(torch, cfg, params, device, prompts, None, script=script, shadow=shadow)
    if shadow["calls"] != launches or float(shadow["excess"]) > 0:
        raise AssertionError(f"serve: a kernel call left the tolerance of the plain version "
                             f"(largest error {float(shadow['max_err'])}, "
                             f"{shadow['calls']} calls)")
    rerun_diff = logit_diff(torch, keng.logits, seng.logits, by_rid)

    peng, pinfo = serve_run(torch, cfg, params, device, prompts, "plain", script=script)
    if pinfo["launches"]["paged_attention"] != 0:
        raise AssertionError("serve: the plain run launched the kernel")
    first = list(range(1, SERVE_PROMPTS + 1))
    oracle = contiguous_oracle(torch, cfg, params, device, [prompts[r - 1] for r in first],
                               [script[r] for r in first]).float()

    def by_prompt(r):
        return oracle[(r - 1) % SERVE_PROMPTS]

    diff_plain_oracle = logit_diff(torch, peng.logits, by_prompt, by_rid)
    if not diff_plain_oracle <= SERVE_TOL:
        raise AssertionError(f"serve: the plain paged run differs from the contiguous oracle "
                             f"by {diff_plain_oracle} > {SERVE_TOL}")
    diff_plain = logit_diff(torch, keng.logits, peng.logits, by_rid)
    diff_oracle = logit_diff(torch, keng.logits, by_prompt, by_rid)
    agree = sum(int(torch.stack(keng.logits[r]).argmax(-1).eq(by_prompt(r).argmax(-1)).sum())
                for r in by_rid)
    max_logit = max(float(torch.stack(v).abs().max()) for v in keng.logits.values())
    nudge = one_ulp_sensitivity(torch, cfg, params, (keng.pool.k, keng.pool.v),
                                capture["step_args"])

    prof = decode_profile(torch, cfg, params, (keng.pool.k, keng.pool.v), capture["step_args"])
    gen_tokens = sum(len(r.tokens) for r in keng.finished)
    emit("serve", arch=cfg.name, params=param_count(model_param_defs(cfg)),
         init_s=init_s, requests=n, prompt_len=SERVE_PROMPT_LEN, max_new=SERVE_MAX_NEW,
         max_batch=SERVE_BATCH, page_size=SERVE_PAGE, decode_steps=steps,
         prefill_ms=kinfo["prefill_ms"], prefill_ms_plain_run=pinfo["prefill_ms"],
         decode_ms_per_step_median=statistics.median(kinfo["decode_ms"]),
         decode_ms_per_step_median_plain=statistics.median(pinfo["decode_ms"]),
         wall_s=kinfo["wall_s"], generated_tokens=gen_tokens,
         tokens_per_s=gen_tokens / kinfo["wall_s"],
         decode_tokens_per_s=gen_tokens / (sum(kinfo["decode_ms"]) / 1e3),
         launches=kinfo["launches"], prefix_reuse_second_wave=sum(reused[SERVE_PROMPTS:]),
         paged_calls_checked=shadow["calls"], paged_max_abs_err=float(shadow["max_err"]),
         rerun_max_abs_diff=rerun_diff, tol=SERVE_TOL,
         plain_vs_contiguous_max_abs_diff=diff_plain_oracle, max_abs_logit=max_logit,
         kernel_vs_plain_max_abs_diff=diff_plain, kernel_vs_contiguous_max_abs_diff=diff_oracle,
         kernel_vs_contiguous_argmax_agree=f"{agree}/{n * SERVE_MAX_NEW}",
         one_ulp_sensitivity=nudge,
         peak_memory_bytes=peak, mgr_stats=keng.mgr.stats, profile=prof)
    return dict(launches=launches, attn_args=capture["attn_args"],
                max_abs_err=float(shadow["max_err"]))


def serve_replay_phase(torch, device) -> None:
    """The committed JAX fixture (Granite-8B smoke config, bfloat16) through
    the port with the kernel, teacher-forced, both cases."""
    from repro_torch.kernels import ops
    from repro_torch.serving.replay import compare_case, load_serve_replay, replay_case

    path = ROOT / "src" / "repro_torch" / "testdata" / "serve_granite8b_smoke.npz"
    cfg, params, cases = load_serve_replay(path, device)
    for name, case in cases.items():
        ops.reset_launches()
        res = compare_case(case, replay_case(cfg, params, case, device), REPLAY_TOL)
        torch.cuda.synchronize()
        res["launches"] = ops.LAUNCHES["paged_attention"]
        ok = (res["max_abs_diff"] <= REPLAY_TOL and res["argmax_equal_where_decided"]
              and res["reused_equal"] and res["stats_equal"] and res["launches"] > 0)
        if not ok:
            raise AssertionError(f"serve replay {name}: {res}")
        emit("serve_replay", case=name, tol=REPLAY_TOL, stats=case["stats"], **res)


# The paged_attention kernel against its plain version.

def bf16_ulp(torch, x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0**-126)))
    return torch.exp2(e - 7)


def paged_truth(torch, q, k_pages, v_pages, page_table, lengths):
    """``paged_attention``'s function in float64 arithmetic."""
    b, hkv, g, d = q.shape
    s_len = page_table.shape[1] * k_pages.shape[1]
    table = page_table.long()
    k = k_pages[table].reshape(b, s_len, hkv, d).double()
    v = v_pages[table].reshape(b, s_len, hkv, d).double()
    s = torch.einsum("bhgd,bkhd->bhgk", q.double(), k) / d**0.5
    mask = torch.arange(s_len, device=q.device)[None] < lengths[:, None]
    s = torch.where(mask[:, None, None], s, -1e30)
    return torch.einsum("bhgk,bkhd->bhgd", torch.softmax(s, dim=-1), v)


def paged_verdict(torch, got, want, args):
    """(largest |kernel - plain|, excess) as device scalars; the kernel is
    within tolerance where the excess is <= 0.

    float32 outputs: within 1e-5 relative of the plain result, plus 1e-5
    of max|V|.  bfloat16 outputs: the kernel's largest error against
    float64 arithmetic is at most twice the plain version's, plus 2**-16
    of max|V|.  Not a fixed number of ulps: on the served model's inputs
    q.k reaches ~600 over 128 terms, float32 rounds each score by ~1e-3,
    near-tied scores turn that into weight differences, and both versions
    land some outputs one or two bfloat16 ulps from each other (and from
    the exact result).  The test is that the kernel is no less accurate.
    """
    vmax = args[2].float().abs().max()
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return diff.max(), (diff - 1e-5 * want.abs() - 1e-5 * vmax).max()
    truth = paged_truth(torch, *args)
    err_kernel = (got.double() - truth).abs().max()
    err_plain = (want.double() - truth).abs().max()
    return diff.max(), (err_kernel - 2 * err_plain - 2.0**-16 * vmax).float()


def paged_check(torch, got, want, args) -> float:
    """Raise unless the kernel's output is within ``paged_verdict``'s
    tolerance of the plain one; returns the largest |kernel - plain|."""
    diff, excess = paged_verdict(torch, got, want, args)
    if got.dtype != want.dtype or got.shape != want.shape or float(excess) > 0:
        raise AssertionError(f"paged_attention: differs from the plain version by "
                             f"{float(diff)} (dtype {got.dtype}, shape {tuple(got.shape)})")
    return float(diff)


def paged_work(q, k_pages, page_table, lengths) -> tuple[int, int, dict]:
    """(bytes, operations, info) the inputs need: K and V of each sequence's
    live pages, q, out, the live page-table entries and the lengths;
    4*G*D operations per (sequence, KV head, live position)."""
    b, hkv, g, d = q.shape
    page = k_pages.shape[1]
    lens = lengths.long().clamp(min=0)
    live_pages = int(((lens + page - 1) // page).clamp(max=page_table.shape[1]).sum())
    nbytes = (2 * live_pages * page * hkv * d * k_pages.element_size()
              + 2 * q.numel() * q.element_size() + live_pages * 4 + b * 4)
    ops_n = int(lens.sum()) * hkv * g * 4 * d
    return nbytes, ops_n, dict(B=b, Hkv=hkv, G=g, D=d, page=page, pool_pages=k_pages.shape[0],
                               max_pages=page_table.shape[1], live_pages=live_pages,
                               positions=int(lens.sum()))


def sdpa_args(torch, q, k_pages, v_pages, page_table, lengths):
    """The same function as one ``scaled_dot_product_attention`` call on K
    and V gathered to contiguous beforehand (B, Hkv, S, D), with a length
    mask and GQA; a yardstick only (the port never calls it)."""
    b, hkv, g, d = q.shape
    s = page_table.shape[1] * k_pages.shape[1]

    def gather(pages):
        return pages[page_table.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()

    mask = (torch.arange(s, device=q.device)[None] < lengths[:, None])[:, None, None, :]
    return q.reshape(b, hkv * g, 1, d), gather(k_pages), gather(v_pages), mask


def paged_case(torch, args, cycles_per_ms, flush, library: bool) -> dict:
    """Kernel against plain on ``args``; both timed (the L2 cache flushed
    before each run: in a decode step the 35 other layers' weights pass
    through it between two calls of one layer), and the library call."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    got = ops.paged_attention(*args)
    torch.cuda.synchronize()
    want = ref.paged_attention_ref(*args)
    err = paged_check(torch, got, want, args)

    def fresh():
        flush.zero_()
        return args

    nbytes, ops_n, info = paged_work(args[0], args[1], args[3], args[4])
    b_ms, b_by = bound(nbytes, ops_n)
    out = dict(info, max_abs_err=err, ms=time_ms(torch, ops.paged_attention, fresh, cycles_per_ms),
               plain_ms=time_ms(torch, ref.paged_attention_ref, fresh, cycles_per_ms),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n, library_ms=None)
    if library:
        lib = sdpa_args(torch, *args)

        def sdpa(qs, ks, vs, mask):
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)

        def fresh_lib():
            flush.zero_()
            return lib

        lib_out = sdpa(*lib).reshape(want.shape)
        out["library_max_abs_diff"] = float((lib_out.float() - want.float()).abs().max())
        out["library_ms"] = time_ms(torch, sdpa, fresh_lib, cycles_per_ms)
        del lib
    return out


def long_context_case(torch, device, gen):
    """B=16 sequences of up to 32,768 positions (decode_32k's length, the
    batch cut from 128), Granite's KV heads and widths, one layer's pool of
    32,768 pages (2.1 GB); the page table is a random permutation of the
    pool, entries past each length 0."""
    b, hkv, g, d, page, max_pages = 16, 8, 4, 128, 16, 2048
    n_pool = b * max_pages
    q = torch.randn((b, hkv, g, d), generator=gen, device=device).to(torch.bfloat16)
    kp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device, dtype=torch.bfloat16)
    vp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device, dtype=torch.bfloat16)
    lengths = torch.randint(1, max_pages * page + 1, (b,), generator=gen, device=device,
                            dtype=torch.int32)
    table = torch.randperm(n_pool, generator=gen, device=device).to(torch.int32).reshape(b, max_pages)
    live = (lengths.long()[:, None] + page - 1) // page
    table[torch.arange(max_pages, device=device)[None] >= live] = 0
    return [q, kp, vp, table, lengths]


def edge_cases(torch, device, gen) -> dict:
    """Random states at the serve path's shapes (page 16, 35 page slots, a
    280-page pool): lengths 1, a full table, 0 (every slot masked: a
    uniform softmax in both versions), an inactive slot (page 0, length 1)
    and random ones; K/V in bfloat16 with q in bfloat16 (the path as
    served) and float32 (a float32 model over the bfloat16 pool), and all
    in float32."""
    b, hkv, g, d, page, max_pages, n_pool = 6, 8, 4, 128, 16, 35, 280
    lengths = torch.randint(1, max_pages * page + 1, (b,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[2], lengths[4] = 1, max_pages * page, 0, 1
    table = torch.randperm(n_pool, generator=gen, device=device)[: b * max_pages]
    table = table.to(torch.int32).reshape(b, max_pages)
    live = ((lengths.long() + page - 1) // page).clamp(min=1)
    table[torch.arange(max_pages, device=device)[None] >= live[:, None]] = 0
    table[4] = 0
    cases = {}
    for qdt, kvdt in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                      (torch.float32, torch.float32)):
        q = torch.randn((b, hkv, g, d), generator=gen, device=device).to(qdt)
        kp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device).to(kvdt)
        vp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device).to(kvdt)
        cases[f"edges_q{str(qdt)[6:]}_kv{str(kvdt)[6:]}"] = [q, kp, vp, table.clone(), lengths]
    return cases


def split_cases(torch, device, gen) -> dict:
    """The edge cases' shapes (B=6, Hkv=8, G=4, D=128, page 16, 35 page
    slots, a 280-page pool) with lengths set by the kernel's split plan on
    this card: one ending on a split boundary, one inside a split, one that
    fits in the first split (fewer live splits than the others), 0 (every
    split walks all its slots), a full table and 1; the three dtype pairs."""
    from repro_torch.kernels import ops

    b, hkv, g, d, page, max_pages, n_pool = 6, 8, 4, 128, 16, 35, 280
    splits, per = ops.paged_split_plan(b, hkv, max_pages, ops.sm_count(device))
    span = per * page
    lengths = torch.tensor([2 * span, 2 * span + 5, span - 3, 0, max_pages * page, 1],
                           dtype=torch.int32, device=device)
    table = torch.randperm(n_pool, generator=gen, device=device)[: b * max_pages]
    table = table.to(torch.int32).reshape(b, max_pages)
    live = ((lengths.long() + page - 1) // page).clamp(min=1)
    live[lengths <= 0] = max_pages
    table[torch.arange(max_pages, device=device)[None] >= live[:, None]] = 0
    cases = {}
    for qdt, kvdt in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                      (torch.float32, torch.float32)):
        q = torch.randn((b, hkv, g, d), generator=gen, device=device).to(qdt)
        kp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device).to(kvdt)
        vp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device).to(kvdt)
        cases[f"splits{splits}x{per}_q{str(qdt)[6:]}_kv{str(kvdt)[6:]}"] = [
            q, kp, vp, table.clone(), lengths]
    return cases


def shape_cases(torch, device, gen) -> dict:
    """Small random states that reach every instance of the kernel beyond
    the served one: bfloat16 at D=256 (the wider mma instance), D=96 (12
    chunks a row: no power of two) with G=5 (two head groups), D=40 (no
    multiple of 16: the bfloat16 CUDA-core instance), D=16 and page 8 (the
    smoke model's); float32 q over bfloat16 at D=80; float32 at D=64 with
    G=8 and page 32.  Random lengths with a 0, page ids anywhere in the
    pool."""
    cases = {}
    for b, hkv, g, d, page, max_pages, n_pool, qdt, kvdt in (
            (3, 2, 4, 256, 16, 40, 200, torch.bfloat16, torch.bfloat16),
            (3, 2, 5, 96, 16, 40, 200, torch.bfloat16, torch.bfloat16),
            (3, 2, 3, 40, 16, 40, 200, torch.bfloat16, torch.bfloat16),
            (2, 1, 4, 16, 8, 5, 20, torch.bfloat16, torch.bfloat16),
            (3, 2, 4, 80, 8, 20, 100, torch.float32, torch.bfloat16),
            (3, 2, 8, 64, 32, 20, 100, torch.float32, torch.float32)):
        q = torch.randn((b, hkv, g, d), generator=gen, device=device).to(qdt)
        kp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device).to(kvdt)
        vp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device).to(kvdt)
        table = torch.randint(0, n_pool, (b, max_pages), generator=gen, device=device,
                              dtype=torch.int32)
        lengths = torch.randint(0, max_pages * page + 1, (b,), generator=gen, device=device,
                                dtype=torch.int32)
        lengths[0] = 0
        cases[f"shape_g{g}_d{d}_page{page}_q{str(qdt)[6:]}_kv{str(kvdt)[6:]}"] = [
            q, kp, vp, table, lengths]
    return cases


def long_context_f32_case(torch, device, gen):
    """float32 q and K/V at the long context's shapes (B=16, Hkv=8, 2,048
    page slots: the same split plan) over a 4,096-page pool; random lengths
    with a 0 and one ending on a split boundary."""
    from repro_torch.kernels import ops

    b, hkv, g, d, page, max_pages, n_pool = 16, 8, 4, 128, 16, 2048, 4096
    _, per = ops.paged_split_plan(b, hkv, max_pages, ops.sm_count(device))
    q = torch.randn((b, hkv, g, d), generator=gen, device=device)
    kp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device)
    vp = torch.randn((n_pool, page, hkv, d), generator=gen, device=device)
    lengths = torch.randint(1, max_pages * page + 1, (b,), generator=gen, device=device,
                            dtype=torch.int32)
    lengths[0], lengths[1] = 0, 2 * per * page
    table = torch.randint(0, n_pool, (b, max_pages), generator=gen, device=device,
                          dtype=torch.int32)
    return [q, kp, vp, table, lengths]


def paged_kernel_phase(torch, device, attn_args, cycles_per_ms) -> dict:
    """``paged_attention`` against its plain version: (a) the inputs of
    decode step ``CAPTURE_STEP``'s layer 0 in the serve run, (b) a long
    context, (c) edge cases, split cases, the kernel's other instances and a
    float32 long context; two
    calls on the same inputs give the same bits; a page id outside the pool,
    in the first or in the last live page slot of sequence 0, gives NaN for
    sequence 0 alone."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)   # > the 50 MB L2

    def same_bits(args, label):
        a, b = ops.paged_attention(*args), ops.paged_attention(*args)
        if not torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32)):
            raise AssertionError(f"paged_attention {label}: two calls gave different bits")

    res = {"serve_step20_layer0": paged_case(torch, attn_args, cycles_per_ms, flush, True)}
    same_bits(attn_args, "serve_step20_layer0")
    long = long_context_case(torch, device, gen)
    res["long_context_b16_32k"] = paged_case(torch, long, cycles_per_ms, flush, True)
    same_bits(long, "long_context_b16_32k")
    del long
    torch.cuda.empty_cache()
    cases = {**edge_cases(torch, device, gen), **split_cases(torch, device, gen),
             **shape_cases(torch, device, gen),
             "long_context_f32_b16": long_context_f32_case(torch, device, gen)}
    for label, args in cases.items():
        got = ops.paged_attention(*args)
        res[label] = dict(max_abs_err=paged_check(torch, got, ref.paged_attention_ref(*args), args))
    del cases
    torch.cuda.empty_cache()
    q, kp, vp, table, lengths = attn_args
    page = kp.shape[1]
    last = (int(lengths[0]) + page - 1) // page - 1
    for slot in (0, last):
        bad = table.clone()
        bad[0, slot] = kp.shape[0]
        out = ops.paged_attention(q, kp, vp, bad, lengths)
        if not (bool(out[0].isnan().all()) and not bool(out[1:].isnan().any())):
            raise AssertionError(f"paged_attention: a page id outside the pool in slot {slot} "
                                 "must give NaN for its row alone")
    res["bad_page_id_gives_nan"] = True
    res["bad_page_id_slots"] = [0, last]
    return res


# ---------------------------------------------------------------------------
# Phases 10-11: flic_merge, replica catch-up on the dense cell's tables.
# ---------------------------------------------------------------------------

MERGE_AT = (300, 420)   # the dense cell's outage starts at tick 300 and ends at 420


def dense_tables_at(torch, device, cfg, ticks) -> dict:
    """The dense cell's cache tables (tags, data_ts, valid, data) after
    each tick count in ``ticks``, from one run with the kernels, stepped as
    ``run_sim`` steps it (the same generator and seed)."""
    from repro_torch.core.simulator import draw_tick, init_sim, sim_tick

    cfg = dataclasses.replace(cfg, probe_backend="cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_sim(cfg, device)
    out = {}
    for t in range(max(ticks)):
        state, _ = sim_tick(cfg, state, draw_tick(cfg, state.plan, t, gen))
        if t + 1 in ticks:
            c = state.caches
            out[t + 1] = [x.clone() for x in (c.tags, c.data_ts, c.valid, c.data)]
    return out


def flat_lines(tables):
    """(N, S, W[, D]) tables as (N*S, W[, D]): one shard of N*S sets."""
    tags, ts, valid, data = tables
    n, s, w = tags.shape
    return [tags.reshape(n * s, w), ts.reshape(n * s, w), valid.reshape(n * s, w),
            data.reshape(n * s, w, data.shape[-1])]


def merge_phase(torch, device, cfg) -> dict:
    """``flic_merge``'s path: its entry ``ops.flic_merge`` reconciles a
    replica that froze when the dense cell's outage began (tick 300) with
    the live tables when it ended (tick 420), the catch-up its docstring
    names; counts set to 0 just before, read just after."""
    from repro_torch.kernels import ops, ref

    tables = dense_tables_at(torch, device, cfg, MERGE_AT)
    a, b = (flat_lines(tables[t]) for t in MERGE_AT)
    ops.reset_launches()
    tags, ts, valid, data = ops.flic_merge(*a, *b)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["flic_merge"] != 1 or sum(launches.values()) != 1:
        raise AssertionError(f"merge: expected one flic_merge launch, got {launches}")
    for i, want in enumerate(ref.flic_merge_ref(*a, *b)):
        if not torch.equal((tags, ts, valid, data)[i], want):
            raise AssertionError(f"merge: output {i} differs from the plain version")
    take_b = b[2] & (~a[2] | (b[1] > a[1]))
    emit("merge", ticks=list(MERGE_AT), sets=a[0].shape[0], ways=a[0].shape[1],
         dim=a[3].shape[-1], launches=launches["flic_merge"],
         lines_valid_a=_count(a[2]), lines_valid_b=_count(b[2]),
         lines_taken_from_b=_count(take_b), lines_tied=_count(a[2] & b[2] & (a[1] == b[1])),
         lines_valid_merged=_count(valid))
    return dict(launches=launches["flic_merge"], args=a + b)


def merge_work(args) -> tuple[int, int, dict]:
    """Bytes: both replicas' timestamp and valid flag (they decide the
    line), the tag and payload of the replica each line takes (the other's
    are never needed), and the merged line written; operations: four
    compares and selects a line."""
    tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b = args
    lines, d = tags_a.numel(), data_a.shape[-1]
    take_b = valid_b & (~valid_a | (ts_b > ts_a))
    nbytes = lines * (2 * (4 + 1) + 4 + 4 * d) + lines * (9 + 4 * d)
    return nbytes, 4 * lines, dict(S=tags_a.shape[0], W=tags_a.shape[1], D=d, lines=lines,
                                   taken_from_b=_count(take_b))


def merge_random(torch, gen, s, w, d):
    """Two arbitrary replicas with forced ties, lines invalid in both, and
    lines where B is newer but invalid."""
    dev = gen.device

    def replica():
        return [torch.randint(0, 2**31 - 1, (s, w), generator=gen, device=dev, dtype=torch.int32),
                torch.randint(0, 10_000, (s, w), generator=gen, device=dev, dtype=torch.int32),
                torch.rand((s, w), generator=gen, device=dev) < 0.7,
                torch.randn((s, w, d), generator=gen, device=dev)]

    a, b = replica(), replica()

    def some(p):
        return torch.rand((s, w), generator=gen, device=dev) < p

    tie, none, stale = some(0.2), some(0.1), some(0.1)
    b[1] = torch.where(tie, a[1], b[1])
    a[2], b[2] = a[2] & ~none, b[2] & ~none
    b[1] = torch.where(stale, a[1] + 1, b[1])
    b[2] = b[2] & ~stale
    return a + b


def merge_kernel_phase(torch, device, catch_up, cycles_per_ms) -> dict:
    """``flic_merge`` bitwise against its plain version and timed (the L2
    cache flushed before each run): (a) the dense cell's catch-up, (b)
    ``benchmarks/kernels_bench.py``'s geometry, (c) random replicas with
    ties, lines invalid in both and invalid newer lines, at a set count no
    block size divides."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)   # > the 50 MB L2
    cases = {"dense_catch_up_t300_t420": catch_up,
             "kernels_bench_s512_w4_d16": merge_random(torch, gen, 512, 4, 16),
             "random_s4099_w4_d8": merge_random(torch, gen, 4099, 4, 8)}
    res = {}
    for label, args in cases.items():
        got = ops.flic_merge(*args)
        torch.cuda.synchronize()
        want = ref.flic_merge_ref(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            bits = (lambda t: t.view(torch.int32)) if g.dtype == torch.float32 else (lambda t: t)
            if g.dtype != w.dtype or not torch.equal(bits(g), bits(w)):
                raise AssertionError(f"flic_merge {label}: output {i} differs from the plain version")

        def fresh():
            flush.zero_()
            return args

        nbytes, ops_n, info = merge_work(args)
        b_ms, b_by = bound(nbytes, ops_n)
        res[label] = dict(info, max_abs_err=float((got[3] - want[3]).abs().max()),
                          ms=time_ms(torch, ops.flic_merge, fresh, cycles_per_ms),
                          plain_ms=time_ms(torch, ref.flic_merge_ref, fresh, cycles_per_ms),
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n,
                          library_ms=None)
    return res


# ---------------------------------------------------------------------------
# Phases 12-14: Mamba2-370M through the ssd_scan kernel.
# ---------------------------------------------------------------------------

# Traffic: 4 prompts of 2,048 seeded tokens (8 chunks of 256), then 32
# greedy decode steps, at the published width (nothing cut).
SSM_ARCH = "mamba2_370m"
SSM_BATCH, SSM_PROMPT_LEN, SSM_DECODE_STEPS = 4, 2048, 32
SSM_TIMED_PREFILLS = 3
SSM_CONSISTENCY_K = (1, 8)


def ssm_generate(torch, cfg, params, tokens, scan) -> dict:
    """``prefill`` of ``tokens`` through the chunk scan ``scan``, then
    ``SSM_DECODE_STEPS`` greedy ``decode_step``s, each call timed on the host clock between
    synchronisations.  Token 0 is the prefill's argmax, token k the argmax
    of decode step k (fed token k-1)."""
    from repro_torch.models.model import decode_step, prefill

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, {"tokens": tokens}, ssd_scan=scan)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    states = caches[0]["blk0"]          # decode returns new tensors: these stay the prefill's
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32, device=tokens.device)
    gen, step_logits, decode_ms = [tok], [], []
    for _ in range(SSM_DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, caches = decode_step(params, cfg, tok, pos, caches)
        tok = out[:, 0].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        step_logits.append(out[:, 0])
        gen.append(tok)
        pos = pos + 1
    return dict(prefill_logits=logits[:, -1], conv=states["conv"], ssd=states["ssd"],
                tokens=torch.cat(gen, dim=1), logits=torch.stack(step_logits),
                prefill_ms=prefill_ms, decode_ms=decode_ms, last=(tok, pos, caches))


def profile_calls(torch, fn, calls: int, host_ms: float, name: str) -> dict:
    """``fn()`` ``calls`` times under ``torch.profiler``: device busy ms a
    call (the CUDA kernels' summed time), the idle share against
    ``host_ms`` (the unprofiled call), kernel launches a call, the time of
    kernel ``name`` and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    if busy_ms <= 0:
        return dict(host_ms=host_ms, device_busy_ms="not measured")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        host_ms=host_ms, device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / host_ms,
        kernel_launches=sum(e.count for e in kernels) / calls,
        **{f"{name}_ms": sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 / calls},
        top_kernels_ms=[[e.key[:80], e.self_device_time_total / 1e3 / calls] for e in top],
    )


def checked_scan(torch, label: str):
    """(scan, record): ``ops.ssd_scan`` that holds every call bitwise
    against the plain version on the same inputs, and the record of its
    calls (count, share of chunk decays that are 0 per call, the first
    call's inputs)."""
    from repro_torch.kernels import ops, ref

    record = dict(calls=0, zero=[], args=None)

    def scan(states, decay, init=None):
        got = ops.ssd_scan(states, decay, init)
        want = ref.ssd_scan_ref(states, decay, init)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{label}: ssd_scan call {record['calls']} differs "
                                 "from the plain version")
        if record["args"] is None:
            record["args"] = [states.clone(), decay.clone(), init]
        record["zero"].append(float((decay == 0).float().mean()))
        record["calls"] += 1
        return got

    return scan, record


def published_ssm_init(torch, params, gen):
    """``params`` with every layer's ``a_log`` and ``dt_bias`` drawn as
    Mamba2 draws them (arXiv 2405.21060; the reference ``Mamba2`` module):
    A uniform in [1, 16], ``a_log = log A``; dt log-uniform in [1e-3, 1e-1]
    (floor 1e-4), ``dt_bias`` its inverse softplus.  The port's init, like
    JAX's, sets ``a_log`` to 1 and ``dt_bias`` to 0, which makes every
    chunk decay of a 256-token chunk 0 in float32."""
    mixer = params["dec"]["g0"]["blk0"]["mixer"]
    shape, dev = mixer["a_log"].shape, mixer["a_log"].device
    a = 1.0 + 15.0 * torch.rand(shape, generator=gen)
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen)).clamp(min=1e-4)
    mixer = dict(mixer, a_log=torch.log(a).to(dev),
                 dt_bias=(dt + torch.log(-torch.expm1(-dt))).to(dev))
    blk = dict(params["dec"]["g0"]["blk0"], mixer=mixer)
    return dict(params, dec=dict(params["dec"], g0=dict(params["dec"]["g0"], blk0=blk)))


def ssm_phase(torch, device) -> dict:
    """The third main path: Mamba2-370M at full width, random weights from
    ``torch.Generator`` seed 0, 4 prompts of 2,048 tokens prefilled and
    decoded 32 greedy steps with the ``ssd_scan`` kernel (counted: 48
    launches, one a layer); again with the plain scan, which must give the
    same prefill logits, states and tokens bit for bit; again with every
    kernel call held bitwise against the plain version on its inputs.
    Then one prefill with Mamba2's published ``a_log``/``dt_bias`` draws,
    whose chunk decays are not 0, kernel against plain in the same way.
    Times, profiles, peak memory, the share of chunk decays that are 0, and
    how far decode step k is from a prefill of the prompt and k tokens."""
    import numpy as np

    from repro_torch.config import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import decode_step, init_model, model_param_defs, prefill
    from repro_torch.models.params import param_count

    cfg = get_arch(SSM_ARCH)
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT_LEN))
                              .astype(np.int32)).to(device)

    prefill(params, cfg, {"tokens": tokens})           # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    krun = ssm_generate(torch, cfg, params, tokens, ops.ssd_scan)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches["ssd_scan"] != cfg.num_layers or sum(launches.values()) != cfg.num_layers:
        raise AssertionError(f"ssm: expected {cfg.num_layers} ssd_scan launches in one prefill "
                             f"and {SSM_DECODE_STEPS} decode steps, got {launches}")
    logits = krun["logits"]
    if krun["tokens"].shape != (SSM_BATCH, SSM_DECODE_STEPS + 1) or not bool(
            torch.isfinite(logits).all() & torch.isfinite(krun["prefill_logits"]).all()):
        raise AssertionError("ssm: logits are not finite or tokens have the wrong shape")

    prun = ssm_generate(torch, cfg, params, tokens, ref.ssd_scan_ref)
    for name in ("prefill_logits", "conv", "ssd", "tokens"):
        if not torch.equal(krun[name], prun[name]):
            raise AssertionError(f"ssm: {name} of the kernel run differs from the plain run's")
    decode_diff = float((krun["logits"] - prun["logits"]).abs().max())

    # every kernel call of a third prefill against the plain version on its inputs
    scan, shadow = checked_scan(torch, "ssm")
    slogits, _ = prefill(params, cfg, {"tokens": tokens}, ssd_scan=scan)
    if shadow["calls"] != cfg.num_layers or not torch.equal(slogits[:, -1], krun["prefill_logits"]):
        raise AssertionError(f"ssm: the checked prefill made {shadow['calls']} scan calls "
                             "or gave other logits")

    # the same with decays that are not 0: the whole prefill, kernel against plain
    pparams = published_ssm_init(torch, params, torch.Generator().manual_seed(1))
    scan, pshadow = checked_scan(torch, "ssm published init")
    plogits, pcaches = prefill(pparams, cfg, {"tokens": tokens}, ssd_scan=scan)
    qlogits, qcaches = prefill(pparams, cfg, {"tokens": tokens}, ssd_scan=ref.ssd_scan_ref)
    pstates, qstates = pcaches[0]["blk0"], qcaches[0]["blk0"]
    if pshadow["calls"] != cfg.num_layers or not bool(torch.isfinite(plogits).all()):
        raise AssertionError(f"ssm published init: {pshadow['calls']} scan calls "
                             "or logits not finite")
    for name, got, want in (("logits", plogits, qlogits), ("conv", pstates["conv"], qstates["conv"]),
                            ("ssd", pstates["ssd"], qstates["ssd"])):
        if not torch.equal(got, want):
            raise AssertionError(f"ssm published init: {name} of the kernel prefill differs "
                                 "from the plain prefill's")
    pdecay = pshadow["args"][1]
    published = dict(
        bitwise_equal_to_plain=["logits", "conv", "ssd"], scan_calls_checked=pshadow["calls"],
        zero_decay_share_mean=statistics.fmean(pshadow["zero"]),
        layer0_decay_min=float(pdecay.min()), layer0_decay_max=float(pdecay.max()),
        layer0_decay_median=float(pdecay.median()))
    del pparams, plogits, qlogits, pcaches, qcaches, pstates, qstates, pshadow

    def timed_prefill(scan):
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(params, cfg, {"tokens": tokens}, ssd_scan=scan)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    prefill_ms = {"kernel": [], "plain": []}
    for _ in range(SSM_TIMED_PREFILLS):      # in turns: kernel, plain
        prefill_ms["kernel"].append(timed_prefill(ops.ssd_scan))
        prefill_ms["plain"].append(timed_prefill(ref.ssd_scan_ref))

    consistency = {}
    for k in SSM_CONSISTENCY_K:
        longer = torch.cat([tokens, krun["tokens"][:, :k]], dim=1)
        want, _ = prefill(params, cfg, {"tokens": longer})
        got = logits[k - 1]
        consistency[f"k{k}"] = dict(
            max_abs_diff=float((got - want[:, -1]).abs().max()),
            argmax_equal=f"{int((got.argmax(-1) == want[:, -1].argmax(-1)).sum())}/{SSM_BATCH}")

    tok, pos, caches = krun["last"]
    decode_med = statistics.median(krun["decode_ms"])
    prefill_med = statistics.median(prefill_ms["kernel"])
    prof_decode = profile_calls(torch, lambda: decode_step(params, cfg, tok, pos, caches), 3,
                                decode_med, "ssd_scan")
    prof_prefill = profile_calls(torch, lambda: prefill(params, cfg, {"tokens": tokens}), 1,
                                 prefill_med, "ssd_scan")
    emit("ssm", arch=cfg.name, params=param_count(model_param_defs(cfg)), init_s=init_s,
         batch=SSM_BATCH, prompt_len=SSM_PROMPT_LEN, chunk=cfg.ssm_chunk,
         decode_steps=SSM_DECODE_STEPS, launches=launches,
         prefill_ms_first=krun["prefill_ms"], prefill_ms_kernel=prefill_ms["kernel"],
         prefill_ms_plain=prefill_ms["plain"], prefill_ms_median=prefill_med,
         prefill_tokens_per_s=SSM_BATCH * SSM_PROMPT_LEN / (prefill_med / 1e3),
         decode_ms_per_step_median=decode_med,
         decode_ms_per_step_median_plain=statistics.median(prun["decode_ms"]),
         decode_tokens_per_s=SSM_BATCH / (decode_med / 1e3),
         bitwise_equal_to_plain=["prefill_logits", "conv", "ssd", "tokens"],
         decode_logits_max_abs_diff_vs_plain=decode_diff,
         scan_calls_checked=shadow["calls"],
         zero_decay_share_by_layer=shadow["zero"],
         zero_decay_share_mean=statistics.fmean(shadow["zero"]),
         published_init=published,
         max_abs_logit=float(logits.abs().max()),
         decode_vs_prefill=consistency, peak_memory_bytes=peak,
         profile_decode_step=prof_decode, profile_prefill=prof_prefill,
         tokens_row0=krun["tokens"][0].tolist())
    return dict(launches=launches["ssd_scan"], scan_args=shadow["args"])


def ssm_replay_phase(torch, device) -> None:
    """The committed JAX fixture (Mamba2 smoke config, float32 and
    bfloat16) through the port with the kernel, teacher-forced, held to
    the CPU tests' tolerances."""
    from repro_torch.kernels import ops
    from repro_torch.models.replay import (
        SSM_TOL,
        compare_ssm_case,
        load_model_replay,
        replay_ssm_case,
        ssm_case_ok,
    )

    path = ROOT / "src" / "repro_torch" / "testdata" / "ssm_mamba2_smoke.npz"
    cfg, tree, cases = load_model_replay(path)
    for dtype, case in sorted(cases.items()):
        ops.reset_launches()
        res = compare_ssm_case(case, replay_ssm_case(cfg, tree, dtype, case, device),
                               SSM_TOL[dtype])
        torch.cuda.synchronize()
        res["launches"] = ops.LAUNCHES["ssd_scan"]
        if not ssm_case_ok(res, SSM_TOL[dtype]) or res["launches"] != cfg.num_layers:
            raise AssertionError(f"ssm replay {dtype}: {res}")
        emit("ssm_replay", case=dtype, tol=SSM_TOL[dtype], **res)


def scan_work(states, decay, init) -> tuple[int, int, dict]:
    """Bytes: every chunk state and decay read once, init where given, every
    entering state and the final state written once; operations: a
    multiply and an add an element a chunk."""
    b, c, h, p, n = states.shape
    lanes = b * h * p * n
    nbytes = 4 * (2 * states.numel() + decay.numel() + lanes * (2 if init is not None else 1))
    return nbytes, 2 * states.numel(), dict(B=b, C=c, H=h, P=p, N=n, init=init is not None)


def scan_random(torch, gen, b, c, h, p, n, lo, hi, with_init):
    dev = gen.device
    states = torch.randn((b, c, h, p, n), generator=gen, device=dev)
    decay = lo + (hi - lo) * torch.rand((b, c, h), generator=gen, device=dev)
    init = torch.randn((b, h, p, n), generator=gen, device=dev) if with_init else None
    return [states, decay, init]


def scan_kernel_phase(torch, device, served, cycles_per_ms) -> dict:
    """``ssd_scan`` bitwise against its plain version and timed (the L2
    cache flushed before each run): (a) layer 0 of the served prefill, (b)
    a long context of 128 chunks with decays in [0.95, 1), (c) decays
    uniform in (0, 1) from a non-zero init at the served shape, and a
    ragged shape of 128 long-memory chunks, (d)
    ``benchmarks/kernels_bench.py``'s geometry."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    cases = {
        "served_prefill_layer0": served,
        "long_context_b1_c128": scan_random(torch, gen, 1, 128, 32, 64, 128, 0.95, 1.0, False),
        "random_uniform_decay_init": scan_random(torch, gen, 4, 8, 32, 64, 128, 0.0, 1.0, True),
        "random_ragged_long_memory_init": scan_random(torch, gen, 3, 128, 5, 7, 9, 0.95, 1.0, True),
        "kernels_bench_b2_c16": scan_random(torch, gen, 2, 16, 32, 64, 128, 0.0, 1.0, False),
    }
    res = {}
    for label, args in cases.items():
        got = ops.ssd_scan(*args)
        torch.cuda.synchronize()
        want = ref.ssd_scan_ref(*args)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"ssd_scan {label}: differs from the plain version")

        def fresh():
            flush.zero_()
            return args

        nbytes, ops_n, info = scan_work(*args)
        b_ms, b_by = bound(nbytes, ops_n)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        res[label] = dict(info, zero_decay_share=float((args[1] == 0).float().mean()),
                          max_abs_err=err,
                          ms=time_ms(torch, ops.ssd_scan, fresh, cycles_per_ms),
                          plain_ms=time_ms(torch, ref.ssd_scan_ref, fresh, cycles_per_ms),
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n,
                          library_ms=None)
        del got, want
    return res


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port (src/repro_torch) is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import workload as wl
    from repro_torch.core.simulator import SimConfig
    from repro_torch.kernels import build

    device = torch.device("cuda")
    # float32 products in full float32 (the plain versions are references)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    logs = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         ptxas={k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
                for k, v in logs.items()})

    dense_cfg = SimConfig(
        n_nodes=1000, cache_lines=200, loss_model="gilbert_elliott",
        workload=wl.SCENARIOS["zipf_hot"], outage_schedule=((300, 120),),
    )
    city_cfg = SimConfig(n_nodes=10_000, cache_lines=200,
                         workload=dataclasses.replace(wl.SCENARIOS["paper"], fanout=32))

    cycles_per_ms = spin_cycles_per_ms(torch)
    kres = kernel_phase(torch, device, dense_cfg, city_cfg, cycles_per_ms)
    emit("kernels", bitwise_equal=True, spin_cycles_per_ms=cycles_per_ms, **kres)

    replay_phase(torch, device)

    dense_launches, _ = engine_phase(torch, device, "dense", dense_cfg, 600, FLIC_KERNELS)
    city_launches, city = engine_phase(torch, device, "city", city_cfg, 120, ("flic_insert",))
    if city["queue_dropped"] <= 0:
        raise AssertionError("city: the writer ring was expected to overflow")

    serve = serve_phase(torch, device)
    pres = paged_kernel_phase(torch, device, serve.pop("attn_args"), cycles_per_ms)
    emit("kernels", kernel=PAGED, spin_cycles_per_ms=cycles_per_ms, **pres)
    serve_replay_phase(torch, device)
    torch.cuda.empty_cache()

    merge = merge_phase(torch, device, dense_cfg)
    mres = merge_kernel_phase(torch, device, merge.pop("args"), cycles_per_ms)
    emit("kernels", kernel="flic_merge", spin_cycles_per_ms=cycles_per_ms, **mres)

    ssm = ssm_phase(torch, device)
    sres = scan_kernel_phase(torch, device, ssm.pop("scan_args"), cycles_per_ms)
    emit("kernels", kernel="ssd_scan", spin_cycles_per_ms=cycles_per_ms, **sres)
    ssm_replay_phase(torch, device)

    # Headline case of each FLIC kernel: the first main-path case of the
    # kernels phase.  Launches: both main-path runs (dense, then city), each
    # counted from 0.  max_abs_err is 0: every FLIC kernel passed a bitwise
    # comparison.  paged_attention: the serve run's launches, its headline
    # the serve step's inputs, its error the largest over all its cases.
    lines = []
    for name in FLIC_KERNELS:
        head = next(iter(kres[name].values()))
        lines.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": dense_launches[name] + city_launches[name],
            "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None,
        })
    head = pres["serve_step20_layer0"]
    lines.append({
        "name": PAGED, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{PAGED}.cu",
        "replaces": REPLACES[PAGED], "launches": serve["launches"],
        "max_abs_err": max([serve["max_abs_err"]]
                           + [v["max_abs_err"] for v in pres.values() if isinstance(v, dict)]),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
    })
    # flic_merge: its entry's run on the dense cell's catch-up; ssd_scan: the
    # Mamba2 run's launches (one prefill).  Error: the largest over all cases.
    for name, launches, cases in (("flic_merge", merge["launches"], mres),
                                  ("ssd_scan", ssm["launches"], sres)):
        head = next(iter(cases.values()))
        lines.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for v in cases.values()),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": lines}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
