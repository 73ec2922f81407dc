#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the FLIC fog cache, its serving engine,
its Mamba2, MoE, hybrid, VLM and encoder-decoder models, its int8 K/V
decode, its trainer and its example drivers on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It builds the
hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc``, then runs these phases, each printing one JSON line:

1. ``device``: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions;
2. ``build``: the build time of the kernels and ``ptxas``'s resource lines
   for each entry function (every template instance); a stack frame or a
   spill in any of them fails the run;
3. ``kernels``: each kernel against its plain PyTorch version (bitwise),
   first on the inputs the main path gives it (copied from one tick of the
   dense and the city cell), then on arbitrary states at the same shapes
   (for ``flic_update`` also a hot-key state, where ~R rows race for one
   line, and a table too large for the kernel's shared memory, swept in
   ranges of sets); for ``flic_insert`` and ``flic_lookup`` also states
   that reach each of their instantiations (``ops.row_plans``: W in {1, 2,
   3, 4, 8} with D in {3, 8}, tables 16-byte aligned and 4 bytes past a
   boundary, which takes the scalar path) and a lookup on S = 8,192; with
   the dense tick-200 sweep and write wave cut to the nodes of rank 1 of
   4 (250 caches; the sweep by all 1,000 rows), the shapes a shard gives
   ``flic_update`` and ``flic_insert``; with
   the median time of 20 runs of each, the card's time bound for the bytes
   that those inputs need, and ``launch_floor_ms``, the time of an empty
   launch (``torch.cuda._sleep(0)``) under the same timing;
4. ``replay``: the committed JAX replays (``src/repro_torch/testdata``:
   all 17 conformance cases at seeds 0 and 1) through ``run_sim`` with the
   kernels; each ``TickMetrics`` series must equal JAX's bitwise, each run
   must launch ``flic_insert``, ``flic_update`` where the workload is
   mutable and ``flic_lookup`` where the probe is dense, and all three must
   have launched across the replays;
5. ``dense``: the main path, N=1,000 nodes, dense gossip, the ``zipf_hot``
   workload (the coherence sweep is live), Gilbert-Elliott loss and a store
   outage, 600 ticks, with the kernels and with the inline path; the two
   series must be equal and each kernel must have launched;
6. ``city``: the paper's stream at N=10,000 nodes with fan-out 32, 120
   ticks, with the kernels and with the inline path; equal series;
6a. ``replicate``: the dense cell's shape on the paper's stream under the
   replicate policy (every hearer upserts every row; Bernoulli loss 0.1),
   30 ticks: ``flic_insert`` once per broadcast row (N a tick) and once for
   the fills, ``flic_lookup`` once a tick; equal series;
6b. ``poisson``: the dense cell under Poisson arrivals (rate 1, 4 write
   lanes a node), Gilbert-Elliott loss, an outage (150, 60), 300 ticks;
   ``flic_insert`` 5, ``flic_update`` 4 and ``flic_lookup`` 1 a tick;
6c. ``trace``: the dense cell replaying the ``trace_ycsb`` trace (T = 600,
   half reads, zipf 0.99) with the same loss and outage, 300 ticks; the
   trace on the card must equal ``materialize_trace``'s numpy arrays;
6d. ``reference``: the reference engine (``run_any_engine(engine=
   "reference")``) on every seed-0 replay, bitwise equal to JAX's series;
6e. ``distributed``: the parity engine (``core/distributed.py``) on the
   dense cell, 600 ticks with the kernels, on spawned ranks over
   ``torch.distributed``: world 1 over NCCL and world 4 over gloo (four
   processes on the one card; the card's compute mode must admit them);
   each series bitwise equal to the dense cell's fused run but for
   ``wire_bytes``, which must equal the ring model; every rank launches
   ``flic_update`` once a tick; ticks/s, host ms a tick, modelled bytes a
   tick and each rank's peak memory;
6f. ``distributed_replay``: the 17 seed-0 JAX replays through the parity
   engine at world 4, bitwise equal to JAX's series, each rank launching
   the kernels its config reaches;
6g. ``sharded``: the bandwidth-lean engine (``core/sharded.py``) on the
   dense cell at world 1 and world 4, held to the ``zipf_hot`` tolerance
   tier against the fused run (exact reads, writes and rejoins, write
   conservation, miss and stale ratios within 0.12 and 0.10), its
   modelled wire bytes at world 4 at most half the parity engine's;
   ``flic_update`` once and ``flic_insert`` at least twice a tick on every
   rank.  6e-6g run in two spawned groups, one per world (the world-4
   group runs the replays too), each announced by a ``multi_rank_group``
   line with its wall time;
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
   0, fewer live splits; a float32 long context), on other shapes, on K/V
   rows that are not 16-byte multiples (D = 12, 13, 20 in bfloat16, 12 and
   13 in float32, the Granite-3 smoke model's split) and on pages 8 bytes
   off a 16-byte boundary, each with the unit of its row copies
   (``ops.paged_row_plan``), so that every instance of the kernel runs,
   with times, bounds and a ``scaled_dot_product_attention`` yardstick;
   two calls give the same bits, two calls with different split plans
   running at once on two streams give the bits of each run alone, and a
   bad page id in the first or the last live slot gives NaN for its
   sequence alone;
9. ``serve_replay``: the committed JAX serving fixtures (the Granite-8B and
   the Granite-3-8B smoke configs; head size 16 and 12) through the port
   with the kernel, teacher-forced, including a tight pool that evicts,
   spills and fetches pages back; the page manager's stats must equal
   JAX's;
10. ``serve_granite3``: Granite-3-8B at its published widths (40 layers,
    head size 128, vocabulary 49,155; random bfloat16 weights from seed 0,
    Granite-8B's freed first), 4 prompts of 512 tokens at batch 4, 16 new
    tokens, page 16, through the kernel (once a layer and decode step),
    then again with every kernel call held against the plain version;
    prefill and decode times and peak memory;
11. ``merge``: ``flic_merge``'s path, its entry ``ops.flic_merge``
    reconciling the dense cell's tables frozen at the outage's start (tick
    300) with those at its end (tick 420), launched once;
12. ``kernels`` (``flic_merge``): the kernel against its plain version
    (bitwise) on that catch-up, on ``kernels_bench.py``'s geometry, on
    random replicas with ties and invalid lines, on every instantiation
    (``ops.merge_plans``) and on tables 4 bytes off a 16-byte boundary,
    timed with events and with the profiler (the kernel's own time), and
    bound;
13. ``ssm``: the third main path, Mamba2-370M at full width (random
    weights from seed 0), 4 prompts of 2,048 tokens prefilled and decoded
    32 greedy steps with the ``ssd_scan`` kernel (48 launches, one a layer
    of the prefill); the plain scan must give the same prefill logits,
    states and tokens bit for bit, and every kernel call equals the plain
    version on its inputs; one more prefill with Mamba2's published
    ``a_log``/``dt_bias`` draws, whose chunk decays are not 0, held kernel
    against plain in the same way; prefill and decode times, profiles of a decode
    step and a prefill, peak memory, the share of chunk decays that are 0,
    and decode step k against a prefill of the prompt and k tokens;
14. ``kernels`` (``ssd_scan``): the kernel against its plain version
    (bitwise) on the served prefill's layer 0, a 128-chunk long context,
    random decays with an initial state and ``kernels_bench.py``'s
    geometry, timed and bound;
15. ``ssm_replay``: the committed JAX Mamba2 fixture (float32 and
    bfloat16) through the port with the kernel, teacher-forced, within the
    CPU tests' tolerances;
16. ``train``: the fourth main path, Mamba2-370M trained at full width and
    depth (random weights from seed 0) on ``synthetic_batch`` at 4 x 2,048
    tokens, remat on, 8 steps through ``Trainer`` with one checkpoint save:
    ``ssd_scan`` 96 and ``ssd_scan_bwd`` 48 launches a step, a falling
    loss; first one step's gradient with the kernels against the plain
    scan and its plain backward (the loss bitwise equal); step ms,
    tokens/s, peak memory, a profiled step;
17. ``kernels`` (``ssd_scan_bwd``): the backward kernel against its plain
    version (``g_states`` and ``g_init`` bitwise, ``g_decay`` within its
    stated tolerance, two calls bitwise equal) on layer 0 of the train
    step, on the ``ssm`` phase's published-init prefill and on 128 chunks
    of decays in [0.95, 1), timed and bound;
18. ``train_dense``: Granite-8B at full width with depth cut to 4 layers,
    4 x 2,048 tokens, 4 steps with remat: loss, step ms, peak memory, a
    profiled step; then the same steps through ``Trainer`` with a fault
    injected at step 3 and recovered from step 2's checkpoint, its params
    against the uninterrupted run's;
19. ``train_replay``: the committed JAX training fixtures (Granite-8B,
    Mamba2, DeepSeek-V2-Lite, Jamba and SeamlessM4T smoke configs, float32
    and bfloat16; DeepSeek's with MLA, MoE and its load-balance loss,
    Jamba's with SSM, MoE and attention blocks in one group, SeamlessM4T's
    encoder and cross-attention) through the port's train step with the
    kernels, within the CPU tests' tolerances;
20. ``moe``: the fifth main path, DeepSeek-V2-Lite-16B at full width (MLA,
    64 routed experts top-6 and 2 shared; 15,706,484,224 random bfloat16
    parameters from seed 0, the router float32), 4 prompts of 512 tokens
    prefilled at batch 4 and decoded 32 greedy steps against contiguous
    latent caches; finite logits, the same tokens from a second decode,
    layer 1's ``moe_forward`` against a direct float32 reference of its
    kept (token, expert) pairs, the pairs dropped at capacity per layer,
    times, profiles, peak memory, and decode step 1 against a prefill
    continuation; no hand kernel lies on this path (JAX's dispatch and MLA
    are XLA, outside any Pallas kernel);
21. ``moe_replay``: the committed JAX MoE fixtures (DeepSeek-V2-Lite's and
    Qwen3-MoE's smoke configs, float32 and bfloat16) through the port,
    teacher-forced, within the CPU tests' tolerances;
22. ``example``: the four example drivers (``python -m
    repro_torch.examples.<name>``: ``quickstart``, ``serve_paged``,
    ``cityscale_cache_sim`` with the fused engine, ``train_lm`` with a
    fault) in processes of their own, started together; each must exit 0
    with its closing line;
23. ``hybrid``: the sixth main path, one whole Jamba-1.5-Large period at
    its published widths (8 of 72 layers: 7 Mamba2 mixers of 256 heads and
    one GQA attention, dense MLPs and MoE of 16 experts top-2 in turn;
    45,144,659,968 parameters in the config, 16,153,630,720 held, the four
    MoE layers sharing one expert stack; bfloat16 from seed 0 with the f32
    router and Mamba2's published ``a_log``/``dt_bias`` in every SSM
    layer), 4 prompts of 2,048 tokens prefilled at batch 4 (7
    ``ssd_scan`` launches) and decoded 32 greedy steps on mixed contiguous
    caches (K/V at block 4 alone, SSM states at the others); finite
    logits, the same tokens from a second decode, every scan call of a
    prefill bitwise equal to plain, layer 1's ``moe_forward`` against
    ``moe_reference``, the pairs dropped per MoE layer, times, profiles,
    peak memory, a decode step against a prefill of the same 1,024 tokens;
    then ``kernels`` (``ssd_scan``): the kernel on the prefill's layer 0
    (H = 256), timed and bound;
24. ``hybrid_replay``: the committed JAX hybrid fixture (Jamba's smoke
    config, float32 and bfloat16) through the port with the kernel,
    teacher-forced, within the CPU tests' tolerances;
25. ``vlm``: the seventh main path, InternVL2-2B at full width (24 layers,
    1,889,146,880 random bfloat16 parameters from seed 0) behind 256
    seeded patch embeddings: 4 x (256 + 512) positions prefilled, 32
    greedy decode steps from position 768, repeated; the 4 text prompts
    through ``ServeEngine`` with ``paged_attention`` (once a layer and
    step), every kernel call held to plain and the run to the contiguous
    oracle within ``SERVE_TOL``; then ``kernels`` (``paged_attention``):
    the kernel on that run's layer-0 inputs (G 2), timed with its SDPA
    yardstick;
26. ``vlm_replay``: the committed JAX VLM fixture (InternVL2's smoke
    config with its patches, float32 and bfloat16), teacher-forced, within
    the CPU tests' tolerances;
27. ``encdec``: the eighth main path, SeamlessM4T-medium at full width (12
    non-causal encoder and 12 decoder layers with cross-attention, d 1,024,
    vocab 256,206; 977,758,208 random bfloat16 parameters from seed 0),
    nothing cut: 4 requests of 4,096 seeded bfloat16 frame embeddings and
    512 seeded tokens prefilled at batch 4, then 32 greedy decode steps on
    ``decode_cache_specs`` caches holding the prefill's cross K/V, twice;
    the same tokens both times, every layer's cross K/V after the last
    step bitwise what prefill wrote, prefill ms with the encoder's share,
    decode ms a step and tokens/s, profiles, peak memory, and decode step
    1 against a prefill of the same 513 tokens;
28. ``encdec_replay``: the committed JAX encoder-decoder fixture
    (SeamlessM4T's smoke config with its frames, float32 and bfloat16),
    teacher-forced, within the CPU tests' tolerances; the Seamless training
    fixture joins ``train_replay``;
29. ``kv_int8``: Granite-8B at full width on int8 K/V caches: 4 x 512
    tokens prefilled, each layer's K/V rows quantized (``quantize_kv_row``)
    into ``decode_cache_specs(..., kv_int8=True)`` caches, 32 greedy steps
    on them and 32 on the bfloat16 caches; ms a step and cache bytes of
    each, the step-1 logit gap and the argmax agreement, the caches still
    int8; then one step of each at context 32,768 (batch 4, caches filled
    from seeded rows), timed.

After each engine cell (``dense``, ``city``, ``replicate``, ``poisson``,
``trace``) a ``profile`` line checks that a tick never synchronises the host
and says where its time goes on the card.

Then one line lists every kernel with its numbers, one line holds
``nvidia-smi``'s name and power limit, and the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device, or without the port beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
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
    # no TPU kernel: JAX's gradient is XLA's autodiff of the model's lax.scan
    "ssd_scan_bwd": "none (XLA autodiff of src/repro/models/ssm.py:131)",
}



def ptxas_report(log: str) -> dict:
    """``{entry function: its ptxas lines}`` from an ``nvcc -Xptxas -v``
    log: registers, barriers and constant memory; stack frame and spills.
    Names are demangled with ``c++filt`` where it is installed and cut to
    the function and its template arguments."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
        if m:
            fn = m.group(1)
        elif fn and ("registers" in ln or "stack frame" in ln):
            text = ln.split(" : ", 1)[-1].strip()
            out[fn] = f"{out[fn]}; {text}" if fn in out else text
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        short = [re.sub(r"^void |\(anonymous namespace\)::", "", n).split("(")[0] for n in names]
        if len(short) == len(out):
            out = dict(zip(short, out.values()))
    return out


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


def copy_at(torch, t, offset: int):
    """A copy of ``t`` that starts ``offset`` bytes past a 16-byte boundary:
    a contiguous view into a larger buffer, reshaped, where ``offset`` > 0."""
    if offset == 0:
        return t.clone()
    skip = offset // t.element_size()
    buf = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    view = buf[skip:].view(t.shape)
    view.copy_(t)
    return view


def clone_at_offset(torch, t):
    """A copy of ``t`` at the same offset from a 16-byte boundary, so that a
    fresh copy of a misaligned case takes the same kernel instantiation."""
    return copy_at(torch, t, t.data_ptr() % 16)


def plan_of(name: str, args):
    """The instantiation the wrapper of FLIC kernel ``name`` launches for
    ``args`` (``ops.insert_plan_for`` / ``ops.lookup_plan_for``, which the
    wrappers call); None for the others."""
    from repro_torch.kernels import ops

    if name == "flic_insert":
        return ops.insert_plan_for(*args)
    if name == "flic_lookup":
        return ops.lookup_plan_for(*args)
    return None


def check_and_time(torch, name: str, args, cycles_per_ms: float) -> dict:
    """One call of kernel ``name`` held bitwise against its plain version
    on the same inputs, then both timed."""
    from repro_torch.kernels import ops, ref

    kernel, plain = getattr(ops, name), getattr(ref, f"{name}_ref")

    def fresh():
        return [clone_at_offset(torch, a) if isinstance(a, torch.Tensor) else a for a in args]

    got = kernel(*fresh())
    torch.cuda.synchronize()
    want = plain(*args)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain version")
    nbytes, ops_n, info = WORK[name](torch, *args)
    b_ms, b_by = bound(nbytes, ops_n)
    plan = plan_of(name, args)
    if plan is not None:
        info["plan"] = plan._asdict()
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


def insert_state(torch, gen, pool, n, s, w, d, aligned=True):
    """Random ``flic_insert`` arguments: N nodes, S sets of W ways, D
    payload floats; ``aligned=False`` puts every table and ``line_data`` 4
    bytes past a 16-byte boundary."""
    from repro_torch.core.cache_state import set_index

    dev = gen.device
    keys = pool[torch.randint(0, pool.numel(), (n,), generator=gen, device=dev)]
    args = [*random_tables(torch, gen, n, s, w, d, pool), keys,
            set_index(keys, s).to(torch.int32),
            torch.randint(-1, 25, (n,), generator=gen, device=dev, dtype=torch.int32),
            torch.randint(0, n, (n,), generator=gen, device=dev, dtype=torch.int32),
            torch.rand(n, generator=gen, device=dev) < 0.5,
            torch.rand(n, generator=gen, device=dev) < 0.8,
            torch.rand((n, d), generator=gen, device=dev), 30]
    if not aligned:
        args[:8] = [copy_at(torch, t, 4) for t in args[:8]]
        args[14] = copy_at(torch, args[14], 4)
    return args


def lookup_state(torch, gen, pool, c, s, w, d, q, aligned=True):
    """Random ``flic_lookup`` arguments: C caches of S sets x W ways, D
    payload floats, Q queries; ``aligned=False`` puts the tables 4 bytes
    past a 16-byte boundary."""
    from repro_torch.core.cache_state import set_index

    dev = gen.device
    tags, data_ts, _, _, valid, _, _, data = random_tables(torch, gen, c, s, w, d, pool)
    tables = [tags, data_ts, valid, data]
    if not aligned:
        tables = [copy_at(torch, t, 4) for t in tables]
    keys = pool[torch.randint(0, pool.numel(), (q,), generator=gen, device=dev)]
    return [*tables, keys, set_index(keys, s).to(torch.int32)]


def coverage_cases(torch, device) -> dict:
    """Random states that reach every instantiation of ``flic_insert`` and
    ``flic_lookup`` (``ops.row_plans``) through the wrappers' own choice:
    W in {1, 2, 3, 4, 8} with D in {3, 8}, 16-byte aligned tables and tables
    4 bytes past a boundary (the scalar path), at the dense cell's sizes
    (N = C = 1,000 caches of S = 50 sets, Q = 67 queries; 2,000 inserting
    nodes); ``w4_d8_offset4`` is the main shape at a 4-byte offset.  Also
    a lookup on S = 8,192 (``w4_d8_s8192``, 8 caches, 1,000 queries).
    ``{name: {label: args}}``."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    pool = torch.randint(-2**31, 2**31 - 1, (48,), generator=gen, device=device,
                         dtype=torch.int32)
    insert, lookup = {}, {}
    for plan in ops.row_plans():
        w = plan.ways or 3
        aligned = plan.ways <= 1 or plan.row16   # a scalar row above W = 1: off a boundary
        d = 8 if plan.pay16 or not aligned else 3
        label = f"w{w}_d{d}" + ("" if aligned else "_offset4")
        insert[label] = insert_state(torch, gen, pool, 2_000, 50, w, d, aligned)
        lookup[label] = lookup_state(torch, gen, pool, 1_000, 50, w, d, 67, aligned)
    lookup["w4_d8_s8192"] = lookup_state(torch, gen, pool, 8, 8_192, 4, 8, 1_000)
    return {"flic_insert": insert, "flic_lookup": lookup}


SHARD_WORLD, SHARD_RANK = 4, 1   # the gloo groups on the one card; the rank the shard cases cut


def rank_nodes(n: int) -> slice:
    """The nodes of rank ``SHARD_RANK`` of ``SHARD_WORLD`` in an N-node fog."""
    per = n // SHARD_WORLD
    return slice(SHARD_RANK * per, (SHARD_RANK + 1) * per)


def shard_update_case(args) -> dict:
    """The dense tick-200 sweep as rank 1 of 4 of the distributed engine
    makes it: its 250 caches by all R = 1,000 rows, the live mask's rows
    of its nodes."""
    nodes = rank_nodes(args[0].shape[0])
    tables = [a[nodes].contiguous() for a in args[:5]]
    cut = tables + list(args[5:9]) + [args[9][nodes].contiguous(), args[10]]
    return {f"shard_rank{SHARD_RANK}of{SHARD_WORLD}_t200": cut}


def shard_insert_case(args) -> dict:
    """The dense tick-200 write wave cut to rank 1 of 4's nodes: the shape
    of a sharded rank's write wave (its 250 rows into its 250 caches)."""
    nodes = rank_nodes(args[0].shape[0])
    return {f"shard_rank{SHARD_RANK}of{SHARD_WORLD}_t200_writes":
            [a[nodes].contiguous() for a in args[:15]] + [args[15]]}


def kernel_phase(torch, device, cfgs, cycles_per_ms) -> dict:
    """Each kernel on the inputs the main path gives it (copied from one
    tick of each cell: dense tick 200, before the outage; city tick 60;
    replicate tick 20, row 500; poisson and trace tick 100, before their
    outage) and on arbitrary states; bitwise against the plain version,
    timed, bound.  The first main-path case of each kernel is its headline.
    For ``flic_insert`` and ``flic_lookup`` also every instantiation
    (``coverage_cases``, which must reach each of ``ops.row_plans``)."""
    from repro_torch.kernels import ops

    dense = capture_main_path(torch, device, cfgs["dense"], 201, {
        "flic_update": (200,), "flic_lookup": (200,), "flic_insert": (400,)})
    city = capture_main_path(torch, device, cfgs["city"], 61, {"flic_insert": (120, 121)})
    n_rep = cfgs["replicate"].n_nodes + 1          # insert calls a replicate tick
    rep = capture_main_path(torch, device, cfgs["replicate"], 21, {
        "flic_insert": (20 * n_rep + 500,), "flic_lookup": (20,)})
    poi = capture_main_path(torch, device, cfgs["poisson"], 101, {
        "flic_insert": (100 * 5 + 2,), "flic_update": (100 * 4 + 1,)})
    trc = capture_main_path(torch, device, cfgs["trace"], 101, {
        "flic_lookup": (100,), "flic_update": (100,)})
    cases = {
        "flic_insert": {"city_t60_writes": city["flic_insert", 120],
                        "city_t60_fills": city["flic_insert", 121],
                        "dense_t200_writes": dense["flic_insert", 400],
                        "replicate_t20_row500": rep["flic_insert", 20 * n_rep + 500],
                        "poisson_t100_wave2": poi["flic_insert", 100 * 5 + 2]},
        "flic_update": {"dense_t200": dense["flic_update", 200],
                        "poisson_t100_wave1": poi["flic_update", 100 * 4 + 1],
                        "trace_t100": trc["flic_update", 100]},
        "flic_lookup": {"dense_t200": dense["flic_lookup", 200],
                        "replicate_t20": rep["flic_lookup", 20],
                        "trace_t100": trc["flic_lookup", 100]},
    }
    cases["flic_update"].update(shard_update_case(dense["flic_update", 200]))
    cases["flic_insert"].update(shard_insert_case(dense["flic_insert", 400]))
    for more in (random_cases(torch, device), coverage_cases(torch, device)):
        for name, by_label in more.items():
            cases[name].update(by_label)
    out = {
        name: {label: check_and_time(torch, name, args, cycles_per_ms)
               for label, args in by_label.items()}
        for name, by_label in cases.items()
    }
    for name in ("flic_insert", "flic_lookup"):
        reached = {tuple(v["plan"].values()) for v in out[name].values()}
        missing = [p for p in ops.row_plans() if tuple(p) not in reached]
        if missing:
            raise AssertionError(f"{name}: no case reached the instantiations {missing}")
    return out


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


def replay_kernels(cfg) -> tuple[str, ...]:
    """The FLIC kernels a run of ``cfg`` with ``probe_backend="cuda"`` must
    launch: the upsert always, the sweep on mutable workloads, the probe
    where it is dense."""
    need = ["flic_insert"]
    if cfg.workload.mutable and cfg.insert_policy == "directory":
        need.append("flic_update")
    if cfg.workload.fanout is None:
        need.append("flic_lookup")
    return tuple(need)


def replay_phase(torch, device) -> list:
    """Every committed JAX replay through ``run_sim`` with the kernels,
    bitwise; returns the paths."""
    import numpy as np

    from repro_torch.core.metrics import EMBODIMENT_FIELDS
    from repro_torch.core.replay import load_replay
    from repro_torch.core.simulator import run_sim
    from repro_torch.kernels import ops

    paths = sorted((ROOT / "src" / "repro_torch" / "testdata").glob("replay_*.npz"))
    if len(paths) != 34:
        raise AssertionError(f"expected 34 replay fixtures, found {len(paths)}")
    total = dict.fromkeys(FLIC_KERNELS, 0)
    for path in paths:
        cfg, draws, expected = load_replay(path, device)
        cfg = dataclasses.replace(cfg, probe_backend="cuda")
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, series = run_sim(cfg, len(draws), device=device, draws=draws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        for f, want in expected.items():
            if f in EMBODIMENT_FIELDS:
                continue
            got = getattr(series, f).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"replay {path.name}: TickMetrics.{f} diverged from JAX")
        missing = [k for k in replay_kernels(cfg) if launches[k] == 0]
        if missing:
            raise AssertionError(f"replay {path.name}: kernels {missing} not launched: {launches}")
        for k in FLIC_KERNELS:
            total[k] += launches[k]
        emit("replay", file=path.name, ticks=len(draws), equal_to_jax=True,
             ticks_per_s=len(draws) / secs, launches=launches)
    if not all(total.values()):
        raise AssertionError(f"replays: a FLIC kernel never launched: {total}")
    return paths


def reference_phase(torch, device, paths) -> None:
    """The reference engine on every seed-0 replay, bitwise equal to JAX's
    fused series."""
    import numpy as np

    from repro_torch.core.metrics import EMBODIMENT_FIELDS
    from repro_torch.core.replay import load_replay
    from repro_torch.core.simulator import run_any_engine

    seed0 = [p for p in paths if not re.search(r"_s\d+\.npz$", p.name)]
    if len(seed0) != 17:
        raise AssertionError(f"expected 17 seed-0 replays, found {len(seed0)}")
    for path in seed0:
        cfg, draws, expected = load_replay(path, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, series = run_any_engine(cfg, len(draws), engine="reference", draws=draws,
                                   device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for f, want in expected.items():
            if f not in EMBODIMENT_FIELDS and not np.array_equal(
                    getattr(series, f).cpu().numpy(), want):
                raise AssertionError(f"reference {path.name}: TickMetrics.{f} diverged from JAX")
        emit("reference", file=path.name, ticks=len(draws), equal_to_jax=True,
             ticks_per_s=len(draws) / secs)


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


def trace_on_card(torch, device, cfg) -> None:
    """The trace the native planner uploads equals ``materialize_trace``'s
    numpy arrays, and a tick's plan reads its row."""
    import numpy as np

    from repro_torch.core import workload as wl

    spec = cfg.workload
    want = wl.materialize_trace(spec, cfg.n_nodes)
    got = wl.trace_tensors(spec, cfg.n_nodes, device)
    for w, g in zip(want, got):
        if g.device.type != "cuda" or not np.array_equal(g.cpu().numpy(), w):
            raise AssertionError("trace: the trace on the card differs from materialize_trace")
    gen = torch.Generator(device=device)
    plan = wl.plan_tick(cfg, wl.init_plan_state(cfg, device), 7, gen)
    if not np.array_equal(plan.r_kids.cpu().numpy(), want[0][7]):
        raise AssertionError("trace: tick 7's plan does not read row 7")
    emit("trace_arrays", shape=list(want[0].shape), equal_to_numpy=True,
         reads=int((want[1] == wl.OP_READ).sum()), writes=int((want[1] == wl.OP_WRITE).sum()))


HEADLINE = ("read_miss_ratio", "hit_local_ratio", "hit_fog_ratio", "hit_queue_ratio",
            "sync_store_request_ratio", "wan_reduction_vs_baseline",
            "coherence_updates", "stale_read_ratio", "writes_gen", "writes_drained",
            "queue_dropped")


def engine_phase(torch, device, name, cfg, ticks, must_launch, per_tick=None,
                 profile_ticks=20):
    """The cell ``cfg`` for ``ticks`` ticks with the kernels and inline:
    equal series, each of ``must_launch`` launched (``per_tick``: exactly
    that many launches a tick), then its profile over ``profile_ticks``."""
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
    wrong = {k: (launches[k], n * ticks) for k, n in (per_tick or {}).items()
             if launches[k] != n * ticks}
    if wrong:
        raise AssertionError(f"{name}: launches (got, expected): {wrong}")
    summary = summarize(s_cuda)
    emit(name, n_nodes=cfg.n_nodes, ticks=ticks, fanout=cfg.workload.fanout,
         ticks_per_s_cuda=rate_cuda, ticks_per_s_inline=rate_inline,
         series_equal=True, launches=launches,
         summary={k: summary[k] for k in HEADLINE})
    emit("profile", cell=name, **tick_profile(torch, device, cfg, rate_cuda, profile_ticks))
    return launches, summary, s_cuda


# ---------------------------------------------------------------------------
# Phases 6e-6g: the two multi-rank engines on torch.distributed.
# ---------------------------------------------------------------------------

# The zipf_hot row of tests/conformance.py's SHARDED_CASES (that module
# imports JAX): |sharded - fused| bounds on the miss and stale ratios.
SHARDED_MISS_EPS, SHARDED_STALE_EPS = 0.12, 0.10
GROUP_TIMEOUT_S = 600.0
PROFILE_TICKS = 10   # a second, profiled run of each engine cell: device time per rank


def compute_mode() -> str:
    """The card's compute mode; a mode that admits one process at most makes
    several ranks on the card impossible, and the phases fail saying so."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    if mode in ("Exclusive_Process", "Prohibited"):
        raise AssertionError(f"compute mode {mode}: the card admits no second process, so "
                             f"{SHARD_WORLD} ranks cannot share it")
    return mode


def rank_figures(res, ticks: int, profiled) -> dict:
    """Rates and memory of ``res``; device busy ms a tick of each rank from
    the ``profiled`` run of the same cell, and the card's idle share: one
    minus the ranks' summed busy time over the unprofiled tick time."""
    tick_ms = 1e3 * max(res.host_s) / ticks
    busy = [None if b is None else 1e3 * b / PROFILE_TICKS for b in profiled.device_busy_s]
    measured = all(b is not None and b > 0 for b in busy)
    return dict(ticks_per_s=ticks / max(res.host_s),
                host_ms_per_tick=[1e3 * s / ticks for s in res.host_s],
                device_busy_ms_per_tick=busy if measured else "not measured",
                device_idle_share=1.0 - sum(busy) / tick_ms if measured else "not measured",
                peak_bytes=res.peak_bytes, launches=res.launches)


def multi_rank_runs(torch, dense_cfg, paths, ticks: int = 600):
    """Both engines on the dense cell (native draws, seed 0, the kernels) in
    two spawned groups: world 1 over NCCL, then world 4 over gloo (four
    processes on the one card), which also runs the 17 seed-0 JAX replays
    through the parity engine.  A group pays its spawn and set-up once.
    Returns ``({world: {engine: RunResult}}, [(path, run, expected, result)])``."""
    from repro_torch.core.distributed import EngineRun, run_group
    from repro_torch.core.replay import load_replay

    mode = compute_mode()
    cfg = dataclasses.replace(dense_cfg, probe_backend="cuda")
    cells = [EngineRun("distributed", cfg, ticks), EngineRun("sharded", cfg, ticks),
             EngineRun("distributed", cfg, PROFILE_TICKS, profile=True),
             EngineRun("sharded", cfg, PROFILE_TICKS, profile=True)]
    seed0 = [p for p in paths if not re.search(r"_s\d+\.npz$", p.name)]
    replays = []
    for path in seed0:
        rcfg, draws, expected = load_replay(path, "cpu")
        replays.append((path, EngineRun("distributed",
                                        dataclasses.replace(rcfg, probe_backend="cuda"),
                                        len(draws), draws=draws), expected))
    by_world, replay_results = {}, []
    for world, backend in ((1, "nccl"), (SHARD_WORLD, "gloo")):
        runs = cells + ([r for _, r, _ in replays] if world > 1 else [])
        t0 = time.perf_counter()
        res = run_group(runs, world=world, backend=backend, timeout=GROUP_TIMEOUT_S)
        emit("multi_rank_group", world=world, backend=backend, compute_mode=mode,
             runs=len(runs), wall_s=time.perf_counter() - t0,
             rank_host_s=[sum(r.host_s[k] for r in res) for k in range(world)])
        by_world[world] = {"distributed": res[0], "sharded": res[1],
                           "distributed_profile": res[2], "sharded_profile": res[3]}
        if world > 1:
            replay_results = [(p, r, e, x) for (p, r, e), x in zip(replays, res[4:])]
    return by_world, replay_results


def distributed_phase(torch, by_world, dense_cfg, fused_series, ticks: int = 600) -> None:
    """The parity engine's dense runs: each series bitwise equal to the fused
    dense run but for ``wire_bytes``, which must equal the ring model; every
    rank launches ``flic_update`` once a tick."""
    from repro_torch.core.distributed import parity_wire_bytes

    for world, runs in by_world.items():
        res = runs["distributed"]
        series_equal(torch, res.series, fused_series, f"distributed world {world}")
        wire = parity_wire_bytes(dense_cfg, world)
        if not bool((res.series.wire_bytes == wire).all()):
            raise AssertionError(f"distributed world {world}: wire_bytes is not {wire} a tick")
        wrong = [(r, k["flic_update"]) for r, k in enumerate(res.launches)
                 if k["flic_update"] != ticks]
        if wrong:
            raise AssertionError(f"distributed world {world}: flic_update launches {wrong}, "
                                 f"expected {ticks} on each rank")
        emit("distributed", world=world, ticks=ticks, series_equal_to_fused=True,
             wire_bytes_per_tick=wire,
             **rank_figures(res, ticks, runs["distributed_profile"]))


def distributed_replay_phase(torch, replay_results) -> None:
    """The 17 seed-0 JAX replays through the parity engine at world 4: each
    series bitwise equal to JAX's; each rank launches the kernels its
    config reaches (``flic_insert`` always, ``flic_update`` for a mutable
    workload under the directory policy)."""
    import numpy as np

    from repro_torch.core.metrics import EMBODIMENT_FIELDS

    if len(replay_results) != 17:
        raise AssertionError(f"expected 17 seed-0 replays, got {len(replay_results)}")
    for path, run, want, res in replay_results:
        for f, v in want.items():
            if f not in EMBODIMENT_FIELDS and not np.array_equal(
                    getattr(res.series, f).cpu().numpy(), v):
                raise AssertionError(f"distributed_replay {path.name}: TickMetrics.{f} "
                                     f"diverged from JAX")
        need = ["flic_insert"]
        if run.cfg.insert_policy == "directory" and run.cfg.workload.mutable:
            need.append("flic_update")
        missing = [(r, k) for r, launch in enumerate(res.launches) for k in need if not launch[k]]
        if missing:
            raise AssertionError(f"distributed_replay {path.name}: (rank, kernel) not "
                                 f"launched: {missing}")
        emit("distributed_replay", file=path.name, world=SHARD_WORLD, ticks=run.ticks,
             equal_to_jax=True, ticks_per_s=run.ticks / max(res.host_s),
             launches=res.launches[0])


def sharded_phase(torch, by_world, fused_series, ticks: int = 600) -> None:
    """The bandwidth-lean engine's dense runs, held to the ``zipf_hot``
    tolerance tier against the fused dense run: exact reads, writes_gen
    and churn_rejoins, write conservation, the eps; at world 4 its
    modelled wire bytes positive and at most half the parity engine's;
    every rank launches ``flic_update`` once a tick and ``flic_insert`` at
    least twice (its writes and its fills)."""
    from repro_torch.core.metrics import summarize

    fs = summarize(fused_series)
    parity_wire = summarize(by_world[SHARD_WORLD]["distributed"].series)["wire_bytes_per_tick"]
    for world, runs in by_world.items():
        res = runs["sharded"]
        ss = summarize(res.series)
        label = f"sharded world {world}"
        for field in ("ticks", "reads", "writes_gen", "churn_rejoins"):
            if ss[field] != fs[field]:
                raise AssertionError(f"{label}: {field} {ss[field]} != fused {fs[field]}")
        budget = (ss["writes_drained"] + ss["final_queue_depth"] + ss["queue_dropped"]
                  + ss["writes_coalesced"])
        if ss["writes_gen"] != budget:
            raise AssertionError(f"{label}: writes_gen {ss['writes_gen']} != {budget}")
        d_miss = abs(ss["read_miss_ratio"] - fs["read_miss_ratio"])
        d_stale = abs(ss["stale_read_ratio"] - fs["stale_read_ratio"])
        if d_miss > SHARDED_MISS_EPS or d_stale > SHARDED_STALE_EPS:
            raise AssertionError(f"{label}: miss delta {d_miss}, stale delta {d_stale} over "
                                 f"{SHARDED_MISS_EPS}, {SHARDED_STALE_EPS}")
        wire = ss["wire_bytes_per_tick"]
        if world > 1 and not 0 < wire <= 0.5 * parity_wire:
            raise AssertionError(f"{label}: wire bytes {wire} a tick, parity {parity_wire}")
        wrong = [(r, k["flic_update"], k["flic_insert"]) for r, k in enumerate(res.launches)
                 if k["flic_update"] != ticks or k["flic_insert"] < 2 * ticks]
        if wrong:
            raise AssertionError(f"{label}: (rank, flic_update, flic_insert) launches {wrong}")
        emit("sharded", world=world, ticks=ticks, wire_bytes_per_tick=wire,
             parity_wire_bytes_per_tick=parity_wire, miss_delta=d_miss, stale_delta=d_stale,
             summary={k: ss[k] for k in HEADLINE}, fused={k: fs[k] for k in HEADLINE},
             **rank_figures(res, ticks, runs["sharded_profile"]))


# ---------------------------------------------------------------------------
# Phases 7-10: Granite-8B and Granite-3-8B served through the paged_attention kernel.
# ---------------------------------------------------------------------------

# Serve cell: 4 distinct prompts of 512 tokens (whole pages, so prefix
# reuse is live), each submitted twice, 32 new tokens, 4 slots, page 16.
SERVE_PROMPTS, SERVE_PROMPT_LEN, SERVE_MAX_NEW = 4, 512, 32
SERVE_BATCH, SERVE_PAGE = 4, 16
SERVE_MAX_SEQ = SERVE_PROMPT_LEN + SERVE_MAX_NEW + SERVE_PAGE   # launch/serve.py's rule
GRANITE3_MAX_NEW = 16   # the Granite-3-8B serve: its 4 prompts only, 16 new tokens
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
              shadow=None, max_new=SERVE_MAX_NEW):
    """One run of the engine (``TeacherForcedEngine``, which records each
    step's logits) with the launch counts set to 0 just before it, each
    request ``max_new`` new tokens.  Times
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
        cfg, params, script=script, max_batch=SERVE_BATCH,
        max_seq=SERVE_PROMPT_LEN + max_new + SERVE_PAGE, page_size=SERVE_PAGE,
        kernel_backend=backend, device=device)
    for p in prompts:
        eng.submit(p, max_new=max_new)
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


def shadowed_run(torch, cfg, params, device, prompts, script, launches: int, label: str,
                 max_new=SERVE_MAX_NEW):
    """``serve_run`` teacher-forced on ``script`` with every kernel call held
    against the plain version on its inputs (``paged_verdict``): fails
    unless it makes ``launches`` calls, each within the plain version's
    tolerance.  Returns (engine, largest |kernel - plain|, calls)."""
    shadow = {"max_err": torch.zeros((), device=device),
              "excess": torch.full((), -float("inf"), device=device), "calls": 0}
    eng, _ = serve_run(torch, cfg, params, device, prompts, None, script=script, shadow=shadow,
                       max_new=max_new)
    if shadow["calls"] != launches or float(shadow["excess"]) > 0:
        raise AssertionError(f"{label}: a kernel call left the tolerance of the plain version "
                             f"(largest error {float(shadow['max_err'])}, "
                             f"{shadow['calls']} calls)")
    return eng, float(shadow["max_err"]), shadow["calls"]


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

    seng, shadow_err, shadow_calls = shadowed_run(torch, cfg, params, device, prompts, script,
                                                  launches, "serve")
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
         paged_calls_checked=shadow_calls, paged_max_abs_err=shadow_err,
         rerun_max_abs_diff=rerun_diff, tol=SERVE_TOL,
         plain_vs_contiguous_max_abs_diff=diff_plain_oracle, max_abs_logit=max_logit,
         kernel_vs_plain_max_abs_diff=diff_plain, kernel_vs_contiguous_max_abs_diff=diff_oracle,
         kernel_vs_contiguous_argmax_agree=f"{agree}/{n * SERVE_MAX_NEW}",
         one_ulp_sensitivity=nudge,
         peak_memory_bytes=peak, mgr_stats=keng.mgr.stats, profile=prof)
    return dict(launches=launches, attn_args=capture["attn_args"], max_abs_err=shadow_err)


def granite3_serve_phase(torch, device) -> dict:
    """Granite-3-8B at its published widths (random bfloat16 weights from
    ``torch.Generator`` seed 0): 4 prompts of 512 tokens at batch 4, each
    ``GRANITE3_MAX_NEW`` new tokens, page 16, through ``ServeEngine`` with
    the kernel (timed, counted), then again teacher-forced with every
    kernel call held against the plain version on its inputs."""
    from repro_torch.config import get_arch
    from repro_torch.models.model import init_model, model_param_defs
    from repro_torch.models.params import param_count

    cfg = get_arch("granite_3_8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts(cfg.vocab_size)[:SERVE_PROMPTS]
    keng, kinfo = serve_run(torch, cfg, params, device, prompts, None, max_new=GRANITE3_MAX_NEW)
    peak = torch.cuda.max_memory_allocated()
    steps = len(kinfo["decode_ms"])
    launches = kinfo["launches"]["paged_attention"]
    if launches != cfg.num_layers * steps or steps == 0:
        raise AssertionError(f"granite3 serve: paged_attention launched {launches} times in "
                             f"{steps} decode steps of {cfg.num_layers} layers")
    if len(keng.finished) != len(prompts) or any(
            len(r.tokens) != GRANITE3_MAX_NEW for r in keng.finished):
        raise AssertionError("granite3 serve: not every request finished with its tokens")
    script = {r.rid: r.tokens for r in keng.finished}
    _, shadow_err, shadow_calls = shadowed_run(torch, cfg, params, device, prompts, script,
                                               launches, "granite3 serve", GRANITE3_MAX_NEW)
    logits = torch.stack([torch.stack(v) for v in keng.logits.values()])
    if not bool(torch.isfinite(logits.float()).all()) or logits.shape[-1] != cfg.vocab_size:
        raise AssertionError(f"granite3 serve: logits of shape {tuple(logits.shape)}, "
                             "or not finite")
    gen_tokens = sum(len(r.tokens) for r in keng.finished)
    emit("serve_granite3", arch=cfg.name, params=param_count(model_param_defs(cfg)),
         init_s=init_s, requests=len(prompts), prompt_len=SERVE_PROMPT_LEN,
         max_new=GRANITE3_MAX_NEW, max_batch=SERVE_BATCH, page_size=SERVE_PAGE,
         decode_steps=steps, prefill_ms=kinfo["prefill_ms"],
         decode_ms_per_step_median=statistics.median(kinfo["decode_ms"]),
         wall_s=kinfo["wall_s"], generated_tokens=gen_tokens,
         decode_tokens_per_s=gen_tokens / (sum(kinfo["decode_ms"]) / 1e3),
         launches=kinfo["launches"], paged_calls_checked=shadow_calls,
         paged_max_abs_err=shadow_err, peak_memory_bytes=peak,
         mgr_stats=keng.mgr.stats)
    return dict(launches=launches, max_abs_err=shadow_err)


SERVE_FIXTURES = ("serve_granite8b_smoke.npz", "serve_granite3_smoke.npz")


def serve_replay_phase(torch, device) -> None:
    """The committed JAX fixtures (the Granite-8B and Granite-3-8B smoke
    configs, bfloat16) through the port with the kernel, teacher-forced,
    both cases of each."""
    from repro_torch.kernels import ops
    from repro_torch.serving.replay import compare_case, load_serve_replay, replay_case

    for fixture in SERVE_FIXTURES:
        path = ROOT / "src" / "repro_torch" / "testdata" / fixture
        cfg, params, cases = load_serve_replay(path, device)
        for name, case in cases.items():
            ops.reset_launches()
            res = compare_case(case, replay_case(cfg, params, case, device), REPLAY_TOL)
            torch.cuda.synchronize()
            res["launches"] = ops.LAUNCHES["paged_attention"]
            ok = (res["max_abs_diff"] <= REPLAY_TOL and res["argmax_equal_where_decided"]
                  and res["reused_equal"] and res["stats_equal"] and res["launches"] > 0)
            if not ok:
                raise AssertionError(f"serve replay {fixture} {name}: {res}")
            emit("serve_replay", fixture=fixture, arch=cfg.name, head_dim=cfg.resolved_head_dim,
                 case=name, tol=REPLAY_TOL, stats=case["stats"], **res)


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
    """Small random states at shapes beyond the served one: bfloat16 at
    D=256 (the wider mma instance), D=96 (12 chunks a row: no power of two)
    with G=5 (two head groups), D=40 (no multiple of 16: a ring row padded
    to a whole k-step of the mma), D=16 and page 8 (the smoke model's);
    float32 q over bfloat16 at D=80; float32 at D=64 with G=8 and page 32.
    Random lengths with a 0, page ids anywhere in the pool."""
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


def paged_random(torch, gen, b, hkv, g, d, page, max_pages, n_pool, qdt, kvdt, offset=0):
    """Random q and K/V pages (``offset`` bytes past a 16-byte boundary),
    the page table a permutation of the pool with the slots past each
    length 0, lengths 1, a full table, 0 and random."""
    dev = gen.device
    lengths = torch.randint(1, max_pages * page + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[-1] = 1, max_pages * page, 0
    table = torch.randperm(n_pool, generator=gen, device=dev)[: b * max_pages]
    table = table.to(torch.int32).reshape(b, max_pages)
    live = ((lengths.long() + page - 1) // page).clamp(min=1)
    live[lengths <= 0] = max_pages
    table[torch.arange(max_pages, device=dev)[None] >= live[:, None]] = 0
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev).to(qdt)
    kp, vp = (copy_at(torch, torch.randn((n_pool, page, hkv, d), generator=gen,
                                         device=dev).to(kvdt), offset) for _ in range(2))
    return [q, kp, vp, table, lengths]


# K/V rows that are not 16-byte multiples, pages off a 16-byte boundary:
# label -> (B, Hkv, G, D, page, max_pages, pool, q dtype, K/V dtype, offset).
BF, F = "bfloat16", "float32"
ROW_CASES = {
    "d12_bf16": (6, 8, 4, 12, 16, 35, 280, BF, BF, 0),
    "d12_f32": (6, 8, 4, 12, 16, 35, 280, F, F, 0),
    "d20_bf16": (6, 8, 4, 20, 16, 35, 280, BF, BF, 0),
    "d13_bf16": (6, 8, 4, 13, 16, 35, 280, BF, BF, 0),
    "d12_bf16_offset8": (6, 8, 4, 12, 16, 35, 280, BF, BF, 8),
    # the Granite-3 smoke model's attention (Hkv 2, G 2, D 12, page 8) over
    # the serve fixture's 8 page slots, which the split plan cuts in two
    "granite3_smoke_splits": (2, 2, 2, 12, 8, 8, 16, BF, BF, 0),
    # the padded instances of the other dtype pairs and k-steps
    "d128_bf16_offset8": (6, 8, 4, 128, 16, 35, 280, BF, BF, 8),
    "d256_bf16_offset8": (3, 2, 4, 256, 16, 40, 200, BF, BF, 8),
    "d12_qf32_kvbf16": (6, 8, 4, 12, 16, 35, 280, F, BF, 0),
    "d13_f32": (6, 8, 4, 13, 16, 35, 280, F, F, 0),
}


def paged_instance(torch, args) -> str:
    """The kernel instance ``ops.paged_attention`` launches for ``args``
    (``paged_attention_launch``'s rule): the dtype pair, the mma's k-steps
    (bfloat16 q over bfloat16 K/V), and ``wide`` (rows of whole 16-byte
    chunks, whole 16-value k-steps with the mma, copied in 16-byte chunks)
    or ``padded`` (zero-padded ring rows, any copy unit)."""
    from repro_torch.kernels import ops

    q, kp = args[0], args[1]
    d = q.shape[-1]
    kind = f"q{str(q.dtype)[6:]}_kv{str(kp.dtype)[6:]}"
    mma = q.dtype == kp.dtype == torch.bfloat16
    if mma:
        kind += f"_mma{8 if d <= 128 else 16}"
    wide = ops.paged_row_plan_for(*args) == 16 and (not mma or d % 16 == 0)
    return kind + ("_wide" if wide else "_padded")



def two_streams(torch, device, gen, cycles_per_ms, tries: int = 8) -> dict:
    """Two ``paged_attention`` calls with different split plans (B=4,
    Hkv=8, G=4, D=128, page 16, 1,024 and 2,048 page slots, so that their
    arrival counters have the same indices) enqueued on two streams with no
    synchronisation between them.  Each stream waits on one event recorded
    behind a 2 ms spin on the current stream, so both calls are released at
    the same instant and run at once (``overlap_ms``: the time both were in
    flight, from events on each stream; it must be > 0 in some try).  Each
    try draws new queries, so that partial states a call finds left in its
    scratch by an earlier try are not its own.  Each output must equal the
    same call run alone, bit for bit, in every try."""
    from repro_torch.kernels import ops

    calls = [paged_random(torch, gen, 4, 8, 4, 128, 16, m, 4 * m, torch.bfloat16, torch.bfloat16)
             for m in (1024, 2048)]
    plans = [ops.paged_split_plan(4, 8, a[3].shape[1], ops.sm_count(device)) for a in calls]
    here = torch.cuda.current_stream(device)
    streams = [torch.cuda.Stream(device) for _ in calls]
    differ, overlap = 0, []

    def event(stream):
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    for _ in range(tries):
        for a in calls:
            a[0] = torch.randn(a[0].shape, generator=gen, device=device).to(torch.bfloat16)
        alone = [ops.paged_attention(*a) for a in calls]
        torch.cuda._sleep(int(2 * cycles_per_ms))
        gate = event(here)
        outs, spans = [], []
        for st, a in zip(streams, calls):
            st.wait_event(gate)
            with torch.cuda.stream(st):
                t0 = event(st)
                outs.append(ops.paged_attention(*a))
                spans.append((t0, event(st)))
        torch.cuda.synchronize()
        ms = [(gate.elapsed_time(t0), gate.elapsed_time(t1)) for t0, t1 in spans]
        overlap.append(min(e for _, e in ms) - max(b for b, _ in ms))
        differ += sum(not torch.equal(o.view(torch.int16), w.view(torch.int16))
                      for o, w in zip(outs, alone))
    if max(overlap) <= 0:
        raise AssertionError(f"paged_attention two_streams: the calls never ran at once {overlap}")
    if differ:
        raise AssertionError(f"paged_attention two_streams: {differ} of {2 * tries} outputs "
                             "differ from the calls run alone")
    return dict(split_plans=plans, tries=tries, overlap_ms=overlap, outputs_differing=differ,
                bitwise_equal=True)


def paged_kernel_phase(torch, device, attn_args, cycles_per_ms) -> dict:
    """``paged_attention`` against its plain version: (a) the inputs of
    decode step ``CAPTURE_STEP``'s layer 0 in the serve run, (b) a long
    context, (c) edge cases, split cases, the kernel's other instances and a
    float32 long context; (d) K/V rows that are not 16-byte multiples and
    pages off a 16-byte boundary (``ROW_CASES``, timed; every instance of
    the kernel, wide and padded, must run); two calls on
    the same inputs give the same bits, also when two calls run at once on
    two streams; a page id outside the pool, in the first or in the last
    live page slot of sequence 0, gives NaN for sequence 0 alone."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)   # > the 50 MB L2

    def same_bits(args, label):
        a, b = ops.paged_attention(*args), ops.paged_attention(*args)
        if not torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32)):
            raise AssertionError(f"paged_attention {label}: two calls gave different bits")

    instances = {paged_instance(torch, attn_args)}
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
        res[label] = dict(max_abs_err=paged_check(torch, got, ref.paged_attention_ref(*args), args),
                          chunk=ops.paged_row_plan_for(*args), instance=paged_instance(torch, args))
        if label.startswith("splits"):   # timed: a split plan's boundaries on the 16-byte path
            res[label] = dict(res[label], **paged_case(torch, args, cycles_per_ms, flush, False))
        instances.add(res[label]["instance"])
    del cases
    torch.cuda.empty_cache()
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    for label, (b, hkv, g, d, page, max_pages, n_pool, qdt, kvdt, offset) in ROW_CASES.items():
        args = paged_random(torch, gen, b, hkv, g, d, page, max_pages, n_pool, dtypes[qdt],
                            dtypes[kvdt], offset)
        splits, per = ops.paged_split_plan(b, hkv, max_pages, ops.sm_count(device))
        res[label] = dict(paged_case(torch, args, cycles_per_ms, flush, False),
                          chunk=ops.paged_row_plan_for(*args), instance=paged_instance(torch, args),
                          offset=args[1].data_ptr() % 16, splits=splits, pages_per_split=per)
        instances.add(res[label]["instance"])
        same_bits(args, label)
    if res["granite3_smoke_splits"]["splits"] < 2:
        raise AssertionError("paged_attention: the Granite-3 smoke case did not split")
    want = {f"{k}_{c}" for k in ("qbfloat16_kvbfloat16_mma8", "qbfloat16_kvbfloat16_mma16",
                                 "qfloat32_kvbfloat16", "qfloat32_kvfloat32")
            for c in ("wide", "padded")}
    if instances != want:
        raise AssertionError(f"paged_attention: the cases reached {sorted(instances)}, "
                             f"not every instance {sorted(want)}")
    res["instances"] = sorted(instances)
    res["two_streams"] = two_streams(torch, device, gen, cycles_per_ms)
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
# Phases 11-12: flic_merge, replica catch-up on the dense cell's tables.
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


def profiled_ms(torch, fn, make_args, name: str, runs: int = TIMED_RUNS, tries: int = 3):
    """Mean device time of the CUDA kernels whose name holds ``name`` in
    ``runs`` calls of ``fn(*make_args())`` under ``torch.profiler``: the
    kernel's own time, without the launch and the events that ``time_ms``
    counts.  The profiler drops records at times, so a profile that kept
    fewer than half the runs' is taken again, up to ``tries`` times; "not
    measured" where none kept a record of such a kernel."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    mean = "not measured"
    for _ in range(tries):
        fn(*make_args())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn(*make_args())
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if e.device_type == cuda and name in e.key]
        count = sum(e.count for e in found)
        if count:
            mean = sum(e.self_device_time_total for e in found) / 1e3 / count
        if count >= runs // 2:
            break
    return mean


def merge_kernel_phase(torch, device, catch_up, cycles_per_ms) -> dict:
    """``flic_merge`` bitwise against its plain version and timed (the L2
    cache flushed before each run) with CUDA events (``ms``) and with the
    profiler (``profiled_ms``, the kernel alone): (a) the dense cell's
    catch-up, (b) ``benchmarks/kernels_bench.py``'s geometry, (c) random
    replicas with ties, lines invalid in both and invalid newer lines, at a
    set count no block size divides, (d) every instantiation
    (``ops.merge_plans``: W in {1, 2, 4, 8} with D = 8 on 16-byte aligned
    tables, and W = 3, D = 3 line by line) and ``w4_d8_offset4``, the
    catch-up's W and D on tables 4 bytes past a boundary (line by line)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)   # > the 50 MB L2
    cases = {"dense_catch_up_t300_t420": catch_up,
             "kernels_bench_s512_w4_d16": merge_random(torch, gen, 512, 4, 16),
             "random_s4099_w4_d8": merge_random(torch, gen, 4099, 4, 8)}
    for w in ops.TEMPLATE_WAYS:
        cases[f"w{w}_d8"] = merge_random(torch, gen, 4099, w, 8)
    cases["w3_d3"] = merge_random(torch, gen, 4099, 3, 3)
    cases["w4_d8_offset4"] = [copy_at(torch, t, 4) for t in merge_random(torch, gen, 4099, 4, 8)]
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
                          plan=ops.merge_plan_for(*args)._asdict(),
                          ms=time_ms(torch, ops.flic_merge, fresh, cycles_per_ms),
                          profiled_ms=profiled_ms(torch, ops.flic_merge, fresh, "flic_merge"),
                          plain_ms=time_ms(torch, ref.flic_merge_ref, fresh, cycles_per_ms),
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n,
                          library_ms=None)
    reached = {tuple(v["plan"].values()) for v in res.values()}
    missing = [p for p in ops.merge_plans() if tuple(p) not in reached]
    if missing or res["w4_d8_offset4"]["plan"]["vec"]:
        raise AssertionError(f"flic_merge: no case reached the instantiations {missing}, or "
                             "the offset tables took the 16-byte path")
    return res


# ---------------------------------------------------------------------------
# Phases 13-15: Mamba2-370M through the ssd_scan kernel.
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
    """``params`` with ``a_log`` and ``dt_bias`` of every layer of every
    SSM block (each group, each block with an SSM mixer, in order) drawn as
    Mamba2 draws them (arXiv 2405.21060; the reference ``Mamba2`` module):
    A uniform in [1, 16], ``a_log = log A``; dt log-uniform in [1e-3, 1e-1]
    (floor 1e-4), ``dt_bias`` its inverse softplus.  The port's init, like
    JAX's, sets ``a_log`` to 1 and ``dt_bias`` to 0, which makes every
    chunk decay of a 256-token chunk 0 in float32.  The other leaves are
    shared with ``params``."""
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    dec = {}
    for g, blocks in params["dec"].items():
        dec[g] = dict(blocks)
        for name, blk in blocks.items():
            mixer = blk["mixer"]
            if "a_log" not in mixer:
                continue
            shape, dev = mixer["a_log"].shape, mixer["a_log"].device
            a = 1.0 + 15.0 * torch.rand(shape, generator=gen)
            dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen)).clamp(min=1e-4)
            dec[g][name] = dict(blk, mixer=dict(
                mixer, a_log=torch.log(a).to(dev),
                dt_bias=(dt + torch.log(-torch.expm1(-dt))).to(dev)))
    return dict(params, dec=dec)


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
    published_args = pshadow["args"]
    pdecay = published_args[1]
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
    return dict(launches=launches["ssd_scan"], scan_args=shadow["args"],
                published_args=published_args)


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
    return {label: scan_case(torch, label, args, cycles_per_ms, flush)
            for label, args in cases.items()}


def scan_case(torch, label: str, args, cycles_per_ms, flush) -> dict:
    """``ssd_scan`` on ``args`` bitwise against its plain version, both
    timed with ``flush`` zeroed before each run, and bound."""
    from repro_torch.kernels import ops, ref

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
    return dict(info, zero_decay_share=float((args[1] == 0).float().mean()),
                max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
                ms=time_ms(torch, ops.ssd_scan, fresh, cycles_per_ms),
                plain_ms=time_ms(torch, ref.ssd_scan_ref, fresh, cycles_per_ms),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n, library_ms=None)


TRAIN_ARCH = "mamba2_370m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
TRAIN_LR = dict(peak_lr=1e-3, warmup_steps=1)   # launch/train.py's warm-up rule for 8 steps
DENSE_ARCH, DENSE_LAYERS, DENSE_STEPS = "granite_8b", 4, 4
DENSE_CKPT_EVERY, DENSE_FAULT_AT = 2, 3   # the fault restores step 2's checkpoint
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"


def _finite(x) -> bool:
    return x == x and abs(x) != float("inf")


def plain_scan_with_grad(torch):
    """The chunk scan through the plain versions in both directions
    (``ref.ssd_scan_ref`` forward, ``ref.ssd_scan_bwd_ref`` backward), the
    counterpart of ``ops.SSDScan`` for a kernel-against-plain step."""
    from repro_torch.kernels import ref

    class PlainSSDScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, states, decay, init):
            prev, final = ref.ssd_scan_ref(states, decay, init)
            ctx.save_for_backward(prev, decay)
            ctx.with_init = init is not None
            return prev, final

        @staticmethod
        def backward(ctx, g_prev, g_final):
            prev, decay = ctx.saved_tensors
            return ref.ssd_scan_bwd_ref(g_prev.contiguous(), g_final.contiguous(), prev, decay,
                                        ctx.with_init)

    def scan(states, decay, init=None):
        return PlainSSDScan.apply(states, decay, init)

    return scan


def tapped_scan(torch, record: dict):
    """``ops.ssd_scan`` that records the first call's forward inputs and
    output (layer 0's, before any recomputation) and the gradients that
    reach its outputs in the backward pass: the inputs of that layer's
    ``ssd_scan_bwd`` launch."""
    from repro_torch.kernels import ops

    class Tap(torch.autograd.Function):
        @staticmethod
        def forward(ctx, prev, final):
            return prev.clone(), final.clone()

        @staticmethod
        def backward(ctx, g_prev, g_final):
            record["g_prev"] = g_prev.detach().contiguous().clone()
            record["g_final"] = g_final.detach().contiguous().clone()
            return g_prev, g_final

    def scan(states, decay, init=None):
        prev, final = ops.ssd_scan(states, decay, init)
        if "prev" not in record:
            record.update(prev=prev.detach().clone(), decay=decay.detach().clone(),
                          with_init=init is not None)
            prev, final = Tap.apply(prev, final)
        return prev, final

    return scan


def train_batch(torch, cfg, step: int, device):
    """``synthetic_batch`` of ``step`` (seed 0), as ``Trainer`` draws it."""
    from repro_torch.data.pipeline import batch_to_device, synthetic_batch

    return batch_to_device(synthetic_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, step), device)


def train_phase(torch, device) -> dict:
    """The slice: Mamba2-370M at full width and depth (random weights from
    seed 0), ``synthetic_batch`` at 4 x 2,048 tokens (8 chunks), remat on,
    8 steps through the port's ``Trainer`` with one checkpoint save (its
    last step).  First, one step's gradient with the kernels against the
    same step with the plain scan and its plain backward, from the same
    weights: the loss bitwise equal, each leaf's largest gradient
    difference printed; the backward kernel's layer-0 inputs are captured
    there.  Then the ``ssd_scan``/``ssd_scan_bwd`` launches a step must
    equal the count the config predicts (the forward twice a layer under
    remat, the backward once), the loss must fall and stay finite; step
    ms, tokens/s, peak memory, the checkpoint's save, and a profiled step
    with its idle share."""
    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_model, model_param_defs
    from repro_torch.models.params import param_count
    from repro_torch.train import Trainer, TrainerConfig, TrainHyper, make_train_step
    from repro_torch.train.train_step import grads_of
    from repro_torch.utils.trees import tree_flatten_with_paths

    cfg = get_arch(TRAIN_ARCH)
    hyper = TrainHyper(total_steps=TRAIN_STEPS, **TRAIN_LR)
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    b0 = train_batch(torch, cfg, 0, device)

    record: dict = {}
    t0 = time.perf_counter()
    loss_k, _, grads_k = grads_of(params, cfg, b0, hyper, tapped_scan(torch, record))
    torch.cuda.synchronize()
    first_grad_s = time.perf_counter() - t0
    loss_p, _, grads_p = grads_of(params, cfg, b0, hyper, plain_scan_with_grad(torch))
    if not torch.equal(loss_k, loss_p):
        raise AssertionError(f"train: the kernel step's loss {float(loss_k)} differs from the "
                             f"plain step's {float(loss_p)}")
    plain_g = dict(tree_flatten_with_paths(grads_p))
    grad_diff = {k: float((g.float() - plain_g[k].float()).abs().max())
                 for k, g in tree_flatten_with_paths(grads_k)}
    if not all(map(_finite, grad_diff.values())):
        raise AssertionError(f"train: gradient differences are not finite: {grad_diff}")
    del grads_k, grads_p, plain_g
    if "g_prev" not in record:
        raise AssertionError("train: layer 0's scan gradient was not captured")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    tcfg = TrainerConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                         ckpt_dir=str(CKPT_DIR / "train"), ckpt_every=TRAIN_STEPS, hyper=hyper)
    trainer = Trainer(cfg, tcfg, device=device, params=params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = trainer.run()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {"ssd_scan": 2 * cfg.num_layers * TRAIN_STEPS, "ssd_scan_bwd": cfg.num_layers * TRAIN_STEPS}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"train: expected launches {want} in {TRAIN_STEPS} steps "
                             f"(remat: the forward twice a layer), got {launches}")
    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(map(_finite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    step_ms = [1e3 * h["step_time_s"] for h in hist]
    med = statistics.median(step_ms)
    step_fn = make_train_step(cfg, hyper)
    b = train_batch(torch, cfg, TRAIN_STEPS, device)
    prof = profile_calls(torch, lambda: step_fn(trainer.params, trainer.opt_state, b, TRAIN_STEPS),
                         1, med, "ssd_scan")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit("train", arch=cfg.name, params=param_count(model_param_defs(cfg)), batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, chunks=TRAIN_SEQ // cfg.ssm_chunk, steps=TRAIN_STEPS, remat=hyper.remat,
         remat_policy=hyper.remat_policy, launches=launches, launches_expected=want,
         launches_per_step={k: v / TRAIN_STEPS for k, v in want.items()},
         losses=losses, lr=[h["lr"] for h in hist], grad_norm=[h["grad_norm"] for h in hist],
         step_ms=step_ms, step_ms_median=med,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (med / 1e3), first_grad_s=first_grad_s,
         run_s=run_s, save_s_approx=run_s - sum(step_ms) / 1e3, peak_memory_bytes=peak,
         kernel_vs_plain_step=dict(loss_bitwise_equal=True, loss=float(loss_k),
                                   grad_max_abs_diff_by_leaf=grad_diff,
                                   grad_max_abs_diff=max(grad_diff.values())),
         profile_step=prof)
    return dict(launches=launches, captured=[record["g_prev"], record["g_final"], record["prev"],
                                             record["decay"], record["with_init"]])


def scan_bwd_work(g_prev, g_final, prev, decay, with_init) -> tuple[int, int, dict]:
    """Bytes: g_prev, prev, g_final and the decays read once, g_states,
    g_decay and g_init (where asked) written once; operations: an element's
    product and its share of the sum, and the carry's multiply and add."""
    b, c, h, p, n = g_prev.shape
    lanes = b * h * p * n
    nbytes = 4 * (3 * g_prev.numel() + decay.numel() * 2 + lanes * (2 if with_init else 1))
    return nbytes, 4 * g_prev.numel(), dict(B=b, C=c, H=h, P=p, N=n, init=with_init)


def scan_bwd_kernel_phase(torch, device, captured, published, cycles_per_ms) -> dict:
    """``ssd_scan_bwd`` against ``ref.ssd_scan_bwd_ref``: ``g_states`` and
    ``g_init`` bitwise, ``g_decay`` within ``ref.ssd_scan_bwd_decay_tol``,
    two calls bitwise equal; timed (L2 flushed) and bound, on (a) the
    layer-0 inputs captured from the train step (all decays 0 under the JAX
    init law), (b) layer 0 of the ``ssm`` phase's prefill with Mamba2's
    published ``a_log``/``dt_bias`` draws (non-zero decays, with its
    forward's prev), (c) 128 chunks with decays in [0.95, 1)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    def with_grads(states, decay, init):
        prev, final = ops.ssd_scan(states, decay, init)
        return [torch.randn(states.shape, generator=gen, device=device),
                torch.randn(final.shape, generator=gen, device=device), prev, decay,
                init is not None]

    states, decay, init = published
    cases = {
        "train_step_layer0": captured,
        "published_init_layer0": with_grads(states, decay, init),
        "long_context_b1_c128": with_grads(*scan_random(torch, gen, 1, 128, 32, 64, 128,
                                                        0.95, 1.0, False)),
    }
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    res = {}
    for label, args in cases.items():
        got = ops.ssd_scan_bwd(*args)
        again = ops.ssd_scan_bwd(*args)
        torch.cuda.synchronize()
        want = ref.ssd_scan_bwd_ref(*args)
        if not torch.equal(got[0], want[0]) or (args[4] and not torch.equal(got[2], want[2])):
            raise AssertionError(f"ssd_scan_bwd {label}: g_states or g_init differs from the "
                                 "plain version")
        if not all(torch.equal(x, y) for x, y in zip(got, again) if x is not None):
            raise AssertionError(f"ssd_scan_bwd {label}: two calls differ")
        tol = ref.ssd_scan_bwd_decay_tol(want[0], args[2])
        err = (got[1] - want[1]).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"ssd_scan_bwd {label}: g_decay off by {float(err.max())}, "
                                 f"past the tolerance")

        def fresh():
            flush.zero_()
            return args

        nbytes, ops_n, info = scan_bwd_work(*args)
        b_ms, b_by = bound(nbytes, ops_n)
        res[label] = dict(info, zero_decay_share=float((args[3] == 0).float().mean()),
                          g_states_g_init_bitwise=True, g_decay_max_abs_err=float(err.max()),
                          g_decay_err_over_tol=float((err / tol).max()),
                          max_abs_err=float(err.max()),
                          ms=time_ms(torch, ops.ssd_scan_bwd, fresh, cycles_per_ms),
                          plain_ms=time_ms(torch, ref.ssd_scan_bwd_ref, fresh, cycles_per_ms),
                          bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops_n,
                          library_ms=None)
        del got, again, want
    return res


def train_dense_phase(torch, device) -> dict:
    """Granite-8B at full width with depth cut to 4 layers, 4 x 2,048
    tokens (the flash-attention path), remat on: 4 steps of
    ``make_train_step`` (loss, step ms, peak memory, a profiled step), then
    the same 4 steps through ``Trainer`` with a checkpoint every 2 steps
    and a fault injected at step 3, recovered from step 2's checkpoint;
    the params at the end against the uninterrupted run's."""
    from repro_torch.config import get_arch
    from repro_torch.models.model import init_model, model_param_defs
    from repro_torch.models.params import param_count
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, TrainerConfig, TrainHyper, make_train_step
    from repro_torch.train.trainer import inject_fault_at
    from repro_torch.utils.trees import tree_flatten_with_paths

    cfg = dataclasses.replace(get_arch(DENSE_ARCH), num_layers=DENSE_LAYERS)
    hyper = TrainHyper(total_steps=DENSE_STEPS, **TRAIN_LR)
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    step_fn = make_train_step(cfg, hyper)
    batches = [train_batch(torch, cfg, i, device) for i in range(DENSE_STEPS)]
    step_fn(params, adamw_init(params), batches[0], 0)        # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, o, losses, step_ms = params, adamw_init(params), [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, b, i)
        losses.append(float(m["loss"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_ms)
    if not all(map(_finite, losses)):
        raise AssertionError(f"train_dense: losses not finite: {losses}")
    prof = profile_calls(torch, lambda: step_fn(p, o, batches[0], 0), 1, med, "gemm")
    del o
    torch.cuda.empty_cache()

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    tcfg = TrainerConfig(steps=DENSE_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                         ckpt_dir=str(CKPT_DIR / "dense"), ckpt_every=DENSE_CKPT_EVERY,
                         hyper=hyper)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, fault_hook=inject_fault_at({DENSE_FAULT_AT}), device=device,
                      params=params)
    hist = trainer.run()
    fault_run_s = time.perf_counter() - t0
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    seen = [h["step"] for h in hist]
    if trainer.step != DENSE_STEPS or seen.count(DENSE_CKPT_EVERY) != 2:
        raise AssertionError(f"train_dense: the fault run saw steps {seen}")
    ref_p = dict(tree_flatten_with_paths(p))
    diff = {k: float((v.float() - ref_p[k].float()).abs().max())
            for k, v in tree_flatten_with_paths(trainer.params)}
    emit("train_dense", arch=cfg.name, layers=DENSE_LAYERS,
         reduced=[f"num_layers {get_arch(DENSE_ARCH).num_layers} -> {DENSE_LAYERS}"],
         params=param_count(model_param_defs(cfg)), batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=DENSE_STEPS, remat=hyper.remat, losses=losses, step_ms=step_ms,
         step_ms_median=med, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (med / 1e3),
         peak_memory_bytes=peak, profile_step=prof,
         fault=dict(at_step=DENSE_FAULT_AT, ckpt_every=DENSE_CKPT_EVERY, steps_seen=seen,
                    run_s=fault_run_s, losses=[h["loss"] for h in hist],
                    params_max_abs_diff_vs_uninterrupted=max(diff.values()),
                    params_equal=all(v == 0.0 for v in diff.values()),
                    leaves_differing=sorted(k for k, v in diff.items() if v)))
    return dict(params_equal=all(v == 0.0 for v in diff.values()))


def train_replay_phase(torch, device) -> None:
    """The committed JAX training fixtures (Granite-8B, Mamba2,
    DeepSeek-V2-Lite, Jamba and SeamlessM4T smoke configs, float32 and
    bfloat16; DeepSeek's with MLA, MoE and its load-balance loss in the
    gradient, Jamba's with SSM, MoE and attention blocks in one group,
    SeamlessM4T's through its encoder and cross-attention) through the
    port's train step with the kernels, held to the CPU tests' tolerances
    (``train_tol``); a stack with SSM blocks must launch ``ssd_scan`` twice
    (remat) and ``ssd_scan_bwd`` once an SSM layer for each gradient it
    takes."""
    from repro_torch.kernels import ops
    from repro_torch.models.replay import load_model_replay
    from repro_torch.models.stack import plan_groups
    from repro_torch.train.replay import (
        compare_train_case,
        replay_train_case,
        train_case_ok,
        train_tol,
    )

    for arch in ("granite_8b", "mamba2_370m", "deepseek_v2_lite_16b", "jamba_1_5_large_398b",
                 "seamless_m4t_medium"):
        path = ROOT / "src" / "repro_torch" / "testdata" / f"train_{arch}_smoke.npz"
        cfg, tree, cases = load_model_replay(path)
        ssm_layers = sum(g.steps for g in plan_groups(cfg)[1] for bd in g.blocks
                         if bd.mixer == "ssm")
        for dtype, case in sorted(cases.items()):
            ops.reset_launches()
            res = compare_train_case(case, replay_train_case(cfg, tree, dtype, case, device))
            torch.cuda.synchronize()
            res["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
            grads = 1 + len(case["loss"])     # step 0's gradient, then every step
            want = ({} if not ssm_layers else
                    {"ssd_scan": 2 * ssm_layers * grads, "ssd_scan_bwd": ssm_layers * grads})
            tol = train_tol(cfg.family, dtype)
            if not train_case_ok(res, tol) or res["launches"] != want:
                raise AssertionError(f"train replay {arch} {dtype}: {res}, launches expected {want}")
            emit("train_replay", arch=arch, case=dtype, tol=tol, **res)


MOE_ARCH = "deepseek_v2_lite_16b"
MOE_PARAMS = 15_706_484_224      # JAX's param_count of the config
MOE_BATCH, MOE_PROMPT_LEN, MOE_DECODE_STEPS = 4, 512, 32
# moe_forward (bfloat16) against the direct float32 reference at layer 1:
# the largest |difference| over the reference's largest |value|, at most 8
# bfloat16 steps (2^-8 each): the path rounds the expert products, the
# SwiGLU, the gated contributions, their k adds and the shared experts to
# bfloat16.  A lost or misrouted (token, expert) pair moves its token by a
# whole gated expert output.
MOE_DISPATCH_TOL = 8 * 2.0 ** -8


def greedy_generate(torch, cfg, params, prefill_caches, first_tok, prompt_len: int,
                    steps: int = MOE_DECODE_STEPS) -> dict:
    """``greedy_steps`` on the prefill caches, their K/V or latent rows
    zero-padded to the prompt plus the steps (new tensors: the prefill
    caches stay as they are; SSM states come back new from every step)."""
    from repro_torch.models.replay import pad_caches

    return greedy_steps(torch, cfg, params, pad_caches(prefill_caches, prompt_len + steps),
                        first_tok, prompt_len, steps)


def greedy_steps(torch, cfg, params, caches, first_tok, prompt_len: int, steps: int) -> dict:
    """``steps`` greedy ``decode_step``s from ``first_tok`` at position
    ``prompt_len`` on ``caches`` (K/V and latent rows written in place),
    each step timed on the host clock between synchronisations.  ``last``:
    the last step's inputs; ``caches``: the caches after the last step."""
    from repro_torch.models.model import decode_step

    tok = first_tok
    pos = torch.full((tok.shape[0],), prompt_len, dtype=torch.int32, device=tok.device)
    gen, step_logits, decode_ms = [tok], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = (tok, pos, caches)
        out, caches = decode_step(params, cfg, tok, pos, caches)
        tok = out[:, 0].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t0))
        step_logits.append(out[:, 0])
        gen.append(tok)
        pos = pos + 1
    return dict(tokens=torch.cat(gen, dim=1), logits=torch.stack(step_logits),
                decode_ms=decode_ms, last=last, caches=caches)


def recording_moe(torch, record: dict):
    """A ``moe_forward`` that records, per MoE layer in call order, the
    (token, expert) pairs dropped at capacity, and the first layer's
    parameters, input and output."""
    from repro_torch.models import moe as moe_mod

    plain = moe_mod.moe_forward

    def moe_forward(p, cfg, x):
        y, aux = plain(p, cfg, x)
        keep = moe_mod.moe_plan(p, cfg, x)[3][0]
        record["dropped"].append(int((~keep).sum()))
        if "first" not in record:
            record["first"] = (p, x.detach().clone(), y.detach().clone())
        return y, aux

    return moe_forward


def moe_reference(torch, p, cfg, x):
    """``moe_forward``'s function computed directly, in float32: for each
    kept (token, expert) pair of the dispatch plan, ``gate * (silu(x W_g) *
    (x W_u)) W_d`` of that expert alone, summed per token, plus the shared
    experts.  Returns (y (B,S,D) float32, kept pairs)."""
    import torch.nn.functional as F

    from repro_torch.models import moe as moe_mod

    xg, cap, _, (keep, rows, sw, stok) = moe_mod.moe_plan(p, cfg, x)
    g, t, d = xg.shape
    y = torch.zeros((g, t, d), dtype=torch.float32, device=x.device)
    expert = torch.div(rows, cap, rounding_mode="floor")
    for e in range(cfg.moe_num_experts):
        gi, pi = (keep & (expert == e)).nonzero(as_tuple=True)
        tok = stok[gi, pi]
        xs = xg[gi, tok].float()
        h = F.silu(xs @ p["w_gate"][e].float()) * (xs @ p["w_up"][e].float())
        y.index_put_((gi, tok), sw[gi, pi][:, None] * (h @ p["w_down"][e].float()),
                     accumulate=True)
    y = y.reshape(x.shape)
    if "shared" in p:
        sp, xf = p["shared"], x.float()
        y = y + (F.silu(xf @ sp["w_gate"].float()) * (xf @ sp["w_up"].float())) @ sp["w_down"].float()
    return y, int(keep.sum())


def recorded_dispatch(torch, params, cfg, batch, logits, moe_layers: int, label: str):
    """One more prefill of ``batch`` with ``moe_forward`` recorded
    (``recording_moe``): it must give ``logits`` and call ``moe_layers``
    MoE layers.  Returns (the pairs dropped at capacity per MoE layer, the
    first MoE layer's ``moe_forward`` against ``moe_reference``), failing
    unless every pair is kept or dropped and the error is within
    ``MOE_DISPATCH_TOL`` of the reference's largest value."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import prefill

    record = {"dropped": []}
    plain = moe_mod.moe_forward
    moe_mod.moe_forward = recording_moe(torch, record)
    try:
        rlogits, _ = prefill(params, cfg, batch)
    finally:
        moe_mod.moe_forward = plain
    if not torch.equal(rlogits, logits) or len(record["dropped"]) != moe_layers:
        raise AssertionError(f"{label}: the recorded prefill ran {len(record['dropped'])} MoE "
                             "layers or gave other logits")
    p1, x1, y1 = record.pop("first")
    want, kept = moe_reference(torch, p1, cfg, x1)
    scale = float(want.abs().max())
    err = float((y1.float() - want).abs().max())
    pairs = batch["tokens"].numel() * cfg.moe_top_k
    dispatch = dict(layer=1, max_abs_err=err, max_abs_ref=scale, rel_err=err / scale,
                    tol_rel=MOE_DISPATCH_TOL,
                    mean_abs_err=float((y1.float() - want).abs().mean()),
                    pairs=pairs, kept=kept, dropped=record["dropped"][0])
    if kept + record["dropped"][0] != pairs or not err <= MOE_DISPATCH_TOL * scale:
        raise AssertionError(f"{label}: layer 1's moe_forward against the direct reference: "
                             f"{dispatch}")
    return record["dropped"], dispatch


def moe_phase(torch, device) -> dict:
    """The fifth main path: DeepSeek-V2-Lite-16B at full width (27 layers:
    MLA, a dense first FFN, 26 MoE layers of 64 routed experts top-6 and 2
    shared), random bfloat16 weights from ``torch.Generator`` seed 0 (the
    router float32), 4 prompts of 512 seeded tokens prefilled at batch 4,
    then 32 greedy ``decode_step``s against contiguous latent caches.
    Again the same decode (the same tokens, or it fails).  One more
    prefill records the pairs dropped at capacity per MoE layer and holds
    layer 1's ``moe_forward`` against ``moe_reference`` within
    ``MOE_DISPATCH_TOL``.  Times, profiles, peak memory, and decode step 1
    against a prefill of the prompt and its first token, with the
    configured capacity and with one no expert fills (printed)."""
    import numpy as np

    from repro_torch.config import get_arch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import decode_step, init_model, model_param_defs, prefill
    from repro_torch.models.params import param_count

    cfg = get_arch(MOE_ARCH)
    n_params = param_count(model_param_defs(cfg))
    if n_params != MOE_PARAMS:
        raise AssertionError(f"moe: {n_params} parameters, JAX counts {MOE_PARAMS}")
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT_LEN))
                              .astype(np.int32)).to(device)
    batch = {"tokens": tokens}

    prefill(params, cfg, batch)                     # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    run = greedy_generate(torch, cfg, params, caches, first, MOE_PROMPT_LEN)
    peak = torch.cuda.max_memory_allocated()
    again = greedy_generate(torch, cfg, params, caches, first, MOE_PROMPT_LEN)
    if not bool(torch.isfinite(logits).all() & torch.isfinite(run["logits"]).all()):
        raise AssertionError("moe: logits are not finite")
    if not torch.equal(run["tokens"], again["tokens"]):
        raise AssertionError("moe: a second decode run gave other tokens")
    spec = (cfg.num_layers, MOE_BATCH, MOE_PROMPT_LEN, cfg.kv_lora_rank + cfg.rope_head_dim)
    got = (sum(c["blk0"]["latent"].shape[0] for c in caches), *caches[0]["blk0"]["latent"].shape[1:])
    if got != spec:
        raise AssertionError(f"moe: latent caches {got}, expected {spec}")

    dropped, dispatch = recorded_dispatch(torch, params, cfg, batch, logits, cfg.num_layers - 1,
                                          "moe")

    # decode step 1 against a prefill of the prompt and its first token, as
    # configured (the prefill drops pairs at capacity, decode at 4 tokens
    # never does) and with a capacity no expert can fill (2E/K: cap >= S)
    longer = {"tokens": torch.cat([tokens, first], dim=1)}
    step1 = run["logits"][0]
    gap = {}
    for name, c in (("as_configured", cfg), ("no_drops", dataclasses.replace(
            cfg, moe_capacity_factor=2 * cfg.moe_num_experts / cfg.moe_top_k))):
        cont = prefill(params, c, longer)[0][:, -1]
        gap[name] = dict(step=1, max_abs_diff=float((step1 - cont).abs().max()),
                         argmax_equal=f"{int((step1.argmax(-1) == cont.argmax(-1)).sum())}"
                                      f"/{MOE_BATCH}")
        del cont

    tok, pos, dcaches = run["last"]
    decode_med = statistics.median(run["decode_ms"])
    prof_decode = profile_calls(torch, lambda: decode_step(params, cfg, tok, pos, dcaches), 3,
                                decode_med, "gemm")
    prof_prefill = profile_calls(torch, lambda: prefill(params, cfg, batch), 1, prefill_ms,
                                 "gemm")
    emit("moe", arch=cfg.name, params=n_params, init_s=init_s, batch=MOE_BATCH,
         prompt_len=MOE_PROMPT_LEN, decode_steps=MOE_DECODE_STEPS,
         experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
         capacity_prefill=moe_mod._capacity(cfg, MOE_PROMPT_LEN),
         capacity_decode=moe_mod._capacity(cfg, MOE_BATCH),
         prefill_ms=prefill_ms,
         prefill_tokens_per_s=MOE_BATCH * MOE_PROMPT_LEN / (prefill_ms / 1e3),
         decode_ms_per_step=run["decode_ms"], decode_ms_per_step_median=decode_med,
         decode_tokens_per_s=MOE_BATCH / (decode_med / 1e3),
         decode_repeat_tokens_equal=True, dropped_by_moe_layer=dropped,
         dispatch_check=dispatch, decode_vs_prefill=gap,
         max_abs_logit=float(run["logits"].abs().max()), peak_memory_bytes=peak,
         profile_decode_step=prof_decode, profile_prefill=prof_prefill,
         tokens_row0=run["tokens"][0].tolist())
    return dict(dispatch=dispatch)


# ---------------------------------------------------------------------------
# Phases 23-26: the hybrid family (one Jamba-1.5-Large period) and the VLM
# patch prefix (InternVL2-2B).
# ---------------------------------------------------------------------------

HYBRID_ARCH, HYBRID_LAYERS = "jamba_1_5_large_398b", 8    # one period (attn_period 8)
HYBRID_PARAMS = 45_144_659_968     # JAX's param_count of the config cut to one period
HYBRID_DISTINCT = 16_153_630_720   # held: the four MoE layers share one expert stack
HYBRID_EXPERTS = ("w_gate", "w_up", "w_down")
# Traffic: the ssm cell's (4 prompts of 2,048 seeded tokens, 8 chunks of
# 256), then 32 greedy decode steps.
HYBRID_BATCH, HYBRID_PROMPT_LEN, HYBRID_DECODE_STEPS = 4, 2048, 32
HYBRID_GAP_LEN = 1024   # decode against prefill at the longest full-attention prefill
VLM_ARCH = "internvl2_2b"
VLM_BATCH, VLM_TEXT_LEN, VLM_DECODE_STEPS = 4, 512, 32


def tied_expert_init(torch, cfg, seed: int, device):
    """Random weights of ``cfg`` (``init_params``' law, ``torch.Generator``
    seed ``seed``) with one expert stack for all MoE blocks: the first MoE
    block's ``w_gate``/``w_up``/``w_down`` are drawn and the other MoE
    blocks' are left out of the drawn tree, then alias them.  Every other
    leaf, the routers included, is drawn per block.  Returns (params, the
    MoE block names)."""
    from repro_torch.models.model import model_param_defs
    from repro_torch.models.params import init_params

    defs = model_param_defs(cfg)
    blocks = defs["dec"]["g0"]
    moe = [b for b, d in blocks.items() if "router" in d.get("ffn", {})]
    for b in moe[1:]:
        blocks[b]["ffn"] = {k: v for k, v in blocks[b]["ffn"].items() if k not in HYBRID_EXPERTS}
    params = init_params(defs, torch.Generator().manual_seed(seed), device)
    first = params["dec"]["g0"][moe[0]]["ffn"]
    for b in moe[1:]:
        params["dec"]["g0"][b]["ffn"].update({k: first[k] for k in HYBRID_EXPERTS})
    return params, moe


def distinct_params(params) -> int:
    """Elements held, each tensor counted once however often it is shared."""
    from repro_torch.utils.trees import tree_leaves

    seen = {t.data_ptr(): t.numel() for t in tree_leaves(params)}
    return sum(seen.values())


def hybrid_phase(torch, device, cycles_per_ms) -> dict:
    """The sixth main path: one whole Jamba-1.5-Large period at its
    published widths (8 layers: blocks 0-7 are Mamba2 mixers but block 4,
    GQA attention; dense MLPs at even blocks, MoE of 16 experts top-2 at
    odd ones), random bfloat16 weights from seed 0 with the four MoE layers
    sharing one expert stack (``tied_expert_init``) and Mamba2's published
    ``a_log``/``dt_bias`` draws in all 7 SSM layers.  4 prompts of 2,048
    seeded tokens prefilled at batch 4 (7 ``ssd_scan`` launches), then 32
    greedy ``decode_step``s on the mixed contiguous caches; again (the same
    tokens, or it fails).  A recorded prefill gives the pairs dropped per
    MoE layer and holds layer 1's ``moe_forward`` against
    ``moe_reference``; a checked prefill holds every ``ssd_scan`` call
    bitwise against its plain version.  Times, profiles, peak memory, a
    decode step against a prefill of the same 1,024 tokens (printed), and
    the layer-0 scan timed as an ``ssd_scan`` kernel case."""
    import numpy as np

    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import decode_step, model_param_defs, prefill
    from repro_torch.models.params import param_count

    cfg = dataclasses.replace(get_arch(HYBRID_ARCH), num_layers=HYBRID_LAYERS)
    n_params = param_count(model_param_defs(cfg))
    if n_params != HYBRID_PARAMS:
        raise AssertionError(f"hybrid: {n_params} parameters, JAX counts {HYBRID_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, moe_blocks = tied_expert_init(torch, cfg, 0, device)
    params = published_ssm_init(torch, params, torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    held = distinct_params(params)
    if held != HYBRID_DISTINCT:
        raise AssertionError(f"hybrid: {held} distinct parameters, expected {HYBRID_DISTINCT}")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT_LEN))
                              .astype(np.int32)).to(device)
    batch = {"tokens": tokens}

    prefill(params, cfg, batch)                     # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    run = greedy_generate(torch, cfg, params, caches, first, HYBRID_PROMPT_LEN,
                          HYBRID_DECODE_STEPS)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ssm_layers = HYBRID_LAYERS - 1
    if launches["ssd_scan"] != ssm_layers or sum(launches.values()) != ssm_layers:
        raise AssertionError(f"hybrid: expected {ssm_layers} ssd_scan launches in one prefill "
                             f"and {HYBRID_DECODE_STEPS} decode steps, got {launches}")
    again = greedy_generate(torch, cfg, params, caches, first, HYBRID_PROMPT_LEN,
                            HYBRID_DECODE_STEPS)
    if not bool(torch.isfinite(logits).all() & torch.isfinite(run["logits"]).all()):
        raise AssertionError("hybrid: logits are not finite")
    if not torch.equal(run["tokens"], again["tokens"]):
        raise AssertionError("hybrid: a second decode run gave other tokens")
    tree = {blk: sorted(c) for blk, c in caches[0].items()}
    attn_blk = f"blk{cfg.attn_period // 2}"
    want_tree = {f"blk{i}": ["conv", "ssd"] for i in range(HYBRID_LAYERS)}
    want_tree[attn_blk] = ["k", "v"]
    if tree != want_tree or caches[0][attn_blk]["k"].shape[2] != HYBRID_PROMPT_LEN:
        raise AssertionError(f"hybrid: cache tree {tree}, expected {want_tree}")
    del again

    # every scan call of one prefill against the plain version, bitwise
    scan, shadow = checked_scan(torch, "hybrid")
    slogits, _ = prefill(params, cfg, batch, ssd_scan=scan)
    if shadow["calls"] != ssm_layers or not torch.equal(slogits, logits):
        raise AssertionError(f"hybrid: the checked prefill made {shadow['calls']} scan calls "
                             "or gave other logits")
    zero_share = shadow["zero"]
    del slogits

    dropped, dispatch = recorded_dispatch(torch, params, cfg, batch, logits, len(moe_blocks),
                                          "hybrid")

    # a decode step against a prefill of the same tokens: the attention's
    # blocked (flash) path takes only whole blocks past 1,024 positions, so
    # on the prompt's first 1,023 tokens, fed token 1,024, against a
    # prefill of its first 1,024 (both on the full-attention path)
    short = HYBRID_GAP_LEN - 1
    _, scaches = prefill(params, cfg, {"tokens": tokens[:, :short]})
    step1 = greedy_generate(torch, cfg, params, scaches, tokens[:, short:short + 1], short,
                            1)["logits"][0]
    cont = prefill(params, cfg, {"tokens": tokens[:, :short + 1]})[0][:, -1]
    gap = dict(prompt_len=short, step=1, max_abs_diff=float((step1 - cont).abs().max()),
               argmax_equal=f"{int((step1.argmax(-1) == cont.argmax(-1)).sum())}/{HYBRID_BATCH}")
    del cont, scaches

    tok, pos, dcaches = run["last"]
    decode_med = statistics.median(run["decode_ms"])
    prof_decode = profile_calls(torch, lambda: decode_step(params, cfg, tok, pos, dcaches), 3,
                                decode_med, "gemm")
    prof_prefill = profile_calls(torch, lambda: prefill(params, cfg, batch), 1, prefill_ms,
                                 "ssd_scan")
    del dcaches, caches

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    layer0 = scan_case(torch, "jamba_prefill_layer0", shadow.pop("args"), cycles_per_ms, flush)
    del flush

    emit("hybrid", arch=cfg.name, layers=HYBRID_LAYERS,
         reduced=[f"num_layers {get_arch(HYBRID_ARCH).num_layers} -> {HYBRID_LAYERS} "
                  "(one period)", f"expert stacks: the {len(moe_blocks)} MoE layers share one"],
         params=n_params, params_held=held, init_s=init_s, init_peak_memory_bytes=init_peak,
         batch=HYBRID_BATCH, prompt_len=HYBRID_PROMPT_LEN, chunk=cfg.ssm_chunk,
         ssm_heads=cfg.ssm_nheads, decode_steps=HYBRID_DECODE_STEPS, launches=launches,
         experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
         capacity_prefill=moe_mod._capacity(cfg, HYBRID_PROMPT_LEN),
         capacity_decode=moe_mod._capacity(cfg, HYBRID_BATCH),
         prefill_ms=prefill_ms,
         prefill_tokens_per_s=HYBRID_BATCH * HYBRID_PROMPT_LEN / (prefill_ms / 1e3),
         decode_ms_per_step=run["decode_ms"], decode_ms_per_step_median=decode_med,
         decode_tokens_per_s=HYBRID_BATCH / (decode_med / 1e3),
         decode_repeat_tokens_equal=True, cache_tree=tree,
         scan_calls_checked=ssm_layers, scan_bitwise_equal_to_plain=True,
         zero_decay_share_by_layer=zero_share,
         dropped_by_moe_layer=dropped, dispatch_check=dispatch, decode_vs_prefill=gap, max_abs_logit=float(run["logits"].abs().max()),
         peak_memory_bytes=peak, profile_decode_step=prof_decode,
         profile_prefill=prof_prefill, tokens_row0=run["tokens"][0].tolist())
    emit("kernels", kernel="ssd_scan", spin_cycles_per_ms=cycles_per_ms,
         jamba_prefill_layer0=layer0)
    return dict(launches=launches["ssd_scan"], scan_case=layer0)


VLM_PARAMS = 1_889_146_880   # JAX's param_count of the config


def vlm_phase(torch, device, cycles_per_ms) -> dict:
    """The seventh main path: InternVL2-2B at full width (24 layers, random
    bfloat16 weights from seed 0) behind its patch prefix: 4 requests of
    256 seeded bfloat16 patch embeddings and 512 seeded tokens prefilled at
    batch 4 (768 positions), then 32 greedy ``decode_step``s from position
    768; again (the same tokens, or it fails).  Then the same 4 text
    prompts through ``ServeEngine`` with ``paged_attention`` (counted: once
    a layer and decode step), again with every kernel call held against
    the plain version (``paged_verdict``), and with the plain version
    against the contiguous-cache oracle within ``SERVE_TOL``, as the
    ``serve`` phase does; the kernel on the run's layer-0 inputs of decode
    step ``CAPTURE_STEP`` timed as a ``paged_attention`` case."""
    import numpy as np

    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import decode_step, init_model, model_param_defs, prefill
    from repro_torch.models.params import param_count

    cfg = get_arch(VLM_ARCH)
    n_params = param_count(model_param_defs(cfg))
    if n_params != VLM_PARAMS:
        raise AssertionError(f"vlm: {n_params} parameters, JAX counts {VLM_PARAMS}")
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (VLM_BATCH, VLM_TEXT_LEN))
                              .astype(np.int32)).to(device)
    patches = torch.from_numpy(rng.standard_normal(
        (VLM_BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32)).to(device, torch.bfloat16)
    batch = {"tokens": tokens, "patches": patches}
    length = cfg.frontend_seq + VLM_TEXT_LEN

    prefill(params, cfg, batch)                     # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    run = greedy_generate(torch, cfg, params, caches, first, length, VLM_DECODE_STEPS)
    contiguous_launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    again = greedy_generate(torch, cfg, params, caches, first, length, VLM_DECODE_STEPS)
    kv_len = caches[0]["blk0"]["k"].shape[2]
    if kv_len != length or sum(contiguous_launches.values()):
        raise AssertionError(f"vlm: K/V of {kv_len} positions after the prefill, expected "
                             f"{length}; launches {contiguous_launches}")
    if not bool(torch.isfinite(logits).all() & torch.isfinite(run["logits"]).all()):
        raise AssertionError("vlm: logits are not finite")
    if not torch.equal(run["tokens"], again["tokens"]):
        raise AssertionError("vlm: a second decode run gave other tokens")
    tok, pos, dcaches = run["last"]
    decode_med = statistics.median(run["decode_ms"])
    prof_decode = profile_calls(torch, lambda: decode_step(params, cfg, tok, pos, dcaches), 3,
                                decode_med, "gemm")
    prof_prefill = profile_calls(torch, lambda: prefill(params, cfg, batch), 1, prefill_ms,
                                 "gemm")
    del caches, dcaches, again

    # the text prompts through the paged engine, as the serve phase runs Granite
    prompts = [row.tolist() for row in tokens.cpu()]
    capture: dict = {}
    keng, kinfo = serve_run(torch, cfg, params, device, prompts, None, capture=capture)
    steps = len(kinfo["decode_ms"])
    launches = kinfo["launches"]["paged_attention"]
    if launches != cfg.num_layers * steps or steps == 0 or any(
            len(r.tokens) != SERVE_MAX_NEW for r in keng.finished):
        raise AssertionError(f"vlm paged: paged_attention launched {launches} times in "
                             f"{steps} decode steps of {cfg.num_layers} layers")
    by_rid = {r.rid: r for r in keng.finished}
    script = {r: by_rid[r].tokens for r in by_rid}
    _, shadow_err, shadow_calls = shadowed_run(torch, cfg, params, device, prompts, script,
                                               launches, "vlm paged")
    peng, _ = serve_run(torch, cfg, params, device, prompts, "plain", script=script)
    rids = sorted(by_rid)
    oracle = contiguous_oracle(torch, cfg, params, device, prompts,
                               [script[r] for r in rids]).float()

    def by_prompt(r):
        return oracle[rids.index(r)]

    diff_plain_oracle = logit_diff(torch, peng.logits, by_prompt, by_rid)
    if not diff_plain_oracle <= SERVE_TOL:
        raise AssertionError(f"vlm paged: the plain paged run differs from the contiguous oracle "
                             f"by {diff_plain_oracle} > {SERVE_TOL}")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    case = paged_case(torch, capture["attn_args"], cycles_per_ms, flush, True)
    emit("vlm", arch=cfg.name, params=n_params, init_s=init_s, batch=VLM_BATCH,
         patches=cfg.frontend_seq, text_len=VLM_TEXT_LEN, prefill_positions=length,
         decode_steps=VLM_DECODE_STEPS, prefill_ms=prefill_ms,
         prefill_tokens_per_s=VLM_BATCH * length / (prefill_ms / 1e3),
         decode_ms_per_step=run["decode_ms"], decode_ms_per_step_median=decode_med,
         decode_tokens_per_s=VLM_BATCH / (decode_med / 1e3), decode_repeat_tokens_equal=True,
         kv_len_after_prefill=kv_len, max_abs_logit=float(run["logits"].abs().max()),
         peak_memory_bytes=peak, profile_decode_step=prof_decode, profile_prefill=prof_prefill,
         paged=dict(requests=len(prompts), max_new=SERVE_MAX_NEW, page_size=SERVE_PAGE,
                    decode_steps=steps, launches=kinfo["launches"],
                    prefill_ms=kinfo["prefill_ms"],
                    decode_ms_per_step_median=statistics.median(kinfo["decode_ms"]),
                    paged_calls_checked=shadow_calls, paged_max_abs_err=shadow_err,
                    tol=SERVE_TOL,
                    plain_vs_contiguous_max_abs_diff=diff_plain_oracle,
                    kernel_vs_plain_max_abs_diff=logit_diff(torch, keng.logits, peng.logits,
                                                            by_rid),
                    mgr_stats=keng.mgr.stats),
         tokens_row0=run["tokens"][0].tolist())
    emit("kernels", kernel=PAGED, spin_cycles_per_ms=cycles_per_ms,
         internvl2_step20_layer0=case)
    return dict(launches=launches, max_abs_err=max(shadow_err, case["max_abs_err"]))


def model_replay_phase(torch, device, phase: str, files: dict) -> None:
    """Committed JAX model fixtures (``files``: name in
    ``src/repro_torch/testdata`` -> its tolerances, ``models.replay``'s
    ``MOE_TOL``, ``HYBRID_TOL`` or ``VLM_TOL``), float32 and bfloat16,
    through the port on the card with the kernels, teacher-forced, held to
    the CPU tests' tolerances; a stack with SSM blocks must launch
    ``ssd_scan`` once an SSM layer of the prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models.replay import (
        compare_model_case,
        load_model_replay,
        model_case_ok,
        replay_model_case,
    )
    from repro_torch.models.stack import plan_groups

    for name, tols in files.items():
        cfg, tree, cases = load_model_replay(ROOT / "src" / "repro_torch" / "testdata" / name)
        ssm_layers = sum(g.steps for g in plan_groups(cfg)[1] for bd in g.blocks
                         if bd.mixer == "ssm")
        for dtype, case in sorted(cases.items()):
            ops.reset_launches()
            res = compare_model_case(case, replay_model_case(cfg, tree, dtype, case, device),
                                     tols[dtype])
            torch.cuda.synchronize()
            res["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
            want = {"ssd_scan": ssm_layers} if ssm_layers else {}
            if not model_case_ok(res, tols[dtype]) or res["launches"] != want:
                raise AssertionError(f"{phase} {name} {dtype}: {res}, launches expected {want}")
            emit(phase, fixture=name, arch=cfg.name, case=dtype, tol=tols[dtype], **res)


ENCDEC_ARCH = "seamless_m4t_medium"
ENCDEC_PARAMS = 977_758_208   # JAX's param_count of the config
ENCDEC_BATCH, ENCDEC_PROMPT_LEN, ENCDEC_DECODE_STEPS = 4, 512, 32


def spec_caches(torch, cfg, prefill_caches, batch: int, seq: int, enc_seq: int = 0,
                kv_int8: bool = False) -> list:
    """``decode_cache_specs`` caches on the prefill caches' device, zeros,
    with the prefill's rows copied in: K/V at the first positions (with
    ``kv_int8``, each row quantized by ``quantize_kv_row`` beside its
    scale), cross K/V whole."""
    from repro_torch.models.attention import quantize_kv_row
    from repro_torch.models.model import decode_cache_specs

    out = []
    for spec, pre in zip(decode_cache_specs(cfg, batch, seq, enc_seq, kv_int8), prefill_caches):
        group = {}
        for blk, names in spec.items():
            dev = pre[blk]["k"].device
            t = {n: torch.zeros(sp.shape, dtype=sp.dtype, device=dev) for n, sp in names.items()}
            s = pre[blk]["k"].shape[2]
            for n in ("k", "v"):
                if kv_int8:
                    t[n][:, :, :s], t[f"{n}_scale"][:, :, :s] = quantize_kv_row(pre[blk][n])
                else:
                    t[n][:, :, :s] = pre[blk][n]
            for n in ("cross_k", "cross_v"):
                if n in t:
                    t[n].copy_(pre[blk][n])
            group[blk] = t
        out.append(group)
    return out


def encdec_phase(torch, device) -> dict:
    """The eighth main path: SeamlessM4T-medium at its published widths
    (12 non-causal encoder layers over the frames, 12 decoder layers with
    cross-attention; random bfloat16 weights from seed 0), nothing cut: 4
    requests of 4,096 seeded bfloat16 frame embeddings (the encoder's
    ``FLASH_THRESHOLD`` is 1,024, so it runs the non-causal flash path) and
    512 seeded tokens prefilled at batch 4, then 32 greedy ``decode_step``s
    on ``decode_cache_specs`` caches that hold the prefill's cross K/V;
    again on fresh caches (the same tokens, or it fails).  Every layer's
    cross K/V after the last step must be bitwise what prefill wrote.
    Prefill ms with the encoder's share (``_encode`` alone), decode ms a
    step, profiles of one prefill and one step, peak memory, and decode
    step 1 against a prefill of the same 513 tokens."""
    import numpy as np

    from repro_torch.config import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.model import _encode, decode_step, init_model, model_param_defs, prefill
    from repro_torch.models.params import param_count

    cfg = get_arch(ENCDEC_ARCH)
    n_params = param_count(model_param_defs(cfg))
    if n_params != ENCDEC_PARAMS:
        raise AssertionError(f"encdec: {n_params} parameters, JAX counts {ENCDEC_PARAMS}")
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ENCDEC_BATCH, ENCDEC_PROMPT_LEN))
                              .astype(np.int32)).to(device)
    frames = torch.from_numpy(rng.standard_normal(
        (ENCDEC_BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32)).to(device, torch.bfloat16)
    batch = {"tokens": tokens, "frames": frames}

    prefill(params, cfg, batch)                     # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    enc_out = _encode(params, cfg, frames, False)
    torch.cuda.synchronize()
    encode_ms = 1e3 * (time.perf_counter() - t0)
    del enc_out
    cross = {n: caches[0]["blk0"][n].clone() for n in ("cross_k", "cross_v")}
    want_cross = (cfg.num_layers, ENCDEC_BATCH, cfg.frontend_seq, cfg.num_kv_heads,
                  cfg.resolved_head_dim)
    if tuple(cross["cross_k"].shape) != want_cross or cross["cross_k"].dtype != torch.bfloat16:
        raise AssertionError(f"encdec: cross K of {tuple(cross['cross_k'].shape)} "
                             f"{cross['cross_k'].dtype}, expected {want_cross} bfloat16")
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    seq = ENCDEC_PROMPT_LEN + ENCDEC_DECODE_STEPS
    run = greedy_steps(torch, cfg, params,
                       spec_caches(torch, cfg, caches, ENCDEC_BATCH, seq, cfg.frontend_seq),
                       first, ENCDEC_PROMPT_LEN, ENCDEC_DECODE_STEPS)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for n, t in cross.items():
        if not torch.equal(run["caches"][0]["blk0"][n], t):
            raise AssertionError(f"encdec: decode changed the {n} that prefill wrote")
    again = greedy_steps(torch, cfg, params,
                         spec_caches(torch, cfg, caches, ENCDEC_BATCH, seq, cfg.frontend_seq),
                         first, ENCDEC_PROMPT_LEN, ENCDEC_DECODE_STEPS)
    if not bool(torch.isfinite(logits).all() & torch.isfinite(run["logits"]).all()):
        raise AssertionError("encdec: logits are not finite")
    if not torch.equal(run["tokens"], again["tokens"]):
        raise AssertionError("encdec: a second decode run gave other tokens")
    if sum(launches.values()):
        raise AssertionError(f"encdec: a kernel launched on a path without one: {launches}")
    # decode step 1 (fed the prefill's argmax at position 512) against a
    # prefill of the prompt and that token
    longer = {"tokens": torch.cat([tokens, first], dim=1), "frames": frames}
    cont, _ = prefill(params, cfg, longer)
    step1_gap = float((run["logits"][0] - cont[:, -1]).abs().max())
    step1_argmax = int(run["logits"][0].argmax(-1).eq(cont[:, -1].argmax(-1)).sum())
    tok, pos, dcaches = run["last"]
    decode_med = statistics.median(run["decode_ms"])
    prof_decode = profile_calls(torch, lambda: decode_step(params, cfg, tok, pos, dcaches), 3,
                                decode_med, "gemm")
    prof_prefill = profile_calls(torch, lambda: prefill(params, cfg, batch), 1, prefill_ms,
                                 "gemm")
    emit("encdec", arch=cfg.name, params=n_params, init_s=init_s, batch=ENCDEC_BATCH,
         frames=cfg.frontend_seq, prompt_len=ENCDEC_PROMPT_LEN,
         decode_steps=ENCDEC_DECODE_STEPS, prefill_ms=prefill_ms, encode_ms=encode_ms,
         encoder_share=encode_ms / prefill_ms,
         prefill_tokens_per_s=ENCDEC_BATCH * ENCDEC_PROMPT_LEN / (prefill_ms / 1e3),
         decode_ms_per_step=run["decode_ms"], decode_ms_per_step_median=decode_med,
         decode_tokens_per_s=ENCDEC_BATCH / (decode_med / 1e3), decode_repeat_tokens_equal=True,
         cross_kv_bitwise_after_decode=True, cross_kv_shape=list(want_cross),
         max_abs_logit=float(run["logits"].abs().max()),
         step1_vs_prefill_max_abs_diff=step1_gap,
         step1_vs_prefill_argmax_agree=f"{step1_argmax}/{ENCDEC_BATCH}",
         peak_memory_bytes=peak, profile_decode_step=prof_decode, profile_prefill=prof_prefill,
         tokens_row0=run["tokens"][0].tolist())
    return dict(prefill_ms=prefill_ms, decode_ms=decode_med)


KV_INT8_ARCH = "granite_8b"
KV_INT8_BATCH, KV_INT8_PROMPT_LEN, KV_INT8_STEPS = 4, 512, 32
KV_INT8_LONG = "decode_32k"   # SHAPES entry whose length the long-context step takes


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for g in caches for blk in g.values()
               for t in blk.values())


def kv_int8_phase(torch, device) -> dict:
    """Granite-8B at full width (random bfloat16 weights from seed 0) on int8
    K/V caches: 4 x 512 seeded tokens prefilled, each layer's K/V rows
    quantized with ``quantize_kv_row`` into ``decode_cache_specs(...,
    kv_int8=True)`` caches, then 32 greedy ``decode_step``s on them and 32
    on bfloat16 ``decode_cache_specs`` caches of the same prefill.  Ms a
    step and cache bytes of each, the step-1 logit gap and argmax
    agreement (beside the gap that flipping the last bit of 1% of the
    bfloat16 cache values gives), the greedy tokens' agreement; the int8 caches must still be
    int8 (and their scales float32) after the last step.  Then one step of
    each kind at the context of ``SHAPES["decode_32k"]`` (batch 4), the
    caches filled from seeded rows (the int8 ones their quantization),
    timed: a step reads all its cache rows."""
    import numpy as np

    from repro_torch.config import SHAPES, get_arch
    from repro_torch.models.attention import quantize_kv_row
    from repro_torch.models.model import decode_cache_specs, decode_step, init_model, prefill

    cfg = get_arch(KV_INT8_ARCH)
    params = init_model(cfg, torch.Generator().manual_seed(0), device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (KV_INT8_BATCH, KV_INT8_PROMPT_LEN))
                              .astype(np.int32)).to(device)
    logits, caches = prefill(params, cfg, {"tokens": tokens})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    seq = KV_INT8_PROMPT_LEN + KV_INT8_STEPS
    runs, nbytes = {}, {}
    for kind, int8 in (("bf16", False), ("int8", True)):
        dcaches = spec_caches(torch, cfg, caches, KV_INT8_BATCH, seq, kv_int8=int8)
        nbytes[kind] = cache_bytes(dcaches)
        runs[kind] = greedy_steps(torch, cfg, params, dcaches, first, KV_INT8_PROMPT_LEN,
                                  KV_INT8_STEPS)
    # the chain's own sensitivity: step 1 on the bfloat16 caches with the
    # last bit of 1% of their values flipped
    nudged = spec_caches(torch, cfg, caches, KV_INT8_BATCH, seq)
    gen = torch.Generator(device=device).manual_seed(2)
    for n in ("k", "v"):
        bits = nudged[0]["blk0"][n].view(torch.int16)
        bits ^= (torch.rand(bits.shape, generator=gen, device=device) < 0.01).to(torch.int16)
    one_ulp = greedy_steps(torch, cfg, params, nudged, first, KV_INT8_PROMPT_LEN, 1)
    one_ulp_gap = float((one_ulp["logits"][0] - runs["bf16"]["logits"][0]).abs().max())
    del nudged, one_ulp
    last = runs["int8"]["caches"][0]["blk0"]
    if (last["k"].dtype, last["v"].dtype, last["k_scale"].dtype) != (
            torch.int8, torch.int8, torch.float32):
        raise AssertionError(f"kv_int8: caches turned {last['k'].dtype}, {last['k_scale'].dtype}")
    if not bool(torch.isfinite(runs["int8"]["logits"]).all()):
        raise AssertionError("kv_int8: logits are not finite")
    ratio = nbytes["int8"] / nbytes["bf16"]
    want_ratio = (1 + 4 / cfg.resolved_head_dim) / 2   # int8 rows + a float32 scale a row
    if abs(ratio - want_ratio) > 1e-9:
        raise AssertionError(f"kv_int8: int8 caches take {ratio} of bfloat16's, not {want_ratio}")
    step1 = runs["int8"]["logits"][0], runs["bf16"]["logits"][0]
    step1_gap = float((step1[0] - step1[1]).abs().max())
    step1_agree = int(step1[0].argmax(-1).eq(step1[1].argmax(-1)).sum())
    token_agree = int(runs["int8"]["tokens"].eq(runs["bf16"]["tokens"]).sum())
    step_ms = {k: statistics.median(r["decode_ms"]) for k, r in runs.items()}
    del runs, caches, last

    # one step of each kind at decode_32k's context, batch 4
    long_seq = SHAPES[KV_INT8_LONG].seq_len
    gen = torch.Generator(device=device).manual_seed(1)
    long_ms = {}
    for kind, int8 in (("bf16", False), ("int8", True)):
        specs = decode_cache_specs(cfg, KV_INT8_BATCH, long_seq, kv_int8=int8)[0]["blk0"]
        blk = {n: torch.empty(sp.shape, dtype=sp.dtype, device=device) for n, sp in specs.items()}
        for n in ("k", "v"):
            for layer in range(blk[n].shape[0]):   # one layer of temporaries at a time
                rows = torch.randn(blk[n].shape[1:], generator=gen, device=device).to(
                    torch.bfloat16)
                if int8:
                    blk[n][layer], blk[f"{n}_scale"][layer] = quantize_kv_row(rows)
                else:
                    blk[n][layer] = rows
        long_caches = [{"blk0": blk}]
        tok = first
        pos = torch.full((KV_INT8_BATCH,), long_seq - 1, dtype=torch.int32, device=device)
        times = []
        for _ in range(4):   # a warm-up, then three timed steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_step(params, cfg, tok, pos, long_caches)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        long_ms[kind] = dict(ms=statistics.median(times[1:]), cache_bytes=cache_bytes(long_caches))
        del long_caches, blk
        torch.cuda.empty_cache()
    emit("kv_int8", arch=cfg.name, batch=KV_INT8_BATCH, prompt_len=KV_INT8_PROMPT_LEN,
         decode_steps=KV_INT8_STEPS, decode_ms_per_step_median=step_ms, cache_bytes=nbytes,
         cache_ratio=ratio, step1_max_abs_diff=step1_gap,
         step1_one_ulp_nudge_max_abs_diff=one_ulp_gap,
         step1_argmax_agree=f"{step1_agree}/{KV_INT8_BATCH}",
         greedy_tokens_agree=f"{token_agree}/{KV_INT8_BATCH * (KV_INT8_STEPS + 1)}",
         caches_int8_after_decode=True, long_context=long_seq, long_context_step=long_ms)
    return dict(step_ms=step_ms, long_context_step=long_ms)


EXAMPLE_TIMEOUT_S = 300
EXAMPLES = {   # module of repro_torch.examples -> (arguments, what its last line must hold)
    "quickstart": ([], "WAN bytes vs no-cache"),
    "serve_paged": ([], "FLIC page-manager stats:"),
    "cityscale_cache_sim": (["--nodes", "100", "--minutes", "5", "--outage-at", "120",
                             "--outage-s", "60", "--engine", "fused"],
                            "FLIC rode out the outage"),
    "train_lm": (["--steps", "60", "--fault-at", "30"], "via ckpt restart"),
}


def examples_phase(torch) -> None:
    """The four example drivers on the card, each ``python -m
    repro_torch.examples.<name>`` in a process of its own, all started
    together: each must exit 0 and print its closing line; ``serve_paged``
    must reuse all 4 prefills.  Every process is stopped before return."""
    ckpt = ROOT / "build" / "chip_smoke_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, (args, _) in EXAMPLES.items():
            extra = ["--ckpt-dir", str(ckpt)] if name == "train_lm" else []
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"repro_torch.examples.{name}", *args, *extra],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
            lines = out.strip().splitlines()
            ok = proc.returncode == 0 and lines and EXAMPLES[name][1] in lines[-1]
            if name == "serve_paged":
                ok = ok and any("prefill reused: 4/4" in x for x in lines)
            if not ok:
                raise AssertionError(f"example {name}: rc {proc.returncode}, "
                                     f"stdout {out[-1500:]!r}, stderr {err[-1500:]!r}")
            emit("example", name=name, args=EXAMPLES[name][0], rc=proc.returncode,
                 seconds_since_start=time.perf_counter() - t0, closing_lines=lines[-4:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(ckpt, ignore_errors=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port (src/repro_torch) is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import workload as wl
    from repro_torch.core.simulator import SimConfig
    from repro_torch.kernels import build, ops
    from repro_torch.models.replay import ENCDEC_TOL, HYBRID_TOL, MOE_TOL, VLM_TOL

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

    start = time.perf_counter()

    def elapsed(after: str) -> None:
        emit("elapsed", after=after, seconds=time.perf_counter() - start)

    t0 = time.perf_counter()
    logs = build.build_all()
    ptxas = {k: ptxas_report(v) for k, v in logs.items()}
    emit("build", seconds=time.perf_counter() - t0, built=sorted(logs), ptxas=ptxas)
    spilled = [f"{k}: {fn}" for k, fns in ptxas.items() for fn, line in fns.items()
               if re.search(r"[1-9]\d* bytes (stack frame|spill)", line)]
    if spilled:
        raise AssertionError(f"ptxas reports a stack frame or spills in {spilled}")

    dense_cfg = SimConfig(
        n_nodes=1000, cache_lines=200, loss_model="gilbert_elliott",
        workload=wl.SCENARIOS["zipf_hot"], outage_schedule=((300, 120),),
    )
    city_cfg = SimConfig(n_nodes=10_000, cache_lines=200,
                         workload=dataclasses.replace(wl.SCENARIOS["paper"], fanout=32))
    # The dense cell's shape under the replicate policy (as the paper_replicate
    # conformance case: Bernoulli loss 0.1), and under Poisson arrivals and
    # trace replay (its loss model, an outage inside their 300 ticks).
    replicate_cfg = SimConfig(n_nodes=1000, cache_lines=200, loss_prob=0.1,
                              insert_policy="replicate", workload=wl.SCENARIOS["paper"])
    poisson_cfg = SimConfig(n_nodes=1000, cache_lines=200, loss_model="gilbert_elliott",
                            workload=wl.SCENARIOS["poisson"], outage_schedule=((150, 60),))
    trace_cfg = dataclasses.replace(poisson_cfg, workload=wl.SCENARIOS["trace_ycsb"])
    cfgs = {"dense": dense_cfg, "city": city_cfg, "replicate": replicate_cfg,
            "poisson": poisson_cfg, "trace": trace_cfg}

    cycles_per_ms = spin_cycles_per_ms(torch)
    launch_floor_ms = time_ms(torch, torch.cuda._sleep, lambda: [0], cycles_per_ms)
    kres = kernel_phase(torch, device, cfgs, cycles_per_ms)
    emit("kernels", bitwise_equal=True, spin_cycles_per_ms=cycles_per_ms,
         launch_floor_ms=launch_floor_ms, **kres)

    elapsed("kernels")
    replays = replay_phase(torch, device)
    elapsed("replay")

    cell_launches = {}
    cell_launches["dense"], _, dense_series = engine_phase(torch, device, "dense", dense_cfg,
                                                           600, FLIC_KERNELS)
    cell_launches["city"], city, _ = engine_phase(torch, device, "city", city_cfg, 120,
                                                  ("flic_insert",))
    if city["queue_dropped"] <= 0:
        raise AssertionError("city: the writer ring was expected to overflow")
    n = replicate_cfg.n_nodes
    cell_launches["replicate"], _, _ = engine_phase(
        torch, device, "replicate", replicate_cfg, 30, ("flic_insert", "flic_lookup"),
        per_tick={"flic_insert": n + 1, "flic_update": 0, "flic_lookup": 1},
        profile_ticks=5)    # ~2,500 launches a tick: 5 ticks keep the trace short
    cell_launches["poisson"], _, _ = engine_phase(
        torch, device, "poisson", poisson_cfg, 300, FLIC_KERNELS,
        per_tick={"flic_insert": 5, "flic_update": 4, "flic_lookup": 1})
    trace_on_card(torch, device, trace_cfg)
    cell_launches["trace"], _, _ = engine_phase(
        torch, device, "trace", trace_cfg, 300, FLIC_KERNELS,
        per_tick={"flic_insert": 2, "flic_update": 1, "flic_lookup": 1})
    elapsed("engine cells")
    reference_phase(torch, device, replays)
    elapsed("reference")
    by_world, replay_results = multi_rank_runs(torch, dense_cfg, replays)
    distributed_phase(torch, by_world, dense_cfg, dense_series)
    distributed_replay_phase(torch, replay_results)
    sharded_phase(torch, by_world, dense_series)
    for world, runs in by_world.items():
        for engine in ("distributed", "sharded"):
            res = runs[engine]
            cell_launches[f"{engine}_w{world}"] = {
                k: sum(rank[k] for rank in res.launches) for k in FLIC_KERNELS}
    elapsed("multi-rank engines")

    serve = serve_phase(torch, device)
    pres = paged_kernel_phase(torch, device, serve.pop("attn_args"), cycles_per_ms)
    emit("kernels", kernel=PAGED, spin_cycles_per_ms=cycles_per_ms, **pres)
    serve_replay_phase(torch, device)
    torch.cuda.empty_cache()
    granite3 = granite3_serve_phase(torch, device)
    torch.cuda.empty_cache()
    elapsed("serving")

    merge = merge_phase(torch, device, dense_cfg)
    mres = merge_kernel_phase(torch, device, merge.pop("args"), cycles_per_ms)
    emit("kernels", kernel="flic_merge", spin_cycles_per_ms=cycles_per_ms, **mres)

    ssm = ssm_phase(torch, device)
    sres = scan_kernel_phase(torch, device, ssm.pop("scan_args"), cycles_per_ms)
    emit("kernels", kernel="ssd_scan", spin_cycles_per_ms=cycles_per_ms, **sres)
    ssm_replay_phase(torch, device)
    elapsed("ssm")

    torch.cuda.empty_cache()
    train = train_phase(torch, device)
    bres = scan_bwd_kernel_phase(torch, device, train.pop("captured"),
                                 ssm.pop("published_args"), cycles_per_ms)
    emit("kernels", kernel="ssd_scan_bwd", spin_cycles_per_ms=cycles_per_ms, **bres)
    torch.cuda.empty_cache()
    train_dense_phase(torch, device)
    torch.cuda.empty_cache()
    train_replay_phase(torch, device)
    elapsed("train")

    torch.cuda.empty_cache()
    moe_phase(torch, device)
    torch.cuda.empty_cache()
    model_replay_phase(torch, device, "moe_replay", {
        f"moe_{arch}_smoke.npz": MOE_TOL
        for arch in ("deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")})
    examples_phase(torch)
    elapsed("moe and examples")

    torch.cuda.empty_cache()
    hybrid = hybrid_phase(torch, device, cycles_per_ms)
    torch.cuda.empty_cache()
    model_replay_phase(torch, device, "hybrid_replay",
                       {"hybrid_jamba_1_5_large_398b_smoke.npz": HYBRID_TOL})
    vlm = vlm_phase(torch, device, cycles_per_ms)
    torch.cuda.empty_cache()
    model_replay_phase(torch, device, "vlm_replay", {"vlm_internvl2_2b_smoke.npz": VLM_TOL})
    elapsed("hybrid and vlm")

    torch.cuda.empty_cache()
    encdec_phase(torch, device)
    torch.cuda.empty_cache()
    model_replay_phase(torch, device, "encdec_replay",
                       {"encdec_seamless_m4t_medium_smoke.npz": ENCDEC_TOL})
    kv_int8_phase(torch, device)
    torch.cuda.empty_cache()
    elapsed("encdec and kv_int8")

    # Headline case of each FLIC kernel: the first main-path case of the
    # kernels phase.  Launches: the main path's kernel runs of the five
    # engine cells (dense, city, replicate, poisson, trace), each counted
    # from 0.  max_abs_err is 0: every FLIC kernel passed a bitwise
    # comparison.  paged_attention: the Granite serve run's launches and
    # InternVL2's paged run's, its headline the Granite serve step's inputs,
    # its error the largest over all its cases and checked calls.
    lines = []
    for name in FLIC_KERNELS:
        head = next(iter(kres[name].values()))
        lines.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in cell_launches.values()),
            "max_abs_err": 0.0, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"], "library_ms": None,
        })
    head = pres["serve_step20_layer0"]
    lines.append({
        "name": PAGED, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{PAGED}.cu",
        "replaces": REPLACES[PAGED], "launches": serve["launches"] + vlm["launches"],
        "max_abs_err": max([serve["max_abs_err"], granite3["max_abs_err"], vlm["max_abs_err"]]
                           + [v["max_abs_err"] for v in pres.values()
                              if isinstance(v, dict) and "max_abs_err" in v]),
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
    })
    # flic_merge: its entry's run on the dense cell's catch-up; ssd_scan: the
    # Mamba2 prefill's launches, the train run's (8 steps, remat: the
    # forward twice a layer) and the Jamba prefill's; ssd_scan_bwd: the
    # train run's.  Error: the largest over all cases (ssd_scan_bwd:
    # g_decay's; g_states and g_init are bitwise).
    sres["jamba_prefill_layer0"] = hybrid["scan_case"]
    for name, launches, cases in (
            ("flic_merge", merge["launches"], mres),
            ("ssd_scan", ssm["launches"] + train["launches"]["ssd_scan"] + hybrid["launches"],
             sres),
            ("ssd_scan_bwd", train["launches"]["ssd_scan_bwd"], bres)):
        head = next(iter(cases.values()))
        lines.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{ops.SOURCE.get(name, name)}.cu",
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
