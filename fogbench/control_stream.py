"""The control of the comparison that decides ``correct``, for the write-once
stream.

    python3 fogbench/control_stream.py --workload <cell> --seeds <n> [<n> ...]

``control.py`` breaks "the newest responding copy answers a fog read"; on a
write-once stream every copy of a row carries its one timestamp, so that
fault changes nothing there.  This control breaks the stream's own
guarantee instead: on overflow the FIFO writer ring overwrites its OLDEST
pending rows (the head moves past them) where the configuration drops the
newest write and counts it.  The fault is put into the reference's
``enqueue`` inside this process only.  For each seed it runs that control
and the reference over the cell's traffic (its warm-up and
``control.CONTROL_TICKS`` more), compares them as ``harness.run_cell``
compares the program, and prints one JSON line with the numbers compared,
as ``control.py`` does.  The control must come out not correct wherever the
ring fills.  It runs on the card where there is one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def enqueue_overwriting(st, keys, ts, origin, mask):
    """The FIFO ring with its overflow rule broken: every masked write is
    appended, and the head moves past the oldest pending rows it overwrote;
    nothing is dropped.  Of more than a ring's worth in one call, the newest
    ``capacity`` rows are written."""
    from fogbench.reference import fog

    cap = st["queue.keys"].shape[0]
    offs = torch.cumsum(mask.to(fog.I32), 0, dtype=fog.I32) - 1
    n = fog._sum(mask)
    keep = mask & (offs >= n - cap)
    slots = torch.where(keep, (st["queue.tail"] + offs) % cap, cap)
    for f, v in (("keys", keys), ("data_ts", ts), ("origin", origin)):
        st["queue." + f] = fog.set_drop(st["queue." + f], slots, v)
    st["queue.tail"] = st["queue.tail"] + n
    st["queue.head"] = torch.maximum(st["queue.head"], st["queue.tail"] - cap)


@contextlib.contextmanager
def overwriting_ring():
    """The reference's FIFO ``enqueue`` replaced by ``enqueue_overwriting``
    while the block runs."""
    from fogbench.reference import fog

    saved = fog.enqueue
    fog.enqueue = enqueue_overwriting
    try:
        yield
    finally:
        fog.enqueue = saved


def control_counts(cell, seed: int, ticks: int, device) -> dict:
    from fogbench import check, harness

    with overwriting_ring():
        ctl = harness.replay_reference(cell, seed, ticks, device)
    ref = harness.replay_reference(cell, seed, ticks, device)
    counts, _ = check.compare(ctl[0], ref[0], ctl[1], ref[1])
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]

    from fogbench import cells, check, control

    cell = cells.load(ROOT, args.workload)
    ticks = cell.traffic["warmup_ticks"] + 1 + control.CONTROL_TICKS
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        h0 = time.perf_counter()
        counts = control_counts(cell, seed, ticks, device)
        print(json.dumps({"workload": args.workload, "seed": seed, "ticks": ticks,
                          "correct": check.verdict(counts), "counts": counts,
                          "seconds": time.perf_counter() - h0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
