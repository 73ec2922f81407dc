"""The control of the comparison that decides ``correct``.

    python3 fogbench/control.py --workload <cell> --seeds <n> [<n> ...]

The reference with one guarantee of the configuration broken, put in the
program's place: a fog read is answered by the OLDEST responding copy, not
the newest.  For each seed it runs that control and the reference over the
cell's traffic (its warm-up and ``CONTROL_TICKS`` more), compares them as
``harness.run_cell`` compares the program, and prints one JSON line with the
numbers compared.  The control must come out not correct.  It runs on the card where there is one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Ticks compared past the warm-up: the control's readings are far above the
# limits after these, and a run's longer window only adds to them.
CONTROL_TICKS = 100


def control_counts(cell, seed: int, ticks: int, device) -> dict:
    from fogbench import check, harness

    ctl = harness.replay_reference(cell, seed, ticks, device, elect="oldest")
    ref = harness.replay_reference(cell, seed, ticks, device)
    counts, _ = check.compare(ctl[0], ref[0], ctl[1], ref[1])
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]

    import torch

    from fogbench import cells, check

    cell = cells.load(ROOT, args.workload)
    ticks = cell.traffic["warmup_ticks"] + 1 + CONTROL_TICKS
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
