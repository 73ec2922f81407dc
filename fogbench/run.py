"""The benchmark of the FLIC fog simulator's PyTorch and CUDA port.

    python3 fogbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card.  It runs
one cell of ``BENCHMARK.json`` (``harness.run_cell``) and prints, as the last
line of its standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device`` and, traced, ``breakdown``; last in it,
``checks``, each compared number beside its limit, which also close its
standard error.  Without a card, or where the program is missing, it exits
with a non-zero code and prints no result; so it does where, once the window
has closed, the process holds a module of JAX or of the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache a build or compile could write stays in the checkout.
    cache = ROOT / "build" / "fogbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from fogbench import cells

    cell = cells.load(ROOT, args.workload)
    chips = next(w["chips"] for w in cells.benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fogbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"fogbench: the program is missing: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)

    from fogbench import harness

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START, cell=cell)
    found = harness.forbidden_modules()
    if found:
        print(f"fogbench: the process holds JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"fogbench check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
