"""Quickstart: the FLIC cache in five minutes (port of ``examples/quickstart.py``).

Run on the card, or on the host::

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Walks the paper's core mechanics with the port's API:
  1. a single node's set-associative cache (insert / lookup / LRU-evict);
  2. soft coherence — a lossy broadcast round across a small fog, resolved
     by max-timestamp;
  3. the full simulated fog reproducing the paper's headline numbers.

Parts 1 and 2 print what the JAX driver prints.  Part 3 runs the fused
engine on the port's own draws (``torch.Generator`` seed 0, not JAX's
threefry), so its ratios are the same distribution's, not the same numbers.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.cache_state import CacheLine, empty_cache
from repro_torch.core.coherence import merge_broadcasts
from repro_torch.core.flic import fog_lookup, insert, local_lookup
from repro_torch.core.metrics import summarize
from repro_torch.core.simulator import SimConfig, resolve_device, run_sim


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    # --- 1. one node's cache -------------------------------------------------
    cache = empty_cache(sets=16, ways=4, payload_dim=4, device=dev)
    line = CacheLine(
        key=i32(0xBEEF), data_ts=i32(10), origin=i32(0),
        data=torch.arange(4, dtype=torch.float32, device=dev),
        valid=torch.tensor(True, device=dev), dirty=torch.tensor(False, device=dev),
    )
    cache, _ = insert(cache, line, now=10)
    cache, hit = local_lookup(cache, i32(0xBEEF), now=11)
    print(f"1) local cache: hit={bool(hit.hit)} ts={int(hit.data_ts)} "
          f"data={np.asarray(hit.data.cpu())}")

    # --- 2. soft coherence over a lossy broadcast ----------------------------
    fog = empty_cache(16, 4, 4, batch=(3,), device=dev)     # 3 nodes
    rows = CacheLine(
        key=i32([0xBEEF]),
        data_ts=i32([42]),                                   # a NEWER version
        origin=i32([1]),
        data=torch.full((1, 4), 7.0, dtype=torch.float32, device=dev),
        valid=torch.tensor([True], device=dev),
        dirty=torch.tensor([False], device=dev),
    )
    delivered = torch.tensor([[False], [True], [True]], device=dev)   # node 0 misses it
    fog, _ = merge_broadcasts(fog, rows, delivered, now=42)
    fog, best, responders = fog_lookup(fog, i32(0xBEEF), now=43)
    print(f"2) fog read: newest ts={int(best.data_ts)} "
          f"responders={responders.tolist()} (node 0 lost the packet — "
          f"soft coherence still serves the newest copy)")

    # --- 3. the paper's evaluation, end to end --------------------------------
    cfg = SimConfig(n_nodes=50, cache_lines=200, loss_prob=0.01)
    _, series = run_sim(cfg, 600, seed=0, device=dev)
    s = summarize(series)
    print("3) city-scale sim (50 nodes, 200-line caches, lossy LAN):")
    print(f"   read miss ratio          {s['read_miss_ratio']:.3%}   (paper: <2%)")
    print(f"   sync store requests      {s['sync_store_request_ratio']:.3%}   (paper: ~5%)")
    print(f"   WAN bytes vs no-cache    -{s['wan_reduction_vs_baseline']:.1%}   (paper: >50%)")


if __name__ == "__main__":
    main()
