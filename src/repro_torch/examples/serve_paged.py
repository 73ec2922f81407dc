"""Serve a model with batched requests through the FLIC-paged KV cache
(port of ``examples/serve_paged.py``).

Run on the card, or on the host::

    PYTHONPATH=src python -m repro_torch.examples.serve_paged
    PYTHONPATH=src python -m repro_torch.examples.serve_paged --device cpu

Shows the paper's cache doing production work: continuous batching, paged
decode attention (the ``paged_attention`` CUDA kernel on the card, its
plain version on the host), LRU page eviction with write-behind spill to
the host store, and content-addressed prefix reuse — a resubmitted prompt
skips prefill exactly like a fog read hit.  The weights are random from
``torch.Generator`` seed 0 (JAX's draw other numbers), so the tokens are
not JAX's; the request, token and reuse counts and the page manager's
stats are.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_smoke_arch
from repro_torch.core.simulator import resolve_device
from repro_torch.models.model import init_model
from repro_torch.serving.engine import ServeEngine


def _wave(eng: ServeEngine, prompts, dev: torch.device):
    for p in prompts:
        eng.submit(p, max_new=12)
    t0 = time.perf_counter()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return done, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_arch("phi3_medium_14b")
    params = init_model(cfg, torch.Generator().manual_seed(0), dev)
    eng = ServeEngine(cfg, params, max_batch=4, max_seq=96, page_size=8,
                      num_pages=48, device=dev)

    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, 16)) for _ in range(4)]

    # wave 1: four unique prompts
    done1, w1 = _wave(eng, prompts, dev)
    # wave 2: the same prompts — FLIC prefix reuse should skip prefill
    done2, w2 = _wave(eng, prompts, dev)

    print(f"wave 1: {len(done1)} requests, {sum(len(r.tokens) for r in done1)} tokens, {w1:.2f}s")
    print(f"wave 2: {len(done2)} requests, {sum(len(r.tokens) for r in done2)} tokens, {w2:.2f}s"
          f"  (prefill reused: {sum(r.reused_prefill for r in done2)}/4)")
    same = all(a.tokens == b.tokens for a, b in zip(done1, done2))
    print(f"outputs identical across waves: {same}")
    print("FLIC page-manager stats:", eng.mgr.stats)


if __name__ == "__main__":
    main()
