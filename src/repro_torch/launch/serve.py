"""Serving driver: batched requests through the FLIC-paged engine.

Port of ``repro.launch.serve``, with the same flags plus ``--device``.  By
default it serves the full Granite-8B on the card, with random weights from
``torch.Generator`` seed 0::

    PYTHONPATH=src python -m repro_torch.launch.serve
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --requests 8 --max-new 16
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.config import get_arch, get_smoke_arch
from repro_torch.core.simulator import resolve_device
from repro_torch.models.model import init_model
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--repeat-prompts", type=int, default=2,
                    help="resubmit each unique prompt this many times "
                         "(exercises FLIC prefix reuse)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (fails without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_model(cfg, gen, device)
    eng = ServeEngine(
        cfg, params, max_batch=args.max_batch,
        max_seq=args.prompt_len + args.max_new + args.page_size,
        page_size=args.page_size, device=device,
    )

    rng = np.random.default_rng(0)
    uniq = max(1, args.requests // args.repeat_prompts)
    prompts = [list(rng.integers(0, cfg.vocab_size, args.prompt_len)) for _ in range(uniq)]
    for i in range(args.requests):
        eng.submit(prompts[i % uniq], max_new=args.max_new)

    t0 = time.perf_counter()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in done)
    print(json.dumps({
        "arch": cfg.name,
        "device": str(device),
        "requests": len(done),
        "generated_tokens": toks,
        "tokens_per_s": round(toks / wall, 2),
        "prefill_reuse": sum(r.reused_prefill for r in done),
        "flic_stats": eng.mgr.stats,
    }, default=int))


if __name__ == "__main__":
    main()
