"""End-to-end training entry point (port of ``repro.launch.train``).

Config -> Trainer (checkpoint/restart, fault hooks, metrics), on the card
unless ``--device cpu``; prints the one JSON line that JAX's prints.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_370m \\
        --seq 2048 --batch 4 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_8b --smoke \\
        --device cpu [--steps 100] [--seq 256] [--batch 8] [key=value ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

from repro_torch.config import get_arch, get_smoke_arch, parse_overrides
from repro_torch.train import Trainer, TrainerConfig, TrainHyper


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the host)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    over = parse_overrides(args.overrides)
    if over:
        cfg = dataclasses.replace(cfg, **over)

    tcfg = TrainerConfig(
        steps=args.steps,
        seq_len=args.seq,
        global_batch=args.batch,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        hyper=TrainHyper(
            peak_lr=args.lr,
            warmup_steps=max(args.steps // 10, 1),
            total_steps=args.steps,
            microbatches=args.microbatches,
        ),
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    history = trainer.run()
    first = sum(h["loss"] for h in history[:5]) / max(len(history[:5]), 1)
    last = sum(h["loss"] for h in history[-5:]) / max(len(history[-5:]), 1)
    out = {
        "arch": cfg.name, "steps": trainer.step,
        "first_loss": round(first, 4), "last_loss": round(last, 4),
        "mean_step_s": round(sum(h["step_time_s"] for h in history) / len(history), 4),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
