"""Train a language model end to end with the full production stack
(port of ``examples/train_lm.py``).

Run on the card, or on the host::

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--big]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 10 \\
        --fault-at 5 --seq 32 --batch 4

Default: a ~10M-param granite-family model for 200 steps — the whole path
(FLIC-cached data pipeline -> microbatched train step -> AdamW -> async
checkpoints -> fault injection at step 120 with automatic recovery) is the
same code ``repro_torch.launch.train`` runs.  ``--big`` switches to a
~100M-param config.  A run restarts from the latest checkpoint in
``--ckpt-dir`` (default: ``repro_torch_train_lm`` under the temporary
directory), so give a fresh directory for a fresh run.  The weights start
from ``torch.Generator`` seed 0, not JAX's draw.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.config import ModelConfig
from repro_torch.train import Trainer, TrainerConfig, TrainHyper
from repro_torch.train.trainer import inject_fault_at

SMALL = ModelConfig(                      # ~10M params
    name="train-demo-10m", family="dense",
    num_layers=4, d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
    d_ff=1024, vocab_size=8192,
)
BIG = ModelConfig(                        # ~100M params
    name="train-demo-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
    d_ff=3072, vocab_size=32768,
)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fault-at", type=int, default=120)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the host)")
    args = ap.parse_args(argv)

    cfg = BIG if args.big else SMALL
    tcfg = TrainerConfig(
        steps=args.steps, seq_len=args.seq, global_batch=args.batch,
        ckpt_dir=args.ckpt_dir, ckpt_every=40,
        hyper=TrainHyper(peak_lr=1e-3, warmup_steps=20, total_steps=args.steps,
                         microbatches=2),
    )
    hook = inject_fault_at({args.fault_at}) if 0 < args.fault_at < args.steps else None
    trainer = Trainer(cfg, tcfg, fault_hook=hook, device=args.device)
    hist = trainer.run()

    print(f"\n{cfg.name}: {len(hist)} steps")
    for h in hist[:: max(len(hist) // 10, 1)]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"lr {h['lr']:.2e}  {h['step_time_s']*1e3:7.1f} ms")
    first = sum(h["loss"] for h in hist[:5]) / 5
    last = sum(h["loss"] for h in hist[-5:]) / 5
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'}); "
          f"survived injected fault at step {args.fault_at} via ckpt restart")


if __name__ == "__main__":
    main()
