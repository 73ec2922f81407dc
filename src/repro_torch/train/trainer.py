"""Trainer: loop, checkpoint/restart and fault handling (port of
``repro.train.trainer``).

* periodic async checkpoints (``ckpt.CheckpointManager``, atomic commit);
* a restart resumes from the latest complete checkpoint in ``ckpt_dir``,
  one written by this package or by the JAX package (same layout);
* a fault hook per step (tests inject failures): on ``_InjectedFault`` the
  trainer restores the last checkpoint and goes on, the path a cluster
  scheduler drives after losing a node.

Params come from ``init_model(cfg, generator, device)`` with a
``torch.Generator`` seeded with ``TrainerConfig.seed``, or from a
checkpoint.  Entry points run on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, restore_checkpoint
from repro_torch.config import ModelConfig
from repro_torch.core.simulator import resolve_device
from repro_torch.data.pipeline import batch_to_device, synthetic_batch
from repro_torch.models.model import init_model
from repro_torch.optim import adamw_init
from repro_torch.train.train_step import TrainHyper, make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    seed: int = 0
    hyper: TrainHyper = dataclasses.field(default_factory=TrainHyper)


class Trainer:
    def __init__(self, model_cfg: ModelConfig, cfg: TrainerConfig,
                 fault_hook: Optional[Callable[[int], None]] = None, device=None,
                 params: Optional[dict] = None):
        """``params``: start from these weights (default: ``init_model`` from
        ``cfg.seed``); a checkpoint in ``cfg.ckpt_dir`` takes precedence."""
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(cfg.ckpt_dir)
        self.step_fn = make_train_step(model_cfg, cfg.hyper)
        self.history: list[dict[str, float]] = []
        if params is None:
            params = init_model(model_cfg, torch.Generator().manual_seed(cfg.seed), self.device)
        self.params = params
        self.opt_state = adamw_init(self.params)
        self.step = 0
        self._maybe_restore()

    # ------------------------------------------------------------------
    def _maybe_restore(self):
        latest = self.ckpt.latest()
        if latest is None:
            return
        state = {"params": self.params, "opt": self.opt_state}
        restored, manifest = restore_checkpoint(self.cfg.ckpt_dir, state, latest,
                                                device=self.device)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.step = manifest["step"]

    def _save(self):
        self.ckpt.save_async(self.step, {"params": self.params, "opt": self.opt_state},
                             extra={"model": self.model_cfg.name})

    # ------------------------------------------------------------------
    def run(self) -> list[dict[str, float]]:
        cfg = self.cfg
        while self.step < cfg.steps:
            batch = batch_to_device(synthetic_batch(self.model_cfg, cfg.seq_len,
                                                    cfg.global_batch, self.step, cfg.seed),
                                    self.device)
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(self.step)
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, self.step)
                metrics = {k: float(v) for k, v in metrics.items()}
            except _InjectedFault:
                # Simulated node failure: recover from the last checkpoint,
                # the same path a cluster scheduler drives after a real loss.
                self.ckpt.wait()
                self._maybe_restore()
                continue
            metrics["step_time_s"] = time.perf_counter() - t0
            metrics["step"] = self.step
            self.history.append(metrics)
            if not np.isfinite(metrics["loss"]):
                raise FloatingPointError(f"non-finite loss at step {self.step}")
            self.step += 1
            if self.step % cfg.ckpt_every == 0 or self.step == cfg.steps:
                self._save()
        self.ckpt.wait()
        return self.history


class _InjectedFault(RuntimeError):
    """Raised by test fault hooks to simulate a node failure."""


def inject_fault_at(steps: set[int]) -> Callable[[int], None]:
    fired: set[int] = set()

    def hook(step: int):
        if step in steps and step not in fired:
            fired.add(step)
            raise _InjectedFault(f"injected failure at step {step}")

    return hook
