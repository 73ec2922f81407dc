"""The training step: microbatched gradient accumulation and AdamW (port of
``repro.train.train_step``).

Eager PyTorch: the gradient of ``models.model.loss_fn`` comes from
``torch.autograd.grad`` over the parameter leaves (the Mamba2 chunk scan
through ``kernels.ops.SSDScan``, whose backward is the ``ssd_scan_bwd``
kernel on the card).  With ``microbatches > 1`` the gradients are summed in
float32 over the microbatches, as JAX's accumulation scan does, and the
reported metrics are JAX's: ``{"ce": loss, "aux": 0}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.model import loss_fn
from repro_torch.models.ssm import ScanFn
from repro_torch.optim import adamw_update, warmup_cosine
from repro_torch.optim.grad_compress import int8_dequantize, int8_quantize
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatches: int = 1
    remat: bool = True
    remat_policy: str = "dots"   # "dots" | "nothing" (recompute the products too)
    int8_grads: bool = False     # quantize grads before the optimizer step


def grads_of(params, cfg: ModelConfig, batch: dict, hyper: TrainHyper,
             ssd_scan: ScanFn = ops.ssd_scan):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect to
    every leaf of ``params`` (a tree like ``params``, in the leaves' dtypes)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, met = loss_fn(live, cfg, batch, remat=hyper.remat, remat_policy=hyper.remat_policy,
                        ssd_scan=ssd_scan)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), {k: v.detach() for k, v in met.items()}, tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, hyper: TrainHyper, ssd_scan: ScanFn = ops.ssd_scan):
    """Returns train_step(params, opt_state, batch, step) -> (p, o, metrics);
    ``batch`` holds tensors on the params' device, ``metrics`` 0-d tensors."""

    def train_step(params, opt_state, batch: dict, step: int):
        n_mb = hyper.microbatches
        if n_mb == 1:
            loss, met, grads = grads_of(params, cfg, batch, hyper, ssd_scan)
        else:
            mbs = {k: v.reshape(n_mb, v.shape[0] // n_mb, *v.shape[1:]) for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
            lsum = torch.zeros((), dtype=F32, device=tree_leaves(params)[0].device)
            for i in range(n_mb):
                loss, _met, g = grads_of(params, cfg, {k: v[i] for k, v in mbs.items()}, hyper,
                                         ssd_scan)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / n_mb, gsum)
            loss = lsum / n_mb
            met = {"ce": loss, "aux": torch.zeros((), dtype=F32, device=loss.device)}

        if hyper.int8_grads:
            def q(g):
                qv, s = int8_quantize(g)
                return int8_dequantize(qv, s).to(g.dtype)

            grads = tree_map(q, grads)

        lr = warmup_cosine(step, peak_lr=hyper.peak_lr, warmup_steps=hyper.warmup_steps,
                           total_steps=hyper.total_steps, device=loss.device)
        params, opt_state, om = adamw_update(params, grads, opt_state, lr,
                                             weight_decay=hyper.weight_decay,
                                             grad_clip=hyper.grad_clip)
        metrics: dict[str, Any] = {"loss": loss, "lr": lr, **met, **om}
        return params, opt_state, metrics

    return train_step
