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


def split_microbatches(batch: dict, n_mb: int) -> list[dict]:
    """The ``n_mb`` microbatches of ``batch``: rows ``[i*b, (i+1)*b)`` of
    each tensor (b = B / n_mb), as JAX splits them.  A DTensor batch
    (sharded on its rows by a plan) is gathered whole once, and each
    microbatch is laid out again as the batch was: one microbatch's rows
    lie on some ranks only, and another split of the rows would change the
    loss (the MoE load-balance term is a product of means over a
    microbatch, the masked CE a ratio of its sums)."""
    from torch.distributed.tensor import DTensor, Replicate

    def whole(v):
        if isinstance(v, DTensor):
            return v.redistribute(v.device_mesh, (Replicate(),) * v.device_mesh.ndim), v.placements
        return v, None

    def rows(v, placements, i):
        b = v.shape[0] // n_mb
        part = v[i * b:(i + 1) * b]
        return part if placements is None else part.redistribute(part.device_mesh, placements)

    gathered = {k: whole(v) for k, v in batch.items()}
    return [{k: rows(v, pl, i) for k, (v, pl) in gathered.items()} for i in range(n_mb)]


def accumulated_grads(params, cfg: ModelConfig, batch: dict, hyper: TrainHyper,
                      ssd_scan: ScanFn = ops.ssd_scan):
    """(loss, metrics, grads) of one step's batch: ``grads_of`` on the whole
    batch, or with ``microbatches > 1`` the mean over the microbatches of
    their losses and gradients (summed in float32, as JAX's accumulation
    scan does; metrics ``{"ce": loss, "aux": 0}``, as JAX reports them)."""
    n_mb = hyper.microbatches
    if n_mb == 1:
        return grads_of(params, cfg, batch, hyper, ssd_scan)
    gsum = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
    lsum = torch.zeros((), dtype=F32, device=tree_leaves(params)[0].device)
    for mb in split_microbatches(batch, n_mb):
        loss, _met, g = grads_of(params, cfg, mb, hyper, ssd_scan)
        gsum = tree_map(torch.add, gsum, g)
        lsum = lsum + loss
    grads = tree_map(lambda g: g / n_mb, gsum)
    loss = lsum / n_mb
    return loss, {"ce": loss, "aux": torch.zeros((), dtype=F32, device=loss.device)}, grads


def make_train_step(cfg: ModelConfig, hyper: TrainHyper, ssd_scan: ScanFn = ops.ssd_scan):
    """Returns train_step(params, opt_state, batch, step) -> (p, o, metrics);
    ``batch`` holds tensors on the params' device, ``metrics`` 0-d tensors."""

    def train_step(params, opt_state, batch: dict, step: int):
        loss, met, grads = accumulated_grads(params, cfg, batch, hyper, ssd_scan)

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
