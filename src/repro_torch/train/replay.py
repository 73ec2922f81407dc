"""Training replay files: three steps of the JAX package's trainer, replayed
by the port.

A file (``models.replay``'s layout: ``config``, ``param.<path>`` for JAX's
initial weights, ``<case>.<field>``) holds one case per model dtype, each
JAX's run of the file's bfloat16 weights (widened exactly to float32 in the
``float32`` case) through ``make_train_step`` for ``steps`` steps:

* ``hyper``: the run's ``TrainHyper``, ``steps``, ``seq`` and ``batch`` as
  JSON;
* ``tokens``/``labels`` (T, B, S) int32: ``synthetic_batch`` of each step
  (an encoder-decoder's frames are not stored: ``encdec_frames`` draws
  them again, in the model's dtype);
* ``loss``, ``grad_norm``, ``lr`` (T,) float32: each step's metrics;
* ``grad/<path>`` float32: step 0's gradient of each leaf of
  ``TRACKED[family]``; ``post/<path>`` float32: the leaf after the last
  step;
* ``update_norm/<path>`` float64 (one per leaf): the L2 norm of
  (param after the last step - initial param), so every leaf's update is
  held, though only the tracked leaves are stored whole (the files stay
  under 300 KB).

``tests/torch_parity.py::write_train_fixture`` writes the files; the CPU
tests and ``chip_smoke.py`` replay them (``replay_train_case``) and hold
the port to ``TRAIN_TOL``.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels import ops
from repro_torch.models.model import _dtype
from repro_torch.models.params import params_from_numpy
from repro_torch.models.replay import _widen
from repro_torch.models.ssm import ScanFn
from repro_torch.optim import adamw_init
from repro_torch.train.train_step import TrainHyper, grads_of, make_train_step
from repro_torch.utils.trees import tree_flatten_with_paths

# The leaves stored whole, per model family: the float32 SSM leaves and
# small normalisation and projection leaves.
TRACKED = {
    "ssm": ("dec/g0/blk0/mixer/a_log", "dec/g0/blk0/mixer/dt_bias",
            "dec/g0/blk0/mixer/d_skip", "dec/g0/blk0/mixer/conv_b",
            "dec/g0/blk0/mixer/norm/scale", "final_norm/scale"),
    "dense": ("dec/g0/blk0/ln1/scale", "dec/g0/blk0/ln2/scale", "dec/g0/blk0/mixer/w_k",
              "dec/g0/blk0/mixer/w_v", "final_norm/scale"),
    # DeepSeek-V2-Lite's stack: a dense MLA layer (g0), then MLA + MoE (g1);
    # the float32 router takes the aux loss's gradient
    "moe": ("dec/g0/blk0/mixer/kv_norm/scale", "dec/g1/blk0/mixer/w_kr",
            "dec/g1/blk0/ln2/scale", "dec/g1/blk0/ffn/router", "final_norm/scale"),
    # Jamba's period: (ssm, mlp), (ssm, moe), (attn, mlp), (ssm, moe)
    "hybrid": ("dec/g0/blk0/mixer/a_log", "dec/g0/blk0/mixer/dt_bias",
               "dec/g0/blk1/ffn/router", "dec/g0/blk2/mixer/w_k",
               "dec/g0/blk3/mixer/d_skip", "dec/g0/blk3/ln2/scale", "final_norm/scale"),
    # SeamlessM4T: the encoder's, the cross-attention's and the decoder's
    "encdec": ("enc/g0/blk0/ln1/scale", "enc_norm/scale", "dec/g0/blk0/ln_cross/scale",
               "dec/g0/blk0/cross/w_k", "dec/g0/blk0/ln1/scale", "final_norm/scale"),
}
FIXTURE_RUN = dict(steps=3, seq=32, batch=4,
                   hyper=dataclasses.asdict(TrainHyper(peak_lr=3e-3, warmup_steps=0,
                                                       total_steps=3)))

# How far the port may be from JAX, per model dtype.  In brackets the
# largest of the Granite-8B and Mamba2 smoke fixtures replayed on the CPU.
#   lr_rel: the schedule's learning rate (XLA's and PyTorch's float32 cos
#     may differ by one unit in the last place) [0].
#   loss_rel: |loss - JAX's| / JAX's, every step [f32 1.3e-6; bf16 1.6e-3].
#   grad_norm_rel: the same for step 0's global gradient norm, taken on
#     the same weights in both packages [f32 6.7e-6; bf16 6.5e-3].  Later
#     steps' norms are not held: in bfloat16 the runs part after the first
#     update (Granite's step-2 norm is 4.44 here and 5.12 in JAX, 30% off
#     JAX's on the H100, and 3.35 in float32 in either package); the loss
#     and the update norms hold the later steps.
#   grad_of_max: step 0's gradient of a tracked leaf, largest |difference|
#     over that leaf's largest |value| [f32 5.7e-5: the embedding's
#     scatter-add and the attention backward sum in other orders; bf16
#     0.048].
#   post_abs: a tracked leaf after the last step, largest |difference|
#     [f32 2.9e-5; bf16 0.0117: three AdamW steps of lr 3e-3 whose
#     normalised updates disagree in sign move a weight by up to 0.018].
#   update_rel: a leaf's update norm, |difference| / JAX's [f32 7.8e-6;
#     bf16 0.010].
TRAIN_TOL = {
    "float32": dict(lr_rel=1e-6, loss_rel=1e-5, grad_norm_rel=2e-4, grad_of_max=2e-4,
                    post_abs=1e-4, update_rel=1e-4),
    "bfloat16": dict(lr_rel=1e-6, loss_rel=5e-3, grad_norm_rel=0.03, grad_of_max=0.1,
                     post_abs=0.03, update_rel=0.05),
}

# Jamba's smoke period (the hybrid family) is held wider.  float32: step
# 0's gradients agree as the others' do [grad_of_max 6.0e-5, grad_norm_rel
# 8.6e-6], but AdamW's first update moves each weight by lr * g / (|g| +
# eps), whose sign follows the roundoff where |g| is near 0 (0.1% of a
# leaf here, by up to 2 x lr = 6e-3), and the MoE routing of the next
# steps follows those weights [loss_rel 1.3e-4, post_abs 6.2e-4,
# update_rel 5.5e-3].  bfloat16: the 8-layer chain amplifies rounding
# (``models.replay.HYBRID_TOL``): JAX's own bfloat16 gradients lie 0.72
# (grad_of_max) and 0.21 (update_rel) from its float32 ones, and the
# port's lie as far from JAX's [loss_rel 7.3e-3, grad_norm_rel 0.025,
# grad_of_max 0.92, post_abs 0.016, update_rel 0.27].  ``grad_of_max`` is
# not held there (``None``): at 0.9 of a leaf's largest value no bound
# tells a zero or negated gradient from the chain's noise.  The bfloat16
# gradients are held block by block, each block fed JAX's input, in
# tests/test_torch_hybrid_bf16.py.
#
# SeamlessM4T's smoke config (the encoder-decoder) is held wider in the
# same way.  JAX's init reads the fan-in of a stacked 4-d projection from
# its head axis, so the attention scores are large and the softmax near
# one-hot, which amplifies roundoff.  float32: step 0's gradients agree
# within 1.74e-4 of a leaf's largest value over all 28 leaves [tracked:
# grad_of_max 1.71e-4 here, 1.86e-4 on the H100; grad_norm_rel 4.8e-6]
# (``grad_of_max`` held at 3e-4, past the others' 2e-4); 3 of 230,144
# gradients, each under 3e-6, differ in sign, so AdamW's first update
# moves those weights by 2 x lr = 6e-3 the other way, and the chain
# carries that [loss_rel 9.8e-5, post_abs 5.7e-3, update_rel 8.5e-3].  bfloat16: JAX's own
# bfloat16 run lies from its float32 run by loss_rel 0.0135, grad_of_max
# 1.45 and update_rel 0.204, and the port's from JAX's [loss_rel 0.0109,
# grad_norm_rel 0.0228, grad_of_max 0.925, post_abs 0.0156, update_rel
# 0.138]; ``grad_of_max`` is not held there, as for the hybrid family.
FAMILY_TRAIN_TOL = {
    "hybrid": {
        "float32": dict(loss_rel=1e-3, post_abs=6e-3, update_rel=0.02),
        "bfloat16": dict(loss_rel=0.02, grad_norm_rel=0.1, grad_of_max=None, update_rel=0.6),
    },
    "encdec": {
        "float32": dict(loss_rel=1e-3, grad_of_max=3e-4, post_abs=1.2e-2, update_rel=0.02),
        "bfloat16": dict(loss_rel=0.02, grad_of_max=None, update_rel=0.2),
    },
}


def train_tol(family: str, dtype: str) -> dict:
    """``TRAIN_TOL[dtype]`` with the family's entries
    (``FAMILY_TRAIN_TOL``; those set to ``None`` are not held)."""
    tol = {**TRAIN_TOL[dtype], **FAMILY_TRAIN_TOL.get(family, {}).get(dtype, {})}
    return {k: v for k, v in tol.items() if v is not None}


def flat_numpy(tree) -> dict[str, np.ndarray]:
    """``{path: float32 or float64 numpy}`` of a tree of tensors."""
    return {k: v.detach().float().cpu().numpy() for k, v in tree_flatten_with_paths(tree)}


def encdec_frames(cfg: ModelConfig, case: dict, step: int) -> torch.Tensor:
    """Step ``step``'s encoder frames, which the file does not hold: both
    packages draw them with ``synthetic_batch`` (its float32 frames, in
    the model's dtype), whose tokens must equal the file's."""
    run = json.loads(str(case["hyper"]))
    drawn = synthetic_batch(cfg, run["seq"], run["batch"], step)
    if not np.array_equal(drawn["tokens"], case["tokens"][step]):
        raise ValueError(f"synthetic_batch's tokens of step {step} differ from the file's")
    return torch.from_numpy(drawn["frames"]).to(_dtype(cfg))


def replay_train_case(cfg: ModelConfig, tree: dict, dtype: str, case: dict, device,
                      ssd_scan: ScanFn = ops.ssd_scan) -> dict:
    """The port's run of one case on ``device``: step 0's gradient, then the
    file's steps through ``make_train_step`` on the file's batches.  Returns
    numpy arrays under the file's field names."""
    run = json.loads(str(case["hyper"]))
    hyper = TrainHyper(**run["hyper"])
    params = params_from_numpy(tree, cfg, device)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if dtype == "float32":
        params = _widen(params)
    init = flat_numpy(params)

    def batch(i):
        out = {k: torch.from_numpy(np.ascontiguousarray(case[k][i])).to(device)
               for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            out["frames"] = encdec_frames(cfg, case, i).to(device)
        return out

    _, _, grads = grads_of(params, cfg, batch(0), hyper, ssd_scan)
    g0 = flat_numpy(grads)
    step_fn = make_train_step(cfg, hyper, ssd_scan)
    opt = adamw_init(params)
    metrics = []
    for i in range(run["steps"]):
        params, opt, m = step_fn(params, opt, batch(i), i)
        metrics.append({k: float(v) for k, v in m.items()})
    post = flat_numpy(params)
    out = {k: np.asarray([m[k] for m in metrics], np.float32)
           for k in ("loss", "grad_norm", "lr")}
    for k in TRACKED[cfg.family]:
        out[f"grad/{k}"] = g0[k]
        out[f"post/{k}"] = post[k]
    for k in post:
        out[f"update_norm/{k}"] = np.float64(np.linalg.norm(
            post[k].astype(np.float64) - init[k].astype(np.float64)))
    return out


def compare_train_case(case: dict, got: dict) -> dict:
    """The largest differences between the port's replay and JAX's run, in
    ``TRAIN_TOL``'s terms."""
    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a, np.float64) - b) / np.maximum(np.abs(b), 1e-30)))

    grads = [k for k in case if k.startswith("grad/")]
    posts = [k for k in case if k.startswith("post/")]
    updates = [k for k in case if k.startswith("update_norm/")]
    if sorted(updates) != sorted(k for k in got if k.startswith("update_norm/")):
        raise AssertionError("the port's leaves differ from the file's")
    return dict(
        loss_rel=rel(got["loss"], case["loss"]),
        grad_norm_rel=rel(got["grad_norm"][0], case["grad_norm"][0]),
        lr_rel=rel(got["lr"], case["lr"]),
        grad_of_max=max(float(np.abs(got[k] - case[k]).max() / max(np.abs(case[k]).max(), 1e-30))
                        for k in grads),
        post_abs=max(float(np.abs(got[k] - case[k]).max()) for k in posts),
        update_rel=max(rel(got[k], case[k]) for k in updates),
        loss=[float(x) for x in got["loss"]],
    )


def train_case_ok(res: dict, tol: dict) -> bool:
    return all(res[k] <= v for k, v in tol.items())
