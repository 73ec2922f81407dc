"""The port's hybrid family in bfloat16, held where the whole chain cannot
hold it: Jamba-1.5-Large's smoke period (8 layers) amplifies a one-ulp
change to ~0.3 of a logit and its bfloat16 gradients lie ~0.9 of a leaf's
largest value from JAX's (``models.replay.HYBRID_TOL``,
``train.replay.FAMILY_TRAIN_TOL``), so faults are looked for block by block.

* Gradients block by block: each of the 8 blocks, fed JAX's bfloat16 input
  to that block (JAX's own chain) and one seeded bfloat16 cotangent of its
  output (and 1.0 of its MoE load-balance loss), gives JAX's gradient of
  every parameter and of its input within 4 bfloat16 steps of that leaf's
  largest |value| (measured at most 3).  JAX's side is compiled with
  ``xla_allow_excess_precision`` off, so that XLA rounds every bfloat16
  intermediate as JAX's op-by-op run and the port do (within one step of
  the op-by-op gradients).  With it on, XLA keeps a fusion's bfloat16
  intermediates in float32: that flips a near-tied expert choice at step 1
  block 3 and moves the block's expert gradients by 0.54 of their largest
  value, against JAX's op-by-op run as against the port.
* Planted faults, bfloat16 only, in every SSM + MoE block (4 of the 8
  layers): the residual branch scaled by 1.5 fails ``HYBRID_TOL`` on the
  committed model fixture, the hybrid ``train_tol`` on the committed
  training fixture and the block test; the gradient negated (forward
  unchanged, so ``HYBRID_TOL`` holds) fails the block test.  Which faults
  the whole-chain checks see at all: ``tests/torch_hybrid_fault_reach.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import MODEL_FIXTURES, TRAIN_FIXTURES, jax_flat_params, seeded_jax_params

from repro import config as jconfig
from repro.models import layers as jlayers
from repro.models import stack as jstack
from repro_torch import config as tconfig
from repro_torch.models import stack as tstack
from repro_torch.models.params import params_from_numpy, tensor_from_numpy
from repro_torch.models.replay import (
    HYBRID_TOL,
    compare_model_case,
    load_model_replay,
    model_case_ok,
    replay_model_case,
    seeded_params,
)
from repro_torch.train.replay import (
    compare_train_case,
    replay_train_case,
    train_case_ok,
    train_tol,
)
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map

ARCH = "jamba_1_5_large_398b"
GRAD_STEPS = 4      # bfloat16 steps of a leaf's largest |gradient|


@functools.cache
def _jax_block_grads() -> list:
    """JAX's run of the smoke period block by block in bfloat16 on the
    committed model fixture's weights and prompts: per block (step s,
    block i), its input, the cotangent of its output and the gradients
    (``{leaf path: array}``, the input's under ``"x"``)."""
    jcfg = jconfig.get_smoke_arch(ARCH)
    jp = seeded_jax_params(jcfg)
    _, _, cases = load_model_replay(MODEL_FIXTURES[ARCH])
    tokens = cases["bfloat16"]["tokens"]
    x = jlayers.embed_tokens(jp["embed"], jnp.asarray(tokens))
    pos = jnp.broadcast_to(jnp.arange(tokens.shape[1])[None], tokens.shape)
    _, (g,) = jstack.plan_groups(jcfg)
    def grads_of(bd):
        def block(bp, x):
            y, _, aux = jstack._apply_block(bp, jcfg, bd, x, pos, "train", None, None, None)
            return y, aux

        def run(bp, x, ct):
            (y, aux), vjp = jax.vjp(block, bp, x)
            return (y, *vjp((ct, jnp.ones_like(aux))))
        return jax.jit(run, compiler_options={"xla_allow_excess_precision": False})

    runs = [grads_of(bd) for bd in g.blocks]
    rng = np.random.default_rng(7)
    out = []
    for s in range(g.steps):
        for i, bd in enumerate(g.blocks):
            ct = jnp.asarray(rng.standard_normal(x.shape), jnp.bfloat16)
            y, gb, gx = runs[i](jax.tree.map(lambda a: a[s], jp["dec"]["g0"][f"blk{i}"]), x, ct)
            grads = {k: np.asarray(v, np.float32) for k, v in jax_flat_params(gb).items()}
            grads["x"] = np.asarray(gx, np.float32)
            out.append(dict(s=s, i=i, bd=bd, x=np.asarray(x), ct=np.asarray(ct), pos=np.asarray(pos),
                            grads=grads))
            x = y
    return out


def _block_grad_misses() -> list:
    """The port's gradients of every block, fed what ``_jax_block_grads``
    fed JAX's, through ``tstack._apply_block`` as it stands: the (block,
    leaf, distance in ``GRAD_STEPS``' steps) of every leaf outside."""
    tcfg = tconfig.get_smoke_arch(ARCH)
    tp = params_from_numpy(seeded_params(tcfg, 0), tcfg, "cpu")
    misses = []
    for rec in _jax_block_grads():
        bp = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      tstack._index(tp["dec"]["g0"][f"blk{rec['i']}"], rec["s"]))
        x = tensor_from_numpy(rec["x"], torch.bfloat16, "cpu").requires_grad_(True)
        y, _, aux = tstack._apply_block(bp, tcfg, rec["bd"], x, torch.from_numpy(rec["pos"].astype(
            np.int32)), "train", None, None)
        outs, cts = [y], [tensor_from_numpy(rec["ct"], torch.bfloat16, "cpu")]
        if torch.is_tensor(aux):
            outs.append(aux)
            cts.append(torch.ones_like(aux))
        leaves = tree_flatten_with_paths(bp) + [("x", x)]
        got = torch.autograd.grad(outs, [v for _, v in leaves], cts, allow_unused=True)
        assert sorted(k for k, _ in leaves) == sorted(rec["grads"])
        for (k, v), gt in zip(leaves, got):
            want = rec["grads"][k]
            have = np.zeros_like(want) if gt is None else gt.float().numpy()
            step = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
            dist = float(np.abs(have - want).max() / step)
            if dist > GRAD_STEPS:
                misses.append((f"step {rec['s']} block {rec['i']}", k, dist))
    return misses


def test_block_grads_in_bfloat16_match_jax_fed_jax_inputs():
    assert _block_grad_misses() == []


class _NegatedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def _plant(monkeypatch, fault: str) -> None:
    """``fault`` in every bfloat16 SSM + MoE block (blocks 1 and 3 of each
    step: 4 of the 8 layers): ``"scaled"`` multiplies its residual branch
    by 1.5, ``"negated"`` negates the gradient of its output."""
    plain = tstack._apply_block

    def apply_block(bp, cfg, bd, x, *args, **kw):
        y, cache, aux = plain(bp, cfg, bd, x, *args, **kw)
        if x.dtype == torch.bfloat16 and (bd.mixer, bd.ffn) == ("ssm", "moe"):
            y = x + (y - x) * 1.5 if fault == "scaled" else _NegatedGrad.apply(y)
        return y, cache, aux

    monkeypatch.setattr(tstack, "_apply_block", apply_block)


def _model_replay_ok() -> bool:
    cfg, tree, cases = load_model_replay(MODEL_FIXTURES[ARCH])
    tol = HYBRID_TOL["bfloat16"]
    case = cases["bfloat16"]
    return model_case_ok(compare_model_case(case, replay_model_case(cfg, tree, "bfloat16", case,
                                                                    "cpu"), tol), tol)


def _train_replay_ok() -> bool:
    cfg, tree, cases = load_model_replay(TRAIN_FIXTURES[ARCH])
    case = cases["bfloat16"]
    res = compare_train_case(case, replay_train_case(cfg, tree, "bfloat16", case, "cpu"))
    return train_case_ok(res, train_tol(cfg.family, "bfloat16"))


def test_planted_scaled_block_fails_every_bf16_check(monkeypatch):
    """The SSM + MoE blocks' residual branch times 1.5 in bfloat16 fails
    the whole-chain checks (``HYBRID_TOL``, the hybrid ``train_tol``) and
    the block test."""
    assert _model_replay_ok() and _train_replay_ok()
    _plant(monkeypatch, "scaled")
    assert not _model_replay_ok()
    assert not _train_replay_ok()
    assert _block_grad_misses()


def test_planted_negated_gradient_fails_the_block_test(monkeypatch):
    """The SSM + MoE blocks' gradient negated in bfloat16 (the forward pass
    unchanged, so the model fixture still replays within ``HYBRID_TOL``):
    the block test finds every SSM + MoE block's parameters and input."""
    _plant(monkeypatch, "negated")
    assert _model_replay_ok()
    missed = {(blk, k) for blk, k, _ in _block_grad_misses()}
    for rec in _jax_block_grads():
        if rec["bd"].ffn == "moe":
            assert (f"step {rec['s']} block {rec['i']}", "x") in missed
            assert (f"step {rec['s']} block {rec['i']}", "mixer/w_in") in missed
