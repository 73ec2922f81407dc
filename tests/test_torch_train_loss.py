"""The port's loss and training step against the JAX package's, on the same
weights (JAX's ``init_model`` leaves through ``params_from_numpy``) and the
same ``synthetic_batch``.

Stated tolerances (measured on this suite's inputs in brackets):

* float32 model (``dtype`` override, JAX's bfloat16 weights widened
  exactly): loss within 1e-5 relative [0 / 8e-8]; every leaf's gradient
  within 2e-4 of that leaf's largest magnitude [7.6e-5: the embedding's
  gradient is a scatter-add over repeated tokens, summed in another
  order].
* bfloat16 model: loss within 1e-3 relative [2.1e-4]; every leaf's
  gradient within 0.1 of that leaf's norm (the two frameworks round
  bfloat16 intermediates at other places) [0.044].
* ``remat`` on or off and either policy: the port's loss and gradients
  are bitwise equal (the recomputation repeats the same operations).
* One microbatched (2) step, and one step with int8 gradients, of
  ``make_train_step`` (float32): metrics within 1e-5 relative; params
  after the step within 1e-4 but for at most 0.1% of a leaf, and every one
  within 2 x lr: AdamW's first update is lr * g / (|g| + eps), whose sign
  may differ where |g| is near the gradients' roundoff [1 element of
  8,192 at 1.8e-4].
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_flat_params, nested

from repro.config import get_smoke_arch
from repro.data.pipeline import synthetic_batch as jbatch
from repro.models import init_model
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro.train import TrainHyper as JHyper
from repro.train import make_train_step as jmake_step
from repro_torch.config import ModelConfig
from repro_torch.data.pipeline import batch_to_device, synthetic_batch
from repro_torch.models import model as tmodel
from repro_torch.models.params import params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.train import TrainHyper, make_train_step
from repro_torch.train.train_step import grads_of
from repro_torch.utils.trees import tree_flatten_with_paths

ARCHS = ["granite_8b", "mamba2_370m"]
SEQ, BATCH = 32, 4


@functools.cache
def _weights(arch: str, dtype: str):
    """(JAX config, JAX params, port config, port params) in ``dtype``."""
    jcfg = dataclasses.replace(get_smoke_arch(arch), dtype=dtype)
    jp = init_model(jax.random.PRNGKey(0), get_smoke_arch(arch))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, params_from_numpy(nested(jax_flat_params(jp)), tcfg, "cpu")


@functools.cache
def _jax_loss_and_grads(arch: str, dtype: str):
    jcfg, jp, _, _ = _weights(arch, dtype)
    b = {k: jnp.asarray(v) for k, v in jbatch(jcfg, SEQ, BATCH, 0).items()}
    (loss, _), g = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, b, remat=True), has_aux=True)(jp)
    return float(loss), {k: v.astype(np.float32) for k, v in jax_flat_params(g).items()}


def _port_loss_and_grads(arch, dtype, remat, policy):
    _, _, tcfg, tp = _weights(arch, dtype)
    b = batch_to_device(synthetic_batch(tcfg, SEQ, BATCH, 0), "cpu")
    loss, met, grads = grads_of(tp, tcfg, b, TrainHyper(remat=remat, remat_policy=policy))
    assert float(met["aux"]) == 0.0 and torch.equal(met["ce"], loss)
    return loss, dict(tree_flatten_with_paths(grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch, dtype):
    jloss, jgrads = _jax_loss_and_grads(arch, dtype)
    runs = {(r, p): _port_loss_and_grads(arch, dtype, r, p)
            for r, p in ((False, "dots"), (True, "dots"), (True, "nothing"))}
    loss, grads = runs[False, "dots"]
    for key, (l2, g2) in runs.items():       # remat changes no bit
        assert torch.equal(l2, loss), key
        assert all(torch.equal(g2[k], grads[k]) for k in grads), key
    assert sorted(grads) == sorted(jgrads)
    rel = abs(float(loss) - jloss) / jloss
    assert rel <= (1e-5 if dtype == "float32" else 1e-3), rel
    for k, w in jgrads.items():
        g = grads[k].float().numpy()
        assert g.shape == w.shape, k
        if dtype == "float32":
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= 2e-4, (k, err)
        else:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 0.1, (k, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_keep_the_params_dtypes(arch):
    _, grads = _port_loss_and_grads(arch, "bfloat16", True, "dots")
    _, _, _, tp = _weights(arch, "bfloat16")
    for k, p in tree_flatten_with_paths(tp):
        assert grads[k].dtype == p.dtype, k


def test_chunked_ce_over_several_chunks_with_a_mask_matches_jax(monkeypatch):
    """LOSS_CHUNK cut to 12 in both packages: S = 32 takes chunks of 8, the
    largest divisor of 32 that is at most 12; a loss mask drops a third of
    the labels."""
    monkeypatch.setattr(jmodel, "LOSS_CHUNK", 12)
    monkeypatch.setattr(tmodel, "LOSS_CHUNK", 12)
    jcfg, jp, tcfg, tp = _weights("granite_8b", "float32")
    b = jbatch(jcfg, SEQ, BATCH, 1)
    mask = (np.random.default_rng(0).random((BATCH, SEQ)) < 0.67).astype(np.float32)
    (jloss, _), jg = jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, jcfg, {**{k: jnp.asarray(v) for k, v in b.items()}, "loss_mask": jnp.asarray(mask)}),
        has_aux=True)(jp)
    tb = {**batch_to_device(b, "cpu"), "loss_mask": torch.from_numpy(mask)}
    loss, _, grads = grads_of(tp, tcfg, tb, TrainHyper(remat=False))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    w = np.asarray(jg["embed"]["head"])
    g = grads["embed"]["head"].numpy()
    assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max()


def _one_step(arch, **hyper):
    jcfg, jp, tcfg, tp = _weights(arch, "float32")
    kw = dict(peak_lr=3e-3, warmup_steps=0, total_steps=3, **hyper)
    b = jbatch(jcfg, SEQ, BATCH, 2)
    jstep = jax.jit(jmake_step(jcfg, JHyper(**kw)))
    jp2, js2, jm = jstep(jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in b.items()}, 2)
    tp2, ts2, tm = make_train_step(tcfg, TrainHyper(**kw))(
        tp, adamw_init(tp), batch_to_device(b, "cpu"), 2)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want = jax_flat_params(jp2)
    for k, p in tree_flatten_with_paths(tp2):
        diff = np.abs(p.numpy() - want[k])
        # AdamW's first update is lr * g / (|g| + eps): where |g| is near
        # the gradients' roundoff its sign may differ, a move of up to 2 lr.
        assert diff.max() <= 2 * kw["peak_lr"], (k, diff.max())
        assert (diff > 1e-4).mean() <= 1e-3, (k, (diff > 1e-4).sum())
    assert int(ts2.step) == int(js2.step) == 1
    return tm


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_step_matches_jax(arch):
    tm = _one_step(arch, microbatches=2)
    assert float(tm["aux"]) == 0.0 and float(tm["ce"]) == float(tm["loss"])


def test_int8_gradient_step_matches_jax():
    _one_step("granite_8b", int8_grads=True)
