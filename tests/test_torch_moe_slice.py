"""The port's MoE family as a whole against the JAX package's: both MoE
smoke configs (DeepSeek-V2-Lite's MLA + MoE with a dense first layer, and
Qwen3-MoE's GQA with QK-norm + MoE), JAX's weights carried across by
``params_from_numpy``, inputs made with numpy from a seed.

* ``decode_cache_specs`` equal JAX's (the MLA ``latent`` rows).
* ``prefill`` and ``decode_step`` in float32: logits and caches within
  2e-5, the same greedy tokens (prefill takes the grouped dispatch, S = 24
  >= E; decode the global one).
* ``loss_fn``'s loss, ``aux`` and every gradient against
  ``jax.value_and_grad`` in float32, with remat on and off.
* The committed fixtures ``moe_<arch>_smoke.npz`` that ``chip_smoke.py``
  replays on the card equal a fresh JAX run, stay small, and replay here
  within ``repro_torch.models.replay.MOE_TOL``.

The functions of ``models/moe.py`` and MLA alone are in
``test_torch_moe.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MOE_FIXTURES, MOE_STEPS, jax_flat_params, jax_moe_run, moe_fixture

from repro import config as jconfig
from repro.models import model as jmodel
from repro_torch import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.models.params import params_from_numpy
from repro_torch.models.replay import (
    MOE_TOL,
    compare_moe_case,
    load_model_replay,
    moe_case_ok,
    pad_caches,
    replay_moe_case,
)
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map

ARCHS = ("deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=ARCHS)
def f32_model(request):
    """(arch, JAX config, port config, JAX params, port params): the
    float32 smoke config, JAX's weights from ``PRNGKey(0)``."""
    jcfg = dataclasses.replace(jconfig.get_smoke_arch(request.param), dtype="float32")
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    return request.param, jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                                            tcfg, "cpu")


def test_decode_cache_specs_match_jax(f32_model):
    _, jcfg, tcfg, _, _ = f32_model
    jstructs, _ = jmodel.decode_cache_specs(jcfg, 2, 32)
    specs = tmodel.decode_cache_specs(tcfg, 2, 32)
    assert len(specs) == len(jstructs)
    for tg, jg in zip(specs, jstructs):
        for blk, names in jg.items():
            assert sorted(tg[blk]) == sorted(names)
            for n, js in names.items():
                assert tg[blk][n].shape == js.shape
                assert str(tg[blk][n].dtype) == "torch." + str(js.dtype)


def test_prefill_and_decode_match_jax(f32_model):
    """Prefill logits and caches, then MOE_STEPS greedy decode steps on
    the caches zero-padded (``pad_caches``): logits within 2e-5, the same
    tokens.  Prefill takes the grouped dispatch (S = 24 >= E), decode the
    global one."""
    _, jcfg, tcfg, jp, tp = f32_model
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want = jax_moe_run(jcfg, jp, tokens, MOE_STEPS)
    logits, caches = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(_np(logits[:, 0]), want["prefill_logits"], rtol=0, atol=2e-5)
    names = [k for k in want if k.startswith("cache/")]
    assert names
    for k in names:
        _, g, blk, n = k.split("/")
        np.testing.assert_allclose(_np(caches[int(g[1:])][blk][n]), want[k], rtol=0, atol=2e-5,
                                   err_msg=k)
    caches = pad_caches(caches, 24 + MOE_STEPS)
    tok = torch.from_numpy(tokens[:, -1:])
    pos = torch.full((2,), 24, dtype=torch.int32)
    fed = []
    for step in range(MOE_STEPS):
        fed.append(tok[:, 0].numpy())
        out, caches = tmodel.decode_step(tp, tcfg, tok, pos, caches)
        np.testing.assert_allclose(_np(out[:, 0]), want["logits"][step], rtol=0, atol=2e-5,
                                   err_msg=f"step {step}")
        tok = out[:, 0].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    np.testing.assert_array_equal(np.stack(fed), want["fed"])


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(f32_model, remat):
    """``loss_fn`` (CE + 0.01 x aux) and its gradient of every leaf,
    float32: loss and aux within 1e-6 relative, each gradient within 1e-4
    of its leaf's largest |value| (the embedding's scatter-add and the
    attention backward sum in other orders)."""
    _, jcfg, tcfg, jp, tp = f32_model
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    (jloss, jmet), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                 remat=remat), has_aux=True)(jp)
    live = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, met = tmodel.loss_fn(live, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()},
                               remat=remat)
    leaves = tree_flatten_with_paths(live)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    assert float(met["aux"].detach()) > 0
    for got, want in ((loss, jloss), (met["aux"], jmet["aux"]), (met["ce"], jmet["ce"])):
        assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    jflat = jax_flat_params(jg)
    assert sorted(jflat) == sorted(k for k, _ in leaves)
    for (k, _), g in zip(leaves, grads):
        scale = max(float(np.abs(jflat[k]).max()), 1e-30)
        assert float(np.abs(_np(g) - jflat[k]).max()) <= 1e-4 * scale, k


# ---------------------------------------------------------------------------
# The committed fixtures that chip_smoke.py replays on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_committed_moe_fixture_equals_regenerated(arch):
    jcfg, cases = moe_fixture(arch)
    cfg, _, committed = load_model_replay(MOE_FIXTURES[arch])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert sorted(committed) == sorted(cases) == ["bfloat16", "float32"]
    for name, fields in cases.items():
        assert sorted(committed[name]) == sorted(fields)
        for k, v in fields.items():
            assert committed[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(committed[name][k], v, err_msg=f"{name}.{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fixture_is_small(arch):
    assert os.path.getsize(MOE_FIXTURES[arch]) < 300_000


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fixture_replays_on_cpu(arch, dtype):
    cfg, tree, cases = load_model_replay(MOE_FIXTURES[arch])
    res = compare_moe_case(cases[dtype], replay_moe_case(cfg, tree, dtype, cases[dtype], "cpu"),
                           MOE_TOL[dtype])
    assert moe_case_ok(res, MOE_TOL[dtype]), res
