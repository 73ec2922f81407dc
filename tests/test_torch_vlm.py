"""The port's VLM patch prefix (``models/model.py::_decoder_input``)
against the JAX package's, on InternVL2-2B's smoke config (2 layers
behind 8 patch embeddings), inputs made with numpy from a seed.

* ``forward`` with patches: the text offset is the patch count, positions
  run over patches and text, hidden states within 2e-5 in float32 (JAX's
  weights from ``PRNGKey(0)``); the patches are cast to the embedding
  dtype (float32 patches give a bfloat16 model the bits of bfloat16 ones).
* ``prefill`` and ``decode_step`` from position P+S: the committed
  fixture's weights and JAX's fresh run of it (``model_fixture``), within
  ``VLM_TOL`` in float32 and bfloat16; the K/V hold P+S positions.
* ``loss_fn`` over the text alone (``hidden[:, P:]``) and every gradient
  against ``jax.value_and_grad`` in float32: loss within 1e-6 relative,
  each gradient within 1e-4 of its leaf's largest |value|.
* ``chunked_ce`` on a text of 1,100 positions (chunks of 550, the largest
  divisor at most ``LOSS_CHUNK``) against JAX's within 1e-6 relative.
* The committed fixture equals a fresh JAX run, stays small, and replays
  here within ``VLM_TOL``.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MODEL_FIXTURES, jax_flat_params, model_fixture, vlm_patches

from repro import config as jconfig
from repro.models import model as jmodel
from repro_torch import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.models.params import params_from_numpy
from repro_torch.models.replay import (
    VLM_TOL,
    _widen,
    compare_model_case,
    load_model_replay,
    model_case_ok,
    replay_model_case,
    seeded_params,
)
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map

ARCH = "internvl2_2b"
B, S = 2, 12


def _np(t):
    return t.detach().float().numpy()


@functools.cache
def _jax_f32_model():
    jcfg = dataclasses.replace(jconfig.get_smoke_arch(ARCH), dtype="float32")
    return jcfg, jmodel.init_model(jax.random.PRNGKey(0), jcfg)


def _model():
    """(JAX config, JAX params, port config, port params), float32."""
    jcfg, jp = _jax_f32_model()
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _inputs(jcfg, seed: int):
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return tokens, vlm_patches(jcfg, B, seed)


def test_forward_with_patches_matches_jax():
    jcfg, jp, tcfg, tp = _model()
    tokens, patches = _inputs(jcfg, 3)
    jh, jaux, _, joff = jmodel.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                                  "patches": jnp.asarray(patches)})
    th, taux, caches, toff = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens),
                                                       "patches": torch.from_numpy(patches)})
    assert toff == joff == jcfg.frontend_seq == 8 and caches is None
    assert th.shape == (B, jcfg.frontend_seq + S, jcfg.d_model)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=2e-5, atol=2e-5)
    # without patches a VLM runs its text alone, offset 0
    th0, _, _, off0 = tmodel.forward(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert off0 == 0 and th0.shape == (B, S, jcfg.d_model)


def test_patches_take_the_embedding_dtype():
    """A bfloat16 model given float32 patches runs on their bfloat16
    rounding, as JAX's ``astype`` does."""
    cfg = tconfig.get_smoke_arch(ARCH)
    params = params_from_numpy(seeded_params(cfg, 0), cfg, "cpu")
    tokens, _ = _inputs(cfg, 4)
    wide = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
    a = tmodel.forward(params, cfg, {"tokens": torch.from_numpy(tokens), "patches": wide})[0]
    b = tmodel.forward(params, cfg, {"tokens": torch.from_numpy(tokens),
                                     "patches": wide.to(torch.bfloat16)})[0]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_from_p_plus_s_match_jax(dtype):
    """The fixture's weights, prompts and patches: prefill logits and K/V
    (P+S positions), then the greedy decode steps from position P+S on the
    K/V padded, against JAX's fresh run."""
    jcfg, cases = model_fixture(ARCH)
    smoke = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    cfg = dataclasses.replace(smoke, dtype=dtype)
    params = params_from_numpy(seeded_params(smoke, 0), smoke, "cpu")
    if dtype == "float32":
        params = _widen(params)
    case, tol = cases[dtype], VLM_TOL[dtype]
    tokens, patches = torch.from_numpy(case["tokens"]), torch.from_numpy(case["patches"])
    b, s = tokens.shape
    length = patches.shape[1] + s
    logits, caches = tmodel.prefill(params, cfg, {"tokens": tokens, "patches": patches})
    np.testing.assert_allclose(_np(logits[:, 0]), case["prefill_logits"], rtol=0,
                               atol=tol["logits"])
    for n in ("k", "v"):
        got = caches[0]["blk0"][n]
        assert got.shape == (cfg.num_layers, b, length, cfg.num_kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(_np(got), case[f"cache/g0/blk0/{n}"], rtol=0,
                                   atol=tol["cache"])
    steps = len(case["fed"])
    kv = {n: torch.cat([t, t.new_zeros((*t.shape[:2], steps, *t.shape[3:]))], dim=2)
          for n, t in caches[0]["blk0"].items()}
    pos = torch.full((b,), length, dtype=torch.int32)
    for step, fed in enumerate(case["fed"]):
        out, new = tmodel.decode_step(params, cfg, torch.from_numpy(fed[:, None].copy()), pos,
                                      [{"blk0": kv}])
        assert new[0]["blk0"]["k"] is kv["k"]
        np.testing.assert_allclose(_np(out[:, 0]), case["logits"][step], rtol=0,
                                   atol=tol["logits"], err_msg=f"step {step}")
        assert bool((kv["k"][:, :, length + step] != 0).any())
        pos = pos + 1


@functools.cache
def _jax_loss_and_grads():
    jcfg, jp = _jax_f32_model()
    tokens, patches = _inputs(jcfg, 6)
    batch = {"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches),
             "labels": jnp.asarray(np.roll(tokens, -1, axis=1))}
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch), has_aux=True))(jp)
    return float(loss), float(met["ce"]), jax_flat_params(g)


def test_loss_over_the_text_and_grads_match_jax():
    jcfg, _, tcfg, tp = _model()
    jloss, jce, jflat = _jax_loss_and_grads()
    tokens, patches = _inputs(jcfg, 6)
    batch = {"tokens": torch.from_numpy(tokens), "patches": torch.from_numpy(patches),
             "labels": torch.from_numpy(np.roll(tokens, -1, axis=1))}
    live = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, met = tmodel.loss_fn(live, tcfg, batch)
    leaves = tree_flatten_with_paths(live)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-6)
    assert float(met["ce"].detach()) == pytest.approx(jce, rel=1e-6)
    assert float(met["aux"]) == 0.0
    # the CE is over the S text positions alone: a label per text token
    hidden, _, _, offset = tmodel.forward(tp, tcfg, batch)
    want = tmodel.chunked_ce(tp, tcfg, hidden[:, offset:], batch["labels"])
    assert torch.equal(met["ce"].detach(), want.detach())
    assert sorted(jflat) == sorted(k for k, _ in leaves)
    for (k, _), g in zip(leaves, grads):
        scale = max(float(np.abs(jflat[k]).max()), 1e-30)
        assert float(np.abs(_np(g) - jflat[k]).max()) <= 1e-4 * scale, k


def test_chunked_ce_chunks_as_jax():
    """A text of 1,100 positions: both cut it in chunks of 550 (the largest
    divisor of 1,100 at most 1,024) and sum them in order."""
    jcfg, jp, tcfg, tp = _model()
    rng = np.random.default_rng(7)
    hidden = rng.standard_normal((1, 1100, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (1, 1100)).astype(np.int32)
    mask = (rng.random((1, 1100)) < 0.9).astype(np.float32)
    want = jmodel.chunked_ce(jp, jcfg, jnp.asarray(hidden), jnp.asarray(labels), jnp.asarray(mask))
    got = tmodel.chunked_ce(tp, tcfg, torch.from_numpy(hidden), torch.from_numpy(labels),
                            torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# The committed fixture that chip_smoke.py replays on the card
# ---------------------------------------------------------------------------

def test_committed_vlm_fixture_equals_regenerated():
    jcfg, cases = model_fixture(ARCH)
    cfg, _, committed = load_model_replay(MODEL_FIXTURES[ARCH])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert sorted(committed) == sorted(cases) == ["bfloat16", "float32"]
    for name, fields in cases.items():
        assert sorted(committed[name]) == sorted(fields) and "patches" in fields
        for k, v in fields.items():
            assert committed[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(committed[name][k], v, err_msg=f"{name}.{k}")


def test_vlm_fixture_is_small():
    assert os.path.getsize(MODEL_FIXTURES[ARCH]) < 300_000


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_fixture_replays_on_cpu(dtype):
    cfg, tree, cases = load_model_replay(MODEL_FIXTURES[ARCH])
    res = compare_model_case(cases[dtype], replay_model_case(cfg, tree, dtype, cases[dtype], "cpu"),
                             VLM_TOL[dtype])
    assert model_case_ok(res, VLM_TOL[dtype]), res
