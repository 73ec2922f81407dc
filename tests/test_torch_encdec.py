"""The port's encoder-decoder family (``models/model.py::_encode``, the
cross-attention block of ``models/stack.py``) against the JAX package's, on
SeamlessM4T-medium's smoke config (2 encoder and 2 decoder layers over 16
frames), the same ``seeded_params`` weights, frames and tokens made with
numpy from a seed:

* the encoder's output within 1e-4 in float32; it is non-causal: a change to
  the last frame moves the first frame's output, as in JAX; the non-causal
  flash path (over ``FLASH_THRESHOLD`` frames) against JAX's;
* ``decode_cache_specs`` with ``enc_seq`` equal JAX's; on the committed
  fixture's inputs, prefill logits and every cache leaf (``cross_k``/
  ``cross_v`` included), then 6 greedy decode steps on the caches (the K/V
  padded in their own dtype), in float32 (1e-4) and bfloat16
  (``ENCDEC_TOL``), with the cross K/V carried through decode unchanged and
  the K/V written in place;
* the loss and every gradient against ``jax.value_and_grad`` in float32,
  with remat off and on (the port's two bitwise equal);
* the committed ``encdec_seamless_m4t_medium_smoke.npz`` equals a fresh JAX
  run, stays small, and replays here within ``ENCDEC_TOL``.

Each JAX run is made once per process (``functools.cache``).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MODEL_FIXTURES, jax_flat_params, model_fixture, seeded_jax_params

from repro import config as jconfig
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import config as tconfig
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models.params import params_from_numpy
from repro_torch.models.replay import (
    ENCDEC_TOL,
    _widen,
    compare_model_case,
    load_model_replay,
    model_case_ok,
    pad_caches,
    replay_model_case,
    seeded_params,
)
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map

ARCH = "seamless_m4t_medium"
B, S = 2, 12
TOL = {"float32": 1e-4}


def _np(t):
    return t.detach().float().numpy()


def _dt(dtype):
    return torch.bfloat16 if dtype == "bfloat16" else torch.float32


@functools.cache
def _model(dtype: str):
    """(JAX config, JAX params, port config, port params): the smoke
    config's ``seeded_params`` (bfloat16), widened exactly for float32."""
    smoke = jconfig.get_smoke_arch(ARCH)
    jcfg = dataclasses.replace(smoke, dtype=dtype)
    jp = seeded_jax_params(smoke)
    tsmoke = tconfig.ModelConfig(**dataclasses.asdict(smoke))
    tp = params_from_numpy(seeded_params(tsmoke, 0), tsmoke, "cpu")
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = _widen(tp)
    return jcfg, jp, dataclasses.replace(tsmoke, dtype=dtype), tp


def _inputs(jcfg, seed: int):
    """Tokens (B, S) and frames (B, 16, d_model) of bfloat16 values, float32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    frames = np.asarray(jnp.asarray(rng.standard_normal((B, jcfg.frontend_seq, jcfg.d_model)),
                                    jnp.bfloat16), np.float32)
    return tokens, frames


@functools.cache
def _jax_encode(seed: int, last_frame_shift: float = 0.0):
    jcfg, jp, _, _ = _model("float32")
    _, frames = _inputs(jcfg, seed)
    frames = frames.copy()
    frames[:, -1] += last_frame_shift
    return np.asarray(jmodel._encode(jp, jcfg, jnp.asarray(frames), False))


def test_encoder_matches_jax_and_is_not_causal():
    jcfg, _, tcfg, tp = _model("float32")
    _, frames = _inputs(jcfg, 1)
    got = tmodel._encode(tp, tcfg, torch.from_numpy(frames), False)
    want = _jax_encode(1)
    assert got.shape == (B, jcfg.frontend_seq, jcfg.d_model)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL["float32"])
    shifted = frames.copy()
    shifted[:, -1] += 1.0
    moved = tmodel._encode(tp, tcfg, torch.from_numpy(shifted), False)
    first = float((moved[:, 0] - got[:, 0]).abs().max())
    jfirst = float(np.abs(_jax_encode(1, 1.0)[:, 0] - want[:, 0]).max())
    assert first > 1e-3 and jfirst > 1e-3
    np.testing.assert_allclose(_np(moved), _jax_encode(1, 1.0), rtol=0, atol=TOL["float32"])
    with pytest.raises(ValueError, match="frames"):   # JAX's scan refuses another dtype
        tmodel._encode(tp, tcfg, torch.from_numpy(frames).to(torch.bfloat16), False)


def test_non_causal_flash_attention_matches_jax():
    """Over ``FLASH_THRESHOLD`` positions ``gqa_forward`` takes the flash
    path; non-causal, every query sees every key, as in JAX."""
    jcfg, jp, tcfg, tp = _model("float32")
    jm = jax.tree.map(lambda a: a[0], jp["enc"]["g0"]["blk0"]["mixer"])
    tm = {k: w[0] for k, w in tp["enc"]["g0"]["blk0"]["mixer"].items()}
    n = 2 * tattn.FLASH_THRESHOLD
    x = (np.random.default_rng(2).standard_normal((1, n, jcfg.d_model)) * 0.1).astype(np.float32)
    pos = np.arange(n, dtype=np.int32)[None]
    jy, _ = jattn.gqa_forward(jm, jcfg, jnp.asarray(x), jnp.asarray(pos), causal=False)
    ty, _ = tattn.gqa_forward(tm, tcfg, torch.from_numpy(x), torch.from_numpy(pos), causal=False)
    want = np.asarray(jy)
    np.testing.assert_allclose(_np(ty), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    causal, _ = tattn.gqa_forward(tm, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    assert float((causal[0, 0] - ty[0, 0]).abs().max()) > 1e-3


def test_decode_cache_specs_match_jax():
    jcfg, _, tcfg, _ = _model("bfloat16")
    for kv_int8 in (False, True):
        jstructs, _ = jmodel.decode_cache_specs(jcfg, 2, 32, 16, kv_int8)
        specs = tmodel.decode_cache_specs(tcfg, 2, 32, 16, kv_int8)
        want = {n: (tuple(sp.shape), np.dtype(sp.dtype).name)
                for n, sp in jstructs[0]["blk0"].items()}
        got = {n: (sp.shape, str(sp.dtype).removeprefix("torch."))
               for n, sp in specs[0]["blk0"].items()}
        assert got == want
        assert got["cross_k"] == ((jcfg.num_layers, 2, 16, 4, 16), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """The committed fixture's weights, prompts and frames, against JAX's
    fresh run of it (``model_fixture``, shared with the fixture test)."""
    jcfg, _, tcfg, tp = _model(dtype)
    tol = {"float32": dict(logits=1e-4, cache=1e-4), "bfloat16": ENCDEC_TOL["bfloat16"]}[dtype]
    case = model_fixture(ARCH)[1][dtype]
    tokens, frames = case["tokens"], case["frames"]
    b, s = tokens.shape
    logits, caches = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens),
                                               "frames": torch.from_numpy(frames).to(_dt(dtype))})
    np.testing.assert_allclose(_np(logits[:, 0]), case["prefill_logits"], rtol=0,
                               atol=tol["logits"])
    assert sorted(caches[0]["blk0"]) == ["cross_k", "cross_v", "k", "v"]
    for n, got in caches[0]["blk0"].items():
        want = case[f"cache/g0/blk0/{n}"]
        assert got.dtype == _dt(dtype) and tuple(got.shape) == want.shape, n
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol["cache"], err_msg=n)
    assert caches[0]["blk0"]["cross_k"].shape[2] == jcfg.frontend_seq
    dcaches = pad_caches(caches, s + len(case["fed"]))
    given = dict(dcaches[0]["blk0"])
    assert given["cross_k"] is caches[0]["blk0"]["cross_k"]   # not padded: the frames'
    cross = {n: given[n].clone() for n in ("cross_k", "cross_v")}
    pos = torch.full((b,), s, dtype=torch.int32)
    for step, fed in enumerate(case["fed"]):
        out, dcaches = tmodel.decode_step(tp, tcfg, torch.from_numpy(fed[:, None].copy()), pos,
                                          dcaches)
        np.testing.assert_allclose(_np(out[:, 0]), case["logits"][step], rtol=0,
                                   atol=tol["logits"], err_msg=f"step {step}")
        assert bool((given["k"][:, :, s + step] != 0).any())
        pos = pos + 1
    assert all(dcaches[0]["blk0"][n] is t for n, t in given.items())   # in place
    for n, t in cross.items():
        assert torch.equal(dcaches[0]["blk0"][n], t), n


@functools.cache
def _jax_loss_and_grads():
    jcfg, jp, _, _ = _model("float32")
    tokens, frames = _inputs(jcfg, 6)
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames),
             "labels": jnp.asarray(np.roll(tokens, -1, axis=1))}
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch), has_aux=True))(jp)
    return float(loss), float(met["ce"]), jax_flat_params(g)


# Each gradient within GRAD_TOL of its leaf's largest |value|, as the other
# families' ``train.replay.TRAIN_TOL`` holds step 0's gradients: the large
# scores of the smoke weights (``ENCDEC_TOL``'s note) amplify the float32
# roundoff of the backward pass past the 1e-4 that the VLM's test holds
# (measured here 1.53e-4, at ``dec/g0/blk0/ln2/scale``).
GRAD_TOL = 2e-4


def test_loss_and_grads_match_jax_with_remat_off_and_on():
    jcfg, _, tcfg, tp = _model("float32")
    jloss, jce, jflat = _jax_loss_and_grads()
    tokens, frames = _inputs(jcfg, 6)
    batch = {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(frames),
             "labels": torch.from_numpy(np.roll(tokens, -1, axis=1))}
    runs = []
    for remat in (False, True):
        live = tree_map(lambda p: p.detach().requires_grad_(True), tp)
        loss, met = tmodel.loss_fn(live, tcfg, batch, remat=remat)
        leaves = tree_flatten_with_paths(live)
        grads = torch.autograd.grad(loss, [v for _, v in leaves])
        assert float(loss.detach()) == pytest.approx(jloss, rel=1e-6)
        assert float(met["ce"].detach()) == pytest.approx(jce, rel=1e-6)
        assert sorted(jflat) == sorted(k for k, _ in leaves)
        assert {"enc/g0/blk0/mixer/w_q", "enc_norm/scale", "dec/g0/blk0/cross/w_k",
                "dec/g0/blk0/ln_cross/scale"} <= set(jflat)
        for (k, _), g in zip(leaves, grads):
            scale = max(float(np.abs(jflat[k]).max()), 1e-30)
            assert float(np.abs(_np(g) - jflat[k]).max()) <= GRAD_TOL * scale, (remat, k)
        runs.append((loss.detach(), grads))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# ---------------------------------------------------------------------------
# The committed fixture that chip_smoke.py replays on the card
# ---------------------------------------------------------------------------

def test_committed_encdec_fixture_equals_regenerated():
    jcfg, cases = model_fixture(ARCH)
    cfg, _, committed = load_model_replay(MODEL_FIXTURES[ARCH])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert sorted(committed) == sorted(cases) == ["bfloat16", "float32"]
    for name, fields in cases.items():
        assert sorted(committed[name]) == sorted(fields) and "frames" in fields
        assert "cache/g0/blk0/cross_k" in fields
        for k, v in fields.items():
            assert committed[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(committed[name][k], v, err_msg=f"{name}.{k}")


def test_encdec_fixture_is_small():
    assert os.path.getsize(MODEL_FIXTURES[ARCH]) < 300_000


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_fixture_replays_on_cpu(dtype):
    cfg, tree, cases = load_model_replay(MODEL_FIXTURES[ARCH])
    res = compare_model_case(cases[dtype], replay_model_case(cfg, tree, dtype, cases[dtype], "cpu"),
                             ENCDEC_TOL[dtype])
    assert model_case_ok(res, ENCDEC_TOL[dtype]), res
