"""The port's Mamba2 path against the JAX package's, on the same weights
(``params_from_numpy`` of JAX's ``init_model`` leaves) and inputs made with
numpy from a seed.

* Each function of ``models/ssm.py`` and ``gated_rmsnorm`` on the float32
  smoke config, within rtol and atol 1e-5: the frameworks' products,
  cumulative sums and transcendental functions differ in the last bits.
  The prompt length, 40, is not a multiple of the chunk (16), so the
  zero-padded ragged chunk is exercised.
* The slice as a whole (``prefill``, then 6 ``decode_step``s): float32
  logits within 1e-4 and equal greedy tokens; bfloat16 teacher-forced
  logits within 0.05 and conv windows equal as bfloat16 bits
  (``repro_torch.models.replay.SSM_TOL``).
* The committed JAX fixture that ``chip_smoke.py`` replays on the card is
  regenerated and compared, and replayed here on the CPU.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SSM_FIXTURE, SSM_STEPS, jax_ssm_run, ssm_fixture

from repro import config as jconfig
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams_mod
from repro.models import ssm as jssm
from repro_torch import config as tconfig
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.models.params import param_count, params_from_numpy
from repro_torch.models.replay import (
    SSM_TOL,
    compare_ssm_case,
    load_model_replay,
    replay_ssm_case,
    ssm_case_ok,
)
from repro_torch.models.stack import _index

F32 = dict(rtol=1e-5, atol=1e-5)
ARCH = "mamba2_370m"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.float().numpy()


def _scan_kw(scan):
    """``None``: the model's default scan (``ops.ssd_scan``, its plain
    version on CPU tensors); ``"plain"``: ``ref.ssd_scan_ref`` passed in."""
    return {} if scan is None else {"ssd_scan": tref.ssd_scan_ref}


def _smoke(dtype="float32"):
    jcfg = dataclasses.replace(jconfig.get_smoke_arch(ARCH), dtype=dtype)
    return jcfg, tconfig.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def f32_model():
    """(JAX config, port config, JAX params, port params): the float32
    smoke config, JAX's weights from ``PRNGKey(0)`` carried to the port."""
    jcfg, tcfg = _smoke("float32")
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _mixer(model, layer=0):
    _, _, jp, tp = model
    return (jax.tree.map(lambda a: a[layer], jp["dec"]["g0"]["blk0"]["mixer"]),
            _index(tp["dec"]["g0"]["blk0"]["mixer"], layer))


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_arch", "get_smoke_arch"])
def test_mamba2_configs_equal_jax(getter):
    jcfg = getattr(jconfig, getter)(ARCH)
    tcfg = getattr(tconfig, getter)(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.ssm_d_inner, tcfg.ssm_nheads) == (jcfg.ssm_d_inner, jcfg.ssm_nheads)


def test_full_mamba2_defs_equal_jax():
    """Every leaf's shape, axes, init, scale and dtype (float32 for
    ``a_log``, ``dt_bias``, ``d_skip``; bfloat16 for the rest)."""
    jcfg, tcfg = jconfig.get_arch(ARCH), tconfig.get_arch(ARCH)
    jdefs, tdefs = jmodel.model_param_defs(jcfg), tmodel.model_param_defs(tcfg)
    assert param_count(tdefs) == jparams_mod.param_count(jdefs)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, jparams_mod.ParamDef))[0]
    assert len(jleaves) == 12
    for path, jd in jleaves:
        td = tdefs
        for p in path:
            td = td[p.key]
        assert (td.shape, td.axes, td.init, td.scale) == (jd.shape, jd.axes, jd.init, jd.scale)
        want = torch.float32 if jd.dtype == jnp.float32 else torch.bfloat16
        assert td.dtype == want, path


def test_params_from_numpy_keeps_float32_leaves_and_bfloat16_bits():
    jcfg, tcfg = _smoke("bfloat16")
    jp = jmodel.init_model(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jm, tm = jp["dec"]["g0"]["blk0"]["mixer"], tp["dec"]["g0"]["blk0"]["mixer"]
    for name in ("a_log", "dt_bias", "d_skip"):
        assert tm[name].dtype == torch.float32
        np.testing.assert_array_equal(tm[name].numpy(), np.asarray(jm[name]))
    assert tm["w_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tm["w_in"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jm["w_in"]).view(np.uint16))


# ---------------------------------------------------------------------------
# Functions of models/ssm.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, gate = (rng.standard_normal((2, 5, 32)).astype(np.float32) for _ in range(2))
    scale = rng.standard_normal(32).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jlayers.gated_rmsnorm({"scale": jnp.asarray(scale, jdt)}, jnp.asarray(x, jdt),
                                 jnp.asarray(gate, jdt), 1e-5)

    def t(a):
        return _t(np.asarray(jnp.asarray(a, jdt), np.float32)).to(tdt)

    got = tlayers.gated_rmsnorm({"scale": t(scale)}, t(x), t(gate), 1e-5)
    assert got.dtype == tdt
    # bfloat16: both compute in float32 and round once; a float32 result
    # that differs in its last bits can round to the neighbouring value
    tol = F32 if dtype == "float32" else dict(rtol=2**-8, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def test_causal_conv_and_segsum_match_jax(f32_model):
    jm, tm = _mixer(f32_model)
    rng = np.random.default_rng(1)
    x_bc = rng.standard_normal((2, 40, tm["conv_w"].shape[1])).astype(np.float32)
    np.testing.assert_allclose(_np(tssm._causal_conv(tm, _t(x_bc))),
                               np.asarray(jssm._causal_conv(jm, jnp.asarray(x_bc))), **F32)
    a = -rng.random((2, 3, 4, 16)).astype(np.float32)
    got, want = _np(tssm._segsum(_t(a))), np.asarray(jssm._segsum(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **F32)


@pytest.mark.parametrize("scan", [None, "plain"])
@pytest.mark.parametrize("with_init", [True, False])
def test_ssd_chunked_matches_jax(with_init, scan):
    """S = 40 with chunk 16 (a ragged last chunk), 4 heads of 8, state 16,
    decays of a trained model's range (dt*A down to -1), an initial state."""
    rng = np.random.default_rng(2)
    b, s, h, p, g, n = 2, 40, 4, 8, 1, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, g, n)).astype(np.float32) for _ in range(2))
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_init else None
    jy, jfinal = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), 16,
                                  None if init is None else jnp.asarray(init))
    ty, tfinal = tssm.ssd_chunked(*map(_t, (x, dt, a, bm, cm)), 16,
                                  None if init is None else _t(init), **_scan_kw(scan))
    assert ty.shape == (b, s, h, p) and tfinal.shape == (b, h, p, n)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(tfinal), np.asarray(jfinal), **F32)


def test_ssm_forward_and_decode_match_jax(f32_model):
    """A block's prefill over 40 tokens from an initial state, then one
    decode step from the prefill's states (conv window cast to bfloat16,
    as ``prefill`` stores it)."""
    jcfg, tcfg, _, _ = f32_model
    jm, tm = _mixer(f32_model, layer=1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    init = rng.standard_normal((2, jcfg.ssm_nheads, jcfg.ssm_headdim, jcfg.ssm_state))
    init = init.astype(np.float32)
    jy, jst = jssm.ssm_forward(jm, jcfg, jnp.asarray(x),
                               jssm.SSMState(conv=None, ssd=jnp.asarray(init)))
    ty, tst = tssm.ssm_forward(tm, tcfg, _t(x), tssm.SSMState(conv=None, ssd=_t(init)))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(tst.conv), np.asarray(jst.conv), **F32)
    np.testing.assert_allclose(_np(tst.ssd), np.asarray(jst.ssd), **F32)

    xd = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    jconv = jst.conv.astype(jnp.bfloat16)
    tconv = torch.from_numpy(np.array(jconv).view(np.int16)).view(torch.bfloat16)
    tssd = _t(np.asarray(jst.ssd))
    jy, jst = jssm.ssm_decode(jm, jcfg, jnp.asarray(xd), jssm.SSMState(conv=jconv, ssd=jst.ssd))
    ty, tst = tssm.ssm_decode(tm, tcfg, _t(xd), tssm.SSMState(conv=tconv, ssd=tssd))
    assert tst.conv.dtype == torch.float32 and np.asarray(jst.conv).dtype == np.float32
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(tst.conv), np.asarray(jst.conv), **F32)
    np.testing.assert_allclose(_np(tst.ssd), np.asarray(jst.ssd), **F32)


def test_prefill_runs_the_scan_it_is_given(f32_model):
    """``prefill(..., ssd_scan=f)`` calls ``f`` once a layer, on the
    chunked states, and its result is what the model uses."""
    _, tcfg, _, tparams = f32_model
    shapes = []

    def scan(states, decay, init):
        shapes.append((tuple(states.shape), tuple(decay.shape), init))
        return tref.ssd_scan_ref(states, decay, init)

    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (2, 40)).astype(np.int32))
    got, _ = tmodel.prefill(tparams, tcfg, {"tokens": tokens}, ssd_scan=scan)
    want, _ = tmodel.prefill(tparams, tcfg, {"tokens": tokens})
    h, pd, n = tcfg.ssm_nheads, tcfg.ssm_headdim, tcfg.ssm_state
    assert shapes == [((2, 3, h, pd, n), (2, 3, h), None)] * tcfg.num_layers
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The slice: prefill and decode_step
# ---------------------------------------------------------------------------

def _tokens(vocab):
    return np.random.default_rng(0).integers(0, vocab, (2, 40)).astype(np.int32)


def test_decode_cache_specs_match_jax_and_prefill(f32_model):
    jcfg, tcfg, _, tp = f32_model
    jstructs, _ = jmodel.decode_cache_specs(jcfg, 2, 64)
    specs = tmodel.decode_cache_specs(tcfg, 2, 64)
    _, caches = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(_tokens(tcfg.vocab_size))})
    for name, dt in (("conv", torch.bfloat16), ("ssd", torch.float32)):
        spec = specs[0]["blk0"][name]
        assert spec.shape == jstructs[0]["blk0"][name].shape
        assert spec.dtype == dt and str(jstructs[0]["blk0"][name].dtype) == str(dt)[6:]
        assert caches[0]["blk0"][name].shape == spec.shape
        assert caches[0]["blk0"][name].dtype == spec.dtype


def test_slice_matches_jax_float32(f32_model):
    """JAX's float32 weights: prefill logits and states, then 6 greedy
    decode steps of the port on its own tokens; logits within 1e-4 of
    JAX's, the same tokens."""
    jcfg, tcfg, jp, tp = f32_model
    tokens = _tokens(jcfg.vocab_size)
    want = jax_ssm_run(jcfg, jp, tokens, SSM_STEPS)
    logits, caches = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(tokens)})
    tol = SSM_TOL["float32"]
    np.testing.assert_allclose(_np(logits[:, 0]), want["prefill_logits"], rtol=0, atol=tol)
    np.testing.assert_allclose(_np(caches[0]["blk0"]["ssd"][-1]), want["ssd"], rtol=0, atol=tol)
    tok = torch.from_numpy(tokens[:, -1:])
    pos = torch.full((2,), 40, dtype=torch.int32)
    fed = []
    for step in range(SSM_STEPS):
        fed.append(tok[:, 0].numpy())
        logits, caches = tmodel.decode_step(tp, tcfg, tok, pos, caches)
        np.testing.assert_allclose(_np(logits[:, 0]), want["logits"][step], rtol=0, atol=tol,
                                   err_msg=f"step {step}")
        tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1
    np.testing.assert_array_equal(np.stack(fed), want["fed"])


# ---------------------------------------------------------------------------
# The committed fixture that chip_smoke.py replays on the card
# ---------------------------------------------------------------------------

def test_committed_ssm_fixture_equals_regenerated():
    jcfg, flat, cases = ssm_fixture()
    cfg, tree, committed = load_model_replay(SSM_FIXTURE)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert sorted("/".join(k.key for k in path) for path, _ in leaves) == sorted(flat)
    for path, a in leaves:
        want = flat["/".join(k.key for k in path)]
        want = want.view(np.uint16) if want.dtype.name == "bfloat16" else want
        np.testing.assert_array_equal(a, want)
        assert a.dtype == want.dtype
    assert sorted(committed) == sorted(cases) == ["bfloat16", "float32"]
    for name, fields in cases.items():
        assert sorted(committed[name]) == sorted(fields)
        for k, v in fields.items():
            assert committed[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(committed[name][k], v, err_msg=f"{name}.{k}")


def test_ssm_fixture_is_small():
    assert os.path.getsize(SSM_FIXTURE) < 300_000


@pytest.mark.parametrize("scan", [None, "plain"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_fixture_replays_on_cpu(dtype, scan):
    """The slice against JAX's run of the fixture's weights (the committed
    file equals a fresh JAX run, above): prefill, then 6 decode steps fed
    JAX's tokens.  In bfloat16 the conv windows equal JAX's bit for bit."""
    cfg, tree, cases = load_model_replay(SSM_FIXTURE)
    got = replay_ssm_case(cfg, tree, dtype, cases[dtype], "cpu", **_scan_kw(scan))
    res = compare_ssm_case(cases[dtype], got, SSM_TOL[dtype])
    assert ssm_case_ok(res, SSM_TOL[dtype]), res
    if dtype == "bfloat16":
        assert res["conv_max_bf16_steps"] == 0, res


# ---------------------------------------------------------------------------
# Device rules
# ---------------------------------------------------------------------------

def test_init_model_needs_a_card_unless_given_the_cpu():
    _, tcfg = _smoke("float32")
    params = tmodel.init_model(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert params["embed"]["tok"].device.type == "cpu"
    if torch.cuda.is_available():
        assert tmodel.init_model(tcfg, torch.Generator().manual_seed(0))["embed"]["tok"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodel.init_model(tcfg, torch.Generator().manual_seed(0))
