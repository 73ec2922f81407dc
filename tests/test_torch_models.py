"""The port's model layers against the JAX package's, on the same weights
(``params_from_numpy``) and inputs made with numpy from a seed.

Float32 is where the algorithm is checked: the two frameworks' matrix
products and transcendental functions differ in the last bits, so values
of order 1 agree to 1e-5 (rtol and atol 1e-5; 2e-5 after a model's layer
stack).  Bfloat16 is checked where the dtype is the point (the bits that
``params_from_numpy`` carries, the casts of ``rmsnorm`` and ``apply_rope``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sizes this worker's torch thread pool)

from repro import config as jconfig
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import params as jparams_mod
from repro.models import stack as jstack
from repro_torch import config as tconfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.params import init_params, param_count, params_from_numpy
from repro_torch.models.stack import _block_defs, plan_groups

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


def jnp_to_t(a):
    """A JAX array as a CPU tensor with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _smoke(dtype="float32"):
    jcfg = dataclasses.replace(jconfig.get_smoke_arch("granite_8b"), dtype=dtype)
    return jcfg, tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def _weights(jcfg, tcfg, seed=0):
    jp = jmodel.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_arch", "get_smoke_arch"])
def test_granite_configs_equal_jax(getter):
    jcfg = getattr(jconfig, getter)("granite_8b")
    tcfg = getattr(tconfig, getter)("granite_8b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim


@pytest.mark.parametrize("getter", ["get_arch", "get_smoke_arch"])
def test_granite3_configs_equal_jax(getter):
    """``configs/granite_3_8b.py`` against JAX's, field by field."""
    jcfg = getattr(jconfig, getter)("granite_3_8b")
    tcfg = getattr(tconfig, getter)("granite_3_8b")
    for field in dataclasses.fields(jcfg):
        assert getattr(tcfg, field.name) == getattr(jcfg, field.name), field.name
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim == (128 if getter == "get_arch" else 12)


def test_full_granite3_defs_count_equals_jax():
    jcfg, tcfg = jconfig.get_arch("granite_3_8b"), tconfig.get_arch("granite_3_8b")
    want = jparams_mod.param_count(jmodel.model_param_defs(jcfg))
    assert param_count(tmodel.model_param_defs(tcfg)) == want == 8_372_187_136


def test_full_granite_defs_equal_jax_and_count_8_25b():
    jcfg = jconfig.get_arch("granite_8b")
    tcfg = tconfig.get_arch("granite_8b")
    jdefs, tdefs = jmodel.model_param_defs(jcfg), tmodel.model_param_defs(tcfg)
    assert param_count(tdefs) == jparams_mod.param_count(jdefs) == 8_254_689_280
    jleaves = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, jparams_mod.ParamDef))[0]
    tflat = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            (walk(v, prefix + (k,)) if isinstance(v, dict) else tflat.__setitem__(prefix + (k,), v))

    walk(tdefs)
    assert len(jleaves) == len(tflat)
    for path, jd in jleaves:
        td = tflat[tuple(p.key for p in path)]
        assert (td.shape, td.axes, td.init, td.scale) == (jd.shape, jd.axes, jd.init, jd.scale)
        assert td.dtype == torch.bfloat16 and jd.dtype == jnp.bfloat16


def test_init_params_law_and_determinism():
    """JAX's law: a normal truncated to [-2, 2] times the fan-in std (the
    stacked shape's fan-in, as JAX reads it); norms are ones; one seed gives
    one result, whatever the dict order."""
    _, tcfg = _smoke("float32")
    defs = tmodel.model_param_defs(tcfg)
    a = init_params(defs, torch.Generator().manual_seed(7), "cpu")
    b = init_params(dict(reversed(list(defs.items()))), torch.Generator().manual_seed(7), "cpu")
    c = init_params(defs, torch.Generator().manual_seed(8), "cpu")
    w = a["dec"]["g0"]["blk0"]["ffn"]["w_gate"]          # (2, 64, 128): fan-in 64
    std = 1 / np.sqrt(64)
    assert w.dtype == torch.float32 and w.abs().max() <= 2 * std
    # the std of a standard normal truncated to [-2, 2] is 0.8796
    assert abs(w.std().item() / std - 0.8796) < 0.03
    assert abs(a["embed"]["tok"].std().item() - 0.8796) < 0.03
    assert torch.equal(a["dec"]["g0"]["blk0"]["ln1"]["scale"], torch.ones(2, 64))
    assert torch.equal(w, b["dec"]["g0"]["blk0"]["ffn"]["w_gate"])
    assert not torch.equal(w, c["dec"]["g0"]["blk0"]["ffn"]["w_gate"])
    assert not torch.equal(w[0], w[1])                  # layers draw apart


def test_params_from_numpy_keeps_bfloat16_bits():
    jcfg, tcfg = _smoke("bfloat16")
    jp, tp = _weights(jcfg, tcfg)
    want = np.asarray(jp["dec"]["g0"]["blk0"]["mixer"]["w_q"]).view(np.uint16)
    got = tp["dec"]["g0"]["blk0"]["mixer"]["w_q"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jx, tx = jnp.asarray(x, jdt), _t(np.asarray(jnp.asarray(x, jdt), np.float32), tdt)
    jn = jlayers.rmsnorm({"scale": jnp.asarray(scale, jdt)}, jx, 1e-5)
    tn = tlayers.rmsnorm({"scale": _t(np.asarray(jnp.asarray(scale, jdt), np.float32), tdt)}, tx, 1e-5)
    jr = jlayers.apply_rope(jx, jnp.asarray(pos), 10000.0)
    tr = tlayers.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    assert tn.dtype == tr.dtype == tdt
    # bfloat16: both compute in float32 and round once; a float32 result
    # that differs in its last bits can round to the neighbouring value
    tol = F32 if dtype == "float32" else dict(rtol=2**-8, atol=1e-5)
    np.testing.assert_allclose(_np(tn), np.asarray(jn, np.float32), **tol)
    np.testing.assert_allclose(_np(tr), np.asarray(jr, np.float32), **tol)


def test_mlp_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    got = tlayers.mlp({k: _t(v) for k, v in w.items()}, _t(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 9, h, 16)).astype(np.float32) for h in (4, 2, 2))
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got = tattn.full_attention(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax_over_1024(causal):
    """Sequence 2048 (> FLASH_THRESHOLD): 4 query blocks of 512 by 2 KV
    blocks of 1024, at narrow width; and ``gqa_forward`` takes this path."""
    rng = np.random.default_rng(3)
    s = 2048
    q = rng.standard_normal((1, s, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, s, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, s, 1, 8)).astype(np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal)
    got = tattn.flash_attention(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    full = tattn.full_attention(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(_np(got), _np(full), **F32)


def test_gqa_forward_over_1024_matches_jax():
    jcfg, tcfg = _smoke("float32")
    jp, tp = _weights(jcfg, tcfg)
    jm = jax.tree.map(lambda a: a[0], jp["dec"]["g0"]["blk0"]["mixer"])
    tm = {k: w[0] for k, w in tp["dec"]["g0"]["blk0"]["mixer"].items()}
    x = np.random.default_rng(4).standard_normal((1, 2048, 64)).astype(np.float32)
    pos = np.arange(2048, dtype=np.int32)[None]
    jy, jkv = jattn.gqa_forward(jm, jcfg, jnp.asarray(x), jnp.asarray(pos))
    ty, tkv = tattn.gqa_forward(tm, tcfg, _t(x), torch.from_numpy(pos))
    # the outputs reach ~20 here (the smoke config's narrow fan-in), so the
    # float32 rounding of their sums is absolute: 1e-5 of the largest value
    for got, want in ((ty, jy), (tkv.k, jkv.k)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Prefill and decode with contiguous caches
# ---------------------------------------------------------------------------

def test_prefill_and_decode_step_match_jax():
    """Prefill logits and K/V caches, then four decode steps on caches
    padded to 32 positions (bfloat16, as ``decode_cache_specs`` says), fed
    the same tokens; float32 weights."""
    jcfg, tcfg = _smoke("float32")
    jp, tp = _weights(jcfg, tcfg)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)})
    tl, tc = tmodel.prefill(tp, tcfg, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=2e-5, atol=2e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[0]["blk0"][name]),
                                   np.asarray(jc[0]["blk0"][name]), rtol=2e-5, atol=2e-5)

    specs = tmodel.decode_cache_specs(tcfg, 2, 32)
    jstructs, _ = jmodel.decode_cache_specs(jcfg, 2, 32)
    assert specs[0]["blk0"]["k"].shape == jstructs[0]["blk0"]["k"].shape
    jcache = jax.tree.map(
        lambda sp, a: jnp.pad(a.astype(sp.dtype), [(0, t - s) for t, s in zip(sp.shape, a.shape)]),
        jstructs, jc)
    tcache = [{"blk0": {n: jnp_to_t(jcache[0]["blk0"][n]) for n in ("k", "v")}}]
    for n in ("k", "v"):
        assert tcache[0]["blk0"][n].shape == specs[0]["blk0"][n].shape
        assert tcache[0]["blk0"][n].dtype == specs[0]["blk0"][n].dtype
    pos = np.full((2,), 12, np.int32)
    tok = np.array(prompt[:, -1:])
    for step in range(4):
        jl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache)
        tl, tcache = tmodel.decode_step(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(pos), tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=2e-5, atol=2e-5,
                                   err_msg=f"step {step}")
        tok = np.array(jnp.argmax(jl[:, 0], axis=-1), np.int32)[:, None]
        pos = pos + 1
    np.testing.assert_array_equal(
        tcache[0]["blk0"]["k"].view(torch.int16).numpy(),
        np.asarray(jcache[0]["blk0"]["k"]).view(np.int16))


def test_every_block_kind_of_every_arch_builds_with_jax_shapes():
    """Every block of every ``ARCH_IDS`` smoke config (the encoder's and the
    decoder's, cross-attention and every mixer and FFN kind) builds, each
    leaf of JAX's shape and logical axes; so does the whole model's tree."""
    kinds = set()
    for arch in tconfig.ARCH_IDS:
        jcfg = jconfig.get_smoke_arch(arch)
        tcfg = tconfig.get_smoke_arch(arch)
        enc, dec = plan_groups(tcfg)
        assert [[dataclasses.asdict(g) for g in gs] for gs in (enc, dec)] == [
            [dataclasses.asdict(g) for g in gs] for gs in jstack.plan_groups(jcfg)], arch
        for g in enc + dec:
            for bd in g.blocks:
                kinds.add((bd.mixer, bd.ffn, bd.causal, bd.cross))
                want = jstack._block_defs(jcfg, jstack.BlockDef(**dataclasses.asdict(bd)),
                                          jnp.float32)
                got = _block_defs(tcfg, bd, torch.float32)
                assert _shapes(got) == _shapes(want), (arch, bd)
        assert _shapes(tmodel.model_param_defs(tcfg)) == _shapes(
            jmodel.model_param_defs(jcfg)), arch
    assert {("attn", "mlp", False, False), ("attn", "mlp", True, True), ("mla", "moe", True, False),
            ("ssm", "none", True, False), ("ssm", "moe", True, False)} <= kinds


def _shapes(defs) -> dict:
    """``{path: (shape, logical axes)}`` of a ParamDef tree of either package."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = (tuple(v.shape), tuple(v.axes))
    walk(defs, ())
    return out
