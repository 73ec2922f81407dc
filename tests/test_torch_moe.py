"""The port's MoE family (``models/moe.py``, MLA in ``models/attention.py``,
the MoE and MLA blocks of ``models/stack.py``) against the JAX package's,
on the same weights (``params_from_numpy`` of JAX's leaves) and inputs
made with numpy from a seed.

* The four configs of the MoE slice and the hybrid and VLM ones
  (Jamba-1.5-Large, InternVL2-2B), field for field; the full parameter
  trees of the MoE, hybrid and VLM configs and their counts
  (DeepSeek-V2-Lite 15,706,484,224; Jamba 397,711,939,584; InternVL2
  1,889,146,880).
* ``moe_forward`` on both dispatch branches (grouped: S >= E; global:
  decode), with tokens dropped at capacity, in float32 and bfloat16: the
  routing indices, ``keep``, the buffer rows and the tokens of the plan
  equal JAX's, the gates within 2e-6 relative (the float32 softmax);
  ``_pack`` equal and ``_combine`` bitwise equal in bfloat16 on the same
  inputs (the k adds of a token in plan order, as XLA's CPU
  scatter does them); the output within 1e-6 (float32: the expert
  products' last bits) or 4 bfloat16 steps (bfloat16: the products, the
  SwiGLU and the shared experts round at other places; measured 2 steps),
  each of the output's largest magnitude; ``aux`` within 1e-6.
* The load-balance loss under a uniform router is 1.
* ``mla_forward`` (full and flash paths) and ``mla_decode`` within 1e-5.

The model as a whole (prefill, decode, loss, gradients, the committed
fixtures) is in ``test_torch_moe_slice.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro import config as jconfig
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import params as jparams_mod
from repro_torch import config as tconfig
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models.params import param_count, params_from_numpy, tensor_from_numpy
from repro_torch.models.stack import _index
from repro_torch.utils.trees import tree_map

ARCHS = ("deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")
CONFIGS = ARCHS + ("phi3_medium_14b", "qwen1_5_110b", "jamba_1_5_large_398b", "internvl2_2b")
# Full defs held leaf by leaf against JAX's, with the counts JAX's
# ``param_count`` gives where this file states them.
DEF_COUNTS = {"deepseek_v2_lite_16b": 15_706_484_224, "qwen3_moe_235b_a22b": None,
              "jamba_1_5_large_398b": 397_711_939_584, "internvl2_2b": 1_889_146_880}


def _np(t):
    return t.detach().float().numpy()


def _smoke(arch, dtype="float32"):
    jcfg = dataclasses.replace(jconfig.get_smoke_arch(arch), dtype=dtype)
    return jcfg, tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def _to_torch(a):
    """A JAX array as a CPU tensor with the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return tensor_from_numpy(a, torch.bfloat16, "cpu")
    return torch.from_numpy(np.array(a))


def _def_paths(defs, prefix=""):
    out = []
    for k, v in defs.items():
        path = f"{prefix}/{k}" if prefix else k
        out += _def_paths(v, path) if isinstance(v, dict) else [path]
    return out


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_arch", "get_smoke_arch"])
@pytest.mark.parametrize("arch", CONFIGS)
def test_configs_equal_jax(arch, getter):
    assert (dataclasses.asdict(getattr(tconfig, getter)(arch))
            == dataclasses.asdict(getattr(jconfig, getter)(arch)))


@pytest.mark.parametrize("arch", sorted(DEF_COUNTS))
def test_full_defs_equal_jax(arch):
    """Every leaf's shape, axes, init, scale and dtype (the router
    float32); the parameter count."""
    jdefs = jmodel.model_param_defs(jconfig.get_arch(arch))
    tdefs = tmodel.model_param_defs(tconfig.get_arch(arch))
    assert param_count(tdefs) == jparams_mod.param_count(jdefs)
    if DEF_COUNTS[arch] is not None:
        assert param_count(tdefs) == DEF_COUNTS[arch]
    jleaves = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: isinstance(x, jparams_mod.ParamDef))[0]
    assert sorted(_def_paths(tdefs)) == sorted("/".join(p.key for p in path)
                                               for path, _ in jleaves)
    for path, jd in jleaves:
        td = tdefs
        for p in path:
            td = td[p.key]
        assert (td.shape, td.axes, td.init, td.scale) == (jd.shape, jd.axes, jd.init, jd.scale)
        want = torch.float32 if jd.dtype == jnp.float32 else torch.bfloat16
        assert td.dtype == want, path


# ---------------------------------------------------------------------------
# moe_forward, its plan, pack and combine
# ---------------------------------------------------------------------------

# (arch, B, S, offset): the offset is a shared direction added to every
# token, which skews the routing so that experts overflow their capacity.
MOE_CASES = [
    ("deepseek_v2_lite_16b", 2, 64, 1.0),   # grouped (S >= E = 4): 56 pairs dropped
    ("deepseek_v2_lite_16b", 32, 1, 1.0),   # global (decode): 7 dropped
    ("qwen3_moe_235b_a22b", 2, 16, 1.0),    # grouped (S >= E = 8): 6 dropped
    ("qwen3_moe_235b_a22b", 16, 1, 1.0),    # global: 1 dropped
]


def _moe_weights(arch, dtype):
    jcfg, tcfg = _smoke(arch, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = jparams_mod.init_params(jax.random.PRNGKey(0), jmoe.moe_defs(jcfg, jdt))
    tp = tree_map(_to_torch, jp)
    return jcfg, tcfg, jp, tp


def _jax_plan(jp, jcfg, x, b, s):
    """JAX's plan for (B,S,D) x as (G, T*K) arrays: vmapped per batch row
    (grouped) or one group (global), as ``moe_forward`` builds it."""
    e, k = jcfg.moe_num_experts, jcfg.moe_top_k
    gates, idx, aux = jmoe._route(jp, jcfg, x.reshape(b * s, -1))
    if s >= e:
        cap = jmoe._capacity(jcfg, s)
        plan = jax.vmap(lambda g, i: jmoe._pack_plan(jcfg, g, i, s, cap))(
            gates.reshape(b, s, k), idx.reshape(b, s, k))
    else:
        cap = jmoe._capacity(jcfg, b * s)
        plan = tuple(a[None] for a in jmoe._pack_plan(jcfg, gates, idx, b * s, cap))
    return idx, cap, aux, plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch, b, s, offset", MOE_CASES)
def test_moe_forward_matches_jax(arch, b, s, offset, dtype):
    jcfg, tcfg, jp, tp = _moe_weights(arch, dtype)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((b, s, jcfg.d_model))
         + offset * rng.standard_normal(jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tx = _to_torch(jx)

    jidx, jcap, jaux, (jkeep, jrows, jsw, jtok) = _jax_plan(jp, jcfg, jx, b, s)
    xg, cap, aux, (keep, rows, sw, stok) = tmoe.moe_plan(tp, tcfg, tx)
    _, tidx, _ = tmoe._route(tp, tcfg, tx.reshape(b * s, -1))
    assert cap == jcap
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for got, want in ((keep, jkeep), (rows, jrows), (stok, jtok)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the gates: the frameworks' float32 softmax differ in the last bit
    np.testing.assert_allclose(_np(sw), np.asarray(jsw), rtol=2e-6, atol=0)
    assert int((~keep).sum()) > 0, "the case must drop tokens"
    assert abs(float(aux) - float(jaux)) <= 1e-6

    # pack and combine on the same inputs: equal, and bitwise in bfloat16
    g, t = xg.shape[:2]
    e = jcfg.moe_num_experts
    jbuf = jax.vmap(lambda xr, ke, br, st: jmoe._pack(xr, ke, br, st, e, cap))(
        jx.reshape(g, t, -1), jkeep, jrows, jtok)
    np.testing.assert_array_equal(_np(tmoe._pack(xg, rows, stok, e, cap)),
                                  np.asarray(jbuf, np.float32))
    out = jnp.asarray(rng.standard_normal((g, e, cap, jcfg.d_model)), jnp.bfloat16)
    jy = jax.vmap(lambda o, ke, br, w, st: jmoe._combine(o, ke, br, w, st, t))(
        out, jkeep, jrows, jsw, jtok)
    ty = tmoe._combine(_to_torch(out), keep, rows, _to_torch(jsw), stok, t)
    np.testing.assert_array_equal(ty.view(torch.int16).numpy(),
                                  np.asarray(jy).view(np.int16))

    jy, jaux = jmoe.moe_forward(jp, jcfg, jx)
    ty, taux = tmoe.moe_forward(tp, tcfg, tx)
    assert ty.dtype == tx.dtype and ty.shape == (b, s, jcfg.d_model)
    want = np.asarray(jy, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    tol = 1e-6 * scale if dtype == "float32" else 4 * 2.0 ** -8 * scale
    np.testing.assert_allclose(_np(ty), want, rtol=0, atol=tol)
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_moe_aux_loss_uniform_router_is_one():
    """JAX's ``test_moe_aux_loss_uniform_router_is_one`` on the port: zero
    router logits give a load-balance loss of 1 (top-k then takes the
    lowest expert indices, as ``lax.top_k`` does)."""
    jcfg, tcfg, jp, tp = _moe_weights("qwen3_moe_235b_a22b", "float32")
    tp["router"] = tp["router"] * 0.0
    jp = dict(jp, router=jp["router"] * 0.0)
    x = np.random.default_rng(0).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    _, aux = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    _, jaux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    assert abs(float(aux) - 1.0) < 0.05 and float(aux) == pytest.approx(float(jaux), abs=1e-6)
    _, idx, _ = tmoe._route(tp, tcfg, torch.from_numpy(x).reshape(32, -1))
    assert (idx == torch.arange(jcfg.moe_top_k)).all()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla(model, layer=0):
    _, _, jp, tp = model
    return (jax.tree.map(lambda a: a[layer], jp["dec"]["g1"]["blk0"]["mixer"]),
            _index(tp["dec"]["g1"]["blk0"]["mixer"], layer))


@pytest.fixture(scope="module")
def deepseek_f32():
    """(JAX config, port config, JAX params, port params): the float32
    smoke config, JAX's weights from ``PRNGKey(0)``."""
    jcfg, tcfg = _smoke("deepseek_v2_lite_16b")
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.mark.parametrize("b, s", [(2, 24), (1, 2048)])   # full, flash (> 1,024)
def test_mla_forward_matches_jax(deepseek_f32, b, s):
    jcfg, tcfg, _, _ = deepseek_f32
    jm, tm = _mla(deepseek_f32)
    x = np.random.default_rng(1).standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jy, jlat = jattn.mla_forward(jm, jcfg, jnp.asarray(x), jnp.asarray(pos))
    ty, tlat = tattn.mla_forward(tm, tcfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert tlat.shape == (b, s, jcfg.kv_lora_rank + jcfg.rope_head_dim)
    for got, want in ((ty, jy), (tlat, jlat)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_mla_decode_matches_jax(deepseek_f32):
    """Rows at different positions (one at 0, attending to itself alone);
    the cache is written at ``pos`` in place and returned."""
    jcfg, tcfg, _, _ = deepseek_f32
    jm, tm = _mla(deepseek_f32, layer=1)
    rng = np.random.default_rng(2)
    r = jcfg.kv_lora_rank + jcfg.rope_head_dim
    cache = rng.standard_normal((3, 20, r)).astype(np.float32)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([0, 7, 19], np.int32)
    jy, jcache = jattn.mla_decode(jm, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cache))
    tcache = torch.from_numpy(cache.copy())
    ty, got = tattn.mla_decode(tm, tcfg, torch.from_numpy(x), torch.from_numpy(pos), tcache)
    assert got is tcache
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(jcache), rtol=1e-5, atol=1e-5)
