"""The port's package surface against the JAX package's: the functions that
came with the re-exports (``tests/test_torch_imports.py`` holds the names)
equal JAX's on inputs made with numpy from a seed (``null_line``,
``occupancy``, ``hash_u32``, ``lm_logits``, ``read_from_store``,
``gilbert_elliott_step``, ``logical_axes`` and ``abstract_params``), as do
``SHAPES``, ``ARCH_IDS`` and ``cells_for``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import arbitrary_tables, as_numpy, as_torch, key_pool

from repro import config as jconfig
from repro.core import backing_store as jbs
from repro.core import cache_state as jcs
from repro.core import coherence as jco
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.utils import hashing as jhash
from repro_torch import config as tconfig
from repro_torch.core import backing_store as tbs
from repro_torch.core import cache_state as tcs
from repro_torch.core import coherence as tco
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.utils import hashing as thash

def test_configs_shapes_and_cells_equal_jax():
    assert tconfig.ARCH_IDS == jconfig.ARCH_IDS and len(tconfig.ARCH_IDS) == 10
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    from repro_torch import configs as tconfigs
    assert tconfigs.ARCH_IDS is tconfig.ARCH_IDS
    for arch in tconfig.ARCH_IDS:
        for getter in ("get_arch", "get_smoke_arch"):
            want = getattr(jconfig, getter)(arch)
            got = getattr(tconfigs, getter)(arch)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, getter)
        assert tconfig.cells_for(tconfig.get_arch(arch)) == jconfig.cells_for(
            jconfig.get_arch(arch)), arch


def test_null_line_and_occupancy_equal_jax():
    want = jcs.null_line(5)
    got = tcs.null_line(5)
    for f in dataclasses.fields(want):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name)
        assert tuple(g.shape) == w.shape, f.name
        np.testing.assert_array_equal(as_numpy(g, like=w), w, err_msg=f.name)
    rng = np.random.default_rng(0)
    tables = arbitrary_tables(rng, 3, 4, 2, 3, key_pool(rng))
    jcache = jcs.CacheState(**{k: jnp.asarray(v) for k, v in tables.items()})
    tcache = tcs.CacheState(**{k: as_torch(v) for k, v in tables.items()})
    got = tcs.occupancy(tcache)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcs.occupancy(jcache)))


def test_hash_u32_equals_jax():
    x = key_pool(np.random.default_rng(1), 64)
    np.testing.assert_array_equal(as_numpy(thash.hash_u32(as_torch(x)), like=x),
                                  np.asarray(jhash.hash_u32(jnp.asarray(x))))


@pytest.mark.parametrize("tie", [False, True])
def test_lm_logits_equal_jax(tie):
    rng = np.random.default_rng(2)
    p = {"tok": rng.standard_normal((32, 16)).astype(np.float32),
         "head": rng.standard_normal((16, 32)).astype(np.float32)}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    want = np.asarray(jlayers.lm_logits({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x), tie))
    got = tlayers.lm_logits({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                            tie)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a bfloat16 head with float32 hidden states is promoted to float32, as in JAX
    pb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    wantb = jlayers.lm_logits({k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()},
                              jnp.asarray(x), tie)
    gotb = tlayers.lm_logits(pb, torch.from_numpy(x), tie)
    assert gotb.dtype == torch.float32 and wantb.dtype == jnp.float32
    np.testing.assert_allclose(gotb.numpy(), np.asarray(wantb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["sheets", "db"])
def test_read_from_store_equals_jax(kind):
    jstore = dataclasses.replace(jbs.init_store(4), drained_total=jnp.int32(7),
                                 api_calls=jnp.int32(3))
    tstore = dataclasses.replace(tbs.init_store(4), drained_total=torch.tensor(7, dtype=torch.int32),
                                 api_calls=torch.tensor(3, dtype=torch.int32))
    jprof, tprof = jbs.StoreProfile(kind=kind), tbs.StoreProfile(kind=kind)
    for index in (0, 6, 7, 12):
        jstore, jfound, jtxn = jbs.read_from_store(jstore, jnp.int32(index), jprof)
        tstore, tfound, ttxn = tbs.read_from_store(tstore, index, tprof)
        assert bool(tfound) == bool(jfound) and float(ttxn) == float(jtxn), index
        for f in dataclasses.fields(jstore):
            np.testing.assert_array_equal(getattr(tstore, f.name).numpy(),
                                          np.asarray(getattr(jstore, f.name)), err_msg=f.name)
    assert int(tstore.api_calls) == 7


@pytest.mark.parametrize("seed", range(2))
def test_gilbert_elliott_step_equals_jax(seed):
    """JAX's step on a key; the port's on the three uniforms that JAX draws
    from its three subkeys."""
    n = 20
    jstate = jco.GilbertElliott(bad=jnp.asarray(np.random.default_rng(seed).random(n) < 0.3))
    tstate = tco.GilbertElliott(bad=as_torch(np.asarray(jstate.bad)))
    key = jax.random.PRNGKey(seed)
    for _ in range(4):
        key, k = jax.random.split(key)
        jstate, jmask = jco.gilbert_elliott_step(jstate, k, (n, 7))
        k_up, k_dn, k_mask = jax.random.split(k, 3)
        uniforms = [as_torch(np.asarray(jax.random.uniform(kk, shape)))
                    for kk, shape in ((k_up, (n,)), (k_dn, (n,)), (k_mask, (n, 7)))]
        tstate, tmask = tco.gilbert_elliott_step(tstate, *uniforms)
        np.testing.assert_array_equal(tstate.bad.numpy(), np.asarray(jstate.bad))
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    with pytest.raises(ValueError, match="receivers"):
        tco.gilbert_elliott_step(tstate, uniforms[0], uniforms[1], uniforms[2][:3])


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "deepseek_v2_lite_16b",
                                  "jamba_1_5_large_398b"])
def test_logical_axes_and_abstract_params_equal_jax(arch):
    """The full-size config: the axes tree equal to JAX's, and meta tensors
    of JAX's ``ShapeDtypeStruct`` shapes and dtypes (nothing allocated)."""
    jcfg, tcfg = jconfig.get_arch(arch), tconfig.get_arch(arch)
    jaxes = jmodel.model_axes(jcfg)
    taxes = tmodel.model_axes(tcfg)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(
        jaxes, is_leaf=lambda x: isinstance(x, tuple))[0])
    assert len(flat_j) > 5
    jabs = jmodel.abstract_model(jcfg)
    tabs = tmodel.abstract_model(tcfg)

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield "/".join(prefix + (k,)), v
    want_axes = {"/".join(str(getattr(k, "key", k)) for k in path): v
                 for path, v in flat_j.items()}
    assert dict(flat(taxes)) == want_axes
    want = {"/".join(str(getattr(k, "key", k)) for k in path): (tuple(v.shape), np.dtype(v.dtype).name)
            for path, v in jax.tree_util.tree_flatten_with_path(jabs)[0]}
    got = dict(flat(tabs))
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in got.items()} == want
