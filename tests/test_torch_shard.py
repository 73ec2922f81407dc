"""The port's sharding rules and roofline against the JAX package's, on the
CPU: ``PLANS``, ``axes_to_pspec`` on both production meshes, ``_fit_spec``,
every parameter leaf's local shard shape and every ``build_cell``
argument's bytes a rank under every plan, the decode caches' logical axes,
``_kv_expansion``, and the roofline functions.

The port's meshes are ``DeviceMesh``es over a ``fake`` process group of
256 or 512 ranks (``launch.dryrun.start_fake_world``); JAX's are
``AbstractMesh``es, whose ``NamedSharding.shard_shape`` needs no devices.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import config as jconfig
from repro.analysis import roofline as jroof
from repro.launch import specs as jspecs
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.params import abstract_params as jabstract
from repro.shard import partition as jpart
from repro_torch import config as tconfig
from repro_torch.analysis import roofline as troof
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.shard import partition as tpart

ARCHS = tconfig.ARCH_IDS
PLAN_NAMES = list(jpart.PLANS)
MESHES = {"pod1": ((16, 16), ("data", "model")), "pod2": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    """{"pod1"/"pod2": (the port's DeviceMesh, JAX's AbstractMesh)}; the
    port's on one fake group each, made in turn (a process has one group)."""
    import torch.distributed as dist

    out = {}
    for name, (shape, axes) in MESHES.items():
        tdry.start_fake_world(int(np.prod(shape)))
        out[name] = (tmesh.make_production_mesh(multi_pod=name == "pod2"),
                     AbstractMesh(shape, axes))
    yield out
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_spec(p: P) -> tuple:
    return tuple(p)


def _all_axes() -> set:
    axes = set()
    for arch in ARCHS:
        for leaf in jax.tree.leaves(jmodel.model_axes(jconfig.get_arch(arch)),
                                    is_leaf=lambda x: isinstance(x, tuple)):
            axes.add(leaf)
    return axes


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_plans_equal_jax(name):
    assert list(tpart.PLANS) == list(jpart.PLANS) and len(tpart.PLANS) == 12
    tp, jp = tpart.PLANS[name], jpart.PLANS[name]
    assert (tp.name, tp.rules, tp.flags) == (jp.name, jp.rules, jp.flags)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", PLAN_NAMES)
def test_axes_to_pspec_equals_jax(meshes, mesh_name, name):
    """Every logical-axes tuple of the ten archs' parameters."""
    tm, jm = meshes[mesh_name]
    for axes in sorted(_all_axes(), key=str):
        want = _jax_spec(jpart.axes_to_pspec(axes, jm, jpart.PLANS[name]))
        assert tpart.axes_to_pspec(axes, tm, tpart.PLANS[name]) == want, axes


def test_fit_spec_divisibility_dropping():
    """JAX's ``test_divisibility_dropping`` cases, and the same on a DeviceMesh."""
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    assert tspecs._fit_spec((None, "model"), (4096, 10), mesh) == (None, None)
    assert tspecs._fit_spec((None, "model"), (4096, 49152), mesh) == (None, "model")
    assert tspecs._fit_spec((("data", "model"),), (4096,), mesh) == (("data", "model"),)
    for spec, shape in [((None, "model"), (4096, 10)), ((("data", "model"), None), (48, 8)),
                        (("data", ("model",)), (32, 49155))]:
        assert tspecs._fit_spec(spec, shape, mesh) == _jax_spec(
            jspecs._fit_spec(P(*spec), shape, mesh))


def test_no_plan_names_axes_against_mesh_order(meshes):
    """A tensor dim spread over several mesh axes is ``Shard`` on each, in
    mesh order; no plan asks for the reverse (which DTensor would lay out as
    ``_StridedShard``), and such a spec is refused."""
    from torch.distributed.tensor import Replicate, Shard

    for tm, _ in meshes.values():
        names = list(tm.mesh_dim_names)
        for plan in tpart.PLANS.values():
            for rule in plan.rules.values():
                if isinstance(rule, tuple):
                    kept = [a for a in rule if a in names]
                    assert kept == sorted(kept, key=names.index), (plan.name, rule)
    tm = meshes["pod2"][0]
    assert tpart.spec_to_placements((("pod", "data"), "model"), tm) == (Shard(0), Shard(0),
                                                                        Shard(1))
    assert tpart.spec_to_placements((None, None), tm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="_StridedShard"):
        tpart.spec_to_placements((("model", "data"),), tm)


@pytest.mark.parametrize("name", PLAN_NAMES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shard_shapes_equal_jax(meshes, arch, name):
    """Every parameter leaf's local shard shape on both meshes equals JAX's
    ``NamedSharding(AbstractMesh, fitted spec).shard_shape``."""
    tcfg, jcfg = tconfig.get_arch(arch), jconfig.get_arch(arch)
    t_struct = tmodel.abstract_model(tcfg)
    j_struct = jabstract(jmodel.model_param_defs(jcfg))
    for tm, jm in meshes.values():
        t_pl = tspecs.resolve_shardings(tmodel.model_axes(tcfg), t_struct, tm, tpart.PLANS[name])
        j_sh = jspecs.resolve_shardings(jmodel.model_axes(jcfg), j_struct, jm,
                                        jpart.PLANS[name])
        flat_j = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda s, st: s.shard_shape(st.shape), j_sh, j_struct,
                         is_leaf=lambda x: isinstance(x, NamedSharding)),
            is_leaf=lambda x: isinstance(x, tuple))[0])
        got = {}

        def walk(pl, st, path):
            if isinstance(st, torch.Tensor):
                got[path] = tspecs.local_shape(tuple(st.shape), pl, tm)
            else:
                for k in st:
                    walk(pl[k], st[k], path + (k,))

        walk(t_pl, t_struct, ())
        want = {tuple(k.key for k in path): tuple(v) for path, v in flat_j.items()}
        assert got == want


def _jax_arg_bytes(jcfg, shape, jm, plan) -> int:
    """The bytes a rank holds of JAX's ``build_cell`` arguments, from
    ``resolve_shardings`` on the AbstractMesh (JAX's ``build_cell`` itself
    reads the devices of a concrete mesh)."""
    def nbytes(shardings, structs):
        leaves = jax.tree.leaves(jax.tree.map(
            lambda s, st: int(np.prod(s.shard_shape(st.shape))) * st.dtype.itemsize,
            shardings, structs, is_leaf=lambda x: isinstance(x, NamedSharding)))
        return sum(leaves)

    p_struct = jabstract(jmodel.model_param_defs(jcfg))
    p_sh = jspecs.resolve_shardings(jmodel.model_axes(jcfg), p_struct, jm, plan)
    params = nbytes(p_sh, p_struct)
    if shape.kind == "train":
        b_struct, b_axes = jspecs.batch_specs(jcfg, shape, with_labels=True)
        f32 = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32), p_struct)
        moments = 2 * nbytes(p_sh, f32)          # AdamW's mu and nu, float32
        return (params + moments + 4             # + the int32 step
                + nbytes(jspecs.resolve_shardings(b_axes, b_struct, jm, plan), b_struct))
    if shape.kind == "prefill":
        b_struct, b_axes = jspecs.batch_specs(jcfg, shape, with_labels=False)
        return params + nbytes(jspecs.resolve_shardings(b_axes, b_struct, jm, plan), b_struct)
    b, s = shape.global_batch, shape.seq_len
    enc = jcfg.frontend_seq if jcfg.family == "encdec" else 0
    c_struct, c_axes = jmodel.decode_cache_specs(jcfg, b, s, enc, kv_int8=plan.has("kv_int8"))
    caches = sum(nbytes(jspecs.resolve_shardings(a, st, jm, plan), st)
                 for a, st in zip(c_axes, c_struct))
    bspec = jspecs._fit_spec(jpart.axes_to_pspec(("batch", None), jm, plan), (b, 1), jm)
    tok = NamedSharding(jm, bspec).shard_shape((b, 1))
    pos = NamedSharding(jm, P(bspec[0])).shard_shape((b,))
    return params + caches + 4 * (int(np.prod(tok)) + int(np.prod(pos)))


PLANS_BY_KIND = {"train": ("train", "train_kvrep", "train_embed_repl", "train_zero3",
                           "train_ep"),
                 "prefill": ("prefill", "prefill_kvrep"),
                 "decode": ("decode", "decode_stationary", "decode_stationary_int8",
                            "decode_vrepl", "long")}


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_argument_bytes_equal_jax(meshes, arch):
    """Params, moments, batch and caches of every ``cells_for`` cell under
    its default plan and every plan of its kind, bytes a rank, on both
    meshes."""
    tcfg, jcfg = tconfig.get_arch(arch), jconfig.get_arch(arch)
    for sid in tconfig.cells_for(tcfg):
        shape = tconfig.SHAPES[sid]
        for name in (None,) + PLANS_BY_KIND[shape.kind]:
            for tm, jm in meshes.values():
                cell = tspecs.build_cell(tcfg, shape, tm, plan=name)
                plan = jpart.PLANS[cell.meta["plan"]]
                got = tdry.argument_bytes(cell, tm)
                assert got == _jax_arg_bytes(jcfg, jconfig.SHAPES[sid], jm, plan), (
                    sid, cell.meta)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_and_axes_equal_jax(arch, kv_int8):
    """The (specs, axes) pair of every arch's smoke and full config equals
    JAX's ``decode_cache_specs`` pair in shape, dtype and axes."""
    for getter in ("get_arch", "get_smoke_arch"):
        tcfg, jcfg = getattr(tconfig, getter)(arch), getattr(jconfig, getter)(arch)
        enc = 7 if tcfg.family == "encdec" else 0
        specs = tmodel.decode_cache_specs(tcfg, 3, 16, enc, kv_int8=kv_int8)
        axes = tmodel.decode_cache_axes(tcfg, kv_int8=kv_int8)
        j_structs, j_axes = jmodel.decode_cache_specs(jcfg, 3, 16, enc, kv_int8=kv_int8)
        assert axes == j_axes
        got = [{b: {k: (s.shape, str(s.dtype).removeprefix("torch.")) for k, s in blk.items()}
                for b, blk in g.items()} for g in specs]
        want = [{b: {k: (tuple(s.shape), str(s.dtype)) for k, s in blk.items()}
                 for b, blk in g.items()} for g in j_structs]
        assert got == want


def _duck_mesh(shape, axes):
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_kv_expansion_equals_jax(name):
    """``_kv_expansion`` on a duck-typed mesh (``axis_names``,
    ``devices.shape``) for every arch, smoke and full, and every TP size."""
    seen = set()
    for arch in ARCHS:
        for getter in ("get_arch", "get_smoke_arch"):
            tcfg, jcfg = getattr(tconfig, getter)(arch), getattr(jconfig, getter)(arch)
            for tp in (1, 2, 4, 8, 16):
                mesh = _duck_mesh((2, tp), ("data", "model"))
                with jpart.use_rules(mesh, name):
                    want = jattn._kv_expansion(jcfg)
                with tpart.use_rules(mesh, name):
                    got = tattn._kv_expansion(tcfg)
                assert got == want, (arch, getter, tp)
                seen.add(got)
    assert tattn._kv_expansion(tconfig.get_arch("granite_8b")) == 1    # no rules active
    assert (seen != {1}) == jpart.PLANS[name].has("kv_expand")


def test_kv_expansion_granite_smoke_r2():
    """At mesh (2, 2) Granite's smoke config (4 heads, 1 K/V head) expands
    K/V 2-fold under ``train_kvrep``: q, k and v all split over ``model``."""
    cfg = tconfig.get_smoke_arch("granite_8b")
    assert (cfg.num_heads, cfg.num_kv_heads) == (4, 1)
    with tpart.use_rules(_duck_mesh((2, 2), ("data", "model")), "train_kvrep"):
        assert tattn._kv_expansion(cfg) == 2
    with tpart.use_rules(_duck_mesh((2, 2), ("data", "model")), "train"):
        assert tattn._kv_expansion(cfg) == 1


def test_kv_expansion_repeats_heads_as_jax(monkeypatch):
    """``project_qkv`` under ``train_kvrep`` repeats each K/V head r times in
    place, as JAX's ``jnp.repeat`` on axis 2 does (JAX's sharding hints,
    which need a concrete mesh, taken out)."""
    monkeypatch.setattr(jattn, "shard_act", lambda x, *axes: x)
    cfg = dataclasses.replace(tconfig.get_smoke_arch("granite_8b"), dtype="float32")
    jcfg = dataclasses.replace(jconfig.get_smoke_arch("granite_8b"), dtype="float32")
    from repro_torch.models.params import init_params

    p = init_params(tattn.gqa_defs(cfg, torch.float32), torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 5, cfg.d_model),
                                                                  dtype=np.float32))
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5)
    mesh = _duck_mesh((2, 2), ("data", "model"))
    with tpart.use_rules(mesh, "train_kvrep"):
        q, k, v = tattn.project_qkv(p, cfg, x, pos)
    with jpart.use_rules(mesh, "train_kvrep"):
        jq, jk, jv = jattn._project_qkv({n: jnp.asarray(t.numpy()) for n, t in p.items()}, jcfg,
                                        jnp.asarray(x.numpy()), jnp.asarray(pos.numpy()))
    assert k.shape == (2, 5, 2, cfg.resolved_head_dim) == jk.shape
    for a, b in ((q, jq), (k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_functions_equal_jax(arch, monkeypatch):
    """``active_params``, ``model_flops``, ``kv_cache_bytes`` and
    ``memory_bytes_per_device`` for every ``cells_for`` shape; ``roofline_row``
    on the same costs once both use the same constants."""
    tcfg, jcfg = tconfig.get_arch(arch), jconfig.get_arch(arch)
    assert troof.active_params(tcfg) == jroof.active_params(jcfg)
    assert troof._moe_layers(tcfg) == jroof._moe_layers(jcfg)
    assert troof._attn_layers(tcfg) == jroof._attn_layers(jcfg)
    monkeypatch.setattr(troof, "HW", dict(jroof.HW))
    for sid in tconfig.cells_for(tcfg):
        ts, js = tconfig.SHAPES[sid], jconfig.SHAPES[sid]
        assert troof.model_flops(tcfg, ts) == jroof.model_flops(jcfg, js)
        for kv_int8 in (False, True):
            assert troof.kv_cache_bytes(tcfg, ts, kv_int8) == jroof.kv_cache_bytes(jcfg, js,
                                                                                 kv_int8)
            for n_dev in (1, 256, 512):
                for mb in (1, 4, 8):
                    assert troof.memory_bytes_per_device(tcfg, ts, n_dev, mb, kv_int8) == \
                        jroof.memory_bytes_per_device(jcfg, js, n_dev, mb, kv_int8)
        costs = {"dot_flops": 3.1e14, "coll_bytes": 2.2e9}
        for n_dev in (1, 256):
            assert troof.roofline_row(tcfg, ts, n_dev, costs).as_dict() == \
                jroof.roofline_row(jcfg, js, n_dev, costs).as_dict()


def test_hw_is_the_h100():
    """The H100 SXM5's datasheet rates (dense bf16, HBM3, NVLink 4 one way
    per GPU), under JAX's three keys; no TPU number."""
    assert troof.HW == {"peak_flops": 989.4e12, "hbm_bw": 3.35e12, "ici_bw": 450e9}
    assert troof.NVLINK_LINK_BW * 18 == troof.HW["ici_bw"]
    assert not set(troof.HW.values()) & set(jroof.HW.values())


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_params_pspecs_resolves_every_leaf(meshes, name):
    """``params_pspecs`` gives each leaf of the logical-axes tree the
    placements of its (unfitted) spec, as JAX's gives each a
    ``NamedSharding``."""
    tm, jm = meshes["pod2"]
    for arch in ("granite_8b", "jamba_1_5_large_398b", "seamless_m4t_medium"):
        axes = tmodel.model_axes(tconfig.get_arch(arch))
        got = tpart.params_pspecs(axes, tm, name)
        want = jpart.params_pspecs(jmodel.model_axes(jconfig.get_arch(arch)), jm, name)

        def walk(g, w, a):
            if isinstance(a, tuple):
                assert g == tpart.spec_to_placements(_jax_spec(w.spec), tm), a
            else:
                for k in a:
                    walk(g[k], w[k], a[k])

        walk(got, want, axes)


def test_shard_act_without_rules_is_the_identity():
    """With no rules active (and on a plain tensor under rules) ``shard_act``
    returns its input object and dispatches no tensor op: the unsharded
    decode steps pay nothing for the hints."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func)
            return func(*args, **(kwargs or {}))

    x = torch.randn(2, 3, 4)
    with Count():
        assert tpart.shard_act(x, "batch", "seq", "embed") is x
        with tpart.use_rules(_duck_mesh((2, 2), ("data", "model")), "train"):
            assert tpart.shard_act(x, "batch", "seq", "embed") is x
    assert ops == [] and tpart.current_rules() == (None, None)
