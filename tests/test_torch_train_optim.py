"""The port's optimizer, schedule, gradient compression, data, tree helpers
and launcher overrides against the JAX package, on inputs made with numpy.

Tolerances: float32 results within rtol 1e-6 (XLA on the CPU contracts
the moment updates into FMAs and its ``pow``/``cos`` may differ from
PyTorch's by one unit in the last place, so bitwise equality is not
expected); bfloat16 params after an update within one bfloat16 step
(a float32 difference of one ulp can round either way); integer and
numpy-only results bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jax_flat_params, nested

from repro import config as jconfig
from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgc
from repro.optim import schedule as jsched
from repro.utils import hashing as jhash
from repro.utils import trees as jtrees
from repro_torch import config as tconfig
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import schedule as tsched
from repro_torch.utils import hashing as thash
from repro_torch.utils import trees as ttrees

SCHEDULES = [dict(peak_lr=3e-4, warmup_steps=100, total_steps=10_000),
             dict(peak_lr=3e-3, warmup_steps=0, total_steps=3),
             dict(peak_lr=1e-2, warmup_steps=4, total_steps=40, final_frac=0.0)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_warmup_cosine_matches_jax(kw):
    for step in (0, 1, 2, 3, 4, 5, 50, 99, 100, 101, 5_000, 9_999, 10_000, 12_000):
        got = tsched.warmup_cosine(step, **kw)
        want = np.asarray(jsched.warmup_cosine(step, **kw))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0, err_msg=str(step))


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"a": rng.standard_normal((7,)).astype(np.float32),
                    "b": rng.standard_normal((3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])   # 1.0: active (norms ~5-10); 100: inactive
def test_adamw_three_steps_match_jax(clip, dtype):
    rng = np.random.default_rng(0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    params = _tree(rng)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), params)
    tp = ttrees.tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for step in range(3):
        grads = _tree(rng)
        grads = jax.tree.map(lambda g: g * (1 + 2 * step), grads)
        lr = 1e-2 * (step + 1)
        jp, js, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js, lr,
                                         grad_clip=clip)
        tp, ts, tm = tadamw.adamw_update(tp, ttrees.tree_map(torch.from_numpy, grads), ts, lr,
                                         grad_clip=clip)
        np.testing.assert_allclose(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                                   rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
    if clip == 1.0:
        assert float(jm["grad_norm"]) > clip   # the clip was active
    for name, leaf in ttrees.tree_flatten_with_paths({"p": tp, "mu": ts.mu, "nu": ts.nu}):
        want = jax_flat_params({"p": jp, "mu": js.mu, "nu": js.nu})[name].astype(np.float32)
        got = leaf.float().numpy()
        if dtype == "bfloat16" and name.startswith("p/"):
            np.testing.assert_allclose(got, want, rtol=2**-7, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=name)


def test_adamw_state_round_trips_through_numpy():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.adamw_init(jp)
    js, _ = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, _tree(rng)), js, 1e-2)[1:]
    tp = ttrees.tree_map(torch.from_numpy, params)
    as_np = {"step": np.asarray(js.step), "mu": jax.tree.map(np.asarray, js.mu),
             "nu": jax.tree.map(np.asarray, js.nu)}
    ts = tadamw.opt_state_from_numpy(as_np, tp, "cpu")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 1
    back = tadamw.opt_state_to_numpy(ts)
    jback = jadamw.AdamWState(step=jnp.asarray(back["step"]),
                              mu=jax.tree.map(jnp.asarray, back["mu"]),
                              nu=jax.tree.map(jnp.asarray, back["nu"]))
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="shape"):
        tadamw.opt_state_from_numpy(as_np, {**tp, "w": torch.zeros(2, 2)}, "cpu")


@pytest.mark.parametrize("shape", [(64,), (8, 33)])
def test_int8_quantize_matches_jax(shape):
    g = (np.random.default_rng(2).standard_normal(shape) * 3).astype(np.float32)
    jq, js = jgc.int8_quantize(jnp.asarray(g))
    tq, ts = tgc.int8_quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(tgc.int8_dequantize(tq, ts).numpy(),
                               np.asarray(jgc.int8_dequantize(jq, js)), rtol=1e-6)


def test_int8_stochastic_rounding_uses_the_generator():
    """floor(x / scale + u), u from the given generator: the same draws as
    a generator of the same seed, and within one step of the nearest."""
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((1000,)).astype(np.float32))
    q, scale = tgc.int8_quantize(g, torch.Generator().manual_seed(5))
    u = torch.rand(g.shape, generator=torch.Generator().manual_seed(5))
    assert torch.equal(q, torch.floor(g / scale + u).clamp(-127, 127).to(torch.int8))
    near, _ = tgc.int8_quantize(g)
    assert (q.int() - near.int()).abs().max() <= 1


@pytest.mark.parametrize("k_frac", [0.1, 0.5])
def test_compress_topk_matches_jax(k_frac):
    rng = np.random.default_rng(4)
    n = 60
    mags = rng.permutation(np.arange(1, n + 1)).astype(np.float32) / 7   # distinct
    g = (mags * np.where(rng.random(n) < 0.5, -1, 1)).reshape(6, 10).astype(np.float32)
    err = (rng.standard_normal((6, 10)) * 1e-3).astype(np.float32)
    jv, ji, je = jgc.compress_topk(jnp.asarray(g), k_frac, jnp.asarray(err))
    tv, ti, te = tgc.compress_topk(torch.from_numpy(g), k_frac, torch.from_numpy(err))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tgc.decompress_topk(tv, ti, g.shape).numpy(),
                                  np.asarray(jgc.decompress_topk(jv, ji, g.shape)))


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_370m"])
def test_synthetic_batch_is_bitwise_jax(arch):
    cfg = tconfig.get_smoke_arch(arch)
    jcfg = jconfig.get_smoke_arch(arch)
    for step, seed, seq, batch in ((0, 0, 32, 4), (7, 3, 64, 2), (123, 1, 2048, 1)):
        got = tpipe.synthetic_batch(cfg, seq, batch, step, seed)
        want = jpipe.synthetic_batch(jcfg, seq, batch, step, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_prefetches_batches_through_the_shard_cache():
    cfg = tconfig.get_smoke_arch("granite_8b")
    pipe = tpipe.DataPipeline(cfg, tpipe.DataConfig(seq_len=8, global_batch=2, prefetch=1))
    try:
        batches = [next(pipe) for _ in range(20)]
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
    for step, b in enumerate(batches):
        want = tpipe.synthetic_batch(cfg, 8, 2, step)
        np.testing.assert_array_equal(b["tokens"], want["tokens"])
    reads = pipe.stats["shard_hits"] + pipe.stats["shard_misses"]
    assert reads >= 20 and pipe.stats["shard_misses"] >= 16 and pipe.stats["shard_hits"] >= 4
    key = thash.hash2_u32(torch.tensor(5), torch.tensor(tpipe.SHARD_SALT))
    want = jhash.hash2_u32(jnp.uint32(5), jnp.uint32(0xD47A))
    assert int(key) & 0xFFFFFFFF == int(want)
    np.testing.assert_array_equal(pipe.read_shard(5), np.random.default_rng(np.uint32(5)).integers(
        0, cfg.vocab_size, (pipe.cfg.shard_tokens,), dtype=np.int32))


def test_tree_paths_counts_and_bytes_match_jax():
    rng = np.random.default_rng(5)
    params = {"embed": {"tok": rng.standard_normal((5, 3)).astype(np.float32)},
              "dec": {"g0": {"blk0": {"w": rng.standard_normal((2, 3, 4)).astype(np.float32)}}},
              "a_list": [np.zeros((2,), np.int32), np.ones((3,), np.float32)]}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jp, "opt": jadamw.adamw_init(jp)}
    tp = ttrees.tree_map(torch.from_numpy, params)
    tstate = {"params": tp, "opt": tadamw.adamw_init(tp)}
    jnames = [n for n, _ in jtrees.tree_flatten_with_paths(jstate)]
    tnames = [n for n, _ in ttrees.tree_flatten_with_paths(tstate)]
    assert tnames == jnames
    assert "opt/mu/embed/tok" in tnames and "opt/step" in tnames and "params/a_list/1" in tnames
    assert ttrees.tree_param_count(tstate) == jtrees.tree_param_count(jstate)
    assert ttrees.tree_bytes(tstate) == jtrees.tree_bytes(jstate)
    bf = {"x": torch.zeros((4, 4), dtype=torch.bfloat16)}
    assert ttrees.tree_bytes(bf) == jtrees.tree_bytes({"x": jnp.zeros((4, 4), jnp.bfloat16)})
    rebuilt = ttrees.tree_unflatten(tp, ttrees.tree_leaves(tp))
    assert [n for n, _ in ttrees.tree_flatten_with_paths(rebuilt)] == \
        [n for n, _ in ttrees.tree_flatten_with_paths(tp)]
    assert nested(jax_flat_params(jp))["embed"]["tok"].shape == (5, 3)


@pytest.mark.parametrize("args", [["a=1", "b=2.5", "c=true", "d=False", "e=x=y", "f=1e-3"], []])
def test_parse_overrides_matches_jax(args):
    got, want = tconfig.parse_overrides(args), jconfig.parse_overrides(args)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    with pytest.raises(ValueError, match="key=value"):
        tconfig.parse_overrides(["nokey"])
