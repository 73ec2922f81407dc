"""The port's hybrid family (Jamba's period: SSM + MLP, SSM + MoE and
attention + MLP blocks in one group, K/V caches and SSM states side by
side) against the JAX package's, on Jamba-1.5-Large's smoke config (8
layers at ``attn_period`` 4: each of the group's 2 steps runs (ssm, mlp),
(ssm, moe), (attn, mlp), (ssm, moe)), inputs made with numpy from a seed.

* ``decode_cache_specs`` equal JAX's; prefill's caches hold K/V at block
  2 alone and SSM states at the other three.
* ``prefill`` and ``decode_step``: the committed fixture's weights
  (``seeded_params``) and JAX's fresh run of it (``model_fixture``), in
  float32 within ``HYBRID_TOL`` (measured 2.3e-5 on logits) and in bfloat16
  within ``HYBRID_TOL``; decode writes the K/V rows into the caches passed
  in (the same tensors come back) and returns new SSM states.  The
  prefill (S = 24 >= E = 4) takes the grouped dispatch and drops pairs at
  capacity; decode takes the global one.
* bfloat16 block by block: each block, fed JAX's bfloat16 input, gives
  JAX's output within one bfloat16 step (of the output's magnitude) but
  for at most 0.5% of its values, within two everywhere (the whole chain
  amplifies such steps, ``HYBRID_TOL``).
* ``loss_fn``'s loss, ``aux`` and every gradient against
  ``jax.value_and_grad`` in float32 (JAX's weights from ``PRNGKey(0)``),
  with remat off and on (the port's remat changes no bit).
* A decode of a group with one kind of cache (Granite, Mamba2, DeepSeek)
  is bitwise what the per-layer loop gives, its K/V or latent caches
  updated in place, as before mixed groups were ported.
* The committed fixture equals a fresh JAX run, stays small, and replays
  here within ``HYBRID_TOL``.
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import stack as jstack
from repro_torch import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import stack as tstack
from repro_torch.models.params import params_from_numpy, tensor_from_numpy
from repro_torch.models.replay import (
    HYBRID_TOL,
    _bf16_steps,
    _widen,
    compare_model_case,
    load_model_replay,
    model_case_ok,
    pad_caches,
    replay_model_case,
    seeded_params,
)
from repro_torch.utils.trees import tree_flatten_with_paths, tree_map

ARCH = "jamba_1_5_large_398b"


def _np(t):
    return t.detach().float().numpy()


def _bits(t):
    return t.detach().to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


@pytest.fixture(scope="module")
def fixture_weights():
    """(port config, JAX cases, the fixture's bfloat16 weights on the CPU)."""
    jcfg, cases = model_fixture(ARCH)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    return tcfg, cases, params_from_numpy(seeded_params(tcfg, 0), tcfg, "cpu")


def test_decode_cache_specs_match_jax():
    jcfg = jconfig.get_smoke_arch(ARCH)
    jstructs, _ = jmodel.decode_cache_specs(jcfg, 2, 32)
    specs = tmodel.decode_cache_specs(tconfig.get_smoke_arch(ARCH), 2, 32)
    assert len(specs) == len(jstructs) == 1
    assert sorted(specs[0]) == sorted(jstructs[0]) == ["blk0", "blk1", "blk2", "blk3"]
    for blk, names in jstructs[0].items():
        assert sorted(specs[0][blk]) == sorted(names)
        for n, js in names.items():
            assert specs[0][blk][n].shape == js.shape
            assert str(specs[0][blk][n].dtype) == "torch." + str(js.dtype)


def _recorded_prefill(monkeypatch, params, cfg, tokens):
    """``prefill`` with every ``moe_forward`` call's dispatch recorded:
    (logits, caches, [(groups, pairs dropped) per MoE layer])."""
    plain, seen = tmoe.moe_forward, []

    def moe_forward(p, c, x):
        xg, _, _, plan = tmoe.moe_plan(p, c, x)
        seen.append((xg.shape[0], int((~plan[0]).sum())))
        return plain(p, c, x)

    monkeypatch.setattr(tmoe, "moe_forward", moe_forward)
    out = tmodel.prefill(params, cfg, {"tokens": tokens})
    monkeypatch.setattr(tmoe, "moe_forward", plain)
    return (*out, seen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(fixture_weights, monkeypatch, dtype):
    """Prefill logits and caches, then the fixture's greedy decode steps on
    the K/V padded to the prompt plus the steps, against JAX's fresh run;
    the mixed cache tree; K/V updated in place, SSM states new."""
    tcfg, cases, params = fixture_weights
    case, tol = cases[dtype], HYBRID_TOL[dtype]
    cfg = dataclasses.replace(tcfg, dtype=dtype)
    if dtype == "float32":
        params = _widen(params)
    tokens = torch.from_numpy(case["tokens"])
    logits, caches, moe_calls = _recorded_prefill(monkeypatch, params, cfg, tokens)
    b, s = tokens.shape
    # grouped dispatch (one group a row) in all 4 MoE layers, with drops
    assert [g for g, _ in moe_calls] == [b] * 4 and sum(d for _, d in moe_calls) > 0
    assert {blk: sorted(c) for blk, c in caches[0].items()} == {
        "blk0": ["conv", "ssd"], "blk1": ["conv", "ssd"], "blk2": ["k", "v"],
        "blk3": ["conv", "ssd"]}
    assert caches[0]["blk2"]["k"].shape == (2, b, s, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    assert caches[0]["blk0"]["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits[:, 0]), case["prefill_logits"], rtol=0,
                               atol=tol["logits"])
    for blk, c in caches[0].items():
        for n, t in c.items():
            want = case[f"cache/g0/{blk}/{n}"]
            if n == "conv":      # bfloat16 in both: at most one step apart where not within tol
                far = np.abs(_np(t) - want) > tol["cache"]
                apart = _bf16_steps(_bits(t), _bits(torch.from_numpy(want.copy())))
                assert not (far & (apart > 1)).any(), blk
            else:
                np.testing.assert_allclose(_np(t), want, rtol=0, atol=tol["cache"],
                                           err_msg=f"{blk}/{n}")

    steps = len(case["fed"])
    kv = {n: torch.zeros((2, b, s + steps, *t.shape[3:]), dtype=t.dtype)
          for n, t in caches[0]["blk2"].items()}
    for n, t in kv.items():
        t[:, :, :s] = caches[0]["blk2"][n]
    caches = [dict(caches[0], blk2=kv)]
    pos = torch.full((b,), s, dtype=torch.int32)
    decode_groups = []
    plain = tmoe.moe_plan

    def moe_plan(p, c, x):
        out = plain(p, c, x)
        decode_groups.append((out[0].shape[0], int((~out[3][0]).sum())))
        return out

    monkeypatch.setattr(tmoe, "moe_plan", moe_plan)
    for step, fed in enumerate(case["fed"]):
        before = caches[0]
        out, caches = tmodel.decode_step(params, cfg, torch.from_numpy(fed[:, None].copy()), pos,
                                         caches)
        assert caches[0]["blk2"]["k"] is kv["k"] and caches[0]["blk2"]["v"] is kv["v"]
        for blk in ("blk0", "blk1", "blk3"):
            assert caches[0][blk]["ssd"] is not before[blk]["ssd"]
            assert caches[0][blk]["conv"].dtype == (torch.float32 if dtype == "float32"
                                                    else torch.bfloat16)
        np.testing.assert_allclose(_np(out[:, 0]), case["logits"][step], rtol=0,
                                   atol=tol["logits"], err_msg=f"step {step}")
        pos = pos + 1
    monkeypatch.setattr(tmoe, "moe_plan", plain)
    # the global dispatch (one group of B tokens), which never drops at 2 tokens
    assert decode_groups == [(1, 0)] * (4 * steps)
    assert bool((kv["k"][:, :, s:] != 0).any(dim=(0, 1, 3, 4)).all())


def test_blocks_in_bfloat16_match_jax_fed_jax_inputs():
    """Teacher-forced block by block in bfloat16 (the fixture's weights and
    prompts): each of the 8 blocks' outputs, given JAX's input to that
    block, against JAX's output, in bfloat16 steps."""
    jcfg, cases = model_fixture(ARCH)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = seeded_jax_params(jcfg)
    tp = params_from_numpy(seeded_params(tcfg, 0), tcfg, "cpu")
    tokens = cases["bfloat16"]["tokens"]
    x = jlayers.embed_tokens(jp["embed"], jnp.asarray(tokens))
    pos = jnp.broadcast_to(jnp.arange(tokens.shape[1])[None], tokens.shape)
    tpos = torch.from_numpy(np.asarray(pos, np.int32))
    _, (g,) = jstack.plan_groups(jcfg)
    blocks = [jax.jit(functools.partial(
        lambda bp, x, bd: jstack._apply_block(bp, jcfg, bd, x, pos, "train", None, None, None)[0],
        bd=bd)) for bd in g.blocks]
    for s in range(g.steps):
        for i, bd in enumerate(g.blocks):
            jb = jax.tree.map(lambda a: a[s], jp["dec"]["g0"][f"blk{i}"])
            tb = tstack._index(tp["dec"]["g0"][f"blk{i}"], s)
            jy = blocks[i](jb, x)
            tin = tensor_from_numpy(np.asarray(x), torch.bfloat16, "cpu")
            ty, _, _ = tstack._apply_block(tb, tcfg, bd, tin, tpos, "train", None, None)
            want = np.asarray(jy).view(np.uint16)
            steps = _bf16_steps(_bits(ty), want)
            # a step of the output's magnitude: values far below it may differ more
            ulp = 2.0 ** (np.floor(np.log2(np.abs(np.asarray(jy, np.float32)).max())) - 7)
            diff = np.abs(_np(ty) - np.asarray(jy, np.float32))
            label = f"step {s} block {i} {bd.mixer}+{bd.ffn}"
            assert diff.max() <= 2 * ulp, (label, diff.max(), ulp)
            assert ((steps > 1) & (diff > ulp)).mean() <= 0.005, label
            x = jy


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    """``loss_fn`` (CE + 0.01 x aux over the 4 MoE layers) and its gradient
    of every leaf, float32, JAX's weights: loss and aux within 1e-6
    relative, each gradient within 1e-4 of its leaf's largest |value| (as
    ``test_torch_moe_slice.py``); the port's remat changes no bit, and both
    are held to JAX's gradient without remat (JAX's recomputes the same
    operations)."""
    jcfg, jparams = _jax_f32_model()
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jloss, jaux, jce, jflat = _jax_loss_and_grads()
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(np.roll(tokens, -1, axis=1))}
    live = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, met = tmodel.loss_fn(live, tcfg, batch, remat=remat)
    leaves = tree_flatten_with_paths(live)
    grads = torch.autograd.grad(loss, [v for _, v in leaves])
    assert float(met["aux"].detach()) > 0
    for got, want in ((loss, jloss), (met["aux"], jaux), (met["ce"], jce)):
        assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    assert sorted(jflat) == sorted(k for k, _ in leaves)
    for (k, _), g in zip(leaves, grads):
        scale = max(float(np.abs(jflat[k]).max()), 1e-30)
        assert float(np.abs(_np(g) - jflat[k]).max()) <= 1e-4 * scale, k
    if remat:
        live2 = tree_map(lambda p: p.detach().requires_grad_(True), tp)
        loss2, _ = tmodel.loss_fn(live2, tcfg, batch, remat=False)
        grads2 = torch.autograd.grad(loss2, [v for _, v in tree_flatten_with_paths(live2)])
        assert torch.equal(loss.detach(), loss2.detach())
        assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@functools.cache
def _jax_f32_model():
    jcfg = dataclasses.replace(jconfig.get_smoke_arch(ARCH), dtype="float32")
    return jcfg, jmodel.init_model(jax.random.PRNGKey(0), jcfg)


@functools.cache
def _jax_loss_and_grads():
    """JAX's loss, aux, CE and flat gradients for the loss test's batch."""
    jcfg, jparams = _jax_f32_model()
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(np.roll(tokens, -1, axis=1))}
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, batch), has_aux=True))(jparams)
    return float(loss), float(met["aux"]), float(met["ce"]), jax_flat_params(g)


# ---------------------------------------------------------------------------
# Groups with one kind of cache decode as before
# ---------------------------------------------------------------------------

def _loop_decode(params, cfg, token, pos, caches):
    """``decode_step`` spelled layer by layer: attention and MLA layers
    write their views in place, Mamba2 layers' states are stacked."""
    x = tmodel.embed_tokens(params["embed"], token)
    _, groups = tstack.plan_groups(cfg)
    out = []
    for i, g in enumerate(groups):
        gp, cache, new = params["dec"][f"g{i}"], caches[i], []
        for s in range(g.steps):
            step = {}
            for j, bd in enumerate(g.blocks):
                x, step[f"blk{j}"], _ = tstack._apply_block(
                    tstack._index(gp[f"blk{j}"], s), cfg, bd, x, None, "decode",
                    tstack._index(cache[f"blk{j}"], s), pos)
            new.append(step)
        out.append({blk: cache[blk] if bd.mixer != "ssm" else
                    {n: torch.stack([st[blk][n] for st in new]) for n in new[0][blk]}
                    for blk, bd in zip(new[0], g.blocks)})
    x = tmodel.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ tmodel._lm_head_weight(params, cfg)).float(), out


def _clone(caches):
    return [{blk: {n: t.clone() for n, t in c.items()} for blk, c in g.items()} for g in caches]


@pytest.mark.parametrize("arch", ["granite_8b", "mamba2_370m", "deepseek_v2_lite_16b", ARCH])
def test_decode_is_the_per_layer_loop(arch):
    """Three float32 decode steps after a 12-token prefill: logits and
    caches bitwise equal to ``_loop_decode``'s; attention and MLA caches
    come back as the tensors passed in."""
    cfg = dataclasses.replace(tconfig.get_smoke_arch(arch), dtype="float32")
    params = tmodel.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    _, caches = tmodel.prefill(params, cfg, {"tokens": tokens})
    a = pad_caches(caches, 16)
    b = _clone(a)
    pos = torch.full((2,), 12, dtype=torch.int32)
    tok = tokens[:, -1:]
    for _ in range(3):
        la, na = tmodel.decode_step(params, cfg, tok, pos, a)
        lb, b = _loop_decode(params, cfg, tok, pos, b)
        assert torch.equal(la, lb)
        for g_new, g_old in zip(na, a):
            for blk, c in g_new.items():
                for n, t in c.items():
                    assert (t is g_old[blk][n]) == (n in ("k", "v", "latent")), (blk, n)
        a = na
        for ga, gb in zip(a, b):
            for blk in ga:
                for n in ga[blk]:
                    assert torch.equal(ga[blk][n], gb[blk][n]), (blk, n)
        tok = la[:, 0].argmax(-1).to(torch.int32)[:, None]
        pos = pos + 1


# ---------------------------------------------------------------------------
# The committed fixture that chip_smoke.py replays on the card
# ---------------------------------------------------------------------------

def test_committed_hybrid_fixture_equals_regenerated():
    jcfg, cases = model_fixture(ARCH)
    cfg, _, committed = load_model_replay(MODEL_FIXTURES[ARCH])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert sorted(committed) == sorted(cases) == ["bfloat16", "float32"]
    for name, fields in cases.items():
        assert sorted(committed[name]) == sorted(fields)
        for k, v in fields.items():
            assert committed[name][k].dtype == v.dtype, (name, k)
            np.testing.assert_array_equal(committed[name][k], v, err_msg=f"{name}.{k}")


def test_hybrid_fixture_is_small():
    assert os.path.getsize(MODEL_FIXTURES[ARCH]) < 300_000


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_fixture_replays_on_cpu(dtype):
    cfg, tree, cases = load_model_replay(MODEL_FIXTURES[ARCH])
    res = compare_model_case(cases[dtype], replay_model_case(cfg, tree, dtype, cases[dtype], "cpu"),
                             HYBRID_TOL[dtype])
    assert model_case_ok(res, HYBRID_TOL[dtype]), res
