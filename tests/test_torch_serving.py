"""The port's serving path against the JAX package's, on Granite-8B's smoke
config with the same weights (``params_from_numpy``), and Granite-3-8B's
(head size 12: K/V rows of 24 bytes in bfloat16) through its own fixture.

* Float32 weights, where the point is the engine's algorithm: the same
  finished requests, tokens, prefix reuse and page-manager stats, and
  teacher-forced logits within ``F32_TOL``.  The pool holds bfloat16 in
  both frameworks, and a float32 K/V value that differs in its last bits
  can round to the neighbouring bfloat16 value: that moves a logit by up
  to 1.2e-3 on these seeds, so ``F32_TOL`` is 5e-3.  Tokens are compared
  on seeds whose top-2 margin exceeds ``2 * F32_TOL`` at every step (the
  test asserts it), where no such difference can flip a greedy choice.
* Bfloat16, the path as served: the committed fixture of JAX's run,
  replayed teacher-forced, logits within ``BF16_TOL``.  The frameworks
  round bfloat16 intermediates at different places (XLA's bfloat16
  logistic differs from torch's in ~30% of elements), which moves these
  logits (|logit| <= 3.4) by up to 0.107; ``BF16_TOL`` is 0.25, and the
  greedy token is compared at every step whose margin exceeds twice that.
* Page-manager stats equal JAX's exactly, in the normal and the tight-pool
  runs, spill and fetch bytes included.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch_parity import SERVE_FIXTURE, SERVE_FIXTURES, jax_serve_run, serve_fixture, serve_prompts

from repro import config as jconfig
from repro.models import model as jmodel
from repro.serving import kv_cache as jkv
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import ServeEngine, TeacherForcedEngine
from repro_torch.serving.kv_cache import FlicPageManager
from repro_torch.serving.replay import CASES, compare_case, load_serve_replay, replay_case
from repro_torch.utils.hashing import hash2_u32, hash2_u32_int, to_i32

F32_TOL = 5e-3
BF16_TOL = 0.25
ENGINE = dict(max_batch=2, max_seq=64, page_size=8)


def _smoke(dtype):
    jcfg = dataclasses.replace(jconfig.get_smoke_arch("granite_8b"), dtype=dtype)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = jmodel.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def test_page_key_equals_jax():
    rng = np.random.default_rng(0)
    uids = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    idxs = rng.integers(0, 4096, 1000, dtype=np.uint64)
    got = [FlicPageManager.page_key(int(u), int(i)) for u, i in zip(uids, idxs)]
    want = [jkv.FlicPageManager.page_key(int(u), int(i)) for u, i in zip(uids, idxs)]
    assert got == want
    tensor = hash2_u32(to_i32(torch.from_numpy(uids.astype(np.int64))),
                       to_i32(torch.from_numpy(idxs.astype(np.int64))))
    assert [hash2_u32_int(int(u), int(i)) for u, i in zip(uids[:50], idxs[:50])] == \
        [int(x) & 0xFFFFFFFF for x in tensor[:50]]


@pytest.mark.parametrize("seed", [1, 2])
def test_engine_matches_jax_float32(seed):
    jcfg, tcfg, jp, tp = _smoke("float32")
    prompts = serve_prompts(jcfg.vocab_size, 4, 16, seed)
    jeng, jlogits = jax_serve_run(jcfg, jp, prompts, 6, **ENGINE)
    for rows in jlogits.values():
        top2 = np.sort(rows, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 2 * F32_TOL).all()

    free = ServeEngine(tcfg, tp, device="cpu", **ENGINE)
    for p in prompts:
        free.submit(p, max_new=6)
    free.run()
    assert [(r.rid, r.tokens, r.reused_prefill) for r in free.finished] == \
        [(r.rid, r.tokens, r.reused_prefill) for r in jeng.finished]
    assert [r.reused_prefill for r in free.finished] == [False] * 4 + [True] * 4
    assert free.mgr.stats == jeng.mgr.stats

    forced = TeacherForcedEngine(tcfg, tp, device="cpu", **ENGINE,
                                 script={r.rid: r.tokens for r in jeng.finished})
    for p in prompts:
        forced.submit(p, max_new=6)
    forced.run()
    for rid, want in jlogits.items():
        got = torch.stack(forced.logits[rid]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL, err_msg=f"request {rid}")


def test_prefix_reuse_and_spill_stats_equal_jax():
    """JAX's ``test_prefix_reuse_and_spill`` on both engines: a 5-page pool
    forces eviction and spill; the stats must be equal."""
    jcfg, tcfg, jp, tp = _smoke("bfloat16")
    rng = np.random.default_rng(1)
    p1 = [int(t) for t in rng.integers(0, jcfg.vocab_size, 8)]
    p2 = [int(t) for t in rng.integers(0, jcfg.vocab_size, 8)]
    kw = dict(max_batch=1, max_seq=32, page_size=8, num_pages=5)
    jeng = JaxEngine(jcfg, jp, kernel_backend="xla", **kw)
    teng = ServeEngine(tcfg, tp, device="cpu", **kw)
    for p in (p1, p2, p1):
        for eng in (jeng, teng):
            eng.submit(p, max_new=4)
            eng.run()
        assert teng.mgr.stats == jeng.mgr.stats
    st = teng.mgr.stats
    assert st["evict"] > 0 and st["spill_bytes"] > 0
    assert st["prefix_hits"] + st["prefix_store_hits"] > 0
    assert [r.reused_prefill for r in teng.finished] == [r.reused_prefill for r in jeng.finished]


def _replays_on_cpu(path, case):
    cfg, params, cases = load_serve_replay(path, "cpu")
    c = cases[case]
    res = compare_case(c, replay_case(cfg, params, c, "cpu"), BF16_TOL)
    assert res["max_abs_diff"] <= BF16_TOL, res
    assert res["argmax_equal_where_decided"] and res["steps_decided"] > 0, res
    assert res["reused_equal"] and res["stats_equal"], res
    if case == "tight":  # eviction, spill and fetch from the store all ran
        assert c["stats"]["evict"] > 0 and c["stats"]["fetch_bytes"] > 0
    return cfg


@pytest.mark.parametrize("case", CASES)
def test_fixture_replays_on_cpu(case):
    _replays_on_cpu(SERVE_FIXTURE, case)


@pytest.mark.parametrize("case", CASES)
def test_granite3_fixture_replays_on_cpu(case):
    """JAX's Granite-3-8B smoke run, teacher-forced, to ``BF16_TOL``."""
    cfg = _replays_on_cpu(SERVE_FIXTURES["granite_3_8b"], case)
    assert cfg.name == "granite3-smoke" and cfg.resolved_head_dim == 12


def _regenerates(arch):
    path = SERVE_FIXTURES[arch]
    jcfg, flat, cases = serve_fixture(arch)
    with np.load(path) as z:
        committed = {k: z[k] for k in z.files}
    assert json.loads(str(committed.pop("config"))) == dataclasses.asdict(jcfg)
    for k, a in flat.items():
        np.testing.assert_array_equal(committed.pop(f"param.{k}"), np.asarray(a).view(np.uint16))
    for name, fields in cases.items():
        for k, v in fields.items():
            np.testing.assert_array_equal(committed.pop(f"{name}.{k}"), np.asarray(v),
                                          err_msg=f"{name}.{k}")
    assert not committed
    assert os.path.getsize(path) < 300_000


def test_committed_serve_fixture_equals_regenerated():
    _regenerates("granite_8b")


def test_committed_granite3_fixture_equals_regenerated():
    _regenerates("granite_3_8b")


def test_engine_matches_contiguous_decode():
    """JAX's ``test_engine_matches_contiguous`` on the port: the paged
    engine's greedy tokens equal a contiguous-cache ``decode_step`` loop."""
    _, tcfg, _, tp = _smoke("bfloat16")
    prompt = [int(t) for t in np.random.default_rng(0).integers(0, tcfg.vocab_size, 16)]
    _, caches = tmodel.prefill(tp, tcfg, {"tokens": torch.tensor([prompt], dtype=torch.int32)})
    specs = tmodel.decode_cache_specs(tcfg, 1, 64)
    padded = [{"blk0": {n: torch.nn.functional.pad(
        caches[0]["blk0"][n].to(specs[0]["blk0"][n].dtype), (0, 0, 0, 0, 0, 64 - 16))
        for n in ("k", "v")}}]
    pos = torch.tensor([16], dtype=torch.int32)
    tok = torch.tensor([[prompt[-1]]], dtype=torch.int32)
    want = []
    for _ in range(6):
        logits, padded = tmodel.decode_step(tp, tcfg, tok, pos, padded)
        want.append(int(logits[0, 0].argmax()))
        tok = torch.tensor([[want[-1]]], dtype=torch.int32)
        pos = pos + 1
    for backend in (None, "plain"):
        eng = ServeEngine(tcfg, tp, max_batch=2, max_seq=64, page_size=8, device="cpu",
                          kernel_backend=backend)
        eng.submit(prompt, max_new=6)
        assert eng.run()[0].tokens == want


def test_engine_arguments():
    _, tcfg, _, tp = _smoke("bfloat16")
    with pytest.raises(ValueError, match="kernel_backend"):
        ServeEngine(tcfg, tp, device="cpu", kernel_backend="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(tcfg, tp)


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--smoke", "--device", "cpu", "--requests", "4", "--max-new", "4",
                "--prompt-len", "16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 4 and out["generated_tokens"] == 16
    assert out["prefill_reuse"] == 2 and out["device"] == "cpu"
