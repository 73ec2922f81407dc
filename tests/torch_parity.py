"""Parity helpers between the JAX package and the PyTorch port.

Not a test module: it imports both packages, which only tests may do.

* ``torch_config`` converts a JAX ``SimConfig`` into the port's.
* ``jax_draw_arrays`` steps JAX's plan stage and channel key splits
  in-process — ``workload.plan_tick``, then ``jax.random.uniform`` on the
  keys and shapes that ``simulator._advance_channel``,
  ``_delivery_mask_dense``, ``_response_mask_compact`` and
  ``backing_store.commit_writes`` use — and returns every tick's draws in
  the replay format of ``repro_torch.core.replay``.  No JAX file changes.
* ``jax_shard_draw_arrays`` does the same for the sharded engine's
  per-shard key chains, one draw series per rank.
* ``jax_series``/``jax_state_arrays`` flatten JAX results to numpy.
* ``replay_fixture_arrays``/``write_replay_fixture`` build the committed
  replay files that ``chip_smoke.py`` runs on the card, every conformance
  case at seeds 0 and 1 (``fixture_path``);
  ``serve_fixture``/``write_serve_fixture`` the serving ones (Granite-8B's
  and Granite-3-8B's smoke configs);
  ``ssm_fixture``/``write_ssm_fixture`` the Mamba2 one (``jax_ssm_run``);
  ``moe_fixture``/``write_moe_fixture`` the MoE ones (``jax_model_run``:
  DeepSeek-V2-Lite's and Qwen3-MoE's smoke configs on ``seeded_params``
  weights), ``model_fixture``/``write_model_fixture`` the hybrid (Jamba's
  smoke config) and VLM (InternVL2's, with patches) ones in the same
  format; ``train_fixture``/``write_train_fixture`` the training ones
  (``jax_train_run``: three steps of JAX's ``make_train_step``).
* ``jax_flat_params``/``nested`` move parameter trees between the layouts.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import metrics as jmet
from repro.core import simulator as jsim
from repro.core import workload as jwl
from repro_torch.core import backing_store as tbs
from repro_torch.core import simulator as tsim
from repro_torch.core import workload as twl
from repro_torch.core.metrics import EMBODIMENT_FIELDS, field_names, summarize
from repro_torch.core.replay import draws_from_arrays, save_replay

FIXTURE_SEEDS = (0, 1)
FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch", "testdata")
_PLAN_KEY_FIELDS = ("k_deliver", "k_resp", "k_coll", "rng_next", "state_next")


def torch_config(jcfg, **overrides) -> tsim.SimConfig:
    """The port's ``SimConfig`` with the JAX config's field values."""
    d = dataclasses.asdict(jcfg)
    w = d["workload"]
    if w["trace"] is not None:
        w["trace"] = twl.TraceSpec(**w["trace"])
    d["workload"] = twl.WorkloadSpec(**w)
    d["store"] = tbs.StoreProfile(**d["store"])
    d.update(overrides)
    return tsim.SimConfig(**d)


def _tick_draws(cfg):
    """One scan step of JAX's plan and channel draws for ``cfg``."""
    n = cfg.n_nodes
    cols = n if cfg.workload.fanout is None else cfg.workload.fanout

    def step(carry, _):
        plan_state, rng, t = carry
        plan = jwl.plan_tick(cfg, plan_state, t, rng)
        out = {"t": t}
        for f in dataclasses.fields(plan):
            if f.name not in _PLAN_KEY_FIELDS:
                out[f"plan.{f.name}"] = getattr(plan, f.name)
        for f in dataclasses.fields(plan.state_next):
            out[f"plan.state_next.{f.name}"] = getattr(plan.state_next, f.name)
        k_mask = plan.k_deliver
        if cfg.loss_model == "gilbert_elliott":
            # gilbert_elliott_advance: split(k_deliver, 3) -> (up, down, mask)
            k_up, k_dn, k_mask = jax.random.split(plan.k_deliver, 3)
            out["u_ge_up"] = jax.random.uniform(k_up, (n,))
            out["u_ge_dn"] = jax.random.uniform(k_dn, (n,))
        if cfg.loss_model != "none":
            if jsim._needs_delivery_mask(cfg):
                out["u_deliver"] = jax.random.uniform(k_mask, (n, cols))
            r = plan.slot_nid.shape[0]
            out["u_resp"] = jax.random.uniform(plan.k_resp, (r, cols))
        if cfg.store.collision_prob > 0.0:
            out["u_coll"] = jax.random.uniform(plan.k_coll, ())
        return (plan.state_next, plan.rng_next, t + 1), out

    return step


def jax_draw_arrays(jcfg, ticks: int, seed: int = 0, start=None) -> dict[str, np.ndarray]:
    """Every tick's draws as stacked numpy arrays (replay format).

    ``start`` is a JAX ``SimState`` to continue from (default: the initial
    state of ``seed``).  Only its plan state, key and tick are read.
    """
    if start is None:
        start = jsim.init_sim(dataclasses.replace(jcfg, seed=seed))
    scan = jax.jit(lambda c: jax.lax.scan(_tick_draws(jcfg), c, None, length=ticks))
    _, out = scan((start.plan, start.rng, start.tick))
    return {k: np.asarray(v) for k, v in out.items()}


def jax_shard_draw_arrays(jcfg, ticks: int, seed: int, world: int) -> list[dict]:
    """Per rank, every tick's draws of JAX's sharded engine, stepped
    in-process on its per-shard key chain (``repro.core.sharded``):
    ``fold_in(PRNGKey(seed), rank)``, then ``split(rng, 5)`` each tick into
    (next, write, read, channel, collision) keys; the write key ids from
    ``fold_in(k_write, WRITE_SALT)`` and the read ids from ``k_read``
    (``sample_key_ids``); ``gilbert_elliott_advance``'s uniforms from
    ``split(k_chan, 3)``; the gossip and response loss uniforms from
    ``fold_in(k_mask, 1)`` and ``fold_in(k_mask, 2)``; ``commit_writes``'
    collision uniform from ``k_coll``.  Returns one dict per rank of
    ``repro_torch.core.sharded.ShardDraws`` fields stacked over ticks."""
    from repro_torch.core.sharded import gossip_fanout

    n_local = jcfg.n_nodes // world
    spec = jcfg.workload
    k_g = gossip_fanout(jcfg, n_local)

    def step(rng, _):
        rng_next, k_write, k_read, k_chan, k_coll = jax.random.split(rng, 5)
        out = {"w_kids": jwl.sample_key_ids(
            spec, jax.random.fold_in(k_write, jwl.WRITE_SALT), (n_local,))}
        k_mask = k_chan
        if jcfg.loss_model == "gilbert_elliott":
            k_up, k_dn, k_mask = jax.random.split(k_chan, 3)
            out["u_ge_up"] = jax.random.uniform(k_up, (n_local,))
            out["u_ge_dn"] = jax.random.uniform(k_dn, (n_local,))
        if jcfg.loss_model != "none" and k_g:
            out["u_gossip"] = jax.random.uniform(jax.random.fold_in(k_mask, 1), (n_local, k_g))
        out["r_kids"] = jwl.sample_key_ids(spec, k_read, (n_local,))
        if jcfg.loss_model != "none":
            out["u_resp"] = jax.random.uniform(jax.random.fold_in(k_mask, 2),
                                               (n_local, n_local))
        if jcfg.store.collision_prob > 0.0:
            out["u_coll"] = jax.random.uniform(k_coll, ())
        return rng_next, out

    scan = jax.jit(lambda rng: jax.lax.scan(step, rng, None, length=ticks)[1])
    ranks = []
    for rank in range(world):
        out = scan(jax.random.fold_in(jax.random.PRNGKey(seed), rank))
        ranks.append({"t": np.arange(ticks), **{k: np.asarray(v) for k, v in out.items()}})
    return ranks


def jax_series(series) -> dict[str, np.ndarray]:
    return {f.name: np.asarray(getattr(series, f.name)) for f in dataclasses.fields(series)}


def jax_state_arrays(state) -> dict[str, np.ndarray]:
    """A JAX ``SimState`` flattened by field path (``caches.tags``, ...)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {".".join(k.name for k in path): np.array(v) for path, v in leaves}


def torch_draws(tcfg, arrays):
    return draws_from_arrays(tcfg, arrays, "cpu")


def assert_series_equal(expected: dict, got, label: str = "") -> None:
    """Every TickMetrics field but the embodiment ones, bitwise."""
    for f in field_names():
        if f in EMBODIMENT_FIELDS:
            continue
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), expected[f],
            err_msg=f"{label}: TickMetrics.{f} diverged",
        )


@functools.lru_cache(maxsize=None)
def jax_case(name: str, seed: int = 0):
    """(draw arrays, series, summary) of conformance case ``name`` on JAX's
    fused engine."""
    from conformance import CASES

    c = CASES[name]
    arrays = jax_draw_arrays(c.cfg, c.ticks, seed)
    _, series = jsim.run_sim(c.cfg, c.ticks, seed, engine="fused",
                             metrics_every=c.metrics_every)
    return arrays, jax_series(series), jmet.summarize(series)


@functools.lru_cache(maxsize=None)
def torch_case(name: str, backend, seed: int = 0, engine: str = "fused"):
    """The port's series of case ``name`` on JAX's replayed draws (CPU)."""
    from conformance import CASES

    c = CASES[name]
    tcfg = torch_config(c.cfg, probe_backend=backend)
    _, series = tsim.run_any_engine(tcfg, c.ticks, engine=engine, device="cpu",
                                    metrics_every=c.metrics_every,
                                    draws=torch_draws(tcfg, jax_case(name, seed)[0]))
    return series


# The 17 conformance cases, in four groups so the test workers share them out.
STREAM = ("paper", "paper_outage", "paper_ge", "stream_churn", "fanout_topk", "trace")
ZIPF = ("zipf", "zipf_hot", "zipf_outage", "zipf_thinned", "poisson")
MODULATED = ("bursty", "diurnal", "churn", "storm", "churn_outage")
POLICY = ("paper_replicate",)
FIXTURE_CASES = STREAM + ZIPF + MODULATED + POLICY


def case_seeds(cases) -> list:
    """``pytest.param(case, seed)`` for every case at seeds 0 and 1; a seed-0
    id is the case's name alone, a seed-1 id ends in ``-s1``."""
    import pytest

    return [pytest.param(c, s, id=c if s == 0 else f"{c}-s1")
            for s in FIXTURE_SEEDS for c in cases]


def check_series(name: str, backend, seed: int = 0) -> None:
    """The port's TickMetrics series equals JAX's bitwise."""
    assert_series_equal(jax_case(name, seed)[1], torch_case(name, backend, seed),
                        f"{name}/{backend}/seed{seed}")


def check_reference(name: str, seed: int = 0) -> None:
    """The port's reference engine emits JAX's fused series bitwise (JAX's
    reference emits the same), and so the port's own fused series."""
    ref = torch_case(name, None, seed, "reference")
    assert_series_equal(jax_case(name, seed)[1], ref, f"{name}/reference/seed{seed}")
    fused = torch_case(name, None, seed)
    assert_series_equal({f: getattr(fused, f).numpy() for f in field_names()}, ref,
                        f"{name}/reference vs fused/seed{seed}")


def check_summary(name: str, seed: int = 0) -> None:
    """``summarize``: integer fields exactly; float fields to rtol 1e-6,
    because the two frameworks may add up a float32 series in different
    orders (the per-tick series themselves are bitwise equal)."""
    want = jax_case(name, seed)[2]
    got = summarize(torch_case(name, None, seed))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, k
        else:
            assert abs(got[k] - w) <= 1e-6 * abs(w), (k, got[k], w)


def key_pool(rng: np.random.Generator, size: int = 24) -> np.ndarray:
    """uint32 keys, half of them >= 2**31, plus the NULL tag's pattern."""
    lo = rng.integers(0, 2**31, size // 2, dtype=np.uint64)
    hi = rng.integers(2**31, 2**32 - 1, size - size // 2, dtype=np.uint64)
    return np.concatenate([lo, hi, [2**32 - 1]]).astype(np.uint32)


def arbitrary_tables(rng: np.random.Generator, n: int, s: int, w: int, d: int,
                     pool: np.ndarray) -> dict[str, np.ndarray]:
    """Arbitrary batched cache tables (JAX dtypes): tags drawn from a small
    pool, so sets hold duplicate tags, and timestamps tie often."""
    shape = (n, s, w)
    return dict(
        tags=pool[rng.integers(0, len(pool), shape)],
        data_ts=rng.integers(-1, 12, shape).astype(np.int32),
        ins_ts=rng.integers(-1, 12, shape).astype(np.int32),
        origin=rng.integers(-1, n, shape).astype(np.int32),
        valid=rng.random(shape) < 0.7,
        dirty=rng.random(shape) < 0.3,
        last_use=rng.integers(-1, 6, shape).astype(np.int32),
        data=rng.random((*shape, d)).astype(np.float32),
    )


def as_torch(a: np.ndarray):
    """numpy -> CPU tensor; uint32 keeps its bit pattern as int32."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def as_numpy(t, like: np.ndarray | None = None) -> np.ndarray:
    """CPU tensor -> numpy, viewed as uint32 where ``like`` is uint32."""
    a = t.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32:
        a = a.view(np.uint32)
    return a


def fixture_path(case: str, seed: int = 0, directory: str = FIXTURE_DIR) -> str:
    """``replay_<case>.npz`` at seed 0, ``replay_<case>_s<seed>.npz`` else."""
    suffix = "" if seed == 0 else f"_s{seed}"
    return os.path.join(directory, f"replay_{case}{suffix}.npz")


def replay_fixture_arrays(case: str, seed: int = 0) -> tuple[tsim.SimConfig, dict]:
    """(port config, arrays) of the replay file of conformance ``case`` at
    ``seed``: JAX's draws and its fused-engine series, one row a tick."""
    from conformance import CASES

    c = CASES[case]
    draws, series, _ = jax_case(case, seed)
    if c.metrics_every != 1:
        _, thick = jsim.run_sim(c.cfg, c.ticks, seed=seed, engine="fused")
        series = jax_series(thick)
    arrays = dict(draws)
    arrays.update({f"metrics.{k}": v for k, v in series.items()})
    return torch_config(c.cfg), arrays


def write_replay_fixture(case: str, seed: int = 0, directory: str = FIXTURE_DIR) -> str:
    """Write the replay file of ``case`` at ``seed``; returns its path."""
    tcfg, arrays = replay_fixture_arrays(case, seed)
    path = fixture_path(case, seed, directory)
    save_replay(path, tcfg, arrays)
    return path



# ---------------------------------------------------------------------------
# Serving: the JAX engine's run on Granite-8B's smoke config, as a fixture.
# ---------------------------------------------------------------------------

SERVE_FIXTURES = {   # arch -> its committed serve fixture
    "granite_8b": os.path.join(FIXTURE_DIR, "serve_granite8b_smoke.npz"),
    "granite_3_8b": os.path.join(FIXTURE_DIR, "serve_granite3_smoke.npz"),
}
SERVE_FIXTURE = SERVE_FIXTURES["granite_8b"]


def jax_serve_run(jcfg, jparams, prompts, max_new, **engine_kw):
    """Run the JAX ``ServeEngine`` (``kernel_backend="xla"``) on ``prompts``;
    returns (engine, ``{rid: (steps, V) float32 logits}``).  The logits are
    read by wrapping ``repro.serving.engine.paged_decode_step`` for the
    length of the run; no JAX file changes."""
    import repro.serving.engine as jeng

    eng = jeng.ServeEngine(jcfg, jparams, kernel_backend="xla", **engine_kw)
    logits: dict[int, list] = {}
    real = jeng.paged_decode_step

    def spy(*args, **kw):
        out = real(*args, **kw)
        rows = np.asarray(out[0][:, 0], np.float32)
        for slot, req in enumerate(eng.slots):
            if req is not None:
                logits.setdefault(req.rid, []).append(rows[slot])
        return out

    jeng.paged_decode_step = spy
    try:
        for p in prompts:
            eng.submit(p, max_new=max_new)
        eng.run()
    finally:
        jeng.paged_decode_step = real
    return eng, {rid: np.stack(rows) for rid, rows in logits.items()}


def jax_serve_case(jcfg, jparams, prompts, max_new, max_batch, max_seq, page_size,
                   num_pages=None) -> dict:
    """One replay case (``repro_torch.serving.replay`` format) from a JAX run."""
    eng, logits = jax_serve_run(jcfg, jparams, prompts, max_new, max_batch=max_batch,
                                max_seq=max_seq, page_size=page_size, num_pages=num_pages)
    by_rid = {r.rid: r for r in eng.finished}
    rids = range(1, len(prompts) + 1)
    return {
        "engine": np.asarray([max_batch, max_seq, page_size, num_pages or 0], np.int32),
        "prompts": np.asarray(prompts, np.int32),
        "max_new": np.full((len(prompts),), max_new, np.int32),
        "tokens": np.asarray([by_rid[r].tokens for r in rids], np.int32),
        "logits": np.stack([logits[r] for r in rids]),
        "reused": np.asarray([by_rid[r].reused_prefill for r in rids]),
        "stats": json.dumps(eng.mgr.stats, sort_keys=True),
    }


def serve_prompts(vocab: int, n: int, length: int, seed: int, repeat: int = 2):
    """``n`` distinct prompts of ``length`` tokens, the list repeated."""
    rng = np.random.default_rng(seed)
    uniq = [[int(t) for t in rng.integers(0, vocab, length)] for _ in range(n)]
    return uniq * repeat


def serve_fixture(arch: str = "granite_8b") -> tuple:
    """(JAX config, flat numpy params, cases) of the committed serve fixture
    of ``arch``: its smoke config in bfloat16 (the path as served), weights
    from ``PRNGKey(0)``.  ``main``: 4 prompts of 16 tokens (whole pages),
    each submitted twice, max_batch 2, page 8, 6 new tokens, so the second
    wave reuses the first's pages.  ``tight``: a 5-page pool (4 usable) and
    prompts p1, p2, p3, p1 of 8 tokens at batch 1, so p3 evicts p1's pages
    to the store and the last request fetches them back."""
    from repro.config import get_smoke_arch
    from repro.models import init_model

    jcfg = get_smoke_arch(arch)
    jparams = init_model(jax.random.PRNGKey(0), jcfg)
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    v = jcfg.vocab_size
    p1, p2, p3 = serve_prompts(v, 3, 8, seed=1, repeat=1)
    cases = {
        "main": jax_serve_case(jcfg, jparams, serve_prompts(v, 4, 16, seed=0), 6,
                               max_batch=2, max_seq=64, page_size=8),
        "tight": jax_serve_case(jcfg, jparams, [p1, p2, p3, p1], 4, max_batch=1,
                                max_seq=32, page_size=8, num_pages=5),
    }
    return jcfg, flat, cases


def write_serve_fixture(arch: str = "granite_8b") -> str:
    from repro_torch.config import ModelConfig
    from repro_torch.models.replay import save_model_replay

    path = SERVE_FIXTURES[arch]
    jcfg, flat, cases = serve_fixture(arch)
    save_model_replay(path, ModelConfig(**dataclasses.asdict(jcfg)), flat, cases)
    return path


SSM_FIXTURE = os.path.join(FIXTURE_DIR, "ssm_mamba2_smoke.npz")
SSM_BATCH, SSM_PROMPT, SSM_STEPS = 2, 40, 6


def jax_ssm_run(jcfg, jparams, tokens: np.ndarray, steps: int) -> dict:
    """JAX's ``prefill`` of ``tokens``, then ``steps`` greedy
    ``decode_step``s: one case of ``repro_torch.models.replay``'s format."""
    from repro.models.model import decode_step, prefill

    logits, caches = prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)})
    blk = caches[0]["blk0"]
    case = {"tokens": tokens, "prefill_logits": np.asarray(logits[:, 0], np.float32),
            "conv": np.asarray(blk["conv"]).view(np.uint16),
            "ssd": np.asarray(blk["ssd"][-1], np.float32)}
    tok = tokens[:, -1:]
    pos = np.full((tokens.shape[0],), tokens.shape[1], np.int32)
    fed, out = [], []
    for _ in range(steps):
        fed.append(tok[:, 0])
        logits, caches = decode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), caches)
        out.append(np.asarray(logits[:, 0], np.float32))
        tok = out[-1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    case["fed"] = np.stack(fed).astype(np.int32)
    case["logits"] = np.stack(out)
    return case


@functools.cache
def ssm_fixture() -> tuple:
    """(JAX config, flat numpy params, cases) of the committed Mamba2
    fixture: the smoke config in bfloat16, weights from ``PRNGKey(0)``, 2
    prompts of 40 tokens (two chunks of 16 and a ragged 8), 6 greedy decode
    steps; case ``bfloat16`` runs the weights as they are, case ``float32``
    the float32 model on the same weights widened (exactly).  Cached: the
    returned arrays are shared and must not be changed."""
    from repro.config import get_smoke_arch
    from repro.models import init_model

    jcfg = get_smoke_arch("mamba2_370m")
    jparams = init_model(jax.random.PRNGKey(0), jcfg)
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (SSM_BATCH, SSM_PROMPT)).astype(np.int32)
    wide = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cases = {
        "bfloat16": jax_ssm_run(jcfg, jparams, tokens, SSM_STEPS),
        "float32": jax_ssm_run(dataclasses.replace(jcfg, dtype="float32"), wide, tokens,
                               SSM_STEPS),
    }
    return jcfg, flat, cases


def write_ssm_fixture(path: str = SSM_FIXTURE) -> str:
    from repro_torch.config import ModelConfig
    from repro_torch.models.replay import save_model_replay

    jcfg, flat, cases = ssm_fixture()
    save_model_replay(path, ModelConfig(**dataclasses.asdict(jcfg)), flat, cases)
    return path


MOE_FIXTURES = {arch: os.path.join(FIXTURE_DIR, f"moe_{arch}_smoke.npz")
                for arch in ("deepseek_v2_lite_16b", "qwen3_moe_235b_a22b")}
MOE_BATCH, MOE_PROMPT, MOE_STEPS = 2, 24, 6
# Smoke configs whose JAX weights would take a fixture past 300 KB: their
# files hold ``weights_seed`` and both packages draw ``seeded_params``.
WEIGHTS_SEED = 0


def seeded_jax_params(jcfg, seed: int = WEIGHTS_SEED):
    """``repro_torch.models.replay.seeded_params`` as a JAX parameter tree
    (bfloat16 leaves from their bits)."""
    from repro_torch.config import ModelConfig
    from repro_torch.models.replay import seeded_params

    tree = seeded_params(ModelConfig(**dataclasses.asdict(jcfg)), seed)
    return jax.tree.map(lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16 else a),
                        tree)


def _jax_caches(caches) -> dict:
    return {f"cache/g{i}/{blk}/{n}": np.asarray(jnp.asarray(a, jnp.float32))
            for i, g in enumerate(caches) for blk, c in g.items() for n, a in c.items()}


def jax_model_run(jcfg, jparams, tokens: np.ndarray, steps: int,
                  patches: np.ndarray | None = None) -> dict:
    """JAX's ``prefill`` of ``tokens`` (after ``patches``, where given),
    its sequence caches (K/V, MLA latent) zero-padded to the prompt plus
    ``steps`` in their own dtype, then ``steps`` greedy ``decode_step``s
    from position P+S: one case of ``repro_torch.models.replay``'s model
    fixtures."""
    from repro.models.model import decode_step, prefill

    batch = {"tokens": jnp.asarray(tokens)}
    case = {"tokens": tokens}
    if patches is not None:
        batch["patches"] = jnp.asarray(patches)
        case["patches"] = patches
    logits, caches = prefill(jparams, jcfg, batch)
    case.update({"prefill_logits": np.asarray(logits[:, 0], np.float32), **_jax_caches(caches)})
    pad = [(0, 0), (0, 0), (0, steps)]
    caches = [{blk: {n: jnp.pad(a, pad + [(0, 0)] * (a.ndim - 3)) if n in ("k", "v", "latent")
                     else a for n, a in c.items()} for blk, c in g.items()} for g in caches]
    tok = tokens[:, -1:]
    length = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    pos = np.full((tokens.shape[0],), length, np.int32)
    fed, out = [], []
    for _ in range(steps):
        fed.append(tok[:, 0])
        logits, caches = decode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), caches)
        out.append(np.asarray(logits[:, 0], np.float32))
        tok = out[-1].argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    case["fed"] = np.stack(fed).astype(np.int32)
    case["logits"] = np.stack(out)
    return case


@functools.cache
def moe_fixture(arch: str) -> tuple:
    """(JAX config, cases) of the committed MoE fixture of ``arch``: the
    smoke config in bfloat16 on ``seeded_params`` weights, 2 prompts of 24
    tokens (the grouped dispatch: S >= E), 6 greedy decode steps (the
    global one); case ``bfloat16`` runs the weights as they are, case
    ``float32`` the float32 model on the same weights widened (exactly).
    Cached: the returned arrays are shared and must not be changed."""
    from repro.config import get_smoke_arch

    jcfg = get_smoke_arch(arch)
    jparams = seeded_jax_params(jcfg)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (MOE_BATCH, MOE_PROMPT)).astype(np.int32)
    wide = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cases = {
        "bfloat16": jax_model_run(jcfg, jparams, tokens, MOE_STEPS),
        "float32": jax_model_run(dataclasses.replace(jcfg, dtype="float32"), wide, tokens,
                                 MOE_STEPS),
    }
    return jcfg, cases


def write_moe_fixture(arch: str) -> str:
    from repro_torch.config import ModelConfig
    from repro_torch.models.replay import save_model_replay

    path = MOE_FIXTURES[arch]
    jcfg, cases = moe_fixture(arch)
    save_model_replay(path, ModelConfig(**dataclasses.asdict(jcfg)), {}, cases,
                      weights_seed=WEIGHTS_SEED)
    return path


MODEL_FIXTURES = {   # arch -> its committed hybrid or VLM fixture
    "jamba_1_5_large_398b": os.path.join(FIXTURE_DIR, "hybrid_jamba_1_5_large_398b_smoke.npz"),
    "internvl2_2b": os.path.join(FIXTURE_DIR, "vlm_internvl2_2b_smoke.npz"),
}


def vlm_patches(jcfg, batch: int, seed: int) -> np.ndarray:
    """(B, P, d_model) float32 patch embeddings of bfloat16 values (so both
    model dtypes take them exactly), drawn with numpy from ``seed``."""
    x = np.random.default_rng(seed).standard_normal((batch, jcfg.frontend_seq, jcfg.d_model))
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@functools.cache
def model_fixture(arch: str) -> tuple:
    """(JAX config, cases) of the committed fixture of ``arch`` (Jamba's
    or InternVL2's smoke config) in ``moe_fixture``'s way: bfloat16 weights
    from ``seeded_params``, 2 prompts of 24 tokens (InternVL2's after
    ``vlm_patches``), 6 greedy decode steps; case ``bfloat16`` runs the
    weights as they are, case ``float32`` the float32 model on the same
    weights widened.  Cached: the returned arrays are shared."""
    from repro.config import get_smoke_arch

    jcfg = get_smoke_arch(arch)
    jparams = seeded_jax_params(jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (MOE_BATCH, MOE_PROMPT)).astype(np.int32)
    patches = vlm_patches(jcfg, MOE_BATCH, 1) if jcfg.family == "vlm" else None
    wide = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cases = {
        "bfloat16": jax_model_run(jcfg, jparams, tokens, MOE_STEPS, patches),
        "float32": jax_model_run(dataclasses.replace(jcfg, dtype="float32"), wide, tokens,
                                 MOE_STEPS, patches),
    }
    return jcfg, cases


def write_model_fixture(arch: str) -> str:
    from repro_torch.config import ModelConfig
    from repro_torch.models.replay import save_model_replay

    path = MODEL_FIXTURES[arch]
    jcfg, cases = model_fixture(arch)
    save_model_replay(path, ModelConfig(**dataclasses.asdict(jcfg)), {}, cases,
                      weights_seed=WEIGHTS_SEED)
    return path


def jax_flat_params(jparams) -> dict[str, np.ndarray]:
    """A JAX parameter (or gradient) tree as ``{"/"-joined path: numpy}``."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}


def nested(flat: dict) -> dict:
    """``{"a/b": x}`` -> ``{"a": {"b": x}}``."""
    tree: dict = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


TRAIN_FIXTURES = {arch: os.path.join(FIXTURE_DIR, f"train_{arch}_smoke.npz")
                  for arch in ("granite_8b", "mamba2_370m", "deepseek_v2_lite_16b",
                               "jamba_1_5_large_398b")}
# Training fixtures on ``seeded_params`` weights (the file holds the seed).
SEEDED_TRAIN = ("deepseek_v2_lite_16b", "jamba_1_5_large_398b")


def jax_train_run(jcfg, jparams) -> dict:
    """JAX's run of one training-fixture case (``repro_torch.train.replay``'s
    format): step 0's gradient of the tracked leaves, then
    ``FIXTURE_RUN["steps"]`` steps of ``make_train_step`` on
    ``synthetic_batch`` of each step, from ``adamw_init``."""
    from repro.data.pipeline import synthetic_batch
    from repro.models.model import loss_fn
    from repro.optim import adamw_init
    from repro.train.train_step import TrainHyper, make_train_step
    from repro_torch.train.replay import FIXTURE_RUN, TRACKED

    run = FIXTURE_RUN
    hyper = TrainHyper(**run["hyper"])
    batches = [synthetic_batch(jcfg, run["seq"], run["batch"], i) for i in range(run["steps"])]
    grads = jax.grad(lambda p: loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batches[0].items()},
                                       remat=hyper.remat, remat_policy=hyper.remat_policy)[0])(jparams)
    step_fn = jax.jit(make_train_step(jcfg, hyper))
    params, opt = jparams, adamw_init(jparams)
    metrics = []
    for i, b in enumerate(batches):
        params, opt, m = step_fn(params, opt, {k: jnp.asarray(v) for k, v in b.items()}, i)
        metrics.append(m)
    init, post, g0 = (jax_flat_params(t) for t in (jparams, params, grads))
    case = {"hyper": np.asarray(json.dumps(run, sort_keys=True)),
            "tokens": np.stack([b["tokens"] for b in batches]),
            "labels": np.stack([b["labels"] for b in batches])}
    for k in ("loss", "grad_norm", "lr"):
        case[k] = np.asarray([np.float32(m[k]) for m in metrics], np.float32)
    for k in TRACKED[jcfg.family]:
        case[f"grad/{k}"] = g0[k].astype(np.float32)
        case[f"post/{k}"] = post[k].astype(np.float32)
    for k in post:
        case[f"update_norm/{k}"] = np.float64(np.linalg.norm(
            post[k].astype(np.float64) - init[k].astype(np.float64)))
    return case


@functools.cache
def train_fixture(arch: str) -> tuple:
    """(JAX config, flat numpy params, cases) of the committed training
    fixture of ``arch``'s smoke config: weights from ``PRNGKey(0)`` in
    bfloat16 (``SEEDED_TRAIN``: ``seeded_params``); case ``bfloat16``
    trains them as they are, case ``float32`` the float32 model on the
    same weights widened (exactly).  Cached: the returned arrays are
    shared and must not be changed."""
    from repro.config import get_smoke_arch
    from repro.models import init_model

    jcfg = get_smoke_arch(arch)
    jparams = (seeded_jax_params(jcfg) if arch in SEEDED_TRAIN
               else init_model(jax.random.PRNGKey(0), jcfg))
    wide = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    cases = {
        "bfloat16": jax_train_run(jcfg, jparams),
        "float32": jax_train_run(dataclasses.replace(jcfg, dtype="float32"), wide),
    }
    return jcfg, jax_flat_params(jparams), cases


def write_train_fixture(arch: str) -> str:
    from repro_torch.config import ModelConfig
    from repro_torch.models.replay import save_model_replay

    path = TRAIN_FIXTURES[arch]
    jcfg, flat, cases = train_fixture(arch)
    if arch in SEEDED_TRAIN:
        save_model_replay(path, ModelConfig(**dataclasses.asdict(jcfg)), {}, cases,
                          weights_seed=WEIGHTS_SEED)
    else:
        save_model_replay(path, ModelConfig(**dataclasses.asdict(jcfg)), flat, cases)
    return path


if __name__ == "__main__":
    for seed in FIXTURE_SEEDS:
        for name in FIXTURE_CASES:
            print(write_replay_fixture(name, seed))
    for arch in SERVE_FIXTURES:
        print(write_serve_fixture(arch))
    print(write_ssm_fixture())
    for arch in MOE_FIXTURES:
        print(write_moe_fixture(arch))
    for arch in MODEL_FIXTURES:
        print(write_model_fixture(arch))
    for arch in TRAIN_FIXTURES:
        print(write_train_fixture(arch))
