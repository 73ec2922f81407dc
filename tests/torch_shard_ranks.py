"""Runs of the port's models under ``repro_torch.shard`` plans on a group of
gloo ranks on the CPU, each rank one process of a (2, 2) ``("data",
"model")`` mesh (``launch.mesh.make_host_mesh``).  Every rank runs every
job; rank 0 reports.  Shared by ``test_torch_shard_ranks.py``; not a test
module.

Jobs:

* ``("train", arch, plan)``: the committed ``train_<arch>_smoke.npz``
  fixture's float32 case through ``train.replay.replay_train_case`` on the
  mesh under ``plan``, and the same case unsharded on rank 0;
* ``("microbatch", arch, plan)``: the gradient of a two-microbatch step
  (``train_step.accumulated_grads``) on a seeded float32 batch whose rows
  keep different numbers of positions (``loss_mask``), under ``plan`` and
  unsharded on rank 0;
* ``("decode", plan)``: one decode step of Granite-8B's smoke config in
  float32 on random caches, under ``plan`` and unsharded;
* ``("scan", plan)``: the chunk scan's kernel entries on DTensors.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "src", "repro_torch", "testdata")
DECODE_BATCH, DECODE_SEQ = 4, 16
DECODE_POS = (3, 8, 12, 15)     # a position in each of the two seq halves
MB_BATCH, MB_SEQ = 4, 32
MB_KEPT = (32, 3, 11, 20)       # positions each row keeps in the loss


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_job(arch: str, plan: str, mesh) -> dict:
    from repro_torch.models.replay import load_model_replay
    from repro_torch.train.replay import replay_train_case

    cfg, tree, cases = load_model_replay(os.path.join(TESTDATA, f"train_{arch}_smoke.npz"))
    got = replay_train_case(cfg, tree, "float32", cases["float32"], "cpu", mesh=mesh, plan=plan)
    if torch.distributed.get_rank() == 0:
        from repro_torch.shard import current_rules

        assert current_rules() == (None, None)
        plain = replay_train_case(cfg, tree, "float32", cases["float32"], "cpu")
        return {"sharded": got, "plain": plain}
    return {}


def _microbatch_job(arch: str, plan: str, mesh) -> dict:
    from repro_torch.config import get_smoke_arch
    from repro_torch.launch.specs import place_tree
    from repro_torch.models.model import init_model, model_axes
    from repro_torch.shard import PLANS, use_rules
    from repro_torch.train.replay import flat_numpy
    from repro_torch.train.train_step import TrainHyper, accumulated_grads

    cfg = dataclasses.replace(get_smoke_arch(arch), dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(1), "cpu")
    gen = torch.Generator().manual_seed(2)
    shape = (MB_BATCH, MB_SEQ)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen, dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, shape, generator=gen, dtype=torch.int32),
             "loss_mask": (torch.arange(MB_SEQ) < torch.tensor(MB_KEPT)[:, None]).float()}
    hyper = TrainHyper(microbatches=2)
    p = place_tree(params, model_axes(cfg), mesh, PLANS[plan])
    b = place_tree(batch, {k: ("batch", "seq") for k in batch}, mesh, PLANS[plan])
    with use_rules(mesh, plan):
        loss, _, grads = accumulated_grads(p, cfg, b, hyper)
        got = {"loss": flat_numpy({"x": loss})["x"],
               **{f"grad/{k}": v for k, v in flat_numpy(grads).items()}}
    if torch.distributed.get_rank() == 0:
        loss, _, grads = accumulated_grads(params, cfg, batch, hyper)
        want = {"loss": loss.numpy(), **{f"grad/{k}": v for k, v in flat_numpy(grads).items()}}
        return {"sharded": got, "plain": want}
    return {}


def decode_inputs(cfg, kv_int8: bool):
    """Seeded weights, random caches of ``decode_cache_specs`` (int8 rows and
    their scales for ``kv_int8``), tokens and positions."""
    from repro_torch.models.model import decode_cache_specs, init_model

    gen = torch.Generator().manual_seed(0)
    params = init_model(cfg, torch.Generator().manual_seed(1), "cpu")

    def fill(spec):
        if spec.dtype == torch.int8:
            return torch.randint(-127, 128, spec.shape, generator=gen, dtype=torch.int8)
        if spec.dtype == torch.float32 and len(spec.shape) == 4:     # int8 scales
            return torch.rand(spec.shape, generator=gen) * 0.02
        return torch.randn(spec.shape, generator=gen).to(spec.dtype)

    caches = [{b: {k: fill(s) for k, s in blk.items()} for b, blk in g.items()}
              for g in decode_cache_specs(cfg, DECODE_BATCH, DECODE_SEQ, kv_int8=kv_int8)]
    token = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, 1), generator=gen, dtype=torch.int32)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32)
    return params, caches, token, pos


def _decode_job(plan: str, mesh) -> dict:
    from repro_torch.config import get_smoke_arch
    from repro_torch.launch.specs import place_tree
    from repro_torch.models.model import decode_cache_axes, decode_step, model_axes
    from repro_torch.shard import PLANS, use_rules
    from repro_torch.train.replay import flat_numpy

    cfg = dataclasses.replace(get_smoke_arch("granite_8b"), dtype="float32")
    kv_int8 = PLANS[plan].has("kv_int8")
    params, caches, token, pos = decode_inputs(cfg, kv_int8)
    p = place_tree(params, model_axes(cfg), mesh, PLANS[plan])
    c = place_tree([{b: {k: t.clone() for k, t in blk.items()} for b, blk in g.items()}
                    for g in caches], decode_cache_axes(cfg, kv_int8), mesh, PLANS[plan])
    tok, ps = place_tree({"t": token, "p": pos}, {"t": ("batch", None), "p": ("batch",)}, mesh,
                         PLANS[plan]).values()
    with use_rules(mesh, plan):
        logits, new = decode_step(p, cfg, tok, ps, c)
        got = {"logits": flat_numpy({"x": logits})["x"], **{
            f"cache/{k}": v for k, v in flat_numpy(new).items()}}
    if torch.distributed.get_rank() == 0:
        logits, new = decode_step(params, cfg, token, pos, caches)
        want = {"logits": logits.detach().numpy(),
                **{f"cache/{k}": v for k, v in flat_numpy(new).items()}}
        return {"sharded": got, "plain": want}
    return {}


def _scan_job(plan: str, mesh) -> dict:
    """``ops.ssd_scan`` and ``ops.ssd_scan_bwd`` called on DTensors (batch
    rows and heads split as the plan says, under their ``local_map``)
    against the same calls on the whole tensors."""
    from repro_torch.kernels import ops
    from repro_torch.launch.specs import place_tree
    from repro_torch.shard import PLANS, use_rules

    gen = torch.Generator().manual_seed(3)
    b, c, h, p, n = 4, 3, 8, 4, 5
    t = {"states": torch.randn(b, c, h, p, n, generator=gen),
         "decay": torch.rand(b, c, h, generator=gen),
         "init": torch.randn(b, h, p, n, generator=gen),
         "g_prev": torch.randn(b, c, h, p, n, generator=gen),
         "g_final": torch.randn(b, h, p, n, generator=gen)}
    axes = {"states": ("batch", None, "act_ssm", None, None), "decay": ("batch", None, "act_ssm"),
            "init": ("batch", "act_ssm", None, None), "g_prev": ("batch", None, "act_ssm", None, None),
            "g_final": ("batch", "act_ssm", None, None)}
    d = place_tree(dict(t), axes, mesh, PLANS[plan])
    with use_rules(mesh, plan):
        prev, final = ops.ssd_scan(d["states"], d["decay"], d["init"])
        grads = ops.ssd_scan_bwd(d["g_prev"], d["g_final"], prev, d["decay"])
        got = [x.full_tensor().numpy() for x in (prev, final, *grads)]
    prev, final = ops.ssd_scan(t["states"], t["decay"], t["init"])
    want = [x.numpy() for x in (prev, final, *ops.ssd_scan_bwd(t["g_prev"], t["g_final"], prev,
                                                                t["decay"]))]
    placed = [tuple(str(pl) for pl in d[k].placements) for k in ("states", "decay")]
    return {"sharded": got, "plain": want, "placements": placed}


def _rank_main(rank: int, world: int, port: int, jobs: list, results) -> None:
    try:
        torch.set_num_threads(1)
        torch.distributed.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(model=2)
        for i, job in enumerate(jobs):
            t0 = time.perf_counter()
            run = {"train": _train_job, "microbatch": _microbatch_job, "decode": _decode_job,
                   "scan": _scan_job}[job[0]]
            out = run(*job[1:], mesh)
            if rank == 0:
                results.put(("ok", i, dict(out, seconds=time.perf_counter() - t0)))
        torch.distributed.destroy_process_group()
        if rank == 0:
            results.put(("done", -1, None))
    except BaseException:
        results.put(("error", rank, traceback.format_exc()))
        raise


def run_ranks(jobs: list, world: int = 4, timeout: float = 300.0) -> list:
    """Every job's rank-0 result, in order, from one spawned gloo group of
    ``world`` CPU ranks; raises on any rank's error or past ``timeout`` s."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, jobs, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the {world} ranks did not finish in {timeout} s")
            try:
                kind, i, body = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with {dead}")
                continue
            if kind == "error":
                raise RuntimeError(f"rank {i} failed:\n{body}")
            if kind == "done":
                break
            got[i] = body
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [got[i] for i in range(len(jobs))]


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| over the largest |b|."""
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))
