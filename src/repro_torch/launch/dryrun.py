"""Production dry-run: run every (arch x shape x mesh) cell on one rank of a
fake process group, on fake tensors (port of ``repro.launch.dryrun``).

For each cell this:
  1. starts a ``fake`` process group of 256 or 512 ranks, as rank 0 (its
     collectives move nothing: only their shapes are real);
  2. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod) as a
     ``DeviceMesh`` and the cell (``launch.specs.build_cell``);
  3. places parameters, moments, batch and caches as DTensors whose local
     shards are fake tensors (``FakeTensorMode``: shapes, no memory), laid
     out by the plan's placements;
  4. runs the step once under ``shard.use_rules`` and records, per rank:
     ``memory`` (``argument_size_in_bytes``, exact from the local shapes;
     ``output_size_in_bytes``; ``peak_memory_in_bytes`` from
     ``torch.distributed._tools.mem_tracker.MemTracker``), ``cost``
     (``flops``: the local matmul FLOPs) and ``collectives`` (by op:
     counts and result bytes), both from ``analysis.op_costs.step_costs``;
  5. writes one JSON per cell under ``results/dryrun_torch`` (resumable).

A failed cell is recorded (``status``, ``error``, ``traceback``) and the
sweep goes on; ``main`` exits 1 if any cell failed.  The batch is placed
by the plan; plain tensors that the model makes inside the step
(positions, masks, scalars) are taken as replicated (``use_rules``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis.op_costs import step_costs
from repro_torch.analysis.torch_patches import start_fake_world, strided_shard_offsets_off_fake
from repro_torch.config import ARCH_IDS, SHAPES, cells_for, get_arch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell, local_bytes
from repro_torch.optim.adamw import AdamWState
from repro_torch.shard.partition import PLANS, use_rules

OUT_DIR = "results/dryrun_torch"


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not _is_placements(tree):
        return [x for v in tree for x in _leaves(v)]
    if isinstance(tree, AdamWState):
        return _leaves([tree.step, tree.mu, tree.nu])
    return [tree]


def _is_placements(x) -> bool:
    from torch.distributed.tensor.placement_types import Placement

    return isinstance(x, tuple) and bool(x) and all(isinstance(p, Placement) for p in x)


def place(struct, placements, mesh):
    """DTensors of fake tensors for a tree of meta tensors, laid out as the
    parallel ``placements`` tree says (plain fake tensors where it is
    ``None``); call under ``FakeTensorMode``.  Non-tensor leaves (a step
    number) are passed through."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(struct, torch.Tensor):
        full = torch.empty(tuple(struct.shape), dtype=struct.dtype)
        if placements is None:
            return full
        return distribute_tensor(full, mesh, list(placements), src_data_rank=None).contiguous()
    if placements is None:
        placements = _nones(struct)
    if isinstance(struct, AdamWState):
        return AdamWState(step=place(struct.step, placements.step, mesh),
                          mu=place(struct.mu, placements.mu, mesh),
                          nu=place(struct.nu, placements.nu, mesh))
    if isinstance(struct, dict):
        return {k: place(v, placements[k], mesh) for k, v in struct.items()}
    if isinstance(struct, (list, tuple)):
        return type(struct)(place(v, p, mesh) for v, p in zip(struct, placements))
    return struct


def _nones(tree):
    if isinstance(tree, dict):
        return {k: None for k in tree}
    if isinstance(tree, AdamWState):
        return AdamWState(step=None, mu=None, nu=None)
    if isinstance(tree, (list, tuple)):
        return type(tree)(None for _ in tree)
    return None


def _local_nbytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for t in _leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += math.prod(t.shape) * t.element_size()
    return total


def _tensor_leaves(tree) -> list:
    return [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]


def argument_bytes(cell, mesh) -> int:
    """Bytes a rank holds of ``cell``'s arguments (params, moments, batch,
    caches), exact from their local shapes (all of them without a mesh)."""
    if mesh is None:
        return sum(t.numel() * t.element_size() for t in _tensor_leaves(cell.args))
    total = 0
    for s, p in zip(cell.args, cell.in_shardings):
        if isinstance(s, AdamWState):
            total += (local_bytes(s.mu, p.mu, mesh) + local_bytes(s.nu, p.nu, mesh)
                      + s.step.element_size())
        elif p is not None:
            total += local_bytes(s, p, mesh)
    return total


def run_fake_step(cell, mesh, plan) -> dict:
    """One run of ``cell`` as a rank of ``mesh`` on fake tensors, under
    ``plan``: ``{memory, cost, collectives}`` per rank.  With ``mesh`` and
    ``plan`` ``None``: the step on one device, no rules."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    arg_bytes = argument_bytes(cell, mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = place(cell.args, cell.in_shardings, mesh)
        placed = _local_nbytes(args)
        if placed != arg_bytes:
            raise AssertionError(f"placed arguments hold {placed} bytes a rank, the "
                                 f"specs say {arg_bytes}")
        tracker = MemTracker()
        tracker.track_external(*_tensor_leaves(args))
        rules = contextlib.nullcontext() if mesh is None else use_rules(mesh, plan)
        with rules, strided_shard_offsets_off_fake(), tracker:
            costs = step_costs(cell.fn, *args)
        peak = max(snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values())
        out_bytes = _local_nbytes(costs.pop("result"))
    return {
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "output_size_in_bytes": int(out_bytes),
                   "peak_memory_in_bytes": int(peak)},
        "cost": {"flops": costs["dot_flops"], "flops_by_op": costs["flops_by_op"]},
        "collectives": {"by_op": costs["coll_by_op"], "counts": costs["counts"],
                        "total_bytes": costs["coll_bytes"]},
    }


def depth(cfg) -> int:
    """The steps of the repeated layer group(s) that ``at_depth`` scales."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    if cfg.family == "moe" and cfg.first_layer_dense:
        return cfg.num_layers - 1
    if cfg.family == "encdec" and cfg.enc_layers != cfg.num_layers:
        raise ValueError("the depth cut takes an encoder as deep as its decoder")
    return cfg.num_layers


def at_depth(cfg, d: int):
    """``cfg`` with ``d`` steps in each repeated group (its widths as they
    are; a dense first layer stays)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=d * cfg.attn_period)
    if cfg.family == "moe" and cfg.first_layer_dense:
        return dataclasses.replace(cfg, num_layers=d + 1)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, num_layers=d, enc_layers=d)
    return dataclasses.replace(cfg, num_layers=d)


def _extrapolate(runs: dict, full_d: int, full_m: int):
    """The value at (``full_d``, ``full_m``) of a quantity measured at two
    consecutive depths and two consecutive microbatch counts (or only the
    full one of either): linear in each, bilinear in both.  Nested dicts are
    extrapolated key by key."""
    first = next(iter(runs.values()))
    if isinstance(first, dict):
        return {k: _extrapolate({dm: v[k] for dm, v in runs.items()}, full_d, full_m)
                for k in first}
    ds = sorted({d for d, _ in runs})
    ms = sorted({m for _, m in runs})

    def line(points, values, x):
        if len(points) == 1:
            return values[0]
        return values[0] + (x - points[0]) * (values[1] - values[0])

    value = line(ds, [line(ms, [runs[(d, m)] for m in ms], full_m) for d in ds], full_d)
    return type(first)(round(value)) if isinstance(first, int) else value


def run_cell_costs(cfg, shape, mesh, plan_name: str | None = None) -> tuple:
    """(cell, ``run_fake_step``'s record) of a full-size cell, the record from
    runs of the cell
    at 2 and 3 steps a repeated layer group (and 2 and 3 microbatches of the
    cell's microbatch size, for training; one microbatch takes another code
    path, with no accumulation), extrapolated linearly in each: every step
    of a group has the same shapes and placements, and every microbatch the
    same work, so the FLOPs repeat exactly (JAX's ``hlo_parse`` multiplies a
    loop body by its trips); the collectives' counts too, their bytes within
    ~2% and the peak within ~5% where DTensor routes a redistribution
    otherwise at another count (``tests/test_torch_dryrun.py``).  The
    arguments' bytes are exact from the full cell's specs.  Runs with no cut
    where the cell is that small."""
    from repro_torch.config import ShapeConfig
    from repro_torch.train.train_step import TrainHyper

    cell = build_cell(cfg, shape, mesh, plan=plan_name)
    plan = PLANS[cell.meta["plan"]]
    full_d = depth(cfg)
    full_m = cell.meta.get("microbatches", 1)
    ds = (2, 3) if full_d > 3 else (full_d,)
    ms = (2, 3) if full_m > 3 else (full_m,)
    runs, walls = {}, {}
    for d in ds:
        for m in ms:
            small_shape = shape
            hyper = None
            if shape.kind == "train":
                small_shape = ShapeConfig(shape.name, shape.seq_len,
                                          shape.global_batch // full_m * m, shape.kind)
                hyper = TrainHyper(microbatches=m, remat_policy=cell.meta["remat_policy"])
            t0 = time.time()
            runs[(d, m)] = run_fake_step(build_cell(at_depth(cfg, d), small_shape, mesh, plan,
                                                    hyper), mesh, plan)
            walls[f"{d}x{m}"] = time.time() - t0
    res = _extrapolate(runs, full_d, full_m)
    res["memory"]["argument_size_in_bytes"] = argument_bytes(cell, mesh)
    if res["memory"]["peak_memory_in_bytes"] < res["memory"]["argument_size_in_bytes"]:
        raise AssertionError(f"the peak {res['memory']} holds less than the arguments "
                             f"(runs {walls}): the tracker missed allocations")
    res["extrapolated"] = {"depth": full_d, "microbatches": full_m,
                           "runs": [f"{d}x{m}" for d, m in runs], "run_wall_s": walls}
    return cell, res


def run_cell(arch_id: str, shape_id: str, multi_pod: bool, out_dir: str = OUT_DIR,
             force: bool = False, plan: str | None = None) -> dict:
    tag = f"{arch_id}.{shape_id}.{'pod2' if multi_pod else 'pod1'}"
    if plan:
        tag += f".{plan}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_arch(arch_id)
    shape = SHAPES[shape_id]
    rec = {"cell": tag, "arch": arch_id, "shape": shape_id,
           "multi_pod": multi_pod, "status": "error"}
    t0 = time.time()
    try:
        start_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        cell, res = run_cell_costs(cfg, shape, mesh, plan)
        rec.update(status="ok", plan=cell.meta["plan"], mesh=cell.meta["mesh"],
                   n_devices=mesh.size(),
                   **{k: cell.meta[k] for k in ("microbatches", "kv_int8") if k in cell.meta},
                   **res)
        mem = res["memory"]
        print(f"[{tag}] memory: {mem}")
        print(f"[{tag}] cost: flops={res['cost']['flops']} "
              f"coll={res['collectives']['total_bytes'] / 1e9:.3f} GB")
    except Exception as e:  # record failures as bugs-to-fix, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{tag}] FAILED: {rec['error']}")
    rec["wall_s"] = time.time() - t0
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summary(out_dir: str = OUT_DIR) -> str:
    """The cells' records under ``out_dir`` as a markdown table: a rank's
    argument and peak GB (against one card's 80 GB), FLOPs, collective GB,
    the FLOPs over the ideal share of ``model_flops`` (n_dev-th) and the
    wall s of the run."""
    from repro_torch.analysis.roofline import model_flops

    rows = ["| Cell | Plan | Status | Args GB | Peak GB | TFLOP | x ideal | Coll GB | Wall s |",
            "|---|---|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(out_dir)):
        if not name.endswith(".json") or name.startswith("cost_worker"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            rec = json.load(f)
        if rec["status"] != "ok":
            rows.append(f"| {rec['cell']} | {rec.get('plan', '')} | {rec['error'][:60]} "
                        "| | | | | | |")
            continue
        mem, n = rec["memory"], rec["n_devices"]
        ideal = model_flops(get_arch(rec["arch"]), SHAPES[rec["shape"]]) / n
        rows.append(
            f"| {rec['cell']} | {rec['plan']} | ok | {mem['argument_size_in_bytes'] / 1e9:.3f} "
            f"| {mem['peak_memory_in_bytes'] / 1e9:.2f} | {rec['cost']['flops'] / 1e12:.3g} "
            f"| {rec['cost']['flops'] / ideal:.2f} | {rec['collectives']['total_bytes'] / 1e9:.1f} "
            f"| {rec['wall_s']:.0f} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--plan", default=None, help="override parallelism plan")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--summary", action="store_true", help="print the records under --out")
    args = ap.parse_args()
    if args.summary:
        print(summary(args.out))
        return

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for aid in ARCH_IDS:
            for sid in cells_for(get_arch(aid)):
                cells.append((aid, sid, False))
                if args.both_meshes:
                    cells.append((aid, sid, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        meshes = [args.multi_pod] if not args.both_meshes else [False, True]
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    ok = failed = 0
    for aid, sid, mp in cells:
        rec = run_cell(aid, sid, mp, args.out, args.force, args.plan)
        ok += rec["status"] == "ok"
        failed += rec["status"] != "ok"
    print(f"dry-run complete: {ok} ok, {failed} failed")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
