"""Input specs + sharding resolution for every (arch x shape) cell (port of
``repro.launch.specs``).

``build_cell(cfg, shape, mesh, plan)`` returns everything the dry-run
needs: the step function, its arguments as ``meta`` tensors (JAX's
``ShapeDtypeStruct``s: shapes and dtypes, nothing allocated) and their
DTensor placements (``None`` where ``mesh`` is ``None``: the step on one
device), with divisibility-aware sharding (a mesh axis that does
not divide a dim is dropped for that dim, e.g. granite-3's vocab 49155 or
phi3's 10 kv heads).  A placements tree is parallel to its argument tree:
each leaf a tuple of one ``Shard``/``Replicate`` per mesh dim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.model import (
    decode_cache_axes,
    decode_cache_specs,
    decode_step,
    model_axes,
    model_param_defs,
    prefill,
)
from repro_torch.models.params import abstract_params
from repro_torch.optim.adamw import AdamWState
from repro_torch.shard.partition import PLANS, Plan, axes_to_pspec, fit_spec, spec_to_placements
from repro_torch.train.train_step import TrainHyper, make_train_step


# ---------------------------------------------------------------------------
# Divisibility-aware sharding resolution
# ---------------------------------------------------------------------------

def _fit_spec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop mesh axes that do not evenly divide their dim.  ``mesh``: a
    ``DeviceMesh``, or anything whose ``shape`` is ``{axis: size}``."""
    sizes = getattr(mesh, "shape", None)
    return fit_spec(spec, shape, sizes if isinstance(sizes, dict) else mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _map(fn, tree, *rest, leaf=_is_axes):
    """``fn`` over the leaves of ``tree`` (dicts and lists recurse; a leaf is
    what ``leaf`` accepts) and the matching nodes of ``rest``."""
    if leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest), leaf=leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest), leaf=leaf) for i, v in enumerate(tree)]
    raise TypeError(f"not a tree node: {tree!r}")


def resolve_shardings(axes_tree, struct_tree, mesh, plan: Plan):
    """(logical axes tree, meta-tensor tree) -> placements tree."""

    def one(axes, struct):
        spec = _fit_spec(axes_to_pspec(axes, mesh, plan), tuple(struct.shape), mesh)
        return spec_to_placements(spec, mesh)

    return _map(one, axes_tree, struct_tree)


def place_tree(tree, axes_tree, mesh, plan: Plan):
    """A tree of tensors as DTensors on ``mesh``, each laid out as its
    logical axes resolve under ``plan`` (fitted to its shape); every rank
    passes the same whole tensors and keeps its own shards."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, pl):
        return distribute_tensor(t, mesh, list(pl), src_data_rank=None).contiguous()

    shard = resolve_shardings(axes_tree, tree, mesh, plan)
    return _map(one, tree, shard, leaf=lambda x: isinstance(x, torch.Tensor))


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def local_shape(shape: tuple[int, ...], placements: tuple, mesh) -> tuple[int, ...]:
    """A rank's shard shape of an evenly divided tensor: each dim over the
    sizes of the mesh dims that shard it."""
    from torch.distributed.tensor import Shard

    out = list(shape)
    for size, pl in zip(tuple(mesh.shape), placements):
        if isinstance(pl, Shard):
            if out[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {shape} does not divide over {size}")
            out[pl.dim] //= size
    return tuple(out)


def local_bytes(struct_tree, placement_tree, mesh) -> int:
    """Bytes a rank holds of the tensors of ``struct_tree`` laid out as
    ``placement_tree`` says."""
    total = 0

    def one(pl, struct):
        nonlocal total
        total += math.prod(local_shape(tuple(struct.shape), pl, mesh)) * struct.element_size()

    _map(one, placement_tree, struct_tree, leaf=lambda x: isinstance(x, tuple))
    return total


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------

def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, with_labels: bool):
    """(meta tensors, logical axes) of a cell's batch: frames and patches
    bfloat16, tokens and labels int32, as in JAX."""
    b, s = shape.global_batch, shape.seq_len
    structs: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    text = s
    if cfg.family == "vlm":
        text = s - cfg.frontend_seq
        structs["patches"] = _meta((b, cfg.frontend_seq, cfg.d_model), torch.bfloat16)
        axes["patches"] = ("batch", "seq", "embed")
    if cfg.family == "encdec":
        structs["frames"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        axes["frames"] = ("batch", "seq", "embed")
    structs["tokens"] = _meta((b, text), torch.int32)
    axes["tokens"] = ("batch", "seq")
    if with_labels:
        structs["labels"] = _meta((b, text), torch.int32)
        axes["labels"] = ("batch", "seq")
    return structs, axes


# ---------------------------------------------------------------------------
# Cell builder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    fn: Any
    args: tuple            # trees of meta tensors (and ints)
    in_shardings: tuple    # placements trees parallel to ``args`` (None: not a tensor)
    out_shardings: Any
    donate_argnums: tuple
    meta: dict


def build_cell(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    plan: Optional[Plan | str] = None,
    hyper: Optional[TrainHyper] = None,
) -> Cell:
    if plan is None:
        plan = {"train": "train", "prefill": "prefill", "decode": "decode"}[shape.kind]
        if shape.name == "long_500k":
            plan = "long"
    if isinstance(plan, str):
        plan = PLANS[plan]

    def shardings(axes, structs):   # no mesh: one device, nothing to place
        return None if mesh is None else resolve_shardings(axes, structs, mesh, plan)

    defs = model_param_defs(cfg)
    p_struct = abstract_params(defs)
    p_shard = shardings(model_axes(cfg), p_struct)
    meta = {
        "arch": cfg.name, "shape": shape.name, "plan": plan.name,
        "mesh": {} if mesh is None else dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
    }

    if shape.kind == "train":
        # 8 gradient-accumulation microbatches by default; ZeRO-3 plans run
        # mb=1, the expert-stationary plan mb=4.
        mb = 1 if plan.has("mb1") else (4 if plan.has("mb4") else 8)
        hyper = hyper or TrainHyper(
            microbatches=mb,
            remat_policy="nothing" if plan.has("mb1") or plan.has("mb4") else "dots",
        )
        step_fn = make_train_step(cfg, hyper)
        f32 = _map(lambda x: _meta(tuple(x.shape), torch.float32), p_struct,
                   leaf=lambda x: isinstance(x, torch.Tensor))
        opt_struct = AdamWState(step=_meta((), torch.int32), mu=f32, nu=f32)
        opt_shard = None if mesh is None else AdamWState(step=replicated(mesh), mu=p_shard,
                                                         nu=p_shard)
        b_struct, b_axes = batch_specs(cfg, shape, with_labels=True)
        b_shard = shardings(b_axes, b_struct)
        return Cell(
            fn=step_fn,
            args=(p_struct, opt_struct, b_struct, 0),
            in_shardings=(p_shard, opt_shard, b_shard, None),
            out_shardings=(p_shard, opt_shard, None),
            donate_argnums=(0, 1),
            meta=dict(meta, microbatches=hyper.microbatches, remat_policy=hyper.remat_policy),
        )

    if shape.kind == "prefill":
        b_struct, b_axes = batch_specs(cfg, shape, with_labels=False)
        b_shard = shardings(b_axes, b_struct)

        def prefill_step(params, batch):
            return prefill(params, cfg, batch)

        return Cell(
            fn=prefill_step,
            args=(p_struct, b_struct),
            in_shardings=(p_shard, b_shard),
            out_shardings=None,
            donate_argnums=(),
            meta=meta,
        )

    # decode
    b, s = shape.global_batch, shape.seq_len
    enc_seq = cfg.frontend_seq if cfg.family == "encdec" else 0
    kv_int8 = plan.has("kv_int8")
    c_struct = _map(lambda spec: _meta(spec.shape, spec.dtype),
                    decode_cache_specs(cfg, b, s, enc_seq, kv_int8=kv_int8),
                    leaf=lambda x: hasattr(x, "dtype"))
    c_shard = shardings(decode_cache_axes(cfg, kv_int8), c_struct)
    tok_struct = _meta((b, 1), torch.int32)
    pos_struct = _meta((b,), torch.int32)
    tok_shard = pos_shard = None
    if mesh is not None:
        bspec = _fit_spec(axes_to_pspec(("batch", None), mesh, plan), (b, 1), mesh)
        tok_shard = spec_to_placements(bspec, mesh)
        pos_shard = spec_to_placements(bspec[:1], mesh)

    def serve_step(params, token, pos, caches):
        return decode_step(params, cfg, token, pos, caches)

    return Cell(
        fn=serve_step,
        args=(p_struct, tok_struct, pos_struct, c_struct),
        in_shardings=(p_shard, tok_shard, pos_shard, c_shard),
        out_shardings=(None, c_shard),
        donate_argnums=(3,),
        meta=dict(meta, kv_int8=kv_int8),
    )
