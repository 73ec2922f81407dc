"""Logical-axis sharding rules (MaxText-style), resolved per parallelism plan.

Port of ``repro.shard.partition``.  A *plan* maps logical axis names to
mesh axes.  Model code only ever names logical axes (``shard_act(x,
"batch", "seq", "embed")``); the plan decides what that means on the
current mesh.  ``Plan``, ``_mk`` and the twelve ``PLANS`` are copied whole.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims, and a resolved spec binds through DTensor placements, PyTorch's
counterpart of GSPMD:

* ``axes_to_pspec`` returns JAX's ``PartitionSpec`` as a tuple of per
  tensor-dim entries (a mesh-axis name, a tuple of names, or ``None``),
  filtered by the mesh's dim names as JAX's ``_filter_spec`` filters;
* ``spec_to_placements`` turns such a spec into DTensor's per mesh-dim
  placements: ``Shard(i)`` on every mesh dim that tensor dim ``i`` names,
  ``Replicate()`` on the others.  A tensor dim spread over several mesh
  dims (``("pod", "data")``) is ``Shard(i)`` on each of them, which DTensor
  splits in mesh order, major first, as JAX does.  A spec that names them
  against mesh order (``("model", "data")`` on a ``("data", "model")``
  mesh) would need DTensor's ``_StridedShard`` for JAX's layout, so it is
  refused; no plan in ``PLANS`` names one;
* ``shard_act`` ``redistribute``s a DTensor activation to the plan's
  placements.  With no rules active, or on a plain tensor, it returns its
  input object unchanged with no tensor op: the unsharded paths pay
  nothing.

Plans (defaults; a cell of the dry-run may name another):

* ``train``    — batch over (pod, data); params FSDP over data on their
  widest non-TP dim; TP over model for heads/ffn/experts/vocab.
* ``prefill``  — activations: batch over (pod, data), heads/ffn over model.
* ``decode``   — batch over (pod, data); KV pages: kv_seq over model (robust
  to kv_heads < axis size).
* ``long``     — batch=1: sequence/state sharded over (data, model).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

Axes = tuple[Optional[str], ...]
Spec = tuple  # per tensor dim: mesh-axis name | tuple of names | None


@dataclasses.dataclass(frozen=True)
class Plan:
    name: str
    rules: dict  # logical axis -> mesh axis | tuple | None
    flags: frozenset = frozenset()  # model-code behavior switches (hillclimb)

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.rules.get(logical, None)

    def has(self, flag: str) -> bool:
        return flag in self.flags


_DATA = ("pod", "data")  # batch-like axes gang pod+data when both exist


def _mk(name: str, _flags: tuple = (), **over) -> Plan:
    rules = {
        # activations
        "batch": _DATA,
        "kv_batch": _DATA,   # KV-cache batch dim (decouplable from act batch)
        "seq": None,
        "kv_seq": None,
        "embed": None,
        "act_heads": "model",
        "act_ffn": "model",
        "act_experts": "model",
        "act_ssm": "model",
        "moe_b": _DATA,   # MoE dispatch buffer batch dim (EP plans: None)
        "moe_d": None,    # MoE dispatch buffer d dim (EP plans: data)
        # params — TP dims (role-suffixed: _in = contraction, _out = output)
        "heads": "model",
        "heads_in": "model",
        "kv_heads": "model",
        "qkv": "model",
        "ffn_in": "model",
        "ffn_out": "model",
        "experts": "model",
        "moe_ffn_in": "model",
        "moe_ffn_out": "model",
        "vocab": "model",
        "head_vocab": "model",
        "head_embed": "data",
        "ssm_in": "model",
        "ssm_out": "model",
        "ssm_heads": "model",
        # params — FSDP dims (the non-TP wide dim, by role)
        "embed_in": "data",
        "embed_out": "data",
        # never sharded
        "layers": None,
        "head_dim": None,
        "ssm_state": None,
        "conv": None,
        "lora": None,
        "null": None,
    }
    rules.update(over)
    return Plan(name, rules, frozenset(_flags))


PLANS: dict[str, Plan] = {
    "train": _mk("train"),
    # replicate KV heads up to the TP degree so q AND k/v are head-sharded
    # when kv_heads < |model| would leave k/v unsharded while q is sharded.
    "train_kvrep": _mk("train_kvrep", _flags=("kv_expand",)),
    # token embedding table replicated on vocab (embed dims only FSDP).
    "train_embed_repl": _mk(
        "train_embed_repl", _flags=("kv_expand",), vocab=None
    ),
    # pure ZeRO-3 data parallelism: batch over every axis, params/optimizer
    # fully sharded on their widest dim, no tensor parallelism.  Wants mb=1.
    "train_zero3": _mk(
        "train_zero3",
        _flags=("mb1",),
        batch=("pod", "data", "model"),
        heads=None, heads_in=None, kv_heads=None, qkv=None,
        ffn_in=None, ffn_out=None, experts=None,
        moe_ffn_in=None, moe_ffn_out=None, vocab=None,
        ssm_in=None, ssm_out=None, ssm_heads=None,
        act_heads=None, act_ffn=None, act_experts=None, act_ssm=None,
        embed_in=("data", "model"), embed_out=("data", "model"),
        # LM head 2D-sharded on its own axes: logits stay vocab-local,
        # the d-contraction partial-sum reduces over 'data' only.
        head_embed="data", head_vocab="model",
    ),
    # expert-stationary EP for MoE training: experts 2D-sharded (E -> model,
    # d -> data) and never gathered; the dispatch buffer contracts its
    # token-d over 'data'.  No tensor parallelism.  Wants mb=4.
    "train_ep": _mk(
        "train_ep",
        _flags=("mb4",),
        batch=("pod", "data"),
        heads=None, heads_in=None, kv_heads=None, qkv=None,
        ffn_in=None, ffn_out=None, vocab=None,
        act_heads=None, act_ffn=None, act_ssm=None,
        experts="model", moe_ffn_in=None, moe_ffn_out=None,
        embed_in="data", embed_out="data",
        moe_b=None, moe_d="data",
        head_embed="data", head_vocab="model",
    ),
    "prefill": _mk("prefill"),
    "prefill_kvrep": _mk("prefill_kvrep", _flags=("kv_expand",)),
    # decode: batch over data; kv_seq sharded over model so every arch's
    # kv_heads count (4/8/10/16) is irrelevant to divisibility.
    "decode": _mk(
        "decode",
        kv_seq="model",
        kv_heads=None,
    ),
    # weight-stationary decode: every weight's contraction dim on 'model',
    # its output dim on 'data'; the tiny decode activations are resharded
    # instead of the weights gathered.  KV cache: batch over data, kv_seq
    # over model.
    "decode_stationary": _mk(
        "decode_stationary",
        batch=None,          # activations: batch replicated (tiny at decode),
        embed="data",        # features carry the data sharding instead
        kv_batch=_DATA,      # the CACHE stays batch-sharded (it is huge)
        kv_seq="model",
        kv_heads=None,
        act_heads="model", act_ffn="model", act_experts="model", act_ssm="model",
        embed_in="data", embed_out="data",
        ffn_in="model", ffn_out="model",
        heads="model", heads_in="model",
        ssm_in="model", ssm_out="model",
        moe_ffn_in="model", moe_ffn_out="model",
        experts="model", moe_d=None,
        vocab=None,
        head_embed="data", head_vocab="model",
        lora=None,
    ),
    # decode_stationary + int8 KV pages: halves the KV read bytes.
    "decode_stationary_int8": _mk(
        "decode_stationary_int8",
        _flags=("kv_int8",),
        batch=None,
        embed="data",
        kv_batch=_DATA,
        kv_seq="model",
        kv_heads=None,
        act_heads="model", act_ffn="model", act_experts="model", act_ssm="model",
        embed_in="data", embed_out="data",
        ffn_in="model", ffn_out="model",
        heads="model", heads_in="model",
        ssm_in="model", ssm_out="model",
        moe_ffn_in="model", moe_ffn_out="model",
        experts="model", moe_d=None,
        vocab=None,
        head_embed="data", head_vocab="model",
        lora=None,
    ),
    # decode with the token-embedding table replicated on the vocab dim.
    "decode_vrepl": _mk(
        "decode_vrepl",
        kv_seq="model",
        kv_heads=None,
        vocab=None,
    ),
    # long-context decode with global_batch=1: spread state/sequence over
    # everything; batch unsharded.
    "long": _mk(
        "long",
        batch=None,
        kv_seq=("data", "model"),
        kv_heads=None,
        act_ssm="model",
    ),
}


class _Ctx:
    mesh = None
    plan: Optional[Plan] = None


# One for the process, not for the thread (JAX's is thread-local): the
# autograd engine runs a CUDA backward, and so the recomputation of a
# checkpointed layer, on a thread of its own, which must see the rules
# that the step began under.
_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh, plan: Plan | str):
    """Activate (mesh, plan) for the process so model code's ``shard_act``
    constraints bind; ``mesh`` is a ``DeviceMesh`` (or ``None``).  With a mesh, a plain tensor
    that meets a DTensor (a position, a mask, a scalar the model makes) is
    taken as replicated (``implicit_replication``)."""
    if isinstance(plan, str):
        plan = PLANS[plan]
    prev = (_CTX.mesh, _CTX.plan)
    _CTX.mesh, _CTX.plan = mesh, plan
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "mesh_dim_names"):
                from torch.distributed.tensor.experimental import implicit_replication

                stack.enter_context(implicit_replication())
            yield
    finally:
        _CTX.mesh, _CTX.plan = prev


def current_rules():
    """(mesh, plan) of the innermost ``use_rules``, or (None, None)."""
    return _CTX.mesh, _CTX.plan


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of anything shaped like
    JAX's mesh (``axis_names`` and ``devices.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def _filter_spec(mesh, entries) -> Spec:
    """Drop mesh axes that don't exist on this mesh; keep order; dedupe."""
    names = mesh_axes(mesh)
    used = set()
    out = []
    for e in entries:
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        keep = tuple(a for a in axes if a in names and a not in used)
        used.update(keep)
        out.append(keep if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def axes_to_pspec(axes: Axes, mesh, plan: Plan) -> Spec:
    return _filter_spec(mesh, [plan.resolve(a) for a in axes])


def fit_spec(spec: Spec, shape: tuple[int, ...], mesh) -> Spec:
    """Drop the mesh axes that do not evenly divide their dim (JAX's
    ``launch.specs._fit_spec``)."""
    sizes = mesh_axes(mesh) if not isinstance(mesh, dict) else mesh
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        keep = []
        d = dim
        for a in axes:
            size = sizes[a]
            if d % size == 0:
                keep.append(a)
                d //= size
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return tuple(out)


def spec_to_placements(spec: Spec, mesh) -> tuple:
    """Per-tensor-dim ``spec`` -> DTensor placements, one per mesh dim:
    ``Shard(i)`` where tensor dim ``i`` names the mesh dim, else
    ``Replicate()``.  Raises where a tensor dim names its mesh dims against
    mesh order (JAX's layout would then need ``_StridedShard``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"tensor dim {i} names mesh axes {axes} against the mesh's order "
                             f"{tuple(names)}: DTensor would lay it out as _StridedShard")
        for j in order:
            placements[j] = Shard(i)
    return tuple(placements)


def grad_placements(placements: tuple, split: tuple) -> tuple:
    """The placements of the gradient of an input of a ``local_map`` region
    whose work is split as ``split`` says: on a mesh dim where the work is
    split but the input is read whole, each rank's gradient is its own
    share of the sum (``Partial``)."""
    from torch.distributed.tensor import Partial, Shard

    return tuple(Partial() if isinstance(s, Shard) and not isinstance(p, Shard) else p
                 for p, s in zip(placements, split))


def placements_for(axes: Axes, shape: tuple[int, ...], mesh, plan: Plan) -> tuple:
    """The placements of a tensor of ``shape`` with logical ``axes``: the
    plan's spec, fitted to the shape, as DTensor placements."""
    return spec_to_placements(fit_spec(axes_to_pspec(axes, mesh, plan), shape, mesh), mesh)


def shard_index(mesh, placements: tuple, dim: int) -> int:
    """This rank's index among the shards of tensor dim ``dim`` laid out as
    ``placements`` (the mesh dims that shard it, major first)."""
    from torch.distributed.tensor import Shard

    coord, idx = mesh.get_coordinate(), 0
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx = idx * mesh.size(i) + coord[i]
    return idx


def shard_range(mesh, placements: tuple, dim: int, size: int) -> tuple[int, int]:
    """(first index, length) of this rank's even share of dim ``dim`` (of
    ``size``) laid out as ``placements``."""
    from torch.distributed.tensor import Shard

    n = 1
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n *= mesh.size(i)
    return shard_index(mesh, placements, dim) * (size // n), size // n


def sharded(x) -> bool:
    """Whether ``x`` is a DTensor under an active plan."""
    if _CTX.mesh is None or _CTX.plan is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def on_ranks(fn, out_placements, in_placements, in_grad_placements=None):
    """``fn`` under ``local_map`` on the active plan's mesh: its DTensor
    inputs redistributed to ``in_placements`` and passed as each rank's
    local tensors, its outputs taken as ``out_placements``.  Where the work
    is split but an input is read whole, ``in_grad_placements`` says its
    gradient is a sum of the ranks' shares (``grad_placements``)."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=_CTX.mesh,
                     redistribute_inputs=True)


def shard_act(x, *axes: Optional[str]):
    """Constrain an activation's sharding by logical axes: a DTensor is
    redistributed to the plan's placements (fitted to its shape); with no
    rules active, or on a plain tensor, ``x`` itself is returned."""
    mesh, plan = _CTX.mesh, _CTX.plan
    if mesh is None or plan is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = placements_for(tuple(axes), tuple(x.shape), mesh, plan)
    if tuple(x.placements) == placements:
        return x
    # a shard of a non-leading dim may come back strided; DTensor's local
    # products view their operands, so keep the local tensor dense
    return x.redistribute(mesh, placements).contiguous()


def params_pspecs(axes_tree, mesh, plan: Plan | str):
    """Resolve a logical-axes tree (from ``models.params.logical_axes``) to a
    tree of DTensor placements, leaf for leaf."""
    if isinstance(plan, str):
        plan = PLANS[plan]

    def walk(node):
        if isinstance(node, tuple):
            return spec_to_placements(axes_to_pspec(node, mesh, plan), mesh)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise TypeError(f"not a logical-axes tree node: {node!r}")

    return walk(axes_tree)
