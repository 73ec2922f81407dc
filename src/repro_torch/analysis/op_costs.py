"""Per-rank FLOPs and collective bytes of one step, counted as it runs.

The counterpart of ``repro.analysis.hlo_parse``.  JAX's dry-run reads
these from the partitioned HLO text, whose loops XLA's own cost analysis
counts once (hence that module's loop correction).  The port has no HLO:
it runs the step eagerly (on fake tensors for a dry-run), so every trip of
a Python loop over layers, microbatches or attention blocks dispatches its
ops again and is counted as it happens.  ``step_costs(fn, *args)`` runs
``fn`` under ``CostMode`` and returns ``parse_hlo_costs``' keys:

* ``dot_flops``: the matmul-family FLOPs (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, attention ops), by the formulas of
  ``torch.utils.flop_counter``;
* ``coll_bytes``, ``coll_by_op`` and ``counts``: the result bytes of every
  ``_c10d_functional`` collective (JAX's result-buffer bytes), by
  ``hlo_parse``'s op names.

``trip_counts`` is not returned: there are no loop bodies to multiply.

Everything is counted on a rank's LOCAL tensors.  Ops on DTensors are let
through to DTensor (``NotImplemented``), which runs the rank's share as
plain ops that come back to the mode and are counted.  DTensor's sharding
propagation also runs each op once on fake tensors of the GLOBAL shapes to
infer its output's metadata; ``step_costs`` runs that propagation with the
dispatch modes set aside, in a fake mode of its own
(``torch_patches.separate_propagation``), and ``CostMode`` counts no op
issued under another fake mode than its own.
"""
from __future__ import annotations

import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.torch_patches import active_fake_mode, separate_propagation

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_C10D = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return math.prod(x.shape) * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


class CostMode(TorchDispatchMode):
    """Counts the matmul FLOPs and collective bytes of the ops a rank runs
    (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.dot_flops = 0
        self.by_op = {op: 0 for op in COLL_OPS}
        self.counts = {op: 0 for op in COLL_OPS}
        self.flops_by_op: dict[str, int] = defaultdict(int)
        self._entry = None

    def __enter__(self):
        self._entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._entry:
            return out   # DTensor's propagation of global shapes
        packet = func._overloadpacket
        if packet in self.registry:
            flops = self.registry[packet](*args, **kwargs, out_val=out)
            self.dot_flops += flops
            self.flops_by_op[str(packet)] += flops
        elif func.namespace == "_c10d_functional":
            op = _C10D.get(packet.__name__)
            if op is not None:
                self.by_op[op] += _nbytes(out)
                self.counts[op] += 1
        return out

    def costs(self) -> dict:
        return {
            "dot_flops": float(self.dot_flops),
            "coll_bytes": float(sum(self.by_op.values())),
            "coll_by_op": {k: float(v) for k, v in self.by_op.items()},
            "counts": dict(self.counts),
            "flops_by_op": dict(self.flops_by_op),
        }


def step_costs(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return its per-rank costs
    (``dot_flops``, ``coll_bytes``, ``coll_by_op``, ``counts``) and, under
    ``"result"``, what ``fn`` returned."""
    with separate_propagation(), CostMode() as mode:
        result = fn(*args, **kwargs)
    return dict(mode.costs(), result=result)
