"""The private PyTorch internals that the cost counter (``op_costs``) and the
dry-run (``launch.dryrun``) reach into, all in this module.

They were checked on torch 2.11 (CUDA build) and 2.13 (CPU build);
``check_torch`` refuses any version outside that range, and any build
that lacks one of the internals, before a patch is made:

* ``separate_propagation`` replaces
  ``torch.distributed.tensor._sharding_prop.detect_fake_mode`` and
  ``ShardingPropagator._propagate_tensor_meta_non_cached``, so that
  DTensor's sharding propagation runs its global-shape ops in a fake mode
  of its own, with every dispatch mode set aside;
* ``strided_shard_offsets_off_fake`` replaces
  ``_StridedShard.local_shard_size_and_offset``, so that it computes its
  small index tensor outside ``FakeTensorMode``;
* ``active_fake_mode`` reads the dispatch-mode stack;
* ``start_fake_world`` starts a ``fake`` process group through
  ``torch.testing._internal.distributed.fake_pg.FakeStore``.

The replacements are global to the process while their context is open.
"""
from __future__ import annotations

import contextlib
import re

import torch

CHECKED = ((2, 11), (2, 13))   # the oldest and newest (major, minor) checked


def check_torch() -> None:
    """Raise unless this torch lies within ``CHECKED`` and has every internal
    that this module replaces or reads."""
    from torch.distributed.tensor import _sharding_prop
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils import _python_dispatch

    m = re.match(r"(\d+)\.(\d+)", torch.__version__)
    version = (int(m.group(1)), int(m.group(2))) if m else None
    if version is None or not CHECKED[0] <= version <= CHECKED[1]:
        raise RuntimeError(f"torch {torch.__version__}: the patches of {__name__} were checked "
                           f"on {CHECKED[0]} to {CHECKED[1]} only")
    needed = [(_sharding_prop, "detect_fake_mode"),
              (_sharding_prop.ShardingPropagator, "_propagate_tensor_meta_non_cached"),
              (_StridedShard, "local_shard_size_and_offset"),
              (_python_dispatch, "_disable_current_modes"),
              (_python_dispatch, "_get_current_dispatch_mode_stack")]
    missing = [f"{getattr(o, '__name__', o)}.{a}" for o, a in needed if not hasattr(o, a)]
    if missing:
        raise RuntimeError(f"torch {torch.__version__} lacks {missing}")


def active_fake_mode():
    """The innermost ``FakeTensorMode`` on the dispatch-mode stack, or None."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    modes = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, FakeTensorMode)]
    return modes[-1] if modes else None


_PROPAGATION_MODE = None


@contextlib.contextmanager
def separate_propagation():
    """DTensor's sharding propagation runs its global-shape ops with every
    dispatch mode set aside, in a fake mode of its own: no counter or
    memory tracker on the stack sees them (newer ``MemTracker``s make that
    test themselves; older ones count them)."""
    global _PROPAGATION_MODE
    check_torch()
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import _sharding_prop
    from torch.utils._python_dispatch import _disable_current_modes

    if _PROPAGATION_MODE is None:
        _PROPAGATION_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    prop = _sharding_prop.ShardingPropagator
    saved = _sharding_prop.detect_fake_mode, prop._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        with _disable_current_modes():
            return saved[1](self, op_schema)

    _sharding_prop.detect_fake_mode = lambda *a, **k: _PROPAGATION_MODE
    prop._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        _sharding_prop.detect_fake_mode, prop._propagate_tensor_meta_non_cached = saved


@contextlib.contextmanager
def strided_shard_offsets_off_fake():
    """DTensor computes a ``_StridedShard``'s local size and offsets from a
    small index tensor (``torch.arange``); under ``FakeTensorMode`` it would
    be fake and have no values.  Compute it with every dispatch mode set
    aside (it reads no tensor of the step)."""
    check_torch()
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes

    original = _StridedShard.local_shard_size_and_offset

    def real(*args, **kwargs):
        with _disable_current_modes():
            return original(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = real
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = original


def start_fake_world(world: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``world``
    ranks (a running group of another size is destroyed first)."""
    check_torch()
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
