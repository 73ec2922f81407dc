"""Production meshes (port of ``repro.launch.mesh``).

Defined as FUNCTIONS (never module-level constants), so importing this
module touches no process group.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` with named dims over the
current process group, which the caller has started
(``torch.distributed.init_process_group``; the dry-run starts a ``fake``
one of 256 or 512 ranks).
"""
from __future__ import annotations

import math

import torch.distributed as dist


def _device_type() -> str:
    """The mesh's device type: ``cuda`` under NCCL, else ``cpu``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 ranks) or 2x16x16 two-pod (512 ranks) mesh;
    raises where the world is smaller."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks (start a process group of world size {n}, e.g. the "
            f"'fake' backend for a dry-run); have {world}")
    if world > n:
        raise RuntimeError(f"the production mesh takes the whole world of {n} ranks; have {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1):
    """Whatever this process group offers (tests/examples): (world/model, model)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world {n} is not a multiple of model {model}")
    return init_device_mesh(_device_type(), (n // model, model), mesh_dim_names=("data", "model"))
