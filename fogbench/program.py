"""What the benchmark takes from the program under test, ``repro_torch``.

The system under test (``init_sim``, ``run_sim`` with the hand-written
kernels, the kernel build), its counters (``kernels/ops.py::LAUNCHES``) and
its kernel entry points (``core/flic.py::KERNEL_BACKENDS``, spied on to count
a kernel's work from its inputs).  Every import of the program is in this
file, inside its functions.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

# Configuration-file keys that are ``SimConfig`` fields.
SIM_KEYS = ("n_nodes", "cache_lines", "cache_ways", "payload_dim", "row_bytes", "query_bytes",
            "read_period", "read_window_keys", "loss_model", "loss_prob", "insert_policy",
            "queue_capacity", "writer_max_per_tick", "lat_local", "lat_lan_base",
            "lat_lan_per_node", "lat_store")


def build() -> None:
    """Compile the program's kernels into the checkout, where missing."""
    from repro_torch.kernels import build as kbuild

    kbuild.build_all()


def sim_config(config: dict, workload: dict, seed: int, trace_ticks: int):
    """The program's ``SimConfig`` of a cell, running its CUDA kernels.  A
    trace mix names the benchmark's trace (seeded from the run's seed) with
    ``trace_ticks`` rows: the program checks a run against its length."""
    from repro_torch.core import backing_store as bs
    from repro_torch.core import simulator as sim
    from repro_torch.core import workload as wl

    spec = dict(workload)
    trace = spec.pop("trace", None)
    if trace is not None:
        spec["trace"] = wl.TraceSpec(**trace, length=max(1, trace_ticks), seed=seed)
    return sim.SimConfig(
        **{k: config[k] for k in SIM_KEYS},
        outage_schedule=tuple(tuple(x) for x in config["outage_schedule"]),
        store=bs.StoreProfile(**config["store"]),
        workload=wl.WorkloadSpec(**spec, fanout=config["fanout"]),
        probe_backend="cuda",
    )


def init(cfg, device):
    from repro_torch.core.simulator import init_sim

    return init_sim(cfg, device)


def tick_draws(t: int, plan: dict, uniforms: dict):
    """The benchmark's plan and uniforms of tick ``t`` as a ``TickDraws``."""
    from repro_torch.core import simulator as sim
    from repro_torch.core import workload as wl

    fields = {k: v for k, v in plan.items() if k != "state_next"}
    request = wl.RequestPlan(**fields, state_next=wl.PlanState(**plan["state_next"]))
    return sim.TickDraws(t=t, plan=request, **uniforms)


def run(cfg, ticks: int, draws, state, device):
    """The public entry: ``run_sim`` for ``ticks`` ticks from ``state`` on
    ``draws``; returns (state, series)."""
    from repro_torch.core.simulator import run_sim

    return run_sim(cfg, ticks, draws=draws, state=state, device=device)


def flat(obj, prefix: str = "") -> dict:
    """A (nested) dataclass of tensors as ``{"caches.tags": tensor, ...}``."""
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out.update(flat(value, prefix + f.name + "."))
        else:
            out[prefix + f.name] = value
    return out


def launch_counts() -> dict:
    from repro_torch.kernels import ops

    return dict(ops.LAUNCHES)


def reset_launch_counts() -> None:
    from repro_torch.kernels import ops

    ops.reset_launches()


def hand_kernel_names() -> tuple[str, ...]:
    """Names of the program's hand-written kernels (its launch counters)."""
    return tuple(launch_counts())


@contextlib.contextmanager
def spy(names, on_call):
    """Call ``on_call(name, args)`` before each call of a kernel entry whose
    name is in ``names``, while the block runs."""
    from repro_torch.core import flic

    saved = dict(flic.KERNEL_BACKENDS)

    def wrap(fn):
        def call(*args):
            on_call(fn.__name__, args)
            return fn(*args)
        return call

    try:
        for backend, fns in saved.items():
            flic.KERNEL_BACKENDS[backend] = tuple(
                wrap(fn) if fn.__name__ in names else fn for fn in fns)
        yield
    finally:
        flic.KERNEL_BACKENDS.clear()
        flic.KERNEL_BACKENDS.update(saved)


def to_host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu") for k, v in tensors.items()}


def empty_device_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
