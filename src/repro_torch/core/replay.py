"""Replay files: a run's per-tick draws and its expected metric series.

A replay holds everything random that a run consumed, tick by tick, so the
port can execute exactly the run another engine executed.  The format is a
flat dict of numpy arrays, saved as one compressed ``.npz``:

* ``config``: the ``SimConfig`` as JSON;
* ``t``: the ticks, ``(T,)``;
* ``plan.<field>`` and ``plan.state_next.<field>``: the ``RequestPlan`` of
  each tick, stacked ``(T, ...)``;
* ``u_ge_up``, ``u_ge_dn``, ``u_deliver``, ``u_resp``, ``u_coll``: the
  uniforms of ``simulator.TickDraws``, stacked, where the config draws them;
* ``metrics.<field>``: the expected ``TickMetrics`` series.

``tests/torch_parity.py`` writes these from the JAX package;
``src/repro_torch/testdata/`` holds two of them, which ``chip_smoke.py``
replays on the card.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.core import backing_store as bs
from repro_torch.core import workload as wl
from repro_torch.core.simulator import SimConfig, TickDraws, draw_shapes


def config_to_json(cfg: SimConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg), sort_keys=True)


def config_from_json(text: str) -> SimConfig:
    d = json.loads(text)
    w = d["workload"]
    if w["trace"] is not None:
        w["trace"] = wl.TraceSpec(**w["trace"])
    d["workload"] = wl.WorkloadSpec(**w)
    d["store"] = bs.StoreProfile(**d["store"])
    d["outage_schedule"] = tuple(tuple(x) for x in d["outage_schedule"])
    return SimConfig(**d)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def draws_from_arrays(cfg: SimConfig, arrays: dict, device) -> list[TickDraws]:
    """Unstack ``t``/``plan.*``/``u_*`` arrays into one ``TickDraws`` per tick."""
    stacked = {k: _tensor(np.asarray(v), device) for k, v in arrays.items()
               if k.startswith(("plan.", "u_"))}
    missing = [k for k in draw_shapes(cfg) if k not in stacked]
    if missing:
        raise ValueError(f"replay lacks the draws {missing} that this config consumes")
    out = []
    for i, t in enumerate(np.asarray(arrays["t"]).tolist()):
        plan_state = wl.PlanState(**{
            f.name: stacked[f"plan.state_next.{f.name}"][i]
            for f in dataclasses.fields(wl.PlanState)
        })
        plan = wl.RequestPlan(state_next=plan_state, **{
            f.name: stacked[f"plan.{f.name}"][i]
            for f in dataclasses.fields(wl.RequestPlan) if f.name != "state_next"
        })
        uniforms = {k: stacked[k][i] for k in draw_shapes(cfg)}
        out.append(TickDraws(t=int(t), plan=plan, **uniforms))
    return out


def draws_to_arrays(draws: list[TickDraws]) -> dict[str, np.ndarray]:
    """The inverse of ``draws_from_arrays``: ``t``/``plan.*``/``u_*`` stacked
    into numpy arrays (how the multi-process engines hand draws to their
    ranks)."""
    def stack(tensors):
        return np.stack([x.detach().cpu().numpy() for x in tensors])

    out = {"t": np.asarray([d.t for d in draws], np.int64)}
    for f in dataclasses.fields(wl.RequestPlan):
        if f.name != "state_next":
            out[f"plan.{f.name}"] = stack(getattr(d.plan, f.name) for d in draws)
    for f in dataclasses.fields(wl.PlanState):
        out[f"plan.state_next.{f.name}"] = stack(getattr(d.plan.state_next, f.name)
                                                 for d in draws)
    for name in ("u_ge_up", "u_ge_dn", "u_deliver", "u_resp", "u_coll"):
        if getattr(draws[0], name) is not None:
            out[name] = stack(getattr(d, name) for d in draws)
    return out


def save_replay(path, cfg: SimConfig, arrays: dict) -> None:
    np.savez_compressed(path, config=np.asarray(config_to_json(cfg)), **arrays)


def load_replay(path, device) -> tuple[SimConfig, list[TickDraws], dict[str, np.ndarray]]:
    """(config, draws on ``device``, expected series ``{field: (T,) array}``)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    cfg = config_from_json(str(arrays.pop("config")))
    expected = {k.split(".", 1)[1]: v for k, v in arrays.items() if k.startswith("metrics.")}
    return cfg, draws_from_arrays(cfg, arrays, device), expected
