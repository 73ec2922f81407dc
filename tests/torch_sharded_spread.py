"""Seed-to-seed spread of the sharded engine's tolerance-tier deltas, the
port's engine beside JAX's.

For one ``conformance.SHARDED_CASES`` case and seeds 0..n-1 at world 4 it
runs the port's sharded engine (spawned gloo ranks on the CPU, one group),
JAX's sharded engine on 4 forced host devices (a subprocess) and JAX's
fused engine, and prints one JSON object: each engine's mean and standard
deviation of the miss and stale ratios, and for each sharded engine how
many seeds leave the case's eps against the fused run.  Not a test module.

    PYTHONPATH=src:tests python tests/torch_sharded_spread.py zipf_hot 52
"""
import json
import os
import subprocess
import sys

import numpy as np
from conformance import CASES, SHARDED_CASES
from torch_parity import torch_config

from repro_torch.core.distributed import EngineRun, run_group
from repro_torch.core.metrics import summarize

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_RUNS = """
import json, sys, jax, numpy as np
from jax.sharding import Mesh
from conformance import CASES
from repro.core.metrics import summarize
from repro.core.sharded import run_sharded_sim
from repro.core.simulator import run_sim
case, n = sys.argv[1], int(sys.argv[2])
c = CASES[case]
mesh = Mesh(np.asarray(jax.devices()[:4]), ('data',))
out = {'sharded': [], 'fused': []}
for seed in range(n):
    for name, series in (('sharded', run_sharded_sim(mesh, c.cfg, c.ticks, axis='data', seed=seed)[1]),
                         ('fused', run_sim(c.cfg, c.ticks, seed=seed)[1])):
        s = summarize(series)
        out[name].append([s['read_miss_ratio'], s['stale_read_ratio']])
print(json.dumps(out))
"""


def main(case: str, n: int) -> dict:
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]))
    jax_out = subprocess.run([sys.executable, "-c", JAX_RUNS, case, str(n)], env=env,
                             capture_output=True, text=True, check=True, timeout=3600)
    ratios = {k: np.asarray(v) for k, v in json.loads(jax_out.stdout.splitlines()[-1]).items()}
    c = CASES[case]
    runs = [EngineRun("sharded", torch_config(c.cfg), c.ticks, seed) for seed in range(n)]
    res = run_group(runs, world=4, backend="gloo", device="cpu", timeout=3600)
    ratios["port_sharded"] = np.asarray([[summarize(r.series)["read_miss_ratio"],
                                          summarize(r.series)["stale_read_ratio"]] for r in res])
    tol = SHARDED_CASES[case]
    eps = np.asarray([tol.miss_ratio_eps, tol.stale_ratio_eps])
    report = {"case": case, "seeds": n, "eps": eps.tolist()}
    for name, r in ratios.items():
        report[name] = {"mean": r.mean(axis=0).tolist(), "sd": r.std(axis=0).tolist()}
        if name != "fused":
            report[name]["seeds_outside_eps"] = (np.abs(r - ratios["fused"]) > eps).sum(
                axis=0).tolist()
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1] if len(sys.argv) > 1 else "zipf_hot",
                          int(sys.argv[2]) if len(sys.argv) > 2 else 52)))
