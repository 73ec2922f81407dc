"""Serve replay files: a serving run of the JAX package, replayed by the port.

A file holds, as one compressed ``.npz``:

* ``config``: the ``ModelConfig`` as JSON;
* ``param.<path>``: every parameter in JAX's layout (``/``-joined path);
  bfloat16 leaves as their ``uint16`` bits;
* per case ``<c>`` (``CASES``): ``<c>.engine`` (max_batch, max_seq,
  page_size, num_pages), ``<c>.prompts`` (R, S) and ``<c>.max_new`` (R,) in
  submit order (request id r + 1 is row r), and what JAX's engine did:
  ``<c>.tokens`` (R, max_new), ``<c>.logits`` (R, max_new, V) float32 (each
  decode step's logits of the request), ``<c>.reused`` (R,) and
  ``<c>.stats`` (``FlicPageManager.stats`` as JSON).

The layout is ``models/replay.py``'s.  ``tests/torch_parity.py`` writes
the file from the JAX package with ``models.replay.save_model_replay``;
``chip_smoke.py`` replays it on the card and the CPU tests on the CPU.  A
replay is teacher-forced: the port's engine is fed JAX's tokens, so its
logits can be compared step by step even where a near-tie would let the
two frameworks' greedy choices part.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.params import params_from_numpy
from repro_torch.models.replay import load_model_replay
from repro_torch.serving.engine import TeacherForcedEngine

CASES = ("main", "tight")


def load_serve_replay(path, device) -> tuple[ModelConfig, dict, dict[str, dict]]:
    """(config, the port's parameters on ``device``, ``{case: fields}``);
    ``stats`` comes back as a dict."""
    cfg, tree, cases = load_model_replay(path)
    for fields in cases.values():
        fields["stats"] = json.loads(str(fields["stats"]))
    return cfg, params_from_numpy(tree, cfg, device), cases


def replay_case(cfg: ModelConfig, params: dict, case: dict, device,
                kernel_backend=None) -> TeacherForcedEngine:
    """Run one case through the port's engine, fed JAX's tokens."""
    max_batch, max_seq, page_size, num_pages = (int(x) for x in case["engine"])
    script = {r + 1: [int(t) for t in toks] for r, toks in enumerate(case["tokens"])}
    eng = TeacherForcedEngine(
        cfg, params, script=script, max_batch=max_batch, max_seq=max_seq,
        page_size=page_size, num_pages=num_pages or None,
        kernel_backend=kernel_backend, device=device,
    )
    for prompt, max_new in zip(case["prompts"], case["max_new"]):
        eng.submit([int(t) for t in prompt], max_new=int(max_new))
    eng.run()
    return eng


def compare_case(case: dict, eng: TeacherForcedEngine, tol: float) -> dict:
    """How the port's replay compares with JAX's run: the largest logit
    difference; the steps where JAX's top-2 logit margin exceeds ``2 * tol``,
    so that the greedy token is decided within the tolerance, and whether
    the port's argmax equals JAX's token at every one of them; whether
    prefix reuse and the manager's stats equal JAX's.  (The tokens fed are
    JAX's: the replay is teacher-forced.)"""
    want = case["logits"]
    got = np.stack([torch.stack(eng.logits[r + 1]).float().cpu().numpy()
                    for r in range(want.shape[0])])
    if got.shape != want.shape:
        raise AssertionError(f"logits of shape {got.shape}, JAX's {want.shape}")
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    decided = margin > 2 * tol
    by_rid = {r.rid: r for r in eng.finished}
    return dict(
        max_abs_diff=float(np.abs(got - want).max()),
        max_abs_logit=float(np.abs(want).max()),
        steps=int(margin.size),
        steps_decided=int(decided.sum()),
        argmax_equal_where_decided=bool(
            (got.argmax(-1) == case["tokens"])[decided].all()),
        reused_equal=[by_rid[r + 1].reused_prefill for r in range(len(case["reused"]))]
        == [bool(x) for x in case["reused"]],
        stats_equal=eng.mgr.stats == case["stats"],
    )
