"""Model replay files: a run of the JAX package's model, replayed by the port.

A file holds, as one compressed ``.npz``:

* ``config``: the ``ModelConfig`` as JSON;
* ``param.<path>``: every parameter in JAX's layout (``/``-joined path);
  bfloat16 leaves as their ``uint16`` bits;
* per case ``<c>``, its fields as ``<c>.<field>``.

``save_model_replay``/``load_model_replay`` write and read that layout
(the serving fixture, ``serving/replay.py``, is one such file).  The Mamba2
fixture ``ssm_mamba2_smoke.npz`` holds one case per model dtype
(``SSM_TOL``), each a JAX run of the file's bfloat16 weights (widened
exactly to float32 in the float32 case):

* ``tokens`` (B, S) int32, the prompts;
* ``prefill_logits`` (B, V) float32, ``prefill``'s last-position logits;
* ``conv`` (L, B, K-1, C) uint16, the bfloat16 bits of every layer's
  prefill conv window; ``ssd`` (B, H, P, N) float32, the last layer's
  prefill SSD state (it depends on every layer below it; all four layers'
  states would take the file past 300 KB);
* ``fed`` (T, B) int32, the token fed to each ``decode_step`` (the prompt's
  last, then JAX's greedy choices); ``logits`` (T, B, V) float32, the
  logits each step returned.

``tests/torch_parity.py`` writes it from the JAX package; the CPU tests and
``chip_smoke.py`` replay it, teacher-forced (fed JAX's tokens).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import params_from_numpy
from repro_torch.models.ssm import ScanFn

# Largest |port - JAX| allowed in a logit and an SSD state, per model dtype.
# float32: the frameworks' products and transcendental functions differ in
# the last bits (measured 1.2e-5 after 4 layers and 6 steps).  bfloat16: the
# products round to bfloat16 at other places in the two frameworks.
SSM_TOL = {"float32": 1e-4, "bfloat16": 0.05}


def save_model_replay(path, cfg: ModelConfig, params: dict, cases: dict[str, dict]) -> None:
    """``params``: ``{path: numpy array}``; ``cases``: ``{name: {field: array}}``."""
    arrays = {"config": np.asarray(json.dumps(dataclasses.asdict(cfg), sort_keys=True))}
    for k, a in params.items():
        a = np.asarray(a)
        arrays[f"param.{k}"] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    for name, fields in cases.items():
        arrays.update({f"{name}.{k}": np.asarray(v) for k, v in fields.items()})
    np.savez_compressed(path, **arrays)


def load_model_replay(path) -> tuple[ModelConfig, dict, dict[str, dict]]:
    """(config, the parameter tree as numpy arrays in JAX's layout,
    ``{case: {field: array}}``)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    cfg = ModelConfig(**json.loads(str(arrays.pop("config"))))
    tree: dict = {}
    for k in [k for k in arrays if k.startswith("param.")]:
        node = tree
        *parents, leaf = k[len("param."):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arrays.pop(k)
    cases: dict[str, dict] = {}
    for k, v in arrays.items():
        name, field = k.split(".", 1)
        cases.setdefault(name, {})[field] = v
    return cfg, tree, cases


def _widen(tree: dict) -> dict:
    """Every leaf as float32 (exact from bfloat16)."""
    return {k: _widen(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


def replay_ssm_case(cfg: ModelConfig, tree: dict, dtype: str, case: dict, device,
                    ssd_scan: ScanFn = ops.ssd_scan) -> dict:
    """The port's run of one Mamba2 case on ``device``, the file's weights
    in the model dtype ``dtype`` (widened exactly to float32 where asked):
    ``prefill`` of the prompts, then ``decode_step`` fed JAX's tokens.  Returns tensors:
    ``prefill_logits`` (B,V), ``conv`` (L,B,K-1,C), ``ssd`` (B,H,P,N) of the
    last layer, ``logits`` (T,B,V)."""
    params = params_from_numpy(tree, cfg, device)   # in the file's dtypes, bits kept
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if dtype == "float32":
        params = _widen(params)
    tokens = torch.from_numpy(case["tokens"]).to(device)
    logits, caches = prefill(params, cfg, {"tokens": tokens}, ssd_scan=ssd_scan)
    out = {"prefill_logits": logits[:, 0], "conv": caches[0]["blk0"]["conv"],
           "ssd": caches[0]["blk0"]["ssd"][-1]}
    pos = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32, device=device)
    steps = []
    for fed in case["fed"]:
        tok = torch.from_numpy(np.ascontiguousarray(fed[:, None])).to(device)
        step_logits, caches = decode_step(params, cfg, tok, pos, caches)
        steps.append(step_logits[:, 0])
        pos = pos + 1
    out["logits"] = torch.stack(steps)
    return out


def _bf16_steps(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """Elementwise distance, in bfloat16 steps, between two arrays of
    bfloat16 bit patterns (``uint16``)."""
    def order(bits):
        b = bits.astype(np.int32)
        return np.where(b & 0x8000, -(b & 0x7FFF), b)
    return np.abs(order(a_bits) - order(b_bits))


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def compare_ssm_case(case: dict, got: dict, tol: float) -> dict:
    """How the port's replay compares with JAX's run: the largest
    differences of the prefill logits, the SSD state and the decode logits;
    the conv windows' largest distance in bfloat16 steps and the count of
    their values more than one step apart and more than ``tol`` apart (a
    float32 value rounded to bfloat16 can land one step away; a small one
    left by cancellation, further); whether the port's argmax equals JAX's
    next token at every step whose top-2 margin exceeds ``2 * tol``
    (decided within the tolerance)."""
    def host(t):
        return t.float().cpu().numpy()

    conv = got["conv"].to(torch.bfloat16).cpu().view(torch.int16).numpy().view(np.uint16)
    logits = host(got["logits"])
    want = case["logits"]
    if logits.shape != want.shape or conv.shape != case["conv"].shape:
        raise AssertionError(f"shapes {logits.shape}, {conv.shape} against JAX's "
                             f"{want.shape}, {case['conv'].shape}")
    steps = _bf16_steps(conv, case["conv"])
    conv_diff = np.abs(_bf16_values(conv) - _bf16_values(case["conv"]))
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol
    jax_next = np.concatenate([case["fed"][1:], want[-1:].argmax(-1)])
    return dict(
        prefill_max_abs_diff=float(np.abs(host(got["prefill_logits"]) - case["prefill_logits"]).max()),
        ssd_max_abs_diff=float(np.abs(host(got["ssd"]) - case["ssd"]).max()),
        conv_max_bf16_steps=int(steps.max()),
        conv_outside=int(((steps > 1) & (conv_diff > tol)).sum()),
        decode_max_abs_diff=float(np.abs(logits - want).max()),
        max_abs_logit=float(np.abs(want).max()),
        steps_decided=f"{int(decided.sum())}/{decided.size}",
        argmax_equal_where_decided=bool((logits.argmax(-1) == jax_next)[decided].all()),
    )


def ssm_case_ok(res: dict, tol: float) -> bool:
    """Within ``tol`` (logits and state), no conv value outside (see
    ``compare_ssm_case``), and the greedy tokens equal where decided."""
    return (res["prefill_max_abs_diff"] <= tol and res["ssd_max_abs_diff"] <= tol
            and res["decode_max_abs_diff"] <= tol and res["conv_outside"] == 0
            and res["argmax_equal_where_decided"])
