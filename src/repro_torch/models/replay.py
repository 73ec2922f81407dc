"""Model replay files: a run of the JAX package's model, replayed by the port.

A file holds, as one compressed ``.npz``:

* ``config``: the ``ModelConfig`` as JSON;
* ``param.<path>``: every parameter in JAX's layout (``/``-joined path);
  bfloat16 leaves as their ``uint16`` bits; or instead ``weights_seed``,
  when the weights are ``seeded_params(config, weights_seed)`` (numpy
  draws either package can make, for models whose weights would take a
  file past 300 KB);
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

The model fixtures (``seeded_params`` weights) hold one case per model
dtype in the same way, replayed by ``replay_model_case``: the MoE ones
``moe_<arch>_smoke.npz`` (DeepSeek-V2-Lite's and Qwen3-MoE's smoke configs,
``MOE_TOL``), the hybrid one ``hybrid_jamba_1_5_large_398b_smoke.npz``
(Jamba's smoke config: SSM and attention blocks with MLPs and MoE in one
group, ``HYBRID_TOL``), the VLM one ``vlm_internvl2_2b_smoke.npz``
(InternVL2's smoke config with its patch prefix, ``VLM_TOL``) and the
encoder-decoder one ``encdec_seamless_m4t_medium_smoke.npz``
(SeamlessM4T's smoke config, ``ENCDEC_TOL``).  Fields:
``tokens``, ``patches`` (VLM only: (B, P, d_model) float32 of bfloat16
values), ``frames`` (encoder-decoder only: (B, S_enc, d_model) float32 of
bfloat16 values, given to the model in its dtype), ``prefill_logits``,
``cache/<group>/<block>/<name>`` (float32, the prefill's caches: the MLA
latent rows, the K/V, the conv windows and SSD states, the cross K/V),
``fed`` and ``logits`` of greedy decode steps from position P+S against
those caches, the sequence caches padded with zeros to the prompt plus the
steps in their own dtype (``pad_caches``).

``tests/torch_parity.py`` writes them from the JAX package; the CPU tests
and ``chip_smoke.py`` replay them, teacher-forced (fed JAX's tokens).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.model import _dtype, decode_step, model_param_defs, prefill
from repro_torch.models.params import ParamDef, _walk, params_from_numpy, path_hash
from repro_torch.models.ssm import ScanFn

# Largest |port - JAX| allowed in a logit and an SSD state, per model dtype.
# float32: the frameworks' products and transcendental functions differ in
# the last bits (measured 1.2e-5 after 4 layers and 6 steps).  bfloat16: the
# products round to bfloat16 at other places in the two frameworks.
SSM_TOL = {"float32": 1e-4, "bfloat16": 0.05}
# Largest |port - JAX| allowed in a logit and in a cache value of the
# model fixtures, per model dtype (``compare_model_case``).  MoE: float32
# as SSM_TOL (measured on the CPU: 1.1e-5 after 3 layers and 6 steps);
# bfloat16 teacher-forced, the frameworks round the bfloat16 products and
# expert outputs at other places, which moves logits of up to ~4 and cache
# values of up to ~8 by a few bfloat16 steps (measured on the CPU: 0.047
# and 0.0625).
MOE_TOL = {"float32": dict(logits=1e-4, cache=1e-4),
           "bfloat16": dict(logits=0.1, cache=0.1)}
# Hybrid (Jamba's smoke period twice): the K/V values reach 18 (JAX's
# init reads the fan-in of a stacked 4-d projection from its head axis),
# so float32's last bits move them more (measured on the CPU: logits
# 2.3e-5, caches 6.0e-5).  bfloat16: the 8-layer chain amplifies rounding:
# flipping the last bit of 1% of the port's own bfloat16 embeddings moves
# its prefill logits by 0.32, its K/V by 2.1 and its decode logits by 1.2,
# and JAX's bfloat16 run lies 0.41 (logits) and 3.9 (caches) from its
# float32 run on the same weights.  Each block, fed JAX's input, agrees
# with JAX's within a bfloat16 step (tests/test_torch_hybrid.py), and so
# do its gradients within 4 (tests/test_torch_hybrid_bf16.py); the whole
# chain is held at the chain's own sensitivity (measured 0.41, 1.40 and
# 2.39): it sees the SSM blocks' residual branch scaled by 1.05, but not
# the attention block's scaled by 2 (tests/torch_hybrid_fault_reach.py).
HYBRID_TOL = {"float32": dict(logits=1e-4, cache=2e-4),
              "bfloat16": dict(logits=2.0, cache=4.0)}
# VLM (InternVL2's smoke config, 2 layers behind 8 patches): float32 as
# MoE's (measured 2.1e-5 and 2.7e-5); bfloat16 logits as MoE's (measured
# 0.049), the K/V values reach 18.6, where a bfloat16 step is 0.125, so
# the caches are held to two steps (measured 0.0625).
VLM_TOL = {"float32": dict(logits=1e-4, cache=1e-4),
           "bfloat16": dict(logits=0.1, cache=0.25)}
# Encoder-decoder (SeamlessM4T's smoke config: 2 encoder and 2 decoder
# layers, 16 frames): float32 as the hybrid's, the K/V values reach 15
# (measured on the CPU: logits 2.8e-5, caches 6.7e-5; on the H100: logits
# 3.9e-5, caches 1.32e-4).  bfloat16: JAX's init reads the
# fan-in of a stacked 4-d projection from its head axis, so the scores are
# large and the softmax near one-hot, and the chain amplifies rounding:
# JAX's own bfloat16 run lies 0.98 (prefill logits) and 3.36 (caches) from
# its float32 run on the same weights, and flipping the last bit of 1% of
# the port's own bfloat16 embeddings moves its prefill logits by 0.105 and
# its K by 0.25.  The port lies 0.131 (prefill logits), 0.328 (decode
# logits) and 0.531 (caches) from JAX's bfloat16 run (measured on the CPU).
ENCDEC_TOL = {"float32": dict(logits=1e-4, cache=2e-4),
              "bfloat16": dict(logits=0.5, cache=1.0)}


def seeded_params(cfg: ModelConfig, seed: int) -> dict:
    """Weights of ``cfg`` that either package can make: the parameter tree
    in JAX's layout as numpy arrays, each leaf drawn with
    ``numpy.random.default_rng([seed, path_hash(path)])`` by JAX's law (a
    standard normal truncated to [-2, 2], redrawn outside, times the
    fan-in scaled std; zeros and ones where the leaf's init says so) in
    float64, then float32, then the leaf's dtype (bfloat16 leaves as the
    ``uint16`` bits of the round to nearest even)."""
    def leaf(path: str, d: ParamDef) -> np.ndarray:
        if d.init in ("zeros", "ones"):
            a = np.full(d.shape, 0.0 if d.init == "zeros" else 1.0, np.float32)
        else:
            rng = np.random.default_rng([seed, path_hash(path)])
            x = rng.standard_normal(d.shape)
            bad = np.abs(x) > 2.0
            while bad.any():
                x[bad] = rng.standard_normal(int(bad.sum()))
                bad = np.abs(x) > 2.0
            std = d.scale if d.init == "embed" else d.scale / np.sqrt(
                max(d.shape[-2] if len(d.shape) >= 2 else d.shape[-1], 1))
            a = (x * std).astype(np.float32)
        if d.dtype == torch.bfloat16:
            return torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        return a

    return _walk(model_param_defs(cfg), leaf)


def save_model_replay(path, cfg: ModelConfig, params: dict, cases: dict[str, dict],
                      weights_seed: int | None = None) -> None:
    """``params``: ``{path: numpy array}`` (empty with ``weights_seed``);
    ``cases``: ``{name: {field: array}}``."""
    arrays = {"config": np.asarray(json.dumps(dataclasses.asdict(cfg), sort_keys=True))}
    if weights_seed is not None:
        if params:
            raise ValueError("give the weights or their seed, not both")
        arrays["weights_seed"] = np.asarray(weights_seed, np.int64)
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
    seed = arrays.pop("weights_seed", None)
    tree: dict = {} if seed is None else seeded_params(cfg, int(seed))
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


def _conv_outside(a_bits: np.ndarray, b_bits: np.ndarray, tol: float) -> tuple[int, int]:
    """Two conv windows as bfloat16 bits: their largest distance in
    bfloat16 steps, and the count of values more than one step and more
    than ``tol`` apart (a float32 value rounded to bfloat16 can land one
    step away; a small one left by cancellation, further)."""
    steps = _bf16_steps(a_bits, b_bits)
    far = np.abs(_bf16_values(a_bits) - _bf16_values(b_bits)) > tol
    return int(steps.max(initial=0)), int(((steps > 1) & far).sum())


def compare_ssm_case(case: dict, got: dict, tol: float) -> dict:
    """How the port's replay compares with JAX's run: the largest
    differences of the prefill logits, the SSD state and the decode logits;
    the conv windows' largest distance in bfloat16 steps and the count of
    their values outside ``tol`` (``_conv_outside``); whether the port's
    argmax equals JAX's next token at every step whose top-2 margin exceeds
    ``2 * tol`` (decided within the tolerance)."""
    def host(t):
        return t.float().cpu().numpy()

    conv = got["conv"].to(torch.bfloat16).cpu().view(torch.int16).numpy().view(np.uint16)
    logits = host(got["logits"])
    want = case["logits"]
    if logits.shape != want.shape or conv.shape != case["conv"].shape:
        raise AssertionError(f"shapes {logits.shape}, {conv.shape} against JAX's "
                             f"{want.shape}, {case['conv'].shape}")
    conv_steps, conv_outside = _conv_outside(conv, case["conv"], tol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol
    jax_next = np.concatenate([case["fed"][1:], want[-1:].argmax(-1)])
    return dict(
        prefill_max_abs_diff=float(np.abs(host(got["prefill_logits"]) - case["prefill_logits"]).max()),
        ssd_max_abs_diff=float(np.abs(host(got["ssd"]) - case["ssd"]).max()),
        conv_max_bf16_steps=conv_steps,
        conv_outside=conv_outside,
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


# Caches whose third axis is the sequence: padded for decode.  The Mamba2
# states (``conv``, ``ssd``) have fixed shapes.
SEQ_CACHES = ("k", "v", "latent")


def pad_caches(caches: list, seq: int) -> list:
    """Prefill caches (per group, ``{blk: {name: (steps, B, S, ...)}}``)
    with the sequence caches (``SEQ_CACHES``) zero-padded along S to
    ``seq`` positions, in their own dtype, and the SSM states as they are:
    the contiguous decode caches of the model replays."""
    def pad(t):
        out = torch.zeros((*t.shape[:2], seq, *t.shape[3:]), dtype=t.dtype, device=t.device)
        out[:, :, :t.shape[2]] = t
        return out

    return [{blk: {n: pad(t) if n in SEQ_CACHES else t for n, t in c.items()}
             for blk, c in g.items()} for g in caches]


def replay_model_case(cfg: ModelConfig, tree: dict, dtype: str, case: dict, device) -> dict:
    """The port's run of one model-fixture case on ``device``, the file's
    weights in the model dtype ``dtype`` (widened exactly to float32 where
    asked): ``prefill`` of the prompts (after the patches, where the case
    has them; after the encoder over the frames, where it has those), then
    ``decode_step`` from position P+S on the padded caches,
    fed JAX's tokens.  Returns tensors: ``prefill_logits`` (B,V), the
    prefill's ``cache/...`` and ``logits`` (T,B,V)."""
    params = params_from_numpy(tree, cfg, device)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if dtype == "float32":
        params = _widen(params)
    tokens = torch.from_numpy(case["tokens"]).to(device)
    batch = {"tokens": tokens}
    if "patches" in case:
        batch["patches"] = torch.from_numpy(case["patches"]).to(device)
    if "frames" in case:
        batch["frames"] = torch.from_numpy(case["frames"]).to(device, _dtype(cfg))
    logits, caches = prefill(params, cfg, batch)
    out = {"prefill_logits": logits[:, 0]}
    out.update({f"cache/g{i}/{blk}/{n}": t for i, g in enumerate(caches)
                for blk, c in g.items() for n, t in c.items()})
    length = tokens.shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)
    caches = pad_caches(caches, length + len(case["fed"]))
    pos = torch.full((tokens.shape[0],), length, dtype=torch.int32, device=device)
    steps = []
    for fed in case["fed"]:
        tok = torch.from_numpy(np.ascontiguousarray(fed[:, None])).to(device)
        step_logits, caches = decode_step(params, cfg, tok, pos, caches)
        steps.append(step_logits[:, 0])
        pos = pos + 1
    out["logits"] = torch.stack(steps)
    return out


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 values as the ``uint16`` bits of their bfloat16 rounding."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint16)


def compare_model_case(case: dict, got: dict, tol: dict) -> dict:
    """How the port's replay of a model-fixture case compares with JAX's
    run (``tol``: ``{"logits", "cache"}``, as ``MOE_TOL``'s entries): the
    largest differences of the prefill logits, the caches and the decode
    logits; the count of bfloat16 conv-window values outside
    ``tol["cache"]`` (``_conv_outside``); whether the port's argmax equals
    JAX's next token at every step whose top-2 margin exceeds
    ``2 * tol["logits"]``."""
    def host(t):
        return t.float().cpu().numpy()

    names = sorted(k for k in case if k.startswith("cache/"))
    if names != sorted(k for k in got if k.startswith("cache/")):
        raise AssertionError(f"caches {names} against the port's {sorted(got)}")
    logits, want = host(got["logits"]), case["logits"]
    if logits.shape != want.shape:
        raise AssertionError(f"logits {logits.shape} against JAX's {want.shape}")
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * tol["logits"]
    jax_next = np.concatenate([case["fed"][1:], want[-1:].argmax(-1)])
    convs = [k for k in names if k.endswith("/conv")]
    conv_outside = sum(_conv_outside(_bf16_bits(host(got[k])), _bf16_bits(case[k]),
                                     tol["cache"])[1] for k in convs)
    rest = [k for k in names if k not in convs]
    return dict(
        prefill_max_abs_diff=float(np.abs(host(got["prefill_logits"]) - case["prefill_logits"]).max()),
        cache_max_abs_diff=max((float(np.abs(host(got[k]) - case[k]).max()) for k in rest),
                               default=0.0),
        conv_outside=conv_outside,
        decode_max_abs_diff=float(np.abs(logits - want).max()),
        max_abs_logit=float(np.abs(want).max()),
        steps_decided=f"{int(decided.sum())}/{decided.size}",
        argmax_equal_where_decided=bool((logits.argmax(-1) == jax_next)[decided].all()),
    )


def model_case_ok(res: dict, tol: dict) -> bool:
    return (res["prefill_max_abs_diff"] <= tol["logits"]
            and res["decode_max_abs_diff"] <= tol["logits"]
            and res["cache_max_abs_diff"] <= tol["cache"] and res["conv_outside"] == 0
            and res["argmax_equal_where_decided"])
