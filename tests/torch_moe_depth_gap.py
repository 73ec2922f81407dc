"""How far a MoE decode step lies from a prefill continuation, by depth and
dtype, on the CPU.

Not a test module.  A DeepSeek-V2-Lite-shaped model (MLA, 64 routed
experts top-6 and 2 shared, a dense first layer), narrowed to d 512 so
that the CPU runs it at full depth, random weights from seed 0: 4 prompts
of 128 tokens prefilled, one ``decode_step`` of each prompt's greedy next
token, against a prefill of the prompt and that token.  Both prefills use
a capacity no expert can fill (factor 2E/K), so no pair is dropped and
the two compute the same function; the gap is rounding, amplified where a
token's top-6 experts flip between near-equal router probabilities.

Run: ``PYTHONPATH=src python tests/torch_moe_depth_gap.py [layers ...]``
(default 2 8 27; ~3 min).  Prints one JSON line per (layers, dtype).
"""
from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.config import get_arch
from repro_torch.models.model import decode_step, init_model, prefill
from repro_torch.models.replay import _widen, pad_caches

PROMPT = 128


def depth_gap(layers: int, dtype: str) -> dict:
    cfg = dataclasses.replace(
        get_arch("deepseek_v2_lite_16b"), num_layers=layers, d_model=512, num_heads=8,
        num_kv_heads=8, kv_lora_rank=128, dense_d_ff=1024, moe_d_ff=256, vocab_size=4096)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    if dtype == "float32":
        cfg, params = dataclasses.replace(cfg, dtype="float32"), _widen(params)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=2 * cfg.moe_num_experts / cfg.moe_top_k)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, PROMPT)).astype(np.int32))
    logits, caches = prefill(params, cfg, {"tokens": tokens})
    first = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    step, _ = decode_step(params, cfg, first, torch.full((4,), PROMPT, dtype=torch.int32),
                          pad_caches(caches, PROMPT + 1))
    cont, _ = prefill(params, cfg, {"tokens": torch.cat([tokens, first], dim=1)})
    step, cont = step[:, 0], cont[:, -1]
    return dict(layers=layers, dtype=dtype, max_abs_gap=float((step - cont).abs().max()),
                max_abs_logit=float(cont.abs().max()),
                argmax_equal=f"{int((step.argmax(-1) == cont.argmax(-1)).sum())}/4")


if __name__ == "__main__":
    for n in [int(a) for a in sys.argv[1:]] or [2, 8, 27]:
        for dt in ("float32", "bfloat16"):
            print(json.dumps(depth_gap(n, dt)), flush=True)
