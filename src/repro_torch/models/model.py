"""Top-level model API: param defs, init, forward, prefill, decode.

Port of ``repro.models.model`` for the stacks the port runs (dense GQA):

  * ``model_param_defs(cfg)``        — ParamDef tree (single source of truth);
  * ``init_model(cfg, generator, device)`` — random weights from a seed;
  * ``forward(params, cfg, batch)``  — hidden states for train/prefill;
  * ``prefill`` / ``decode_step``    — serving with contiguous per-layer caches.

Batches: ``{"tokens": (B,S) int32}``.  The VLM patch prefix, the encoder
and the training loss are later work (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import embed_defs, embed_tokens, f32, rmsnorm, rmsnorm_defs
from repro_torch.models.params import init_params
from repro_torch.models.stack import apply_group, cache_specs, group_param_defs, plan_groups


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def model_param_defs(cfg: ModelConfig) -> dict:
    dt = _dtype(cfg)
    enc_groups, dec_groups = plan_groups(cfg)
    if enc_groups:
        raise NotImplementedError("encoder-decoder stacks are not ported yet (ROADMAP.md, Queue 1)")
    defs: dict[str, Any] = {"embed": embed_defs(cfg, dt)}
    defs["dec"] = {f"g{i}": group_param_defs(cfg, g, dt) for i, g in enumerate(dec_groups)}
    defs["final_norm"] = rmsnorm_defs(cfg.d_model, dt)
    return defs


def init_model(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    return init_params(model_param_defs(cfg), generator, device)


def forward(params, cfg: ModelConfig, batch: dict, mode: str = "train"):
    """Returns (hidden, aux_loss, caches, text_offset). Caches only in prefill."""
    if cfg.family == "vlm" and "patches" in batch:
        raise NotImplementedError("the VLM patch prefix is not ported yet (ROADMAP.md, Queue 1)")
    x = embed_tokens(params["embed"], batch["tokens"])
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    _, dec_groups = plan_groups(cfg)
    caches = []
    for i, g in enumerate(dec_groups):
        x, c = apply_group(params["dec"][f"g{i}"], cfg, g, x, pos,
                           "prefill" if mode == "prefill" else "train")
        if mode == "prefill":
            caches.append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, caches if mode == "prefill" else None, 0


def _lm_head_weight(params, cfg: ModelConfig):
    emb = params["embed"]
    return emb["tok"].T if cfg.tie_embeddings else emb["head"]


def prefill(params, cfg: ModelConfig, batch: dict):
    """Full-prompt forward returning per-group caches + last-position logits."""
    hidden, _, caches, _ = forward(params, cfg, batch, "prefill")
    logits = f32(hidden[:, -1:] @ _lm_head_weight(params, cfg))
    return logits, caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: torch.Tensor,
                caches: list):
    """One token for every sequence in the batch.

    token: (B,1) int32; pos: (B,) current lengths; caches: stacked per group
    (``decode_cache_specs``), updated IN PLACE.  Returns (logits (B,1,V)
    float32, caches).
    """
    x = embed_tokens(params["embed"], token)
    _, dec_groups = plan_groups(cfg)
    new_caches = []
    for i, g in enumerate(dec_groups):
        x, c = apply_group(params["dec"][f"g{i}"], cfg, g, x, None, "decode",
                           cache=caches[i], kv_len=pos)
        new_caches.append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = f32(x @ _lm_head_weight(params, cfg))
    return logits, new_caches


def decode_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> list[dict]:
    return cache_specs(cfg, batch, seq)
