"""Transformer stacks: block descriptors and a loop over layers.

Port of ``repro.models.stack``.  ``BlockDef``, ``Group`` and
``plan_groups`` are copied whole; the rest supports the blocks the port can
run, attention (``mixer="attn"``) with a dense MLP (``ffn="mlp"``), and
raises ``NotImplementedError`` for any other block.  JAX's ``lax.scan``
over layers is a Python loop over the leading ``layers`` axis of each
parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_defs, rmsnorm, rmsnorm_defs
from repro_torch.models.params import stack_defs


@dataclasses.dataclass(frozen=True)
class BlockDef:
    mixer: str                 # "attn" | "mla" | "ssm"
    ffn: str                   # "mlp" | "moe" | "none"
    causal: bool = True
    cross: bool = False        # decoder block with cross-attention
    dense_ff: int = 0          # d_ff override for this block's dense MLP


@dataclasses.dataclass(frozen=True)
class Group:
    steps: int
    blocks: tuple[BlockDef, ...]

    @property
    def layers(self) -> int:
        return self.steps * len(self.blocks)


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Shape and dtype of one cache tensor (JAX's ``ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Architecture -> groups
# ---------------------------------------------------------------------------

def plan_groups(cfg: ModelConfig) -> tuple[list[Group], list[Group]]:
    """Returns (encoder_groups, decoder_groups). Encoder empty for LMs."""
    if cfg.family == "encdec":
        enc = [Group(cfg.enc_layers, (BlockDef("attn", "mlp", causal=False),))]
        dec = [Group(cfg.num_layers, (BlockDef("attn", "mlp", cross=True),))]
        return enc, dec
    if cfg.family == "ssm":
        return [], [Group(cfg.num_layers, (BlockDef("ssm", "none"),))]
    if cfg.family == "hybrid":
        period = cfg.attn_period
        if cfg.num_layers % period:
            raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of attn_period {period}")
        blocks = []
        for i in range(period):
            mixer = "attn" if i == period // 2 else "ssm"
            ffn = "moe" if (i % cfg.moe_layer_period == cfg.moe_layer_period - 1) else "mlp"
            blocks.append(BlockDef(mixer, ffn))
        return [], [Group(cfg.num_layers // period, tuple(blocks))]
    if cfg.family == "moe":
        mixer = "mla" if cfg.use_mla else "attn"
        groups = []
        n = cfg.num_layers
        if cfg.first_layer_dense:
            groups.append(Group(1, (BlockDef(mixer, "mlp", dense_ff=cfg.dense_d_ff),)))
            n -= 1
        groups.append(Group(n, (BlockDef(mixer, "moe"),)))
        return [], groups
    # dense / vlm
    return [], [Group(cfg.num_layers, (BlockDef("attn", "mlp"),))]


def _supported(bd: BlockDef) -> None:
    if bd.mixer != "attn" or bd.ffn != "mlp" or bd.cross:
        raise NotImplementedError(
            f"block {bd} is not ported yet: the port runs attention + dense MLP "
            "blocks (ROADMAP.md, Queue 1)"
        )


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, bd: BlockDef, dtype) -> dict:
    _supported(bd)
    return {
        "ln1": rmsnorm_defs(cfg.d_model, dtype),
        "mixer": attn.gqa_defs(cfg, dtype),
        "ln2": rmsnorm_defs(cfg.d_model, dtype),
        "ffn": mlp_defs(cfg.d_model, bd.dense_ff or cfg.d_ff, dtype),
    }


def group_param_defs(cfg: ModelConfig, g: Group, dtype) -> dict:
    per_step = {f"blk{i}": _block_defs(cfg, bd, dtype) for i, bd in enumerate(g.blocks)}
    return stack_defs(per_step, g.steps)


# ---------------------------------------------------------------------------
# Cache specs (contiguous decode caches)
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> list[dict]:
    """Per decoder group, ``{"blk<i>": {"k": CacheSpec, "v": CacheSpec}}``
    stacked over steps: bfloat16 ``(steps, batch, seq, Hkv, D)``."""
    _, dec = plan_groups(cfg)
    out = []
    for g in dec:
        specs = {}
        for i, bd in enumerate(g.blocks):
            _supported(bd)
            shape = (g.steps, batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
            specs[f"blk{i}"] = {"k": CacheSpec(shape, torch.bfloat16),
                                "v": CacheSpec(shape, torch.bfloat16)}
        out.append(specs)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(bp: dict, cfg: ModelConfig, bd: BlockDef, x, positions, mode: str,
                 cache: Optional[dict], kv_len):
    """One sublayer. Returns (x, new_cache)."""
    _supported(bd)
    new_cache: dict[str, Any] = {}
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        y, k_cache, v_cache = attn.gqa_decode(
            bp["mixer"], cfg, h, kv_len, cache["k"], cache["v"])
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        y, upd = attn.gqa_forward(bp["mixer"], cfg, h, positions, causal=bd.causal)
        if mode == "prefill":
            new_cache = {"k": upd.k, "v": upd.v}
    x = x + y
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + mlp(bp["ffn"], h), new_cache


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def apply_group(gp: dict, cfg: ModelConfig, g: Group, x, positions, mode: str,
                cache=None, kv_len=None):
    """Run a group's steps in order.  Returns (x, caches stacked over steps).

    Prefill stacks each step's fresh K/V; decode writes into ``cache`` in
    place (each step gets a view of its layer) and returns it.
    """
    per_step = []
    for s in range(g.steps):
        step_params = _index(gp, s)
        step_cache = None if cache is None else _index(cache, s)
        new_caches = {}
        for i, bd in enumerate(g.blocks):
            c_in = None if step_cache is None else step_cache[f"blk{i}"]
            x, new_caches[f"blk{i}"] = _apply_block(
                step_params[f"blk{i}"], cfg, bd, x, positions, mode, c_in, kv_len)
        per_step.append(new_caches)
    if mode == "decode":
        return x, cache
    if mode == "prefill":
        return x, {blk: {name: torch.stack([c[blk][name] for c in per_step])
                         for name in per_step[0][blk]}
                   for blk in per_step[0]}
    return x, None
