"""Transformer stacks: block descriptors and a loop over layers.

Port of ``repro.models.stack``.  ``BlockDef``, ``Group`` and
``plan_groups`` are copied whole; the rest supports the blocks the port can
run (``PORTED_BLOCKS``): an attention mixer (GQA ``"attn"`` or MLA
``"mla"``) with a dense MLP (``ffn="mlp"``, the width ``dense_ff`` where a
block sets it) or a mixture of experts (``ffn="moe"``), and a Mamba2 mixer
alone (``mixer="ssm"``, ``ffn="none"``).  It raises
``NotImplementedError`` for any other block (the hybrid's SSM + MLP and the
cross-attention decoder).  JAX's ``lax.scan`` over layers is a Python loop
over the leading ``layers`` axis of each parameter; its ``jax.checkpoint``
of the scan body (``remat``) is ``torch.utils.checkpoint`` of each step.
Every block returns the MoE load-balance loss (0 but for MoE blocks),
which a group sums over its layers in order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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


PORTED_BLOCKS = (("attn", "mlp"), ("attn", "moe"), ("mla", "mlp"), ("mla", "moe"),
                 ("ssm", "none"))


def _supported(bd: BlockDef) -> None:
    if (bd.mixer, bd.ffn) not in PORTED_BLOCKS or bd.cross:
        raise NotImplementedError(
            f"block {bd} is not ported yet: the port runs attention or MLA with a "
            "dense MLP or MoE, and Mamba2 blocks (ROADMAP.md, Queue 1)"
        )


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, bd: BlockDef, dtype) -> dict:
    _supported(bd)
    mixer = {"attn": attn.gqa_defs, "mla": attn.mla_defs, "ssm": ssm_mod.ssm_defs}[bd.mixer]
    d: dict[str, Any] = {"ln1": rmsnorm_defs(cfg.d_model, dtype), "mixer": mixer(cfg, dtype)}
    if bd.ffn == "mlp":
        d["ln2"] = rmsnorm_defs(cfg.d_model, dtype)
        d["ffn"] = mlp_defs(cfg.d_model, bd.dense_ff or cfg.d_ff, dtype)
    elif bd.ffn == "moe":
        d["ln2"] = rmsnorm_defs(cfg.d_model, dtype)
        d["ffn"] = moe_mod.moe_defs(cfg, dtype)
    return d


def group_param_defs(cfg: ModelConfig, g: Group, dtype) -> dict:
    per_step = {f"blk{i}": _block_defs(cfg, bd, dtype) for i, bd in enumerate(g.blocks)}
    return stack_defs(per_step, g.steps)


# ---------------------------------------------------------------------------
# Cache specs (contiguous decode caches)
# ---------------------------------------------------------------------------

def _block_cache_spec(cfg: ModelConfig, bd: BlockDef, steps: int, batch: int,
                      seq: int) -> dict:
    _supported(bd)
    if bd.mixer == "ssm":
        conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        return {
            "conv": CacheSpec((steps, batch, cfg.ssm_conv - 1, conv_dim), torch.bfloat16),
            "ssd": CacheSpec((steps, batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                             torch.float32),
        }
    if bd.mixer == "mla":
        return {"latent": CacheSpec((steps, batch, seq, cfg.kv_lora_rank + cfg.rope_head_dim),
                                    torch.bfloat16)}
    shape = (steps, batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": CacheSpec(shape, torch.bfloat16), "v": CacheSpec(shape, torch.bfloat16)}


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> list[dict]:
    """Per decoder group, ``{"blk<i>": {name: CacheSpec}}`` stacked over
    steps: attention ``k``/``v`` bfloat16 ``(steps, batch, seq, Hkv, D)``;
    MLA ``latent`` bfloat16 ``(steps, batch, seq, r+dr)``;
    Mamba2 ``conv`` bfloat16 ``(steps, batch, K-1, conv_dim)`` (the last
    K-1 pre-activation conv inputs) and ``ssd`` float32 ``(steps, batch, H,
    P, N)``."""
    _, dec = plan_groups(cfg)
    return [{f"blk{i}": _block_cache_spec(cfg, bd, g.steps, batch, seq)
             for i, bd in enumerate(g.blocks)} for g in dec]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_block(bp: dict, cfg: ModelConfig, bd: BlockDef, x, positions, mode: str,
                 cache: Optional[dict], kv_len, ssd_scan: ssm_mod.ScanFn = ops.ssd_scan):
    """One sublayer. Returns (x, new_cache, aux): ``aux`` is the MoE
    load-balance loss, 0.0 for a block without experts."""
    _supported(bd)
    aux = 0.0
    new_cache: dict[str, Any] = {}
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if bd.mixer == "ssm":
        if mode == "decode":
            y, st = ssm_mod.ssm_decode(
                bp["mixer"], cfg, h, ssm_mod.SSMState(conv=cache["conv"], ssd=cache["ssd"]))
            new_cache = {"conv": st.conv, "ssd": st.ssd}
        else:
            y, st = ssm_mod.ssm_forward(bp["mixer"], cfg, h, ssd_scan=ssd_scan)
            if mode == "prefill":
                new_cache = {"conv": st.conv.to(torch.bfloat16), "ssd": st.ssd}
    elif bd.mixer == "mla":
        if mode == "decode":
            y, lat_cache = attn.mla_decode(bp["mixer"], cfg, h, kv_len, cache["latent"])
            new_cache = {"latent": lat_cache}
        else:
            y, latent = attn.mla_forward(bp["mixer"], cfg, h, positions)
            if mode == "prefill":
                new_cache = {"latent": latent}
    elif mode == "decode":
        y, k_cache, v_cache = attn.gqa_decode(
            bp["mixer"], cfg, h, kv_len, cache["k"], cache["v"])
        new_cache = {"k": k_cache, "v": v_cache}
    else:
        y, upd = attn.gqa_forward(bp["mixer"], cfg, h, positions, causal=bd.causal)
        if mode == "prefill":
            new_cache = {"k": upd.k, "v": upd.v}
    x = x + y
    if bd.ffn == "mlp":
        x = x + mlp(bp["ffn"], rmsnorm(bp["ln2"], x, cfg.norm_eps))
    elif bd.ffn == "moe":
        y, aux = moe_mod.moe_forward(bp["ffn"], cfg, rmsnorm(bp["ln2"], x, cfg.norm_eps))
        x = x + y
    return x, new_cache, aux


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


REMAT_POLICIES = ("dots", "nothing")


def _save_dots(ctx, func, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the products without
    batch dimensions (``mm``, and ``bmm`` over a batch of one, which is how
    an unbatched ``einsum`` runs), recompute the rest."""
    if func is torch.ops.aten.mm.default or (
            func is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _train_step(step_params: dict, x, aux, positions, cfg: ModelConfig, g: Group,
                ssd_scan: ssm_mod.ScanFn):
    """One step of a group in train mode (the body that ``remat``
    recomputes): (x, aux plus each block's aux, in order)."""
    for i, bd in enumerate(g.blocks):
        x, _, a = _apply_block(step_params[f"blk{i}"], cfg, bd, x, positions, "train", None,
                               None, ssd_scan)
        if bd.ffn == "moe":
            aux = aux + a
    return x, aux


def _remat_step(step_params: dict, x, aux, positions, cfg: ModelConfig, g: Group,
                ssd_scan: ssm_mod.ScanFn, policy: str):
    """``_train_step`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward pass, but for the products that ``"dots"``
    saves (``"nothing"`` saves none).  The numbers do not depend on the
    policy."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}: use one of {REMAT_POLICIES}")
    context = (functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
               if policy == "dots" else ckpt.noop_context_fn)
    return ckpt.checkpoint(_train_step, step_params, x, aux, positions, cfg, g, ssd_scan,
                           use_reentrant=False, context_fn=context)


def apply_group(gp: dict, cfg: ModelConfig, g: Group, x, positions, mode: str,
                cache=None, kv_len=None, ssd_scan: ssm_mod.ScanFn = ops.ssd_scan,
                remat: bool = False, remat_policy: str = "dots"):
    """Run a group's steps in order.  Returns (x, caches stacked over steps,
    aux): ``aux`` float32, the blocks' MoE losses summed in layer order
    from 0, as JAX's scan carries it.

    Prefill stacks each step's fresh caches.  Decode of attention and MLA
    blocks writes K/V or the latent row into ``cache`` in place (each step
    gets a view of its layer) and returns it; decode of Mamba2 blocks
    stacks each step's new states (new tensors: a float32 model's bfloat16
    conv window turns float32, as in JAX).  Train mode returns no caches;
    with ``remat`` each step is recomputed in the backward pass
    (``_remat_step``).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        for s in range(g.steps):
            step_params = _index(gp, s)
            x, aux = (_remat_step(step_params, x, aux, positions, cfg, g, ssd_scan, remat_policy)
                      if remat else
                      _train_step(step_params, x, aux, positions, cfg, g, ssd_scan))
        return x, None, aux
    per_step = []
    for s in range(g.steps):
        step_params = _index(gp, s)
        step_cache = None if cache is None else _index(cache, s)
        new_caches = {}
        for i, bd in enumerate(g.blocks):
            c_in = None if step_cache is None else step_cache[f"blk{i}"]
            x, new_caches[f"blk{i}"], a = _apply_block(
                step_params[f"blk{i}"], cfg, bd, x, positions, mode, c_in, kv_len,
                ssd_scan)
            if bd.ffn == "moe":
                aux = aux + a
        per_step.append(new_caches)
    if mode == "decode" and all(bd.mixer in ("attn", "mla") for bd in g.blocks):
        return x, cache, aux
    return x, {blk: {name: torch.stack([c[blk][name] for c in per_step])
                     for name in per_step[0][blk]}
               for blk in per_step[0]}, aux
