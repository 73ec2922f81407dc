"""Transformer stacks: block descriptors and a loop over layers.

Port of ``repro.models.stack``.  ``BlockDef``, ``Group`` and
``plan_groups`` are copied whole; the rest supports every block kind of
the ten configurations: an attention mixer (GQA
``"attn"``, causal or not, or MLA ``"mla"``) or a Mamba2 mixer
(``"ssm"``), each with a dense MLP (``ffn="mlp"``, the width ``dense_ff``
where a block sets it) or a mixture of experts (``ffn="moe"``), and a
Mamba2 mixer alone (``ffn="none"``); a GQA block may add cross-attention
over an encoder's output (``cross``, the encoder-decoder's decoder).  A
hybrid group (Jamba's period) mixes them block by block, so its caches hold
K/V for its attention blocks and SSM states for the others.  JAX's
``lax.scan`` over layers is a Python loop
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
from repro_torch.models.layers import apply_rope, einsum, mlp, mlp_defs, rmsnorm, rmsnorm_defs
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


# ---------------------------------------------------------------------------
# Param defs
# ---------------------------------------------------------------------------

def _block_defs(cfg: ModelConfig, bd: BlockDef, dtype) -> dict:
    mixers = {"attn": attn.gqa_defs, "mla": attn.mla_defs, "ssm": ssm_mod.ssm_defs}
    if bd.mixer not in mixers:
        raise ValueError(bd.mixer)
    d: dict[str, Any] = {"ln1": rmsnorm_defs(cfg.d_model, dtype),
                         "mixer": mixers[bd.mixer](cfg, dtype)}
    if bd.cross:
        d["ln_cross"] = rmsnorm_defs(cfg.d_model, dtype)
        d["cross"] = attn.gqa_defs(cfg, dtype)
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
                      seq: int, enc_seq: int = 0, kv_int8: bool = False) -> dict:
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
    kv_dt = torch.int8 if kv_int8 else torch.bfloat16
    out = {"k": CacheSpec(shape, kv_dt), "v": CacheSpec(shape, kv_dt)}
    if kv_int8:
        out["k_scale"] = CacheSpec(shape[:-1], torch.float32)
        out["v_scale"] = CacheSpec(shape[:-1], torch.float32)
    if bd.cross:
        cross = (steps, batch, enc_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        out["cross_k"] = CacheSpec(cross, torch.bfloat16)
        out["cross_v"] = CacheSpec(cross, torch.bfloat16)
    return out


def cache_specs(cfg: ModelConfig, batch: int, seq: int, enc_seq: int = 0,
                kv_int8: bool = False) -> list[dict]:
    """Per decoder group, ``{"blk<i>": {name: CacheSpec}}`` stacked over
    steps: attention ``k``/``v`` bfloat16 ``(steps, batch, seq, Hkv, D)``,
    or with ``kv_int8`` int8 beside float32 ``k_scale``/``v_scale``
    ``(steps, batch, seq, Hkv)``; a cross-attention block's ``cross_k``/
    ``cross_v`` bfloat16 ``(steps, batch, enc_seq, Hkv, D)``;
    MLA ``latent`` bfloat16 ``(steps, batch, seq, r+dr)``;
    Mamba2 ``conv`` bfloat16 ``(steps, batch, K-1, conv_dim)`` (the last
    K-1 pre-activation conv inputs) and ``ssd`` float32 ``(steps, batch, H,
    P, N)``."""
    _, dec = plan_groups(cfg)
    return [{f"blk{i}": _block_cache_spec(cfg, bd, g.steps, batch, seq, enc_seq, kv_int8)
             for i, bd in enumerate(g.blocks)} for g in dec]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _cross_attention(bp: dict, cfg: ModelConfig, x, positions, mode: str,
                     cache: Optional[dict], kv_len, enc_out, new_cache: dict):
    """The decoder block's cross-attention step, added to ``x``: queries of
    ``x`` (RoPE at the decode position, or the prompt positions) against
    K/V of the encoder's output (RoPE on K over the encoder positions),
    non-causal.  Prefill computes the K/V and puts them in ``new_cache``
    (``cross_k``/``cross_v``); decode reads them from ``cache`` and carries
    them through unchanged."""
    p = bp["cross"]
    hc = rmsnorm(bp["ln_cross"], x, cfg.norm_eps)
    if mode == "decode":
        ck, cv = cache["cross_k"], cache["cross_v"]
    else:
        enc_pos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=x.device)[None]
        ck = einsum("bsd,dhk->bshk", enc_out, p["w_k"])
        cv = einsum("bsd,dhk->bshk", enc_out, p["w_v"])
        if cfg.qkv_bias:
            ck, cv = ck + p["b_k"], cv + p["b_v"]
        ck = apply_rope(ck, enc_pos, cfg.rope_theta)
    if mode != "train":
        new_cache["cross_k"], new_cache["cross_v"] = ck, cv
    q = einsum("bsd,dhk->bshk", hc, p["w_q"])
    if cfg.qkv_bias:
        q = q + p["b_q"]
    q = apply_rope(q, kv_len[:, None] if mode == "decode" else positions, cfg.rope_theta)
    yc = attn.full_attention(q, ck, cv, causal=False)
    return x + einsum("bshk,hkd->bsd", yc, p["w_o"])


def _apply_block(bp: dict, cfg: ModelConfig, bd: BlockDef, x, positions, mode: str,
                 cache: Optional[dict], kv_len, ssd_scan: ssm_mod.ScanFn = ops.ssd_scan,
                 enc_out=None):
    """One sublayer. Returns (x, new_cache, aux): ``aux`` is the MoE
    load-balance loss, 0.0 for a block without experts.  ``enc_out``: the
    encoder's output, which a cross-attention block reads outside decode."""
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
        y, k_cache, v_cache, k_s, v_s = attn.gqa_decode(
            bp["mixer"], cfg, h, kv_len, cache["k"], cache["v"], cache.get("k_scale"),
            cache.get("v_scale"))
        new_cache = {"k": k_cache, "v": v_cache}
        if k_s is not None:
            new_cache["k_scale"], new_cache["v_scale"] = k_s, v_s
    else:
        y, upd = attn.gqa_forward(bp["mixer"], cfg, h, positions, causal=bd.causal)
        if mode == "prefill":
            new_cache = {"k": upd.k, "v": upd.v}
    x = x + y
    if bd.cross:
        x = _cross_attention(bp, cfg, x, positions, mode, cache, kv_len, enc_out, new_cache)
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
                ssd_scan: ssm_mod.ScanFn, enc_out=None):
    """One step of a group in train mode (the body that ``remat``
    recomputes): (x, aux plus each block's aux, in order)."""
    for i, bd in enumerate(g.blocks):
        x, _, a = _apply_block(step_params[f"blk{i}"], cfg, bd, x, positions, "train", None,
                               None, ssd_scan, enc_out)
        if bd.ffn == "moe":
            aux = aux + a
    return x, aux


def _remat_step(step_params: dict, x, aux, positions, cfg: ModelConfig, g: Group,
                ssd_scan: ssm_mod.ScanFn, policy: str, enc_out=None):
    """``_train_step`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward pass, but for the products that ``"dots"``
    saves (``"nothing"`` saves none).  The numbers do not depend on the
    policy."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}: use one of {REMAT_POLICIES}")
    context = (functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
               if policy == "dots" else ckpt.noop_context_fn)
    return ckpt.checkpoint(_train_step, step_params, x, aux, positions, cfg, g, ssd_scan,
                           enc_out, use_reentrant=False, context_fn=context)


def apply_group(gp: dict, cfg: ModelConfig, g: Group, x, positions, mode: str,
                cache=None, kv_len=None, ssd_scan: ssm_mod.ScanFn = ops.ssd_scan,
                remat: bool = False, remat_policy: str = "dots", enc_out=None):
    """Run a group's steps in order.  Returns (x, caches stacked over steps,
    aux): ``aux`` float32, the blocks' MoE losses summed in layer order
    from 0, as JAX's scan carries it.

    Prefill stacks each step's fresh caches.  Decode, block by block: an
    attention or MLA block writes K/V or the latent row into its ``cache``
    tensors in place (each step gets a view of its layer) and returns those
    tensors; a Mamba2 block's new states are stacked over the steps (new
    tensors: a float32 model's bfloat16 conv window turns float32, as in
    JAX).  So a hybrid group returns its K/V caches as passed in and fresh
    SSM states beside them; an int8 cache's scales and a cross-attention
    block's ``cross_k``/``cross_v`` come back as passed in too.  ``enc_out``
    is the encoder's output for the cross-attention blocks of prefill and
    train mode.  Train mode returns no caches;
    with ``remat`` each step is recomputed in the backward pass
    (``_remat_step``).
    """
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        for s in range(g.steps):
            step_params = _index(gp, s)
            x, aux = (_remat_step(step_params, x, aux, positions, cfg, g, ssd_scan, remat_policy,
                                  enc_out)
                      if remat else
                      _train_step(step_params, x, aux, positions, cfg, g, ssd_scan, enc_out))
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
                ssd_scan, enc_out)
            if bd.ffn == "moe":
                aux = aux + a
        per_step.append(new_caches)
    out = {}
    for i, bd in enumerate(g.blocks):
        blk = f"blk{i}"
        out[blk] = (cache[blk] if mode == "decode" and bd.mixer in ("attn", "mla") else
                    {name: torch.stack([c[blk][name] for c in per_step])
                     for name in per_step[0][blk]})
    return x, out, aux
