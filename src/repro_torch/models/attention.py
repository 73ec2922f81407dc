"""Attention: GQA (with bias / qk-norm variants) and MLA (DeepSeek-V2).

Port of ``repro.models.attention``.  The score paths are
plain PyTorch einsums in float32, as JAX writes them (not
``scaled_dot_product_attention``, whose reduction differs):

* ``full_attention``  — materialized scores, prompts up to
  ``FLASH_THRESHOLD`` tokens; the softmax weights are cast to ``v``'s dtype
  before the PV product, as in JAX;
* ``flash_attention`` — online softmax over (q-block x kv-block) loops;
* ``decode_attention`` — one query token against a contiguous cache.

The FLIC-paged decode path is ``repro_torch.serving.serve_step``; it reads
K/V through the ``paged_attention`` kernel.  Under a plan with the
``kv_expand`` flag, ``project_qkv`` repeats K/V heads r-fold where
``kv_heads`` does not divide the ``model`` axis (``_kv_expansion``, as in
JAX); with no plan active r is 1.  MLA
(``mla_defs``, ``mla_forward``, ``mla_decode``) keeps a compressed latent
cache ``(B, S, r+dr)``; its decode absorbs ``W_uk`` and ``W_uv`` into the
query and output.  An int8 contiguous cache holds each K/V row
quantized per (token, head) (``quantize_kv_row``) beside its float32
scale; ``gqa_decode`` writes both in place and attends over the
dequantized cache (``dequantize_kv``), as JAX's decode does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ref import inv_sqrt
from repro_torch.models.layers import apply_rope, f32, rmsnorm, rmsnorm_defs
from repro_torch.models.params import ParamDef
from repro_torch.shard import shard_act
from repro_torch.shard.partition import (current_rules, grad_placements, mesh_axes, on_ranks,
                                         placements_for, shard_index, sharded)

FLASH_THRESHOLD = 1024
Q_BLOCK = 512
KV_BLOCK = 1024
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA parameter defs
# ---------------------------------------------------------------------------

def gqa_defs(cfg: ModelConfig, dtype) -> dict:
    hd = cfg.resolved_head_dim
    d = {
        "w_q": ParamDef((cfg.d_model, cfg.num_heads, hd), ("embed_in", "heads", "head_dim"), dtype=dtype),
        "w_k": ParamDef((cfg.d_model, cfg.num_kv_heads, hd), ("embed_in", "kv_heads", "head_dim"), dtype=dtype),
        "w_v": ParamDef((cfg.d_model, cfg.num_kv_heads, hd), ("embed_in", "kv_heads", "head_dim"), dtype=dtype),
        "w_o": ParamDef((cfg.num_heads, hd, cfg.d_model), ("heads_in", "head_dim", "embed_out"), dtype=dtype),
    }
    if cfg.qkv_bias:
        d["b_q"] = ParamDef((cfg.num_heads, hd), ("heads", "head_dim"), init="zeros", dtype=dtype)
        d["b_k"] = ParamDef((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros", dtype=dtype)
        d["b_v"] = ParamDef((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros", dtype=dtype)
    if cfg.use_qk_norm:
        d["q_norm"] = rmsnorm_defs(hd, dtype)
        d["k_norm"] = rmsnorm_defs(hd, dtype)
    return d


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)``: per-head projections.  On a
    DTensor under a plan, under ``local_map``: each rank projects its batch
    rows onto its heads (``batch``, ``act_heads``, fitted to the head
    count), reading ``w``'s heads as the output lays them out.  DTensor's
    own product could split the flattened heads x head_dim dim so that a
    head count smaller than the mesh dim no longer unflattens."""
    if not sharded(x):
        return torch.einsum("bsd,dhk->bshk", x, w)
    from torch.distributed.tensor import Replicate, Shard

    mesh, plan = current_rules()
    (b, s, _), (_, h, k) = x.shape, w.shape
    op = placements_for(("batch", "seq", "act_heads", None), (b, s, h, k), mesh, plan)
    xp = placements_for(("batch", "seq", None), tuple(x.shape), mesh, plan)
    wp = tuple(Shard(1) if pl == Shard(2) else Replicate() for pl in op)
    return on_ranks(lambda xl, wl: torch.einsum("bsd,dhk->bshk", xl, wl),
                    out_placements=list(op), in_placements=(xp, wp),
                    in_grad_placements=(grad_placements(xp, op), grad_placements(wp, op)))(x, w)


def project_out(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, w)``: the output projection.  On a
    DTensor under a plan, under ``local_map``: each rank contracts its own
    heads (as ``out`` lies: ``batch``, ``act_heads``), and the result is
    the sum of the ranks' shares where the heads are split (``Partial``)."""
    if not sharded(out):
        return torch.einsum("bshk,hkd->bsd", out, w)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, plan = current_rules()
    op = placements_for(("batch", "seq", "act_heads", None), tuple(out.shape), mesh, plan)
    wp = tuple(Shard(0) if pl == Shard(2) else Replicate() for pl in op)
    yp = tuple(Partial() if pl == Shard(2) else pl for pl in op)
    return on_ranks(lambda ol, wl: torch.einsum("bshk,hkd->bsd", ol, wl),
                    out_placements=list(yp), in_placements=(op, wp),
                    in_grad_placements=(op, grad_placements(wp, op)))(out, w)


def _kv_expansion(cfg: ModelConfig) -> int:
    """KV-head replication factor for TP alignment (plan flag 'kv_expand').

    When kv_heads doesn't divide the TP axis but a small replication factor
    r makes (kv_heads*r) % tp == 0 (and still divides num_heads), replicate
    KV r-fold so q AND k/v shard over the same head partition.  Returns 1
    when inapplicable or with no rules active.
    """
    mesh, plan = current_rules()
    if mesh is None or plan is None or not plan.has("kv_expand"):
        return 1
    tp = mesh_axes(mesh).get("model", 1)
    hkv, hq = cfg.num_kv_heads, cfg.num_heads
    if hkv % tp == 0 or hq % tp != 0:
        return 1
    for r in (2, 4, 8, 16):
        if hq % (hkv * r) == 0 and (hkv * r) % tp == 0:
            return r
    return 1


def project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """q (B,S,Hq,D), k and v (B,S,r*Hkv,D) (r = ``_kv_expansion``), with
    RoPE on q and k."""
    q = project_heads(x, p["w_q"])
    k = project_heads(x, p["w_k"])
    v = project_heads(x, p["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    if cfg.use_qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    r = _kv_expansion(cfg)
    if r > 1:
        k = torch.repeat_interleave(k, r, dim=2)
        v = torch.repeat_interleave(v, r, dim=2)
    q = shard_act(q, "batch", "seq", "act_heads", None)
    k = shard_act(k, "batch", "seq", "act_heads", None)
    v = shard_act(v, "batch", "seq", "act_heads", None)
    return q, k, v


# ---------------------------------------------------------------------------
# Score paths
# ---------------------------------------------------------------------------

def _grouped(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B,S,Hq,D) -> (B,S,Hkv,G,D)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, hkv, hq // hkv, d)


def _causal_mask(sq: int, sk: int, q_offset: int, k_offset: int, device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device) + k_offset
    return qpos[:, None] >= kpos[None, :]


def full_attention(q, k, v, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Materialized-score attention. q:(B,Sq,Hq,D) k/v:(B,Skv,Hkv,D)."""
    hkv = k.shape[2]
    qg = _grouped(q, hkv)
    scale = inv_sqrt(q.shape[-1])
    scores = torch.einsum("bqhgd,bkhd->bhgqk", f32(qg), f32(k)) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, 0, q.device)
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    b, sq, hkv_, g, d = out.shape
    return out.reshape(b, sq, hkv_ * g, d)


def flash_attention(q, k, v, causal: bool) -> torch.Tensor:
    """Online-softmax attention over (q-block x kv-block) loops.

    Shapes as ``full_attention``; sequence lengths must divide the block
    sizes, as in JAX.  The output is in ``q``'s dtype.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    qb = min(Q_BLOCK, sq)
    kb = min(KV_BLOCK, skv)
    if sq % qb or skv % kb:
        raise ValueError(f"sequence lengths {sq}, {skv} must divide the blocks {qb}, {kb}")
    scale = inv_sqrt(d)
    qg = _grouped(q, hkv)
    outs = []
    for qi in range(sq // qb):
        q_blk = f32(qg[:, qi * qb:(qi + 1) * qb])                    # (b, qb, hkv, g, d)
        m = torch.full((b, hkv, g, qb), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, qb, hkv, g, dv), dtype=torch.float32, device=q.device)
        for kj in range(skv // kb):
            k_blk = f32(k[:, kj * kb:(kj + 1) * kb])
            v_blk = f32(v[:, kj * kb:(kj + 1) * kb])
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            if causal:
                mask = _causal_mask(qb, kb, qi * qb, kj * kb, q.device)
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bhgqk,bkhd->bqhgd", p, v_blk
            )
            m = m_new
        out = acc / torch.clamp(l, min=1e-37).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, hq, dv)


def decode_attention(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """One-token attention. q:(B,1,Hq,D), caches:(B,S,Hkv,D), kv_len:(B,)."""
    hkv = k_cache.shape[2]
    qg = _grouped(q, hkv)                       # (B,1,Hkv,G,D)
    scale = inv_sqrt(q.shape[-1])
    s = torch.einsum("bqhgd,bkhd->bhgqk", f32(qg), f32(k_cache)) * scale
    mask = torch.arange(k_cache.shape[1], device=q.device)[None] < kv_len[:, None]   # (B,S)
    s = torch.where(mask[:, None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, f32(v_cache)).to(q.dtype)
    b, one, h, g, d = out.shape
    return out.reshape(b, one, h * g, d)


# ---------------------------------------------------------------------------
# Under a plan: the score paths on each rank's heads
# ---------------------------------------------------------------------------

def attend(fn, q, k, v, *args, **kwargs):
    """``fn(q, k, v, *args, **kwargs)`` (a score path); on DTensors under a
    plan, under ``local_map`` on each rank's batch rows and query heads
    (the plan's ``batch`` and ``act_heads``; attention is independent per
    head).  Where K/V heads are not split as the query heads are, a rank
    takes the K/V heads of its own query heads' groups, and their gradient
    is the sum of the ranks' shares."""
    if not sharded(q):
        return fn(q, k, v, *args, **kwargs)

    mesh, plan = current_rules()
    axes = ("batch", None, "act_heads", None)
    qp, kp, vp = (placements_for(axes, tuple(t.shape), mesh, plan) for t in (q, k, v))
    hq, hkv = q.shape[2], k.shape[2]

    def local(ql, kl, vl):
        if kl.shape[2] == hkv and ql.shape[2] < hq:
            g, hl = hq // hkv, ql.shape[2]
            if g % hl and hl % g:
                raise ValueError(f"{hl} query heads a rank do not tile groups of {g}")
            start = shard_index(mesh, qp, 2) * hl // g
            kl, vl = (t[:, :, start:start + max(1, hl // g)] for t in (kl, vl))
        return fn(ql, kl, vl, *args, **kwargs)

    return on_ranks(local, out_placements=list(qp), in_placements=(qp, kp, vp),
                    in_grad_placements=(qp, grad_placements(kp, qp),
                                        grad_placements(vp, qp)))(q, k, v)


def write_rows(pos: torch.Tensor, *writes: tuple[torch.Tensor, torch.Tensor]) -> None:
    """``cache[b, pos[b]] = rows[b]`` for every batch row b of each
    (cache, rows) pair, IN PLACE.  On DTensor caches under a plan (batch as
    ``kv_batch``, positions as ``kv_seq``), each rank writes the rows whose
    position lies in its own range of positions, under ``local_map``."""
    if not sharded(writes[0][0]):
        bidx = torch.arange(writes[0][0].shape[0], device=pos.device)
        pos_l = pos.long()
        for cache, rows in writes:
            cache[bidx, pos_l] = rows.to(cache.dtype)
        return
    for cache, rows in writes:
        _write_rows_on_ranks(cache, pos, rows)


def _write_rows_on_ranks(cache, pos, rows) -> None:
    mesh, plan = current_rules()
    cp = placements_for(("kv_batch", "kv_seq") + (None,) * (cache.ndim - 2), tuple(cache.shape),
                        mesh, plan)
    bp = placements_for(("kv_batch",), (cache.shape[0],), mesh, plan)
    rp = placements_for(("kv_batch",) + (None,) * (rows.ndim - 1), tuple(rows.shape), mesh, plan)

    def local(cl, pl, rl):
        n = cl.shape[1]
        at = pl.long() - shard_index(mesh, cp, 1) * n
        mine = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        bidx = torch.arange(cl.shape[0], device=cl.device)
        keep = mine.view(-1, *([1] * (rl.ndim - 1)))
        cl[bidx, at] = torch.where(keep, rl.to(cl.dtype), cl[bidx, at])
        return cl

    on_ranks(local, out_placements=list(cp), in_placements=(cp, bp, rp))(cache, pos, rows)


# ---------------------------------------------------------------------------
# GQA block entry points
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVUpdate:
    """New K/V rows produced by a forward pass (for cache append)."""
    k: torch.Tensor
    v: torch.Tensor


def gqa_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                causal: bool = True) -> tuple[torch.Tensor, KVUpdate]:
    q, k, v = project_qkv(p, cfg, x, positions)
    out = attend(flash_attention if x.shape[1] > FLASH_THRESHOLD else full_attention, q, k, v,
                 causal)
    y = project_out(out, p["w_o"])
    return shard_act(y, "batch", "seq", "embed"), KVUpdate(k=k, v=v)


def quantize_kv_row(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 of K/V rows (..., Hkv, D): the rows
    as int8 (round half to even, clipped to [-127, 127]) and their float32
    scales (..., Hkv), each the row's largest |value| (at least 1e-8) over
    127."""
    absmax = torch.clamp(f32(x).abs().amax(dim=-1, keepdim=True), min=1e-8)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(f32(x) / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               k_scale: torch.Tensor | None = None, v_scale: torch.Tensor | None = None):
    """One decode step. x: (B,1,d); pos: (B,) write position (= current len).

    Writes the new K/V row at ``pos`` of the contiguous caches IN PLACE and
    attends over ``pos+1`` entries.  An int8 cache (``k_scale``/``v_scale``
    (B,S,Hkv) float32 given) takes the row quantized (``quantize_kv_row``)
    and its scales, also in place, and is dequantized to float32 for the
    scores.  Returns (y, k_cache, v_cache, k_scale, v_scale): the tensors
    passed in (scales ``None`` for a bfloat16 or float32 cache).
    """
    q, k, v = project_qkv(p, cfg, x, pos[:, None])
    if k_cache.dtype == torch.int8:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 K/V cache needs its k_scale and v_scale")
        kq, ks = quantize_kv_row(k[:, 0])
        vq, vs = quantize_kv_row(v[:, 0])
        write_rows(pos, (k_cache, kq), (v_cache, vq), (k_scale, ks), (v_scale, vs))
        k_full, v_full = dequantize_kv(k_cache, k_scale), dequantize_kv(v_cache, v_scale)
    else:
        write_rows(pos, (k_cache, k[:, 0]), (v_cache, v[:, 0]))
        k_full, v_full = k_cache, v_cache
    # under a plan the query heads are gathered: the scores then split as
    # the cache's positions do, and the softmax and the PV sum reduce them
    out = decode_attention(shard_act(q, "batch", "seq", None, None), k_full, v_full, pos + 1)
    y = project_out(out, p["w_o"])
    return shard_act(y, "batch", "seq", "embed"), k_cache, v_cache, k_scale, v_scale


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed-latent KV
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig, dtype) -> dict:
    h, dn, dr, dv = cfg.num_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    return {
        "w_q": ParamDef((cfg.d_model, h, dn + dr), ("embed_in", "heads", "head_dim"), dtype=dtype),
        "w_dkv": ParamDef((cfg.d_model, r), ("embed_in", "lora"), dtype=dtype),
        "kv_norm": rmsnorm_defs(r, dtype),
        "w_uk": ParamDef((r, h, dn), ("lora", "heads", "head_dim"), dtype=dtype),
        "w_uv": ParamDef((r, h, dv), ("lora", "heads", "head_dim"), dtype=dtype),
        "w_kr": ParamDef((cfg.d_model, dr), ("embed_in", "head_dim"), dtype=dtype),
        "w_o": ParamDef((h, dv, cfg.d_model), ("heads_in", "head_dim", "embed_out"), dtype=dtype),
    }


def _mla_latent(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """(c_kv (B,S,r), k_rope (B,S,dr)): the normalised latent and the
    shared rotary key of each position."""
    c_kv = rmsnorm(p["kv_norm"], x @ p["w_dkv"], cfg.norm_eps)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_query(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope (B,S,h,dn), q_rope (B,S,h,dr)), RoPE on the second."""
    dn = cfg.nope_head_dim
    q = project_heads(x, p["w_q"])
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def mla_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill MLA. Returns (y, latent_cache (B,S,r+dr))."""
    q_nope, q_rope = _mla_query(p, cfg, x, positions)
    c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    k_nope = project_heads(c_kv, p["w_uk"])
    v = project_heads(c_kv, p["w_uv"])
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], cfg.rope_head_dim)],
                  dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = attend(flash_attention if x.shape[1] > FLASH_THRESHOLD else full_attention, qf, k, v,
                 causal=True)
    y = project_out(out, p["w_o"])
    return shard_act(y, "batch", "seq", "embed"), torch.cat([c_kv, k_rope], dim=-1)


def mla_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor,
               latent_cache: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absorbed-weight MLA decode against the compressed latent cache.

    latent_cache: (B, S, r+dr), per position [c_kv | k_rope].  The fresh
    latent row is written at ``pos`` IN PLACE before attending, so the
    token attends to itself; scores and softmax in float32 with scale
    ``1/sqrt(dn+dr)`` over positions ``<= pos``.  Returns (y, the cache
    passed in).
    """
    r = cfg.kv_lora_rank
    c_new, kr_new = _mla_latent(p, cfg, x, pos[:, None])
    write_rows(pos, (latent_cache, torch.cat([c_new, kr_new], dim=-1)[:, 0]))

    q_nope, q_rope = _mla_query(p, cfg, x, pos[:, None])
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])      # absorb W_uk: (B,1,h,r)
    c_kv, k_rope = latent_cache[..., :r], latent_cache[..., r:]
    scale = inv_sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    s = (torch.einsum("bshr,bkr->bshk", f32(q_lat), f32(c_kv))
         + torch.einsum("bshd,bkd->bshk", f32(q_rope), f32(k_rope))) * scale   # (B,1,h,S)
    mask = torch.arange(latent_cache.shape[1], device=x.device)[None] <= pos[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bshk,bkr->bshr", w, f32(c_kv))           # (B,1,h,r)
    out = torch.einsum("bshr,rhk->bshk", o_lat, f32(p["w_uv"])).to(x.dtype)
    y = project_out(out, p["w_o"])
    return shard_act(y, "batch", "seq", "embed"), latent_cache
