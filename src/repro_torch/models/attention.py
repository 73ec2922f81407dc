"""Attention for GQA stacks: full, flash (online softmax) and decode.

Port of the GQA half of ``repro.models.attention``.  The score paths are
plain PyTorch einsums in float32, as JAX writes them (not
``scaled_dot_product_attention``, whose reduction differs):

* ``full_attention``  — materialized scores, prompts up to
  ``FLASH_THRESHOLD`` tokens; the softmax weights are cast to ``v``'s dtype
  before the PV product, as in JAX;
* ``flash_attention`` — online softmax over (q-block x kv-block) loops;
* ``decode_attention`` — one query token against a contiguous cache.

The FLIC-paged decode path is ``repro_torch.serving.serve_step``; it reads
K/V through the ``paged_attention`` kernel.  Without a mesh the JAX
package's KV-head expansion is 1, so the port has none.  MLA and the int8
KV cache are later work (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.ref import inv_sqrt
from repro_torch.models.layers import apply_rope, f32, rmsnorm, rmsnorm_defs
from repro_torch.models.params import ParamDef

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


def project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """q (B,S,Hq,D), k and v (B,S,Hkv,D), with RoPE on q and k."""
    q = torch.einsum("bsd,dhk->bshk", x, p["w_q"])
    k = torch.einsum("bsd,dhk->bshk", x, p["w_k"])
    v = torch.einsum("bsd,dhk->bshk", x, p["w_v"])
    if cfg.qkv_bias:
        q, k, v = q + p["b_q"], k + p["b_k"], v + p["b_v"]
    if cfg.use_qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
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
    if x.shape[1] > FLASH_THRESHOLD:
        out = flash_attention(q, k, v, causal)
    else:
        out = full_attention(q, k, v, causal)
    y = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    return y, KVUpdate(k=k, v=v)


def gqa_decode(p: dict, cfg: ModelConfig, x: torch.Tensor, pos: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor):
    """One decode step. x: (B,1,d); pos: (B,) write position (= current len).

    Writes the new K/V row at ``pos`` of the contiguous caches IN PLACE and
    attends over ``pos+1`` entries.  Returns (y, k_cache, v_cache); the
    caches are the tensors passed in.  JAX's int8 caches (with their
    scales) are not ported.
    """
    if k_cache.dtype == torch.int8:
        raise NotImplementedError(
            "the int8 KV cache is not ported yet (ROADMAP.md, Queue 1: int8 KV path)"
        )
    q, k, v = project_qkv(p, cfg, x, pos[:, None])
    bidx = torch.arange(x.shape[0], device=x.device)
    pos_l = pos.long()
    k_cache[bidx, pos_l] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, pos_l] = v[:, 0].to(v_cache.dtype)
    out = decode_attention(q, k_cache, v_cache, pos + 1)
    y = torch.einsum("bshk,hkd->bsd", out, p["w_o"])
    return y, k_cache, v_cache
