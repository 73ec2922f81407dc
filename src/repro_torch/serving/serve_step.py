"""Paged decode step for dense GQA models.

Port of ``repro.serving.serve_step``.  Loops over the layer stack with K/V
read through the FLIC page pool: each layer writes the fresh K/V row into
the sequence's current page and attends through
``repro_torch.kernels.ops.paged_attention`` (the CUDA kernel on the card,
its plain version on CPU tensors).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import project_qkv
from repro_torch.models.layers import embed_tokens, f32, rmsnorm
from repro_torch.models.model import _lm_head_weight

KERNEL_BACKENDS = (None, "plain")


def paged_attention_fn(kernel_backend: Optional[str]):
    """``None``: ``ops.paged_attention`` (the kernel on CUDA tensors, the
    plain version on CPU tensors); ``"plain"``: the plain version on any
    device."""
    if kernel_backend is None:
        return ops.paged_attention
    if kernel_backend == "plain":
        return ref.paged_attention_ref
    raise ValueError(f"kernel_backend must be one of {KERNEL_BACKENDS}, got {kernel_backend!r}")


def paged_decode_step(
    params,
    cfg: ModelConfig,
    token: torch.Tensor,        # (B, 1) int32
    pos: torch.Tensor,          # (B,) int32 current lengths (write position)
    k_pool: torch.Tensor,       # (L, P, page, Hkv, D)
    v_pool: torch.Tensor,       # (L, P, page, Hkv, D)
    page_table: torch.Tensor,   # (B, max_pages) int32
    kernel_backend: Optional[str] = None,
):
    """One token for every slot.  Returns (logits (B,1,V) float32, k_pool,
    v_pool); the pools are the tensors passed in, written IN PLACE.

    Inactive slots point at dummy page 0, offset 0, so their K/V writes
    collide there and which one lands is unspecified, as in JAX; only the
    active slots' logits mean anything.
    """
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError("the paged path serves dense GQA stacks only")
    attend = paged_attention_fn(kernel_backend)
    page = k_pool.shape[2]
    hkv = cfg.num_kv_heads
    g = cfg.num_heads // hkv
    bsz = token.shape[0]
    bidx = torch.arange(bsz, device=token.device)

    x = embed_tokens(params["embed"], token)
    layers = params["dec"]["g0"]["blk0"]  # dense stacks: one group, one block

    pos_l = pos.long()
    cur_page = page_table[bidx, pos_l // page].long()   # (B,)
    offset = pos_l % page
    lengths = pos + 1
    for i in range(cfg.num_layers):
        mixer = {k: w[i] for k, w in layers["mixer"].items()}
        ffn = {k: w[i] for k, w in layers["ffn"].items()}
        kp, vp = k_pool[i], v_pool[i]
        h = rmsnorm({"scale": layers["ln1"]["scale"][i]}, x, cfg.norm_eps)
        q, k, v = project_qkv(mixer, cfg, h, pos[:, None])
        kp[cur_page, offset] = k[:, 0].to(kp.dtype)
        vp[cur_page, offset] = v[:, 0].to(vp.dtype)
        qg = q[:, 0].reshape(bsz, hkv, g, -1)
        out = attend(qg, kp, vp, page_table, lengths)
        out = out.reshape(bsz, 1, cfg.num_heads, -1).to(x.dtype)
        x = x + torch.einsum("bshk,hkd->bsd", out, mixer["w_o"])
        h = rmsnorm({"scale": layers["ln2"]["scale"][i]}, x, cfg.norm_eps)
        hh = F.silu(h @ ffn["w_gate"]) * (h @ ffn["w_up"])
        x = x + hh @ ffn["w_down"]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = f32(x @ _lm_head_weight(params, cfg))
    return logits, k_pool, v_pool
