"""Core layers: RMSNorm, gated RMSNorm, RoPE, SwiGLU MLP, embeddings.

Port of ``repro.models.layers``: plain functions over weight dicts, with
JAX's casts (float32 inside ``rmsnorm``, ``gated_rmsnorm`` and
``apply_rope``; back to the input dtype after, the gate's for
``gated_rmsnorm``).  JAX's activation-sharding hints have no counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.params import ParamDef


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_defs(dim: int, dtype) -> dict:
    return {"scale": ParamDef((dim,), ("null",), init="ones", dtype=dtype)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    var = f32(x).square().mean(dim=-1, keepdim=True)
    y = f32(x) * torch.rsqrt(var + eps)
    return (y * f32(p["scale"])).to(x.dtype)


def gated_rmsnorm(p: dict, x: torch.Tensor, gate: torch.Tensor, eps: float) -> torch.Tensor:
    """Mamba2's norm: RMSNorm(x * silu(gate)), in float32, returned in
    ``gate``'s dtype."""
    x = f32(x) * F.silu(f32(gate))
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * f32(p["scale"])).to(gate.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-rotation / llama convention)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` in float32 (``theta`` enters as a
    scalar: no device tensor is made from the host)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    ang = f32(positions)[..., :, None] * freqs              # (..., seq, d/2)
    cos = torch.cos(ang)[..., :, None, :]                   # (..., seq, 1, d/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = f32(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed_in", "ffn_out"), dtype=dtype),
        "w_up": ParamDef((d_model, d_ff), ("embed_in", "ffn_out"), dtype=dtype),
        "w_down": ParamDef((d_ff, d_model), ("ffn_in", "embed_out"), dtype=dtype),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig, dtype) -> dict:
    d = {
        "tok": ParamDef(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed_out"),
            init="embed", scale=1.0, dtype=dtype,
        )
    }
    if not cfg.tie_embeddings:
        d["head"] = ParamDef(
            (cfg.d_model, cfg.vocab_size), ("head_embed", "head_vocab"),
            init="normal", dtype=dtype,
        )
    return d


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]
