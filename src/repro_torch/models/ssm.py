"""Mamba2 (SSD, state-space duality) blocks: chunked prefill scan and
decode step.

Port of ``repro.models.ssm`` (Dao & Gu 2024, arXiv:2405.21060).  The
inter-chunk recurrence, JAX's ``lax.scan``, goes through the scan function
passed as ``ssd_scan``: by default ``repro_torch.kernels.ops.ssd_scan`` (the
hand-written CUDA kernel on the card, its plain version on CPU tensors);
``repro_torch.kernels.ref.ssd_scan_ref`` is the plain version on any
device.  JAX's ``einsum``s of three
and four operands are written as products of two, so no (B, C, H, Q, K, P)
intermediate is formed.  ``ssm_decode`` has no kernel, in JAX or here.

Shapes: B batch, S seq, H heads, P headdim, N state, G groups (=1 here),
Q chunk length.  d_inner = H*P = expand*d_model.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import f32, gated_rmsnorm, rmsnorm_defs
from repro_torch.models.params import ParamDef
from repro_torch.shard import shard_act
from repro_torch.shard.partition import (current_rules, grad_placements, on_ranks,
                                         placements_for, sharded)

# (states (B,C,H,P,N), chunk_decay (B,C,H), init (B,H,P,N) or None)
#   -> (prev (B,C,H,P,N), final (B,H,P,N)), all float32
ScanFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
                  tuple[torch.Tensor, torch.Tensor]]


def ssm_defs(cfg: ModelConfig, dtype) -> dict:
    di = cfg.ssm_d_inner
    h = cfg.ssm_nheads
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    conv_dim = di + 2 * g * n
    return {
        # fused in_proj -> [z (di) | xBC (conv_dim) | dt (h)]
        "w_in": ParamDef((cfg.d_model, 2 * di + 2 * g * n + h), ("embed_in", "ssm_out"), dtype=dtype),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), ("conv", "ssm_out"), dtype=dtype, scale=0.5),
        "conv_b": ParamDef((conv_dim,), ("ssm_out",), init="zeros", dtype=dtype),
        "a_log": ParamDef((h,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "d_skip": ParamDef((h,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "norm": rmsnorm_defs(di, dtype),
        "w_out": ParamDef((di, cfg.d_model), ("ssm_in", "embed_out"), dtype=dtype),
    }


@dataclasses.dataclass(frozen=True)
class SSMState:
    """Decode-time recurrent state of one layer."""
    conv: torch.Tensor  # (B, conv_width-1, conv_dim)
    ssd: torch.Tensor   # (B, H, P, N) float32


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di = cfg.ssm_d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    z = proj[..., :di]
    x_bc = proj[..., di : di + di + 2 * gn]
    dt = proj[..., di + di + 2 * gn :]
    return z, x_bc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|))."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N) in float32: each group's values broadcast
    to its H/G heads."""
    *lead, g, n = t.shape
    return f32(t)[..., None, :].expand(*lead, g, h // g, n).reshape(*lead, h, n)


def _causal_conv(p: dict, x_bc: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. x_bc: (B,S,C)."""
    w = f32(p["conv_w"])                        # (K, C)
    k = w.shape[0]
    pad = F.pad(f32(x_bc), (0, 0, k - 1, 0))
    out = sum(
        pad[:, i : pad.shape[1] - (k - 1 - i), :] * w[i]
        for i in range(k)
    )
    return F.silu(out + f32(p["conv_b"])).to(x_bc.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[i,j] = sum_{j<k<=i} a_k."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,    # (B,S,H,P) pre-scaled inputs
    dt: torch.Tensor,   # (B,S,H) softplus'd step sizes
    a: torch.Tensor,    # (H,) negative decay rates (A = -exp(a_log))
    b: torch.Tensor,    # (B,S,G,N)
    c: torch.Tensor,    # (B,S,G,N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B,H,P,N)
    ssd_scan: ScanFn = ops.ssd_scan,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bsz, s_orig, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, s_orig)
    pad = (-s_orig) % q
    if pad:  # zero-pad to a chunk multiple: dt=0 rows are exact no-ops
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    s = s_orig + pad
    nc = s // q

    # reshape to chunks; broadcast groups to heads (G=1 typical)
    xr = f32(x).reshape(bsz, nc, q, h, p)
    dtr = f32(dt).reshape(bsz, nc, q, h)
    br = _heads(b.reshape(bsz, nc, q, g, n), h)       # (B,nc,q,H,N)
    cr = _heads(c.reshape(bsz, nc, q, g, n), h)
    br_h = br.permute(0, 1, 3, 2, 4)                  # (B,nc,H,q,N)
    cr_h = cr.permute(0, 1, 3, 2, 4)

    da = dtr * f32(a)                                 # (B,nc,q,H) decay increments
    cum = torch.cumsum(da, dim=2)                     # within-chunk cumsum
    # intra-chunk (diagonal) term: sum_k C_q.B_k L_qk dt_k x_k
    L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))    # (B,nc,H,q,k)
    scores = cr_h @ br_h.transpose(-1, -2)            # (B,nc,H,q,k)
    xdt = (xr * dtr[..., None]).permute(0, 1, 3, 2, 4)        # (B,nc,H,k,P)
    y_diag = ((scores * L) @ xdt).permute(0, 1, 3, 2, 4)      # (B,nc,q,H,P)

    # chunk-final states: sum_q B_q decay_to_end_q dt_q x_q
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,q,H)
    xw = (xr * (decay_to_end * dtr)[..., None]).permute(0, 1, 3, 4, 2)   # (B,nc,H,P,q)
    states = xw @ br_h                                         # (B,nc,H,P,N)

    # inter-chunk recurrence: S_c = exp(sum da_c) S_{c-1} + states_c
    chunk_decay = torch.exp(da.sum(dim=2))                     # (B,nc,H)
    init = None if init_state is None else f32(init_state).contiguous()
    prev_states, final = ssd_scan(states.contiguous(), chunk_decay.contiguous(), init)

    # inter-chunk (off-diagonal) contribution: C_q in_decay_q S_prev
    in_decay = torch.exp(cum)                                  # decay from chunk start
    cw = (cr * in_decay[..., None]).permute(0, 1, 3, 2, 4)     # (B,nc,H,q,N)
    y_off = (cw @ prev_states.transpose(-1, -2)).permute(0, 1, 3, 2, 4)   # (B,nc,q,H,P)

    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y[:, :s_orig], final


def _chunked_on_ranks(xh, dt, a, b, c, chunk, init, ssd_scan):
    """``ssd_chunked`` on DTensors under the active plan: under
    ``local_map`` on each rank's batch rows (``batch``) and heads
    (``act_ssm``); the scan is independent per head, so this is exact.  B
    and C (read by every head) and the decay rates (read by every batch
    row) take the sum of the ranks' gradient shares."""

    mesh, plan = current_rules()
    bsz, _, h, p = xh.shape

    def pl(axes, shape):
        return placements_for(axes, tuple(shape), mesh, plan)

    xp = pl(("batch", None, "act_ssm", None), xh.shape)
    sp = pl(("batch", "act_ssm", None, None), (bsz, h, p, b.shape[3]))
    bp = pl(("batch", None, None, None), b.shape)

    def local(xl, dtl, al, bl, cl, il):
        return ssd_chunked(xl, dtl, al, bl, cl, chunk, il, ssd_scan)

    dp, ap = pl(("batch", None, "act_ssm"), dt.shape), pl(("act_ssm",), a.shape)
    ip = sp if init is not None else None
    bg = grad_placements(bp, xp)
    return on_ranks(local, out_placements=(xp, sp), in_placements=(xp, dp, ap, bp, bp, ip),
                    in_grad_placements=(xp, dp, grad_placements(ap, xp), bg, bg, ip))(
        xh, dt, a, b, c, init)


def _ssm_inputs(p: dict, cfg: ModelConfig, proj: torch.Tensor):
    """The mixer from the in-projection ``proj`` = x @ w_in up to the chunk
    scan: (z, xh (B,S,H,P), dt (B,S,H) softplus'd, b, c (B,S,G,N),
    conv_state (B,K-1,conv_dim))."""
    z, raw_xbc, dt = _split_proj(cfg, proj)
    x_bc = _causal_conv(p, raw_xbc)

    bsz, s = proj.shape[:2]
    di = cfg.ssm_d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    xs = x_bc[..., :di]
    b = x_bc[..., di : di + gn].reshape(bsz, s, cfg.ssm_ngroups, cfg.ssm_state)
    c = x_bc[..., di + gn :].reshape(bsz, s, cfg.ssm_ngroups, cfg.ssm_state)
    xh = xs.reshape(bsz, s, cfg.ssm_nheads, cfg.ssm_headdim)
    dt = _softplus(f32(dt) + f32(p["dt_bias"]))
    # decode conv state = last (K-1) *pre-activation* xBC inputs
    conv_state = raw_xbc[:, -(cfg.ssm_conv - 1):, :]
    return z, xh, dt, b, c, conv_state


def _ssm_output(p: dict, cfg: ModelConfig, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The mixer after the chunk scan up to the out-projection: the skip and
    the gated norm of y (B,S,H,P)."""
    bsz, s = y.shape[:2]
    y = y + f32(p["d_skip"])[None, None, :, None] * f32(xh)
    y = y.reshape(bsz, s, cfg.ssm_d_inner).to(dtype)
    return gated_rmsnorm(p["norm"], y, z, cfg.norm_eps)


def ssm_forward(
    p: dict, cfg: ModelConfig, x: torch.Tensor,
    init_state: Optional[SSMState] = None, ssd_scan: ScanFn = ops.ssd_scan,
) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence Mamba2 block. x: (B,S,d_model).  On DTensors under a
    plan: ``_ssm_forward_on_ranks``."""
    init = None if init_state is None else init_state.ssd
    if sharded(x):
        out, conv_state, final = _ssm_forward_on_ranks(p, cfg, x, init, ssd_scan)
    else:
        z, xh, dt, b, c, conv_state = _ssm_inputs(p, cfg, x @ p["w_in"])
        a = -torch.exp(f32(p["a_log"]))
        y, final = ssd_chunked(xh, dt, a, b, c, cfg.ssm_chunk, init, ssd_scan)
        out = _ssm_output(p, cfg, y, xh, z, x.dtype) @ p["w_out"]
    return shard_act(out, "batch", "seq", "embed"), SSMState(conv=conv_state, ssd=f32(final))


def _ssm_forward_on_ranks(p: dict, cfg: ModelConfig, x, init, ssd_scan):
    """``ssm_forward``'s mixer on a DTensor ``x`` under the active plan: the
    in- and out-projections as DTensor products (split as ``ssm_out`` and
    ``ssm_in`` say), and between them three ``local_map`` regions: the
    conv and splits on each rank's batch rows (the projection gathered
    whole), the chunk scan on its rows and heads (``_chunked_on_ranks``,
    heads as ``act_ssm`` says), and the skip and the gated norm (over all
    heads) on its rows.  Returns (out, conv_state, final)."""
    from torch.distributed.tensor import Replicate

    mesh, plan = current_rules()
    whole = (Replicate(),) * mesh.ndim

    def rows(ndim: int):   # the batch rows split as the plan says, the rest whole
        return placements_for(("batch",) + (None,) * (ndim - 1), (x.shape[0],) + (1,) * (ndim - 1),
                              mesh, plan)

    xp = rows(3)
    wgrad = grad_placements(whole, xp)   # each rank's rows' share of a weight's gradient

    def inputs_local(projl, conv_w, conv_b, dt_bias):
        return _ssm_inputs({"conv_w": conv_w, "conv_b": conv_b, "dt_bias": dt_bias}, cfg, projl)

    z, xh, dt, b, c, conv_state = on_ranks(
        inputs_local, out_placements=(xp, rows(4), rows(3), rows(4), rows(4), xp),
        in_placements=(xp,) + (whole,) * 3, in_grad_placements=(xp,) + (wgrad,) * 3)(
        x @ p["w_in"], p["conv_w"], p["conv_b"], p["dt_bias"])
    xh = shard_act(xh, "batch", "seq", "act_ssm", None)
    a = -torch.exp(f32(p["a_log"]))
    y, final = _chunked_on_ranks(xh, dt, a, b, c, cfg.ssm_chunk, init, ssd_scan)

    def output_local(yl, xhl, zl, d_skip, scale):
        return _ssm_output({"d_skip": d_skip, "norm": {"scale": scale}}, cfg, yl, xhl, zl,
                           x.dtype)

    hp = rows(4)
    normed = on_ranks(output_local, out_placements=list(xp),
                      in_placements=(hp, hp, xp) + (whole,) * 2,
                      in_grad_placements=(hp, hp, xp) + (wgrad,) * 2)(
        y, xh, z, p["d_skip"], p["norm"]["scale"])
    return normed @ p["w_out"], conv_state, final


def ssm_decode(
    p: dict, cfg: ModelConfig, x: torch.Tensor, state: SSMState,
) -> tuple[torch.Tensor, SSMState]:
    """Single-token recurrent step. x: (B,1,d_model).  Returns new states;
    the conv window takes the promoted dtype of the cache and the input, as
    in JAX (a float32 model's bfloat16 prefill window turns float32)."""
    proj = x @ p["w_in"]                              # (B,1,·)
    z, x_bc_new, dt = _split_proj(cfg, proj)

    # causal conv over [conv_state | new]
    wdt = torch.promote_types(state.conv.dtype, x_bc_new.dtype)
    window = torch.cat([state.conv.to(wdt), x_bc_new.to(wdt)], dim=1)   # (B,K,C)
    w = f32(p["conv_w"])                                        # (K,C)
    conv_out = (f32(window) * w).sum(dim=1) + f32(p["conv_b"])
    x_bc = F.silu(conv_out)[:, None, :].to(x.dtype)             # (B,1,C)

    bsz = x.shape[0]
    di = cfg.ssm_d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    xs = x_bc[..., :di]
    b = x_bc[..., di : di + gn].reshape(bsz, cfg.ssm_ngroups, cfg.ssm_state)
    c = x_bc[..., di + gn :].reshape(bsz, cfg.ssm_ngroups, cfg.ssm_state)

    h, pd = cfg.ssm_nheads, cfg.ssm_headdim
    xh = f32(xs).reshape(bsz, h, pd)                            # (B,H,P)
    dtv = _softplus(f32(dt)[:, 0, :] + f32(p["dt_bias"]))       # (B,H)
    a = -torch.exp(f32(p["a_log"]))                             # (H,)
    bh, ch = _heads(b, h), _heads(c, h)                         # (B,H,N)

    decay = torch.exp(dtv * a[None, :])                         # (B,H)
    s_new = (
        decay[:, :, None, None] * state.ssd
        + (dtv[:, :, None] * xh)[..., None] * bh[:, :, None, :]
    )
    y = (s_new @ ch[..., None])[..., 0] + f32(p["d_skip"])[None, :, None] * xh
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = gated_rmsnorm(p["norm"], y, z, cfg.norm_eps)
    out = y @ p["w_out"]

    new_conv = window[:, 1:, :]                                 # slide window
    return out, SSMState(conv=new_conv, ssd=s_new)
