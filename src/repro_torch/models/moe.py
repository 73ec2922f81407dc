"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

Port of ``repro.models.moe``, function by function.  Tokens are sorted by
assigned expert, packed into an (E, C, D) buffer (C = capacity), run
through the stacked expert SwiGLUs and combined back with the router
weights.  Overflow beyond capacity is dropped; the Switch/GShard
load-balance loss is computed before the drop.

Where JAX's primitives promise an order that torch's do not, the port
spells the order out:

* ``jax.lax.top_k`` returns descending values, ties to the lower index:
  here a stable descending ``torch.sort`` and its first k;
* ``jnp.bincount`` per group is a ``scatter_add_`` into (G, E);
* ``_pack``'s out-of-bounds drop slot ``E*C`` is a real row of an
  ``E*C + 1``-row buffer, sliced off;
* ``_combine``'s scatter-add adds a token's k contributions in the order of
  the sorted plan, in the output dtype; XLA's CPU scatter does so one
  update at a time.  A token's entries in the plan are sorted by expert,
  so here each token adds its k contributions by ascending expert, in a
  loop of k adds from zero (no atomics, the same order on every device).

JAX's dispatch plan is per group: one group per batch row when S >= E
(train, prefill), one global group of B*S tokens otherwise (decode).  Here
both are one batched plan over G groups.  JAX's hint on the output is
``repro_torch.shard.shard_act`` at the same site; its hints on the expert
buffer are the placements of ``_experts_on_ranks``.

Under a plan (``use_rules``) with DTensor activations, the plan, the pack,
the expert products and the combine run under ``local_map`` on each
rank's own groups (``moe_b``; the decode group whole), its own experts
(``act_experts``) and its share of d (``moe_d``): ``_moe_sharded``.  The
routing is ``_route_core`` there too; the load-balance loss is summed
from per-rank partial sums (the same value; the order of the sums
differs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import f32
from repro_torch.models.params import ParamDef
from repro_torch.shard import shard_act
from repro_torch.shard.partition import (current_rules, grad_placements, on_ranks,
                                         placements_for, shard_range, sharded)


def moe_defs(cfg: ModelConfig, dtype) -> dict:
    """The router is float32 whatever ``dtype`` is, as in JAX."""
    e, d, fdim = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    defs = {
        "router": ParamDef((d, e), ("embed_in", "experts"), dtype=torch.float32),
        "w_gate": ParamDef((e, d, fdim), ("experts", "embed_in", "moe_ffn_out"), dtype=dtype),
        "w_up": ParamDef((e, d, fdim), ("experts", "embed_in", "moe_ffn_out"), dtype=dtype),
        "w_down": ParamDef((e, fdim, d), ("experts", "moe_ffn_in", "embed_out"), dtype=dtype),
    }
    if cfg.moe_num_shared:
        s = cfg.moe_num_shared
        defs["shared"] = {
            "w_gate": ParamDef((d, s * fdim), ("embed_in", "ffn_out"), dtype=dtype),
            "w_up": ParamDef((d, s * fdim), ("embed_in", "ffn_out"), dtype=dtype),
            "w_down": ParamDef((s * fdim, d), ("ffn_in", "embed_out"), dtype=dtype),
        }
    return defs


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_num_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _route_core(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor):
    """Router top-k for (T,D) tokens: (gates (T,K) float32, idx (T,K) int64,
    probs (T,E) float32, one_hot (T,K,E) float32).  The load-balance loss
    is read from ``probs`` and ``one_hot`` (``_route``, ``_moe_sharded``)."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    logits = f32(xt) @ f32(router)                            # (T,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, topk_idx = vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return gate_vals, topk_idx, probs, F.one_hot(topk_idx, e).to(torch.float32)


def _route(p: dict, cfg: ModelConfig, xt: torch.Tensor):
    """Router top-k for (T,D) tokens. Returns (gates (T,K) float32, idx
    (T,K) int64, aux 0-d float32)."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    gate_vals, topk_idx, probs, one_hot = _route_core(cfg, xt, p["router"])
    # load-balance aux loss (Switch/GShard), computed before dropping
    me = probs.mean(dim=0)
    ce = one_hot.sum(dim=1).mean(dim=0) / k
    aux = e * (me * ce).sum()
    return gate_vals, topk_idx, aux


def _pack_plan(cfg: ModelConfig, gate_vals: torch.Tensor, topk_idx: torch.Tensor, cap: int):
    """Sort-based dispatch plan for G groups of T tokens (inputs (G,T,K)).

    Returns, each (G, T*K) in plan order (a stable sort of the flattened
    assignments by expert): ``keep`` (rank within the expert < ``cap``),
    ``buf_rows`` (``e*cap + rank`` where kept, else the drop slot
    ``E*cap``), ``sw`` (the gate) and ``stok`` (the token)."""
    e = cfg.moe_num_experts
    g, t, k = topk_idx.shape
    flat_e = topk_idx.reshape(g, t * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    sw = gate_vals.reshape(g, t * k).gather(1, order)
    stok = torch.div(order, k, rounding_mode="floor")          # flat entry j is token j // k
    counts = torch.zeros((g, e), dtype=torch.int64, device=se.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(t * k, device=se.device) - starts.gather(1, se)
    keep = rank < cap
    buf_rows = torch.where(keep, se * cap + rank, e * cap)
    return keep, buf_rows, sw, stok


def _pack(xt: torch.Tensor, buf_rows: torch.Tensor, stok: torch.Tensor, e: int,
          cap: int) -> torch.Tensor:
    """(G,T,D) tokens into the (G,E,cap,D) expert buffer; dropped entries
    land in the extra row ``E*cap``, which is cut off."""
    g, _, d = xt.shape
    gidx = torch.arange(g, device=xt.device)[:, None]
    buf = torch.zeros((g, e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((gidx, buf_rows), xt[gidx, stok])
    return buf[:, :e * cap].reshape(g, e, cap, d)


def _combine(out_buf: torch.Tensor, keep: torch.Tensor, buf_rows: torch.Tensor,
             sw: torch.Tensor, stok: torch.Tensor, t: int) -> torch.Tensor:
    """(G,E,cap,D) expert outputs back to (G,T,D) tokens: each token's k
    gated contributions (0 where dropped) added in plan order, in the
    output dtype, starting from 0."""
    g, e, cap, d = out_buf.shape
    k = keep.shape[1] // t
    # the plan positions of token i's k entries, in plan order, at
    # [:, i*k:(i+1)*k]
    slots = torch.argsort(stok, dim=1, stable=True)

    def per_token(a):
        return a.gather(1, slots).reshape(g, t, k)

    flat = out_buf.reshape(g, e * cap, d)
    gidx = torch.arange(g, device=out_buf.device)[:, None, None]
    kept = per_token(keep)
    gathered = flat[gidx, per_token(torch.where(keep, buf_rows, 0))]   # (G,T,K,D)
    w = per_token(sw).to(out_buf.dtype)
    contrib = torch.where(kept[..., None], gathered * w[..., None], 0)
    y = torch.zeros((g, t, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        y = y + contrib[:, :, j]
    return y


def _experts(p: dict, buf: torch.Tensor) -> torch.Tensor:
    """The stacked expert SwiGLUs on a (G,E,cap,D) buffer.  JAX's sharding
    hints on the buffer, ``h`` and the output (``moe_b``, ``act_experts``,
    -, ``moe_d``) are the placements of ``_experts_on_ranks``, which runs
    them on DTensors; here the buffer is a plain tensor."""
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) * torch.einsum(
        "gecd,edf->gecf", buf, p["w_up"])
    return torch.einsum("gecf,efd->gecd", h, p["w_down"])


def _experts_on_ranks(p: dict, buf):
    """``_experts`` on a DTensor buffer laid out (groups, experts, -, d) by
    the plan: each rank runs its own experts on its own groups under
    ``local_map``.  The gate and up products contract the buffer's d over
    its shards (partial sums, reduced by DTensor); the down product writes
    the rank's share of d.  The weights are read as the buffer is laid out
    (experts and d alike, the ffn dim whole)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, _ = current_rules()
    bp = tuple(buf.placements)
    # the weights (E, D, F) / (E, F, D) laid out as the buffer's E and D
    wp = tuple(Shard({1: 0, 3: 1}[pl.dim]) if isinstance(pl, Shard) and pl.dim in (1, 3)
               else Replicate() for pl in bp)
    wdp = tuple(Shard(2) if pl == Shard(1) else pl for pl in wp)
    part = tuple(Partial() if pl == Shard(3) else pl for pl in bp)
    hp = tuple(Replicate() if pl == Shard(3) else pl for pl in bp)

    def up(bl, wg, wu):
        return (torch.einsum("gecd,edf->gecf", bl, wg).contiguous(),
                torch.einsum("gecd,edf->gecf", bl, wu).contiguous())

    gate, upv = on_ranks(up, out_placements=(part, part), in_placements=(bp, wp, wp),
                         in_grad_placements=(bp, grad_placements(wp, bp),
                                             grad_placements(wp, bp)))(
        buf, p["w_gate"], p["w_up"])
    h = F.silu(gate.redistribute(mesh, hp)) * upv.redistribute(mesh, hp)
    down = on_ranks(lambda hl, wd: torch.einsum("gecf,efd->gecd", hl, wd).contiguous(),
                    out_placements=list(bp), in_placements=(hp, wdp),
                    in_grad_placements=(grad_placements(hp, bp), grad_placements(wdp, bp)))
    return down(h, p["w_down"])


def moe_plan(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """Routing and dispatch plan of ``moe_forward`` for x (B,S,D).  Returns
    (xg, cap, aux, plan): the tokens in groups, (G,T,D) (one group per
    batch row when S >= E, else one of all B*S tokens), the capacity, the
    load-balance loss and ``_pack_plan``'s (keep, buf_rows, sw, stok)."""
    bsz, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    xg = x if s >= e else x.reshape(1, bsz * s, d)
    g, t = xg.shape[:2]
    cap = _capacity(cfg, t)
    gates, topk_idx, aux = _route(p, cfg, xg.reshape(g * t, d))
    plan = _pack_plan(cfg, gates.reshape(g, t, k), topk_idx.reshape(g, t, k), cap)
    return xg, cap, aux, plan


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D). Returns (y, aux_loss).

    Dispatch is grouped per batch row when S >= E (train/prefill), one
    global group of B*S tokens otherwise (decode), as in JAX.  Decode runs
    every expert on its (mostly empty) capacity rows, as JAX's einsum does.
    """
    bsz, s, d = x.shape
    if sharded(x):
        y, aux = _moe_sharded(p, cfg, x)
    else:
        xg, cap, aux, (keep, buf_rows, sw, stok) = moe_plan(p, cfg, x)
        buf = _pack(xg, buf_rows, stok, cfg.moe_num_experts, cap)
        y = _combine(_experts(p, buf), keep, buf_rows, sw, stok, xg.shape[1]).reshape(bsz, s, d)
    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])
        y = y + hs @ sp["w_down"]
    return shard_act(y, "batch", "seq", "embed"), aux


def _moe_sharded(p: dict, cfg: ModelConfig, x):
    """The routed experts of ``moe_forward`` on a DTensor ``x`` under the
    active plan: (y (B,S,D), aux).  Expert-parallel: the dispatch buffer
    (groups, experts, capacity, d) lies as JAX's constraint on it says
    (``moe_b``, ``act_experts``, -, ``moe_d``; the decode group whole), and
    each rank packs, runs and combines only its own experts' rows and its
    own share of d, under ``local_map``.  The routing plan is computed for
    the rank's groups over all experts (the router read whole); the combined
    output is the sum of the ranks' expert shares (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, plan = current_rules()
    bsz, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    grouped = s >= e
    g_all, t = (bsz, s) if grouped else (1, bsz * s)
    cap = _capacity(cfg, t)
    groups = (placements_for(("moe_b", None, None), (bsz, s, d), mesh, plan) if grouped
              else (Replicate(),) * mesh.ndim)
    bp = placements_for(("moe_b" if grouped else None, "act_experts", None, "moe_d"),
                        (g_all, e, cap, d), mesh, plan)
    whole = (Replicate(),) * mesh.ndim
    # per-rank sums over its own groups: partial where the groups are split
    partial = tuple(Partial() if isinstance(pl, Shard) else pl for pl in groups)
    e0, e_l = shard_range(mesh, bp, 1, e)
    d0, d_l = shard_range(mesh, bp, 3, d)

    def mine(keep, rows):
        return keep & (rows >= e0 * cap) & (rows < (e0 + e_l) * cap)

    def in_groups(xl):
        return xl if grouped else xl.reshape(1, -1, d)

    def plan_local(xl, router):
        xg = in_groups(xl)
        g = xg.shape[0]
        gates, topk, probs, one_hot = _route_core(cfg, xg.reshape(g * t, d), router)
        keep, rows, sw, stok = _pack_plan(cfg, gates.reshape(g, t, k), topk.reshape(g, t, k), cap)
        return keep, rows, sw, stok, probs.sum(dim=0), one_hot.sum(dim=1).sum(dim=0)

    def pack_local(xl, keep, rows, stok):
        local = mine(keep, rows)
        return _pack(in_groups(xl)[..., d0:d0 + d_l],
                     torch.where(local, rows - e0 * cap, e_l * cap), stok, e_l, cap)

    # routing: every rank of a group computes the same plan (gradients as
    # the groups lie); packing: each rank its own experts and share of d
    # (x's gradient the sum of the ranks' shares)
    gp = groups   # the plan's (G, T*K) tensors: split as the groups
    keep, rows, sw, stok, prob_sum, counts = on_ranks(
        plan_local, out_placements=(gp,) * 4 + (partial, partial),
        in_placements=(groups, whole), in_grad_placements=(groups, partial))(x, p["router"])
    buf = on_ranks(pack_local, out_placements=list(bp), in_placements=(groups, gp, gp, gp),
                   in_grad_placements=(grad_placements(groups, bp), gp, gp, gp))(
        x, keep, rows, stok)
    tokens = bsz * s
    me = (prob_sum / tokens).redistribute(mesh, whole)
    ce = (counts / (tokens * k)).redistribute(mesh, whole)
    aux = e * (me * ce).sum()
    out_buf = _experts_on_ranks(p, buf)

    def combine_local(ob, ke, br, w, st):
        local = mine(ke, br)
        return _combine(ob, local, torch.where(local, br - e0 * cap, 0), w, st, t)

    yp = tuple(Partial() if pl == Shard(1) else Shard(2) if pl == Shard(3) else pl for pl in bp)
    y = on_ranks(combine_local, out_placements=list(yp), in_placements=(bp,) + (gp,) * 4,
                 in_grad_placements=(bp, gp, gp, grad_placements(gp, bp), gp))(
        out_buf, keep, rows, sw, stok)
    return y.reshape(bsz, s, d), aux


