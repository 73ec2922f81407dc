"""Loss models of the fog broadcast channel (port of ``repro.core.coherence``).

The JAX functions draw their uniforms from a PRNG key.  Here every mask is a
function of uniform draws passed in, so a caller can feed the same uniforms
that JAX drew (``TickDraws`` replay) or draw its own from a
``torch.Generator``.  A mask is ``uniform >= p``; a float32 tensor compared
with a Python float is compared in float32, as JAX compares with its weakly
typed constants, so replayed uniforms give bitwise-identical masks.

Also the replicate policy's gossip round (``merge_broadcasts``) and the
paper's analytic loss bound beside the exact i.i.d. value.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cache_state import CacheLine, CacheState
from repro_torch.core.flic import insert_batch, vmap_nodes


def bernoulli_loss_mask(u: torch.Tensor, loss_prob: float) -> torch.Tensor:
    """True = DELIVERED: i.i.d. per-packet loss, from uniforms ``u``."""
    return u >= loss_prob


@dataclasses.dataclass(frozen=True)
class GilbertElliott:
    """Two-state bursty loss channel per receiver."""

    bad: torch.Tensor  # (N,) bool

    @staticmethod
    def init(n: int, device=None) -> "GilbertElliott":
        return GilbertElliott(bad=torch.zeros((n,), dtype=torch.bool, device=device))


def gilbert_elliott_advance(state: GilbertElliott, u_up: torch.Tensor,
                            u_dn: torch.Tensor, p_g2b: float = 0.05,
                            p_b2g: float = 0.4) -> GilbertElliott:
    """Advance every receiver's channel one tick from two (N,) uniforms."""
    flip_up = u_up < p_g2b
    flip_dn = u_dn < p_b2g
    return GilbertElliott(bad=torch.where(state.bad, ~flip_dn, flip_up))


def gilbert_elliott_mask(state: GilbertElliott, u: torch.Tensor,
                         receivers: torch.Tensor | None = None,
                         loss_good: float = 0.01,
                         loss_bad: float = 0.5) -> torch.Tensor:
    """Delivery mask for an already-advanced channel from uniforms ``u``.

    ``u.shape[0]`` indexes receivers; ``receivers`` maps compact leading rows
    (reader slots) to global node ids for the per-receiver loss probability.
    """
    loss_p = torch.where(state.bad, loss_bad, loss_good)        # (N,) float32
    if receivers is not None:
        loss_p = loss_p[receivers.long()]
    if loss_p.shape[0] != u.shape[0]:
        raise ValueError("mask leading axis must be receivers")
    return u >= loss_p.reshape((u.shape[0],) + (1,) * (u.dim() - 1))


def gilbert_elliott_step(state: GilbertElliott, u_up: torch.Tensor, u_dn: torch.Tensor,
                         u: torch.Tensor, p_g2b: float = 0.05, p_b2g: float = 0.4,
                         loss_good: float = 0.01, loss_bad: float = 0.5
                         ) -> tuple[GilbertElliott, torch.Tensor]:
    """Advance the channel one tick and draw its delivery mask (the shape of
    ``u``, receivers leading): (state, delivered).  JAX's three subkeys of
    the tick are the three uniforms here: ``u_up`` and ``u_dn`` (N,) for the
    state's flips, ``u`` for the mask."""
    if u.shape[0] != state.bad.shape[0]:
        raise ValueError("mask leading axis must be receivers")
    state = gilbert_elliott_advance(state, u_up, u_dn, p_g2b, p_b2g)
    return state, gilbert_elliott_mask(state, u, loss_good=loss_good, loss_bad=loss_bad)


def merge_broadcasts(caches: CacheState, rows: CacheLine, delivered: torch.Tensor,
                     now, self_always: bool = True,
                     node_ids: torch.Tensor | None = None) -> tuple[CacheState, CacheLine]:
    """One gossip round: every node upserts the R broadcast rows in order.

    ``delivered`` is the (N, R) delivery mask per (receiver, row); with
    ``self_always`` a node always hears its own rows (``node_ids``: the
    global id of each cache lane, default ``arange(N)``).  Receivers store
    a row clean: only its origin keeps it dirty.  Returns (caches,
    evictions) with leading axes (N, R).
    """
    n = caches.tags.shape[0]
    if node_ids is None:
        node_ids = torch.arange(n, dtype=torch.int32, device=rows.key.device)
    if self_always:
        delivered = delivered | (rows.origin[None, :] == node_ids[:, None])

    def per_node(cache, deliv_row, node_id):
        lines = dataclasses.replace(rows, valid=rows.valid & deliv_row,
                                    dirty=rows.dirty & (rows.origin == node_id))
        return insert_batch(cache, lines, now)

    return vmap_nodes(per_node)(caches, delivered, node_ids.to(torch.int32))


# --------------------------------------------------------------------------
# Analytics: the paper's §II-B bound and the exact i.i.d. loss probability.
# --------------------------------------------------------------------------

def markov_loss_bound(loss_prob: float, n_nodes: int) -> float:
    """Markov bound on near-total update loss (paper §II-B).

    Pr[sum L_k >= N-1] <= E[sum L_k]/(N-1) = N·p/(N-1).

    NOTE (erratum): the paper prints E[L_k]/(N-1) = p/(N-1), dropping the
    N factor from E[sum L_k] = N·p.  The corrected bound is implemented
    here; it still decreases toward p as N grows, preserving the paper's
    qualitative claim, and it actually dominates the exact i.i.d. total-loss
    probability p^N for all p (the printed form fails at p -> 1).
    """
    if n_nodes <= 1:
        return 1.0
    return min(1.0, n_nodes * loss_prob / (n_nodes - 1))


def exact_total_loss_prob(loss_prob: float, n_nodes: int) -> float:
    """Exact i.i.d. probability that ALL N receivers lose the packet."""
    return float(loss_prob) ** int(n_nodes)
