"""Loss models of the fog broadcast channel (port of ``repro.core.coherence``).

The JAX functions draw their uniforms from a PRNG key.  Here every mask is a
function of uniform draws passed in, so a caller can feed the same uniforms
that JAX drew (``TickDraws`` replay) or draw its own from a
``torch.Generator``.  A mask is ``uniform >= p``; a float32 tensor compared
with a Python float is compared in float32, as JAX compares with its weakly
typed constants, so replayed uniforms give bitwise-identical masks.

The replicate-policy merge (``merge_broadcasts``) and the analytic loss
bounds come with a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


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
