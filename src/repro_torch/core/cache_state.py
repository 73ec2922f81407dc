"""Cache-line state for FLIC as frozen dataclasses of tensors.

The port of ``repro.core.cache_state``.  One difference in representation:
tags (uint32 key hashes in the JAX package) are stored as int32 tensors
holding the same bit pattern, as the JAX kernel wrappers already pass them
(``tags.astype(jnp.int32)``).  Equality is unchanged; the set index is taken
from the UNSIGNED value (``set_index``), because a signed ``%`` on the int32
pattern would place half of all keys in the wrong set.  ``valid``/``dirty``
are bool tensors, payload lanes float32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.hashing import as_u32

NULL_TAG = -1  # the int32 pattern of 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class CacheState:
    """Per-node cache contents, batched over nodes with a leading axis."""

    tags: torch.Tensor      # (N, S, W) int32 — key hash bit pattern
    data_ts: torch.Tensor   # (N, S, W) int32 — generation timestamp
    ins_ts: torch.Tensor    # (N, S, W) int32 — tick the line was inserted
    origin: torch.Tensor    # (N, S, W) int32 — producer node id
    valid: torch.Tensor     # (N, S, W) bool
    dirty: torch.Tensor     # (N, S, W) bool
    last_use: torch.Tensor  # (N, S, W) int32 — last access tick (LRU)
    data: torch.Tensor      # (N, S, W, D) float32 payload lanes

    @property
    def num_sets(self) -> int:
        return self.tags.shape[-2]

    @property
    def num_ways(self) -> int:
        return self.tags.shape[-1]


@dataclasses.dataclass(frozen=True)
class CacheLine:
    """Rows in flight (a broadcast wave, a fill), one per leading lane."""

    key: torch.Tensor      # int32 bit pattern
    data_ts: torch.Tensor  # int32
    origin: torch.Tensor   # int32
    data: torch.Tensor     # (..., D) float32
    valid: torch.Tensor    # bool — masked lanes are no-ops
    dirty: torch.Tensor    # bool


def empty_cache(sets: int, ways: int, payload_dim: int, batch: tuple[int, ...] = (),
                device=None) -> CacheState:
    """An all-invalid cache, batched over the leading ``batch`` dims."""
    shp = (*batch, sets, ways)

    def full(v):
        return torch.full(shp, v, dtype=torch.int32, device=device)

    return CacheState(
        tags=full(NULL_TAG),
        data_ts=full(-1),
        ins_ts=full(-1),
        origin=full(-1),
        valid=torch.zeros(shp, dtype=torch.bool, device=device),
        dirty=torch.zeros(shp, dtype=torch.bool, device=device),
        last_use=full(-1),
        data=torch.zeros((*shp, payload_dim), dtype=torch.float32, device=device),
    )


def null_line(payload_dim: int, dtype: torch.dtype = torch.float32, device=None) -> CacheLine:
    """One invalid, clean row with the null tag: the no-op lane."""
    def i32(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return CacheLine(
        key=i32(NULL_TAG),
        data_ts=i32(-1),
        origin=i32(-1),
        data=torch.zeros((payload_dim,), dtype=dtype, device=device),
        valid=torch.zeros((), dtype=torch.bool, device=device),
        dirty=torch.zeros((), dtype=torch.bool, device=device),
    )


def occupancy(cache: CacheState) -> torch.Tensor:
    """Number of valid lines (per node if batched), int32."""
    return cache.valid.sum(dim=(-2, -1), dtype=torch.int32)


def set_index(keys: torch.Tensor, sets: int) -> torch.Tensor:
    """The set of each key: its unsigned 32-bit value mod ``sets``, as int64."""
    return as_u32(keys) % sets
