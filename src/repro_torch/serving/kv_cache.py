"""FLIC-paged KV cache: the paper's cache as a serving substrate.

Port of ``repro.serving.kv_cache``.  Three locality levels:

  * **PagePool** (device memory) — fixed-size K/V pages per layer, the
    "local cache" level.  Reads go through the ``paged_attention`` kernel.
  * **fog** — on a pod, peers' memory; in this single-device engine the fog
    level collapses into the pool.
  * **host backing store** — evicted pages spill to host memory through a
    write-behind queue (the paper's single queued writer), and prefix reuse
    faults them back in.

Page identity is a FLIC cache line: key = hash(seq_uid, page_index),
timestamped by last use, with LRU eviction.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.utils.hashing import hash2_u32_int


@dataclasses.dataclass
class PagePool:
    """Device-resident paged K/V for all layers of a dense GQA model.

    Unlike the JAX package's immutable pool, ``write_prefill`` and
    ``write_pages`` update ``k``/``v`` IN PLACE (and return the pool), so a
    step never copies the whole pool.
    """

    k: torch.Tensor  # (L, P, page, Hkv, D) bfloat16
    v: torch.Tensor  # (L, P, page, Hkv, D) bfloat16
    page_size: int

    @staticmethod
    def create(cfg: ModelConfig, num_pages: int, page_size: int, device) -> "PagePool":
        shape = (
            cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
            cfg.resolved_head_dim,
        )
        return PagePool(
            k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
            v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
            page_size=page_size,
        )

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    def _index(self, pages) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pages, np.int64), device=self.k.device)

    def write_prefill(self, pages: np.ndarray, k: torch.Tensor, v: torch.Tensor) -> "PagePool":
        """Copy a prefill's (L, S, Hkv, D) K/V into ``pages`` (host ids), in place."""
        l, s, h, d = k.shape
        ps = self.page_size
        n = (s + ps - 1) // ps
        pad = n * ps - s
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        idx = self._index(pages[:n])
        self.k[:, idx] = k.reshape(l, n, ps, h, d).to(self.k.dtype)
        self.v[:, idx] = v.reshape(l, n, ps, h, d).to(self.v.dtype)
        return self

    def read_pages(self, pages: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Host copies (L, n, page, Hkv, D) of ``pages``."""
        idx = self._index(pages)
        return self.k[:, idx].cpu(), self.v[:, idx].cpu()

    def write_pages(self, pages: np.ndarray, k: torch.Tensor, v: torch.Tensor) -> "PagePool":
        """Copy host K/V (L, n, page, Hkv, D) into ``pages``, in place."""
        idx = self._index(pages)
        self.k[:, idx] = k.to(device=self.k.device, dtype=self.k.dtype)
        self.v[:, idx] = v.to(device=self.v.device, dtype=self.v.dtype)
        return self


class FlicPageManager:
    """Host-side page directory with FLIC semantics.

    * LRU over page keys hash(seq_uid, page_idx); ties on the timestamp go
      to the key inserted first (``min`` over the dict);
    * spill-on-evict to a host backing store via a bounded write-behind
      queue (single writer, drained ``drain_per_step`` pages per step — the
      paper's load-store-buffer writer), readable by ``lookup_prefix``;
    * prefix reuse: a new request whose prompt prefix matches a cached
      sequence faults pages back from the store (or hits them in the pool).
    """

    def __init__(self, pool_pages: int, drain_per_step: int = 8):
        self.free: deque[int] = deque(range(pool_pages))
        self.resident: dict[int, dict] = {}     # key -> {page, ts, seq, idx}
        self.spill_queue: deque[tuple[int, torch.Tensor, torch.Tensor]] = deque()
        self.store: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.drain_per_step = drain_per_step
        self.clock = 0
        self.stats = {
            "alloc": 0, "evict": 0, "spill_bytes": 0, "fetch_bytes": 0,
            "prefix_hits": 0, "prefix_store_hits": 0, "prefix_misses": 0,
        }

    @staticmethod
    def page_key(seq_uid: int, page_idx: int) -> int:
        return hash2_u32_int(seq_uid, page_idx)

    def tick(self):
        self.clock += 1

    # -- allocation ---------------------------------------------------------
    def alloc(self, seq_uid: int, page_idx: int, pool: PagePool) -> tuple[int, PagePool]:
        """Allocate one page; evicts the LRU resident page if needed."""
        self.stats["alloc"] += 1
        if not self.free:
            pool = self._evict_lru(pool)
        page = self.free.popleft()
        key = self.page_key(seq_uid, page_idx)
        self.resident[key] = {
            "page": page, "ts": self.clock, "seq": seq_uid, "idx": page_idx,
        }
        return page, pool

    def touch(self, seq_uid: int, page_idx: int):
        key = self.page_key(seq_uid, page_idx)
        if key in self.resident:
            self.resident[key]["ts"] = self.clock

    def _evict_lru(self, pool: PagePool) -> PagePool:
        key = min(self.resident, key=lambda k: self.resident[k]["ts"])
        meta = self.resident.pop(key)
        k, v = pool.read_pages(np.array([meta["page"]]))
        self.spill_queue.append((key, k[:, 0], v[:, 0]))
        self.free.append(meta["page"])
        self.stats["evict"] += 1
        return pool

    def drain(self):
        """The single queued writer: flush a bounded batch to the store."""
        for _ in range(min(self.drain_per_step, len(self.spill_queue))):
            key, k, v = self.spill_queue.popleft()
            self.store[key] = (k, v)
            self.stats["spill_bytes"] += k.nbytes + v.nbytes

    # -- prefix reuse -------------------------------------------------------
    def lookup_prefix(self, seq_uid: int, page_idx: int) -> Optional[str]:
        """'pool' | 'store' | None — where a previously cached page lives."""
        key = self.page_key(seq_uid, page_idx)
        if key in self.resident:
            self.stats["prefix_hits"] += 1
            return "pool"
        # the write-behind queue is readable too (paper §II-D)
        for qk, _, _ in self.spill_queue:
            if qk == key:
                self.stats["prefix_hits"] += 1
                return "pool"
        if key in self.store:
            self.stats["prefix_store_hits"] += 1
            return "store"
        self.stats["prefix_misses"] += 1
        return None

    def fetch_from_store(self, seq_uid: int, page_idx: int,
                         pool: PagePool) -> tuple[int, PagePool]:
        key = self.page_key(seq_uid, page_idx)
        k, v = self.store[key]
        page, pool = self.alloc(seq_uid, page_idx, pool)
        pool = pool.write_pages(np.array([page]), k[:, None], v[:, None])
        self.stats["fetch_bytes"] += k.nbytes + v.nbytes
        return page, pool

    def release(self, seq_uid: int, page_indices: list[int]):
        """Return a finished sequence's pages to the free list (no spill) —
        unless kept resident for prefix reuse (caller decides by not calling)."""
        for idx in page_indices:
            key = self.page_key(seq_uid, idx)
            meta = self.resident.pop(key, None)
            if meta is not None:
                self.free.append(meta["page"])
