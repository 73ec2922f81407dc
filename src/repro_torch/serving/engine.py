"""Continuous-batching serve engine over the FLIC page cache.

Port of ``repro.serving.engine``, behaviour for behaviour.  Request
lifecycle: submit -> (admission) prefill or FLIC prefix reuse -> batched
paged decode -> finish (pages stay resident and age out through the FLIC
LRU, spilling to the host store via the write-behind queue).

Prefix reuse is content-addressed, like the paper's cache keys: page uid =
crc32 of the token prefix covering the page.  A resubmitted prompt whose
pages are all still in the pool (or the store) skips prefill — the serving
analogue of the paper's fog read hit.  As in JAX: full reuse needs the
prompt to fill whole pages; the page the first generated token lands in
takes the prompt's uid XOR 0x5A5A5A5A; both admission branches feed the
last prompt token as the first decode input, at ``pos = len(prompt)``; and
each admitted prompt is prefilled alone, at batch 1.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.simulator import resolve_device
from repro_torch.models.model import prefill as model_prefill
from repro_torch.serving.kv_cache import FlicPageManager, PagePool
from repro_torch.serving.serve_step import paged_attention_fn, paged_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    tokens: list[int] = dataclasses.field(default_factory=list)
    pages: list[int] = dataclasses.field(default_factory=list)
    page_uids: list[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    reused_prefill: bool = False


def _prefix_uid(tokens: list[int]) -> int:
    return zlib.crc32(np.asarray(tokens, np.int32).tobytes()) & 0x7FFFFFFF


class ServeEngine:
    """``kernel_backend``: ``None`` reads K/V through ``ops.paged_attention``
    (the CUDA kernel on the card, its plain version on the CPU); ``"plain"``
    forces the plain version on any device.  ``device=None`` means the card
    (``resolve_device``); ``params`` must lie on that device."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_batch: int = 4,
        max_seq: int = 256,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        kernel_backend: Optional[str] = None,
        device=None,
    ):
        if cfg.family not in ("dense", "vlm"):
            raise NotImplementedError("the paged engine serves dense GQA stacks only")
        paged_attention_fn(kernel_backend)  # rejects an unknown backend now
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.page_size = page_size
        self.max_seq = max_seq
        self.max_pages = max_seq // page_size
        self.max_batch = max_batch
        self.kernel_backend = kernel_backend
        n_pages = num_pages or (max_batch * self.max_pages * 2)
        self.pool = PagePool.create(cfg, n_pages, page_size, self.device)
        self.mgr = FlicPageManager(n_pages)
        self.mgr.free.popleft()  # page 0 reserved as the inactive-slot dummy
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.waiting: list[Request] = []
        self.finished: list[Request] = []
        self._table = np.zeros((max_batch, self.max_pages), np.int32)
        self._pos = np.zeros((max_batch,), np.int32)
        self._tok = np.zeros((max_batch, 1), np.int32)
        self._rid = 0

    # ------------------------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 16) -> int:
        self._rid += 1
        self.waiting.append(Request(rid=self._rid, prompt=list(prompt), max_new=max_new))
        return self._rid

    # ------------------------------------------------------------------
    def _page_uids_for(self, prompt: list[int]) -> list[int]:
        ps = self.page_size
        n = (len(prompt) + ps - 1) // ps
        return [_prefix_uid(prompt[: min((i + 1) * ps, len(prompt))]) for i in range(n)]

    def _admit(self, req: Request, slot: int):
        ps = self.page_size
        prompt = req.prompt
        uids = self._page_uids_for(prompt)

        # FLIC prefix probe: full-prompt reuse iff every page is cached.
        where = [self.mgr.lookup_prefix(u, i) for i, u in enumerate(uids)]
        full_reuse = all(w is not None for w in where) and len(prompt) % ps == 0
        pages: list[int] = []
        if full_reuse:
            for i, (u, w) in enumerate(zip(uids, where)):
                if w == "pool":
                    key = self.mgr.page_key(u, i)
                    pages.append(self.mgr.resident[key]["page"])
                    self.mgr.touch(u, i)
                else:
                    pg, self.pool = self.mgr.fetch_from_store(u, i, self.pool)
                    pages.append(pg)
            req.reused_prefill = True
        else:
            # full prefill, then write K/V into freshly allocated pages
            _, caches = model_prefill(
                self.params, self.cfg,
                {"tokens": torch.tensor([prompt], dtype=torch.int32, device=self.device)},
            )
            k = caches[0]["blk0"]["k"][:, 0]   # (L,S,Hkv,D)
            v = caches[0]["blk0"]["v"][:, 0]
            for i, u in enumerate(uids):
                pg, self.pool = self.mgr.alloc(u, i, self.pool)
                pages.append(pg)
            self.pool = self.pool.write_prefill(np.asarray(pages), k, v)

        # allocate the page the first generated token lands in, if needed
        if len(prompt) % ps == 0:
            u = _prefix_uid(prompt)  # uid of the growing page
            pg, self.pool = self.mgr.alloc(u ^ 0x5A5A5A5A, len(pages), self.pool)
            pages.append(pg)
            uids.append(u ^ 0x5A5A5A5A)

        req.pages, req.page_uids, req.slot = pages, uids, slot
        self.slots[slot] = req
        row = np.zeros((self.max_pages,), np.int32)
        row[: len(pages)] = pages
        self._table[slot] = row
        self._pos[slot] = len(prompt)
        # both branches feed the last prompt token at pos = len(prompt)
        self._tok[slot, 0] = prompt[-1]

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy choice of every slot's next token from (B, V) logits."""
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    # ------------------------------------------------------------------
    def step(self):
        """One engine iteration: admit, batched decode, retire."""
        self.mgr.tick()
        for slot in range(self.max_batch):
            if self.slots[slot] is None and self.waiting:
                self._admit(self.waiting.pop(0), slot)

        if not any(s is not None for s in self.slots):
            self.mgr.drain()
            return

        def dev(a):
            return torch.tensor(a, device=self.device)

        logits, k_pool, v_pool = paged_decode_step(
            self.params, self.cfg, dev(self._tok), dev(self._pos),
            self.pool.k, self.pool.v, dev(self._table),
            kernel_backend=self.kernel_backend,
        )
        self.pool = dataclasses.replace(self.pool, k=k_pool, v=v_pool)
        nxt = self._next_tokens(logits[:, 0])

        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            req.tokens.append(int(nxt[slot]))
            self._tok[slot, 0] = int(nxt[slot])
            self._pos[slot] += 1
            # page-boundary crossing: allocate the next page
            if self._pos[slot] % self.page_size == 0:
                idx = int(self._pos[slot]) // self.page_size
                uid = _prefix_uid(req.prompt + req.tokens) ^ 0x5A5A5A5A
                if idx < self.max_pages:
                    pg, self.pool = self.mgr.alloc(uid, idx, self.pool)
                    req.pages.append(pg)
                    req.page_uids.append(uid)
                    self._table[slot, idx] = pg
            for u, i in zip(req.page_uids, range(len(req.pages))):
                self.mgr.touch(u, i)
            if len(req.tokens) >= req.max_new or self._pos[slot] >= self.max_seq - 1:
                req.done = True
                self.finished.append(req)
                self.slots[slot] = None  # pages stay resident (prefix cache)
                self._pos[slot] = 0
                self._tok[slot, 0] = 0
                self._table[slot] = 0
        self.mgr.drain()

    def run(self, max_steps: int = 1000) -> list[Request]:
        steps = 0
        while (self.waiting or any(s is not None for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.finished


class TeacherForcedEngine(ServeEngine):
    """A ``ServeEngine`` for parity checks: it records every active slot's
    logits at every decode step (``logits[rid]``, a list of (V,) float32
    rows) and, where ``script[rid]`` gives a request's tokens, feeds those
    instead of its own greedy choice, so two engines see the same inputs."""

    def __init__(self, cfg, params, *, script: Optional[dict[int, list[int]]] = None, **kw):
        super().__init__(cfg, params, **kw)
        self.script = script or {}
        self.logits: dict[int, list[torch.Tensor]] = {}

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        nxt = super()._next_tokens(logits)
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.logits.setdefault(req.rid, []).append(logits[slot].clone())
            if req.rid in self.script:
                nxt[slot] = self.script[req.rid][len(req.tokens)]
        return nxt
