"""Training data pipeline (port of ``repro.data.pipeline``).

Data-parallel workers are fog nodes that produce token shards and read each
other's; a shard read goes through a FLIC cache before the backing store,
the paper's read path.  The source is a deterministic synthetic corpus
(``synthetic_batch``, numpy only, so it is a copy of JAX's and gives the
same bits), and ``DataPipeline`` prefetches it on a thread while its shard
reads go through the port's scalar FLIC cache (``core.flic.insert`` and
``local_lookup``) on the CPU.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core.cache_state import CacheLine, empty_cache
from repro_torch.core.flic import insert, local_lookup
from repro_torch.utils.hashing import hash2_u32

SHARD_SALT = 0xD47A


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    seed: int = 0
    prefetch: int = 2
    # FLIC shard-cache knobs
    cache_lines: int = 64
    cache_ways: int = 4
    shard_tokens: int = 65536


def synthetic_batch(cfg: ModelConfig, seq: int, batch: int, step: int, seed: int = 0) -> dict:
    """Deterministic synthetic batch (same on every host, no file I/O), as
    numpy arrays.

    Tokens follow a power-law marginal (not uniform): a uniform stream is
    already loss-optimal for a fresh near-zero-logit model (CE == log V with
    zero gradient signal), so nothing can be learned from it.  The skewed
    unigram distribution gives the trainer a real signal: the loss floor is
    the distribution's entropy, well below log V.
    """
    rng = np.random.default_rng(np.uint32(seed * 1_000_003 + step))
    u = rng.random((batch, seq + 1))
    tokens = np.minimum((cfg.vocab_size * u**4).astype(np.int32), cfg.vocab_size - 1)
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.frontend_seq, cfg.d_model), dtype=np.float32) * 0.02
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((batch, seq, cfg.d_model), dtype=np.float32) * 0.02
    return out


def batch_to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class DataPipeline:
    """Background-prefetching iterator with a FLIC shard cache.

    ``read_shard(shard_id)`` goes local cache -> backing store and records
    hit metrics, so the trainer never blocks on the store for hot shards.
    The producer thread starts with the pipeline; ``close`` stops it.
    """

    def __init__(self, model_cfg: ModelConfig, cfg: DataConfig):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._cache = empty_cache(max(1, cfg.cache_lines // cfg.cache_ways), cfg.cache_ways, 8,
                                  device="cpu")
        self.stats = {"shard_hits": 0, "shard_misses": 0}
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- FLIC-cached shard read ------------------------------------------------
    def read_shard(self, shard_id: int) -> np.ndarray:
        key = hash2_u32(torch.tensor(shard_id, dtype=torch.int64),
                        torch.tensor(SHARD_SALT, dtype=torch.int64))
        self._cache, res = local_lookup(self._cache, key, self._step)
        if bool(res.hit):
            self.stats["shard_hits"] += 1
        else:
            self.stats["shard_misses"] += 1
            line = CacheLine(
                key=key, data_ts=torch.tensor(self._step, dtype=torch.int32),
                origin=torch.tensor(0, dtype=torch.int32),
                data=torch.zeros((8,), dtype=torch.float32), valid=torch.tensor(True),
                dirty=torch.tensor(False),
            )
            self._cache, _ = insert(self._cache, line, self._step)
        rng = np.random.default_rng(np.uint32(shard_id))
        return rng.integers(0, self.model_cfg.vocab_size, (self.cfg.shard_tokens,),
                            dtype=np.int32)

    def _producer(self):
        step = 0
        while not self._stop.is_set():
            batch = synthetic_batch(self.model_cfg, self.cfg.seq_len, self.cfg.global_batch,
                                    step, self.cfg.seed)
            self.read_shard(step % 16)      # touch the shard cache like a real reader
            try:
                self._q.put(batch, timeout=1.0)
                step += 1
                self._step = step
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
