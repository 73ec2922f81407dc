"""Fault-tolerant checkpointing without external deps (port of
``repro.ckpt.checkpoint``).

The layout is the JAX package's, so checkpoints pass between the two::

    ckpt_dir/step_000123/
        manifest.json        # leaf paths, shapes, logical dtypes, crc32s
        arrays.npz           # host copies of the leaves (np.savez)
        .complete            # commit marker, written last (atomic rename)

* Leaves are named by ``utils.trees.tree_flatten_with_paths`` as JAX names
  them (``params/embed/tok``, ``opt/mu/...``).
* The archive is written uncompressed (JAX's is compressed; ``np.load``
  reads either): deflating random weights saves little space and takes
  tens of seconds a gigabyte.
* numpy has no bfloat16: such a leaf is stored as its ``uint16`` view,
  with ``"bfloat16"`` as its dtype in the manifest, and each leaf's crc32
  is taken over the stored bytes.
* Readers trust only directories with ``.complete``; a killed writer
  leaves a temporary directory that is skipped.
* ``CheckpointManager.save_async`` copies the tree to host memory at once,
  then writes it on a thread, off the training step; ``keep`` bounds how
  many complete checkpoints stay.
* ``restore_checkpoint(..., device=)`` puts the leaves on ``device`` in the
  dtypes of the tree it restores into (JAX's ``shardings=``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.utils.trees import tree_flatten_with_paths, tree_unflatten

# numpy cannot hold these: stored as a same-width uint view, the logical
# dtype in the manifest.
_EXOTIC = {"bfloat16": (np.uint16, torch.int16)}
_TORCH_NAMES = {torch.bfloat16: "bfloat16"}


def _crc(a: np.ndarray) -> int:
    """crc32 of the array's bytes (JAX's ``_crc``), read in place."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def _to_savable(leaf) -> tuple[np.ndarray, str]:
    """(a numpy array numpy can save, its logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _TORCH_NAMES.get(t.dtype)
        if name is not None:
            store, same_width = _EXOTIC[name]
            return t.view(same_width).numpy().view(store), name
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    name = str(a.dtype)
    if name in _EXOTIC:
        return a.view(_EXOTIC[name][0]), name
    return a, name


def _snapshot(leaf):
    """A host copy of ``leaf`` that later updates of the leaf cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None) -> str:
    """Synchronous save with atomic commit. Returns the final path."""
    arrays, logical = {}, {}
    for name, leaf in tree_flatten_with_paths(tree):
        arrays[name], logical[name] = _to_savable(leaf)
    manifest = {
        "step": step,
        "time": time.time(),
        "extra": extra or {},
        "leaves": {
            name: {"shape": list(a.shape), "dtype": logical[name], "crc32": _crc(a)}
            for name, a in arrays.items()
        },
    }
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, ".complete"), "w") as f:
            f.write("ok")
        if os.path.exists(final):  # a re-save of the same step
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _complete_steps(ckpt_dir: str) -> list[int]:
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, ".complete")))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def _restore_leaf(a: np.ndarray, logical: str, like, device):
    """The stored array as a leaf like ``like``: a tensor of its dtype on
    ``device`` (bfloat16 from the stored bits), else a numpy array."""
    if isinstance(like, torch.Tensor):   # ``a`` is a fresh array np.load made
        t = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if logical == "bfloat16"
             else torch.from_numpy(a))
        return t.to(device=device, dtype=like.dtype)
    if logical in _EXOTIC:
        return a
    want = getattr(like, "dtype", None)
    return a.astype(want) if want is not None and a.dtype != want else a


def restore_checkpoint(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
                       device=None) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (its leaves give each
    restored leaf's dtype; a tensor leaf comes back on ``device``, default
    that leaf's device).  Raises on a missing leaf or a crc mismatch."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = tree_flatten_with_paths(tree_like)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = [n for n, _ in flat if n not in data]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        leaves = []
        for name, like in flat:
            a = data[name]
            want, got = manifest["leaves"][name]["crc32"], _crc(a)
            if want != got:
                raise IOError(f"crc mismatch for {name}: {want} != {got}")
            dev = device if device is not None else getattr(like, "device", None)
            leaves.append(_restore_leaf(a, manifest["leaves"][name]["dtype"], like, dev))
    return tree_unflatten(tree_like, leaves), manifest


@dataclasses.dataclass
class CheckpointManager:
    """Async checkpointing with bounded retention."""

    ckpt_dir: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the writer; raise the error it hit, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Snapshot to host memory now; write on a background thread."""
        self.wait()
        snap = {name: _snapshot(leaf) for name, leaf in tree_flatten_with_paths(tree)}

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, snap, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 -- surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _complete_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"), ignore_errors=True)

    def latest(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)
