"""The port's trainer and checkpoints (``repro_torch.train``,
``repro_torch.ckpt``) on the CPU, mirroring ``tests/test_train_ckpt.py``,
and held against the JAX package across a checkpoint.

* Trainer: the loss falls, a microbatched run stays finite, an injected
  fault is recovered from the last checkpoint, a restart resumes; a run
  that restarts (from a fault or a new ``Trainer``) is bitwise equal to an
  uninterrupted one (the CPU is deterministic).
* Checkpoints: round trip (bfloat16 included), crc, incomplete directory
  ignored, async GC, restore onto a device.
* Across packages, on the Mamba2 smoke config: a JAX ``Trainer`` runs 4
  steps and checkpoints; the port's ``Trainer`` resumes that checkpoint
  and runs 3 more; JAX's continuation of the same checkpoint gives the
  same per-step losses within ``train.replay.TRAIN_TOL["bfloat16"]``'s
  ``loss_rel``.  A port checkpoint restores in JAX's
  ``restore_checkpoint`` with identical arrays, and a tree saved by JAX's
  ``save_checkpoint`` (bfloat16 leaves included) restores in the port with
  identical bits and paths.
* ``python -m repro_torch.launch.train --smoke --device cpu`` prints the
  JSON line of JAX's ``repro.launch.train``.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sizes this worker's torch thread pool)

from repro.ckpt import checkpoint as jckpt
from repro.config import get_smoke_arch as jsmoke
from repro.models import init_model as jinit
from repro.optim import adamw_init as jadamw_init
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import TrainHyper as JHyper
from repro_torch.ckpt import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.config import get_smoke_arch
from repro_torch.train import Trainer, TrainerConfig, TrainHyper
from repro_torch.train.replay import TRAIN_TOL
from repro_torch.train.trainer import inject_fault_at
from repro_torch.utils.trees import tree_flatten_with_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcfg(tmp, **over):
    hyper = over.pop("hyper", TrainHyper(peak_lr=3e-3, warmup_steps=4, total_steps=40,
                                         microbatches=over.pop("microbatches", 1)))
    return TrainerConfig(steps=over.pop("steps", 12), seq_len=32, global_batch=4,
                         ckpt_dir=str(tmp), ckpt_every=5, hyper=hyper, **over)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_same_state(a: Trainer, b: Trainer):
    fa = tree_flatten_with_paths({"params": a.params, "opt": a.opt_state})
    fb = dict(tree_flatten_with_paths({"params": b.params, "opt": b.opt_state}))
    for k, v in fa:
        assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def test_loss_decreases(tmp_path):
    tr = Trainer(get_smoke_arch("granite_8b"), _tcfg(tmp_path, steps=15), device="cpu")
    hist = tr.run()
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first, f"no learning: {first} -> {last}"
    assert {"loss", "lr", "ce", "aux", "grad_norm", "step_time_s", "step"} <= set(hist[0])


def test_microbatched_run_stays_finite(tmp_path):
    tr = Trainer(get_smoke_arch("mamba2_370m"), _tcfg(tmp_path, steps=6, microbatches=2),
                 device="cpu")
    hist = tr.run()
    assert len(hist) == 6
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["aux"] == 0.0 and h["ce"] == h["loss"] for h in hist)


def test_fault_injection_recovers_bitwise(tmp_path):
    """A failure at step 7: the trainer restores step 5 and re-runs 5-6,
    and ends with the params and moments of a run without the fault."""
    cfg = get_smoke_arch("granite_8b")
    tr = Trainer(cfg, _tcfg(tmp_path / "a", steps=10), fault_hook=inject_fault_at({7}),
                 device="cpu")
    hist = tr.run()
    assert tr.step == 10
    steps_seen = [h["step"] for h in hist]
    assert steps_seen.count(7) == 1 and steps_seen.count(5) == 2   # 5-6 re-run after the fault
    clean = Trainer(cfg, _tcfg(tmp_path / "b", steps=10), device="cpu")
    clean_hist = clean.run()
    _assert_same_state(tr, clean)
    assert [h["loss"] for h in hist if h["step"] == 9] == [clean_hist[-1]["loss"]]


def test_restart_resumes_from_checkpoint_bitwise(tmp_path):
    cfg = get_smoke_arch("granite_8b")
    Trainer(cfg, _tcfg(tmp_path / "a", steps=5), device="cpu").run()
    tr2 = Trainer(cfg, _tcfg(tmp_path / "a", steps=8), device="cpu")
    assert tr2.step == 5  # resumed, not restarted
    tr2.run()
    assert tr2.step == 8
    clean = Trainer(cfg, _tcfg(tmp_path / "b", steps=8), device="cpu")
    clean.run()
    _assert_same_state(tr2, clean)


def test_trainer_needs_a_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(get_smoke_arch("granite_8b"), _tcfg(tmp_path, steps=1))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16) / 3}}
    save_checkpoint(str(tmp_path), 3, tree)
    out, manifest = restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 3
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16 and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert manifest["leaves"]["b/c"]["dtype"] == "bfloat16"


def test_crc_detects_corruption(tmp_path):
    tree = {"a": torch.arange(4, dtype=torch.float32)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    np.savez_compressed(os.path.join(path, "arrays.npz"), a=np.zeros(4, np.float32))
    with pytest.raises(IOError, match="crc"):
        restore_checkpoint(str(tmp_path), tree)


def test_incomplete_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2)})
    os.makedirs(os.path.join(str(tmp_path), "step_000000002"))  # no .complete
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(KeyError, match="missing leaves"):
        restore_checkpoint(str(tmp_path), {"b": torch.zeros(2)})


def test_async_manager_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {"x": torch.full((2,), float(s))})
        mgr.wait()
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 2 and kept[-1].endswith("4".zfill(9))
    assert mgr.latest() == 4


def test_async_save_snapshots_before_returning(tmp_path):
    """The tree is copied when ``save_async`` returns: a later in-place
    change of a leaf does not reach the checkpoint."""
    x = torch.zeros(1000)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    out, _ = restore_checkpoint(str(tmp_path), {"x": torch.empty(1000)})
    assert float(out["x"].abs().max()) == 0.0


def test_restore_onto_a_device_and_dtype(tmp_path):
    """A checkpoint restores into the structure and dtypes of the target
    tree, on the device asked for (JAX's reshard-on-load)."""
    save_checkpoint(str(tmp_path), 1, {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)})
    out, _ = restore_checkpoint(str(tmp_path), {"w": torch.empty(4, 4, dtype=torch.float64)},
                                device="cpu")
    assert out["w"].dtype == torch.float64 and out["w"].device.type == "cpu"
    assert torch.equal(out["w"], torch.arange(16, dtype=torch.float64).reshape(4, 4))


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def test_checkpoints_pass_between_packages_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"params": {"w": jnp.asarray(w).astype(jnp.bfloat16), "s": jnp.asarray(w[0])},
             "step": jnp.int32(7)}
    for d in ("j", "t"):
        os.makedirs(tmp_path / d)
    jckpt.save_checkpoint(str(tmp_path / "j"), 2, jtree)
    like = {"params": {"w": torch.empty((3, 5), dtype=torch.bfloat16),
                       "s": torch.empty(5)}, "step": torch.empty((), dtype=torch.int32)}
    got, manifest = restore_checkpoint(str(tmp_path / "j"), like, device="cpu")
    assert [n for n, _ in tree_flatten_with_paths(got)] == list(manifest["leaves"])
    for (name, t), (path, a) in zip(tree_flatten_with_paths(got),
                                    jax.tree_util.tree_flatten_with_path(jtree)[0]):
        a = np.asarray(a)
        assert name == "/".join(str(k.key) for k in path)
        np.testing.assert_array_equal(_bits(t), a.view(np.int16) if a.dtype.name == "bfloat16"
                                      else a)

    save_checkpoint(str(tmp_path / "t"), 2, got)
    back, tman = jckpt.restore_checkpoint(str(tmp_path / "t"), jtree)
    assert tman["leaves"] == manifest["leaves"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))


CROSS_ARCH = "mamba2_370m"


def _jcfg(tmp, steps):
    return JTrainerConfig(steps=steps, seq_len=32, global_batch=4, ckpt_dir=str(tmp),
                          ckpt_every=4, hyper=JHyper(peak_lr=3e-3, warmup_steps=2,
                                                     total_steps=7))


def test_port_trainer_continues_a_jax_checkpoint_as_jax_does(tmp_path):
    jcfg = jsmoke(CROSS_ARCH)
    JTrainer(jcfg, _jcfg(tmp_path / "shared", 4)).run()
    assert latest_step(str(tmp_path / "shared")) == 4
    shutil.copytree(tmp_path / "shared", tmp_path / "jax")
    jhist = JTrainer(jcfg, _jcfg(tmp_path / "jax", 7)).run()

    tcfg = TrainerConfig(steps=7, seq_len=32, global_batch=4, ckpt_dir=str(tmp_path / "shared"),
                         ckpt_every=4, hyper=TrainHyper(peak_lr=3e-3, warmup_steps=2,
                                                        total_steps=7))
    tr = Trainer(get_smoke_arch(CROSS_ARCH), tcfg, device="cpu")
    assert tr.step == 4
    thist = tr.run()
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [4, 5, 6]
    for t, j in zip(thist, jhist):
        assert abs(t["loss"] - j["loss"]) <= TRAIN_TOL["bfloat16"]["loss_rel"] * j["loss"], (t, j)
        assert t["lr"] == pytest.approx(j["lr"], rel=1e-6)

    # ... and the port's checkpoint of step 7 restores in JAX, bit for bit.
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    jstate, _ = jckpt.restore_checkpoint(str(tmp_path / "shared"),
                                         {"params": jparams, "opt": jadamw_init(jparams)}, 7)
    ours = dict(tree_flatten_with_paths({"params": tr.params, "opt": tr.opt_state}))
    for path, a in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        a = np.asarray(a)
        np.testing.assert_array_equal(_bits(ours[name]),
                                      a.view(np.int16) if a.dtype.name == "bfloat16" else a)


def test_launch_train_smoke_on_the_cpu_prints_its_json_line(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite_8b", "--smoke",
         "--device", "cpu", "--steps", "3", "--seq", "16", "--batch", "2",
         "--ckpt-dir", str(tmp_path), "d_ff=64"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(line) == ["arch", "first_loss", "last_loss", "mean_step_s", "steps"]
    assert line["arch"] == "granite8b-smoke" and line["steps"] == 3
    assert np.isfinite(line["first_loss"]) and np.isfinite(line["last_loss"])
    assert latest_step(str(tmp_path)) == 3
