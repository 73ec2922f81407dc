"""Package rules of the port: no JAX, nothing of the JAX package, and a
counted wrapper for every CUDA kernel."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import build, ops

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


# Modules whose ports came late; each must be scanned and imported like the rest.
LATE_MODULES = ("core/distributed.py", "core/sharded.py", "core/workload.py",
                "utils/trees.py", "optim/adamw.py", "optim/schedule.py",
                "optim/grad_compress.py", "data/pipeline.py", "train/train_step.py",
                "train/trainer.py", "train/replay.py", "ckpt/checkpoint.py",
                "launch/train.py", "models/moe.py", "examples/quickstart.py",
                "examples/cityscale_cache_sim.py", "examples/serve_paged.py",
                "examples/train_lm.py", "configs/jamba_1_5_large_398b.py",
                "configs/internvl2_2b.py")


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for late in LATE_MODULES:
        assert ROOT / "src" / "repro_torch" / late in files, late
    bad = [(str(f.relative_to(ROOT)), root, line) for f in files
           for root, line in _imported_roots(f) if root in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    """Every module of the port imported in a fresh interpreter: neither
    JAX nor the JAX package is loaded."""
    modules = sorted(
        ".".join(f.relative_to(ROOT / "src").with_suffix("").parts)
        for f in (ROOT / "src" / "repro_torch").rglob("*.py") if f.name != "__init__.py")
    assert "repro_torch.models.ssm" in modules and "repro_torch.models.replay" in modules
    for late in LATE_MODULES:
        assert "repro_torch." + late[:-3].replace("/", ".") in modules, late
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_every_cuda_kernel_has_a_counted_wrapper():
    sources = build.sources()
    assert set(sources) == {"flic_insert", "flic_update", "flic_lookup", "flic_merge",
                            "paged_attention", "ssd_scan"}
    assert set(ops.LAUNCHES) == set(sources) | set(ops.SOURCE)
    for name, lib in ops.SOURCE.items():   # a second entry of another kernel's source
        assert lib in sources and callable(getattr(ops, name)), name
        assert re.search(rf'extern "C" int {name}_launch\(', sources[lib].read_text()), name
    for name, src in sources.items():
        text = src.read_text()
        assert callable(getattr(ops, name)), name
        assert re.search(rf'extern "C" int {name}_launch\(', text), name
        assert "Replaces the TPU kernel repro/kernels/" in text, name
        assert "What bounds it on the card" in text, name
    ops.reset_launches()
    assert set(ops.LAUNCHES.values()) == {0}


def test_kernels_build_for_hopper_into_an_ignored_directory():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "rows.cuh"\n')
    (tmp_path / "rows.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path(tmp_path / "k.cu")
    assert before == build.library_path(tmp_path / "k.cu")
    (tmp_path / "rows.cuh").write_text("// two\n")
    assert build.library_path(tmp_path / "k.cu") != before
    assert set(build.sources()) == {"k"}
