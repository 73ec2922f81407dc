"""Build the port's CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C launcher and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``).  A library's file name carries a hash of its source, the
shared headers beside it (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is not.  The
build runs at first use: one ``nvcc`` per source, all started together.
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA kernels "
        "are compiled on a machine with the CUDA toolkit"
    )


def sources() -> dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every kernel whose library is missing; returns each built
    kernel's ``nvcc`` log (register and shared-memory use from ``ptxas``).
    Raises with the log if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, src in sources().items():
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[name] for name in failed)
        )
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        src = sources()[name]
        if not library_path(src).exists():
            build_all()
        lib = ctypes.CDLL(str(library_path(src)))
        _LOADED[name] = lib
    return lib
