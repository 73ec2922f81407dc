"""Runs of the example drivers, shared by ``test_torch_examples.py`` and
``test_torch_examples_train.py``: the JAX package's (``examples/*.py``) and
the port's (``repro_torch.examples``, with ``--device cpu``), each in this
process, as their standard output lines.  Not a test module."""
import contextlib
import io
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def jax_example(name: str, args: list[str]) -> list[str]:
    """Standard output lines of ``examples/<name>.py`` run with ``args``."""
    out, argv = io.StringIO(), sys.argv
    sys.argv = [name] + args
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(ROOT / "examples" / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv = argv
    return out.getvalue().splitlines()


def port_example(module, args: list[str]) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(args + ["--device", "cpu"])
    return out.getvalue().splitlines()
