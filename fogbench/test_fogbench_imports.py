"""What the benchmark's files import.

Nothing under ``fogbench/`` imports JAX, jaxlib, flax or the JAX package
``repro``, compared by whole top-level names (``repro_torch`` is the
program, not ``repro``); nothing under ``fogbench/reference/`` or
``fogbench/traffic/`` imports the program either.
"""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(HERE)) for p in FILES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("part", ["reference", "traffic"])
def test_yardstick_imports_nothing_of_the_program(part):
    for path in sorted((HERE / part).rglob("*.py")):
        assert "repro_torch" not in top_level_imports(path), path
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_check_compares_whole_names():
    from fogbench import harness

    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "repro")
    import sys
    sys.modules.setdefault("repro_torch_fake_probe", object())
    try:
        assert "repro_torch_fake_probe" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_fake_probe", None)
