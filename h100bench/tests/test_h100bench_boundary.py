"""What the harness may import: nothing of the JAX package or its stack
anywhere, and in the reference nothing of the port either. Top-level names
are compared whole: ``calciumgan_tpu_torch`` begins with
``calciumgan_tpu`` and is the program under test."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from h100bench import run

HARNESS = Path(__file__).resolve().parents[1]
REFERENCE_MAY_IMPORT = {"__future__", "math", "torch", "h100bench"}


def imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def reference_modules(path: Path) -> set:
    """The ``h100bench`` modules a reference file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module == "h100bench":
            out.add("h100bench")
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(HARNESS.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HARNESS)))
def test_no_jax_anywhere(path):
    assert not imported_top_names(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HARNESS / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imported_top_names(path) <= REFERENCE_MAY_IMPORT
    for module in reference_modules(path) - {"__future__"}:
        if module.startswith("h100bench"):
            assert module.startswith("h100bench.reference"), module


def test_top_level_names_are_compared_whole():
    names = imported_top_names(HARNESS / "loops" / "train.py")
    assert "calciumgan_tpu_torch" in names
    assert "calciumgan_tpu" not in names
    assert "calciumgan_tpu_torch" not in run.FORBIDDEN


def test_forbidden_modules_reads_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "calciumgan_tpu_torch_x",
                        types.ModuleType("calciumgan_tpu_torch_x"))
    assert "calciumgan_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen",
                        types.ModuleType("flax.linen"))
    assert run.forbidden_modules() == ["flax"]
