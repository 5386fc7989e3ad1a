"""What the benchmark may import: no file under ``benchmark/`` imports
``jax``, ``jaxlib``, ``flax`` or ``dpcx`` (top-level names compared whole,
so ``dpcx_torch`` is not ``dpcx``), and the reference imports nothing of
the port either."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dpcx"}
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "__import__", "import_module") and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_sources_found():
    assert len(SOURCES) > 20
    assert HERE / "reference" / "model.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_nor_dpcx(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "dpcx_torch" not in top_level_imports(path)


def test_the_check_tells_the_names_apart(tmp_path):
    src = tmp_path / "x.py"
    src.write_text("import dpcx_torch.train\nfrom jax import numpy\n"
                   "import importlib\nimportlib.import_module('flax.linen')\n")
    assert top_level_imports(src) == {"dpcx_torch", "jax", "importlib",
                                      "flax"}
