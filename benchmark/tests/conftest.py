"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.
Tests marked ``cuda`` need a CUDA card and skip without one; on the card:
``python -m pytest benchmark/tests -q -m cuda``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark import manifest

FIXTURES = Path(__file__).resolve().parent / "fixtures"
TINY = ("tiny.train", "tiny.render", "tiny.train_dp2")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


def make_root(root: Path, cells: list[dict]) -> Path:
    """A checkout's benchmark at ``root``: this one's files, the fixtures'
    configuration, traffic mixes and limits, and ``cells`` added."""
    shutil.copytree(manifest.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for sub in ("configs", "traffic", "workloads"):
        for p in (FIXTURES / sub).glob("*.json"):
            shutil.copy(p, root / "benchmark" / sub / p.name)
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return add_cells(root, cells)


def add_cells(root: Path, cells: list[dict]) -> Path:
    """``cells`` added to the ``BENCHMARK.json`` at ``root``, each
    reporting the metrics of the first cell there with its driver and as
    one card or several."""
    bench = manifest.load(root)

    def kind(cell):
        traffic = json.loads((root / "benchmark" / "traffic"
                              / f"{cell['traffic']}.json").read_text())
        return traffic["driver"], cell["chips"] > 1

    for c in cells:
        like = next(w["name"] for w in bench["workloads"]
                    if kind(w) == kind(c))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(c["name"])
    bench["workloads"] += cells
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def tiny_cells() -> list[dict]:
    return [{"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
             "chips": 1, "why": "a CPU test's training cell"},
            {"name": "tiny.render", "config": "tiny",
             "traffic": "tiny_render", "chips": 1,
             "why": "a CPU test's renderer cell"},
            {"name": "tiny.train_dp2", "config": "tiny",
             "traffic": "tiny_train", "chips": 2,
             "why": "a CPU test's data-parallel cell, two gloo ranks"}]


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A checkout with the tiny fixture cells added as files alone."""
    return make_root(tmp_path_factory.mktemp("bench"), tiny_cells())
