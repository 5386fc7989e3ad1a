"""The manifest and the files it names: every cell, configuration, traffic
mix, limit file and per-layer metric loads by name; a cell added as files
alone is found; the manifest keeps to its contract's shape."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from benchmark import manifest
from benchmark.tests.conftest import add_cells, make_root

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = manifest.cell(name)
    assert cell.chips in (1, 4)
    assert cell.traffic["driver"] in ("train", "render")
    assert set(cell.workload["limits"]) and all(
        isinstance(v, float) for v in cell.workload["limits"].values())
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_holds_every_setting(entry):
    from dpcx_torch.config import Config, load_config

    doc = json.loads((manifest.ROOT / entry["file"]).read_text())
    fields = {f.name for f in dataclasses.fields(Config)}
    assert set(doc["config"]) == fields
    assert doc["source"] == entry["source"]
    assert doc["reduced"] == entry["reduced"] == []
    shipped = dataclasses.asdict(load_config(
        manifest.ROOT / "experiments" / f"{entry['name']}.yaml"))
    assert {k: list(v) if isinstance(v, tuple) else v
            for k, v in shipped.items()} == doc["config"]


def test_manifest_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for x in BENCH["workloads"] + BENCH["configs"] + metrics:
        assert NAME.match(x["name"]), x["name"]
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: set(m.get("workloads", CELLS))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        # a metric's cells report the end-to-end metric it moves
        assert set(m["workloads"]) <= e2e[m["moves"]]
    for w in CELLS:  # setup_s, one more end-to-end metric, a per-layer one
        assert sum(w in cells for cells in e2e.values()) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_cell_added_as_files_is_found(tmp_path):
    """A cell, traffic mix, limits and metric added as files and manifest
    entries alone: the harness finds them by name."""
    root = make_root(tmp_path, [])
    here = root / "benchmark"
    traffic = json.loads((here / "traffic" / "train_b64.json").read_text())
    traffic["config"]["batch_size"] = 32
    (here / "traffic" / "train_b32.json").write_text(json.dumps(traffic))
    add_cells(root, [{"name": "car64_depth.train_b32",
                      "config": "car_64_depth", "traffic": "train_b32",
                      "chips": 1, "why": "a fixture"}])
    (here / "workloads" / "car64_depth.train_b32.json").write_text(
        json.dumps({"limits": {"loss_gap": 0.1}}))
    (here / "metrics" / "steps_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps_seen", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "training loop",
        "moves": "train_samples_per_s",
        "workloads": ["car64_depth.train_b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.cell("car64_depth.train_b32", root)
    assert cell.settings()["batch_size"] == 32
    assert cell.settings()["vox_size"] == 64
    assert "steps_seen" in [m["name"] for m in cell.per_layer]
    assert cell.reader("steps_seen")(type("C", (), {"units": 7})()) == 7.0
    assert {m["name"] for m in cell.end_to_end} == {
        "train_samples_per_s", "train_step_p95_ms", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_end_to_end_by_base_name(name):
    """A metric ``<base>.<group>`` reports ``<base>``; a cell reports
    just its own metrics."""
    from benchmark import harness

    cell = manifest.cell(name)
    values = {"train_samples_per_s": 1.0, "train_step_p95_ms": 2.0,
              "render_mpts_per_s": 3.0, "setup_s": 4.0}
    out = harness.end_to_end(cell, values)
    assert set(out) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert out[m["name"]] == {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
