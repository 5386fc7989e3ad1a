"""The benchmark's parts, found by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration is ``benchmark/configs/<config>.json``, its traffic mix
``benchmark/traffic/<traffic>.json`` (the driver that runs it and its
parameters), and its limits on the numbers that decide ``correct``
``benchmark/workloads/<name>.json``. A per-layer metric is
``benchmark/metrics/<name>.py``, whose ``read(ctx)`` gives its value or
None; a metric ``<base>.<group>`` with no file of its own is read by
``<base>.py``. A metric is reported in the cells its ``workloads`` key lists, or
without the key in every cell that reports the metric it ``moves``. Adding
a cell, a configuration, a traffic mix or a metric is adding files and
entries: no code here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict      # the configuration file
    traffic: dict     # the traffic file
    workload: dict    # the cell's own file (limits)
    end_to_end: tuple  # BENCHMARK.json entries reported with --trace 0
    per_layer: tuple   # and with --trace 1
    root: Path

    def settings(self) -> dict:
        """The configuration as this cell runs it: the file's values with
        the traffic mix's ``config`` overrides (the batch)."""
        return {**self.config["config"], **self.traffic.get("config", {})}

    def reader(self, metric: str):
        """The ``read`` function of a per-layer metric's file (that of its
        base name where it has none of its own)."""
        here = self.root / "benchmark" / "metrics"
        path = here / f"{metric}.py"
        if not path.exists():
            path = here / f"{metric.partition('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest at ``root``."""
    root = Path(root)
    manifest = load(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    here = root / "benchmark"
    e2e = tuple(m for m in manifest["end_to_end"]
                if name in m.get("workloads", [name]))
    moved = {m["name"] for m in e2e}
    per = tuple(m for m in manifest["per_layer"]
                if (name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved))
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json(here / "configs" / f"{entry['config']}.json"),
                traffic=_json(here / "traffic" / f"{entry['traffic']}.json"),
                workload=_json(here / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per, root=root)
