"""What every driver shares: the run's arguments, the process group of a
cell on several cards, the per-layer metrics' context, and the result."""

from __future__ import annotations

import dataclasses
import datetime
import math
import sys

from benchmark.manifest import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "dpcx")
GROUP_TIMEOUT_S = 300  # a rank that waits longer in a collective fails


@dataclasses.dataclass
class Run:
    """One run of one cell: ``rank`` of ``world`` processes, one card
    each (``port``: the group's rendezvous on localhost)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t_start: float
    rank: int = 0
    world: int = 1
    port: int = 0
    device: str = "cuda"

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def mark(self, phase: str) -> None:
        """The set-up's seconds so far, at the end of ``phase``, on
        standard error."""
        import time

        if self.lead:
            print(f"setup {phase}: {time.time() - self.t_start:.3f} s",
                  file=sys.stderr, flush=True)

    def torch_device(self):
        import torch

        if self.device == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.rank)

    def join(self) -> None:
        """Join the cell's process group (NCCL on cards, gloo on the
        CPU), where it has more than one process."""
        import torch
        import torch.distributed as dist

        if self.world == 1:
            return
        if self.device != "cpu":
            torch.cuda.set_device(self.torch_device())
        dist.init_process_group(
            "gloo" if self.device == "cpu" else "nccl",
            init_method=f"tcp://localhost:{self.port}", rank=self.rank,
            world_size=self.world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

    def leave(self) -> None:
        import torch.distributed as dist

        if self.world > 1 and dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader may read: the traced window's
    ``trace``, the ``units`` (steps or calls) it held, the cell's
    settings, and its per-unit work: ``rows`` samples a chip, ``renders``
    renders with ``weights`` (point weights) or not."""

    trace: object
    units: int
    settings: dict
    rows: int
    renders: int
    weights: bool

    @property
    def unit_s(self) -> float:
        return self.trace.window_s / self.units

    def layer_s_per_unit(self, names) -> float:
        layers = self.trace.layers()
        return sum(layers[n] for n in names) / self.units


def end_to_end(cell: Cell, values: dict) -> dict:
    """The cell's end-to-end metrics out of ``values``, by base name: a
    metric named ``<base>.<group>`` (``train_samples_per_s.dp``) is
    ``<base>`` measured alike, bounded apart for its group of cells."""
    out = {}
    for m in cell.end_to_end:
        base = m["name"].partition(".")[0]
        if base in values:
            out[m["name"]] = {"value": values[base], "unit": m["unit"]}
    return out


def per_layer(cell: Cell, ctx: MetricContext) -> dict:
    """Every per-layer metric of the cell whose reader found something to
    read."""
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one this benchmark must not
    load (compared whole: ``dpcx_torch`` is not ``dpcx``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(run: Run, peak_bytes: int, traced=None) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.world, "memory_peak_bytes": int(peak_bytes)}
    if traced is not None:
        info["busy_s"], info["window_s"] = traced
    return info


def _plain(x):
    """A number as JSON can hold it (a non-finite one as its name)."""
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its ``checks`` last."""
    import json

    checks = result.pop("checks")
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    result["checks"] = {k: {"value": _plain(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    print(json.dumps(result), flush=True)
