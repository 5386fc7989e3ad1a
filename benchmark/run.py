"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its traffic
mix names the driver (``benchmark/drivers/<driver>.py``) that runs it. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), ``breakdown`` with ``--trace 1``, and
last ``checks``, each number that decided ``correct`` beside its limit;
the same numbers are the last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits 2. A cell on several cards runs one process a
card: this one is rank 0 and prints the result, the others are started
here (``--rank``) and waited for. A run in which any rank has loaded
``jax``, ``jaxlib``, ``flax`` or ``dpcx`` prints no result and exits 3
(a rank other than 0 exits 3, and rank 0 then prints nothing).

Build and kernel caches stay inside the checkout: the port builds its
kernels into ``build/``, and ``TRITON_CACHE_DIR`` defaults to
``build/triton``.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import harness, manifest  # noqa: E402

CHILD_WAIT_S = 120


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards, started by rank 0
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--root", default=str(manifest.ROOT),
                   help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def execute(run: harness.Run) -> dict | None:
    """Run the cell's driver in this process."""
    driver = importlib.import_module(
        f"benchmark.drivers.{run.cell.traffic['driver']}")
    return driver.run(run)


def spawn(entry: list[str], argv: list[str],
          run: harness.Run) -> list[subprocess.Popen]:
    """The other ranks of ``run``'s group: ``python <entry> <argv>`` with
    each one's rank; their output goes to standard error."""
    procs = []
    for rank in range(1, run.world):
        cmd = [sys.executable, *entry, *argv, "--rank", str(rank),
               "--world", str(run.world), "--port", str(run.port)]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr))
    return procs


def reap(procs: list[subprocess.Popen], timeout: float) -> list[int]:
    """Wait for every process, ending those still running after
    ``timeout`` seconds; -> their exit codes."""
    deadline = time.time() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(max(deadline - time.time(), 0.1)))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def main(argv=None, entry=("-m", "benchmark.run")) -> int:
    """Run the cell; ``entry`` starts this program again for the other
    ranks of a cell on several cards."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    root = Path(args.root)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(root / "build" / "triton"))
    cell = manifest.cell(args.workload, root)
    import torch

    if args.device != "cpu" and (not torch.cuda.is_available()
                                 or torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); {found} "
              "found: nothing measured", file=sys.stderr)
        return 2
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=T_START,
                      rank=args.rank, world=args.world or cell.chips,
                      port=args.port, device=args.device)
    procs = []
    if run.world > 1 and run.lead:
        run.port = run.port or free_port()
        procs = spawn(list(entry), argv, run)
    try:
        result = execute(run)
    finally:
        codes = reap(procs, CHILD_WAIT_S)
    bad = harness.forbidden_modules()
    if bad:
        print(f"rank {run.rank} of the run loaded {bad}: no result",
              file=sys.stderr)
        return 3
    if not run.lead:
        return 0
    if any(codes):
        print(f"ranks 1-{run.world - 1} exited with {codes}: no result",
              file=sys.stderr)
        return 1
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
