"""Profiling and tracing harness (port of ``dpcx/utils/profiling.py``):
``torch.profiler`` traces, and a host-clock benchmark helper."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path
from typing import Callable

import torch


def _synchronize() -> None:
    """Wait for the card, where anything has run on it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark_fn(
    fn: Callable[[], object],
    iters: int = 20,
    warmup: int = 2,
) -> dict[str, float]:
    """Time a nullary fn by the host clock; returns seconds/iter and
    iters/sec. The card is synchronised before each read of the clock, so
    the time covers the work and not its enqueue. For a kernel's device
    time use ``dpcx_torch.utils.timing.bench_scan`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _synchronize()
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_iter": dt, "iters_per_sec": 1.0 / dt}


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """``torch.profiler`` trace of the block: CPU activity, and CUDA
    activity where there is a card. The card is synchronised before the
    profiler stops, and one Chrome trace (``*.pt.trace.json``; open it in
    Perfetto, chrome://tracing or TensorBoard's profiler plugin) is
    written into ``log_dir`` (default: ``dpcx-trace`` in the temporary
    directory). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir or Path(tempfile.gettempdir()) / "dpcx-trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield log_dir
        finally:
            _synchronize()
    prof.export_chrome_trace(str(
        log_dir / f"dpcx_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
