"""``syncs_per_step`` on a fixture trace: it counts the CUDA runtime's
synchronising calls inside the traced window over its units, leaves out
launches, copies, event records and the calls outside the window, and
reads nothing from a trace that holds no host call."""

from __future__ import annotations

import pytest

from benchmark import harness, manifest
from benchmark.trace import Trace


def x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


KERNELS = [x("splat_kernel", "kernel", 100, 400),
           x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 600, 2),
           x("blur_slab_kernel", "kernel", 700, 300)]  # window 100-1000 us
CALLS = [
    x("cudaLaunchKernel", "cuda_runtime", 110, 5),
    x("cudaMemcpyAsync", "cuda_runtime", 590, 8),
    x("cudaStreamSynchronize", "cuda_runtime", 598, 10),
    x("cudaEventRecord", "cuda_runtime", 650, 2),
    x("cudaLaunchKernel", "cuda_runtime", 690, 5),
    x("cudaEventSynchronize", "cuda_runtime", 800, 5),
    x("cudaDeviceSynchronize", "cuda_runtime", 990, 20),
    x("cudaStreamSynchronize", "cuda_runtime", 20, 10),  # before the window
    x("cudaDeviceSynchronize", "cuda_runtime", 1005, 3),  # after it
]


def ctx_of(events, units):
    return harness.MetricContext(trace=Trace(events), units=units,
                                 settings={}, rows=0, renders=0,
                                 weights=False)


def read(metric, ctx):
    return manifest.cell("car64_depth.train_b256").reader(metric)(ctx)


@pytest.mark.parametrize("metric,units", [("syncs_per_step.train", 2),
                                          ("syncs_per_step.dp", 3)])
def test_counts_the_syncs_inside_the_window(metric, units):
    ctx = ctx_of(KERNELS + CALLS, units)
    assert read(metric, ctx) == pytest.approx(3 / units)


def test_launches_and_copies_are_not_syncs():
    calls = [c for c in CALLS if not c["name"].endswith("Synchronize")]
    assert read("syncs_per_step.train", ctx_of(KERNELS + calls, 4)) == 0.0


def test_nothing_read_without_host_calls():
    assert read("syncs_per_step.train", ctx_of(KERNELS, 2)) is None
