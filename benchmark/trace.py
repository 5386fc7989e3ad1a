"""The traced window: ``torch.profiler`` over the window, its CUDA
activity alone, reduced to device operations and the host's CUDA calls on
one clock.

Recording the host's operators too slowed the training step's dispatch
about 1.8-fold (12.5 ms untraced against 22.4 ms traced at
car_64_depth's B 64), and the device's idle share with it, so the
profiler records the CUDA activity alone: kernels, copies, memsets, and
the CUDA runtime and driver calls. The window runs from the first device
operation's start to the last one's end; the busy time is the union of
the device operations. The trace is exported as Chrome JSON into the run's
temporary directory, read, and deleted.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

from benchmark import window
from benchmark.layers import layer_seconds

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
LAUNCH_PIECES = ("LaunchKernel", "GraphLaunch", "LaunchCooperativeKernel")
TOP = 10
NAME_CHARS = 160


class Trace:
    """A trace's events in seconds on the host's clock: ``device`` and
    ``host`` lists of ``(name, start, end)``, the window ``lo``, ``hi``
    they span, and the launch calls the host made inside it."""

    def __init__(self, events: list[dict]):
        def items(cats):
            return [(e["name"], e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6)
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in cats]

        self.device = items(DEVICE_CATS)
        if not self.device:
            raise ValueError("the trace holds no device operation")
        self.lo = min(s for _, s, _ in self.device)
        self.hi = max(e for _, _, e in self.device)
        self.host = [i for i in items(HOST_CATS)
                     if self.lo <= i[1] < self.hi]
        self.launches = sum(1 for name, _, _ in self.host
                            if any(p in name for p in LAUNCH_PIECES))

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return window.busy([(s, e) for _, s, e in self.device], self.lo,
                           self.hi)

    def op_seconds(self) -> dict[str, float]:
        """Device seconds by operation name."""
        out: dict[str, float] = {}
        for name, s, e in self.device:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def layers(self) -> dict[str, float]:
        return layer_seconds(list(self.op_seconds().items()))

    def host_label(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host call or
        operation around it, within the outermost."""
        around = [(e - s, name) for name, s, e in self.host if s <= t < e]
        if not around:
            return "host outside CUDA calls"
        inner = min(around)[1]
        outer = max(around)[1]
        return inner if inner == outer else f"{inner} in {outer}"

    def breakdown(self) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each labelled by what the host was doing at its middle."""
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(window.gaps([(s, e) for _, s, e in self.device],
                                  self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:TOP]
        return {
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[self.host_label((a + b) / 2)[:NAME_CHARS], b - a]
                          for a, b in idle],
        }


@contextlib.contextmanager
def traced(holder: list):
    """Profile the block's CUDA activity; on exit append its ``Trace`` to
    ``holder``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.append(Trace(events))
