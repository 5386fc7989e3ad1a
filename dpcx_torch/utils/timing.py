"""Device-side timing harness (port of ``dpcx/utils/timing.py``).

What holds on the card:

1. PyTorch returns before the card finishes, so a host clock around a
   call measures its enqueue. The device time is read from CUDA events
   recorded on the stream around the whole loop of ``iters`` iterations,
   and the host time from the clock after a synchronise.
2. The iterations run in one Python loop with a carry dependency, so each
   one reads the result of the one before; on one stream they run in
   order anyway, and the dependency keeps the work from being elided.
3. One untimed run of the loop comes first: it builds the CUDA kernels at
   their first launch (``dpcx_torch/_build.py``, nvcc) and fills the
   allocator's caches, so no timed window holds a build.
4. The card keeps no result cache: repeats run on the same operands.

On the CPU (the caller asks for it: ``torch.device("cpu")`` tensors) the
same loop is timed by the host clock alone.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch


@dataclasses.dataclass(frozen=True)
class ScanTimes:
    """Seconds per iteration, one entry per repeat: ``device`` from CUDA
    events (None on the CPU), ``host`` from the host clock around the
    synchronised loop."""

    device: list[float] | None
    host: list[float]

    @property
    def best(self) -> float:
        """The least device time per iteration (host time on the CPU)."""
        return min(self.host if self.device is None else self.device)

    @property
    def host_median(self) -> float:
        return statistics.median(self.host)


def scan_times(
    body,
    carry0: torch.Tensor,
    operands: tuple = (),
    iters: int = 100,
    repeats: int = 3,
) -> ScanTimes:
    """Time ``iters`` iterations of ``body``, ``repeats`` times, after one
    untimed run. ``body(carry, *operands) -> (new_carry, probe)``:
    new_carry must depend on the iteration's result, and the probes' sum
    is read back at the end of each run (the result is consumed inside the
    timed window)."""
    on_card = carry0.device.type == "cuda"

    def run():
        carry, total = carry0, None
        for _ in range(iters):
            carry, probe = body(carry, *operands)
            s = probe.detach().sum().float()
            total = s if total is None else total + s
        return total

    float(run())  # builds, warms
    device, host = [], []
    for _ in range(repeats):
        if on_card:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(carry0.device)
        t0 = time.perf_counter()
        if on_card:
            e0.record()
        total = run()
        if on_card:
            e1.record()
        float(total)  # reads the result: waits for the card
        host.append((time.perf_counter() - t0) / iters)
        if on_card:
            device.append(e0.elapsed_time(e1) * 1e-3 / iters)
    return ScanTimes(device if on_card else None, host)


def bench_scan(
    body,
    carry0: torch.Tensor,
    operands: tuple = (),
    iters: int = 100,
    repeats: int = 3,
) -> float:
    """Best-of-``repeats`` seconds per iteration of ``body`` (device time
    on the card): ``scan_times(...).best``."""
    return scan_times(body, carry0, operands, iters, repeats).best


def render_scan_times(
    cfg,
    pts: torch.Tensor,
    quat: torch.Tensor,
    sigma: torch.Tensor,
    iters: int = 100,
    backward: bool = False,
    repeats: int = 3,
) -> ScanTimes:
    """``scan_times`` of the standard renderer: the forward, or with
    ``backward`` the forward and the gradient of the silhouette sum with
    respect to the points."""
    from dpcx_torch.render.project import pointcloud_project_fn

    if backward:

        def body(carry, q, sg):
            p = carry.detach().requires_grad_()
            sil = pointcloud_project_fn(cfg, p, q, sg).silhouette
            (g,) = torch.autograd.grad(sil.sum(), p)
            return carry + g * 1e-9, g.sum()

    else:

        def body(carry, q, sg):
            with torch.no_grad():
                sil = pointcloud_project_fn(cfg, carry, q, sg).silhouette
            return carry + sil.sum() * 1e-17, sil.sum()

    return scan_times(body, pts, (quat, sigma), iters, repeats)


def render_throughput_mpts(
    cfg,
    pts: torch.Tensor,
    quat: torch.Tensor,
    sigma: torch.Tensor,
    iters: int = 100,
    backward: bool = False,
) -> float:
    """Mpoints splatted+projected per second for the standard renderer —
    forward, or forward + backward (grad wrt points) when ``backward``."""
    B, N = pts.shape[:2]
    sec = render_scan_times(cfg, pts, quat, sigma, iters, backward).best
    return B * N / sec / 1e6
