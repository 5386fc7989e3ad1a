"""Renderer cells: ``pointcloud_project_fn`` as the GT-pose loss calls it,
forward and backward into the points, every call dispatched ahead with no
host sync.

Set-up draws ``input_sets`` sets of clouds, cameras and cotangents from the
seed and warms the call up ``warmup_calls`` times. The window cycles
through the sets until ``--seconds`` have passed, then synchronises:
``render_mpts_per_s`` is renders x points of every call over the
window's seconds. The window keeps the outputs of a sample of its calls,
every ``check_stride``-th from an offset drawn from the seed (at most
``check_calls``) and the last; once it has closed, the reference renders
each sampled call's inputs and judges its silhouettes, depths and point
gradients. With ``--trace 1`` the window is ``trace_calls`` calls under
the profiler.
"""

from __future__ import annotations

import gc
import time

from benchmark import check, data, harness, trace, window
from benchmark.drivers.train import config
from benchmark.reference import exact_f32, render

TAKES = 3


def run(r: harness.Run) -> dict:
    return measure(r)[0]


def measure(r: harness.Run) -> tuple[dict, dict]:
    """(the run's result, every number over the sampled calls)."""
    import torch

    from dpcx_torch.render.project import pointcloud_project_fn

    t = r.cell.traffic
    settings = r.cell.settings()
    cfg = config(settings)
    device = r.torch_device()
    cuda = device.type == "cuda"
    R, N, D = t["renders"], cfg.pc_num_points, cfg.vox_size
    sets = data.clouds(r.seed, t["input_sets"], R, N, device)
    cts = data.cotangents(r.seed, t["input_sets"], R, D, device)
    sigma = torch.tensor(cfg.pc_relative_sigma, device=device)
    r.mark("inputs")

    def call(i: int):
        inp, ct = sets[i % len(sets)], cts[i % len(cts)]
        pts = inp["points"].detach().requires_grad_(True)
        out = pointcloud_project_fn(cfg, pts, inp["quats"], sigma)
        outs, grads = [out.silhouette], [ct["silhouette"]]
        if out.depth is not None:
            outs.append(out.depth)
            grads.append(ct["depth"])
        (g,) = torch.autograd.grad(outs, pts, grads)
        return {"silhouette": out.silhouette.detach(),
                "depth": None if out.depth is None else out.depth.detach(),
                "grad": g}

    for i in range(t["warmup_calls"]):
        call(i)
    if cuda:
        torch.cuda.synchronize(device)
    r.mark("warm-up")
    stride = t["check_stride"]
    offset = r.seed % stride
    kept: dict[int, dict] = {}
    setup_s = time.time() - r.t_start
    t0 = time.perf_counter()
    calls = 0
    holder: list = []
    if r.trace and cuda:
        for _ in range(TAKES):
            with trace.traced(holder):
                for i in range(t["trace_calls"]):
                    out = call(i)
                    if i % stride == offset and len(kept) < t["check_calls"]:
                        kept[i] = out
            calls = t["trace_calls"]
            kept[calls - 1] = out
            if holder[-1].device:
                break
        else:
            raise RuntimeError("the profiler recorded no device operation "
                               f"in {TAKES} traced windows")
    else:
        while True:
            out = call(calls)
            if calls % stride == offset and len(kept) < t["check_calls"]:
                kept[calls] = out
            calls += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        kept[calls - 1] = out
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    busy = (holder[-1].busy_s, holder[-1].window_s) if holder else None
    del out
    gc.collect()

    numbers: dict[str, float] = {}
    failed = 0
    limits = r.cell.workload.get("limits", {})
    with exact_f32():
        for i, got in sorted(kept.items()):
            inp, ct = sets[i % len(sets)], cts[i % len(cts)]
            pts = inp["points"].detach().requires_grad_(True)
            sil, depth = render.render(settings, pts, inp["quats"], sigma)
            outs, grads = [sil], [ct["silhouette"]]
            if depth is not None:
                outs.append(depth)
                grads.append(ct["depth"])
            (g,) = torch.autograd.grad(outs, pts, grads)
            nums = check.render_numbers(got, {"silhouette": sil.detach(),
                                              "depth": None if depth is None
                                              else depth.detach(),
                                              "grad": g})
            failed += not check.verdict(nums, limits)[0]
            numbers = {k: max(v, numbers.get(k, v)) for k, v in nums.items()}
    ok, checks = check.verdict(numbers, limits)

    metrics, result = {}, {}
    if cuda and not r.trace:
        values = {"render_mpts_per_s": window.rate(calls * R * N / 1e6,
                                                   window_s),
                  "setup_s": setup_s}
        metrics = harness.end_to_end(r.cell, values)
    elif cuda:
        ctx = harness.MetricContext(trace=holder[-1], units=calls,
                                    settings=settings, rows=0, renders=R,
                                    weights=False)
        metrics = harness.per_layer(r.cell, ctx)
        result["breakdown"] = holder[-1].breakdown()
    return {
        "correct": ok,
        "attempted": calls,
        "failed": failed,
        "metrics": metrics,
        "device": (harness.device_info(r, peak, busy) if cuda
                   else {"platform": "cpu", "count": 1}),
        **result,
        "checks": checks,
    }, numbers
