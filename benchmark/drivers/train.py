"""Training cells: dpcx's GT-pose training as ``cli train`` runs it, on
records resident on the card: chunks of ``train_steps_scan`` steps
(``train_steps_scan_dp`` over a group of several cards), each chunk's
metrics read back as ``train`` reads them, no checkpoints.

The chunk is ``train``'s: ``min(log_every, save_every, eval_every or
save_every)`` steps. Set-up makes the records and the weights from the
seed, builds the training state once, and drives it through its first
``check_steps`` steps, one call each; the same state then warms up for
``warmup_chunks`` chunks and runs the window. The first steps' losses, the first gradient
(from Adam's first moment after one step), the parameters after them, and
the first step's points and renders (its renderer call, recorded as the
loss makes it) are what the reference judges, once the window has closed
and the state is freed.

Window (``--trace 0``): chunks until ``--seconds`` have passed, ended by
the last chunk's read-back. ``train_samples_per_s`` is every batch row of
the window, over all ranks, over its seconds (``.dp``: the same, bounded
apart for a cell on several cards); ``train_step_p95_ms`` the 95th
percentile of the times between consecutive step ends, each a CUDA
event recorded after the step's Adam by an optimizer hook (no host sync).
With ``--trace 1`` the window is ``trace_chunks`` chunks under the
profiler, and the per-layer metrics are read from it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time

from benchmark import check, data, harness, trace, window
from benchmark.reference import exact_f32, model, prng

BETA1 = 0.9  # the port's Adam (optax.adam's defaults)
TAKES = 3  # traced windows tried where the profiler lost the device's


def config(settings: dict):
    from dpcx_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in settings.items() if k in names})


def read(metrics: dict) -> dict[str, float]:
    """A chunk's metrics on the host, as ``train`` logs them."""
    return {k: float(v) for k, v in metrics.items()}


def agree(run: harness.Run, flag: bool, device, op="broadcast") -> bool:
    """Rank 0's ``flag`` (``op`` "min": every rank's) on every rank."""
    if run.world == 1:
        return flag
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag)], device=device)
    if op == "min":
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
    else:
        dist.broadcast(t, 0)
    return bool(t.item())


@contextlib.contextmanager
def own_weights_only():
    """The model's own init left out inside the block (flax's
    ``lecun_normal`` on threefry, some 10 s on the card for 58M
    parameters): the benchmark overwrites every parameter with the
    weights it draws from the seed."""
    from dpcx_torch.models import model_pc

    init = getattr(model_pc, "flax_init_", None)
    if init is not None:
        model_pc.flax_init_ = lambda model, seed: model
    try:
        yield
    finally:
        if init is not None:
            model_pc.flax_init_ = init


@dataclasses.dataclass
class Program:
    """The training state the window drives, and its inputs."""

    cfg: object
    state: object
    named: dict
    records: dict
    start: dict  # the weights the state began from
    key: tuple
    steps: object  # n -> the last step's metrics


def build(r: harness.Run, settings: dict, device) -> Program:
    """The records and the weights from the seed, and one training state
    on them (over the group's ranks where it has several)."""
    import torch
    import torch.distributed as dist

    from dpcx_torch.parallel.mesh import make_mesh
    from dpcx_torch.train import (
        create_state,
        train_steps_scan,
        train_steps_scan_dp,
    )

    t = r.cell.traffic
    cfg = config(settings)
    recs = data.records(r.seed, t["models"], t["views"], cfg.image_size,
                        cfg.mask_size, device)
    r.mark("records")
    with own_weights_only():
        state = create_state(cfg, device)
    named = dict(state.model.named_parameters())
    r.mark("the program's training state")
    w0 = data.weights(r.seed, {k: tuple(p.shape) for k, p in named.items()},
                      device)
    if r.world > 1:  # rank 0's inputs on every rank, as train's state
        for v in list(recs.values()) + list(w0.values()):
            dist.broadcast(v, 0)
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(w0[k])
    key = prng.prng_key(r.seed + 1)
    mesh = (make_mesh(cfg, ranks=range(r.world), device=device)
            if r.world > 1 else None)

    def steps(n: int) -> dict:
        if mesh is None:
            return train_steps_scan(cfg, state, recs, key, n)
        return train_steps_scan_dp(cfg, state, recs, key, n, mesh)

    return Program(cfg, state, named, recs, w0, key, steps)


@contextlib.contextmanager
def observed(calls: list, views: int):
    """The GT-pose loss's renderer calls inside the block, each recorded
    as it is made: {"points" (the model's points, every ``views``-th of
    the call's clouds: one a sample), "silhouette", "depth"}, detached
    copies. The call is the program's, unchanged."""
    from dpcx_torch.models import losses

    fn = losses.pointcloud_project_fn

    def recording(cfg, points, quat, *a, **k):
        out = fn(cfg, points, quat, *a, **k)
        calls.append({
            "points": points.detach()[::views].float().clone(),
            "silhouette": out.silhouette.detach().float().clone(),
            "depth": None if out.depth is None
            else out.depth.detach().float().clone()})
        return out

    losses.pointcloud_project_fn = recording
    try:
        yield
    finally:
        losses.pointcloud_project_fn = fn


def first_steps(p: Program, n: int, views: int) -> dict:
    """``n`` steps, one call each: {"losses", "grad1" (from Adam's first
    moment after the first step), "params" (after the last), "first" (the
    first step's renderer call as ``observed`` records it, or None)}."""
    import torch

    opt = p.state.optimizer
    losses, grad1, calls = [], None, []
    for i in range(n):
        with observed(calls, views) if i == 0 else contextlib.nullcontext():
            losses.append(read(p.steps(1))["loss_total"])
        if grad1 is None:
            grad1 = {k: opt.state[w]["exp_avg"].detach() / (1 - BETA1)
                     if opt.state.get(w) else torch.zeros_like(w)
                     for k, w in p.named.items()}
    return {"losses": losses, "grad1": grad1,
            "params": {k: w.detach().clone() for k, w in p.named.items()},
            "first": calls[0] if len(calls) == 1 else None}


def judged_points(prog: dict, rows: int):
    """The program's first-step points, where it made ``rows`` of them
    (the reference renders them to judge the program's renders), else
    None."""
    first = prog.get("first")
    if first is None or first["points"].shape[0] != rows:
        return None
    return first["points"]


def reference(settings: dict, p: Program, n: int, ranks: int,
              operand: str = "float32", points=None) -> dict:
    """The reference's first ``n`` steps on the program's inputs, and its
    first step's outputs (``model.first_outputs``; the renders of
    ``points``, the program's, where given)."""
    with exact_f32():
        out = model.train_steps(settings, p.start, p.records, p.key, n,
                                ranks=ranks, operand=operand)
        out["first"] = model.first_outputs(settings, p.start, p.records,
                                           p.key, ranks, points, operand)
    return out


def run(r: harness.Run) -> dict | None:
    import torch
    import torch.distributed as dist

    t = r.cell.traffic
    settings = r.cell.settings()
    device = r.torch_device()
    cuda = device.type == "cuda"
    r.join()
    r.mark("process group")
    p = build(r, settings, device)
    r.mark("weights")
    cfg, state, steps = p.cfg, p.state, p.steps
    views = min(cfg.views_per_step, t["views"])
    prog = first_steps(p, t["check_steps"], views)
    r.mark("first steps")
    chunk = max(1, min(cfg.log_every, cfg.save_every,
                       cfg.eval_every or cfg.save_every))  # train's chunk
    for _ in range(t["warmup_chunks"]):
        read(steps(chunk))
    r.mark("warm-up")

    ends, start = [], None
    hook = None
    if cuda and r.lead and not r.trace:
        def on_step(opt, args, kwargs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)

        hook = state.optimizer.register_step_post_hook(on_step)
        start = torch.cuda.Event(enable_timing=True)
    if cuda:
        torch.cuda.synchronize(device)
    agree(r, True, device)
    setup_s = time.time() - r.t_start
    if start is not None:
        start.record()
    t0 = time.perf_counter()
    done = failed = 0
    holder: list = []
    if r.trace and cuda:
        for _ in range(TAKES):
            with trace.traced(holder):
                for _ in range(t["trace_chunks"]):
                    read(steps(chunk))
            done = t["trace_chunks"] * chunk
            if agree(r, bool(holder[-1].device), device, op="min"):
                break
        else:
            raise RuntimeError("the profiler recorded no device operation "
                               f"in {TAKES} traced windows")
    else:
        while True:
            rec = read(steps(chunk))
            done += chunk
            if not math.isfinite(rec["loss_total"]):
                failed += chunk
            if not agree(r, time.perf_counter() - t0 < r.seconds, device):
                break
    if cuda:
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    if hook is not None:
        hook.remove()

    peak = 0
    if cuda:
        peak_t = torch.tensor([torch.cuda.max_memory_allocated(device)],
                              device=device)
        if r.world > 1:
            dist.all_reduce(peak_t, op=dist.ReduceOp.MAX)
        peak = int(peak_t.item())
    busy = None
    if holder:
        tr = holder[-1]
        busy_t = torch.tensor([tr.busy_s], device=device,
                              dtype=torch.float64)
        if r.world > 1:
            dist.all_reduce(busy_t)
        busy = (float(busy_t.item()) / r.world, tr.window_s)
    del state, steps
    p.state = p.named = p.steps = None  # the program's state is freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    r.leave()
    if not r.lead:
        return None

    ref = reference(settings, p, t["check_steps"], r.world,
                    points=judged_points(prog, cfg.batch_size // r.world))
    numbers = check.train_numbers(prog, ref, p.start)
    ok, checks = check.verdict(numbers, r.cell.workload.get("limits", {}))

    metrics, result = {}, {}
    rows = cfg.batch_size // r.world
    if cuda and not r.trace:
        step_ms = window.step_times_ms(
            [0.0] + [start.elapsed_time(e) for e in ends])
        values = {
            "train_samples_per_s": window.rate(done * cfg.batch_size,
                                               window_s),
            "train_step_p95_ms": window.p95(step_ms),
            "setup_s": setup_s,
        }
        metrics = harness.end_to_end(r.cell, values)
    elif cuda:
        ctx = harness.MetricContext(
            trace=holder[-1], units=done, settings=settings, rows=rows,
            renders=rows * views,
            weights=cfg.pc_point_dropout < 1.0)
        metrics = harness.per_layer(r.cell, ctx)
        result["breakdown"] = holder[-1].breakdown()
    result = {
        "correct": ok and failed == 0,
        "attempted": done,
        "failed": failed,
        "metrics": metrics,
        "device": (harness.device_info(r, peak, busy) if cuda
                   else {"platform": "cpu", "count": r.world}),
        **result,
        "checks": checks,
    }
    return result
