#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dpcx_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. build    — compile the CUDA kernels from dpcx_torch/csrc with nvcc,
              and print each kernel's stack frame and spills (ptxas).
2. kernel   — the fused splat->blur->DRC forward against its plain
              PyTorch version on the card: K1 at the car_64_depth training
              render shape (32 renders x 16000 points, D 64, with depth)
              and the chair_gt_pose one (64 x 8000, D 32, no depth); the
              counterpart of the depth-blocked K3 at the multicat_128_fused
              one (16 x 16000, D 128, no depth), at D 128 with depth (8
              renders) and at D 72.
3. backward — the backward kernels against autograd through the plain
              version for a random linear functional of sil and depth, at
              every shape of phase 2, with dropout weights: K2 at D <= 64;
              at D > 64 the counterpart of K4 + K5 with the saved grid and
              with the recompute (remat), each against plain and against
              each other.
4. serve    — experiments/car_64_depth.yaml at full width, seeded random
              weights, behind the HTTP server: 3 requests of 1, 16 and 20
              images (padding, chunking, uint8), checked against a direct
              ServingModel call and the /healthz counter.
5. score    — 8 served clouds scored by the GT-pose loss forward with
              renderer: pallas (one K1 launch) against 4 seeded views
              each, and the same loss rendered by the plain ops.
6. datagen  — `cli datagen` for car_64_depth, 32 models, GT views through
              K1, into a temporary data_dir.
7. parity   — 3 training steps with renderer: pallas (K1 + K2) against 3
              with renderer: xla (the plain ops) from the same init,
              batches and dropout generator, in float32: per-parameter
              first-step gradients and the three losses (the gradient
              reaching a point with an exactly integer grid coordinate is
              held at 0 on both sides, see phase_parity).
8. train    — `cli train` on car_64_depth for 200 steps (finite losses,
              the last 20 below the first 20, one K1 and one K2 launch per
              step), a resumed run of 10 more steps from step 200, and
              chair_gt_pose with renderer: pallas for 20 steps.
9. multicat — experiments/multicat_128_fused.yaml at full width (D 128,
              N 16000, B 4 x 4 views, no depth, GT pose): `cli datagen`
              (32 models, one D > 64 forward launch each), 3 kernel-vs-plain
              training steps (as phase 7), `cli train` for 100 steps (finite
              losses, the last 20 below the first 20, exactly one D > 64
              forward and one D > 64 backward launch per step, no D <= 64
              launch), and 3 steps with remat: true (two forward launches
              and one recompute backward per step) whose losses equal the
              first run's.
10. time    — CUDA-event medians: each forward and backward kernel
              against its plain version at the shapes of phase 2 (the
              recompute backward too); host-clock serve latency at batch
              16 and the median car_64_depth and multicat_128 training
              steps.
11. profile — torch.profiler device time per kernel, per call, of K1, K2,
              the D > 64 forward and backward, the scoring forward, the
              batch-16 ServingModel call and one training step of each of
              car_64_depth and multicat_128 (with its time by layer),
              beside the host time per call and the share of it in which
              the card is idle.

Data and checkpoints go to a temporary directory that is removed at the
end; the car_64_depth and multicat_128 runs' metrics.jsonl are copied to
chiprun_out/. The last lines are the run's seconds, the card's name and
power limit (nvidia-smi), a JSON line describing each kernel (its launches
on the main path, its largest error against its plain version, its time,
its plain version's time, and the least time the card could take for the
same work), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "experiments" / "car_64_depth.yaml"
CHAIR = REPO / "experiments" / "chair_gt_pose.yaml"
MULTICAT = REPO / "experiments" / "multicat_128_fused.yaml"
OUT_DIR = REPO / "chiprun_out"
KERNEL_ATOL = 1e-4  # atomics reorder the f32 splat sums from run to run
GRAD_RTOL = 1e-3  # backward vs plain: of the largest plain gradient, same
# reason; d ndc along an axis whose grid coordinate is an exact integer is
# 0 from the kernels (dpcx's _dhat_t) and one-sided from the plain
# version's floor: checked to be 0 there and not compared
LOSS_RTOL = 1e-4
TRAIN_RTOL = 1e-3  # kernel vs plain training: gradient L2 and losses
SEED = 0
DEVICE = "cuda"
TRAIN_STEPS, RESUME_STEPS, CHAIR_STEPS, MODELS = 200, 10, 20, 32
MULTICAT_STEPS, REMAT_STEPS = 100, 3
# the kernels of csrc/fused_render.cu, as torch.profiler names them
K1_STAGES = ("splat_kernel", "blur_yx_kernel", "zblur_drc_kernel")
# one H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores,
# and device memory; the renderer runs no tensor-core instruction
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 operations per item, counted from csrc/fused_render.cu: the splat
# per point (floors, fractions, 1 - t, 8 corners x (3 mults + 1 add)); the
# splat backward per point (the same hats, 8 corners x 4 sums x 3); DRC per
# cell (clip, p = o T, sil += p, T *= 1 - o; + 3 with depth) and its
# backward (the forward walk's T, phi, the suffix, dL/do); a blur pass costs
# a multiply and an add per in-range tap
SPLAT_OPS, SPLAT_BWD_OPS, DRC_OPS, DRC_BWD_OPS, DEPTH_OPS = 40, 108, 6, 14, 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def ptxas_report(log: str) -> list[tuple[str, int, int]]:
    """(kernel, stack frame bytes, spill store + load bytes) per function
    from nvcc's -Xptxas=-v output; a template kernel as name<D>."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", m.group(1))
            name = (m.group(1) if k is None else
                    k.group(1) + (f"<{k.group(2)}>" if k.group(2) else ""))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.append((name, int(m.group(1)),
                        int(m.group(2)) + int(m.group(3))))
            name = None
    return out


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median milliseconds of fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_ms(fn, runs: int = 20, warmup: int = 2) -> float:
    """Median host milliseconds of fn(), which must end synchronised."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn, label: str, runs: int = 20,
                   top: int = 8) -> list[tuple[str, float]]:
    """Print torch.profiler's device microseconds per call of fn(), summed
    and per kernel (memsets and copies included), beside the host
    microseconds per call measured without the profiler; return the
    per-kernel list, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def synced():
        fn()
        torch.cuda.synchronize()

    host_us = host_ms(synced, runs=runs) * 1e3
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(
        ((e.key, e.self_device_time_total / runs)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA
         # a user annotation (Optimizer.step#Adam.step) spans kernels
         # that are counted on their own
         and not getattr(e, "is_user_annotation", False)),
        key=lambda kv: -kv[1],
    )
    busy_us = sum(us for _, us in kernels)
    assert busy_us > 0, f"{label}: torch.profiler saw no device time"
    print(f"profile {label}: device {busy_us:.1f} us per call, host "
          f"{host_us:.1f} us per call, device idle "
          f"{max(0.0, 1 - busy_us / host_us):.1%}", flush=True)
    for name, us in kernels[:top]:
        print(f"  {us:9.1f} us {us / busy_us:6.1%}  {name[:90]}", flush=True)
    return kernels


def seeded_ndc(rng: np.random.Generator, renders: int, n: int) -> np.ndarray:
    """[R, 3, N] NDC clouds: half on a sphere shell (dense, saturating
    cells), half uniform over a box 20% wider than the grid (some points
    and corners out of the grid)."""
    shell = rng.normal(size=(renders, n // 2, 3))
    shell *= (0.3 / np.linalg.norm(shell, axis=-1, keepdims=True))
    box = rng.uniform(-0.6, 0.6, size=(renders, n - n // 2, 3))
    pts = np.concatenate([shell, box], axis=1)
    return np.ascontiguousarray(pts.transpose(0, 2, 1), dtype=np.float32)


def phase_kernel(cfg, fused, gauss) -> list[dict]:
    """Each forward shape against the plain version; one case per shape,
    with its max abs error."""
    rng = np.random.default_rng(SEED)
    shapes = [
        ("car_64_depth", 32, cfg.pc_num_points, cfg.vox_size, True),
        ("chair_gt_pose", 64, 8000, 32, False),
        ("multicat_128", 16, 16000, 128, False),
        ("multicat_128_depth", 8, 16000, 128, True),
        ("d72_depth", 4, 4000, 72, True),
    ]
    cases = []
    for name, renders, n, vox, with_depth in shapes:
        ndc = torch.from_numpy(seeded_ndc(rng, renders, n)).cuda()
        pw = torch.from_numpy(
            rng.uniform(0.0, 1.0, (renders, n)).astype(np.float32)
        ).cuda()
        radius = gauss.kernel_radius(
            max(cfg.pc_relative_sigma, cfg.pc_relative_sigma_end), vox,
            cfg.gauss_kernel_truncate,
        )
        sigma = torch.tensor(cfg.pc_relative_sigma * vox, device="cuda")
        args = (ndc, vox, sigma, radius)
        kw = dict(point_weights=pw, with_depth=with_depth)
        key = f"{fused.launch_family(vox)}_render"
        before = fused.LAUNCHES[key]
        sil_k, dep_k = fused.fused_project_t(*args, **kw)
        sil_p, dep_p = fused.fused_project_reference(*args, **kw)
        torch.cuda.synchronize()
        assert fused.LAUNCHES[key] == before + 1, (key, fused.LAUNCHES)
        assert sil_k.shape == (renders, vox, vox), sil_k.shape
        err = (sil_k - sil_p).abs().max().item()
        if with_depth:
            err = max(err, (dep_k - dep_p).abs().max().item())
        else:
            assert dep_k is None and dep_p is None
        print(f"kernel check {name} ({key}): {renders} renders x {n} "
              f"points, D {vox}, R {radius}, depth {with_depth}: max abs err "
              f"{err:.3e} (atol {KERNEL_ATOL}), mean sil "
              f"{sil_k.mean().item():.4f}", flush=True)
        assert np.isfinite(err) and err <= KERNEL_ATOL, err
        cases.append(dict(name=name, vox=vox, args=args, kw=kw, err=err))
    return cases


def linear_functional(rng, sil, depth):
    """Random cotangents (dsil, ddepth or None) of <dsil, sil> +
    <ddepth, depth>."""
    def like(t):
        return torch.from_numpy(
            rng.normal(size=tuple(t.shape)).astype(np.float32)).to(DEVICE)

    return like(sil), None if depth is None else like(depth)


def render_grads(render, ndc, pw, dsil, ddepth):
    """d/d(ndc) and d/d(weights) of the linear functional through
    render(ndc, pw) -> (sil, depth)."""
    ndc = ndc.detach().requires_grad_()
    pw = pw.detach().requires_grad_()
    sil, depth = render(ndc, pw)
    loss = (sil * dsil).sum()
    if depth is not None:
        loss = loss + (depth * ddepth).sum()
    return torch.autograd.grad(loss, (ndc, pw))


def check_grads(label, got, want, ndc, vox) -> float:
    """Kernel gradients (d ndc, d weights) against ``want``: max abs error
    within GRAD_RTOL of the largest |want|; d ndc along an axis whose grid
    coordinate is an exact integer must be 0 and is not compared."""
    coords = (ndc.flip(1) + 0.5) * vox - 0.5  # as fused._kernel_project
    on_int = (coords == coords.floor()).flip(1)
    worst = 0.0
    for name, a, b in zip(("d ndc", "d weights"), got, want):
        if name == "d ndc":
            assert (a[on_int] == 0).all(), (label, "integer coordinate")
            a, b = a[~on_int], b[~on_int]
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"backward check {label} {name}: max abs err {err:.3e}, max "
              f"|ref| {scale:.3e}, ratio {err / scale:.3e} (bound "
              f"{GRAD_RTOL}; {int(on_int.sum())} integer grid coordinates "
              "held at 0)", flush=True)
        assert np.isfinite(err) and scale > 0, (err, scale)
        assert err <= GRAD_RTOL * scale, (label, name, err, scale)
        worst = max(worst, err)
    return worst


def phase_backward(cases, fused) -> list[dict]:
    """The backward kernels against autograd through the plain version, at
    the forward's shapes, with dropout weights (keep-prob 0.1: weights 0
    or 10); at D > 64 in both modes, and the two modes against each
    other."""
    from dpcx_torch.render.voxelize import pc_point_dropout_weights

    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    out = []
    for case in cases:
        ndc, vox, sigma, radius = case["args"]
        with_depth = case["kw"]["with_depth"]
        pw = pc_point_dropout_weights(gen, ndc.shape[0], ndc.shape[2], 0.1)
        kw = dict(with_depth=with_depth)
        sil, depth = fused.fused_project_reference(ndc, vox, sigma, radius,
                                                   pw, **kw)
        dsil, ddepth = linear_functional(rng, sil, depth)
        g_p = render_grads(
            lambda x, w: fused.fused_project_reference(x, vox, sigma, radius,
                                                       w, **kw),
            ndc, pw, dsil, ddepth)
        modes = (True, False) if vox > 64 else (True,)
        grads, errs = {}, {}
        for save in modes:
            key = (f"{fused.launch_family(vox)}_render_bwd"
                   + ("" if save else "_recompute"))
            before = fused.LAUNCHES[key]
            grads[save] = render_grads(
                lambda x, w: fused.fused_project_t(
                    x, vox, sigma, radius, w, save_grid=save, **kw),
                ndc, pw, dsil, ddepth)
            torch.cuda.synchronize()
            assert fused.LAUNCHES[key] == before + 1, (key, fused.LAUNCHES)
            errs[save] = check_grads(f"{case['name']} ({key})", grads[save],
                                     g_p, ndc, vox)
        if len(modes) == 2:
            check_grads(f"{case['name']} saved grid vs recompute",
                        grads[True], grads[False], ndc, vox)
        out.append(dict(name=case["name"], ndc=ndc, pw=pw, vox=vox,
                        sigma=sigma, radius=radius, with_depth=with_depth,
                        dsil=dsil, ddepth=ddepth, err=max(errs.values())))
    return out


def time_backward(fused, case, save_grid: bool = True):
    """CUDA-event ms of the backward kernel alone (the launch on saved
    residuals, or the recompute launch from coords alone) and of the plain
    version's backward (autograd on a retained graph), and the kernel's
    launch itself for the profiler."""
    from dpcx_torch.render.gauss import gauss_kernel_1d

    ndc, pw, vox, radius = case["ndc"], case["pw"], case["vox"], case["radius"]
    wd = case["with_depth"]
    coords = ((ndc.flip(1) + 0.5) * vox - 0.5).contiguous()
    taps = gauss_kernel_1d(case["sigma"], radius).contiguous()
    _, _, grid = fused._launch_forward(coords, pw, taps, radius, vox, wd)
    if not save_grid:
        grid = None

    def bwd():
        fused._launch_backward(coords, pw, taps, radius, grid, case["dsil"],
                               case["ddepth"], vox, wd, True)

    k_ms = cuda_ms(bwd)
    x = ndc.detach().requires_grad_()
    w = pw.detach().requires_grad_()
    sil, depth = fused.fused_project_reference(x, vox, case["sigma"], radius,
                                               w, with_depth=wd)
    loss = (sil * case["dsil"]).sum()
    if depth is not None:
        loss = loss + (depth * case["ddepth"]).sum()
    p_ms = cuda_ms(lambda: torch.autograd.grad(loss, (x, w),
                                               retain_graph=True))
    return k_ms, p_ms, bwd


def blur_taps(d: int, r: int) -> int:
    """In-range taps of one 1-D blur pass along a line of d cells (SAME
    zero padding: a tap past the grid reads nothing)."""
    return sum(min(r, d - 1 - i) + min(r, i) + 1 for i in range(d))


def render_bound(renders, n, vox, radius, with_depth, weights, backward,
                 saved_grid) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one forward or backward
    call: the larger of its f32 operations over PEAK_F32_FLOPS and its
    bytes (each input read once, each output written once; the saved grid
    is an output of the forward and an input of the backward) over
    PEAK_BYTES_PER_S."""
    cells = renders * vox**3
    blur_pass = 2 * renders * vox * vox * blur_taps(vox, radius)
    pts = renders * n
    depth_ops = DEPTH_OPS if with_depth else 0
    point_bytes = 4 * pts * (4 if weights else 3)
    image_bytes = 4 * renders * vox * vox * (2 if with_depth else 1)
    grid_bytes = 4 * cells if saved_grid else 0
    taps_bytes = 4 * (2 * radius + 1)
    if not backward:  # splat, 3 blur passes, DRC
        ops = SPLAT_OPS * pts + 3 * blur_pass + (DRC_OPS + depth_ops) * cells
        nbytes = point_bytes + taps_bytes + image_bytes + grid_bytes
    else:  # z-blur again, its transpose, the y and x transposes, DRC
        # backward, splat backward (+ the splat and y/x blur recomputed)
        ops = (4 * blur_pass + (DRC_BWD_OPS + depth_ops) * cells
               + SPLAT_BWD_OPS * pts)
        if not saved_grid:
            ops += SPLAT_OPS * pts + 2 * blur_pass
        nbytes = 2 * point_bytes + taps_bytes + image_bytes + grid_bytes
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def post_npz(port: int, images: np.ndarray) -> dict[str, np.ndarray]:
    buf = io.BytesIO()
    np.savez(buf, images=images)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        assert resp.status == 200, resp.status
        with np.load(io.BytesIO(resp.read())) as f:
            return {k: f[k] for k in f.files}


def seeded_targets(cfg, views: int, models: int):
    """Masks and depths [M, V, D, D] of seeded ellipsoid clouds from
    seeded cameras, rendered by the plain ops; quats [M, V, 4]."""
    from dpcx_torch.render.project import pointcloud_project_fn

    rng = np.random.default_rng(SEED + 1)
    n = cfg.pc_num_points
    pts = rng.normal(size=(models, n, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= rng.uniform(0.15, 0.4, size=(models, 1, 3))
    u1, u2, u3 = rng.uniform(size=(3, models, views))
    a, b = np.sqrt(1.0 - u1), np.sqrt(u1)
    quats = np.stack([b * np.cos(2 * np.pi * u3), a * np.sin(2 * np.pi * u2),
                      a * np.cos(2 * np.pi * u2), b * np.sin(2 * np.pi * u3)],
                     axis=-1)
    pts_t = torch.tensor(pts, dtype=torch.float32, device="cuda")
    quats_t = torch.tensor(quats, dtype=torch.float32, device="cuda")
    out = pointcloud_project_fn(
        cfg.replace(renderer="xla"),
        pts_t.repeat_interleave(views, dim=0),
        quats_t.reshape(-1, 4),
        torch.tensor(cfg.pc_relative_sigma_end),
    )
    D = cfg.vox_size
    return {
        "masks": out.silhouette.reshape(models, views, D, D),
        "depths": out.depth.reshape(models, views, D, D),
        "quats": quats_t,
    }


def training_step_fn(cfg, ds):
    """One synchronised training step per call, as `cli train` runs it
    (device-resident records, the step's batch and dropout generator)."""
    from dpcx_torch.train import batch_at, create_state, device_records
    from dpcx_torch.train import step_generator, train_step

    state = create_state(
        cfg, DEVICE, torch.Generator(device=DEVICE).manual_seed(cfg.seed))
    records = device_records(ds, DEVICE)

    def step():
        batch = batch_at(cfg, ds, state.step, DEVICE, records)
        train_step(cfg, state, batch,
                   step_generator(cfg.seed + 1, state.step, DEVICE))
        torch.cuda.synchronize()

    return step


# kernel-name pieces -> the layer a training step's device time belongs
# to; the first match wins, blur_yx_kernel (forward and backward both
# launch it once a step) is split half and half. The renderer's forward is
# K1 at D <= 64 and the counterpart of K3 above; its backward K2, or K4 + K5
RENDER_FWD, RENDER_BWD = ("renderer forward (K1 / K3)",
                          "renderer backward (K2 / K4 + K5)")
STEP_LAYERS = (
    (RENDER_BWD, ("zblur_drc_bwd_kernel", "splat_bwd_kernel")),
    (RENDER_FWD, ("zblur_drc_kernel", "splat_kernel")),
    ("Adam (foreach)", ("multi_tensor_apply",)),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("convs", ("conv", "cudnn", "dgrad", "wgrad", "implicit")),
    ("copies, dtype casts, memsets", ("Memcpy", "Memset", "copy_kernel")),
)


def print_step_breakdown(kernels: list[tuple[str, float]],
                         label: str) -> None:
    """Device us per training step by layer, from device_profile's list."""
    total = sum(us for _, us in kernels)
    layers = {name: 0.0 for name, _ in STEP_LAYERS}
    layers["other (elementwise, reductions, indexing)"] = 0.0
    for key, us in kernels:
        if "blur_yx_kernel" in key:
            layers[RENDER_FWD] += us / 2
            layers[RENDER_BWD] += us / 2
            continue
        name = next((n for n, pieces in STEP_LAYERS
                     if any(p in key for p in pieces)),
                    "other (elementwise, reductions, indexing)")
        layers[name] += us
    for name, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        print(f"profile train step {label} by layer: {us:9.1f} us "
              f"{us / total:6.1%}  {name}", flush=True)


def reset_counts(fused) -> None:
    for name in fused.LAUNCHES:
        fused.LAUNCHES[name] = 0


def only(fused, **counts) -> dict:
    """Every launch count 0 but the ones named."""
    return {name: counts.get(name, 0) for name in fused.LAUNCHES}


def read_losses(checkpoint_dir: Path) -> list[tuple[int, float]]:
    recs = [json.loads(line) for line in
            (checkpoint_dir / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["loss_total"]) for r in recs if "loss_total" in r]


def phase_datagen(cli, fused, cfg_path: str, num_models: int, label: str):
    """`cli datagen` with the launch counts set to 0 just before; every
    model's V GT views go through one forward launch (K1, or the
    counterpart of K3 at D > 64)."""
    from dpcx_torch.config import load_config
    from dpcx_torch.data.dataset import load_or_make

    cfg = load_config(cfg_path)
    reset_counts(fused)
    t0 = time.perf_counter()
    cli.main(["datagen", "-f", cfg_path, "-n", str(num_models)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    assert launches == only(fused, **{
        f"{fused.launch_family(cfg.vox_size)}_render": num_models}), launches
    ds = load_or_make(cfg, num_models, seed=cfg.seed)  # the cached shard
    rec = ds.records
    V, D, size = cfg.num_views, cfg.vox_size, cfg.image_size
    assert rec["images"].shape == (num_models, V, size, size, 3)
    assert rec["masks"].shape == rec["depths"].shape == (num_models, V, D, D)
    assert all(np.isfinite(v).all() for v in rec.values())
    assert set(np.unique(rec["masks"])) <= {0.0, 1.0}
    cover = float(rec["masks"].mean())
    assert 0.02 < cover < 0.9, cover
    print(f"datagen {label}: {num_models} models x {V} views in {secs:.2f} s, "
          f"images {rec['images'].shape}, mask cover {cover:.3f}, launches "
          f"{launches}", flush=True)
    return ds


def integer_points(cfg, points, quats) -> torch.Tensor:
    """[B, N] bool: points with an exactly integer grid coordinate in some
    view, from the same ops the loss renders them with."""
    from dpcx_torch.render.transform import pc_perspective_transform_t

    B, N, _ = points.shape
    V = quats.shape[1]
    ndc = pc_perspective_transform_t(
        points.repeat_interleave(V, dim=0), quats.reshape(B * V, 4),
        focal_length=cfg.focal_length, camera_distance=cfg.camera_distance)
    coords = (ndc.flip(1) + 0.5) * cfg.vox_size - 0.5
    on_int = (coords == coords.floor()).any(1)  # [B * V, N]
    return on_int.reshape(B, V, N).any(1)


def phase_parity(cfg, ds) -> None:
    """3 steps with renderer: pallas (the kernels) against 3 with renderer:
    xla (plain ops), same init, batches and dropout generator, float32.
    A point with an exactly integer grid coordinate gets 0 along that axis
    from the kernels (dpcx's _dhat_t) and a one-sided derivative from the
    plain ops (dpcx's XLA scatter): a few per step do, so the gradient
    reaching such a point is set to 0 on both sides."""
    from dpcx_torch import train as ttrain
    from dpcx_torch.train import batch_at, create_state, step_generator
    from dpcx_torch.train import train_step

    masked = []

    def apply_model(c, model, batch):
        preds = real_apply(c, model, batch)
        mask = integer_points(c, preds["points"].detach(), batch["quats"])
        masked.append(int(mask.sum()))
        preds["points"].register_hook(
            lambda g: g.masked_fill(mask[..., None], 0.0))
        return preds

    real_apply, ttrain.apply_model = ttrain.apply_model, apply_model
    runs = {}
    try:
        for renderer in ("pallas", "xla"):
            runs[renderer] = parity_run(cfg.replace(renderer=renderer), ds,
                                        batch_at, create_state,
                                        step_generator, train_step)
    finally:
        ttrain.apply_model = real_apply
    # the first step, whose gradients are compared, starts both runs from
    # the same parameters and so masks the same points; later steps start
    # from parameters that differ by float reordering, and may not
    assert masked[0] == masked[3], masked
    (l_k, g_k), (l_p, g_p) = runs["pallas"], runs["xla"]
    worst_name, worst = "", 0.0
    for name, gp in g_p.items():
        norm = torch.linalg.vector_norm(gp).item()
        if norm == 0.0:  # the unused pose branch
            assert torch.equal(g_k[name], gp), name
            continue
        rel = torch.linalg.vector_norm(g_k[name] - gp).item() / norm
        if rel > worst:
            worst_name, worst = name, rel
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_k, l_p))
    print(f"parity {cfg.name}: first-step gradients, worst relative L2 "
          f"{worst:.3e} "
          f"({worst_name}; bound {TRAIN_RTOL}); losses kernel {l_k} vs "
          f"plain {l_p}, worst rel {loss_rel:.3e} (bound {TRAIN_RTOL}); "
          f"points with an integer grid coordinate, gradient held at 0, "
          f"per step: kernel run {masked[:3]}, plain run {masked[3:]}",
          flush=True)
    assert worst <= TRAIN_RTOL, (worst_name, worst)
    assert loss_rel <= TRAIN_RTOL, loss_rel


def parity_run(cfg, ds, batch_at, create_state, step_generator,
               train_step):
    """3 float32 steps from the seeded init: (losses, first-step grads)."""
    c = cfg.replace(compute_dtype="float32")
    state = create_state(
        c, DEVICE, torch.Generator(device=DEVICE).manual_seed(c.seed))
    losses, grads = [], None
    for step in range(3):
        batch = batch_at(c, ds, step, DEVICE)
        m = train_step(c, state, batch,
                       step_generator(c.seed + 1, step, DEVICE))
        losses.append(m["loss_total"].item())
        if grads is None:
            grads = {n: p.grad.detach().clone()
                     for n, p in state.model.named_parameters()}
    return losses, grads


def phase_train(cli, fused, cfg_path: str, cfg) -> dict:
    """`cli train` for TRAIN_STEPS with the counts set to 0 just before:
    finite, falling losses and one K1 and one K2 launch per step; then a
    resumed run of RESUME_STEPS."""
    run_dir = Path(cfg.checkpoint_dir)
    reset_counts(fused)
    t0 = time.perf_counter()
    cli.main(["train", "-f", cfg_path, "-n", str(MODELS), "--steps",
              str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    losses = read_losses(run_dir)
    assert [s for s, _ in losses] == list(range(1, TRAIN_STEPS + 1))
    vals = np.array([v for _, v in losses])
    assert np.isfinite(vals).all()
    first, last = vals[:20].mean(), vals[-20:].mean()
    print(f"train car_64_depth: {TRAIN_STEPS} steps in {secs:.1f} s (datagen "
          f"cached; log_every 1), loss_total mean of the first 20 "
          f"{first:.6f}, of the last 20 {last:.6f}; launches {launches} "
          "(image summaries render with renderer xla, as dpcx's do, so "
          "they launch no K1)", flush=True)
    assert last < first, (first, last)
    assert launches == only(fused, fused_render=TRAIN_STEPS,
                            fused_render_bwd=TRAIN_STEPS), launches
    pngs = sorted(p.name for p in (run_dir / "summaries").glob("*.png"))
    assert pngs == ["proj_0000100.png", "proj_0000200.png"], pngs
    assert (run_dir / "ckpt" / f"{TRAIN_STEPS}.pt").exists()
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(run_dir / "metrics.jsonl",
                OUT_DIR / "chip_smoke_car_64_depth_metrics.jsonl")

    reset_counts(fused)
    cli.main(["train", "-f", cfg_path, "-n", str(MODELS), "--steps",
              str(TRAIN_STEPS + RESUME_STEPS)])
    torch.cuda.synchronize()
    resumed = [s for s, _ in read_losses(run_dir)][TRAIN_STEPS:]
    assert resumed == list(range(TRAIN_STEPS + 1,
                                 TRAIN_STEPS + RESUME_STEPS + 1)), resumed
    assert dict(fused.LAUNCHES) == only(fused, fused_render=RESUME_STEPS,
                                        fused_render_bwd=RESUME_STEPS)
    print(f"train resume: steps {resumed[0]}..{resumed[-1]} after the "
          f"step-{TRAIN_STEPS} checkpoint, launches {fused.LAUNCHES}",
          flush=True)
    return launches


def phase_chair(cli, fused, tmp: Path) -> None:
    """chair_gt_pose with renderer: pallas (D 32, no depth, B 16 x 4)."""
    from dpcx_torch.config import load_config, save_config

    cfg = load_config(CHAIR).replace(
        renderer="pallas", data_dir=str(tmp / "chair_data"),
        checkpoint_dir=str(tmp / "chair"), log_every=1)
    path = tmp / "chair.yaml"
    save_config(cfg, path)
    phase_datagen(cli, fused, str(path), MODELS, "chair_gt_pose")
    reset_counts(fused)
    cli.main(["train", "-f", str(path), "-n", str(MODELS), "--steps",
              str(CHAIR_STEPS)])
    torch.cuda.synchronize()
    vals = [v for _, v in read_losses(Path(cfg.checkpoint_dir))]
    assert len(vals) == CHAIR_STEPS and np.isfinite(vals).all(), vals
    assert dict(fused.LAUNCHES) == only(fused, fused_render=CHAIR_STEPS,
                                        fused_render_bwd=CHAIR_STEPS)
    print(f"train chair_gt_pose (renderer pallas): {CHAIR_STEPS} steps, "
          f"loss_total {vals[0]:.6f} -> {vals[-1]:.6f}, launches "
          f"{fused.LAUNCHES}", flush=True)


def phase_multicat(cli, fused, tmp: Path):
    """multicat_128_fused at full width: datagen, kernel-vs-plain steps,
    `cli train` for MULTICAT_STEPS with the counts set to 0 just before
    and read just after, then REMAT_STEPS with remat: true."""
    from dpcx_torch.config import load_config, save_config

    cfg = load_config(MULTICAT).validate().replace(
        data_dir=str(tmp / "multicat_data"),
        checkpoint_dir=str(tmp / "multicat"), log_every=1,
        save_every=MULTICAT_STEPS)
    assert (cfg.vox_size, cfg.renderer, cfg.proj_depth, cfg.predict_pose,
            cfg.remat) == (128, "pallas", False, False, False)
    path = str(tmp / "multicat.yaml")
    save_config(cfg, path)
    ds = phase_datagen(cli, fused, path, MODELS, "multicat_128_fused")
    phase_parity(cfg, ds)

    run_dir = Path(cfg.checkpoint_dir)
    reset_counts(fused)
    t0 = time.perf_counter()
    cli.main(["train", "-f", path, "-n", str(MODELS), "--steps",
              str(MULTICAT_STEPS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    losses = read_losses(run_dir)
    assert [s for s, _ in losses] == list(range(1, MULTICAT_STEPS + 1))
    vals = np.array([v for _, v in losses])
    assert np.isfinite(vals).all()
    first, last = vals[:20].mean(), vals[-20:].mean()
    print(f"train multicat_128_fused: {MULTICAT_STEPS} steps in {secs:.1f} s "
          f"(datagen cached; log_every 1), loss_total mean of the first 20 "
          f"{first:.6f}, of the last 20 {last:.6f}; launches {launches}",
          flush=True)
    assert last < first, (first, last)
    assert launches == only(fused, blocked_render=MULTICAT_STEPS,
                            blocked_render_bwd=MULTICAT_STEPS), launches
    assert (run_dir / "ckpt" / f"{MULTICAT_STEPS}.pt").exists()
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(run_dir / "metrics.jsonl",
                OUT_DIR / "chip_smoke_multicat_128_metrics.jsonl")

    # remat: the checkpointed forward runs again in the backward (a second
    # forward launch), whose backward recomputes the grid from coords
    remat = cfg.replace(remat=True, checkpoint_dir=str(tmp / "remat"))
    remat_path = str(tmp / "remat.yaml")
    save_config(remat, remat_path)
    reset_counts(fused)
    cli.main(["train", "-f", remat_path, "-n", str(MODELS), "--steps",
              str(REMAT_STEPS)])
    torch.cuda.synchronize()
    remat_launches = dict(fused.LAUNCHES)
    got = [v for _, v in read_losses(Path(remat.checkpoint_dir))]
    want = list(vals[:REMAT_STEPS])
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"train multicat_128_fused remat: {REMAT_STEPS} steps, loss_total "
          f"{got} vs without remat {want}, worst rel {rel:.3e} (bound "
          f"{TRAIN_RTOL}); launches {remat_launches}", flush=True)
    assert len(got) == REMAT_STEPS and rel <= TRAIN_RTOL, (got, want)
    assert remat_launches == only(
        fused, blocked_render=2 * REMAT_STEPS,
        blocked_render_bwd_recompute=REMAT_STEPS), remat_launches
    return cfg, ds, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2

    from dpcx_torch import _build, cli
    from dpcx_torch.config import load_config, save_config
    from dpcx_torch.models.losses import compute_loss
    from dpcx_torch.models.model_pc import ModelPointCloud
    from dpcx_torch.render import fused, gauss
    from dpcx_torch.serve import serve

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, frame, spill in ptxas_report(_build.build_log().read_text()):
        print(f"build: ptxas {name}: {frame} bytes stack frame, {spill} "
              "bytes spilled", flush=True)

    cfg = load_config(CONFIG).validate()
    assert cfg.renderer == "pallas" and cfg.proj_depth

    # 2. each forward kernel vs its plain version
    cases = phase_kernel(cfg, fused, gauss)
    # 3. each backward kernel vs autograd through the plain version
    bwd_cases = phase_backward(cases, fused)

    # 4. serve: the first path starts here, with every launch count at 0
    reset_counts(fused)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    params = ModelPointCloud(cfg, device="cuda", generator=gen).state_dict()
    srv = serve(cfg, params, port=0, batch_size=16)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(SEED + 2)
        size, N = cfg.image_size, cfg.pc_num_points
        requests = [
            rng.random((1, size, size, 3), np.float32),
            (rng.random((16, size, size, 3)) * 255).astype(np.uint8),
            rng.random((20, size, size, 3), np.float32),
        ]
        served = []
        for imgs in requests:
            out = post_npz(port, imgs)
            n = imgs.shape[0]
            assert out["points"].shape == (n, N, 3), out["points"].shape
            assert out["scale"].shape == (n, 1), out["scale"].shape
            assert all(np.isfinite(v).all() for v in out.values())
            direct = srv.model(imgs)
            for k in out:
                np.testing.assert_array_equal(out[k], direct[k])
            served.append(out)
            print(f"serve: {n} images -> points {out['points'].shape}, "
                  f"scale {out['scale'].shape}, finite, equal to a direct "
                  "ServingModel call", flush=True)
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=60
        ) as resp:
            health = json.loads(resp.read())
        # warmup + 3 POSTs + 3 direct calls
        assert health["status"] == "ok" and health["requests"] == 7, health
        print(f"serve: /healthz {health}", flush=True)

        # 5. score 8 served clouds with the GT-pose loss forward
        batch = seeded_targets(cfg, views=4, models=8)
        preds = {k: torch.from_numpy(v[:8]).cuda()
                 for k, v in served[2].items()}
        with torch.no_grad():
            total, metrics = compute_loss(cfg, preds, batch, step=0,
                                          train=False)
            torch.cuda.synchronize()
            launches = dict(fused.LAUNCHES)
            total_plain, metrics_plain = compute_loss(
                cfg.replace(renderer="xla"), preds, batch, step=0,
                train=False,
            )
        assert launches == only(fused, fused_render=1), launches
        for k in ("loss_proj", "loss_depth", "loss_total"):
            v = metrics[k].item()
            assert np.isfinite(v), (k, v)
        rel = abs(total.item() - total_plain.item()) / abs(total_plain.item())
        print(f"score: launches {launches}, loss_proj "
              f"{metrics['loss_proj'].item():.6f}, loss_depth "
              f"{metrics['loss_depth'].item():.6f}, loss_total "
              f"{total.item():.6f} vs plain {total_plain.item():.6f} "
              f"(rel {rel:.2e}, rtol {LOSS_RTOL}), iou "
              f"{metrics['iou'].item():.4f}", flush=True)
        assert rel <= LOSS_RTOL, rel

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_name:
            tmp = Path(tmp_name)
            # 6. datagen through the CLI, GT views through K1
            car_cfg = cfg.replace(data_dir=str(tmp / "data"),
                              checkpoint_dir=str(tmp / "car"), log_every=1,
                              save_every=100)
            car_path = str(tmp / "car.yaml")
            save_config(car_cfg, car_path)
            ds = phase_datagen(cli, fused, car_path, MODELS, "car_64_depth")
            # 7. kernel against plain in training
            phase_parity(car_cfg, ds)
            # 8. train through the CLI, resume, chair
            launches = phase_train(cli, fused, car_path, car_cfg)
            phase_chair(cli, fused, tmp)
            # 9. multicat_128_fused: datagen, parity, train, remat
            mc_cfg, mc_ds, mc_launches = phase_multicat(cli, fused, tmp)

            # 10. time
            timings = {}
            for case in cases:
                args, kw = case["args"], case["kw"]
                k_ms = cuda_ms(lambda: fused.fused_project_t(*args, **kw))
                p_ms = cuda_ms(
                    lambda: fused.fused_project_reference(*args, **kw))
                timings[case["name"]] = (k_ms, p_ms)
                which = "K3" if args[1] > 64 else "K1"
                print(f"time {which} {case['name']} ({args[0].shape[0]} "
                      f"renders x {args[0].shape[2]} points, D {args[1]}): "
                      f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms | {card}",
                      flush=True)
            bwd_timings, bwd_launch = {}, {}
            for case in bwd_cases:
                modes = (True, False) if case["vox"] > 64 else (True,)
                for save in modes:
                    k_ms, p_ms, bwd = time_backward(fused, case, save)
                    bwd_timings[case["name"], save] = k_ms, p_ms
                    bwd_launch.setdefault((case["name"], save), bwd)
                    which = ("K2" if case["vox"] <= 64 else
                             "K4 + K5" + ("" if save else " (recompute)"))
                    print(f"time {which} {case['name']} "
                          f"({case['ndc'].shape[0]} renders x "
                          f"{case['ndc'].shape[2]} points, D {case['vox']}): "
                          f"kernel {k_ms:.4f} ms, plain backward "
                          f"{p_ms:.4f} ms | {card}", flush=True)
            imgs16 = requests[2][:16]
            direct_ms = host_ms(lambda: srv.model(imgs16))
            http_ms = host_ms(lambda: post_npz(port, imgs16))
            print(f"time serve batch 16 ({size}px -> {N} points): "
                  f"ServingModel {direct_ms:.3f} ms, HTTP round trip "
                  f"{http_ms:.3f} ms per request | {card}", flush=True)
            step_fn = training_step_fn(car_cfg, ds)
            step_ms = host_ms(step_fn)
            print(f"time train step car_64_depth (B 8 x 4 views, N 16000, "
                  f"D 64, bf16 compute): median {step_ms:.3f} ms per step "
                  f"| {card}", flush=True)
            mc_step_fn = training_step_fn(mc_cfg, mc_ds)
            mc_step_ms = host_ms(mc_step_fn)
            print(f"time train step multicat_128 (B 4 x 4 views, N 16000, "
                  f"D 128, bf16 compute): median {mc_step_ms:.3f} ms per "
                  f"step | {card}", flush=True)

        # 11. profile
        print(f"profile on {card}", flush=True)
        for case in (cases[0], cases[2]):
            device_profile(
                lambda: fused.fused_project_t(*case["args"], **case["kw"]),
                f"{'K3' if case['args'][1] > 64 else 'K1'} {case['name']}",
            )
        device_profile(bwd_launch["car_64_depth", True],
                       "K2 car_64_depth (launch on saved residuals)")
        device_profile(bwd_launch["multicat_128", True],
                       "K4 + K5 multicat_128 (launch on saved residuals)")
        device_profile(bwd_launch["multicat_128", False],
                       "K4 + K5 multicat_128 (recompute launch)")
        with torch.no_grad():
            score = device_profile(
                lambda: compute_loss(cfg, preds, batch, step=0, train=False),
                "score forward (compute_loss, 8 clouds x 4 views, D 64)",
            )
        k1_us = sum(us for name, us in score if any(
            stage in name for stage in K1_STAGES))
        print(f"profile score forward: K1's kernels {k1_us:.1f} us per call",
              flush=True)
        device_profile(lambda: srv.model(imgs16), "ServingModel batch 16")
        step = device_profile(step_fn, "train step car_64_depth", runs=10,
                              top=16)
        print_step_breakdown(step, "car_64_depth")
        step = device_profile(mc_step_fn, "train step multicat_128", runs=10,
                              top=16)
        print_step_breakdown(step, "multicat_128")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s, build included",
          flush=True)
    print(card)
    source = "dpcx_torch/csrc/fused_render.cu"
    by_name = {c["name"]: c for c in bwd_cases}

    def entry(name, replaces, launches_, case, backward, note=None):
        ndc, vox, radius = case["ndc"], case["vox"], case["radius"]
        if backward:
            k_ms, p_ms = bwd_timings[case["name"], True]
        else:
            k_ms, p_ms = timings[case["name"]]
        bound_ms, bound_by = render_bound(
            ndc.shape[0], ndc.shape[2], vox, radius, case["with_depth"],
            True, backward, True)
        checked = [c["err"] for c in (bwd_cases if backward else cases)
                   if (c["vox"] > 64) == (vox > 64)]
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches_,
               "max_abs_err": max(checked), "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if note:
            out["note"] = note
        return out

    shared = ("K4 and K5 are one launch, dpcx_fused_render_bwd (the suffix "
              "form makes K4's Total the suffix after the downward walk); "
              "ms and bound_ms are that launch's")
    print(json.dumps({"kernels": [
        entry("fused_render", "dpcx/render/pallas_kernel.py:75",
              launches["fused_render"], by_name["car_64_depth"], False),
        entry("fused_render_bwd", "dpcx/render/pallas_kernel.py:254",
              launches["fused_render_bwd"], by_name["car_64_depth"], True),
        entry("blocked_render", "dpcx/render/pallas_blocked.py:289",
              mc_launches["blocked_render"], by_name["multicat_128"], False),
        entry("blocked_render_bwd:K4",
              "dpcx/render/pallas_blocked.py:376",
              mc_launches["blocked_render_bwd"], by_name["multicat_128"],
              True, shared),
        entry("blocked_render_bwd:K5",
              "dpcx/render/pallas_blocked.py:451",
              mc_launches["blocked_render_bwd"], by_name["multicat_128"],
              True, shared),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
