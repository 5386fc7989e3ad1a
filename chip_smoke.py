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
3b. splats  — the anisotropic splat forward (the counterpart of K6)
              against its plain version at the rgb_splats training render
              (32 renders x 4096 points, D 32, rgb), density only, and at
              N 1000 (pads); the backward (K7) against autograd through the
              plain version, all 32 renders, for a random linear functional
              of the density and colour grids, with dropout weights.
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
9b. splats  — experiments/rgb_splats.yaml at full width (N 4096 with rgb
              and gauss heads, D 32, B 8 x 4 views, gsplat_impl pallas, GT
              pose): `cli datagen` (32 models, plain ops: renderer xla), 3
              float32 training steps through K6 + K7 against 3 through the
              plain version, `cli train` for 200 steps (finite losses,
              loss_rgb logged, the last 20 below the first 20, exactly one
              K6 and one K7 launch per step and no other kernel's), and a
              ServingModel call on the trained model (rgb and gauss heads).
10. time    — CUDA-event medians: each forward and backward kernel
              against its plain version at the shapes of phases 2 and 3b
              (the recompute backward too); host-clock serve latency at
              batch 16 and the median car_64_depth, multicat_128 and
              rgb_splats training steps.
11. profile — torch.profiler device time per kernel, per call, of K1, K2,
              the D > 64 forward and backward, K6 and K7, the scoring
              forward, the batch-16 ServingModel call and one training step
              of each of car_64_depth, multicat_128 and rgb_splats (with
              its time by layer), beside the host time per call and the
              share of it in which the card is idle.

Data and checkpoints go to a temporary directory that is removed at the
end; the car_64_depth, multicat_128 and rgb_splats runs' metrics.jsonl
are copied to OUT_DIR. The last lines are the run's seconds, the card's
name and power limit (nvidia-smi), a JSON line describing each kernel (its
launches on the main path, its largest error against its plain version,
its time, its plain version's time, and the least time the card could take
for the same work), and {"ok": true, "device": {...}}.
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
RGB_SPLATS = REPO / "experiments" / "rgb_splats.yaml"
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
MULTICAT_STEPS, REMAT_STEPS, SPLAT_STEPS = 100, 3, 200
SPLAT_GRAD_RTOL = 2e-4  # K7 vs plain: relative L2, dpcx's own bound for
# its Pallas backward against the dense oracle
# the kernels of csrc/fused_render.cu, as torch.profiler names them
K1_STAGES = ("splat_kernel", "blur_yx_kernel", "zblur_drc_kernel")
# one H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores,
# and device memory; the renderer runs no tensor-core instruction
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
# f32 operations per item, counted from csrc/fused_render.cu: the splat
# per point (floors, fractions, 1 - t, 8 corners x (3 mults + 1 add)); the
# splat backward per point (the same hats, 8 corners x 4 sums x 3); DRC per
# cell (clip, p = o T, sil += p, T *= 1 - o; + 3 with depth) and its
# backward (the forward walk's T, phi, the suffix, dL/do); a blur pass costs
# a multiply and an add per in-range tap
SPLAT_OPS, SPLAT_BWD_OPS, DRC_OPS, DRC_BWD_OPS, DEPTH_OPS = 40, 108, 6, 14, 3
# The least f32 operations the anisotropic splat function needs (an FMA
# counts 2, as the peak rate does; exp2 1, log2(e) folded into the
# coefficients), per point and cell in its z-range, per row of D cells and
# per z-plane, with rgb / density only. Forward: the exponent is a
# quadratic in x with per-row coefficients (2 FMAs), exp2, the density sum
# (1) and three colour FMAs (6); a row forms its coefficients from dy and
# the plane's terms (12), a plane its dz terms (6). Backward: e again (5),
# the colour sums of e ct_c (6), u = e (ct_d + r ct_r + g ct_g + b ct_b)
# (7; density only e ct_d, 1), and three sums per cell, u, u x, u x^2 (5);
# a row forms its coefficients (12) and folds its three sums into the
# plane's six moments with dy (10), a plane its dz terms (6) and folds
# those into the point's ten moments (15); per-point work is left out
ANISO_FWD_OPS = {True: (12, 12, 6), False: (6, 12, 6)}
ANISO_BWD_OPS = {True: (23, 22, 21), False: (11, 22, 21)}
# what csrc/aniso_splat.cu itself spends per point-cell (expf as 2), printed
# beside the bound: K6 24 / 18, K7 55 / 43 (it recomputes per-row terms in
# every cell and sums ten moments per cell)
ANISO_KERNEL_OPS = {False: {True: 24, False: 18}, True: {True: 55, False: 43}}


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
            k = re.search(r"([a-z_]+_kernel)((?:I?L[ib]\d+E)*)", m.group(1))
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([ib])(\d+)E",
                                           k.group(2) if k else "")]
            name = (m.group(1) if k is None else
                    k.group(1) + (f"<{', '.join(args)}>" if args else ""))
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


def device_profile(fn, label: str, runs: int = 20, top: int = 8,
                   host_top: int = 0) -> list[tuple[str, float]]:
    """Print torch.profiler's device microseconds per call of fn(), summed
    and per kernel (memsets and copies included), beside the host
    microseconds per call measured without the profiler, and with
    ``host_top`` the host ops of the most self CPU time; return the
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
    cpu = sorted(((e.key, e.self_cpu_time_total / runs, e.count // runs)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda kv: -kv[1])
    for name, us, calls in cpu[:host_top]:
        print(f"  host {us:9.1f} us self CPU per call, {calls} calls  "
              f"{name[:70]}", flush=True)
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
                 saved_grid, bf16=False) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one forward or backward
    call: the larger of its f32 operations over PEAK_F32_FLOPS and its
    bytes (each input read once, each output written once; the saved grid
    is an output of the forward and an input of the backward) over
    PEAK_BYTES_PER_S. ``bf16``: K1's bfloat16 mode (not ported), whose
    Pallas kernel runs the splat and the blur as bf16 matmuls: those
    operations over PEAK_BF16_FLOPS, DRC's in f32; inputs and outputs stay
    f32."""
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
        if bf16:
            t_ops = ((SPLAT_OPS * pts + 3 * blur_pass) / PEAK_BF16_FLOPS
                     + (DRC_OPS + depth_ops) * cells / PEAK_F32_FLOPS) * 1e3
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            return ((t_ops, "operations") if t_ops >= t_bytes
                    else (t_bytes, "bytes"))
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
    ("splat renderer backward (K7)", ("aniso_bwd_kernel",)),
    ("splat renderer forward (K6)", ("aniso_fwd_kernel",)),
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


def counters() -> tuple[dict, ...]:
    """Every kernel wrapper's launch counts: the fused renderer's (K1-K5)
    and the anisotropic splats' (K6, K7)."""
    from dpcx_torch.render import aniso, fused

    return fused.LAUNCHES, aniso.LAUNCHES


def reset_counts() -> None:
    for c in counters():
        for name in c:
            c[name] = 0


def launch_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def only(**counts) -> dict:
    """Every launch count 0 but the ones named."""
    return {name: counts.get(name, 0) for name in launch_counts()}


def read_losses(checkpoint_dir: Path) -> list[tuple[int, float]]:
    recs = [json.loads(line) for line in
            (checkpoint_dir / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["loss_total"]) for r in recs if "loss_total" in r]


def phase_datagen(cli, fused, cfg_path: str, num_models: int, label: str):
    """`cli datagen` with the launch counts set to 0 just before; with
    renderer: pallas every model's V GT views go through one forward launch
    (K1, or the counterpart of K3 at D > 64), with renderer: xla through
    the plain ops."""
    from dpcx_torch.config import load_config
    from dpcx_torch.data.dataset import load_or_make

    cfg = load_config(cfg_path)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["datagen", "-f", cfg_path, "-n", str(num_models)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    want = ({f"{fused.launch_family(cfg.vox_size)}_render": num_models}
            if cfg.renderer == "pallas" else {})
    assert launches == only(**want), launches
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
               train_step, density_fn=None):
    """3 float32 steps from the seeded init: (losses, first-step grads).
    ``density_fn`` goes to train_step (the anisotropic splats' density)."""
    c = cfg.replace(compute_dtype="float32")
    state = create_state(
        c, DEVICE, torch.Generator(device=DEVICE).manual_seed(c.seed))
    losses, grads = [], None
    for step in range(3):
        batch = batch_at(c, ds, step, DEVICE)
        m = train_step(c, state, batch,
                       step_generator(c.seed + 1, step, DEVICE),
                       density_fn=density_fn)
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
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-f", cfg_path, "-n", str(MODELS), "--steps",
              str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
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
    assert launches == only(fused_render=TRAIN_STEPS,
                            fused_render_bwd=TRAIN_STEPS), launches
    pngs = sorted(p.name for p in (run_dir / "summaries").glob("*.png"))
    assert pngs == ["proj_0000100.png", "proj_0000200.png"], pngs
    assert (run_dir / "ckpt" / f"{TRAIN_STEPS}.pt").exists()
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(run_dir / "metrics.jsonl",
                OUT_DIR / "chip_smoke_car_64_depth_metrics.jsonl")

    reset_counts()
    cli.main(["train", "-f", cfg_path, "-n", str(MODELS), "--steps",
              str(TRAIN_STEPS + RESUME_STEPS)])
    torch.cuda.synchronize()
    resumed = [s for s, _ in read_losses(run_dir)][TRAIN_STEPS:]
    assert resumed == list(range(TRAIN_STEPS + 1,
                                 TRAIN_STEPS + RESUME_STEPS + 1)), resumed
    assert launch_counts() == only(fused_render=RESUME_STEPS,
                                        fused_render_bwd=RESUME_STEPS)
    print(f"train resume: steps {resumed[0]}..{resumed[-1]} after the "
          f"step-{TRAIN_STEPS} checkpoint, launches {launch_counts()}",
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
    reset_counts()
    cli.main(["train", "-f", str(path), "-n", str(MODELS), "--steps",
              str(CHAIR_STEPS)])
    torch.cuda.synchronize()
    vals = [v for _, v in read_losses(Path(cfg.checkpoint_dir))]
    assert len(vals) == CHAIR_STEPS and np.isfinite(vals).all(), vals
    assert launch_counts() == only(fused_render=CHAIR_STEPS,
                                        fused_render_bwd=CHAIR_STEPS)
    print(f"train chair_gt_pose (renderer pallas): {CHAIR_STEPS} steps, "
          f"loss_total {vals[0]:.6f} -> {vals[-1]:.6f}, launches "
          f"{launch_counts()}", flush=True)


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
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-f", path, "-n", str(MODELS), "--steps",
              str(MULTICAT_STEPS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
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
    assert launches == only(blocked_render=MULTICAT_STEPS,
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
    reset_counts()
    cli.main(["train", "-f", remat_path, "-n", str(MODELS), "--steps",
              str(REMAT_STEPS)])
    torch.cuda.synchronize()
    remat_launches = launch_counts()
    got = [v for _, v in read_losses(Path(remat.checkpoint_dir))]
    want = list(vals[:REMAT_STEPS])
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"train multicat_128_fused remat: {REMAT_STEPS} steps, loss_total "
          f"{got} vs without remat {want}, worst rel {rel:.3e} (bound "
          f"{TRAIN_RTOL}); launches {remat_launches}", flush=True)
    assert len(got) == REMAT_STEPS and rel <= TRAIN_RTOL, (got, want)
    assert remat_launches == only(
        blocked_render=2 * REMAT_STEPS,
        blocked_render_bwd_recompute=REMAT_STEPS), remat_launches
    return cfg, ds, launches


def splat_inputs(renders: int, n: int, vox: int, seed: int, with_rgb: bool,
                 keep: float = 0.1):
    """Seeded K6/K7 inputs as the gsplat renderer makes them
    (gsplat.splat_params, truncate 3): points in [-0.45, 0.45], scales in
    rgb_splats' bounds [0.005, 0.06], random local rotations, opacity times
    dropout weights at keep-prob ``keep`` (0 or 1 / keep) -> dict of mu,
    A6, w, rgb (or None) and rz on the card."""
    from dpcx_torch.render.gsplat import splat_params

    rng = np.random.default_rng(seed)
    q = rng.normal(size=(renders, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pw = rng.uniform(size=(renders, n)) * (
        rng.random((renders, n)) < keep) / keep
    pts, scales, rot, pw, rgb = (
        torch.tensor(a, dtype=torch.float32, device=DEVICE) for a in (
            rng.uniform(-0.45, 0.45, (renders, n, 3)),
            rng.uniform(0.005, 0.06, (renders, n, 3)), q, pw,
            rng.uniform(size=(renders, n, 3))))
    mu, A6, w, rz = splat_params(pts, scales, rot, vox, pw)
    return dict(mu=mu, A6=A6, w=w, rgb=rgb if with_rgb else None, rz=rz,
                vox=vox)


def aniso_args(case: dict) -> tuple:
    return tuple(case[k] for k in ("mu", "A6", "w", "rgb", "rz", "vox"))


def phase_aniso_kernel(aniso) -> list[dict]:
    """K6 against its plain version: the rgb_splats training render (32
    renders x 4096 points, D 32, rgb, f32), its density-only variant, and
    an N that is not a multiple of 128 (pads in the last chunk). Bound:
    KERNEL_ATOL of the largest plain value (at least KERNEL_ATOL): the
    density of thin Gaussians at keep-prob 0.1 (weights 10x) peaks near
    1e2, where one f32 ulp is ~1e-5, and the two sum in other orders."""
    shapes = [("rgb_splats", 32, 4096, 32, True),
              ("rgb_splats_density", 32, 4096, 32, False),
              ("pads", 8, 1000, 32, True)]
    cases = []
    for i, (name, renders, n, vox, with_rgb) in enumerate(shapes):
        case = splat_inputs(renders, n, vox, SEED + 10 + i, with_rgb)
        before = aniso.LAUNCHES["aniso_render"]
        got = aniso.aniso_density(*aniso_args(case))
        torch.cuda.synchronize()
        assert aniso.LAUNCHES["aniso_render"] == before + 1, aniso.LAUNCHES
        want = aniso.aniso_density_reference(*aniso_args(case))
        got, want = (got, want) if with_rgb else ((got,), (want,))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        peak = max(b.abs().max().item() for b in want)
        bound = KERNEL_ATOL * max(1.0, peak)
        z_lo, z_hi = aniso.z_ranges(case["mu"][..., 0], case["rz"], vox)
        cells = int((z_hi - z_lo).sum()) * vox * vox
        print(f"kernel check K6 {name}: {renders} renders x {n} points, D "
              f"{vox}, rgb {with_rgb}: max abs err {err:.3e}, largest plain "
              f"value {peak:.3e} (bound {bound:.3e}); {cells} point-cells in "
              f"range ({cells / (renders * n * vox**3):.3f} of all)",
              flush=True)
        assert np.isfinite(err) and err <= bound, (name, err, bound)
        case.update(name=name, err=err, point_cells=cells, renders=renders,
                    n=n)
        cases.append(case)
    return cases


def phase_aniso_backward(aniso, cases) -> list[dict]:
    """K7 against autograd through the plain version (every z-slab
    checkpointed, so all 32 renders fit), for a random linear functional
    of the density and colour grids, with opacity and dropout weights, at
    the two rgb_splats shapes of phase_aniso_kernel: relative L2 of each
    gradient (mu, A6, w, rgb) within SPLAT_GRAD_RTOL."""
    rng = np.random.default_rng(SEED + 20)
    out = []
    for case in cases[:2]:
        vox, with_rgb = case["vox"], case["rgb"] is not None
        ct = torch.tensor(rng.normal(size=(
            case["renders"], 4 if with_rgb else 1, vox, vox, vox)),
            dtype=torch.float32, device=DEVICE)
        before = aniso.LAUNCHES["aniso_render_bwd"]
        g_k = splat_grads(aniso.aniso_density, case, ct)
        torch.cuda.synchronize()
        assert aniso.LAUNCHES["aniso_render_bwd"] == before + 1
        g_p = splat_grads(aniso.aniso_density_reference, case, ct)
        worst, err = 0.0, 0.0
        for name, a, b in zip(("mu", "A6", "w", "rgb"), g_k, g_p):
            rel = (torch.linalg.vector_norm(a - b)
                   / torch.linalg.vector_norm(b)).item()
            err = max(err, (a - b).abs().max().item())
            print(f"backward check K7 {case['name']} d {name}: relative L2 "
                  f"{rel:.3e} (bound {SPLAT_GRAD_RTOL}), max abs err "
                  f"{(a - b).abs().max().item():.3e}, max |plain| "
                  f"{b.abs().max().item():.3e}", flush=True)
            assert np.isfinite(rel) and rel <= SPLAT_GRAD_RTOL, (name, rel)
            worst = max(worst, rel)
        out.append(dict(case, ct=ct, err=err, rel=worst))
    return out


def splat_grads(render, case, ct):
    """d/d(mu, A6, w[, rgb]) of <ct, render output> (density and, with
    rgb, the colour accumulators stacked as the kernel's channels)."""
    ins = [case[k].detach().requires_grad_() for k in ("mu", "A6", "w")]
    if case["rgb"] is not None:
        ins.append(case["rgb"].detach().requires_grad_())
    out = render(*ins[:3], ins[3] if len(ins) == 4 else None, case["rz"],
                 case["vox"])
    out = (torch.cat([out[0][:, None], out[1]], 1) if len(ins) == 4
           else out[:, None])
    return torch.autograd.grad((out * ct).sum(), ins)


def time_aniso(aniso, case):
    """CUDA-event ms of K6 (the wrapper, z-ranges included), K7 alone (the
    launch on the saved inputs), the plain forward, and the plain forward
    plus backward; and the K7 launch itself for the profiler."""
    args = aniso_args(case)
    with_rgb = case["rgb"] is not None
    fwd_ms = cuda_ms(lambda: aniso.aniso_density(*args))
    pk = aniso.pack(case["mu"], case["A6"], case["w"], case["rgb"])
    z_lo, z_hi = aniso.z_ranges(case["mu"][..., 0], case["rz"], case["vox"])

    def bwd():
        aniso._launch_backward(pk, z_lo, z_hi, case["ct"], case["vox"],
                               with_rgb)

    bwd_ms = cuda_ms(bwd)
    plain_ms = cuda_ms(lambda: aniso.aniso_density_reference(*args), runs=5,
                       warmup=1)
    plain_fb_ms = cuda_ms(
        lambda: splat_grads(aniso.aniso_density_reference, case, case["ct"]),
        runs=5, warmup=1)
    return fwd_ms, bwd_ms, plain_ms, plain_fb_ms, bwd


def aniso_bound(case, backward: bool) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of one K6 or K7 call on this
    case's data: the function's least f32 operations (ANISO_*_OPS, on the
    point-cells, rows and planes in range for the z-ranges these inputs
    give) over PEAK_F32_FLOPS, against the bytes (packed points and
    z-ranges in, the grids out; backward: the cotangent grids in, the
    packed gradient out) over PEAK_BYTES_PER_S."""
    with_rgb = case["rgb"] is not None
    per_cell, per_row, per_plane = (
        ANISO_BWD_OPS if backward else ANISO_FWD_OPS)[with_rgb]
    cells, vox = case["point_cells"], case["vox"]
    ops = (per_cell * cells + per_row * cells // vox
           + per_plane * cells // vox**2)
    points = case["renders"] * case["n"]
    grids = case["renders"] * (4 if with_rgb else 1) * case["vox"] ** 3
    nbytes = 4 * (15 * points + grids + (13 * points if backward else 0))
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def aniso_own_ms(case, backward: bool) -> float:
    """ms of the f32 operations csrc/aniso_splat.cu spends on this case's
    point-cells, at PEAK_F32_FLOPS (not a bound: the kernel's own count)."""
    own = ANISO_KERNEL_OPS[backward][case["rgb"] is not None]
    return own * case["point_cells"] / PEAK_F32_FLOPS * 1e3


def phase_splat_parity(cfg, ds) -> None:
    """3 float32 rgb_splats steps through the kernels (K6 + K7) against 3
    through the plain version, same init, batches and dropout generator.
    The plain side is chosen here, by the density function handed to
    parity_run, which passes it down to gsplat_project."""
    from dpcx_torch.render import aniso
    from dpcx_torch.train import batch_at, create_state, step_generator
    from dpcx_torch.train import train_step

    def plain(mu, A6, w, rgb, rz, vox, acc_dtype="float32"):
        assert acc_dtype == "float32", acc_dtype
        return aniso.aniso_density_reference(mu, A6, w, rgb, rz, vox)

    runs = {}
    for label, render in (("kernel", aniso.aniso_density), ("plain", plain)):
        before = launch_counts()
        runs[label] = parity_run(cfg, ds, batch_at, create_state,
                                 step_generator, train_step,
                                 density_fn=render)
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in launch_counts().items()}
        want = (only(aniso_render=3, aniso_render_bwd=3)
                if label == "kernel" else only())
        assert made == want, (label, made)
    (l_k, g_k), (l_p, g_p) = runs["kernel"], runs["plain"]
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
          f"{worst:.3e} ({worst_name}; bound {TRAIN_RTOL}); losses kernel "
          f"{l_k} vs plain {l_p}, worst rel {loss_rel:.3e} (bound "
          f"{TRAIN_RTOL})", flush=True)
    assert worst <= TRAIN_RTOL, (worst_name, worst)
    assert loss_rel <= TRAIN_RTOL, loss_rel


def phase_splats(cli, fused, tmp: Path):
    """experiments/rgb_splats.yaml at full width (N 4096, D 32, B 8 x 4
    views, rgb and gauss heads, gsplat_impl pallas, GT pose): `cli
    datagen` (32 models, rendered by the plain ops: renderer xla),
    kernel-vs-plain training steps, `cli train` for SPLAT_STEPS with the
    counts set to 0 just before and read just after (one K6 and one K7
    launch a step, nothing else), and one ServingModel call on the trained
    model."""
    from dpcx_torch.config import load_config, save_config
    from dpcx_torch.serve import ServingModel
    from dpcx_torch.train import load_checkpoint

    cfg = load_config(RGB_SPLATS).validate().replace(
        data_dir=str(tmp / "splats_data"),
        checkpoint_dir=str(tmp / "splats"), log_every=1,
        save_every=SPLAT_STEPS)
    assert (cfg.pc_rgb, cfg.pc_gauss, cfg.gsplat_impl, cfg.vox_size,
            cfg.pc_num_points, cfg.batch_size, cfg.views_per_step,
            cfg.pallas_acc_dtype, cfg.predict_pose) == (
        True, True, "pallas", 32, 4096, 8, 4, "float32", False)
    path = str(tmp / "rgb_splats.yaml")
    save_config(cfg, path)
    ds = phase_datagen(cli, fused, path, MODELS, "rgb_splats")
    phase_splat_parity(cfg, ds)

    run_dir = Path(cfg.checkpoint_dir)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-f", path, "-n", str(MODELS), "--steps",
              str(SPLAT_STEPS)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == list(range(1, SPLAT_STEPS + 1))
    vals = np.array([r["loss_total"] for r in recs])
    rgb_vals = np.array([r["loss_rgb"] for r in recs])
    assert np.isfinite(vals).all() and np.isfinite(rgb_vals).all()
    first, last = vals[:20].mean(), vals[-20:].mean()
    print(f"train rgb_splats: {SPLAT_STEPS} steps in {secs:.1f} s (datagen "
          f"cached; log_every 1), loss_total mean of the first 20 "
          f"{first:.6f}, of the last 20 {last:.6f}; loss_rgb "
          f"{rgb_vals[:20].mean():.6f} -> {rgb_vals[-20:].mean():.6f}; "
          f"launches {launches}", flush=True)
    assert last < first, (first, last)
    assert launches == only(aniso_render=SPLAT_STEPS,
                            aniso_render_bwd=SPLAT_STEPS), launches
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(run_dir / "metrics.jsonl",
                OUT_DIR / "chip_smoke_rgb_splats_metrics.jsonl")

    params = load_checkpoint(cfg, DEVICE)["params"]
    model = ServingModel(cfg, params, batch_size=cfg.batch_size)
    imgs = ds.records["images"][:cfg.batch_size, 0]
    served = model(imgs)
    N = cfg.pc_num_points
    shapes = {"points": (N, 3), "scale": (1,), "rgb": (N, 3),
              "gauss_scales": (N, 3), "gauss_rot": (N, 4),
              "gauss_opacity": (N,)}
    assert {k: v.shape[1:] for k, v in served.items()} == shapes, \
        {k: v.shape for k, v in served.items()}
    assert all(np.isfinite(v).all() for v in served.values())
    s = served["gauss_scales"]
    assert (s >= cfg.gauss_scale_min).all() and (s <= cfg.gauss_scale_max
                                                 ).all()
    print(f"serve rgb_splats: {len(imgs)} images -> "
          f"{sorted(served)} of the step-{SPLAT_STEPS} model, finite, scales "
          f"in [{s.min():.4f}, {s.max():.4f}]", flush=True)
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
    from dpcx_torch.render import aniso, fused, gauss
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
    # 3b. K6 and K7 vs their plain version
    aniso_cases = phase_aniso_kernel(aniso)
    aniso_bwd = phase_aniso_backward(aniso, aniso_cases)

    # 4. serve: the first path starts here, with every launch count at 0
    reset_counts()
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
            launches = launch_counts()
            total_plain, metrics_plain = compute_loss(
                cfg.replace(renderer="xla"), preds, batch, step=0,
                train=False,
            )
        assert launches == only(fused_render=1), launches
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
            # 9b. rgb_splats: datagen, parity, train, serve
            sp_cfg, sp_ds, sp_launches = phase_splats(cli, fused, tmp)

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
            aniso_timings, aniso_launch = {}, {}
            for case in aniso_bwd:
                f_ms, b_ms, p_ms, pfb_ms, bwd = time_aniso(aniso, case)
                aniso_timings[case["name"]] = f_ms, b_ms, p_ms, pfb_ms
                aniso_launch[case["name"]] = bwd
                print(f"time K6/K7 {case['name']} ({case['renders']} renders "
                      f"x {case['n']} points, D {case['vox']}, "
                      f"{case['point_cells']} point-cells): K6 {f_ms:.4f} ms "
                      f"(bound {aniso_bound(case, False)[0]:.4f}), K7 "
                      f"{b_ms:.4f} ms (bound {aniso_bound(case, True)[0]:.4f}"
                      f"); the kernels' own f32 operations at peak: K6 "
                      f"{aniso_own_ms(case, False):.4f} ms, K7 "
                      f"{aniso_own_ms(case, True):.4f} ms; plain forward "
                      f"{p_ms:.4f} ms, plain forward + backward "
                      f"{pfb_ms:.4f} ms | {card}", flush=True)
            sp_step_fn = training_step_fn(sp_cfg, sp_ds)
            sp_step_ms = host_ms(sp_step_fn)
            print(f"time train step rgb_splats (B 8 x 4 views, N 4096, D 32, "
                  f"rgb + gauss, bf16 compute): median {sp_step_ms:.3f} ms "
                  f"per step | {card}", flush=True)

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
        sp_case = aniso_bwd[0]
        device_profile(lambda: aniso.aniso_density(*aniso_args(sp_case)),
                       "K6 rgb_splats (with the z-ranges)")
        device_profile(aniso_launch[sp_case["name"]],
                       "K7 rgb_splats (launch on the saved inputs)")
        step = device_profile(sp_step_fn, "train step rgb_splats", runs=10,
                              top=16, host_top=12)
        print_step_breakdown(step, "rgb_splats")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    bf16_ms, bf16_by = render_bound(
        32, cfg.pc_num_points, cfg.vox_size, cases[0]["args"][3], True, True,
        False, True, bf16=True)
    print(f"bound K1 bfloat16 mode (not ported) at the car_64_depth render: "
          f"{bf16_ms:.4f} ms ({bf16_by}) | {card}", flush=True)
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

    def splat_entry(name, replaces, backward):
        case = aniso_bwd[0]
        f_ms, b_ms, p_ms, pfb_ms = aniso_timings[case["name"]]
        bound_ms, bound_by = aniso_bound(case, backward)
        errs = ([c["err"] for c in aniso_bwd] if backward
                else [c["err"] for c in aniso_cases])
        out = {"name": name, "route": "cuda",
               "source": "dpcx_torch/csrc/aniso_splat.cu",
               "replaces": replaces, "launches": sp_launches[name],
               "max_abs_err": max(errs), "ms": b_ms if backward else f_ms,
               "plain_ms": pfb_ms - p_ms if backward else p_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if backward:
            out["note"] = ("plain_ms: the plain forward + backward less its "
                           "forward, CUDA events")
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
        splat_entry("aniso_render", "dpcx/render/pallas_gsplat.py:88", False),
        splat_entry("aniso_render_bwd", "dpcx/render/pallas_gsplat.py:187",
                    True),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
