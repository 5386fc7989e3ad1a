#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dpcx_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --splat-times TREE

The second form times only K6, K7 and the rgb_splats training step of
the checkout at TREE (splat_times), for an A/B of a splat kernel change
against an older commit. The first runs these phases, each of which
raises on failure (exit code non-zero):

1. build    — compile the CUDA kernels from dpcx_torch/csrc with nvcc,
              and print each kernel's stack frame and spills (ptxas).
2. kernel   — the fused splat->blur->DRC forward against its plain
              PyTorch version on the card: K1 at the car_64_depth training
              render shape (32 renders x 16000 points, D 64, with depth),
              the chair_gt_pose one (64 x 8000, D 32, no depth) and the
              chair_pred_pose one (256 x 2048, D 32, no depth); the
              counterpart of the depth-blocked K3 at the multicat_128_fused
              one (16 x 16000, D 128, no depth), at D 128 with depth (8
              renders) and at D 72.
3. backward — the backward kernels against the plain version with K2's
              backward written out (fused_project_plain) for a random
              linear functional of sil and depth, at every shape of phase
              2, with dropout weights: K2 at D <= 64;
              at D > 64 the counterpart of K4 + K5 with the saved grid and
              with the recompute (remat), each against plain and against
              each other.
3c. bf16    — the bfloat16 operand mode against the plain bfloat16
              forward and fused_backward_reference, with dropout weights:
              K1 and K2 at the car_64_depth and chair_pred_pose renders,
              and the counterparts of K3 and K4 + K5 at the
              multicat_128_fused render (16 x 16000, D 128, R 16; the
              backward with the saved grid and with the recompute): the
              forward within 1e-5 of the largest plain value, the
              gradients within 2^-8 of it and 1e-3 in relative L2; the
              float32 mode on the same inputs must miss the forward's and
              the relative L2 limits.
3b. splats  — the anisotropic splat forward (the counterpart of K6)
              against its plain version at the rgb_splats training render
              (32 renders x 4096 points, D 32, rgb), density only, and at
              N 1000 (pads); the backward (K7) against autograd through the
              plain version, all 32 renders, for a random linear functional
              of the density and colour grids, with dropout weights; and
              the float32 aniso_backward_reference (K7's function written
              out) against the same autograd gradients.
3d. splats bf16 — K6 and K7 in bfloat16 operand mode against the plain
              bfloat16 forward and aniso_backward_reference (the raw moments
              over dpcx's rounded basis) at the rgb_splats render, its
              density-only variant (phase 3b's inputs and cotangents) and
              8 x 4096 at D 64 with rgb: the forward within 1e-5 of the
              largest plain value, each gradient group (mu, A6, w, rgb)
              within 2^-8 of its largest and 1e-3 in relative L2; the
              float32-mode kernels on the same inputs must miss the
              forward's and the relative L2 limits.
4. serve    — experiments/car_64_depth.yaml at full width, seeded random
              weights, behind the HTTP server: 3 requests of 1, 16 and 20
              images (padding, chunking, uint8), checked against a direct
              ServingModel call and the /healthz counter.
5. score    — 8 served clouds scored by the GT-pose loss forward with
              renderer: pallas (one K1 launch) against 4 seeded views
              each, and the same loss rendered by the plain ops.
6. datagen  — `cli datagen` for car_64_depth, 32 models, GT views through
              K1, into a temporary data_dir.
7. parity   — 3 training steps through K1 + K2 against 3 through the
              plain version handed to train_step (fused_project_plain),
              from the same init, batches and dropout generator, in
              float32: per-parameter first-step gradients and the three
              losses.
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
              first run's; then with pallas_acc_dtype: bfloat16 (K3 and
              K4 + K5 in bfloat16 mode) 3 kernel-vs-plain steps, `cli
              train` for 40 steps (one bfloat16 forward and backward launch
              per step, the loss falling, a checkpoint) and 3 remat steps
              (two bfloat16 forwards and one bfloat16 recompute backward per
              step) whose losses equal that run's.
9b. splats  — experiments/rgb_splats.yaml at full width (N 4096 with rgb
              and gauss heads, D 32, B 8 x 4 views, gsplat_impl pallas, GT
              pose): `cli datagen` (32 models, plain ops: renderer xla), 3
              float32 training steps through K6 + K7 against 3 through the
              plain version, `cli train` for 200 steps (finite losses,
              loss_rgb logged, the last 20 below the first 20, exactly one
              K6 and one K7 launch per step and no other kernel's), and a
              ServingModel call on the trained model (rgb and gauss heads);
              then with pallas_acc_dtype: bfloat16 (K6 and K7's bfloat16
              mode) 3 kernel-vs-plain steps (which must lie farther from the
              float32 ones than the limit), `cli train` for 100 steps (one
              bfloat16 K6 and K7 launch per step and nothing else, finite
              loss_total and loss_rgb, the last fifth below the first, a
              checkpoint) and a ServingModel call on that model.
9c. pose    — experiments/chair_pred_pose.yaml at full width (image 128,
              N 2048, D 32, B 8, K 8 candidates, 4 views predicted from
              their own images, student, renderer pallas): `cli datagen`
              (32 models), 3 float32 training steps through K1 + K2 against
              3 through the plain version (as phase 7, and equal winners),
              `cli train` for 200 steps (finite losses, the last 20 below
              the first 20, gauge_spread_deg logged, one K1 and one K2
              launch per step), the gauge reseed drive (threshold 1 degree,
              check step 30, one retry, 60 steps), then with
              pallas_acc_dtype: bfloat16 3 kernel-vs-plain steps (which
              must lie farther from the float32 ones than the limit) and `cli
              train` for 100 steps (one K1 and one K2 launch of the
              bfloat16 mode per step), and a ServingModel call on the
              trained model (a unit "pose" per image).
9d. shard   — experiments/largecloud_pointshard.yaml as shipped (N 131072,
              D 32, renderer xla, shard_points on one card: a no-op that
              warns once per verb, as dpcx on one device): `cli datagen`
              (32 models) and `cli train` for 30 steps (finite losses, the
              last 10 below the first 10, no kernel launch).
10. time    — CUDA-event medians: each forward and backward kernel
              against its plain version at the shapes of phases 2, 3b and
              3c (the recompute backward too) and at the rgb_splats render
              of phase 3d (K6/K7 beside their bound, the floor of one exp a
              point-cell on the MUFU, and the kernels' own operation
              count); host-clock serve latency at batch 16 and the
              median car_64_depth, multicat_128, rgb_splats and
              chair_pred_pose training steps (the last three in both
              operand modes).
11. profile — torch.profiler device time per kernel, per call, of K1, K2,
              the D > 64 forward and backward (both modes), K6 and K7 (both
              modes), the scoring forward, the batch-16 ServingModel call
              and one training step of each of car_64_depth, multicat_128,
              rgb_splats and chair_pred_pose (the last three in both
              modes; with its time by layer), beside the host time per
              call and the share
              of it in which the card is idle. Wherever a kernel's device
              time is read (the kernel profiles and the steps), the
              profiler's time of the renderer kernels is held against CUDA
              events around their C entry points in the same calls: below
              half of it, the profile is taken again, and still short, the
              phase fails.

Data and checkpoints go to a temporary directory that is removed at the
end; the car_64_depth, multicat_128, rgb_splats and chair_pred_pose runs'
metrics.jsonl are copied to OUT_DIR. The last lines are the run's seconds,
the card's name and power limit (nvidia-smi), a JSON line describing each
kernel (its launches on the main path, its largest error against its plain
version, its time, its plain version's time, and the least time the card
could take for the same work), and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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
LARGECLOUD = REPO / "experiments" / "largecloud_pointshard.yaml"
CHAIR = REPO / "experiments" / "chair_gt_pose.yaml"
MULTICAT = REPO / "experiments" / "multicat_128_fused.yaml"
RGB_SPLATS = REPO / "experiments" / "rgb_splats.yaml"
PRED_POSE = REPO / "experiments" / "chair_pred_pose.yaml"
OUT_DIR = REPO / "chiprun_out"
KERNEL_ATOL = 1e-4  # atomics reorder the f32 splat sums from run to run
GRAD_RTOL = 1e-3  # backward vs plain: of the largest plain gradient, same
# reason
LOSS_RTOL = 1e-4
TRAIN_RTOL = 1e-3  # kernel vs plain training: gradient L2 and losses
SEED = 0
DEVICE = "cuda"
TRAIN_STEPS, RESUME_STEPS, CHAIR_STEPS, MODELS = 200, 10, 20, 32
MULTICAT_STEPS, REMAT_STEPS, SPLAT_STEPS = 100, 3, 200
MULTICAT_BF16_STEPS, LARGECLOUD_STEPS, SPLAT_BF16_STEPS = 40, 30, 100
POSE_STEPS, RESEED_STEPS, RESEED_CHECK, POSE_BF16_STEPS = 200, 60, 30, 100
# K1/K2 bf16 vs the plain bf16 version, of the largest plain value: the
# forward within BF16_FWD_SHARE (its bf16 operands are products of bf16
# values, whose f32 sums rarely depend on their order); the gradients within
# BF16_SHARE in max abs and BF16_GRAD_L2 in relative L2 (a rounded
# cotangent flips where two f32 sums in other orders straddle a bf16
# boundary). The float32 mode on the same inputs must miss the forward's and
# the relative L2 limits, which shows the rounding points are the kernels'
BF16_FWD_SHARE, BF16_SHARE, BF16_GRAD_L2 = 1e-5, 2.0**-8, 1e-3
SPLAT_GRAD_RTOL = 2e-4  # K7 vs plain: relative L2, dpcx's own bound for
# its Pallas backward against the dense oracle
# the kernels of csrc/fused_render.cu, as torch.profiler names them
K1_STAGES = ("splat_kernel", "blur_yx_kernel", "zblur_drc_kernel")
# every kernel of csrc/*.cu: what the profiler check (check_profile) sums
RENDER_KERNELS = ("splat_kernel", "blur_yx_kernel", "zblur_kernel",
                  "zblur_drc_kernel", "zblur_drc_bwd_kernel",
                  "drc_bwd_kernel", "zblock_transpose_kernel",
                  "splat_bwd_kernel", "aniso_fwd_kernel", "aniso_bwd_kernel")
# their C entry points (csrc/*.cu), which launch_event_ms times
C_ENTRIES = ("dpcx_fused_render", "dpcx_fused_render_bwd",
             "dpcx_fused_render_bwd_recompute", "dpcx_aniso_render",
             "dpcx_aniso_render_bwd")
SHARD_WARNING = "shard_points on a single device is a no-op"
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
# The bfloat16 mode (rgb / density only): its quadratic form, exponential,
# t_c and u stay f32 and count at PEAK_F32_FLOPS, its rounded-operand
# products (Pallas matmuls) at PEAK_BF16_FLOPS: per point-cell the f32 and
# the bf16 operations, then per row and per plane as above. Forward: e (5)
# in f32; the density row and the three colour rows (8) in bf16, since
# dpcx sums the density as row 0 of the same matmul, E = rnd(e) rnd([1, r,
# g, b]) (pallas_gsplat.py:140-165); density only, its row alone (2).
# Backward: e (5), t_c (3), u (7; density only e ct_d, 1) in f32, the six
# basis rows (12) and the three colour sums (6) in bf16; a row forms its
# coefficients (12), a plane its dz terms (6)
ANISO_FWD_BF16_OPS = {True: (5, 8, 12, 6), False: (5, 2, 12, 6)}
ANISO_BWD_BF16_OPS = {True: (15, 18, 12, 6), False: (6, 12, 12, 6)}
# What csrc/aniso_splat.cu itself spends per point-cell, printed beside the
# bound: by mode (bf16), then K6 / K7 (backward), then rgb / density only;
# an FMA 2, ex2.approx 1, expf 8 (its range reduction and polynomial, as
# the .cu header counts it), a bf16 rounding 0, the row terms spread over
# the cells that share them (at D 32: 4 cells a thread in K6, 32 in K7).
# f32 K6: dx, 2 FMAs, ex2, the density sum and 3 colour FMAs (13; density
# only 7) and the row's dy, base, m once per 4 cells (8 / 4). f32 K7: e as
# K6 (6), v = ct_d + r ct_r + g ct_g + b ct_b (3 FMAs), u = e v, 3 colour
# FMAs, sum u, u dx, (u dx) dx (5) (24; density only u = e ct_d, 12) and
# a row's dz and dy terms and its fold into ten moments (~35 / 32). bf16
# K6 (D 32, the sums on the tensor cores): dx, the uncontracted exponent
# (5), expf (8) and exact_row per 4 cells (9 / 4) (16, with rgb or
# without: the sums are 8 bf16 MACs a point-cell, not counted here). bf16
# K7: dx, exponent (5), expf (8), e ct (4), u (6), the colour sums (3),
# the moment sums (5) (32; density only 20) and the row's terms (~20 /
# 32; its fold is 10 float64 FMAs)
ANISO_KERNEL_OPS = {
    False: {False: {True: 15, False: 9}, True: {True: 25, False: 13}},
    True: {False: {True: 16, False: 16}, True: {True: 33, False: 21}},
}
# one exp per point-cell on the MUFU, 16 a clock per SM on 132 SMs at the
# H100 SXM's 1.98 GHz boost clock: a floor beside the bound (which counts
# exp2 as one operation at the FMA rate), printed as information
MUFU_EXP_PER_S = 132 * 16 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def ptxas_report(log: str) -> list[tuple[str, int, int, int, int]]:
    """(kernel, stack frame bytes, spill store + load bytes, registers,
    static shared memory bytes) per function from nvcc's -Xptxas=-v
    output; a template kernel as name<args>."""
    out, name, frame = [], None, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            k = re.search(r"([a-z_]+_kernel(?:_mma)?)((?:I?L[ib]\d+E)*)",
                          m.group(1))
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([ib])(\d+)E",
                                           k.group(2) if k else "")]
            name = (m.group(1) if k is None else
                    k.group(1) + (f"<{', '.join(args)}>" if args else ""))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (int(m.group(1)), int(m.group(2)) + int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and frame:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, *frame, int(m.group(1)),
                        int(smem.group(1)) if smem else 0))
            name = frame = None
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


def host_times(fn, runs: int = 20, warmup: int = 2) -> list[float]:
    """Host milliseconds of each of ``runs`` calls of fn(), which must end
    synchronised, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def host_ms(fn, runs: int = 20, warmup: int = 2) -> float:
    """Median host milliseconds of fn(), which must end synchronised."""
    return statistics.median(host_times(fn, runs, warmup))


def launch_event_ms(fn, runs: int = 10) -> float:
    """ms per call of fn() between CUDA events recorded around each call of
    the csrc kernels' C entry points (the library dpcx_torch._build loads),
    summed over the call: their device time, and the host's gaps between
    the kernels of one entry."""
    from dpcx_torch import _build

    lib = _build.load()
    events, real = [], {name: getattr(lib, name) for name in C_ENTRIES}
    for name, entry in real.items():
        def timed(*a, _entry=entry):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            err = _entry(*a)
            e1.record()
            events.append((e0, e1))
            return err

        setattr(lib, name, timed)
    try:
        fn()  # warm-up
        torch.cuda.synchronize()
        events.clear()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    finally:
        for name, entry in real.items():
            setattr(lib, name, entry)
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / runs


def device_profile(fn, label: str, runs: int = 20, top: int = 8,
                   host_top: int = 0,
                   check: bool = True) -> list[tuple[str, float]]:
    """Print torch.profiler's device microseconds per call of fn(), summed
    and per kernel (memsets and copies included), beside the host
    microseconds per call measured without the profiler, and with
    ``host_top`` the host ops of the most self CPU time; return the
    per-kernel list, largest first. With ``check`` fn launches csrc
    kernels, and the profiler's time of them (RENDER_KERNELS) is held
    against launch_event_ms: below half of it the profile is taken once
    more, and still short, this raises (the profiler has dropped
    records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def synced():
        fn()
        torch.cuda.synchronize()

    def take():
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        return prof, sorted(
            ((e.key, e.self_device_time_total / runs)
             for e in prof.key_averages() if e.device_type == DeviceType.CUDA
             # a user annotation (Optimizer.step#Adam.step) spans kernels
             # that are counted on their own
             and not getattr(e, "is_user_annotation", False)),
            key=lambda kv: -kv[1],
        )

    host_us = host_ms(synced, runs=runs) * 1e3
    prof, kernels = take()
    if check:
        event_us = launch_event_ms(fn) * 1e3
        assert event_us > 0, f"{label}: no csrc kernel launched"
        for attempt in (1, 2):
            prof_us = sum(us for name, us in kernels
                          if any(k in name for k in RENDER_KERNELS))
            print(f"profile check {label} (attempt {attempt}): csrc kernels "
                  f"{prof_us:.1f} us per call by torch.profiler, "
                  f"{event_us:.1f} us by CUDA events around their C entry "
                  f"points, ratio {prof_us / event_us:.3f} (at least 0.5)",
                  flush=True)
            if prof_us >= 0.5 * event_us:
                break
            assert attempt == 1, (f"{label}: torch.profiler read "
                                  f"{prof_us:.1f} us against {event_us:.1f}")
            prof, kernels = take()
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
        ("chair_pred_pose", 256, 2048, 32, False),
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


def check_grads(label, got, want) -> float:
    """Kernel gradients (d ndc, d weights) against ``want``: max abs error
    within GRAD_RTOL of the largest |want|."""
    worst = 0.0
    for name, a, b in zip(("d ndc", "d weights"), got, want):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        print(f"backward check {label} {name}: max abs err {err:.3e}, max "
              f"|ref| {scale:.3e}, ratio {err / scale:.3e} (bound "
              f"{GRAD_RTOL})", flush=True)
        assert np.isfinite(err) and scale > 0, (err, scale)
        assert err <= GRAD_RTOL * scale, (label, name, err, scale)
        worst = max(worst, err)
    return worst


def phase_backward(cases, fused) -> list[dict]:
    """The backward kernels against the plain version with K2's backward
    written out (fused_project_plain: its hat derivative is 0 at an exactly
    integer grid coordinate, as the kernels' and dpcx's _dhat_t), at the
    forward's shapes, with dropout weights (keep-prob 0.1: weights 0 or
    10); at D > 64 in both modes, and the two modes against each other."""
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
            lambda x, w: fused.fused_project_plain(x, vox, sigma, radius, w,
                                                   **kw),
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
                                     g_p)
        if len(modes) == 2:
            check_grads(f"{case['name']} saved grid vs recompute",
                        grads[True], grads[False])
        out.append(dict(name=case["name"], ndc=ndc, pw=pw, vox=vox,
                        sigma=sigma, radius=radius, with_depth=with_depth,
                        dsil=dsil, ddepth=ddepth, err=max(errs.values()),
                        grads=grads[True]))
    return out


def time_backward(fused, case, save_grid: bool = True, bf16: bool = False):
    """CUDA-event ms of the backward kernel alone (the launch on saved
    residuals, or the recompute launch from coords alone) and of the plain
    version's backward (fused_backward_reference, which recomputes the
    grid), in ``bf16``'s operand mode; and the kernel's launch itself for
    the profiler."""
    from dpcx_torch.render.gauss import gauss_kernel_1d

    ndc, pw, vox, radius = case["ndc"], case["pw"], case["vox"], case["radius"]
    wd = case["with_depth"]
    coords = ((ndc.flip(1) + 0.5) * vox - 0.5).contiguous()
    taps = gauss_kernel_1d(case["sigma"], radius).contiguous()
    _, _, grid = fused._launch_forward(coords, pw, taps, radius, vox, wd,
                                       bf16)
    if not save_grid:
        grid = None

    def bwd():
        fused._launch_backward(coords, pw, taps, radius, grid, case["dsil"],
                               case["ddepth"], vox, wd, True, bf16)

    k_ms = cuda_ms(bwd)
    p_ms = cuda_ms(lambda: fused.fused_backward_reference(
        ndc, vox, case["sigma"], radius, pw, wd, case["dsil"],
        case["ddepth"], "bfloat16" if bf16 else "float32"))
    return k_ms, p_ms, bwd


def blur_taps(d: int, r: int) -> int:
    """In-range taps of one 1-D blur pass along a line of d cells (SAME
    zero padding: a tap past the grid reads nothing)."""
    return sum(min(r, d - 1 - i) + min(r, i) + 1 for i in range(d))


def render_bound(renders, n, vox, radius, with_depth, weights, backward,
                 bf16=False) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of the function of one forward
    or backward call: the larger of its operations over the card's peak
    rate for their type and its bytes (each input read once, each output
    written once) over PEAK_BYTES_PER_S. The forward's outputs are the
    images alone: the x/y-blurred grid the kernels keep for the backward is
    their choice, not the function's. The backward takes the lesser of two
    ways to it: reading such a grid, or recomputing it (the splat and the
    y/x blur again, no grid bytes). In f32 every operation counts at
    PEAK_F32_FLOPS. ``bf16``: K1/K2's bfloat16 mode, whose Pallas kernels
    run the splat, the blur passes and the splat backward's products as
    bf16 matmuls: those operations over PEAK_BF16_FLOPS, DRC and its
    backward in f32; inputs and outputs stay f32."""
    cells = renders * vox**3
    blur_pass = 2 * renders * vox * vox * blur_taps(vox, radius)
    pts = renders * n
    depth_ops = DEPTH_OPS if with_depth else 0
    point_bytes = 4 * pts * (4 if weights else 3)
    image_bytes = 4 * renders * vox * vox * (2 if with_depth else 1)
    taps_bytes = 4 * (2 * radius + 1)

    def least(mm_ops, f32_ops, nbytes):
        if bf16:
            t_ops = (mm_ops / PEAK_BF16_FLOPS + f32_ops / PEAK_F32_FLOPS) * 1e3
        else:
            t_ops = (mm_ops + f32_ops) / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                               "bytes")

    if not backward:  # splat, 3 blur passes, DRC
        return least(SPLAT_OPS * pts + 3 * blur_pass,
                     (DRC_OPS + depth_ops) * cells,
                     point_bytes + taps_bytes + image_bytes)
    # z-blur again, its transpose, the y and x transposes, DRC backward,
    # splat backward; on a read grid, or with the splat and y/x blur redone
    mm_ops = 4 * blur_pass + SPLAT_BWD_OPS * pts
    f32_ops = (DRC_BWD_OPS + depth_ops) * cells
    nbytes = 2 * point_bytes + taps_bytes + image_bytes
    return min(least(mm_ops, f32_ops, nbytes + 4 * cells),
               least(mm_ops + SPLAT_OPS * pts + 2 * blur_pass, f32_ops,
                     nbytes))


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
    (RENDER_BWD, ("drc_bwd_kernel", "zblock_transpose_kernel",
                  "splat_bwd_kernel")),
    (RENDER_FWD, ("zblur_drc_kernel", "zblur_kernel", "splat_kernel")),
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


def winners(cfg, sil, masks) -> torch.Tensor:
    """The predicted-pose loss's winners ([B, V] with pose_from_views, else
    [B]) from its renders sil [B*K*V, D, D] and the batch's masks."""
    from dpcx_torch.models.losses import candidate_scores

    B, V, D = masks.shape[0], masks.shape[1], cfg.vox_size
    K = cfg.pose_predict_num_candidates
    l_kv = ((sil.reshape(B, K, V, D, D) - masks[:, None]) ** 2).mean((3, 4))
    l_k = l_kv if cfg.pose_from_views else l_kv.mean(2)
    return torch.argmin(candidate_scores(cfg, l_k, None), dim=1)


def phase_parity(cfg, ds, want: dict):
    """3 float32-compute training steps through the kernels against 3
    through the plain versions, from the same init, batches and dropout
    generator: per-parameter first-step gradients and the three losses
    within TRAIN_RTOL, and under predicted pose every step's winners equal.
    The plain side is handed to train_step: fused_project_plain (whose
    backward is K2's function, the hat derivative 0 at an exactly integer
    grid coordinate included), and aniso_density_reference in float32 or
    aniso_density_plain (K7's bfloat16 function written out) in bfloat16.
    ``want``: the
    launches the kernel steps make (the plain steps make none). Returns
    the kernel run's (losses, first-step gradients)."""
    from dpcx_torch.render import aniso, fused
    from dpcx_torch.train import batch_at, create_state, step_generator
    from dpcx_torch.train import train_step

    def fused_plain(ndc_t, vox, sigma, radius, point_weights=None,
                    with_depth=False, acc_dtype="float32", save_grid=True):
        return fused.fused_project_plain(ndc_t, vox, sigma, radius,
                                         point_weights, with_depth,
                                         acc_dtype)

    def aniso_plain(mu, A6, w, rgb, rz, vox, acc_dtype="float32"):
        if acc_dtype == "bfloat16":
            return aniso.aniso_density_plain(mu, A6, w, rgb, rz, vox,
                                             acc_dtype)
        return aniso.aniso_density_reference(mu, A6, w, rgb, rz, vox)

    c = cfg.replace(compute_dtype="float32")
    runs = {}
    for label, project, density in (
            ("kernel", fused.fused_project_t, aniso.aniso_density),
            ("plain", fused_plain, aniso_plain)):
        sils = []

        def recorded(*a, render=project, **k):
            out = render(*a, **k)
            sils.append(out[0].detach())
            return out

        state = create_state(
            c, DEVICE, torch.Generator(device=DEVICE).manual_seed(c.seed))
        before = launch_counts()
        losses, grads, won = [], None, []
        for step in range(3):
            batch = batch_at(c, ds, step, DEVICE)
            m = train_step(c, state, batch,
                           step_generator(c.seed + 1, step, DEVICE),
                           density_fn=density, project_fn=recorded)
            losses.append(m["loss_total"].item())
            if grads is None:
                grads = {n: p.grad.detach().clone()
                         for n, p in state.model.named_parameters()}
            if c.predict_pose:
                won.append(winners(c, sils[-1], batch["masks"]).cpu())
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in launch_counts().items()}
        assert made == (only(**want) if label == "kernel" else only()), \
            (label, made)
        runs[label] = losses, grads, won
    (l_k, g_k, w_k), (l_p, g_p, w_p) = runs["kernel"], runs["plain"]
    worst_name, worst = worst_grad(g_k, g_p)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_k, l_p))
    same = [torch.equal(a, b) for a, b in zip(w_k, w_p)]
    print(f"parity {cfg.name} ({cfg.pallas_acc_dtype}): first-step "
          f"gradients, worst relative L2 {worst:.3e} ({worst_name}; bound "
          f"{TRAIN_RTOL}); losses kernel {l_k} vs plain {l_p}, worst rel "
          f"{loss_rel:.3e} (bound {TRAIN_RTOL}); launches {want}"
          + (f"; winners per step equal {same}, first step "
             f"{w_k[0].tolist()}" if c.predict_pose else ""), flush=True)
    assert worst <= TRAIN_RTOL, (worst_name, worst)
    assert loss_rel <= TRAIN_RTOL, loss_rel
    assert len(same) == (3 if c.predict_pose else 0) and all(same), same
    return l_k, g_k


def worst_grad(got: dict, want: dict) -> tuple[str, float]:
    """(name, relative L2) of the parameter gradient in ``got`` farthest
    from ``want``'s; one that ``want`` has as zeros must be zeros in
    ``got`` (a branch the loss does not reach)."""
    worst_name, worst = "", 0.0
    for name, gp in want.items():
        norm = torch.linalg.vector_norm(gp).item()
        if norm == 0.0:
            assert torch.equal(got[name], gp), name
            continue
        rel = torch.linalg.vector_norm(got[name] - gp).item() / norm
        if rel > worst:
            worst_name, worst = name, rel
    return worst_name, worst


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


def multicat_train(cli, path: str, run_dir: Path, steps: int, mode: str,
                   label: str) -> tuple[dict, np.ndarray]:
    """`cli train` of a multicat_128 config for ``steps`` with the counts
    set to 0 just before and read just after: finite losses, the mean of
    the last ``steps // 5`` below the first's, exactly one D > 64 forward
    and one D > 64 backward launch of ``mode`` ("" or "_bf16") per step,
    and a checkpoint. Returns (launches, losses)."""
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-f", path, "-n", str(MODELS), "--steps", str(steps)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    losses = read_losses(run_dir)
    assert [s for s, _ in losses] == list(range(1, steps + 1))
    vals = np.array([v for _, v in losses])
    assert np.isfinite(vals).all()
    k = steps // 5
    first, last = vals[:k].mean(), vals[-k:].mean()
    print(f"train {label}: {steps} steps in {secs:.1f} s (datagen cached; "
          f"log_every 1), loss_total mean of the first {k} {first:.6f}, of "
          f"the last {k} {last:.6f}; launches {launches}", flush=True)
    assert last < first, (first, last)
    assert launches == only(**{f"blocked_render{mode}": steps,
                               f"blocked_render_bwd{mode}": steps}), launches
    assert (run_dir / "ckpt" / f"{steps}.pt").exists()
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(run_dir / "metrics.jsonl",
                OUT_DIR / f"chip_smoke_{label}_metrics.jsonl")
    return launches, vals


def multicat_remat(cli, cfg, tmp: Path, mode: str, want: list) -> None:
    """REMAT_STEPS of ``cfg`` with remat: true: the checkpointed forward
    runs again in the backward (a second forward launch), whose backward
    recomputes the grid from coords; the losses equal ``want`` (the run
    without remat) within TRAIN_RTOL."""
    from dpcx_torch.config import save_config

    remat = cfg.replace(remat=True, checkpoint_dir=str(tmp / f"remat{mode}"))
    remat_path = str(tmp / f"remat{mode}.yaml")
    save_config(remat, remat_path)
    reset_counts()
    cli.main(["train", "-f", remat_path, "-n", str(MODELS), "--steps",
              str(REMAT_STEPS)])
    torch.cuda.synchronize()
    launches = launch_counts()
    got = [v for _, v in read_losses(Path(remat.checkpoint_dir))]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"train multicat_128_fused{mode} remat: {REMAT_STEPS} steps, "
          f"loss_total {got} vs without remat {want}, worst rel {rel:.3e} "
          f"(bound {TRAIN_RTOL}); launches {launches}", flush=True)
    assert len(got) == REMAT_STEPS and rel <= TRAIN_RTOL, (got, want)
    assert launches == only(**{
        f"blocked_render{mode}": 2 * REMAT_STEPS,
        f"blocked_render_bwd_recompute{mode}": REMAT_STEPS}), launches


def phase_multicat(cli, fused, tmp: Path):
    """multicat_128_fused at full width: datagen, kernel-vs-plain steps,
    `cli train` for MULTICAT_STEPS, REMAT_STEPS with remat: true; then in
    bfloat16 operand mode (K3 and K4 + K5's) kernel-vs-plain steps, `cli
    train` for MULTICAT_BF16_STEPS and REMAT_STEPS with remat. Returns (the
    float32 config, the bfloat16 config, the data, the float32 run's
    launches, the bfloat16 run's launches)."""
    from dpcx_torch.config import load_config, save_config

    cfg = load_config(MULTICAT).validate().replace(
        data_dir=str(tmp / "multicat_data"),
        checkpoint_dir=str(tmp / "multicat"), log_every=1,
        save_every=MULTICAT_STEPS)
    assert (cfg.vox_size, cfg.renderer, cfg.proj_depth, cfg.predict_pose,
            cfg.remat, cfg.pallas_acc_dtype) == (128, "pallas", False, False,
                                                 False, "float32")
    path = str(tmp / "multicat.yaml")
    save_config(cfg, path)
    ds = phase_datagen(cli, fused, path, MODELS, "multicat_128_fused")
    phase_parity(cfg, ds, dict(blocked_render=3, blocked_render_bwd=3))
    launches, vals = multicat_train(cli, path, Path(cfg.checkpoint_dir),
                                    MULTICAT_STEPS, "", "multicat_128")
    multicat_remat(cli, cfg, tmp, "", list(vals[:REMAT_STEPS]))

    # the bfloat16 operand mode of the depth-blocked kernels
    bf = cfg.replace(pallas_acc_dtype="bfloat16",
                     checkpoint_dir=str(tmp / "multicat_bf16"),
                     save_every=MULTICAT_BF16_STEPS)
    bf_path = str(tmp / "multicat_bf16.yaml")
    save_config(bf, bf_path)
    phase_parity(bf, ds, dict(blocked_render_bf16=3,
                              blocked_render_bwd_bf16=3))
    bf_launches, bf_vals = multicat_train(
        cli, bf_path, Path(bf.checkpoint_dir), MULTICAT_BF16_STEPS, "_bf16",
        "multicat_128_bf16")
    multicat_remat(cli, bf, tmp, "_bf16", list(bf_vals[:REMAT_STEPS]))
    return cfg, bf, ds, launches, bf_launches


def phase_largecloud(cli, fused, tmp: Path) -> None:
    """experiments/largecloud_pointshard.yaml as shipped (shard_points on
    one card, N 131072, D 32, renderer xla), data and checkpoints moved to
    ``tmp``: `cli datagen` and `cli train` for LARGECLOUD_STEPS, each with
    dpcx's one-device warning exactly once, finite and falling losses, no
    kernel launch (renderer xla)."""
    import warnings

    from dpcx_torch.config import load_config, save_config

    cfg = load_config(LARGECLOUD).replace(
        data_dir=str(tmp / "largecloud_data"),
        checkpoint_dir=str(tmp / "largecloud"), log_every=1,
        save_every=LARGECLOUD_STEPS)
    assert (cfg.shard_points, cfg.pc_num_points, cfg.vox_size,
            cfg.renderer) == (True, 131072, 32, "xla")
    path = str(tmp / "largecloud.yaml")
    save_config(cfg, path)
    for verb, extra in (("datagen", []),
                        ("train", ["--steps", str(LARGECLOUD_STEPS)])):
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            cli.main([verb, "-f", path, "-n", str(MODELS), *extra])
        torch.cuda.synchronize()
        said = [str(w.message) for w in seen
                if SHARD_WARNING in str(w.message)]
        print(f"largecloud_pointshard cli {verb}: "
              f"{time.perf_counter() - t0:.1f} s, warnings {said}, launches "
              f"{launch_counts()}", flush=True)
        assert len(said) == 1, [str(w.message) for w in seen]
        assert launch_counts() == only(), launch_counts()
    vals = np.array([v for _, v in read_losses(Path(cfg.checkpoint_dir))])
    assert len(vals) == LARGECLOUD_STEPS and np.isfinite(vals).all(), vals
    k = LARGECLOUD_STEPS // 3
    first, last = vals[:k].mean(), vals[-k:].mean()
    print(f"train largecloud_pointshard (N {cfg.pc_num_points}, unsharded "
          f"on one card): loss_total mean of the first {k} {first:.6f}, of "
          f"the last {k} {last:.6f}", flush=True)
    assert last < first, (first, last)
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(Path(cfg.checkpoint_dir) / "metrics.jsonl",
                OUT_DIR / "chip_smoke_largecloud_metrics.jsonl")


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
    gradient (mu, A6, w, rgb) within SPLAT_GRAD_RTOL; and the float32
    aniso_backward_reference (K7's function written out, the plain side of
    phase 3d) against the same autograd gradients, under the same bound."""
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
        pk = aniso.pack(case["mu"], case["A6"], case["w"], case["rgb"])
        z_lo, z_hi = aniso.z_ranges(case["mu"][..., 0], case["rz"], vox)
        dpk = aniso.aniso_backward_reference(pk, z_lo, z_hi, ct, vox,
                                             with_rgb)
        g_r = [dpk[:, a:b].transpose(1, 2).reshape(g.shape)
               for (a, b), g in zip(((0, 3), (3, 9), (9, 10), (10, 13)), g_p)]
        worst, err = 0.0, 0.0
        for name, a, b, r in zip(("mu", "A6", "w", "rgb"), g_k, g_p, g_r):
            rel, rel_r = ((torch.linalg.vector_norm(x - b)
                           / torch.linalg.vector_norm(b)).item()
                          for x in (a, r))
            err = max(err, (a - b).abs().max().item())
            print(f"backward check K7 {case['name']} d {name}: relative L2 "
                  f"{rel:.3e} (bound {SPLAT_GRAD_RTOL}), max abs err "
                  f"{(a - b).abs().max().item():.3e}, max |plain| "
                  f"{b.abs().max().item():.3e}; aniso_backward_reference "
                  f"relative L2 {rel_r:.3e}", flush=True)
            assert np.isfinite(rel) and rel <= SPLAT_GRAD_RTOL, (name, rel)
            assert rel_r <= SPLAT_GRAD_RTOL, (name, rel_r)
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


def phase_aniso_bf16(aniso, bwd_cases) -> list[dict]:
    """K6 and K7 in bfloat16 operand mode against the plain bfloat16 forward
    and aniso_backward_reference (raw moments of rnd(u) over dpcx's rounded
    basis, centred at the end) on the same inputs: the rgb_splats render
    and its density-only variant (phase 3b's inputs and cotangents), and
    8 x 4096 at D 64 with rgb (the shape of dpcx's D 64 gsplat bench key).
    The forward within BF16_FWD_SHARE of the largest plain value, each
    gradient group (mu, A6, w, rgb of the packed gradient) within BF16_SHARE
    of its largest and BF16_GRAD_L2 in relative L2. Control: the
    float32-mode kernels on the same inputs must miss the forward's and the
    relative L2 limits. Then the wrapper itself in that mode at the
    rgb_splats render (check_aniso_bf16_wrapper). Returns each case with
    its errors."""
    d64 = splat_inputs(8, 4096, 64, SEED + 30, True)
    z_lo, z_hi = aniso.z_ranges(d64["mu"][..., 0], d64["rz"], 64)
    d64.update(name="d64", renders=8, n=4096,
               point_cells=int((z_hi - z_lo).sum()) * 64 * 64,
               ct=torch.randn(8, 4, 64, 64, 64, device=DEVICE,
                              generator=torch.Generator(
                                  device=DEVICE).manual_seed(SEED + 31)))
    groups = (("mu", 0, 3), ("A6", 3, 9), ("w", 9, 10), ("rgb", 10, 13))
    out = []
    for case in (*bwd_cases[:2], d64):
        vox, with_rgb, ct = case["vox"], case["rgb"] is not None, case["ct"]
        pk = aniso.pack(case["mu"], case["A6"], case["w"], case["rgb"])
        z_lo, z_hi = aniso.z_ranges(case["mu"][..., 0], case["rz"], vox)
        table = aniso.chunk_table(case["mu"][..., 0], case["rz"], vox)
        before = launch_counts()
        fwd = {bf: aniso._launch_forward(pk, table, vox, with_rgb, bf)
               for bf in (True, False)}
        bwd = {bf: aniso._launch_backward(pk, table, ct, vox, with_rgb, bf)
               for bf in (True, False)}
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in launch_counts().items()}
        assert made == only(aniso_render=1, aniso_render_bwd=1,
                            aniso_render_bf16=1, aniso_render_bwd_bf16=1), \
            made
        want = aniso._render_plain(pk, z_lo, z_hi, vox, with_rgb, "bfloat16")
        g_p = aniso.aniso_backward_reference(pk, z_lo, z_hi, ct, vox,
                                             with_rgb, "bfloat16")
        label = (f"{case['name']} ({case['renders']} x {case['n']}, D {vox}, "
                 f"rgb {with_rgb})")
        missed = []  # every row is printed before any limit is enforced
        peak = want.abs().max().item()
        fwd_err, ctl = ((fwd[bf] - want).abs().max().item()
                        for bf in (True, False))
        print(f"bf16 check K6 {label}: max abs err {fwd_err:.3e}, largest "
              f"plain value {peak:.3e}, ratio {fwd_err / peak:.3e} (bound "
              f"{BF16_FWD_SHARE:.1e}); float32 mode's ratio {ctl / peak:.3e} "
              "(must exceed the bound)", flush=True)
        if not fwd_err <= BF16_FWD_SHARE * peak < ctl:
            missed.append(("forward", fwd_err, ctl, peak))
        bwd_err = 0.0
        for name, a, b in groups if with_rgb else groups[:3]:
            p = g_p[:, a:b]
            err = (bwd[True][:, a:b] - p).abs().max().item()
            top = p.abs().max().item()
            rel, rel_f = ((torch.linalg.vector_norm(bwd[bf][:, a:b] - p)
                           / torch.linalg.vector_norm(p)).item()
                          for bf in (True, False))
            print(f"bf16 check K7 {label} d {name}: max abs err {err:.3e}, "
                  f"largest plain value {top:.3e}, ratio {err / top:.3e} "
                  f"(bound {BF16_SHARE:.3e}), relative L2 {rel:.3e} (bound "
                  f"{BF16_GRAD_L2:.1e}); float32 mode's relative L2 "
                  f"{rel_f:.3e} (must exceed the bound)", flush=True)
            if not (np.isfinite(rel) and err <= BF16_SHARE * top
                    and rel <= BF16_GRAD_L2 < rel_f):
                missed.append((name, err, top, rel, rel_f))
            bwd_err = max(bwd_err, err)
        assert not missed, (label, missed)
        out.append(dict(case, pk=pk, z_lo=z_lo, z_hi=z_hi, table=table,
                        fwd_err=fwd_err, bwd_err=bwd_err))
    check_aniso_bf16_wrapper(aniso, bwd_cases[0])
    return out


def check_aniso_bf16_wrapper(aniso, case) -> None:
    """The wrapper's bfloat16 dispatch (acc_dtype to the mode flag, pack,
    z-ranges, autograd) at the rgb_splats render: aniso_density(...,
    "bfloat16") against aniso_density_plain in that mode, the forward within
    BF16_FWD_SHARE of the largest plain value, each gradient (mu, A6, w,
    rgb) within BF16_SHARE of its largest and BF16_GRAD_L2 in relative L2;
    one launch of each bf16 kernel and none other."""
    ct = case["ct"]

    def wrapper(*a):
        return aniso.aniso_density(*a, acc_dtype="bfloat16")

    def plain(*a):
        return aniso.aniso_density_plain(*a, acc_dtype="bfloat16")

    with torch.no_grad():
        want = torch.cat([t[:, None] if t.dim() == 4 else t
                          for t in plain(*aniso_args(case))], 1)
    before = launch_counts()
    with torch.no_grad():
        got = torch.cat([t[:, None] if t.dim() == 4 else t
                         for t in wrapper(*aniso_args(case))], 1)
    g_k = splat_grads(wrapper, case, ct)
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in launch_counts().items()}
    assert made == only(aniso_render_bf16=2, aniso_render_bwd_bf16=1), made
    g_p = splat_grads(plain, case, ct)
    peak = want.abs().max().item()
    fwd_err = (got - want).abs().max().item()
    print(f"bf16 check aniso_density wrapper {case['name']}: forward max abs "
          f"err {fwd_err:.3e}, ratio {fwd_err / peak:.3e} (bound "
          f"{BF16_FWD_SHARE:.1e})", flush=True)
    missed = [] if fwd_err <= BF16_FWD_SHARE * peak else [("forward",
                                                            fwd_err, peak)]
    for name, a, b in zip(("mu", "A6", "w", "rgb"), g_k, g_p):
        err, top = (a - b).abs().max().item(), b.abs().max().item()
        rel = (torch.linalg.vector_norm(a - b)
               / torch.linalg.vector_norm(b)).item()
        print(f"bf16 check aniso_density wrapper {case['name']} d {name}: "
              f"max abs err {err:.3e}, ratio {err / top:.3e} (bound "
              f"{BF16_SHARE:.3e}), relative L2 {rel:.3e} (bound "
              f"{BF16_GRAD_L2:.1e})", flush=True)
        if not (np.isfinite(rel) and err <= BF16_SHARE * top
                and rel <= BF16_GRAD_L2):
            missed.append((name, err, top, rel))
    assert not missed, missed


def time_aniso(aniso, case):
    """CUDA-event ms of K6 (the wrapper, the chunk table included), K7 alone
    (the launch on the saved inputs), the plain forward, and the plain
    forward plus backward; and the K7 launch itself for the profiler."""
    args = aniso_args(case)
    with_rgb = case["rgb"] is not None
    fwd_ms = cuda_ms(lambda: aniso.aniso_density(*args))
    pk = aniso.pack(case["mu"], case["A6"], case["w"], case["rgb"])
    table = aniso.chunk_table(case["mu"][..., 0], case["rz"], case["vox"])

    def bwd():
        aniso._launch_backward(pk, table, case["ct"], case["vox"], with_rgb)

    bwd_ms = cuda_ms(bwd)
    plain_ms = cuda_ms(lambda: aniso.aniso_density_reference(*args), runs=5,
                       warmup=1)
    plain_fb_ms = cuda_ms(
        lambda: splat_grads(aniso.aniso_density_reference, case, case["ct"]),
        runs=5, warmup=1)
    return fwd_ms, bwd_ms, plain_ms, plain_fb_ms, bwd


def aniso_bound(case, backward: bool, bf16: bool = False
                ) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of one K6 or K7 call on this
    case's data: the function's least operations (on the point-cells, rows
    and planes in range for the z-ranges these inputs give) over the peak
    for their type, against the bytes (packed points and z-ranges in, the
    grids out; backward: the cotangent grids in, the packed gradient out)
    over PEAK_BYTES_PER_S. f32: ANISO_*_OPS at PEAK_F32_FLOPS; ``bf16``:
    ANISO_*_BF16_OPS, the rounded-operand products at PEAK_BF16_FLOPS."""
    with_rgb = case["rgb"] is not None
    if bf16:
        f32_cell, bf16_cell, per_row, per_plane = (
            ANISO_BWD_BF16_OPS if backward else ANISO_FWD_BF16_OPS)[with_rgb]
    else:
        f32_cell, per_row, per_plane = (
            ANISO_BWD_OPS if backward else ANISO_FWD_OPS)[with_rgb]
        bf16_cell = 0
    cells, vox = case["point_cells"], case["vox"]
    ops = (f32_cell * cells + per_row * cells // vox
           + per_plane * cells // vox**2)
    points = case["renders"] * case["n"]
    grids = case["renders"] * (4 if with_rgb else 1) * case["vox"] ** 3
    nbytes = 4 * (15 * points + grids + (13 * points if backward else 0))
    t_ops = (ops / PEAK_F32_FLOPS + bf16_cell * cells / PEAK_BF16_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def aniso_own_ms(case, backward: bool, bf16: bool = False) -> float:
    """ms of the f32 operations csrc/aniso_splat.cu spends on this case's
    point-cells, at PEAK_F32_FLOPS (not a bound: the kernel's own count)."""
    own = ANISO_KERNEL_OPS[bf16][backward][case["rgb"] is not None]
    return own * case["point_cells"] / PEAK_F32_FLOPS * 1e3


def mufu_floor_ms(case) -> float:
    """ms of one exp per point-cell of this case on the MUFU (K6 and K7
    alike): a floor the bound does not show, not the bound."""
    return case["point_cells"] / MUFU_EXP_PER_S * 1e3


def splat_train(cli, path: str, run_dir: Path, steps: int, mode: str,
                label: str) -> dict:
    """`cli train` of an rgb_splats config for ``steps`` with the counts set
    to 0 just before and read just after: finite loss_total and loss_rgb,
    the mean of the last min(20, steps / 5) below the first's, one K6 and
    one K7 launch of ``mode`` ("" or "_bf16") per step and nothing else,
    and a checkpoint. Returns the launches."""
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-f", path, "-n", str(MODELS), "--steps", str(steps)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == list(range(1, steps + 1))
    vals = np.array([r["loss_total"] for r in recs])
    rgb_vals = np.array([r["loss_rgb"] for r in recs])
    assert np.isfinite(vals).all() and np.isfinite(rgb_vals).all()
    k = min(20, steps // 5)
    first, last = vals[:k].mean(), vals[-k:].mean()
    print(f"train {label}: {steps} steps in {secs:.1f} s (datagen cached; "
          f"log_every 1), loss_total mean of the first {k} {first:.6f}, of "
          f"the last {k} {last:.6f}; loss_rgb {rgb_vals[:k].mean():.6f} -> "
          f"{rgb_vals[-k:].mean():.6f}; launches {launches}", flush=True)
    assert last < first, (first, last)
    assert launches == only(**{f"aniso_render{mode}": steps,
                               f"aniso_render_bwd{mode}": steps}), launches
    assert (run_dir / "ckpt" / f"{steps}.pt").exists()
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(run_dir / "metrics.jsonl",
                OUT_DIR / f"chip_smoke_{label}_metrics.jsonl")
    return launches


def serve_splats(cfg, ds, steps: int, label: str) -> None:
    """One ServingModel call on the newest checkpoint of ``cfg``'s run:
    points, rgb and the gauss arrays, finite, scales within their bounds."""
    from dpcx_torch.serve import ServingModel
    from dpcx_torch.train import load_checkpoint

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
    print(f"serve {label}: {len(imgs)} images -> {sorted(served)} of the "
          f"step-{steps} model, finite, scales in [{s.min():.4f}, "
          f"{s.max():.4f}]", flush=True)


def phase_splats(cli, fused, tmp: Path):
    """experiments/rgb_splats.yaml at full width (N 4096, D 32, B 8 x 4
    views, rgb and gauss heads, gsplat_impl pallas, GT pose): `cli
    datagen` (32 models, rendered by the plain ops: renderer xla),
    kernel-vs-plain training steps, `cli train` for SPLAT_STEPS with the
    counts set to 0 just before and read just after (one K6 and one K7
    launch a step, nothing else), and one ServingModel call on the trained
    model; then the same with pallas_acc_dtype: bfloat16 (K6 and K7's
    bfloat16 mode): kernel-vs-plain steps, which must lie farther from the
    float32 ones than the limit, `cli train` for SPLAT_BF16_STEPS and a
    ServingModel call. Returns (the f32 config, the bf16 config, the data,
    the f32 run's launches, the bf16 run's launches)."""
    from dpcx_torch.config import load_config, save_config

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
    l_f32, g_f32 = phase_parity(cfg, ds,
                                dict(aniso_render=3, aniso_render_bwd=3))
    launches = splat_train(cli, path, Path(cfg.checkpoint_dir), SPLAT_STEPS,
                           "", "rgb_splats")
    serve_splats(cfg, ds, SPLAT_STEPS, "rgb_splats")

    # the bfloat16 operand mode of K6 and K7
    bf = cfg.replace(pallas_acc_dtype="bfloat16",
                     checkpoint_dir=str(tmp / "splats_bf16"),
                     save_every=SPLAT_BF16_STEPS)
    bf_path = str(tmp / "rgb_splats_bf16.yaml")
    save_config(bf, bf_path)
    l_bf, g_bf = phase_parity(
        bf, ds, dict(aniso_render_bf16=3, aniso_render_bwd_bf16=3))
    # control: the two modes' kernel runs lie farther apart than the limit
    # that held each against its plain version
    name, rel = worst_grad(g_bf, g_f32)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_bf, l_f32))
    print(f"parity control rgb_splats: bfloat16 against float32 kernel "
          f"steps, first-step gradients worst relative L2 {rel:.3e} "
          f"({name}), losses worst rel {loss_rel:.3e}; the gradients must "
          f"exceed {TRAIN_RTOL}", flush=True)
    assert rel > TRAIN_RTOL, (rel, loss_rel)
    bf_launches = splat_train(cli, bf_path, Path(bf.checkpoint_dir),
                              SPLAT_BF16_STEPS, "_bf16", "rgb_splats_bf16")
    serve_splats(bf, ds, SPLAT_BF16_STEPS, "rgb_splats_bf16")
    return cfg, bf, ds, launches, bf_launches


def phase_bf16(bwd_cases, fused) -> list[dict]:
    """The bfloat16 operand mode at the car_64_depth and chair_pred_pose
    renders (K1, K2) and the multicat_128 one (D 128: the counterparts of
    K3 and K4 + K5, the backward also in the recompute form), on phase 3's
    inputs (dropout weights 0 or 10, random cotangents): the kernel forward
    against the plain bfloat16 forward within BF16_FWD_SHARE of the largest
    plain value, the kernel backward against fused_backward_reference
    within BF16_SHARE (max abs) and BF16_GRAD_L2 (relative L2). Control:
    the float32-mode kernels on the same inputs (phase 3's gradients) must
    miss the forward's and the relative L2 limits."""
    out = []
    for case in bwd_cases:
        if case["name"] not in ("car_64_depth", "chair_pred_pose",
                                "multicat_128"):
            continue
        ndc, pw, vox, sigma, radius, wd = (case[k] for k in (
            "ndc", "pw", "vox", "sigma", "radius", "with_depth"))
        fam = fused.launch_family(vox)
        kw = dict(with_depth=wd, acc_dtype="bfloat16")
        saves = (True, False) if vox > 64 else (True,)
        before = launch_counts()
        g_k = {save: render_grads(
            lambda x, w: fused.fused_project_t(x, vox, sigma, radius, w,
                                               save_grid=save, **kw),
            ndc, pw, case["dsil"], case["ddepth"]) for save in saves}
        with torch.no_grad():
            sil_k, dep_k = fused.fused_project_t(ndc, vox, sigma, radius, pw,
                                                 **kw)
            sil_f, dep_f = fused.fused_project_t(ndc, vox, sigma, radius, pw,
                                                 with_depth=wd)
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in launch_counts().items()}
        want = {f"{fam}_render_bf16": len(saves) + 1,
                f"{fam}_render_bwd_bf16": 1, f"{fam}_render": 1}
        if vox > 64:
            want[f"{fam}_render_bwd_recompute_bf16"] = 1
        assert made == only(**want), made
        sil_p, dep_p = fused.fused_project_reference(ndc, vox, sigma, radius,
                                                     pw, **kw)
        g_p = fused.fused_backward_reference(
            ndc, vox, sigma, radius, pw, wd, case["dsil"], case["ddepth"],
            "bfloat16")
        g_f = case["grads"]
        rows = [("sil", sil_k, sil_f, sil_p)] + (
            [("depth", dep_k, dep_f, dep_p)] if wd else [])
        for save in saves:
            mode = "" if save else " (recompute)"
            rows += [(f"d ndc{mode}", g_k[save][0], g_f[0], g_p[0]),
                     (f"d weights{mode}", g_k[save][1], g_f[1], g_p[1])]
        fwd_err = bwd_err = 0.0
        label = f"{case['name']} ({fam})"
        missed = []  # every row is printed before any limit is enforced
        for name, a, f, b in rows:
            err, ctl = ((x - b).abs().max().item() for x in (a, f))
            peak = b.abs().max().item()
            assert np.isfinite(err) and peak > 0, (name, err, peak)
            if name in ("sil", "depth"):
                print(f"bf16 check {label} {name}: max abs err {err:.3e}, "
                      f"largest plain value {peak:.3e}, ratio "
                      f"{err / peak:.3e} (bound {BF16_FWD_SHARE:.1e}); "
                      f"float32 mode's ratio {ctl / peak:.3e} (must exceed "
                      "the bound)", flush=True)
                if not err <= BF16_FWD_SHARE * peak < ctl:
                    missed.append((name, err, ctl, peak))
                fwd_err = max(fwd_err, err)
                continue
            rel, rel_f = ((torch.linalg.vector_norm(x - b)
                           / torch.linalg.vector_norm(b)).item()
                          for x in (a, f))
            print(f"bf16 check {label} {name}: max abs err {err:.3e}, "
                  f"largest plain value {peak:.3e}, ratio {err / peak:.3e} "
                  f"(bound {BF16_SHARE:.3e}), relative L2 {rel:.3e} (bound "
                  f"{BF16_GRAD_L2:.1e}); float32 mode's ratio "
                  f"{ctl / peak:.3e}, relative L2 {rel_f:.3e} (must exceed "
                  "the bound)", flush=True)
            if not (err <= BF16_SHARE * peak and rel <= BF16_GRAD_L2 < rel_f):
                missed.append((name, err, peak, rel, rel_f))
            bwd_err = max(bwd_err, err)
        assert not missed, (label, missed)
        out.append(dict(case, fwd_err=fwd_err, bwd_err=bwd_err))
    return out


def pose_train(cli, path: str, run_dir: Path, steps: int, mode: str,
               label: str) -> dict:
    """`cli train` for ``steps`` with the counts set to 0 just before and
    read just after: finite, falling losses, gauge_spread_deg logged, one
    K1 and one K2 launch of ``mode`` ("" or "_bf16") per step."""
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-f", path, "-n", str(MODELS), "--steps", str(steps)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    recs = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == list(range(1, steps + 1))
    vals = np.array([r["loss_total"] for r in recs])
    spread = np.array([r["gauge_spread_deg"] for r in recs])
    assert np.isfinite(vals).all() and np.isfinite(spread).all()
    first, last = vals[:20].mean(), vals[-20:].mean()
    print(f"train {label}: {steps} steps in {secs:.1f} s (datagen cached; "
          f"log_every 1), loss_total mean of the first 20 {first:.6f}, of "
          f"the last 20 {last:.6f}; loss_proj "
          f"{np.mean([r['loss_proj'] for r in recs[:20]]):.6f} -> "
          f"{np.mean([r['loss_proj'] for r in recs[-20:]]):.6f}; "
          f"gauge_spread_deg {spread[:20].mean():.2f} -> "
          f"{spread[-20:].mean():.2f}; launches {launches}", flush=True)
    assert last < first, (first, last)
    assert launches == only(**{f"fused_render{mode}": steps,
                               f"fused_render_bwd{mode}": steps}), launches
    OUT_DIR.mkdir(exist_ok=True)
    shutil.copy(run_dir / "metrics.jsonl",
                OUT_DIR / f"chip_smoke_{label}_metrics.jsonl")
    return launches


def phase_pred_pose(cli, fused, tmp: Path):
    """experiments/chair_pred_pose.yaml at full width: datagen, the float32
    kernel-vs-plain steps, `cli train`, the reseed drive, the bfloat16
    mode's kernel-vs-plain steps and `cli train`, and a ServingModel call.
    Returns (the f32 config, the bf16 config, the data, the f32 run's
    launches, the bf16 run's launches)."""
    from dpcx_torch.config import load_config, save_config
    from dpcx_torch.serve import ServingModel
    from dpcx_torch.train import load_checkpoint

    cfg = load_config(PRED_POSE).validate().replace(
        data_dir=str(tmp / "pose_data"), checkpoint_dir=str(tmp / "pose"),
        log_every=1, save_every=POSE_STEPS)
    assert (cfg.image_size, cfg.pc_num_points, cfg.vox_size,
            cfg.batch_size, cfg.pose_predict_num_candidates,
            cfg.views_per_step, cfg.pose_from_views, cfg.pose_student,
            cfg.renderer, cfg.proj_depth, cfg.pallas_acc_dtype) == (
        128, 2048, 32, 8, 8, 4, True, True, "pallas", False, "float32")
    path = str(tmp / "chair_pred_pose.yaml")
    save_config(cfg, path)
    ds = phase_datagen(cli, fused, path, MODELS, "chair_pred_pose")
    l_f32, g_f32 = phase_parity(cfg, ds,
                                dict(fused_render=3, fused_render_bwd=3))
    launches = pose_train(cli, path, Path(cfg.checkpoint_dir), POSE_STEPS,
                          "", "chair_pred_pose")

    # the reseed drive: an untrained spread fires at 1 degree
    rs = cfg.replace(checkpoint_dir=str(tmp / "pose_reseed"),
                     gauge_reseed_threshold_deg=1.0,
                     gauge_reseed_check_step=RESEED_CHECK,
                     gauge_reseed_max_retries=1, save_every=20)
    rs_path = str(tmp / "chair_pred_pose_reseed.yaml")
    save_config(rs, rs_path)
    reset_counts()
    cli.main(["train", "-f", rs_path, "-n", str(MODELS), "--steps",
              str(RESEED_STEPS)])
    torch.cuda.synchronize()
    recs = [json.loads(line) for line in
            (Path(rs.checkpoint_dir) / "metrics.jsonl").read_text()
            .splitlines()]
    fired = [r for r in recs if "gauge_reseed" in r]
    steps = [r["step"] for r in recs if "gauge_reseed" not in r]
    want_steps = (list(range(1, RESEED_CHECK + 1))
                  + list(range(1, RESEED_STEPS + 1)))
    print(f"reseed drive chair_pred_pose: records {fired}, logged steps "
          f"1..{RESEED_CHECK} then 1..{steps[-1]}, launches "
          f"{launch_counts()}", flush=True)
    assert len(fired) == 1 and fired[0]["step"] == RESEED_CHECK, fired
    assert fired[0]["gauge_reseed"] == 1.0
    assert fired[0]["gauge_spread_deg"] > 1.0, fired
    assert steps == want_steps, steps
    assert (Path(rs.checkpoint_dir) / "ckpt" / f"{RESEED_STEPS}.pt").exists()
    n = RESEED_CHECK + RESEED_STEPS
    assert launch_counts() == only(fused_render=n, fused_render_bwd=n)

    # the bfloat16 operand mode of K1 and K2
    bf = cfg.replace(pallas_acc_dtype="bfloat16",
                     checkpoint_dir=str(tmp / "pose_bf16"),
                     save_every=POSE_BF16_STEPS)
    bf_path = str(tmp / "chair_pred_pose_bf16.yaml")
    save_config(bf, bf_path)
    l_bf, g_bf = phase_parity(
        bf, ds, dict(fused_render_bf16=3, fused_render_bwd_bf16=3))
    # control: the two modes' kernel runs lie farther apart than the limit
    # that held each against its plain version
    name, rel = worst_grad(g_bf, g_f32)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_bf, l_f32))
    print(f"parity control chair_pred_pose: bfloat16 against float32 "
          f"kernel steps, first-step gradients worst relative L2 {rel:.3e} "
          f"({name}), losses worst rel {loss_rel:.3e}; each must exceed "
          f"{TRAIN_RTOL}", flush=True)
    assert rel > TRAIN_RTOL and loss_rel > TRAIN_RTOL, (rel, loss_rel)
    bf_launches = pose_train(cli, bf_path, Path(bf.checkpoint_dir),
                             POSE_BF16_STEPS, "_bf16", "chair_pred_pose_bf16")

    params = load_checkpoint(cfg, DEVICE)["params"]
    model = ServingModel(cfg, params, batch_size=cfg.batch_size)
    imgs = ds.records["images"][:cfg.batch_size, 0]
    served = model(imgs)
    assert {k: v.shape for k, v in served.items()} == {
        "points": (len(imgs), cfg.pc_num_points, 3),
        "scale": (len(imgs), 1), "pose": (len(imgs), 4)}, \
        {k: v.shape for k, v in served.items()}
    assert all(np.isfinite(v).all() for v in served.values())
    norm = np.linalg.norm(served["pose"], axis=-1)
    assert np.abs(norm - 1.0).max() < 1e-5, norm
    print(f"serve chair_pred_pose: {len(imgs)} images -> {sorted(served)} of "
          f"the step-{POSE_STEPS} model, pose norms within "
          f"{np.abs(norm - 1.0).max():.1e} of 1", flush=True)
    return cfg, bf, ds, launches, bf_launches


def splat_times(tree: Path) -> int:
    """``--splat-times TREE``: the A/B of a change to the splat kernels, for
    the checkout at TREE (this one, or an older commit unpacked with `git
    archive` into a directory .gitignore lists), whose dpcx_torch is
    imported and built; run it for the two trees in turns, one process
    each (old, new, new, old). Prints ptxas's report of the tree's splat
    kernels, then for each operand mode one JSON line: K6's and K7's
    torch.profiler device us per call at phase 3b's rgb_splats render
    (through the wrapper and autograd, which every tree's launchers
    share) and the host-clock median, 10th and 90th percentiles of 30
    rgb_splats training steps (after 3) on 32 synthetic models."""
    sys.path.insert(0, str(tree.resolve()))
    import dpcx_torch
    from dpcx_torch import _build
    from dpcx_torch.config import load_config
    from dpcx_torch.data.dataset import load_or_make
    from dpcx_torch.render import aniso

    assert Path(dpcx_torch.__file__).resolve().is_relative_to(
        tree.resolve()), dpcx_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    _build.build()
    _build.load()
    for name, frame, spill, regs, smem in ptxas_report(
            _build.build_log().read_text()):
        if "aniso" in name:
            print(f"splat times {tree}: ptxas {name}: {regs} registers, "
                  f"{smem} bytes shared memory, {frame} bytes stack frame, "
                  f"{spill} bytes spilled", flush=True)
    case = splat_inputs(32, 4096, 32, SEED + 10, True)
    ct = torch.tensor(np.random.default_rng(SEED + 20).normal(
        size=(32, 4, 32, 32, 32)), dtype=torch.float32, device=DEVICE)
    cfg = load_config(RGB_SPLATS).validate()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ab_") as tmp:
        cfg = cfg.replace(data_dir=str(Path(tmp) / "data"),
                          checkpoint_dir=str(Path(tmp) / "run"))
        ds = load_or_make(cfg, 32, seed=cfg.seed, device=DEVICE)
        for mode in ("float32", "bfloat16"):
            def fwd():
                with torch.no_grad():
                    aniso.aniso_density(*aniso_args(case), acc_dtype=mode)

            ins = [case[k].detach().requires_grad_()
                   for k in ("mu", "A6", "w", "rgb")]
            dens, cols = aniso.aniso_density(*ins, case["rz"], 32,
                                             acc_dtype=mode)
            loss = (torch.cat([dens[:, None], cols], 1) * ct).sum()

            def bwd():
                torch.autograd.grad(loss, ins, retain_graph=True)

            rec = {"tree": str(tree), "mode": mode}
            for key, fn, kernel in (("k6_device_us", fwd, "aniso_fwd_kernel"),
                                    ("k7_device_us", bwd, "aniso_bwd_kernel")):
                rec[key] = sum(us for name, us in device_profile(
                    fn, f"{kernel} {mode} {tree}") if kernel in name)
            steps = host_times(training_step_fn(
                cfg.replace(pallas_acc_dtype=mode), ds), runs=30, warmup=3)
            rec.update(step_ms_median=statistics.median(steps),
                       step_ms_p10=float(np.percentile(steps, 10)),
                       step_ms_p90=float(np.percentile(steps, 90)),
                       card=card)
            print(json.dumps(rec), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splat-times", metavar="TREE", type=Path,
                    help="time only K6, K7 and the rgb_splats step of the "
                         "checkout at TREE (see splat_times)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if args.splat_times is not None:
        return splat_times(args.splat_times)

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
    for name, frame, spill, regs, smem in ptxas_report(
            _build.build_log().read_text()):
        print(f"build: ptxas {name}: {regs} registers, {smem} bytes shared "
              f"memory, {frame} bytes stack frame, {spill} bytes spilled",
              flush=True)

    cfg = load_config(CONFIG).validate()
    assert cfg.renderer == "pallas" and cfg.proj_depth

    # 2. each forward kernel vs its plain version
    cases = phase_kernel(cfg, fused, gauss)
    # 3. each backward kernel vs autograd through the plain version
    bwd_cases = phase_backward(cases, fused)
    # 3c. K1 and K2 in bfloat16 mode vs their plain bfloat16 version
    bf16_cases = phase_bf16(bwd_cases, fused)
    # 3b. K6 and K7 vs their plain version
    aniso_cases = phase_aniso_kernel(aniso)
    aniso_bwd = phase_aniso_backward(aniso, aniso_cases)
    # 3d. K6 and K7 in bfloat16 mode vs their plain bfloat16 version
    aniso_bf16 = phase_aniso_bf16(aniso, aniso_bwd)

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
            phase_parity(car_cfg, ds,
                         dict(fused_render=3, fused_render_bwd=3))
            # 8. train through the CLI, resume, chair
            launches = phase_train(cli, fused, car_path, car_cfg)
            phase_chair(cli, fused, tmp)
            # 9. multicat_128_fused: datagen, parity, train, remat
            mc_cfg, mc_bf, mc_ds, mc_launches, mc_bf_launches = \
                phase_multicat(cli, fused, tmp)
            # 9b. rgb_splats: datagen, parity, train, serve
            sp_cfg, sp_bf, sp_ds, sp_launches, sp_bf_launches = \
                phase_splats(cli, fused, tmp)
            # 9c. chair_pred_pose: datagen, parity, train, reseed, bf16,
            # serve
            pp_cfg, pp_bf, pp_ds, pp_launches, pp_bf_launches = \
                phase_pred_pose(cli, fused, tmp)
            # 9d. largecloud_pointshard: shard_points on one card
            phase_largecloud(cli, fused, tmp)

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
            mc_step_fns = {}
            for label, c in (("float32", mc_cfg), ("bfloat16", mc_bf)):
                mc_step_fns[label] = training_step_fn(c, mc_ds)
                ms = host_ms(mc_step_fns[label])
                print(f"time train step multicat_128 {label} operands (B 4 "
                      f"x 4 views, N 16000, D 128, bf16 compute): median "
                      f"{ms:.3f} ms per step | {card}", flush=True)
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
                      f"); MUFU floor of one exp per point-cell "
                      f"{mufu_floor_ms(case):.4f} ms (not the bound); the "
                      f"kernels' own f32 operations at peak: K6 "
                      f"{aniso_own_ms(case, False):.4f} ms, K7 "
                      f"{aniso_own_ms(case, True):.4f} ms; plain forward "
                      f"{p_ms:.4f} ms, plain forward + backward "
                      f"{pfb_ms:.4f} ms | {card}", flush=True)
            sp_bf_case = aniso_bf16[0]
            sp_bf_args = aniso_args(sp_bf_case)

            def sp_bf_launch():
                aniso._launch_backward(sp_bf_case["pk"], sp_bf_case["table"],
                                       sp_bf_case["ct"], 32, True, True)

            sp_bf_ms = (
                cuda_ms(lambda: aniso.aniso_density(*sp_bf_args,
                                                    acc_dtype="bfloat16")),
                cuda_ms(sp_bf_launch),
                cuda_ms(lambda: aniso.aniso_density_reference(
                    *sp_bf_args, acc_dtype="bfloat16"), runs=5, warmup=1),
                cuda_ms(lambda: aniso.aniso_backward_reference(
                    sp_bf_case["pk"], sp_bf_case["z_lo"], sp_bf_case["z_hi"],
                    sp_bf_case["ct"], 32, True, "bfloat16"), runs=5,
                    warmup=1))
            print(f"time K6/K7 bf16 {sp_bf_case['name']} (32 renders x 4096 "
                  f"points, D 32, {sp_bf_case['point_cells']} point-cells): "
                  f"K6 {sp_bf_ms[0]:.4f} ms (f32 mode "
                  f"{aniso_timings[sp_bf_case['name']][0]:.4f}; bound "
                  f"{aniso_bound(sp_bf_case, False, True)[0]:.4f}), K7 "
                  f"{sp_bf_ms[1]:.4f} ms (f32 mode "
                  f"{aniso_timings[sp_bf_case['name']][1]:.4f}; bound "
                  f"{aniso_bound(sp_bf_case, True, True)[0]:.4f}); MUFU "
                  f"floor {mufu_floor_ms(sp_bf_case):.4f} ms (not the "
                  f"bound); the kernels' own f32 operations at peak: K6 "
                  f"{aniso_own_ms(sp_bf_case, False, True):.4f} ms, K7 "
                  f"{aniso_own_ms(sp_bf_case, True, True):.4f} ms; plain "
                  f"forward {sp_bf_ms[2]:.4f} ms, plain backward "
                  f"(aniso_backward_reference) {sp_bf_ms[3]:.4f} ms | {card}",
                  flush=True)
            sp_step_fns = {}
            for label, c in (("float32", sp_cfg), ("bfloat16", sp_bf)):
                sp_step_fns[label] = training_step_fn(c, sp_ds)
                ms = host_ms(sp_step_fns[label])
                print(f"time train step rgb_splats {label} operands (B 8 x 4 "
                      f"views, N 4096, D 32, rgb + gauss, bf16 compute): "
                      f"median {ms:.3f} ms per step | {card}", flush=True)
            bf16_timings, bf16_launch = {}, {}
            for case in bf16_cases:
                fwd_args = tuple(case[k] for k in (
                    "ndc", "vox", "sigma", "radius", "pw", "with_depth"))
                f_ms = cuda_ms(lambda: fused.fused_project_t(
                    *fwd_args, acc_dtype="bfloat16"))
                pf_ms = cuda_ms(lambda: fused.fused_project_reference(
                    *fwd_args, acc_dtype="bfloat16"))
                fwd, bwd_name = (("K3", "K4 + K5") if case["vox"] > 64
                                 else ("K1", "K2"))
                for save in (True, False) if case["vox"] > 64 else (True,):
                    b_ms, pb_ms, bwd = time_backward(fused, case, save, True)
                    bf16_timings[case["name"], save] = (f_ms, b_ms, pf_ms,
                                                        pb_ms)
                    bf16_launch[case["name"], save] = bwd
                    print(f"time {fwd}/{bwd_name} bf16 {case['name']} "
                          f"({case['ndc'].shape[0]} renders x "
                          f"{case['ndc'].shape[2]} points, D {case['vox']}"
                          f"{'' if save else ', recompute'}): {fwd} "
                          f"{f_ms:.4f} ms (f32 mode "
                          f"{timings[case['name']][0]:.4f}), plain forward "
                          f"{pf_ms:.4f} ms; {bwd_name} {b_ms:.4f} ms (f32 "
                          f"mode {bwd_timings[case['name'], save][0]:.4f}), "
                          f"plain backward {pb_ms:.4f} ms | {card}",
                          flush=True)
            pp_step_fns = {}
            for label, c in (("float32", pp_cfg), ("bfloat16", pp_bf)):
                pp_step_fns[label] = training_step_fn(c, pp_ds)
                ms = host_ms(pp_step_fns[label])
                print(f"time train step chair_pred_pose {label} operands (B "
                      f"8 x 4 views x K 8 = 256 renders, N 2048, D 32, bf16 "
                      f"compute): median {ms:.3f} ms per step | {card}",
                      flush=True)

        # 11. profile
        print(f"profile on {card}", flush=True)
        for case in (cases[0], cases[2], cases[3]):
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
        device_profile(lambda: srv.model(imgs16), "ServingModel batch 16",
                       check=False)
        step = device_profile(step_fn, "train step car_64_depth", runs=10,
                              top=16)
        print_step_breakdown(step, "car_64_depth")
        for label, fn in mc_step_fns.items():
            step = device_profile(fn, f"train step multicat_128 {label}",
                                  runs=10, top=16)
            print_step_breakdown(step, f"multicat_128 {label}")
        sp_case = aniso_bwd[0]
        device_profile(lambda: aniso.aniso_density(*aniso_args(sp_case)),
                       "K6 rgb_splats (with the chunk table)")
        device_profile(aniso_launch[sp_case["name"]],
                       "K7 rgb_splats (launch on the saved inputs)")
        device_profile(lambda: aniso.aniso_density(*sp_bf_args,
                                                   acc_dtype="bfloat16"),
                       "K6 bf16 rgb_splats (with the chunk table)")
        device_profile(sp_bf_launch,
                       "K7 bf16 rgb_splats (launch on the saved inputs)")
        for label, fn in sp_step_fns.items():
            step = device_profile(fn, f"train step rgb_splats {label}",
                                  runs=10, top=16, host_top=12)
            print_step_breakdown(step, f"rgb_splats {label}")
        pp_case = next(c for c in bf16_cases
                       if c["name"] == "chair_pred_pose")
        device_profile(lambda: fused.fused_project_t(
            pp_case["ndc"], 32, pp_case["sigma"], pp_case["radius"],
            pp_case["pw"], acc_dtype="bfloat16"), "K1 bf16 chair_pred_pose")
        device_profile(bf16_launch["chair_pred_pose", True],
                       "K2 bf16 chair_pred_pose (launch on saved residuals)")
        mc_case = next(c for c in bf16_cases if c["name"] == "multicat_128")
        device_profile(lambda: fused.fused_project_t(
            mc_case["ndc"], 128, mc_case["sigma"], mc_case["radius"],
            mc_case["pw"], acc_dtype="bfloat16"), "K3 bf16 multicat_128")
        device_profile(bf16_launch["multicat_128", True],
                       "K4 + K5 bf16 multicat_128 (launch on saved residuals)")
        device_profile(bf16_launch["multicat_128", False],
                       "K4 + K5 bf16 multicat_128 (recompute launch)")
        for label, fn in pp_step_fns.items():
            step = device_profile(fn, f"train step chair_pred_pose {label}",
                                  runs=10, top=16, host_top=8)
            print_step_breakdown(step, f"chair_pred_pose {label}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    print(f"elapsed: {time.perf_counter() - t_start:.1f} s, build included",
          flush=True)
    print(card)
    source = "dpcx_torch/csrc/fused_render.cu"
    plain_bwd_note = ("plain_ms: fused_backward_reference, which recomputes "
                      "the grid")
    by_name = {c["name"]: c for c in bwd_cases}

    def entry(name, replaces, launches_, case, backward, note=None):
        ndc, vox, radius = case["ndc"], case["vox"], case["radius"]
        if backward:
            k_ms, p_ms = bwd_timings[case["name"], True]
        else:
            k_ms, p_ms = timings[case["name"]]
        bound_ms, bound_by = render_bound(
            ndc.shape[0], ndc.shape[2], vox, radius, case["with_depth"],
            True, backward)
        checked = [c["err"] for c in (bwd_cases if backward else cases)
                   if (c["vox"] > 64) == (vox > 64)]
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches_,
               "max_abs_err": max(checked), "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        if backward:
            note = "; ".join(filter(None, (note, plain_bwd_note)))
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

    def splat_bf16_entry(name, replaces, backward):
        k_ms = sp_bf_ms[1] if backward else sp_bf_ms[0]
        bound_ms, bound_by = aniso_bound(sp_bf_case, backward, True)
        key = "bwd_err" if backward else "fwd_err"
        return {"name": name, "route": "cuda",
                "source": "dpcx_torch/csrc/aniso_splat.cu",
                "replaces": replaces,
                "launches": sp_bf_launches[
                    "aniso_render_bwd_bf16" if backward
                    else "aniso_render_bf16"],
                "max_abs_err": max(c[key] for c in aniso_bf16),
                "ms": k_ms,
                "plain_ms": sp_bf_ms[3] if backward else sp_bf_ms[2],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "note": ("bfloat16 operand mode; times and bound at the "
                         "rgb_splats render (32 x 4096, D 32, rgb), "
                         "launches from its bfloat16 cli train run"
                         + ("; plain_ms: aniso_backward_reference"
                            if backward else ""))}

    def bf16_entry(name, replaces, backward, case, run_launches, note):
        f_ms, b_ms, pf_ms, pb_ms = bf16_timings[case["name"], True]
        bound_ms, bound_by = render_bound(
            case["ndc"].shape[0], case["ndc"].shape[2], case["vox"],
            case["radius"], case["with_depth"], True, backward, bf16=True)
        key = "bwd_err" if backward else "fwd_err"
        fam = fused.launch_family(case["vox"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": run_launches[
                    f"{fam}_render_bwd_bf16" if backward
                    else f"{fam}_render_bf16"],
                "max_abs_err": max(c[key] for c in bf16_cases
                                   if (c["vox"] > 64) == (case["vox"] > 64)),
                "ms": b_ms if backward else f_ms,
                "plain_ms": pb_ms if backward else pf_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "note": "; ".join(filter(None, (
                    note, plain_bwd_note if backward else None)))}

    pp_note = ("bfloat16 operand mode; times and bound at the "
               "chair_pred_pose render (256 x 2048, D 32), launches from its "
               "bfloat16 cli train run")
    mc_note = ("bfloat16 operand mode; times and bound at the "
               "multicat_128_fused render (16 x 16000, D 128), launches "
               "from its bfloat16 cli train run")

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
        bf16_entry("fused_render:bf16", "dpcx/render/pallas_kernel.py:75",
                   False, pp_case, pp_bf_launches, pp_note),
        bf16_entry("fused_render_bwd:bf16",
                   "dpcx/render/pallas_kernel.py:254", True, pp_case,
                   pp_bf_launches, pp_note),
        bf16_entry("blocked_render:bf16", "dpcx/render/pallas_blocked.py:289",
                   False, mc_case, mc_bf_launches, mc_note),
        bf16_entry("blocked_render_bwd:K4:bf16",
                   "dpcx/render/pallas_blocked.py:376", True, mc_case,
                   mc_bf_launches, f"{mc_note}; {shared}"),
        bf16_entry("blocked_render_bwd:K5:bf16",
                   "dpcx/render/pallas_blocked.py:451", True, mc_case,
                   mc_bf_launches, f"{mc_note}; {shared}"),
        splat_bf16_entry("aniso_render:bf16",
                         "dpcx/render/pallas_gsplat.py:88", False),
        splat_bf16_entry("aniso_render_bwd:bf16",
                         "dpcx/render/pallas_gsplat.py:187", True),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
