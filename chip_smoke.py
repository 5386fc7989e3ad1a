#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dpcx_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --splat-times TREE
    python3 chip_smoke.py --render-times TREE
    python3 chip_smoke.py --parallel WORLD

The second form times only K6, K7 and the rgb_splats training step of
the checkout at TREE (splat_times), for an A/B of a splat kernel change
against an older commit; the third, the same for the renderer kernels
(K1, K2 at the car_64_depth and chair_pred_pose renders; K3, K4 + K5 at
the multicat_128 one) and those configs' steps (render_times); the
fourth runs phase 9g alone at WORLD ranks (after the datagen and phase 9d
it needs; NCCL on a machine with a card a rank) and a second one-card
run of its configs, the one-card path's own spread (parallel_only). The
first runs these phases, each of which raises on failure (exit code
non-zero):

1. build    — compile the CUDA kernels from dpcx_torch/csrc with nvcc,
              and print each kernel's stack frame and spills (ptxas);
              fail where a blur pass or a DRC walk (NO_FRAME_KERNELS) has
              either.
1b. draws   — the training step's draw kernels (csrc/prng.cu: dpcx's
              jax.random stream) against their plain versions, bitwise:
              the dropout weights at every shipped config's [B, N] and
              keep-prob, with the dropout keys of steps 0, 1, 9999 and
              2^31 - 1, and the batch draws' gather rows at every config's
              (B, V, V_use) over 32 and 200 models, with and without the
              second input view (their times: phases 10 and 11, so that
              torch.profiler's first use stays in phase 11).
3h. world   — the renderer the main path runs, fused_project_world
              (world clouds and cameras in: the splat stages of K1-K5 run
              the camera transform), against the plain version on the same
              inputs (pc_perspective_transform_t, then fused_project_plain,
              whose backward is K2's function written out), with keep
              weights and random cotangents, in both operand modes and at
              D > 64 with the saved grid and with the recompute (remat):
              K1/K2 at the car_64_depth render (32 x 16000, D 64, depth),
              the chair_gt_pose one (64 x 8000, D 32) and the
              chair_pred_pose one (256 x 2048, D 32, the cameras'
              gradient); the counterparts of K3 and K4 + K5 at the
              multicat_128_fused one (16 x 16000, D 128), at D 128 with
              depth (8 renders) and at D 72 with depth (4 x 4000). sil and
              depth within KERNEL_ATOL in float32 and 1e-5 of the largest
              plain value in bfloat16; the gradients within GRAD_RTOL of
              the largest plain one in float32, 2^-7 of it and 1e-3
              relative L2 in bfloat16 (the rotation's sums may move a
              coordinate by an ulp); the float32 mode on the same inputs
              must miss bfloat16's forward and relative L2 limits.
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
3e. init    — dpcx's parameter init (flax's lecun_normal on jax.random's
              threefry, utils/prng.py) drawn on the card against the same
              draw on the CPU, for every shipped config but
              largecloud_pointshard: every leaf within INIT_ULPS of its
              largest value on at most INIT_SHARE of its elements (the
              CPU side drawn once for leaves that several configs share);
              the card's init seconds printed. largecloud_pointshard: the
              card's init timed alone, and its fc_points kernel's first
              and last chunk of counters held to a CPU draw of those
              ranges.
3f. datagen card vs CPU — make_dataset of DATAGEN_MODELS car_64_depth
              models on the card and on the CPU (dpcx's draws on the CPU
              on both sides, so only rendering differs): points and quats
              equal, masks flipping on at most DATAGEN_MASK_FLIPS of the
              cells, depths (where both masks agree) within KERNEL_ATOL,
              images within DATAGEN_IMAGE_ATOL and beyond KERNEL_ATOL on
              at most DATAGEN_IMAGE_SHARE of the values; both times
              printed.
3g. rbf     — pointcloud2voxels_rbf (eager, no kernel) on the card against
              the CPU, 2 x 4096 points at D 32, within RBF_RTOL of the
              largest value.
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
              plain version handed to the step (fused_project_plain),
              from the same init and the same key (the scan's batches and
              dropout, as `cli train` draws them), in float32:
              per-parameter first-step gradients and the three losses.
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
9e. eval    — the eval and predict verbs on held-out sets drawn at seed + 1
              (their GT views through K1, one launch a model): `cli eval
              --all-views --flip-resolve --per-sample` of 9c's step-200
              chair_pred_pose model (32 models x 5 views pooled; dpcx's
              keys in dpcx's order, finite, acc and IoU in [0, 1], Chamfer
              >= 0, no kernel launch; the JSON to OUT_DIR); `evaluate` (view
              0) of that model on the card against the CPU, the forward in
              float32 on both: every metric within rtol 1e-5 (IoU 1e-2)
              of the CPU's at the card's two alignment picks (the
              canonical one, and the re-alignment of the flip-corrected
              poses behind the up-to-flip metrics), and of the CPU's own,
              or a tie of the argmin explains the miss (of the canonical
              alignment, or, where only the up-to-flip metrics miss and
              the canonical picks agree, of the re-alignment); then `cli
              predict -o` of phase
              8's car_64_depth model (points [32, 16000, 3], equal to a
              ServingModel call on the same images). Each verb's seconds
              beside the card's name and power limit.
9d. shard   — experiments/largecloud_pointshard.yaml as shipped (N 131072,
              D 32, renderer xla, shard_points on one card: a no-op that
              warns once per verb, as dpcx on one device): `cli datagen`
              (32 models) and `cli train` for 30 steps (finite losses, the
              last 10 below the first 10, no kernel launch).
9g. parallel — two ranks of `python -m torch.distributed.run
              --standalone --nproc_per_node 2` on the one card (gloo: the
              ranks share it; a correctness phase, not a speed-up), each
              first holding a 1 MB all_reduce of a CUDA tensor: (a) `cli
              train` of car_64_depth at full width, dropout off, 10 steps
              at W 1 (this process) and W 2 (B 4 a rank, one K1 and one K2
              launch a step in each rank, counts set to 0 just before):
              the logged loss_total within rtol 2e-3 and the final
              checkpoint's parameters within atol 5e-3 of W 1's (dpcx's
              test_dp_scan_matches_single_device_scan); (b)
              largecloud_pointshard as shipped at W 2 for 30 steps (the
              points split over the ranks): no one-device warning,
              finite, falling, within rtol 2e-3 of 9d's losses at each of
              the first 4 steps and in their mean (two one-card runs
              differ by up to 6.3e-3 at a later step); (c) the
              point- and grid-sharded renderers and the GT-pose loss at D
              32 and 64 (sum and both DRC modes, rgb where DRC composes
              it, 8 renders of 16000 points with weights) against the
              one-rank eager render: silhouette 1e-5, depth and rgb 1e-4,
              gradients with respect to points, rgb and weights 2e-5
              (dpcx's tests/test_sharded_render.py). Each run's seconds
              and step median, W 1 and W 2, beside the card's name and
              power limit; the ranks' output to OUT_DIR.
9f. bench   — `cli bench` at dpcx's full shapes (dpcx_torch/bench.py), in
              this process with every launch count 0 just before and read
              just after: every key finite and positive (the headline bf16
              at B 48, N 16384, D 64; fp32, b16, fwdbwd; d128 forward and
              fwdbwd in bf16; the gsplat windowed, dense and pallas keys and
              pallas at D 64 in bf16), no key's error, parity_ok in both
              modes, the exit code 0, and each of K1-K7 launched (K4 in
              K5's launch); one line with every key's value, bound, share
              and host median; the record to OUT_DIR.
10. time    — CUDA-event medians: each draw kernel and its plain version
              at the car_64_depth step's shapes beside its bound; each
              forward and backward kernel
              against its plain version at the shapes of phases 3h (the
              recompute backward too) and 3b and at the rgb_splats render
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
              modes; with its time by layer), and one call of the bench's
              value, fwdbwd_value, d128_fwdbwd_value,
              gsplat_pallas_fwdbwd_value and (eager, unchecked)
              gsplat_fwdbwd_value, and of each draw kernel (one launch),
              beside the host time per call and the share
              of it in which the card is idle. Wherever a kernel's device
              time is read (the kernel profiles and the steps), the
              profiler's time of the renderer kernels is held against CUDA
              events around their C entry points in the same calls: below
              half of it, the profile is taken again, and still short, the
              phase fails.

Every `cli train` run's launch counts also hold its draws: one
batch_draws launch a step (device_data, every shipped config) and one
dropout_weights launch a step where pc_point_dropout < 1 (two with remat,
whose recompute draws the same weights again); the parity steps make the
same draws on both sides.

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
import contextlib
import hashlib
import io
import json
import math
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

from dpcx_torch.bench import (
    ANISO_KERNEL_OPS,
    MUFU_EXP_PER_S,
    PEAK_F32_FLOPS,
    aniso_bound,
    draw_bound,
    render_bound,
)
from dpcx_torch.render.transform import CAMERA_DISTANCE, FOCAL_LENGTH

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "experiments" / "car_64_depth.yaml"
LARGECLOUD = REPO / "experiments" / "largecloud_pointshard.yaml"
CHAIR = REPO / "experiments" / "chair_gt_pose.yaml"
MULTICAT = REPO / "experiments" / "multicat_128_fused.yaml"
RGB_SPLATS = REPO / "experiments" / "rgb_splats.yaml"
PRED_POSE = REPO / "experiments" / "chair_pred_pose.yaml"
OUT_DIR = REPO / "chiprun_out"
KERNEL_ATOL = 1e-4  # atomics reorder the f32 splat sums from run to run
# phase 3e: the card's init against the CPU's, per leaf: within INIT_ULPS
# ulp of the leaf's largest value, on at most INIT_SHARE of its elements
# (tests/test_torch_init.py's bound against flax; expected bitwise: the
# draw is integer ops, IEEE float32 adds, multiplies, divides and square
# roots, and float64 FMAs, each rounded the same on both)
INIT_ULPS, INIT_SHARE = 2, 1e-3
DATAGEN_MODELS = 3
DATAGEN_MASK_FLIPS = 0.005  # tests/test_torch_data.py's mask flip share
# phase 3f's images: the colour pass divides each cell's colour sum by
# max(density, 1e-6) (dpcx's formula), so a near-empty cell's colour moves
# with an ulp of the points' transform; at most DATAGEN_IMAGE_SHARE of the
# values beyond KERNEL_ATOL, none beyond DATAGEN_IMAGE_ATOL (measured on
# an NVIDIA H100 80GB HBM3 at 700 W, one car_64_depth model: 36 of 245,760
# beyond 1e-4, the largest 5.1e-4, while the silhouettes and the blurred
# grids agree within 1.04e-5)
DATAGEN_IMAGE_SHARE, DATAGEN_IMAGE_ATOL = 1e-3, 2e-3
RBF_RTOL = 2e-5  # of the largest value: the renderer's parity on unit scale
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
# the bf16 modes vs the plain bf16 version, of the largest plain value:
# the forward within BF16_FWD_SHARE (its bf16 operands are products of bf16
# values, whose f32 sums rarely depend on their order); the gradients within
# BF16_SHARE in max abs (at the same grid coordinates on both sides, as K6
# and K7 take them) and BF16_GRAD_L2 in relative L2 (a rounded cotangent
# flips where two f32 sums in other orders straddle a bf16 boundary). The
# float32 mode on the same inputs must miss the forward's and the relative
# L2 limits, which shows the rounding points are the kernels'
BF16_FWD_SHARE, BF16_SHARE, BF16_GRAD_L2 = 1e-5, 2.0**-8, 1e-3
# phase 3h's bf16 gradients in max abs, of the largest plain one: the
# kernels sum the rotation in another order than the plain version's GEMM,
# so a coordinate an ulp away can move a bf16-rounded hat weight by one
# bf16 ulp, up to 2^-7 of it (the pose render's d points read 4.31e-3 of
# the largest, where the same render from shared grid coordinates read
# 5.4e-4; NVIDIA H100 80GB HBM3, 700 W); relative L2 stays BF16_GRAD_L2
BF16_FLIP_SHARE = 2.0**-7
SPLAT_GRAD_RTOL = 2e-4  # K7 vs plain: relative L2, dpcx's own bound for
# its Pallas backward against the dense oracle
# the kernels of csrc/fused_render.cu, as torch.profiler names them
K1_STAGES = ("splat_kernel", "blur_slab_kernel", "blur_z_kernel",
             "zblur_drc_kernel")
# every kernel of csrc/*.cu: what the profiler check (check_profile) sums
RENDER_KERNELS = ("splat_kernel", "blur_slab_kernel", "blur_z_kernel",
                  "zblur_drc_kernel", "drc_bwd_kernel", "drc_bwd_tile_kernel",
                  "splat_bwd_kernel", "aniso_fwd_kernel", "aniso_bwd_kernel")
# the names an older checkout's kernels had (the D > 64 z pass and z
# transpose before blur_z_kernel; the D <= 64 y/x pass before
# blur_slab_kernel; the f32 walk of the z-blur, DRC backward and z
# transpose before drc_bwd_tile_kernel and blur_z_kernel), which
# render_times also sums when it times such a tree
OLD_RENDER_KERNELS = ("zblur_kernel", "zblock_transpose_kernel",
                      "blur_yx_kernel", "zblur_drc_bwd_kernel")
# the renderer's blur passes and walks, which keep no per-thread array:
# phase 1 fails if ptxas gives one a stack frame or spills
NO_FRAME_KERNELS = ("blur_slab_kernel", "blur_z_kernel", "zblur_drc_kernel",
                    "drc_bwd_kernel", "drc_bwd_tile_kernel")
# their C entry points (csrc/*.cu), which launch_event_ms times
C_ENTRIES = ("dpcx_fused_render_world", "dpcx_fused_render_world_bwd",
             "dpcx_aniso_render", "dpcx_aniso_render_bwd")
# phase 3h's renders: those the main path makes (pointcloud_project_fn on
# the card: world clouds through fused_project_world, one render a cloud as
# the losses call it), chair_gt_pose's, and D 128 and D 72 with depth:
# (name, renders, points, D, depth, whether the cameras learn)
WORLD_SHAPES = (
    ("car_64_depth", 32, 16000, 64, True, False),
    ("chair_gt_pose", 64, 8000, 32, False, False),
    ("chair_pred_pose", 256, 2048, 32, False, True),
    ("multicat_128", 16, 16000, 128, False, False),
    ("multicat_128_depth", 8, 16000, 128, True, False),
    ("d72_depth", 4, 4000, 72, True, False),
)
SHARD_WARNING = "shard_points on a single device is a no-op"
# phase 9g: two ranks (torch.distributed.run) share the one card over gloo
PARALLEL_WORLD, DP_STEPS, PARALLEL_TIMEOUT = 2, 10, 480
# dpcx's test_dp_scan_matches_single_device_scan: the logged loss_total and
# the parameters of the data-parallel run against the one-device run
DP_LOSS_RTOL, DP_PARAM_ATOL = 2e-3, 5e-3
# largecloud_pointshard's two runs of the one-card path already differ by up
# to 6.3e-3 at a step by step 30 (the splat's float atomics, carried by Adam
# through bf16 compute; NVIDIA H100 80GB HBM3, 700 W), so its W 2 run is
# held at DP_LOSS_RTOL step by step over the first LARGECLOUD_EXACT_STEPS,
# before those differences grow, and on the mean of all its logged losses
LARGECLOUD_EXACT_STEPS = 4
# dpcx's tests/test_sharded_render.py: the sharded renderers against the
# unsharded one (the GT-pose loss's value as the silhouette)
SHARDED_TOL = {"silhouette": 1e-5, "depth": 1e-4, "rgb": 1e-4, "loss": 1e-5,
               "grad_points": 2e-5, "grad_rgb": 2e-5, "grad_weights": 2e-5}


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


# takes of one profile before device_profile gives up on lost records
PROFILE_TAKES = 4
# GPU cycles of the spin kernel queued ahead of each timed C entry: about
# 1 ms on an H100, longer than the host takes to launch one entry's kernels
ENTRY_SPIN_CYCLES = 2_000_000


def launch_event_ms(fn, runs: int = 10) -> float:
    """ms per call of fn() between CUDA events recorded around each call of
    the csrc kernels' C entry points (the library dpcx_torch._build loads),
    summed over the call: their device time alone. A spin kernel goes on
    the stream before each entry's first event, so the entry's launches
    are queued before they run, and the host's gaps between the kernels of
    one entry (which grow on a loaded host) stay outside the events."""
    from dpcx_torch import _build

    lib = _build.load()
    events, real = [], {name: getattr(lib, name) for name in C_ENTRIES}
    for name, entry in real.items():
        def timed(*a, _entry=entry):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(ENTRY_SPIN_CYCLES)
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
                   host_top: int = 0, check: bool = True,
                   names: tuple[str, ...] = RENDER_KERNELS
                   ) -> list[tuple[str, float]]:
    """Print torch.profiler's device microseconds per call of fn(), summed
    and per kernel (memsets and copies included), beside the host
    microseconds per call measured without the profiler, and with
    ``host_top`` the host ops of the most self CPU time; return the
    per-kernel list, largest first. With ``check`` fn launches csrc
    kernels, and the profiler's time of them (``names``) is held
    against launch_event_ms. A take below half of it, or one with no
    device time at all, has lost records (the profiler now and then drops
    a session's device records): the profile is taken again, after a
    pause, up to PROFILE_TAKES takes, and then this raises."""
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
    event_us = launch_event_ms(fn) * 1e3 if check else 0.0
    assert event_us > 0 or not check, f"{label}: no csrc kernel launched"
    for attempt in range(1, PROFILE_TAKES + 1):
        prof, kernels = take()
        busy_us = sum(us for _, us in kernels)
        complete = busy_us > 0
        if check:
            prof_us = sum(us for name, us in kernels
                          if any(k in name for k in names))
            print(f"profile check {label} (attempt {attempt}): csrc kernels "
                  f"{prof_us:.1f} us per call by torch.profiler, "
                  f"{event_us:.1f} us by CUDA events around their C entry "
                  f"points, ratio {prof_us / event_us:.3f} (at least 0.5)",
                  flush=True)
            complete = prof_us >= 0.5 * event_us
        elif not complete:
            print(f"profile check {label} (attempt {attempt}): no device "
                  "time", flush=True)
        if complete:
            break
        assert attempt < PROFILE_TAKES, (
            f"{label}: torch.profiler read {busy_us:.1f} us of device time"
            + (f", {prof_us:.1f} us of csrc kernels against {event_us:.1f}"
               if check else ""))
        time.sleep(0.2)
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


DRAW_STEPS = (0, 1, 9999, 2**31 - 1)


def phase_draws() -> dict:
    """1b. The draw kernels against their plain versions on the card,
    bitwise: the dropout weights at every shipped config's [B, N] and
    keep-prob, with the dropout key of scan steps 0, 1, 9999 and 2^31 - 1;
    the batch draws at every config's (B, V, V_use) over 32 and 200 models,
    with and without the second input view, at the same steps. Returns
    each kernel's largest error (0)."""
    import warnings

    from dpcx_torch.config import load_config
    from dpcx_torch.render.project import keep_prob_schedule
    from dpcx_torch.render.voxelize import pc_point_dropout_weights
    from dpcx_torch.utils import prng

    def same_bits(a, b) -> bool:  # floats as their int32 words
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.dtype == b.dtype and torch.equal(a, b)

    with warnings.catch_warnings():  # largecloud's one-device note
        warnings.simplefilter("ignore")
        cfgs = {p.stem: load_config(p).validate()
                for p in sorted((REPO / "experiments").glob("*.yaml"))}
    drop_shapes, row_shapes, checked = set(), set(), [0, 0]
    errs = {"dropout_weights": 0.0, "batch_draws": 0.0}
    for c in cfgs.values():
        drop_shapes.add((c.batch_size, c.pc_num_points, c.pc_point_dropout,
                         c.pc_point_dropout_steps))
        row_shapes.add((c.batch_size, c.num_views,
                        min(c.views_per_step, c.num_views)))
    for B, N, dropout, ramp in sorted(drop_shapes):
        c = cfgs["car_64_depth"].replace(pc_point_dropout=dropout,
                                         pc_point_dropout_steps=ramp)
        for step in DRAW_STEPS:
            k_drop = prng.split(prng.fold_in(prng.prng_key(1), step), 4)[3]
            keep = keep_prob_schedule(c, step)
            got = pc_point_dropout_weights(k_drop, B, N, keep, DEVICE)
            want = prng.dropout_weights_plain(k_drop, B, N, keep, DEVICE)
            torch.cuda.synchronize()
            assert same_bits(got, want), (B, N, dropout, step)
            errs["dropout_weights"] = max(errs["dropout_weights"],
                                          (got - want).abs().max().item())
            checked[0] += 1
    for B, V, V_use in sorted(row_shapes):
        for M in (MODELS, 200):
            for with_in2 in (False, True):
                for step in DRAW_STEPS:
                    kk = prng.fold_in(prng.prng_key(1), step)
                    keys = (*prng.split(kk, 4)[:3],
                            prng.fold_in(kk, 7) if with_in2 else None)
                    got = prng.batch_draws(*keys, B, M, V, V_use, DEVICE)
                    want = prng.batch_draws_plain(*keys, B, M, V, V_use,
                                                  DEVICE)
                    torch.cuda.synchronize()
                    assert same_bits(got, want), (B, M, V, V_use, step)
                    assert int(got[:, 0].max()) < M * V
                    errs["batch_draws"] = max(errs["batch_draws"], float(
                        (got - want).abs().max().item()))
                    checked[1] += 1
    print(f"draws: dropout_weights equal to the plain version bitwise at "
          f"{checked[0]} (shape, keep-prob, step) cases {sorted(drop_shapes)}"
          f"; batch_draws at {checked[1]} (B, M, V, V_use, v_in2, step) "
          f"cases over {sorted(row_shapes)} x M (32, 200)", flush=True)
    return errs


def time_draws(errs: dict) -> dict:
    """10. Each draw kernel's time (CUDA events around the call) at the
    car_64_depth step's shapes, beside its bound and its plain version's;
    with ``errs`` (phase_draws'), the numbers of the kernels' JSON entries
    and each kernel's call (``fn``), which phase 11 profiles."""
    from dpcx_torch.config import load_config
    from dpcx_torch.render.project import keep_prob_schedule
    from dpcx_torch.render.voxelize import pc_point_dropout_weights
    from dpcx_torch.utils import prng

    car = load_config(CONFIG)
    B, N, V = car.batch_size, car.pc_num_points, car.num_views
    V_use = min(car.views_per_step, V)
    k_drop = (1, 2)
    keep = keep_prob_schedule(car, 0)
    kk = prng.fold_in(prng.prng_key(1), 0)
    keys = (*prng.split(kk, 4)[:3], None)
    out = {}
    for name, kernel, plain, shape in (
            ("dropout_weights",
             lambda: pc_point_dropout_weights(k_drop, B, N, keep, DEVICE),
             lambda: prng.dropout_weights_plain(k_drop, B, N, keep, DEVICE),
             (B, N)),
            ("batch_draws",
             lambda: prng.batch_draws(*keys, B, 200, V, V_use, DEVICE),
             lambda: prng.batch_draws_plain(*keys, B, 200, V, V_use, DEVICE),
             (B, V, V_use))):
        # the plain versions launch hundreds of elementwise kernels a call
        k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain, runs=5, warmup=1)
        bound_ms, bound_by = draw_bound(name, *shape)
        out[name] = dict(ms=k_ms, plain_ms=p_ms, err=errs[name],
                         bound_ms=bound_ms, bound_by=bound_by, shape=shape,
                         fn=kernel)
        print(f"time {name} {shape}: kernel {k_ms * 1e3:.3f} us between "
              f"CUDA events around the call, bound {bound_ms * 1e3:.4f} us "
              f"({bound_by}); plain version {p_ms * 1e3:.3f} us | "
              f"{card_line()}", flush=True)
    return out


def shipped_configs() -> list[Path]:
    return sorted((REPO / "experiments").glob("*.yaml"))


def hold_leaf(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A card leaf against the CPU's: INIT_ULPS ulp of its largest value,
    on at most INIT_SHARE of its elements; returns the largest error."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    diff = (got.detach().cpu() - want).abs()
    err = float(diff.max())
    bound = INIT_ULPS * float(np.spacing(np.float32(want.abs().max())))
    share = float((diff > 0).float().mean())
    assert err <= bound and share <= INIT_SHARE, (name, err, bound, share)
    return err


def phase_init() -> dict:
    """dpcx's init on the card against the CPU (phase 3e); returns the
    card's init seconds by config."""
    from dpcx_torch.config import load_config
    from dpcx_torch.nets.layers import Conv3x3s2, Dense, weight_from_kernel
    from dpcx_torch.train import create_state
    from dpcx_torch.utils import prng

    cpu_leaves: dict = {}
    secs = {}
    for path in shipped_configs():
        if path == LARGECLOUD:
            continue
        cfg = load_config(path).validate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = create_state(cfg, "cuda").model
        torch.cuda.synchronize()
        secs[path.stem] = time.perf_counter() - t0
        t0 = time.perf_counter()
        worst, leaves, drawn = 0.0, 0, 0
        for name, mod in model.named_modules():
            if not isinstance(mod, (Dense, Conv3x3s2)):
                continue
            key = (cfg.seed, name, mod.flax_shape)
            if key not in cpu_leaves:
                cpu_leaves[key] = weight_from_kernel(prng.lecun_normal(
                    prng.param_key(cfg.seed, name.split("."), 1),
                    mod.flax_shape, mod.fan_in, "cpu")).contiguous()
                drawn += 1
            worst = max(worst, hold_leaf(f"{path.stem} {name}", mod.weight,
                                         cpu_leaves[key]))
            assert not mod.bias.any(), name
            leaves += 2
        n = sum(p.numel() for p in model.parameters())
        print(f"init {path.stem}: {n} parameters in {leaves} leaves, card "
              f"{secs[path.stem]:.3f} s; CPU draws of {drawn} new kernels "
              f"and the holds {time.perf_counter() - t0:.1f} s; largest "
              f"card-vs-CPU error {worst:.3e} (bound {INIT_ULPS} ulp of "
              f"each leaf's largest)", flush=True)
        del model
        torch.cuda.empty_cache()
    del cpu_leaves
    cfg = load_config(LARGECLOUD).validate()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = create_state(cfg, "cuda").model
    torch.cuda.synchronize()
    secs[LARGECLOUD.stem] = time.perf_counter() - t0
    fc = model.decoder.fc_points
    kernel = fc.weight.detach().t().reshape(-1)  # flax's [in, out], flat
    size, chunk = kernel.numel(), prng.DRAW_CHUNK
    key = prng.param_key(cfg.seed, ("decoder", "fc_points"), 1)
    std = prng.lecun_std(fc.fan_in)
    worst = 0.0
    for lo, hi in ((0, chunk), (size - chunk, size)):
        want = prng.truncated_normal_bits(
            prng.random_bits_range(key, lo, hi, "cpu"), -2.0, 2.0) * std
        worst = max(worst, hold_leaf(f"largecloud fc_points [{lo}, {hi})",
                                     kernel[lo:hi], want))
    n = sum(p.numel() for p in model.parameters())
    print(f"init {LARGECLOUD.stem}: {n} parameters, card "
          f"{secs[LARGECLOUD.stem]:.3f} s; fc_points ({size} draws) first "
          f"and last {chunk} against the CPU: largest error {worst:.3e}",
          flush=True)
    del model, kernel
    torch.cuda.empty_cache()
    return secs


def phase_datagen_devices() -> None:
    """make_dataset on the card against the CPU (phase 3f)."""
    from dpcx_torch.config import load_config
    from dpcx_torch.data.synthetic import make_dataset

    cfg = load_config(CONFIG).validate()
    got, secs = {}, {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[device] = {k: v.cpu() for k, v in make_dataset(
            cfg, DATAGEN_MODELS, seed=cfg.seed, device=device).items()}
        torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
    card, cpu = got["cuda"], got["cpu"]
    assert card.keys() == cpu.keys()
    for k in ("gt_points", "quats", "category_idx"):
        assert torch.equal(card[k], cpu[k]), k
    flips = (card["masks"] != cpu["masks"])
    assert float(flips.float().mean()) <= DATAGEN_MASK_FLIPS, flips.sum()
    same = ~flips
    depth_err = float((card["depths"] - cpu["depths"])[same].abs().max())
    image_off = (card["images"] - cpu["images"]).abs()
    image_err = float(image_off.max())
    beyond = float((image_off > KERNEL_ATOL).float().mean())
    assert depth_err <= KERNEL_ATOL, depth_err
    assert beyond <= DATAGEN_IMAGE_SHARE and image_err <= DATAGEN_IMAGE_ATOL, (
        beyond, image_err)
    print(f"datagen card vs CPU car_64_depth: {DATAGEN_MODELS} models x "
          f"{cfg.num_views} views, card {secs['cuda']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s; points and quats equal, mask flips "
          f"{int(flips.sum())} of {flips.numel()}, depth err {depth_err:.3e} "
          f"(atol {KERNEL_ATOL}), image err {image_err:.3e} (atol "
          f"{DATAGEN_IMAGE_ATOL}), {beyond:.2e} of the image values beyond "
          f"{KERNEL_ATOL} (at most {DATAGEN_IMAGE_SHARE})", flush=True)


def phase_rbf() -> None:
    """pointcloud2voxels_rbf on the card against the CPU (phase 3g)."""
    from dpcx_torch.render.voxelize import pointcloud2voxels_rbf

    rng = np.random.default_rng(SEED + 11)
    pts = torch.from_numpy(rng.uniform(-0.45, 0.45, (2, 4096, 3)).astype(
        np.float32))
    want = pointcloud2voxels_rbf(pts, 32, 1.0)
    got = pointcloud2voxels_rbf(pts.cuda(), 32, torch.tensor(1.0).cuda())
    torch.cuda.synchronize()
    err = float((got.cpu() - want).abs().max())
    peak = float(want.abs().max())
    assert torch.isfinite(got).all() and err <= RBF_RTOL * peak, (err, peak)
    print(f"rbf card vs CPU: 2 x 4096 points, D 32, sigma 1 cell: max abs "
          f"err {err:.3e} of peak {peak:.3f} (rtol {RBF_RTOL})", flush=True)


def world_grads(render, points, quat, pw, cam, dsil, ddepth):
    """render(points, quat, pw) -> (sil, depth or None): its outputs and
    the gradients of <dsil, sil> + <ddepth, depth> into points, pw and,
    with ``cam``, quat, in that order."""
    leaves = [points.detach().requires_grad_(), pw.detach().requires_grad_(),
              quat.detach().requires_grad_(cam)]
    sil, depth = render(leaves[0], leaves[2], leaves[1])
    loss = (sil * dsil).sum()
    if depth is not None:
        loss = loss + (depth * ddepth).sum()
    grads = torch.autograd.grad(
        loss, [t for t in leaves if t.requires_grad])
    return (sil.detach(), None if depth is None else depth.detach()), grads


def phase_world(cfg, fused, gauss) -> list[dict]:
    """3h. The renderer, fused_project_world (world clouds and cameras in;
    K1-K5's splat stages run the camera transform), against the plain
    version on the same inputs (pc_perspective_transform_t, then
    fused_project_plain, whose backward is K2's function, hat derivative 0
    at an exactly integer grid coordinate included) at every render of
    WORLD_SHAPES, with keep weights, random cotangents and seeded_ndc's
    shell and box as world clouds (some points project outside the grid),
    in both operand modes and at D > 64 in both backward modes: sil and
    depth within KERNEL_ATOL in float32 and BF16_FWD_SHARE of the largest
    plain value in bfloat16; the gradients of points, weights and, where
    the cameras learn, quaternions within GRAD_RTOL of the largest plain
    one in float32, BF16_FLIP_SHARE of it and BF16_GRAD_L2 relative L2 in
    bfloat16. The rotation's sums (FMAs in the kernels, a GEMM in the plain
    version) may move a coordinate by an ulp, inside these limits
    (tests/test_torch_front_cuda.py). Control: the float32-mode kernels'
    sil, depth, d points and d weights (saved grid) against the plain
    bfloat16 version must miss the bfloat16 forward limit and
    BF16_GRAD_L2, which shows the rounding points are the kernels'. One
    case per shape and mode."""
    from dpcx_torch.render.transform import pc_perspective_transform_t

    rng = np.random.default_rng(SEED + 5)
    focal, dist = cfg.focal_length, cfg.camera_distance
    out = []
    for name, renders, n, vox, wd, cam in WORLD_SHAPES:
        points = torch.from_numpy(np.ascontiguousarray(
            seeded_ndc(rng, renders, n).transpose(0, 2, 1))).to(DEVICE)
        quat = torch.from_numpy(
            rng.normal(size=(renders, 4)).astype(np.float32)).to(DEVICE)
        pw = torch.from_numpy(
            rng.uniform(0.0, 1.0, (renders, n)).astype(np.float32)
        ).to(DEVICE)
        dsil, ddepth = (torch.from_numpy(rng.normal(
            size=(renders, vox, vox)).astype(np.float32)).to(DEVICE)
            for _ in range(2))
        ddepth = ddepth if wd else None
        radius = gauss.kernel_radius(
            max(cfg.pc_relative_sigma, cfg.pc_relative_sigma_end), vox,
            cfg.gauss_kernel_truncate,
        )
        sigma = torch.tensor(cfg.pc_relative_sigma * vox, device=DEVICE)
        f32_kernels = None  # the float32 mode's outputs: bfloat16's control
        for acc in ("float32", "bfloat16"):
            bf16 = acc == "bfloat16"

            def plain(p, q, w):
                ndc = pc_perspective_transform_t(p, q, focal, dist)
                return fused.fused_project_plain(ndc, vox, sigma, radius, w,
                                                 wd, acc)

            (sil_p, dep_p), g_p = world_grads(plain, points, quat, pw, cam,
                                              dsil, ddepth)
            fwd_key = f"{fused.launch_family(vox)}_render" + (
                "_bf16" if bf16 else "")
            label = f"{name} ({acc})"
            fwd_err = bwd_err = 0.0
            missed = []  # every row is printed before any limit is enforced
            for save in (True, False) if vox > 64 else (True,):
                bwd_key = fused._bwd_name(vox, not save, bf16)
                before = launch_counts()
                (sil_k, dep_k), g_k = world_grads(
                    lambda p, q, w: fused.fused_project_world(
                        p, q, vox, sigma, radius, point_weights=w,
                        focal_length=focal, camera_distance=dist,
                        with_depth=wd, acc_dtype=acc, save_grid=save),
                    points, quat, pw, cam, dsil, ddepth)
                torch.cuda.synchronize()
                made = {k: v - before[k] for k, v in launch_counts().items()}
                assert made == only(**{fwd_key: 1, bwd_key: 1}), (label,
                                                                  made)
                if save and not bf16:
                    f32_kernels = (sil_k, dep_k), g_k
                for what, a, b in (("sil", sil_k, sil_p),
                                   ("depth", dep_k, dep_p)):
                    assert (a is None) == (b is None) == (
                        what == "depth" and not wd), what
                    if b is None:
                        continue
                    err = (a - b).abs().max().item()
                    bound = (BF16_FWD_SHARE * b.abs().max().item() if bf16
                             else KERNEL_ATOL)
                    print(f"world check {label} {what}: max abs err "
                          f"{err:.3e} (bound {bound:.3e})", flush=True)
                    if not err <= bound:
                        missed.append((what, err))
                    fwd_err = max(fwd_err, err)
                names = ("d points", "d weights", "d quat")[:len(g_p)]
                for what, a, b in zip(names, g_k, g_p):
                    err = (a - b).abs().max().item()
                    peak = b.abs().max().item()
                    rel = (torch.linalg.vector_norm(a - b)
                           / torch.linalg.vector_norm(b)).item()
                    share, l2 = ((BF16_FLIP_SHARE, BF16_GRAD_L2) if bf16
                                 else (GRAD_RTOL, None))
                    print(f"world check {label} {what} ({bwd_key}): max abs "
                          f"err {err:.3e}, largest plain {peak:.3e}, ratio "
                          f"{err / peak:.3e} (bound {share:.3e}), relative "
                          f"L2 {rel:.3e}" + (f" (bound {l2:.1e})" if l2
                                             else ""), flush=True)
                    assert np.isfinite(err) and peak > 0, (label, what)
                    if not (err <= share * peak
                            and (l2 is None or rel <= l2)):
                        missed.append((what, bwd_key, err, peak, rel))
                    bwd_err = max(bwd_err, err)
            if bf16:
                (sil_f, dep_f), g_f = f32_kernels
                for what, f, b in (("sil", sil_f, sil_p),
                                   ("depth", dep_f, dep_p)):
                    if b is None:
                        continue
                    ratio = ((f - b).abs().max() / b.abs().max()).item()
                    print(f"world control {label} {what}: the float32 "
                          f"mode's ratio {ratio:.3e} (must exceed "
                          f"{BF16_FWD_SHARE:.1e})", flush=True)
                    if not ratio > BF16_FWD_SHARE:
                        missed.append(("control", what, ratio))
                for what, f, b in zip(("d points", "d weights"), g_f, g_p):
                    rel = (torch.linalg.vector_norm(f - b)
                           / torch.linalg.vector_norm(b)).item()
                    print(f"world control {label} {what}: the float32 "
                          f"mode's relative L2 {rel:.3e} (must exceed "
                          f"{BF16_GRAD_L2:.1e})", flush=True)
                    if not rel > BF16_GRAD_L2:
                        missed.append(("control", what, rel))
            assert not missed, (label, missed)
            out.append(dict(name=name, acc=acc, points=points, quat=quat,
                            pw=pw, vox=vox, sigma=sigma, radius=radius,
                            with_depth=wd, cam=cam, dsil=dsil, ddepth=ddepth,
                            camera=(float(focal), float(dist)),
                            fwd_err=fwd_err, bwd_err=bwd_err))
    return out


def time_world(fused, case, save_grid: bool = True):
    """CUDA-event ms of the world forward through fused_project_world (the
    rotations, the taps and the launch) and of the backward launch alone
    (on the forward's grid, or the recompute launch; the cameras'
    gradients where they learn); and that backward launch for the
    profiler."""
    from dpcx_torch.geometry.quaternion import quaternion_to_matrix
    from dpcx_torch.render.gauss import gauss_kernel_1d

    points, pw, vox, radius = (case[k] for k in ("points", "pw", "vox",
                                                 "radius"))
    wd, bf16 = case["with_depth"], case["acc"] == "bfloat16"
    camera = case["camera"]
    kw = dict(point_weights=pw, focal_length=camera[0],
              camera_distance=camera[1], with_depth=wd,
              acc_dtype=case["acc"], save_grid=save_grid)
    f_ms = cuda_ms(lambda: fused.fused_project_world(
        points, case["quat"], vox, case["sigma"], radius, **kw))
    rot = quaternion_to_matrix(case["quat"]).contiguous()
    taps = gauss_kernel_1d(case["sigma"], radius).contiguous()
    _, _, grid = fused._launch_world_forward(points, pw, rot, None, camera,
                                             taps, radius, vox, wd, bf16)
    if not save_grid:
        grid = None

    def bwd():
        fused._launch_world_backward(
            points, pw, rot, None, camera, taps, radius, grid, case["dsil"],
            case["ddepth"], vox, wd, True, case["cam"], bf16)

    return f_ms, cuda_ms(bwd), bwd


def time_plain(fused, case):
    """CUDA-event ms of the plain version's forward
    (fused_project_reference) and backward (fused_backward_reference,
    which recomputes the grid) in the case's operand mode, on the grid
    coordinates of its clouds: no transform."""
    from dpcx_torch.render.transform import pc_perspective_transform_t

    ndc = pc_perspective_transform_t(case["points"], case["quat"],
                                     *case["camera"])
    args = (ndc, case["vox"], case["sigma"], case["radius"], case["pw"],
            case["with_depth"])
    return (cuda_ms(lambda: fused.fused_project_reference(
                *args, acc_dtype=case["acc"])),
            cuda_ms(lambda: fused.fused_backward_reference(
                *args, case["dsil"], case["ddepth"], case["acc"])))


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
    """One synchronised training step per call, as `cli train` runs it on
    device-resident records: one step of train_steps_scan (dpcx's scan
    draws: the batch and dropout key from PRNGKey(seed + 1) and the step)
    in a tree that has it; in an older tree, which --render-times and
    --splat-times may time, its batch_at and step_generator (the host-fed
    draws it trained with)."""
    from dpcx_torch import train as ttrain

    state = ttrain.create_state(cfg, DEVICE)
    records = ttrain.device_records(ds, DEVICE)
    if hasattr(ttrain, "train_steps_scan"):
        from dpcx_torch.utils import prng

        key = prng.prng_key(cfg.seed + 1)

        def step():
            ttrain.train_steps_scan(cfg, state, records, key, 1)
            torch.cuda.synchronize()
    else:
        def step():
            batch = ttrain.batch_at(cfg, ds, state.step, DEVICE, records)
            ttrain.train_step(cfg, state, batch, ttrain.step_generator(
                cfg.seed + 1, state.step, DEVICE))
            torch.cuda.synchronize()

    return step


# kernel-name pieces -> the layer a training step's device time belongs
# to; the first match wins, blur_slab_kernel (forward and backward both
# launch one once a step) is split half and half. The renderer's forward
# is K1 at D <= 64 and the counterpart of K3 above, with the z pass
# blur_z_kernel<false, ...>; its backward K2, or K4 + K5, with the DRC
# backward drc_bwd_kernel (drc_bwd_tile_kernel above D 64) and the z
# transpose blur_z_kernel<true, ...>
RENDER_FWD, RENDER_BWD = ("renderer forward (K1 / K3)",
                          "renderer backward (K2 / K4 + K5)")
STEP_LAYERS = (
    ("random draws (csrc/prng.cu)", ("dropout_weights_kernel",
                                     "batch_draws_kernel")),
    ("splat renderer backward (K7)", ("aniso_bwd_kernel",)),
    ("splat renderer forward (K6)", ("aniso_fwd_kernel",)),
    (RENDER_BWD, ("drc_bwd_kernel", "drc_bwd_tile_kernel",
                  "blur_z_kernel<true", "splat_bwd_kernel")),
    (RENDER_FWD, ("zblur_drc_kernel", "blur_z_kernel<false",
                  "splat_kernel")),
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
        if "blur_slab_kernel" in key:
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
    """Every kernel wrapper's launch counts: the fused renderer's (K1-K5),
    the anisotropic splats' (K6, K7) and the training step's draws."""
    from dpcx_torch.render import aniso, fused
    from dpcx_torch.utils import prng

    return fused.LAUNCHES, aniso.LAUNCHES, prng.LAUNCHES


def reset_counts() -> None:
    for c in counters():
        for name in c:
            c[name] = 0


def launch_counts() -> dict:
    return {k: v for c in counters() for k, v in c.items()}


def only(**counts) -> dict:
    """Every launch count 0 but the ones named."""
    return {name: counts.get(name, 0) for name in launch_counts()}


def draws(cfg, steps: int, remat: bool = False) -> dict:
    """The draw launches of ``steps`` training steps of ``cfg`` (a config
    or its YAML path), as `cli train` makes them: one batch_draws a step
    with device_data, one dropout_weights a step with pc_point_dropout < 1
    (two with remat, whose recompute draws the weights again)."""
    from dpcx_torch.config import load_config

    if isinstance(cfg, (str, Path)):
        cfg = load_config(cfg)
    out = {}
    if cfg.device_data:
        out["batch_draws"] = steps
    if cfg.pc_point_dropout < 1.0:
        out["dropout_weights"] = steps * (2 if remat else 1)
    return out


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
    through the plain versions, from the same init, on the same draws as
    `cli train` makes (scan_batch: the batch and dropout key of each step
    from the same key): per-parameter first-step gradients and the three
    losses within TRAIN_RTOL, and under predicted pose every step's winners
    equal.
    The kernel side takes the main path (no project_fn:
    pointcloud_project_fn's fused_project_world, whose splat stages run the
    camera transform; its silhouettes recorded around that call). The
    plain side is handed to train_step: pc_perspective_transform_t, then
    fused_project_plain (whose backward is K2's function, the hat
    derivative 0 at an exactly integer grid coordinate included), and
    aniso_density_reference in float32 or aniso_density_plain (K7's
    bfloat16 function written out) in bfloat16.
    ``want``: the
    renderer launches the kernel steps make (the plain steps make none);
    both make the draw launches. Returns the kernel run's (losses,
    first-step gradients)."""
    from dpcx_torch.render import aniso, fused, project
    from dpcx_torch.train import create_state, device_records, scan_batch
    from dpcx_torch.train import update
    from dpcx_torch.utils import prng

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
    records = device_records(ds, DEVICE)
    key = prng.prng_key(c.seed + 1)
    runs = {}
    world = project.fused_project_world
    for label, density in (("kernel", aniso.aniso_density),
                           ("plain", aniso_plain)):
        sils = []

        def recorded(*a, render=world if label == "kernel" else fused_plain,
                     **k):
            out = render(*a, **k)
            sils.append(out[0].detach())
            return out

        state = create_state(c, DEVICE)
        before = launch_counts()
        losses, grads, won = [], None, []
        if label == "kernel":
            project.fused_project_world = recorded
        try:
            for step in range(3):
                batch, k_drop = scan_batch(c, records, key, step)
                m = update(c, state, batch, k_drop, density_fn=density,
                           project_fn=None if label == "kernel"
                           else recorded)
                losses.append(m["loss_total"].item())
                if grads is None:
                    grads = {n: p.grad.detach().clone()
                             for n, p in state.model.named_parameters()}
                if c.predict_pose:
                    won.append(winners(c, sils[-1], batch["masks"]).cpu())
        finally:
            project.fused_project_world = world
        torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in launch_counts().items()}
        assert made == (only(**want, **draws(c, 3)) if label == "kernel"
                        else only(**draws(c, 3))), (label, made)
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
                            fused_render_bwd=TRAIN_STEPS,
                            **draws(cfg, TRAIN_STEPS)), launches
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
                                   fused_render_bwd=RESUME_STEPS,
                                   **draws(cfg, RESUME_STEPS))
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
                                   fused_render_bwd=CHAIR_STEPS,
                                   **draws(cfg, CHAIR_STEPS))
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
                               f"blocked_render_bwd{mode}": steps},
                            **draws(path, steps)), launches
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
        f"blocked_render_bwd_recompute{mode}": REMAT_STEPS},
        **draws(remat, REMAT_STEPS, remat=True)), launches


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


# the launch counts that show each TPU kernel ran in the bench (K4 runs in
# K5's launch)
BENCH_KERNELS = {
    "K1": ("fused_render", "fused_render_bf16"),
    "K2": ("fused_render_bwd", "fused_render_bwd_bf16"),
    "K3": ("blocked_render_bf16",),
    "K4 + K5": ("blocked_render_bwd_bf16",),
    "K6": ("aniso_render", "aniso_render_bf16"),
    "K7": ("aniso_render_bwd", "aniso_render_bwd_bf16"),
}


def phase_bench(cli, card: str) -> dict:
    """9f: `cli bench` at full shape, its record held to the gates (see the
    module docstring); -> the record."""
    from dpcx_torch import bench

    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["bench"])
    except SystemExit as e:
        raise AssertionError(f"cli bench exited {e.code}: "
                             f"{buf.getvalue()[-3000:]}") from e
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_bench.json").write_text(json.dumps(rec, indent=1))
    errors = {k: rec[k] for k in rec if k.endswith("_error")}
    assert not errors, errors
    assert rec["parity_ok"] is True, rec["parity"]
    for key in bench.KEYS:
        for k in (key, key + "_host", key + "_ms"):
            assert math.isfinite(rec[k]) and rec[k] > 0, (k, rec[k])
    missing = [f"{kernel} {name}" for kernel, names in BENCH_KERNELS.items()
               for name in names if not launches[name]]
    assert not missing, (missing, launches)

    def bound(key):
        if rec[key + "_bound"] is None:
            return "bound none (eager)"
        return (f"bound {rec[key + '_bound']:.2f} ({rec[key + '_bound_by']}),"
                f" share {rec[key + '_share']:.4f}")

    print("bench: " + "; ".join(
        f"{key} {rec[key]:.4f} Mpts/s ({rec[key + '_ms']:.4f} ms, "
        f"{bound(key)}, host median {rec[key + '_host']:.4f}, peak "
        f"{rec[key + '_peak_gib']:.2f} GiB)" for key in bench.KEYS)
        + f" | {card}", flush=True)
    print(f"bench: parity {json.dumps(rec['parity'])}, launches "
          f"{ {k: v for k, v in launches.items() if v} }, {secs:.1f} s",
          flush=True)
    return rec


def profile_bench_calls() -> None:
    """Phase 11's profiles of one call of four of phase 9f's bench keys,
    on the bench's inputs: the headline forward (bf16, 48 x 16384, D 64),
    fwdbwd_value (bf16, 16 x 16384), d128_fwdbwd_value (bf16, 16 x 16000,
    D 128) and gsplat_pallas_fwdbwd_value (K6 + K7 f32, 8 x 4096, D 32),
    each held against CUDA events; and the eager windowed splats
    (gsplat_fwdbwd_value), which launch no csrc kernel."""
    from dpcx_torch import bench
    from dpcx_torch.config import Config
    from dpcx_torch.render.project import pointcloud_project_fn

    sigma = torch.tensor(0.02, device=DEVICE)

    def render(renders, n, vox, backward):
        cfg = Config(vox_size=vox, pc_num_points=n, renderer="pallas",
                     pallas_acc_dtype="bfloat16", proj_depth=False)
        pts, quat = bench._inputs(renders, n, key=4 if vox > 64 else 0,
                                  device=DEVICE)

        def call():
            p = pts.detach().requires_grad_(backward)
            with torch.set_grad_enabled(backward):
                sil = pointcloud_project_fn(cfg, p, quat, sigma).silhouette
            if backward:
                torch.autograd.grad(sil.sum(), p)

        return call

    for key, renders, n, vox, backward in (
            ("value", 48, 16384, 64, False),
            ("fwdbwd_value", 16, 16384, 64, True),
            ("d128_fwdbwd_value", 16, 16000, 128, True)):
        device_profile(render(renders, n, vox, backward),
                       f"bench {key} ({renders} x {n}, D {vox}, bf16) call",
                       host_top=8)
    for impl, check in (("pallas", True), ("windowed", False)):
        _, body, ops = bench.gsplat_call(impl, device=DEVICE)
        carry = torch.zeros((), device=DEVICE)
        device_profile(lambda: body(carry, *ops),
                       f"bench gsplat {impl} (8 x 4096, D 32, f32, forward "
                       "+ backward) call", runs=20 if check else 5,
                       check=check, host_top=8)


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
        assert launch_counts() == only(**(
            draws(cfg, LARGECLOUD_STEPS) if verb == "train" else {})), \
            launch_counts()
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


def step_ms(checkpoint_dir: Path) -> list[float]:
    """Milliseconds of each logged step after the first of a fresh run
    logged every step: differences of the host clock at each logged read
    (synchronised by the read). ``steps_per_sec`` is the first record's
    steps over the seconds from the run's start, and every later one's
    steps since the first record over the seconds since its read."""
    recs = [json.loads(line) for line in
            (checkpoint_dir / "metrics.jsonl").read_text().splitlines()]
    recs = [r for r in recs if "steps_per_sec" in r]
    first = recs[0]["step"]
    t1 = first / recs[0]["steps_per_sec"]
    ends = [t1] + [t1 + (r["step"] - first) / r["steps_per_sec"]
                   for r in recs[1:]]
    return [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]


def sharded_cases() -> list[dict]:
    """Phase 9g (c): each sharded renderer at D 32 and 64, with the sum
    projection and both DRC modes (rgb where DRC composes it), on 8
    renders of car_64_depth's 16000 points with weights; and the GT-pose
    loss at D 64."""
    cases = []
    for vox in (32, 64):
        for mode in ("sum", "drc", "drc_logsum"):
            for kind in ("point", "grid"):
                cases.append({"kind": kind, "vox": vox, "mode": mode,
                              "rgb": mode != "sum" or kind == "point"})
    cases.append({"kind": "loss", "vox": 64, "mode": "drc", "rgb": True})
    return cases


def sharded_check(case: dict, device) -> dict:
    """One case of phase 9g (c) in this rank: the sharded render over the
    world (2 ranks) and the one-rank eager render (renderer xla) of the
    same seeded inputs, forward and the gradients of a fixed loss with
    respect to the points, colours and weights -> the largest difference
    of each output and gradient, and the sharded call's milliseconds."""
    from dpcx_torch.config import load_config
    from dpcx_torch.parallel.mesh import make_mesh
    from dpcx_torch.render import sharded
    from dpcx_torch.render.project import pointcloud_project_fn

    cfg = load_config(CONFIG).replace(
        vox_size=case["vox"], renderer="xla", proj_depth=True,
        proj_type="sum" if case["mode"] == "sum" else "drc",
        drc_logsum=case["mode"] == "drc_logsum")
    rng = np.random.default_rng(SEED + case["vox"])
    B, N = 8, cfg.pc_num_points
    pts = rng.normal(size=(B, N, 3))
    pts *= rng.uniform(0.15, 0.4, (B, 1, 3)) / np.linalg.norm(
        pts, axis=-1, keepdims=True)
    q = rng.normal(size=(B, 4))
    inp = {"points": pts, "quat": q / np.linalg.norm(q, axis=1,
                                                     keepdims=True),
           "weights": rng.uniform(0.3, 1.0, (B, N)),
           "target": rng.uniform(0.0, 1.0, (B, cfg.vox_size, cfg.vox_size))}
    if case["rgb"]:
        inp["rgb"] = rng.uniform(0.0, 1.0, (B, N, 3))
    inp = {k: torch.tensor(v, dtype=torch.float32, device=device)
           for k, v in inp.items()}
    sigma = torch.tensor(cfg.pc_relative_sigma, device=device)
    mesh = make_mesh(cfg, device=device)

    def run(render):
        leaves = {k: inp[k].clone().requires_grad_()
                  for k in ("points", "rgb", "weights") if k in inp}
        o = render(leaves)
        if case["kind"] == "loss":
            loss, res = o, {"loss": o}
        else:
            res = {"silhouette": o.silhouette}
            loss = torch.mean((o.silhouette - inp["target"]) ** 2)
            if o.depth is not None and cfg.proj_type == "drc":
                res["depth"] = o.depth
                loss = loss + torch.mean(o.depth ** 2)
            if o.rgb is not None:
                res["rgb"] = o.rgb
                loss = loss + torch.mean(o.rgb ** 2)
        loss.backward()
        res.update({f"grad_{k}": v.grad for k, v in leaves.items()})
        return {k: v.detach() for k, v in res.items()}

    masks = (inp["target"] > 0.5).float()
    tgt_rgb = inp["target"][..., None].expand(-1, -1, -1, 3)

    def sharded_fn(lv):
        if case["kind"] == "loss":
            return sharded.gt_pose_projection_loss_sharded(
                cfg, mesh, lv["points"], inp["quat"], masks, sigma,
                rgb=lv["rgb"], images_tgt=tgt_rgb,
                point_weights=lv["weights"])
        fn = (sharded.pointcloud_project_grid_sharded
              if case["kind"] == "grid"
              else sharded.pointcloud_project_point_sharded)
        return fn(cfg, mesh, lv["points"], inp["quat"], sigma,
                  point_weights=lv["weights"], rgb=lv.get("rgb"))

    def plain_fn(lv):
        o = pointcloud_project_fn(cfg, lv["points"], inp["quat"], sigma,
                                  point_weights=lv["weights"],
                                  rgb=lv.get("rgb"))
        if case["kind"] != "loss":
            return o
        rgb_cmp = o.rgb + (1.0 - o.silhouette[..., None]) * \
            cfg.rgb_background
        w = masks[..., None]
        return torch.mean((o.silhouette - masks) ** 2) + cfg.rgb_weight * (
            torch.sum(w * (rgb_cmp - tgt_rgb) ** 2)
            / (torch.sum(w) * 3.0).clamp_min(1.0))

    got, want = run(sharded_fn), run(plain_fn)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    run(sharded_fn)
    torch.cuda.synchronize(device)
    return {"case": case, "ms": (time.perf_counter() - t0) * 1e3,
            "errs": {k: float((got[k] - want[k]).abs().max())
                     for k in want},
            "shapes": {k: list(v.shape) for k, v in got.items()}}


def parallel_rank(spec_path: Path) -> int:
    """One rank of phase 9g, started by torch.distributed.run: a 1 MB
    all_reduce of a CUDA tensor (gloo takes CUDA tensors), each `cli
    train` run of the spec (counts set to 0 just before, read just after;
    the shard_points warnings), then every sharded case; -> the spec's
    out/rank<r>.json."""
    import warnings

    import torch.distributed as dist

    from dpcx_torch import cli
    from dpcx_torch.parallel.mesh import init_from_env

    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(spec_path.read_text())
    device = init_from_env(spec["device"])
    rank = dist.get_rank()
    res = {"rank": rank, "world": dist.get_world_size(),
           "device": str(device), "backend": dist.get_backend()}
    x = torch.full((1 << 18,), float(rank + 1), device=device)
    dist.all_reduce(x)
    res["all_reduce_1mb"] = float(x.min()), float(x.max())
    for name, argv in spec["runs"]:
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            cli.main(argv)
        torch.cuda.synchronize(device)
        res[name] = {"seconds": time.perf_counter() - t0,
                     "launches": launch_counts(),
                     "warnings": [str(w.message) for w in seen
                                  if SHARD_WARNING in str(w.message)]}
    res["sharded"] = [sharded_check(c, device) for c in spec["sharded"]]
    Path(spec["out"], f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def run_ranks(spec: dict, log: Path, world: int) -> list[dict]:
    """`python -m torch.distributed.run --standalone --nproc_per_node
    WORLD chip_smoke.py --parallel-rank SPEC` in its own session,
    killed whole at PARALLEL_TIMEOUT; its output to ``log``; -> each
    rank's record."""
    import os
    import signal

    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(world), str(REPO / "chip_smoke.py"),
           "--parallel-rank", str(spec_path)]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=PARALLEL_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        finally:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
    if rc != 0:
        print(log.read_text()[-6000:], flush=True)
        raise RuntimeError(f"phase 9g ranks ended with {rc}; log {log}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(world)]


class Tee(io.TextIOBase):
    """A text stream that writes to each of ``streams``."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


def phase_parallel(cli, tmp: Path, car_cfg, card: str,
                   world: int = PARALLEL_WORLD) -> None:
    """Phase 9g (parallel_runs), its output also in OUT_DIR (it lies
    beyond the tail that a chip call returns)."""
    OUT_DIR.mkdir(exist_ok=True)
    with open(OUT_DIR / f"chip_smoke_parallel_w{world}.txt", "w") as f, \
            contextlib.redirect_stdout(Tee(sys.stdout, f)):
        parallel_runs(cli, tmp, car_cfg, card, world)


def parallel_runs(cli, tmp: Path, car_cfg, card: str, world: int) -> None:
    """Phase 9g, parallelism on the card: two ranks of
    torch.distributed.run share it over gloo (a correctness phase: two
    ranks on one card are no speed-up). (a) `cli train` of car_64_depth at
    full width (B 8 x 4 views, K1 and K2 in every rank) with dropout off,
    DP_STEPS steps at W 1 (in this process) and W 2: the logged losses and
    the final parameters within dpcx's own tolerances; (b)
    largecloud_pointshard as shipped (shard_points) at W 2 for
    LARGECLOUD_STEPS: no one-device warning, finite falling losses within
    DP_LOSS_RTOL of phase 9d's W 1 run (each of the first
    LARGECLOUD_EXACT_STEPS, and the mean); (c) the sharded renderers against
    the one-rank eager render (sharded_cases). Every run's seconds and
    step median, W 1 and W 2."""
    from dpcx_torch.config import load_config, save_config

    paths = {}
    for w in (1, world):
        c = car_cfg.replace(pc_point_dropout=1.0, log_every=1,
                            save_every=DP_STEPS,
                            checkpoint_dir=str(tmp / f"dp_w{w}"))
        paths[w] = str(tmp / f"dp_w{w}.yaml")
        save_config(c, paths[w])
    dp_argv = ["-n", str(MODELS), "--steps", str(DP_STEPS)]
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "-f", paths[1], *dp_argv])
    torch.cuda.synchronize()
    w1_secs = time.perf_counter() - t0
    want = only(fused_render=DP_STEPS, fused_render_bwd=DP_STEPS,
                **draws(load_config(paths[1]), DP_STEPS))
    assert launch_counts() == want, launch_counts()
    lc = load_config(tmp / "largecloud.yaml").replace(
        checkpoint_dir=str(tmp / f"largecloud_w{world}"))
    lc_path = str(tmp / f"largecloud_w{world}.yaml")
    save_config(lc, lc_path)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    ranks = run_ranks({
        "device": "cuda", "out": str(tmp / "parallel"),
        "runs": [["car", ["train", "-f", paths[world], *dp_argv]],
                 ["largecloud", ["train", "-f", lc_path, "-n", str(MODELS),
                                 "--steps", str(LARGECLOUD_STEPS)]]],
        "sharded": sharded_cases()}, OUT_DIR / "chip_smoke_parallel.log",
        world)
    total = sum(range(1, world + 1))
    # init_from_env's rule: NCCL where every rank has a card of its own
    shared = world > torch.cuda.device_count()
    backend = "gloo" if shared else "nccl"
    note = ("; the ranks share one card: a correctness run, not a speed-up"
            if shared else "")
    for r in ranks:
        print(f"parallel rank {r['rank']} of {r['world']}: {r['device']}, "
              f"backend {r['backend']}; 1 MB all_reduce of a CUDA tensor "
              f"min/max {r['all_reduce_1mb']} (want {total})", flush=True)
        assert r["world"] == world and r["backend"] == backend
        assert r["all_reduce_1mb"] == [total, total], r["all_reduce_1mb"]
        assert r["car"]["launches"] == want, r["car"]["launches"]
        assert r["largecloud"]["launches"] == only(
            **draws(lc, LARGECLOUD_STEPS)), r["largecloud"]["launches"]
        assert r["car"]["warnings"] == r["largecloud"]["warnings"] == [], r

    runs = {w: Path(tmp / f"dp_w{w}") for w in (1, world)}
    for name, d in (("dp_w1", runs[1]), (f"dp_w{world}", runs[world]),
                    (f"largecloud_w{world}", Path(lc.checkpoint_dir))):
        shutil.copy(d / "metrics.jsonl",
                    OUT_DIR / f"chip_smoke_{name}_metrics.jsonl")

    # (a) car_64_depth, W 2 against W 1
    losses = {w: read_losses(d) for w, d in runs.items()}
    for w, ls in losses.items():
        assert [s for s, _ in ls] == list(range(1, DP_STEPS + 1)), (w, ls)
    a = np.array([v for _, v in losses[1]])
    b = np.array([v for _, v in losses[world]])
    loss_rel = float(np.max(np.abs(b - a) / np.abs(a)))
    p1, p2 = (torch.load(d / "ckpt" / f"{DP_STEPS}.pt", map_location="cpu",
                         weights_only=True)["params"] for d in runs.values())
    param_err = max(float((p1[k] - p2[k]).abs().max()) for k in p1)
    secs = {1: w1_secs, world: ranks[0]["car"]["seconds"]}
    for w, d in runs.items():
        ms = step_ms(d)
        rows = car_cfg.batch_size // w
        print(f"parallel car_64_depth W {w} (B 8 x 4 views, N 16000, D 64, "
              f"{'the whole batch' if w == 1 else f'B {rows} a rank'}): "
              f"{DP_STEPS} steps in {secs[w]:.2f} s, step median "
              f"{statistics.median(ms):.3f} ms (steps 2-{DP_STEPS}) | {card}"
              + ("" if w == 1 else note), flush=True)
    print(f"parallel car_64_depth W {world} vs W 1: loss_total "
          f"relative difference by step "
          f"{np.array2string(np.abs(b - a) / np.abs(a), precision=2)}, the "
          f"largest {loss_rel:.3e} (rtol "
          f"{DP_LOSS_RTOL}), final parameters {param_err:.3e} (atol "
          f"{DP_PARAM_ATOL}); launches a rank {ranks[0]['car']['launches']}",
          flush=True)
    fails = []
    if not (loss_rel <= DP_LOSS_RTOL and param_err <= DP_PARAM_ATOL):
        fails.append(("car_64_depth W 2 vs W 1", loss_rel, param_err))

    # (b) largecloud_pointshard, W 2 against phase 9d's W 1
    one = np.array([v for _, v in read_losses(tmp / "largecloud")])
    two_recs = read_losses(Path(lc.checkpoint_dir))
    two = np.array([v for _, v in two_recs])
    assert [s for s, _ in two_recs] == list(range(1, LARGECLOUD_STEPS + 1))
    assert np.isfinite(two).all(), two
    k, e = LARGECLOUD_STEPS // 3, LARGECLOUD_EXACT_STEPS
    by_step = np.abs(two - one) / np.abs(one)
    lc_rel = float(by_step[:e].max())
    mean_rel = abs(two.mean() - one.mean()) / one.mean()
    for w, d, sec in ((1, tmp / "largecloud", None),
                      (world, Path(lc.checkpoint_dir),
                       ranks[0]["largecloud"]["seconds"])):
        ms = step_ms(d)
        split = f", the points split over {w} ranks" if w > 1 else ""
        print(f"parallel largecloud_pointshard W {w} (N 131072, D 32, B 4 x "
              f"2 views{split}): {'' if sec is None else f'{sec:.2f} s, '}"
              f"step median {statistics.median(ms):.3f} ms (steps "
              f"2-{LARGECLOUD_STEPS}) | {card}" + ("" if w == 1 else note),
              flush=True)
    print(f"parallel largecloud_pointshard W {world}: loss_total "
          f"mean of the first {k} {two[:k].mean():.6f}, of the last {k} "
          f"{two[-k:].mean():.6f}; against W 1: relative difference by step "
          f"{np.array2string(by_step, precision=2)}, of the first {e} at "
          f"most {lc_rel:.3e}, of the mean of all {mean_rel:.3e} (rtol "
          f"{DP_LOSS_RTOL} each); no one-device warning", flush=True)
    if not (two[-k:].mean() < two[:k].mean() and lc_rel <= DP_LOSS_RTOL
            and mean_rel <= DP_LOSS_RTOL):
        fails.append(("largecloud_pointshard W 2 vs W 1", lc_rel, mean_rel))

    # (c) the sharded renderers against the one-rank eager render
    for r in ranks:
        for res in r["sharded"]:
            c = res["case"]
            label = (f"{c['kind']} D {c['vox']} {c['mode']}"
                     f"{' rgb' if c['rgb'] else ''}")
            if r["rank"] == 0:
                print(f"parallel sharded {label}: "
                      + ", ".join(f"{k} {v:.2e}" for k, v in
                                  res["errs"].items())
                      + f"; {res['ms']:.2f} ms forward + backward (W "
                      f"{world}) | {card}", flush=True)
            fails += [(r["rank"], label, k, v)
                      for k, v in res["errs"].items()
                      if not v <= SHARDED_TOL[k]]
    assert not fails, fails


def parallel_only(world: int) -> int:
    """Phase 9g alone at ``world`` ranks, after what it needs
    (car_64_depth's datagen, phase 9d), then a second one-card run of
    car_64_depth's and largecloud_pointshard's: their losses against the
    first are the one-card path's own spread (the splat's float atomics),
    beside which phase 9g's differences read."""
    from dpcx_torch import _build, cli
    from dpcx_torch.config import load_config, save_config
    from dpcx_torch.render import fused

    torch.backends.cuda.matmul.allow_tf32 = False  # as main()
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card} x {torch.cuda.device_count()}; torch "
          f"{torch.__version__}", flush=True)
    _build.build()
    _build.load()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp_name:
        tmp = Path(tmp_name)
        car_cfg = load_config(CONFIG).replace(
            data_dir=str(tmp / "data"), checkpoint_dir=str(tmp / "car"),
            log_every=1, save_every=100)
        save_config(car_cfg, tmp / "car.yaml")
        phase_datagen(cli, fused, str(tmp / "car.yaml"), MODELS,
                      "car_64_depth")
        phase_largecloud(cli, fused, tmp)
        t0 = time.perf_counter()
        phase_parallel(cli, tmp, car_cfg, card, world)
        print(f"phase 9g at W {world}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        for name, steps in (("dp_w1", DP_STEPS),
                            ("largecloud", LARGECLOUD_STEPS)):
            path = tmp / f"{name}_again.yaml"
            save_config(load_config(tmp / f"{name}.yaml").replace(
                checkpoint_dir=str(tmp / f"{name}_again")), path)
            cli.main(["train", "-f", str(path), "-n", str(MODELS),
                      "--steps", str(steps)])
            a, b = (np.array([v for _, v in read_losses(tmp / d)])
                    for d in (name, f"{name}_again"))
            by_step = np.abs(b - a) / np.abs(a)
            print(f"one card, two runs of {name}: loss_total relative "
                  f"difference by step {np.array2string(by_step, precision=2)}"
                  f", the worst {by_step.max():.3e}, of the mean "
                  f"{abs(b.mean() - a.mean()) / a.mean():.3e} | {card}",
                  flush=True)
    return 0


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
                               f"aniso_render_bwd{mode}": steps},
                            **draws(path, steps)), launches
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
                               f"fused_render_bwd{mode}": steps},
                            **draws(path, steps)), launches
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
    assert launch_counts() == only(fused_render=n, fused_render_bwd=n,
                                   **draws(rs, n))

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


# the keys and order of `cli eval --all-views --flip-resolve --per-sample`
# on a predicted-pose model (dpcx's evaluate)
EVAL_KEYS = [
    "pose_acc_30deg", "pose_median_err_deg", "pose_acc_30deg_up_to_flip",
    "pose_median_err_deg_up_to_flip", "pose_flip_rate",
    "pose_gauge_spread_deg", "pose_acc_30deg_flip_resolved",
    "pose_median_err_deg_flip_resolved", "flip_resolve_changed", "chamfer",
    "chamfer_pred_to_gt", "chamfer_gt_to_pred", "iou_3d_16", "per_sample",
]
# card against CPU, as tests/test_torch_predict.py holds the port to dpcx:
# pose metrics and Chamfer rtol EVAL_RTOL, iou_3d_16 within EVAL_IOU_ATOL
# (a point within the forwards' difference of a cell boundary may round
# into the next cell)
EVAL_RTOL, EVAL_IOU_ATOL = 1e-5, 1e-2
# The canonical alignment is an argmin over candidate rotations: where two
# candidates' mean errors lie closer than the two forwards' difference
# moves them (a tie), the card and the CPU may pick different ones; so may
# the re-alignment of the flip-corrected poses behind the up-to-flip
# metrics. A tie is shown by two picks (a rotation of more than
# TIE_MIN_DEG between them; q_align 1e-5 apart is one pick) at most TIE_DEG
# apart, the CPU's mean errors at them within TIE_GAP (relative). Tie or
# not, every metric is held at EVAL_RTOL / EVAL_IOU_ATOL to the CPU's at
# the card's picks.
TIE_GAP, TIE_DEG, TIE_MIN_DEG = 1e-5, 2.0, 2e-3


def run_cli_json(cli, argv: list[str]) -> tuple[dict, float]:
    """One verb's last JSON line and its seconds (the card synchronised)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return json.loads(buf.getvalue().strip().splitlines()[-1]), secs


def alignment_tie(cpu_pose, card_pose, gt_quats, device=DEVICE):
    """The canonical alignments of the CPU's and the card's poses (the
    latter on ``device``): the rotation between the two picks (degrees), the
    relative gap between the CPU's mean errors at them, and the card's
    pick (on the CPU)."""
    from dpcx_torch.eval.pose_metrics import align_canonical_frame
    from dpcx_torch.geometry.quaternion import (
        quaternion_angular_distance,
        quaternion_multiply,
    )

    pc, gq = torch.from_numpy(cpu_pose), torch.from_numpy(gt_quats)
    q_c, _ = align_canonical_frame(pc, gq)
    q_g, _ = align_canonical_frame(torch.from_numpy(card_pose).to(device),
                                   gq.to(device))
    q_g = q_g.cpu()

    def mean_err(q):
        return float(quaternion_angular_distance(
            quaternion_multiply(pc, q[None]), gq).mean())

    # the rotation between them, 2 arccos |a . b|, in float64 by atan2
    # (an f32 arccos reads 0 below ~0.04 degrees): arccos(a . b) is
    # 2 atan2(|a - b|, |a + b|)
    a, b = q_c.double(), q_g.double() * torch.sign((q_c * q_g).sum())
    deg = math.degrees(4 * math.atan2(float((a - b).norm()),
                                      float((a + b).norm())))
    return deg, abs(mean_err(q_g) - mean_err(q_c)) / mean_err(q_c), q_g


def realignment_tie(cpu_pose, card_pose, gt_quats, device=DEVICE):
    """alignment_tie of `evaluate`'s second alignment, the one of the
    flip-corrected poses behind the up-to-flip metrics
    (dpcx_torch/predict.py: each aligned pose, or its composition with the
    180-degree flip where that is nearer the GT, aligned again), each side
    corrected on its own device as `evaluate` corrects it."""
    from dpcx_torch.eval.pose_metrics import (
        FLIP_QUAT,
        align_canonical_frame,
        pose_error_metrics,
    )
    from dpcx_torch.geometry.quaternion import quaternion_multiply

    def corrected(pose, device):
        p, g = (torch.from_numpy(a).to(device) for a in (pose, gt_quats))
        _, aligned = align_canonical_frame(p, g)
        flipped = quaternion_multiply(aligned, FLIP_QUAT.to(device))
        e0 = pose_error_metrics(aligned, g)["angular_err_deg"]
        e1 = pose_error_metrics(flipped, g)["angular_err_deg"]
        return torch.where((e1 < e0)[:, None], flipped, aligned).cpu().numpy()

    return alignment_tie(corrected(cpu_pose, "cpu"),
                         corrected(card_pose, device), gt_quats, device)


# the metrics of the flip-corrected re-alignment alone
REALIGNED = ("pose_acc_30deg_up_to_flip", "pose_median_err_deg_up_to_flip")


def metrics_at_pick(pred, q_align, q_realign, gt_points, gt_quats) -> dict:
    """`evaluate`'s metrics (view 0) on the CPU, from the predictions
    `pred`, at the canonical pick `q_align` and the re-alignment pick
    `q_realign` in place of its own argmins: what `evaluate` computes after
    them."""
    from dpcx_torch.eval.chamfer import chamfer_distance
    from dpcx_torch.eval.iou import voxel_iou
    from dpcx_torch.eval.pose_metrics import (
        FLIP_QUAT,
        pose_error_metrics,
        pose_error_metrics_up_to_flip,
    )
    from dpcx_torch.geometry.quaternion import (
        quaternion_conjugate,
        quaternion_multiply,
        quaternion_rotate,
    )

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    gt, gq = t(gt_points), t(gt_quats)
    aligned = quaternion_multiply(t(pred["pose"]), q_align[None])
    pm = pose_error_metrics(aligned, gq)
    flipped = quaternion_multiply(aligned, FLIP_QUAT)
    e0 = pm["angular_err_deg"]
    e1 = pose_error_metrics(flipped, gq)["angular_err_deg"]
    corrected = torch.where((e1 < e0)[:, None], flipped, aligned)
    fm = pose_error_metrics_up_to_flip(
        quaternion_multiply(corrected, q_realign[None]), gq)
    pts = quaternion_rotate(t(pred["points"]),
                            quaternion_conjugate(q_align)[None])
    cd = chamfer_distance(pts, gt)
    return {
        "pose_acc_30deg": float(pm["acc_30deg"]),
        "pose_median_err_deg": float(pm["median_err_deg"]),
        "pose_acc_30deg_up_to_flip": float(fm["acc_30deg_up_to_flip"]),
        "pose_median_err_deg_up_to_flip": float(
            fm["median_err_deg_up_to_flip"]),
        "pose_flip_rate": float((e1 < e0).float().mean()),
        "chamfer": float(cd["chamfer"].mean()),
        "chamfer_pred_to_gt": float(cd["pred_to_gt"].mean()),
        "chamfer_gt_to_pred": float(cd["gt_to_pred"].mean()),
        "iou_3d_16": float(voxel_iou(pts, gt, 16).mean()),
    }


def eval_off(key: str, got: float, ref: float) -> float:
    """|got - ref| over its tolerance: EVAL_IOU_ATOL for iou_3d_16, else
    EVAL_RTOL relative to ref."""
    if key == "iou_3d_16":
        return abs(got - ref) / EVAL_IOU_ATOL
    return abs(got - ref) / (EVAL_RTOL * abs(ref) + 1e-12)


def is_tie(deg: float, gap: float) -> bool:
    """Two picks more than TIE_MIN_DEG and at most TIE_DEG apart, the
    CPU's mean errors at them within TIE_GAP."""
    return TIE_MIN_DEG < deg <= TIE_DEG and gap <= TIE_GAP


def hold_eval_metrics(got, want, at_pick, canonical, realign) -> list[str]:
    """The card's `evaluate` metrics ``got`` against the CPU's ``want``:
    each within tolerance (eval_off) of the CPU's at the card's picks
    (``at_pick``: metrics_at_pick), in every run; a miss of the CPU's own
    values only under a tie (is_tie) of the canonical alignment
    (``canonical``: its (degrees, gap)), or, where the up-to-flip
    metrics alone miss and the canonical picks agree, of the re-alignment
    (``realign``). Returns the misses; raises where a check fails."""
    assert set(at_pick) == set(want), (sorted(at_pick), sorted(want))
    assert all(eval_off(k, got[k], v) <= 1.0 for k, v in at_pick.items()), (
        {k: (got[k], v) for k, v in at_pick.items()})
    missed = [k for k in want if eval_off(k, got[k], want[k]) > 1.0]
    if missed:
        assert is_tie(*canonical) or (
            set(missed) <= set(REALIGNED) and canonical[0] <= TIE_MIN_DEG
            and is_tie(*realign)), (missed, canonical, realign)
    return missed


def hold_eval_to_cpu(cfg, ds) -> None:
    """`evaluate` (view 0) of the newest checkpoint on the card against the
    same on the CPU, on the same held-out set, with the forward in float32
    on both (TF32 off): hold_eval_metrics, with the CPU's metrics at the
    card's two alignment picks. The predictions themselves are held within
    1e-4."""
    from dpcx_torch.predict import evaluate, predict_dataset
    from dpcx_torch.train import load_checkpoint

    cfg = cfg.replace(compute_dtype="float32")
    card = load_checkpoint(cfg, DEVICE)["params"]
    cpu = load_checkpoint(cfg, "cpu")["params"]
    reset_counts()
    t0 = time.perf_counter()
    got = evaluate(cfg, card, ds)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    assert launch_counts() == only(), launch_counts()
    t0 = time.perf_counter()
    want = evaluate(cfg, cpu, ds)
    cpu_s = time.perf_counter() - t0
    p_card = predict_dataset(cfg, card, ds)
    p_cpu = predict_dataset(cfg, cpu, ds)
    pred_err = {k: float(np.abs(p_card[k] - p_cpu[k]).max()) for k in p_cpu}
    assert list(got) == list(want) and "pose_acc_30deg" in got, (got, want)
    assert all(np.isfinite(v) for v in got.values()), got
    gt_quats = ds.records["quats"][:, 0].astype(np.float32)
    deg, gap, q_card = alignment_tie(p_cpu["pose"], p_card["pose"], gt_quats)
    deg2, gap2, q2_card = realignment_tie(p_cpu["pose"], p_card["pose"],
                                          gt_quats)
    at_pick = metrics_at_pick(p_cpu, q_card, q2_card,
                              ds.records["gt_points"], gt_quats)
    missed = [k for k in want if eval_off(k, got[k], want[k]) > 1.0]
    print(f"eval card vs CPU chair_pred_pose (view 0, {ds.num_models} "
          f"models, float32 forward): card {card_s:.2f} s, CPU "
          f"{cpu_s:.2f} s; predictions max abs diff {pred_err}; "
          + ", ".join(f"{k} {got[k]:.6g}/{want[k]:.6g}" for k in want)
          + f"; outside rtol {EVAL_RTOL} (iou {EVAL_IOU_ATOL}): {missed}; "
          f"canonical alignment picks {deg:.4f} degrees apart, the CPU's "
          f"mean errors at them {gap:.2e} apart (relative); re-alignment "
          f"picks {deg2:.4f} degrees apart, {gap2:.2e}; the CPU at the "
          f"card's picks: "
          + ", ".join(f"{k} {v:.6g}" for k, v in at_pick.items())
          + f" | {card_line()}", flush=True)
    assert max(pred_err.values()) < 1e-4, pred_err
    hold_eval_metrics(got, want, at_pick, (deg, gap), (deg2, gap2))


def phase_eval(cli, pose_path: str, car_path: str) -> None:
    """9e. The eval and predict verbs on the card: `cli eval --all-views
    --flip-resolve --per-sample` of phase 9c's step-200 chair_pred_pose
    model, `evaluate` (view 0) on the card against the CPU, and `cli
    predict` of phase 8's car_64_depth model. Each held-out set is drawn at
    seed + 1 first, its GT views through K1; the verbs launch no kernel."""
    from dpcx_torch.config import load_config
    from dpcx_torch.data.dataset import load_or_make
    from dpcx_torch.serve import ServingModel
    from dpcx_torch.train import load_checkpoint

    card = card_line()
    cfg = load_config(pose_path)
    reset_counts()
    ds = load_or_make(cfg, MODELS, seed=cfg.seed + 1, device=DEVICE)
    torch.cuda.synchronize()
    assert launch_counts() == only(fused_render=MODELS), launch_counts()
    reset_counts()
    out, secs = run_cli_json(cli, ["eval", "-f", pose_path, "-n",
                                   str(MODELS), "--all-views",
                                   "--flip-resolve", "--per-sample"])
    launches = launch_counts()
    rows = MODELS * cfg.num_views
    assert list(out) == EVAL_KEYS, list(out)
    ps = out.pop("per_sample")
    assert all(len(v) == (MODELS if k == "gauge_spread_deg" else rows)
               for k, v in ps.items()), {k: len(v) for k, v in ps.items()}
    assert all(np.isfinite(v) for v in out.values()), out
    assert all(np.isfinite(np.asarray(v, float)).all() for v in ps.values())
    for k in ("pose_acc_30deg", "pose_acc_30deg_up_to_flip",
              "pose_acc_30deg_flip_resolved", "pose_flip_rate",
              "flip_resolve_changed", "iou_3d_16"):
        assert 0.0 <= out[k] <= 1.0, (k, out[k])
    assert min(out["chamfer"], out["chamfer_pred_to_gt"],
               out["chamfer_gt_to_pred"]) >= 0.0, out
    assert launches == only(), launches
    launches = {k: v for k, v in launches.items() if v} or "none"
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_chair_pred_pose_eval.json").write_text(
        json.dumps({**out, "per_sample": ps}) + "\n")
    print(f"eval chair_pred_pose (step {POSE_STEPS}, held-out seed "
          f"{cfg.seed + 1}, {MODELS} models x {cfg.num_views} views pooled, "
          f"flip resolve, per sample): {json.dumps(out)}; launches "
          f"{launches}; `cli eval` {secs:.2f} s | {card}", flush=True)

    hold_eval_to_cpu(cfg, ds)

    car = load_config(car_path)
    reset_counts()
    car_ds = load_or_make(car, MODELS, seed=car.seed + 1, device=DEVICE)
    torch.cuda.synchronize()
    assert launch_counts() == only(fused_render=MODELS), launch_counts()
    preds_path = Path(car.checkpoint_dir) / "car_64_preds.npz"
    reset_counts()
    out, secs = run_cli_json(cli, ["predict", "-f", car_path, "-n",
                                   str(MODELS), "-o", str(preds_path)])
    assert out == {"num_models": MODELS, "out": str(preds_path)}, out
    launches = launch_counts()
    assert launches == only(), launches
    launches = {k: v for k, v in launches.items() if v} or "none"
    with np.load(preds_path) as f:
        preds = {k: f[k] for k in f.files}
    assert {k: v.shape for k, v in preds.items()} == {
        "points": (MODELS, car.pc_num_points, 3), "scale": (MODELS, 1)}, \
        {k: v.shape for k, v in preds.items()}
    assert all(np.isfinite(v).all() for v in preds.values())
    served = ServingModel(car, load_checkpoint(car, DEVICE)["params"])(
        car_ds.records["images"][:, 0])
    err = float(np.abs(served["points"] - preds["points"]).max())
    assert err <= 1e-6, err
    print(f"predict car_64_depth (step {TRAIN_STEPS + RESUME_STEPS}, "
          f"held-out seed {car.seed + 1}): {MODELS} models -> points "
          f"{preds['points'].shape}, scale {preds['scale'].shape}, finite, "
          f"within {err:.1e} of a ServingModel call on the same images; "
          f"launches {launches}; `cli predict` {secs:.2f} s | {card}",
          flush=True)


def import_tree(tree: Path, label: str, keep) -> str:
    """For an A/B run: put the checkout at TREE (this one, or an older
    commit unpacked with `git archive` into a directory .gitignore lists)
    first on the path, build and load its dpcx_torch, print ptxas's report
    of its kernels whose name ``keep`` accepts, and return the card line."""
    # this checkout's dpcx_torch is imported (for the bounds): drop it, so
    # that the tree's own modules are the ones loaded
    for name in [m for m in sys.modules
                 if m == "dpcx_torch" or m.startswith("dpcx_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree.resolve()))
    import dpcx_torch
    from dpcx_torch import _build

    assert Path(dpcx_torch.__file__).resolve().is_relative_to(
        tree.resolve()), dpcx_torch.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    _build.build()
    _build.load()
    for name, frame, spill, regs, smem in ptxas_report(
            _build.build_log().read_text()):
        if keep(name):
            print(f"{label} {tree}: ptxas {name}: {regs} registers, "
                  f"{smem} bytes shared memory, {frame} bytes stack frame, "
                  f"{spill} bytes spilled", flush=True)
    return card


def step_stats(cfg, ds) -> dict:
    """Host-clock median, 10th and 90th percentiles of 30 training steps
    of cfg on ds, after 3."""
    steps = host_times(training_step_fn(cfg, ds), runs=30, warmup=3)
    return dict(step_ms_median=statistics.median(steps),
                step_ms_p10=float(np.percentile(steps, 10)),
                step_ms_p90=float(np.percentile(steps, 90)))


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
    card = import_tree(tree, "splat times", lambda name: "aniso" in name)
    from dpcx_torch.config import load_config
    from dpcx_torch.data.dataset import load_or_make
    from dpcx_torch.render import aniso

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
            rec.update(step_stats(cfg.replace(pallas_acc_dtype=mode), ds),
                       card=card)
            print(json.dumps(rec), flush=True)
    return 0


def stage_name(key: str) -> str:
    """A profiler kernel name cut to its function and template arguments,
    e.g. blur_slab_kernel<true>."""
    m = re.search(r"(\w+_kernel(?:_mma)?(?:<[^>(]*>)?)", key)
    return m.group(1) if m else key


LATTICE_CAMERA = (FOCAL_LENGTH, CAMERA_DISTANCE)


def lattice_world(renders: int, vox: int, seed: int) -> torch.Tensor:
    """World points [R, N, 3] on the card, in front of an identity camera
    at the shipped configs' focal length and camera distance, whose grid
    coordinates put one point in each 2 x 2 x 2 block of cells at a seeded
    offset in [0.01, 0.99) from the block's first cell (the margin takes
    the transform's rounding): every cell takes at most one splat
    contribution, so the atomics' order cannot change a sum, and a
    renderer's outputs are a function of its sum order alone."""
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(*[np.arange(0, vox - 1, 2)] * 3,
                                indexing="ij")).reshape(3, -1)
    g = base[None] + rng.uniform(0.01, 0.99, (renders, 3, base.shape[1]))
    x, y, z = ((g[:, ::-1] + 0.5) / vox - 0.5).transpose(1, 0, 2)
    scale = (z + LATTICE_CAMERA[1]) / LATTICE_CAMERA[0]
    pts = np.stack([x * scale, y * scale, z], axis=-1)
    return torch.tensor(pts, dtype=torch.float32, device=DEVICE).contiguous()


def outputs_sha(fused, renders: int, vox: int, radius: int,
                with_depth: bool, bf16: bool) -> str:
    """sha256 of the world forward's sil (and depth) and of the saved-grid
    backward's gradients (and above D 64 the recompute's) on
    lattice_world (weights and cotangents seeded; no camera gradient,
    whose sums over warps are atomic), after checking that two runs
    agree: equal digests for two trees show their kernels compute the same
    bits."""
    from dpcx_torch.render import gauss

    points = lattice_world(renders, vox, SEED + vox)
    rot = torch.eye(3, device=DEVICE).expand(renders, 3, 3).contiguous()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pw = torch.rand(renders, points.shape[1], device=DEVICE,
                    generator=gen) * 2
    dsil = torch.randn(renders, vox, vox, device=DEVICE, generator=gen)
    ddepth = (torch.randn(renders, vox, vox, device=DEVICE, generator=gen)
              if with_depth else None)
    taps = gauss.gauss_kernel_1d(torch.tensor(0.05 * vox, device=DEVICE),
                                 radius).contiguous()

    def digest() -> str:
        sil, depth, grid = fused._launch_world_forward(
            points, pw, rot, None, LATTICE_CAMERA, taps, radius, vox,
            with_depth, bf16)
        outs = [sil, depth]
        for g in (grid, None) if vox > 64 else (grid,):
            outs += fused._launch_world_backward(
                points, pw, rot, None, LATTICE_CAMERA, taps, radius, g, dsil,
                ddepth, vox, with_depth, True, False, bf16)
        h = hashlib.sha256()
        for t in outs:
            if t is not None:
                h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    first = digest()
    assert digest() == first, "a repeated launch gave other bits"
    return first[:16]


def fwd_errors(fused, points, quat, camera, vox, sigma, radius, pw,
               with_depth, mode, runs: int = 8) -> list[float]:
    """The distinct largest errors of ``runs`` world forwards against the
    plain version on the same inputs (the torch transform, then
    fused_project_reference): more than one where the splat's atomics add
    a cell's contributions in another order from launch to launch."""
    from dpcx_torch.render.transform import pc_perspective_transform_t

    want = fused.fused_project_reference(
        pc_perspective_transform_t(points, quat, *camera), vox, sigma,
        radius, pw, with_depth, acc_dtype=mode)
    errs = set()
    for _ in range(runs):
        with torch.no_grad():
            got = fused.fused_project_world(
                points, quat, vox, sigma, radius, pw,
                focal_length=camera[0], camera_distance=camera[1],
                with_depth=with_depth, acc_dtype=mode)
        errs.add(max((a - b).abs().max().item() for a, b in zip(got, want)
                     if a is not None))
    return sorted(errs)


def render_times(tree: Path) -> int:
    """``--render-times TREE``: the A/B of a change to the renderer kernels
    (K1, K2 at D <= 64; K3, K4 + K5 above), for the checkout at TREE, as
    splat_times does for the splats (one process per tree, in turns: old,
    new, new, old). It drives the world launchers
    (render/fused.py::_launch_world_forward, _launch_world_backward), so
    TREE must have them. Prints ptxas's report of the tree's
    csrc/fused_render.cu kernels, then one JSON line for each render and
    operand mode, at the car_64_depth render (32 x 16000, D 64, R 8,
    depth), the chair_pred_pose one (256 x 2048, D 32, R 6, the cameras'
    gradient) and the multicat_128 one (16 x 16000, D 128, R 16), each
    with seeded world clouds (seeded_ndc's shell and box), random cameras
    and dropout weights: the torch.profiler device us per call of the
    forward launch, the backward launch on the saved grid and (D > 64) the
    recompute launch, each in all and per kernel (stage), the forward's
    and the backward's render_bound, outputs_sha (equal for two trees
    whose kernels compute the same bits) and fwd_errors on the seeded
    clouds with the dropout weights and with uniform ones; and the
    host-clock median, 10th and 90th percentiles of 30 training steps
    (after 3) on 32 synthetic models: car_64_depth in float32,
    chair_pred_pose in bfloat16, multicat_128 in both."""
    card = import_tree(tree, "render times",
                       lambda name: "aniso" not in name)
    from dpcx_torch.config import load_config
    from dpcx_torch.data.dataset import load_or_make
    from dpcx_torch.geometry.quaternion import quaternion_to_matrix
    from dpcx_torch.render import fused, gauss

    renders_of = {"car_64_depth": 32, "chair_pred_pose": 256,
                  "multicat_128": 16}
    steps_of = {"car_64_depth": ("float32",),
                "chair_pred_pose": ("bfloat16",),
                "multicat_128": ("float32", "bfloat16")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ab_") as tmp:
        for label, path in (("car_64_depth", CONFIG),
                            ("chair_pred_pose", PRED_POSE),
                            ("multicat_128", MULTICAT)):
            cfg = load_config(path).validate()
            renders, n, vox = (renders_of[label], cfg.pc_num_points,
                               cfg.vox_size)
            wd, cam = cfg.proj_depth, cfg.predict_pose
            camera = (float(cfg.focal_length), float(cfg.camera_distance))
            radius = gauss.kernel_radius(
                max(cfg.pc_relative_sigma, cfg.pc_relative_sigma_end), vox,
                cfg.gauss_kernel_truncate)
            rng = np.random.default_rng(SEED)
            points = torch.from_numpy(np.ascontiguousarray(seeded_ndc(
                rng, renders, n).transpose(0, 2, 1))).to(DEVICE)
            quat = torch.from_numpy(rng.normal(size=(renders, 4)).astype(
                np.float32)).to(DEVICE)
            pw_uniform = torch.from_numpy(rng.uniform(
                0.0, 1.0, (renders, n)).astype(np.float32)).to(DEVICE)
            # dropout weights at keep-prob 0.1 drawn by numpy: the same
            # bits for either tree's wrapper
            pw = torch.from_numpy((np.random.default_rng(SEED + 3).uniform(
                size=(renders, n)) < 0.1).astype(np.float32) / np.float32(
                    0.1)).to(DEVICE)
            dsil, ddepth = (torch.from_numpy(rng.normal(
                size=(renders, vox, vox)).astype(np.float32)).to(DEVICE)
                for _ in range(2))
            ddepth = ddepth if wd else None
            sigma = torch.tensor(cfg.pc_relative_sigma * vox, device=DEVICE)
            rot = quaternion_to_matrix(quat).contiguous()
            taps = gauss.gauss_kernel_1d(sigma, radius).contiguous()
            cfg = cfg.replace(data_dir=str(Path(tmp) / label / "data"),
                              checkpoint_dir=str(Path(tmp) / label / "run"))
            ds = load_or_make(cfg, MODELS, seed=cfg.seed, device=DEVICE)
            for mode in ("float32", "bfloat16"):
                bf16 = mode == "bfloat16"

                def fwd():
                    return fused._launch_world_forward(
                        points, pw, rot, None, camera, taps, radius, vox, wd,
                        bf16)

                def bwd(grid):
                    return lambda: fused._launch_world_backward(
                        points, pw, rot, None, camera, taps, radius, grid,
                        dsil, ddepth, vox, wd, True, cam, bf16)

                launches = {"fwd": fwd, "bwd_saved_grid": bwd(fwd()[2])}
                if vox > 64:
                    launches["bwd_recompute"] = bwd(None)
                rec = {"tree": str(tree), "render": label, "mode": mode,
                       "renders": renders, "points": n, "vox": vox,
                       "radius": radius, "with_depth": wd,
                       "camera_grad": cam,
                       "bound_ms": {key: render_bound(
                           renders, n, vox, radius, wd, True, key == "bwd",
                           bf16) for key in ("fwd", "bwd")}}
                for key, fn in launches.items():
                    kernels = device_profile(
                        fn, f"{label} {key} {mode} {tree}",
                        names=RENDER_KERNELS + OLD_RENDER_KERNELS)
                    stages: dict[str, float] = {}
                    for name, us in kernels:
                        stage = stage_name(name)
                        stages[stage] = stages.get(stage, 0.0) + us
                    rec[f"{key}_device_us"] = sum(stages.values())
                    rec[f"{key}_stages_us"] = stages
                rec["outputs_sha"] = outputs_sha(fused, 3, vox, radius, wd,
                                                 bf16)
                rec["fwd_errors"] = {
                    label_w: fwd_errors(fused, points, quat, camera, vox,
                                        sigma, radius, w, wd, mode)
                    for label_w, w in (("dropout", pw),
                                       ("uniform", pw_uniform))}
                if mode in steps_of[label]:
                    rec.update(step_stats(
                        cfg.replace(pallas_acc_dtype=mode), ds))
                rec["card"] = card
                print(json.dumps(rec), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splat-times", metavar="TREE", type=Path,
                    help="time only K6, K7 and the rgb_splats step of the "
                         "checkout at TREE (see splat_times)")
    ap.add_argument("--render-times", metavar="TREE", type=Path,
                    help="time only the renderer kernels (K1-K5), through "
                         "the world launchers, which TREE must have, and the "
                         "car_64_depth, chair_pred_pose and multicat_128 "
                         "steps of the checkout at TREE (see render_times)")
    ap.add_argument("--parallel", metavar="WORLD", type=int,
                    help="phase 9g alone at WORLD ranks (NCCL where each "
                         "has a card), and the one-card path's own spread "
                         "(see parallel_only)")
    ap.add_argument("--parallel-rank", metavar="SPEC", type=Path,
                    help=argparse.SUPPRESS)  # phase 9g's ranks
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    if args.splat_times is not None:
        return splat_times(args.splat_times)
    if args.render_times is not None:
        return render_times(args.render_times)
    if args.parallel_rank is not None:
        return parallel_rank(args.parallel_rank)
    if args.parallel is not None:
        return parallel_only(args.parallel)

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
    framed = []
    for name, frame, spill, regs, smem in ptxas_report(
            _build.build_log().read_text()):
        print(f"build: ptxas {name}: {regs} registers, {smem} bytes shared "
              f"memory, {frame} bytes stack frame, {spill} bytes spilled",
              flush=True)
        if name.split("<")[0] in NO_FRAME_KERNELS and (frame or spill):
            framed.append(name)
    assert not framed, f"stack frame or spills in {framed}"
    # 1b. the training step's draw kernels vs their plain versions
    draw_errs = phase_draws()

    cfg = load_config(CONFIG).validate()
    assert cfg.renderer == "pallas" and cfg.proj_depth

    # 3h. the renderer (world clouds, the camera transform in the splat
    # stages) vs the plain version, both modes
    world_cases = phase_world(cfg, fused, gauss)
    # 3b. K6 and K7 vs their plain version
    aniso_cases = phase_aniso_kernel(aniso)
    aniso_bwd = phase_aniso_backward(aniso, aniso_cases)
    # 3d. K6 and K7 in bfloat16 mode vs their plain bfloat16 version
    aniso_bf16 = phase_aniso_bf16(aniso, aniso_bwd)
    # 3e. dpcx's init on the card against the CPU
    phase_init()
    # 3f. datagen on the card against the CPU
    phase_datagen_devices()
    # 3g. the RBF voxelizer on the card against the CPU
    phase_rbf()

    # 4. serve: the first path starts here, with every launch count at 0
    reset_counts()
    params = ModelPointCloud(cfg, device="cuda").state_dict()
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
            # 9e. eval and predict: the chair_pred_pose and car_64_depth
            # models on held-out sets
            phase_eval(cli, str(tmp / "chair_pred_pose.yaml"), car_path)
            # 9d. largecloud_pointshard: shard_points on one card
            phase_largecloud(cli, fused, tmp)
            # 9g. parallelism: two ranks on the card (DP car_64_depth,
            # largecloud_pointshard sharded, the sharded renderers)
            phase_parallel(cli, tmp, car_cfg, card)
            # 9f. the bench verb at dpcx's shapes through K1-K7
            phase_bench(cli, card)

            # 10. time
            draw_times = time_draws(draw_errs)
            world_timings, world_launch, plain_timings = {}, {}, {}
            for case in world_cases:
                pf_ms, pb_ms = time_plain(fused, case)
                plain_timings[case["name"], case["acc"]] = pf_ms, pb_ms
                for save in (True, False) if case["vox"] > 64 else (True,):
                    f_ms, b_ms, bwd = time_world(fused, case, save)
                    world_timings[case["name"], case["acc"], save] = (f_ms,
                                                                      b_ms)
                    world_launch[case["name"], case["acc"], save] = bwd
                    fwd, bwd_name = (("K3", "K4 + K5") if case["vox"] > 64
                                     else ("K1", "K2"))
                    print(f"time world {fwd}/{bwd_name} {case['acc']} "
                          f"{case['name']} ({case['points'].shape[0]} renders "
                          f"x {case['points'].shape[1]} points, D "
                          f"{case['vox']}{'' if save else ', recompute'}"
                          f"{', camera gradient' if case['cam'] else ''}): "
                          f"{fwd} through fused_project_world {f_ms:.4f} ms, "
                          f"{bwd_name} launch {b_ms:.4f} ms; plain forward "
                          f"{pf_ms:.4f} ms, plain backward {pb_ms:.4f} ms "
                          f"| {card}", flush=True)
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
        by_world = {(c["name"], c["acc"]): c for c in world_cases}

        def world_fwd(shape, acc):
            c = by_world[shape, acc]
            return lambda: fused.fused_project_world(
                c["points"], c["quat"], c["vox"], c["sigma"], c["radius"],
                point_weights=c["pw"], focal_length=c["camera"][0],
                camera_distance=c["camera"][1], with_depth=c["with_depth"],
                acc_dtype=acc)

        for shape in ("car_64_depth", "chair_pred_pose", "multicat_128"):
            device_profile(world_fwd(shape, "float32"),
                           f"{'K3' if shape == 'multicat_128' else 'K1'} "
                           f"{shape} (world clouds)")
        device_profile(world_launch["car_64_depth", "float32", True],
                       "K2 car_64_depth (world clouds, launch on saved "
                       "residuals)")
        device_profile(world_launch["chair_pred_pose", "float32", True],
                       "K2 chair_pred_pose (world clouds, camera gradient, "
                       "launch on saved residuals)")
        device_profile(world_launch["multicat_128", "float32", True],
                       "K4 + K5 multicat_128 (world clouds, launch on saved "
                       "residuals)")
        device_profile(world_launch["multicat_128", "float32", False],
                       "K4 + K5 multicat_128 (world clouds, recompute "
                       "launch)")
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
        device_profile(world_fwd("chair_pred_pose", "bfloat16"),
                       "K1 bf16 chair_pred_pose (world clouds)")
        device_profile(world_launch["chair_pred_pose", "bfloat16", True],
                       "K2 bf16 chair_pred_pose (world clouds, camera "
                       "gradient, launch on saved residuals)")
        device_profile(world_fwd("multicat_128", "bfloat16"),
                       "K3 bf16 multicat_128 (world clouds)")
        device_profile(world_launch["multicat_128", "bfloat16", True],
                       "K4 + K5 bf16 multicat_128 (world clouds, launch on "
                       "saved residuals)")
        device_profile(world_launch["multicat_128", "bfloat16", False],
                       "K4 + K5 bf16 multicat_128 (world clouds, recompute "
                       "launch)")
        for label, fn in pp_step_fns.items():
            step = device_profile(fn, f"train step chair_pred_pose {label}",
                                  runs=10, top=16, host_top=8)
            print_step_breakdown(step, f"chair_pred_pose {label}")
        profile_bench_calls()
        for name, d in draw_times.items():
            d["device_ms"] = sum(us for _, us in device_profile(
                d["fn"], f"{name} kernel {d['shape']}", check=False,
                top=1)) / 1e3
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
    world_note = ("world clouds in (fused_project_world, the main path): "
                  "the splat stages run the camera transform; ms: the "
                  "forward through fused_project_world, or the backward "
                  "launch alone; max_abs_err against the plain version "
                  "(pc_perspective_transform_t, then fused_project_plain); "
                  "plain_ms and bound_ms from grid coordinates, with no "
                  "transform")

    def world_row(shape, acc, backward):
        """(ms, plain ms, bound, bound_by, max abs err) of the world
        route at ``shape``'s render; the error the largest of the world
        checks of its kernel family and mode."""
        case = by_world[shape, acc]
        f_ms, b_ms = world_timings[shape, acc, True]
        pf_ms, pb_ms = plain_timings[shape, acc]
        bound_ms, bound_by = render_bound(
            case["points"].shape[0], case["points"].shape[1], case["vox"],
            case["radius"], case["with_depth"], True, backward,
            bf16=acc == "bfloat16")
        err = max(c["bwd_err" if backward else "fwd_err"]
                  for c in world_cases if c["acc"] == acc
                  and (c["vox"] > 64) == (case["vox"] > 64))
        return (b_ms if backward else f_ms, pb_ms if backward else pf_ms,
                bound_ms, bound_by, err)

    def entry(name, replaces, launches_, shape, backward, note=None):
        k_ms, p_ms, bound_ms, bound_by, err = world_row(shape, "float32",
                                                        backward)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "note": "; ".join(filter(None, (
                    note, world_note, plain_bwd_note if backward
                    else None)))}

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

    def bf16_entry(name, replaces, backward, shape, run_launches, note):
        k_ms, p_ms, bound_ms, bound_by, err = world_row(shape, "bfloat16",
                                                        backward)
        fam = fused.launch_family(by_world[shape, "bfloat16"]["vox"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": run_launches[
                    f"{fam}_render_bwd_bf16" if backward
                    else f"{fam}_render_bf16"],
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "note": "; ".join(filter(None, (
                    note, world_note,
                    plain_bwd_note if backward else None)))}

    def draw_entry(name, replaces):
        d = draw_times[name]
        return {"name": name, "route": "cuda",
                "source": "dpcx_torch/csrc/prng.cu", "replaces": replaces,
                "launches": launches[name], "max_abs_err": d["err"],
                "ms": d["ms"], "plain_ms": d["plain_ms"],
                "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                "library_ms": None,
                "note": (f"no Pallas kernel: dpcx's jax.random draw, "
                         f"compiled by XLA; ms and plain_ms at "
                         f"{d['shape']} between CUDA events around the call "
                         f"(the host's dispatch included), device time "
                         f"{d['device_ms'] * 1e3:.3f} us a launch "
                         f"(torch.profiler); launches from the car_64_depth "
                         f"cli train run; held bitwise to the plain "
                         f"version")}

    pp_note = ("bfloat16 operand mode; times and bound at the "
               "chair_pred_pose render (256 x 2048, D 32), launches from its "
               "bfloat16 cli train run")
    mc_note = ("bfloat16 operand mode; times and bound at the "
               "multicat_128_fused render (16 x 16000, D 128), launches "
               "from its bfloat16 cli train run")

    shared = ("K4 and K5 are one launch, dpcx_fused_render_world_bwd (the "
              "suffix form makes K4's Total the suffix after the downward "
              "walk); ms and bound_ms are that launch's")
    print(json.dumps({"kernels": [
        entry("fused_render", "dpcx/render/pallas_kernel.py:75",
              launches["fused_render"], "car_64_depth", False),
        entry("fused_render_bwd", "dpcx/render/pallas_kernel.py:254",
              launches["fused_render_bwd"], "car_64_depth", True),
        entry("blocked_render", "dpcx/render/pallas_blocked.py:289",
              mc_launches["blocked_render"], "multicat_128", False),
        entry("blocked_render_bwd:K4",
              "dpcx/render/pallas_blocked.py:376",
              mc_launches["blocked_render_bwd"], "multicat_128",
              True, shared),
        entry("blocked_render_bwd:K5",
              "dpcx/render/pallas_blocked.py:451",
              mc_launches["blocked_render_bwd"], "multicat_128",
              True, shared),
        splat_entry("aniso_render", "dpcx/render/pallas_gsplat.py:88", False),
        splat_entry("aniso_render_bwd", "dpcx/render/pallas_gsplat.py:187",
                    True),
        bf16_entry("fused_render:bf16", "dpcx/render/pallas_kernel.py:75",
                   False, "chair_pred_pose", pp_bf_launches, pp_note),
        bf16_entry("fused_render_bwd:bf16",
                   "dpcx/render/pallas_kernel.py:254", True,
                   "chair_pred_pose",
                   pp_bf_launches, pp_note),
        bf16_entry("blocked_render:bf16", "dpcx/render/pallas_blocked.py:289",
                   False, "multicat_128", mc_bf_launches, mc_note),
        bf16_entry("blocked_render_bwd:K4:bf16",
                   "dpcx/render/pallas_blocked.py:376", True, "multicat_128",
                   mc_bf_launches, f"{mc_note}; {shared}"),
        bf16_entry("blocked_render_bwd:K5:bf16",
                   "dpcx/render/pallas_blocked.py:451", True, "multicat_128",
                   mc_bf_launches, f"{mc_note}; {shared}"),
        splat_bf16_entry("aniso_render:bf16",
                         "dpcx/render/pallas_gsplat.py:88", False),
        splat_bf16_entry("aniso_render_bwd:bf16",
                         "dpcx/render/pallas_gsplat.py:187", True),
        draw_entry("dropout_weights", "dpcx/render/voxelize.py:54"),
        draw_entry("batch_draws", "dpcx/train.py:153"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
