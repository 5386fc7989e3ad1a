#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dpcx_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. build    — compile the CUDA kernels from dpcx_torch/csrc with nvcc.
2. kernel   — the fused splat->blur->DRC kernel (K1) against its plain
              PyTorch version on the card, at the car_64_depth training
              render shape (32 renders x 16000 points, D 64, with depth)
              and the chair_gt_pose one (64 x 8000, D 32, no depth).
3. backward — K2, the fused renderer's backward kernel, against autograd
              through the plain version for a random linear functional of
              sil and depth, at both shapes, with dropout weights.
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
              first-step gradients and the three losses.
8. train    — `cli train` on car_64_depth for 200 steps (finite losses,
              the last 20 below the first 20, one K1 and one K2 launch per
              step), a resumed run of 10 more steps from step 200, and
              chair_gt_pose with renderer: pallas for 20 steps.
9. time     — CUDA-event medians: K1 and K2 against their plain versions
              at both shapes; host-clock serve latency at batch 16 and the
              median car_64_depth training step.
10. profile — torch.profiler device time per kernel, per call, of K1, the
              scoring forward, the batch-16 ServingModel call and one
              car_64_depth training step, beside the host time per call
              and the share of it in which the card is idle.

Data and checkpoints go to a temporary directory that is removed at the
end; the car_64_depth run's metrics.jsonl is copied to chiprun_out/. The
last lines are the run's seconds, the card's name and power limit
(nvidia-smi), a JSON line describing each kernel, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
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
OUT_DIR = REPO / "chiprun_out"
KERNEL_ATOL = 1e-4  # atomics reorder the f32 splat sums from run to run
GRAD_RTOL = 1e-3  # K2 vs plain: of the largest plain gradient, same reason
LOSS_RTOL = 1e-4
TRAIN_RTOL = 1e-3  # kernel vs plain training: gradient L2 and losses
SEED = 0
DEVICE = "cuda"
TRAIN_STEPS, RESUME_STEPS, CHAIR_STEPS, MODELS = 200, 10, 20, 32
# the kernels of csrc/fused_render.cu, as torch.profiler names them
K1_STAGES = ("splat_kernel", "blur_yx_kernel", "zblur_drc_kernel")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


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


def phase_kernel(cfg, fused, gauss) -> tuple[float, list[dict]]:
    rng = np.random.default_rng(SEED)
    shapes = [
        ("car_64_depth", 32, cfg.pc_num_points, cfg.vox_size, True),
        ("chair_gt_pose", 64, 8000, 32, False),
    ]
    worst, cases = 0.0, []
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
        sil_k, dep_k = fused.fused_project_t(*args, **kw)
        sil_p, dep_p = fused.fused_project_reference(*args, **kw)
        torch.cuda.synchronize()
        assert sil_k.shape == (renders, vox, vox), sil_k.shape
        err = (sil_k - sil_p).abs().max().item()
        if with_depth:
            err = max(err, (dep_k - dep_p).abs().max().item())
        else:
            assert dep_k is None and dep_p is None
        print(f"kernel check {name}: {renders} renders x {n} points, "
              f"D {vox}, depth {with_depth}: max abs err {err:.3e} "
              f"(atol {KERNEL_ATOL}), mean sil {sil_k.mean().item():.4f}",
              flush=True)
        assert np.isfinite(err) and err <= KERNEL_ATOL, err
        worst = max(worst, err)
        cases.append(dict(name=name, args=args, kw=kw))
    return worst, cases


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


def phase_backward(cases, fused) -> tuple[float, list[dict]]:
    """K2 against autograd through the plain version, at K1's shapes,
    with dropout weights (keep-prob 0.1: weights 0 or 10)."""
    from dpcx_torch.render.voxelize import pc_point_dropout_weights

    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst, out = 0.0, []
    for case in cases:
        ndc, vox, sigma, radius = case["args"]
        with_depth = case["kw"]["with_depth"]
        pw = pc_point_dropout_weights(gen, ndc.shape[0], ndc.shape[2], 0.1)
        kw = dict(with_depth=with_depth)
        sil, depth = fused.fused_project_reference(ndc, vox, sigma, radius,
                                                   pw, **kw)
        dsil, ddepth = linear_functional(rng, sil, depth)
        g_k = render_grads(
            lambda x, w: fused.fused_project_t(x, vox, sigma, radius, w, **kw),
            ndc, pw, dsil, ddepth)
        g_p = render_grads(
            lambda x, w: fused.fused_project_reference(x, vox, sigma, radius,
                                                       w, **kw),
            ndc, pw, dsil, ddepth)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("d ndc", "d weights"), g_k, g_p):
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            print(f"backward check {case['name']} {name}: max abs err "
                  f"{err:.3e}, max |plain| {scale:.3e}, ratio "
                  f"{err / scale:.3e} (bound {GRAD_RTOL})", flush=True)
            assert np.isfinite(err) and scale > 0, (err, scale)
            assert err <= GRAD_RTOL * scale, (case["name"], name, err, scale)
            errs.append(err)
        worst = max(worst, *errs)
        out.append(dict(name=case["name"], ndc=ndc, pw=pw, vox=vox,
                        sigma=sigma, radius=radius, with_depth=with_depth,
                        dsil=dsil, ddepth=ddepth))
    return worst, out


def time_backward(fused, case):
    """CUDA-event ms of K2 alone (the launch on saved residuals) and of
    the plain version's backward (autograd on a retained graph), and the
    K2 launch itself for the profiler."""
    from dpcx_torch.render.gauss import gauss_kernel_1d

    ndc, pw, vox, radius = case["ndc"], case["pw"], case["vox"], case["radius"]
    wd = case["with_depth"]
    coords = ((ndc.flip(1) + 0.5) * vox - 0.5).contiguous()
    taps = gauss_kernel_1d(case["sigma"], radius).contiguous()
    _, _, grid = fused._launch_forward(coords, pw, taps, radius, vox, wd)
    def k2():
        fused._launch_backward(coords, pw, taps, radius, grid, case["dsil"],
                               case["ddepth"], vox, wd, True)

    k_ms = cuda_ms(k2)
    x = ndc.detach().requires_grad_()
    w = pw.detach().requires_grad_()
    sil, depth = fused.fused_project_reference(x, vox, case["sigma"], radius,
                                               w, with_depth=wd)
    loss = (sil * case["dsil"]).sum()
    if depth is not None:
        loss = loss + (depth * case["ddepth"]).sum()
    p_ms = cuda_ms(lambda: torch.autograd.grad(loss, (x, w),
                                               retain_graph=True))
    return k_ms, p_ms, k2


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
    """One synchronised car_64_depth training step per call, as `cli
    train` runs it (device-resident records, the step's batch and dropout
    generator)."""
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
# to; the first match wins, blur_yx_kernel (K1 and K2 both launch it once
# a step) is split half and half
STEP_LAYERS = (
    ("K2 (fused backward)", ("zblur_drc_bwd_kernel", "splat_bwd_kernel")),
    ("K1 (fused forward)", ("zblur_drc_kernel", "splat_kernel")),
    ("Adam (foreach)", ("multi_tensor_apply",)),
    ("GEMMs", ("gemm", "nvjet", "cutlass", "sm90_xmma")),
    ("convs", ("conv", "cudnn", "dgrad", "wgrad", "implicit")),
    ("copies, dtype casts, memsets", ("Memcpy", "Memset", "copy_kernel")),
)


def print_step_breakdown(kernels: list[tuple[str, float]]) -> None:
    """Device us per training step by layer, from device_profile's list."""
    total = sum(us for _, us in kernels)
    layers = {name: 0.0 for name, _ in STEP_LAYERS}
    layers["other (elementwise, reductions, indexing)"] = 0.0
    for key, us in kernels:
        if "blur_yx_kernel" in key:
            layers["K1 (fused forward)"] += us / 2
            layers["K2 (fused backward)"] += us / 2
            continue
        name = next((n for n, pieces in STEP_LAYERS
                     if any(p in key for p in pieces)),
                    "other (elementwise, reductions, indexing)")
        layers[name] += us
    for name, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        print(f"profile train step by layer: {us:9.1f} us {us / total:6.1%}"
              f"  {name}", flush=True)


def reset_counts(fused) -> None:
    for name in fused.LAUNCHES:
        fused.LAUNCHES[name] = 0


def read_losses(checkpoint_dir: Path) -> list[tuple[int, float]]:
    recs = [json.loads(line) for line in
            (checkpoint_dir / "metrics.jsonl").read_text().splitlines()]
    return [(r["step"], r["loss_total"]) for r in recs if "loss_total" in r]


def phase_datagen(cli, fused, cfg_path: str, num_models: int, label: str):
    """`cli datagen` with the launch counts set to 0 just before; every
    model's V GT views go through one K1 launch."""
    from dpcx_torch.config import load_config
    from dpcx_torch.data.dataset import load_or_make

    reset_counts(fused)
    t0 = time.perf_counter()
    cli.main(["datagen", "-f", cfg_path, "-n", str(num_models)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    assert launches == {"fused_render": num_models, "fused_render_bwd": 0}, \
        launches
    cfg = load_config(cfg_path)
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


def phase_parity(cfg, ds) -> None:
    """3 steps with renderer: pallas (K1 + K2) against 3 with renderer: xla
    (plain ops), same init, batches and dropout generator, float32."""
    from dpcx_torch.train import batch_at, create_state, step_generator
    from dpcx_torch.train import train_step

    runs = {}
    for renderer in ("pallas", "xla"):
        c = cfg.replace(renderer=renderer, compute_dtype="float32")
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
        runs[renderer] = losses, grads
        del state
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
    print(f"parity: first-step gradients, worst relative L2 {worst:.3e} "
          f"({worst_name}; bound {TRAIN_RTOL}); losses kernel {l_k} vs "
          f"plain {l_p}, worst rel {loss_rel:.3e} (bound {TRAIN_RTOL})",
          flush=True)
    assert worst <= TRAIN_RTOL, (worst_name, worst)
    assert loss_rel <= TRAIN_RTOL, loss_rel


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
    assert launches == {"fused_render": TRAIN_STEPS,
                        "fused_render_bwd": TRAIN_STEPS}, launches
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
    assert dict(fused.LAUNCHES) == {"fused_render": RESUME_STEPS,
                                    "fused_render_bwd": RESUME_STEPS}
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
    assert dict(fused.LAUNCHES) == {"fused_render": CHAIR_STEPS,
                                    "fused_render_bwd": CHAIR_STEPS}
    print(f"train chair_gt_pose (renderer pallas): {CHAIR_STEPS} steps, "
          f"loss_total {vals[0]:.6f} -> {vals[-1]:.6f}, launches "
          f"{fused.LAUNCHES}", flush=True)


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

    cfg = load_config(CONFIG).validate()
    assert cfg.renderer == "pallas" and cfg.proj_depth

    # 2. K1 vs plain version
    max_err, cases = phase_kernel(cfg, fused, gauss)
    # 3. K2 vs plain version
    bwd_err, bwd_cases = phase_backward(cases, fused)

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
        assert launches == {"fused_render": 1, "fused_render_bwd": 0}, \
            launches
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

            # 9. time
            timings = {}
            for case in cases:
                args, kw = case["args"], case["kw"]
                k_ms = cuda_ms(lambda: fused.fused_project_t(*args, **kw))
                p_ms = cuda_ms(
                    lambda: fused.fused_project_reference(*args, **kw))
                timings[case["name"]] = (k_ms, p_ms)
                print(f"time K1 {case['name']} ({args[0].shape[0]} renders x "
                      f"{args[0].shape[2]} points, D {args[1]}): kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms | {card}",
                      flush=True)
            bwd_timings, k2_car = {}, None
            for case in bwd_cases:
                k_ms, p_ms, k2 = time_backward(fused, case)
                bwd_timings[case["name"]] = k_ms, p_ms
                k2_car = k2_car or k2
                print(f"time K2 {case['name']} ({case['ndc'].shape[0]} "
                      f"renders x {case['ndc'].shape[2]} points, D "
                      f"{case['vox']}): kernel {k_ms:.4f} ms, plain backward "
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

        # 10. profile
        print(f"profile on {card}", flush=True)
        car = cases[0]
        device_profile(
            lambda: fused.fused_project_t(*car["args"], **car["kw"]),
            f"K1 {car['name']}",
        )
        device_profile(k2_car, "K2 car_64_depth (launch on saved residuals)")
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
        print_step_breakdown(step)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)

    k_ms, p_ms = timings["car_64_depth"]
    kb_ms, pb_ms = bwd_timings["car_64_depth"]
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s, build included",
          flush=True)
    print(card)
    source = "dpcx_torch/csrc/fused_render.cu"
    print(json.dumps({"kernels": [
        {"name": "fused_render", "route": "cuda", "source": source,
         "replaces": "dpcx/render/pallas_kernel.py:75",
         "launches": launches["fused_render"], "max_abs_err": max_err,
         "ms": k_ms, "plain_ms": p_ms},
        {"name": "fused_render_bwd", "route": "cuda", "source": source,
         "replaces": "dpcx/render/pallas_kernel.py:254",
         "launches": launches["fused_render_bwd"], "max_abs_err": bwd_err,
         "ms": kb_ms, "plain_ms": pb_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
