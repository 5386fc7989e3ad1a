"""Renderer benchmark on one CUDA card (port of the root ``bench.py``),
and the H100 bounds of the renderer's kernels.

    python -m dpcx_torch.cli bench               # the card (the default)
    python -m dpcx_torch.cli bench --device cpu  # plain versions, tiny

Prints ONE JSON line: dpcx's keys (``metric``, ``value``, ``unit``, and
on the card ``fp32_value``, ``b16_value``, ``fwdbwd_value``,
``d128_value``, ``d128_fwdbwd_value``, ``gsplat_fwdbwd_value``,
``gsplat_dense_fwdbwd_value``, ``gsplat_pallas_fwdbwd_value``,
``gsplat_pallas_d64_fwdbwd_value``, ``parity``, ``parity_ok``) at dpcx's
shapes, and beside each value ``<key>_host`` (Mpoints/s from the host
clock's median over the same calls), ``<key>_ms`` (ms a call: CUDA
events on the card, the host clock on the CPU),
``<key>_bound`` (the least time the card could take for the kernels'
work, ``render_bound`` / ``aniso_bound``, as Mpoints/s; null for the
eager windowed and dense splats), ``<key>_share`` (value over bound, on
the card), ``<key>_bound_by``, ``<key>_launches`` (the kernel launches of
the key's run, warm-up included) and, on the card, ``<key>_peak_gib``.

- On the card each value is Mpoints/s from the best of 3 CUDA-event
  times of a loop of calls (``utils.timing.scan_times``, after an untimed
  run that builds the kernels), never from the host clock.
- The headline is bfloat16 operands at B 48, N 16384, D 64 (the flagship
  training step's render batch), ``renderer: pallas`` (K1/K2's bf16
  mode); ``d128_*`` run K3-K5's bf16 mode at B 16, N 16000, D 128; the
  ``gsplat_*`` keys the anisotropic splats at the rgb_splats shapes (B 8,
  N 4096, D 32, f32), forward and backward into points, scales and
  opacity, ``gsplat_pallas_d64_*`` K6/K7's bf16 mode at D 64.
- ``parity``: in both operand modes, the kernels (``renderer: pallas``)
  against the eager scatter (``renderer: xla``) at the headline shape,
  held to dpcx's loose bench tolerances ``SIL_TOL`` / ``GRAD_TOL``.
- Inputs are drawn with numpy from fixed seeds, not with ``jax.random``:
  values compare across runs of the port, not with dpcx's numbers.
- A key that raises is recorded as ``<key>: null`` and ``<key>_error``,
  and the run goes on; the command exits 1 when any key erred or
  ``parity_ok`` is false.
- ``--device cpu`` runs dpcx's CPU shapes (B 2, N 256, 3 iterations): the
  headline and parity, through the plain versions. ``cuda`` is the
  default; without a card it raises.

Left out, as TPU-only: dpcx's ``roofline`` (v5e arithmetic; the H100
bounds below take its place), ``KERNEL_SHARE_B48``, the health probe
(``health_mpts``, ``degraded``, ``bench_health.json``) and
``vs_baseline`` (a v5e target).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import traceback

import numpy as np
import torch

from dpcx_torch.config import Config
from dpcx_torch.geometry.quaternion import quaternion_multiply
from dpcx_torch.render import aniso, fused
from dpcx_torch.render.gauss import kernel_radius
from dpcx_torch.render.gsplat import gsplat_project, splat_params
from dpcx_torch.render.project import pointcloud_project_fn
from dpcx_torch.render.transform import pc_perspective_transform
from dpcx_torch.utils.timing import (
    ScanTimes,
    render_scan_times,
    scan_times,
)

# one H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores,
# and device memory
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
    images alone: the grid the kernels keep for the backward is their
    choice, not the function's. The backward takes the lesser of two ways
    to it: reading the fully blurred grid the forward saves (its bytes,
    then the three blur transposes), or recomputing it (the splat and three
    blur passes again, no grid bytes). In f32 every operation counts at
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
    # DRC backward, the z, y and x transposes, splat backward; on the read
    # grid, or with the splat and the three blur passes redone
    mm_ops = 3 * blur_pass + SPLAT_BWD_OPS * pts
    f32_ops = (DRC_BWD_OPS + depth_ops) * cells
    nbytes = 2 * point_bytes + taps_bytes + image_bytes
    return min(least(mm_ops, f32_ops, nbytes + 4 * cells),
               least(mm_ops + SPLAT_OPS * pts + 3 * blur_pass, f32_ops,
                     nbytes))


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


# csrc/prng.cu's draws are integer work, counted per element: the key
# schedule is the launch's (k0 ^ k1 ^ 0x1BD11BDA and each injection's
# k + i are host-side constants). A threefry2x32 word is 20 rounds of add,
# funnel shift and xor (60), the counter's add, the five x1 injections and
# the last x0 one (the other four fold into the next round's add as one
# IADD3), and the final x0 ^ x1: 68 operations, of which the 20 shifts and
# 21 xors (41) issue on the ALU pipe alone. The uniform adds a shift and an
# or (ALU) and the f32 subtract; a dropout weight its compare and select;
# the batch draws' rank sort 3 a pair of views (two compares and the add).
# The H100's ALU pipe has 64 lanes an SM (PEAK_F32_FLOPS / 4 operations a
# second: PEAK_F32_FLOPS counts 128 FMA lanes x 2), and an SM issues at
# most one warp instruction a clock to each of its four quarters, 128
# lanes (PEAK_F32_FLOPS / 2: the dispatch rate), adds on the FMA pipe as
# IMAD too
THREEFRY_OPS, THREEFRY_ALU_OPS = 68, 41
UNIFORM_OPS, UNIFORM_ALU_OPS = 3, 2
DROPOUT_OPS, RANK_OPS = 2, 3
PEAK_ALU_OPS, PEAK_DISPATCH_OPS = PEAK_F32_FLOPS / 4, PEAK_F32_FLOPS / 2


def draw_bound(kind: str, batch: int, n: int, views_use: int = 0,
               with_in2: bool = False) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of one draw launch of
    csrc/prng.cu: "dropout_weights" of [batch, n] (4 bytes written an
    element), or "batch_draws" of ``batch`` rows over n views (2 +
    ``views_use`` int64 written a row; the randint words of m and v_in,
    and of v_in2 ``with_in2``, the row's n uniforms and the n x n pairs of
    its rank sort; the randint's modular combine is not counted). The
    operations' time is the larger of the ALU-only ones over PEAK_ALU_OPS
    and all of them over PEAK_DISPATCH_OPS."""
    if kind == "dropout_weights":
        alu = batch * n * (THREEFRY_ALU_OPS + UNIFORM_ALU_OPS)
        ops = batch * n * (THREEFRY_OPS + UNIFORM_OPS + DROPOUT_OPS)
        nbytes = batch * n * 4
    else:
        words = 4 + (2 if with_in2 else 0) + n
        alu = batch * (words * THREEFRY_ALU_OPS + n * UNIFORM_ALU_OPS)
        ops = batch * (words * THREEFRY_OPS + n * UNIFORM_OPS
                       + n * n * RANK_OPS)
        nbytes = batch * (2 + views_use) * 8
    t_ops = max(alu / PEAK_ALU_OPS, ops / PEAK_DISPATCH_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# tolerances of the kernels-against-eager parity gate, dpcx's (max abs
# error on the [0, 1] silhouette; relative L2 of the point gradients)
SIL_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
GRAD_TOL = {"float32": 2e-2, "bfloat16": 2e-1}
METRIC = "points_splatted_projected_per_sec_per_chip_64cubed"
# dpcx's value keys (bench.py::main), the headline first
KEYS = ("value", "fp32_value", "b16_value", "fwdbwd_value", "d128_value",
        "d128_fwdbwd_value", "gsplat_fwdbwd_value",
        "gsplat_dense_fwdbwd_value", "gsplat_pallas_fwdbwd_value",
        "gsplat_pallas_d64_fwdbwd_value")
GIB = 2.0**30


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes and iteration counts of one bench run."""

    renders: int = 48        # the headline's and fp32_value's render batch
    points: int = 16384
    iters: int = 100
    b16_renders: int = 16    # b16_value and fwdbwd_value
    d128: tuple[int, int] = (16, 16000)   # renders, points at D 128
    gsplat: tuple[int, int] = (8, 4096)   # renders, points of the splats
    extras: bool = True       # every key, not the headline alone


FULL = Shapes()
CPU = Shapes(renders=2, points=256, iters=3, extras=False)


@dataclasses.dataclass(frozen=True)
class Measured:
    """One key's times, its points a call and its bound (ms, by)."""

    times: ScanTimes
    points: int
    bound: tuple[float, str] | None


def _inputs(B: int, N: int, key: int = 0, device="cuda"):
    """Seeded points uniform in [-0.4, 0.4]^3 [B, N, 3] and unit camera
    quaternions [B, 4]."""
    rng = np.random.default_rng(key)
    pts = rng.uniform(-0.4, 0.4, (B, N, 3))
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    return (torch.tensor(pts, dtype=torch.float32, device=device),
            torch.tensor(quat, dtype=torch.float32, device=device))


def _sum_bounds(fwd: tuple[float, str], bwd: tuple[float, str]
                ) -> tuple[float, str]:
    return fwd[0] + bwd[0], max(fwd, bwd)[1]


def renderer_bound(cfg: Config, renders: int, n: int, backward: bool
                   ) -> tuple[float, str]:
    """render_bound of one call of the standard renderer at cfg (no point
    weights), forward or forward + backward."""
    D = cfg.vox_size
    radius = kernel_radius(max(cfg.pc_relative_sigma,
                               cfg.pc_relative_sigma_end),
                           D, cfg.gauss_kernel_truncate)
    bf16 = cfg.pallas_acc_dtype == "bfloat16"
    fwd = render_bound(renders, n, D, radius, cfg.proj_depth, False, False,
                       bf16)
    if not backward:
        return fwd
    return _sum_bounds(fwd, render_bound(renders, n, D, radius,
                                         cfg.proj_depth, False, True, bf16))


def measure(cfg, pts, quat, sigma, iters) -> Measured:
    """Forward throughput of the standard renderer."""
    return _measure_render(cfg, pts, quat, sigma, iters, backward=False)


def measure_bwd(cfg, pts, quat, sigma, iters) -> Measured:
    """fwd + backward throughput: grad of the silhouette sum wrt the
    points (the training path's render cost)."""
    return _measure_render(cfg, pts, quat, sigma, iters, backward=True)


def _measure_render(cfg, pts, quat, sigma, iters, backward) -> Measured:
    B, N = pts.shape[:2]
    times = render_scan_times(cfg, pts, quat, sigma, iters, backward)
    return Measured(times, B * N, renderer_bound(cfg, B, N, backward))


def gsplat_call(impl="windowed", vox=32, acc="float32", device="cuda",
                renders=8, n=4096):
    """BASELINE config 5's renderer as the gsplat keys run it: -> (cfg,
    body, operands), ``body(carry, *operands) -> (carry, probe)`` one
    forward of gsplat_project on seeded inputs and the gradient of its
    silhouette and colour sums into points, scales and opacity."""
    cfg = Config(
        vox_size=vox, pc_num_points=n, pc_rgb=True, pc_gauss=True,
        gauss_scale_min=0.005, gauss_scale_max=0.06,
        gsplat_impl=impl, pallas_acc_dtype=acc,
    )
    rng = np.random.default_rng(5)
    pts, quat = _inputs(renders, n, key=5, device=device)
    rot = rng.normal(size=(renders, n, 4))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    scales, rot, opac, rgb = (
        torch.tensor(a, dtype=torch.float32, device=device) for a in (
            rng.uniform(0.01, 0.05, (renders, n, 3)), rot,
            rng.uniform(size=(renders, n)), rng.uniform(size=(renders, n, 3))))

    def body(carry, p, s, o, q, r, cg):
        ins = [(p + carry * 1e-17).requires_grad_(),
               s.detach().requires_grad_(), o.detach().requires_grad_()]
        out = gsplat_project(cfg, ins[0], q, ins[1], r, ins[2], cg)
        gp, gs, go = torch.autograd.grad(out.silhouette.sum()
                                         + out.rgb.sum(), ins)
        return carry + 1e-17, gp.sum() + gs.sum() + go.sum()

    return cfg, body, (pts, scales, opac, quat, rot, rgb)


def measure_gsplat(iters=60, impl="windowed", vox=32, acc="float32",
                   device="cuda", renders=8, n=4096) -> Measured:
    """The splats' forward and backward throughput at the rgb_splats shapes
    (B 8, N 4096, D 32; the training cost). ``impl``: windowed, dense (the
    eager forms) or pallas (K6/K7; with vox 64 and acc bfloat16 their bf16
    mode at D 64)."""
    cfg, body, ops = gsplat_call(impl, vox, acc, device, renders, n)
    times = scan_times(body, torch.zeros((), device=device), ops, iters)
    bound = None
    if impl == "pallas":
        pts, scales, _, quat, rot, rgb = ops
        case = splat_case(cfg, pts, quat, scales, rot, rgb)
        bf16 = acc == "bfloat16"
        bound = _sum_bounds(aniso_bound(case, False, bf16),
                            aniso_bound(case, True, bf16))
    return Measured(times, renders * n, bound)


def splat_case(cfg: Config, pts, quat, scales, rot, rgb) -> dict:
    """aniso_bound's case for gsplat_project's K6/K7 call on these
    inputs: the point-cells in the z-ranges its chunk table gives."""
    B, N = pts.shape[:2]
    D = cfg.vox_size
    with torch.no_grad():
        ndc = pc_perspective_transform(
            pts, quat, focal_length=cfg.focal_length,
            camera_distance=cfg.camera_distance)
        rot_cam = quaternion_multiply(quat[:, None, :], rot)
        mu, _, _, rz = splat_params(ndc, scales, rot_cam, D)
        z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, D)
    return dict(renders=B, n=N, vox=D, rgb=rgb,
                point_cells=int((z_hi - z_lo).sum()) * D * D)


def parity(cfg_pallas: Config, pts, quat, sigma) -> dict:
    """The kernels (forward and backward) against the eager scatter at the
    same shapes, on this device: the silhouettes' max abs error and the
    point gradients' relative L2 of a squared error to seeded targets."""
    cfg_xla = cfg_pallas.replace(renderer="xla")
    tgt = torch.tensor(np.random.default_rng(9).uniform(
        size=(pts.shape[0],) + (cfg_pallas.vox_size,) * 2),
        dtype=torch.float32, device=pts.device)

    def sil(cfg):
        with torch.no_grad():
            return pointcloud_project_fn(cfg, pts, quat, sigma).silhouette

    def grad(cfg):
        p = pts.detach().requires_grad_()
        s = pointcloud_project_fn(cfg, p, quat, sigma).silhouette
        return torch.autograd.grad(torch.mean((s - tgt) ** 2), p)[0]

    sil_err = float((sil(cfg_pallas) - sil(cfg_xla)).abs().max())
    g_p, g_x = grad(cfg_pallas), grad(cfg_xla)
    grad_rel = float(torch.linalg.vector_norm(g_p - g_x)
                     / (torch.linalg.vector_norm(g_x) + 1e-12))
    mode = cfg_pallas.pallas_acc_dtype
    return {
        "sil_max_err": sil_err,
        "grad_rel_err": grad_rel,
        "ok": sil_err < SIL_TOL[mode] and grad_rel < GRAD_TOL[mode],
    }


def _launches() -> dict[str, int]:
    return {**fused.LAUNCHES, **aniso.LAUNCHES}


@contextlib.contextmanager
def _f32_products(device: torch.device):
    """TF32 off for the run (the eager paths' products and convolutions
    in f32, as dpcx's at HIGHEST precision); the settings restored."""
    if device.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def bench(device: torch.device, shapes: Shapes = FULL) -> dict:
    """The bench record at ``shapes`` on ``device`` (see the module)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA card and none is "
                           "available; --device cpu runs the plain "
                           "versions at dpcx's CPU shapes")
    D = 64
    B, N, iters = shapes.renders, shapes.points, shapes.iters
    pts, quat = _inputs(B, N, device=device)
    sigma = torch.tensor(0.02, device=device)

    def cfg(acc, vox=D, n=N):
        return Config(vox_size=vox, pc_num_points=n, renderer="pallas",
                      pallas_acc_dtype=acc, proj_depth=False)

    rec: dict = {"metric": METRIC, "unit": "Mpoints/s",
                 "device": (torch.cuda.get_device_name(device) if on_card
                            else "cpu")}

    def keyed(key, fn):
        # a key that fails (a build, an OOM) leaves the others standing;
        # its error is recorded and the run exits 1 at the end
        before = _launches()
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        try:
            m = fn()
        except Exception as e:  # noqa: BLE001 - recorded, exits 1
            traceback.print_exc(file=sys.stderr)
            rec[key] = None
            rec[key + "_error"] = f"{type(e).__name__}: {e}"[:200]
            if on_card:
                torch.cuda.empty_cache()
            return
        best = m.times.best
        rec[key] = m.points / best / 1e6
        rec[key + "_host"] = m.points / m.times.host_median / 1e6
        rec[key + "_ms"] = best * 1e3
        rec[key + "_bound"] = (None if m.bound is None
                               else m.points / (m.bound[0] * 1e-3) / 1e6)
        rec[key + "_share"] = (m.bound[0] * 1e-3 / best
                               if m.bound is not None and on_card else None)
        rec[key + "_bound_by"] = None if m.bound is None else m.bound[1]
        rec[key + "_launches"] = {k: v - before[k] for k, v in
                                  _launches().items() if v != before[k]}
        if on_card:
            rec[key + "_peak_gib"] = (torch.cuda.max_memory_allocated(device)
                                      / GIB)

    with _f32_products(device):
        keyed("value",
              lambda: measure(cfg("bfloat16"), pts, quat, sigma, iters))
        if shapes.extras:
            pts16, quat16 = _inputs(shapes.b16_renders, N, device=device)
            keyed("fp32_value",
                  lambda: measure(cfg("float32"), pts, quat, sigma, iters))
            keyed("b16_value", lambda: measure(
                cfg("bfloat16"), pts16, quat16, sigma, 150))
            keyed("fwdbwd_value", lambda: measure_bwd(
                cfg("bfloat16"), pts16, quat16, sigma, 100))
            b128, n128 = shapes.d128
            pts128, quat128 = _inputs(b128, n128, key=4, device=device)
            c128 = cfg("bfloat16", vox=128, n=n128)
            keyed("d128_value", lambda: measure(
                c128, pts128, quat128, sigma, 100))
            keyed("d128_fwdbwd_value", lambda: measure_bwd(
                c128, pts128, quat128, sigma, 60))
            gb, gn = shapes.gsplat
            for key, kw in (
                ("gsplat_fwdbwd_value", dict(impl="windowed")),
                ("gsplat_dense_fwdbwd_value", dict(impl="dense")),
                ("gsplat_pallas_fwdbwd_value", dict(impl="pallas")),
                ("gsplat_pallas_d64_fwdbwd_value",
                 dict(impl="pallas", vox=64, acc="bfloat16", iters=12)),
            ):
                keyed(key, lambda kw=kw: measure_gsplat(
                    device=device, renders=gb, n=gn, **kw))
        try:
            rec["parity"] = {mode: parity(cfg(mode), pts, quat, sigma)
                             for mode in ("float32", "bfloat16")}
            rec["parity_ok"] = all(v["ok"] for v in rec["parity"].values())
        except Exception as e:  # noqa: BLE001 - recorded, exits 1
            traceback.print_exc(file=sys.stderr)
            rec["parity_ok"] = False
            rec["parity_error"] = f"{type(e).__name__}: {e}"[:200]
    return rec


def failed(rec: dict) -> list[str]:
    """The keys that erred, and ``parity_ok`` where parity failed."""
    bad = [k for k in rec if k.endswith("_error")]
    return bad if rec.get("parity_ok") else bad + ["parity_ok"]


def main(device: str = "cuda") -> None:
    """Print the bench record at dpcx's shapes (the card's, or with
    ``device="cpu"`` its CPU ones) as one JSON line; exit 1 when a key
    erred or parity failed."""
    device = torch.device(device)
    rec = bench(device, FULL if device.type == "cuda" else CPU)
    print(json.dumps(rec), flush=True)
    if failed(rec):
        raise SystemExit(1)
