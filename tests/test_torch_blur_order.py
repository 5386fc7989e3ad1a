"""The sum order of the renderer's register-blocked blur passes, on the CPU.

``csrc/fused_render.cu::blur_run`` gives a thread a run of 8 consecutive
outputs of one line (a row, a column or a z column of the grid). It walks
the line's inputs in chunks of 8 aligned to a multiple of 8, each with the
15 taps the chunk meets; an input past the grid is 0, and a tap past the
window is a padded 0. The one-tap loops it replaced summed only the
in-range taps. The two orders agree bit for bit because a zero product
leaves a sum as it was and both add each output's taps in ascending order.
K5's bfloat16 z transpose also splits each sum at multiples of the z-block
(dpcx's Dz), rounds each part and adds the parts in f32.

Both orders are written out here in torch, over many lines at once, and
held against each other bit for bit: in the bfloat16 mode (rounded inputs
and taps, whose products are exact in f32, so a multiply and an add give
the kernel's FMA) and in float32 with a multiply and an add in both. The
bfloat16 z pass and z transpose are also held against the plain version
(``render/fused.py``: ``_blur`` along z, ``_zblock_transpose``): the
z pass within 1e-5 of the largest plain value (another f32 sum order),
the transpose within chip_smoke.py's gradient limits, 2^-8 of the largest
and 1e-3 in relative L2 (a rounded partial can flip where two f32 sums in
other orders straddle a bfloat16 boundary).

At D <= 64 (K1/K2), and in float32 above D 64 (K3, K4 + K5), the kernels
once fused the z-blur into the per-ray DRC walks (``zblur_drc_kernel``
formed each z-blurred value from its 2R + 1 neighbours,
``zblur_drc_bwd_kernel`` re-formed them, walked the suffix and wrote the z
transpose from per-thread arrays) after the y/x passes. They now run a z
pass (``blur_z_kernel``) and walk the stored, fully blurred grid, and the
backward runs the DRC backward (``drc_bwd_kernel``; above D 64
``drc_bwd_tile_kernel``, the same arithmetic in the same order) and then
the z transpose as a z pass of dL/do with the taps reversed (dpcx's taps
are symmetric). Both routes are written out whole, over every ray of a
grid, and held against each other bit for bit: sil, depth and the
cotangent grid after the three transposes, in both operand modes at
D <= 64 (bfloat16: y, then x, then z) and in float32 above.
"""

import numpy as np
import pytest
import torch

from dpcx_torch.render import fused
from dpcx_torch.render.gauss import blur_matrix, gauss_kernel_1d
from torch_workers import share_cores

share_cores()

RUN = 8  # outputs a thread forms (fused_render.cu kRun)
BF16_FWD_SHARE, BF16_SHARE, BF16_GRAD_L2 = 1e-5, 2.0**-8, 1e-3


def one_tap_order(c, k, radius, zb=None):
    """The one-tap loops: out[:, z] sums c[:, z + t] k[t + R] over the
    in-range t in ascending order; with ``zb`` (the parent's z transpose)
    per z-block of the input, each part rounded, tap index z - i + R."""
    L, d = c.shape
    out = torch.zeros_like(c)
    for z in range(d):
        lo, hi = max(z - radius, 0), min(z + radius, d - 1)
        s = torch.zeros(L)
        if zb is None:
            for i in range(lo, hi + 1):
                s = s + c[:, i] * k[i - z + radius]
        else:
            for b0 in range(lo // zb * zb, hi + 1, zb):
                part = torch.zeros(L)
                for i in range(max(lo, b0), min(hi, b0 + zb - 1) + 1):
                    part = part + c[:, i] * k[z - i + radius]
                s = s + fused._rnd(part)
        out[:, z] = s
    return out


def run_order(c, k, radius, zb=None, flip=False):
    """blur_run: runs of RUN outputs, inputs in aligned chunks of RUN with
    zeros past the grid, taps staged between 2 RUN zeros each side (with
    ``zb``: reversed, and the parts flushed at multiples of zb; ``flip``:
    reversed, the transpose's tap(z - i))."""
    L, d = c.shape
    n = 2 * radius + 1
    pad = torch.zeros(2 * RUN)
    ks = torch.cat([pad, k.flip(0) if flip or zb is not None else k, pad])
    out = torch.zeros_like(c)
    for z0 in range(0, d, RUN):
        acc = [torch.zeros(L) for _ in range(RUN)]
        res = [torch.zeros(L) for _ in range(RUN)]
        lo = max(z0 - radius, 0) & ~(RUN - 1)
        hi = min(z0 + RUN - 1 + radius, d - 1)
        for ic in range(lo, hi + 1, RUN):
            if zb is not None and ic % zb == 0:
                res = [r + fused._rnd(a) for r, a in zip(res, acc)]
                acc = [torch.zeros(L) for _ in range(RUN)]
            cc = [c[:, ic + m] if ic + m < d else torch.zeros(L)
                  for m in range(RUN)]
            base = 2 * RUN + radius + ic - z0 - (RUN - 1)
            kk = ks[base:base + 2 * RUN - 1]
            assert base >= 0 and base + 2 * RUN - 1 <= n + 4 * RUN
            for m in range(RUN):
                for j in range(RUN):
                    acc[j] = acc[j] + cc[m] * kk[m - j + RUN - 1]
        for j in range(RUN):
            if z0 + j < d:
                out[:, z0 + j] = (res[j] + fused._rnd(acc[j])
                                  if zb is not None else acc[j])
    return out


def _lines(d, count, seed, sparse=True):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(count, d)) * (rng.random((count, d)) < 0.3
                                       if sparse else 1.0)
    return torch.tensor(c, dtype=torch.float32)


@pytest.mark.parametrize("d,radius", [(72, 9), (72, 71), (128, 16),
                                      (100, 30), (65, 3)])
def test_runs_sum_as_the_one_tap_loop_f32(d, radius):
    """float32, multiply then add in both orders: bit for bit."""
    c = _lines(d, 48, d + radius)
    k = gauss_kernel_1d(torch.tensor(0.05 * d), radius)
    assert torch.equal(run_order(c, k, radius), one_tap_order(c, k, radius))


@pytest.mark.parametrize("d,radius,blocks", [(72, 9, False), (72, 9, True),
                                             (72, 71, True), (80, 10, True),
                                             (128, 16, False),
                                             (128, 16, True)])
def test_runs_sum_as_the_one_tap_loop_bf16(d, radius, blocks):
    """bfloat16 (rounded inputs and taps): the z pass, and the z transpose
    with its rounded per-block partials, bit for bit."""
    c = fused._rnd(_lines(d, 48, d + radius + 1))
    k = fused._rnd(gauss_kernel_1d(torch.tensor(0.05 * d), radius))
    zb = fused.blocked_dz(d) if blocks else None
    assert torch.equal(run_order(c, k, radius, zb),
                       one_tap_order(c, k, radius, zb))


@pytest.mark.parametrize("d,radius", [(72, 9), (96, 12), (128, 16)])
def test_runs_match_the_plain_z_pass_and_transpose(d, radius):
    """The bfloat16 z pass and z transpose in run order against the plain
    version's, on the z columns of a [1, D, 2, 8] grid."""
    rng = np.random.default_rng(d)
    g = torch.tensor(rng.normal(size=(1, d, 2, 8)), dtype=torch.float32)
    sigma = torch.tensor(0.05 * d)
    K = fused._rnd(blur_matrix(sigma, d, radius).float())
    k = fused._rnd(gauss_kernel_1d(sigma, radius))
    lines = fused._rnd(g).permute(0, 2, 3, 1).reshape(-1, d)

    def as_grid(out):
        return out.reshape(1, 2, 8, d).permute(0, 3, 1, 2)

    z_plain = fused._blur(g, K, "z", fused._rnd)
    z_runs = as_grid(run_order(lines, k, radius))
    peak = z_plain.abs().max().item()
    assert (z_runs - z_plain).abs().max().item() <= BF16_FWD_SHARE * peak
    zb = fused.blocked_dz(d)
    t_plain = fused._zblock_transpose(g, K, zb, radius)
    t_runs = as_grid(run_order(lines, k, radius, zb))
    peak = t_plain.abs().max().item()
    assert (t_runs - t_plain).abs().max().item() <= BF16_SHARE * peak
    rel = (torch.linalg.vector_norm(t_runs - t_plain)
           / torch.linalg.vector_norm(t_plain)).item()
    assert rel <= BF16_GRAD_L2


# K1/K2 at D <= 64: the parent's fused walks against the split route


def _along(fn, g, axis):
    """fn over the lines of grid g [R, Z, Y, X] along ``axis`` (1 z, 2 y,
    3 x)."""
    moved = g.movedim(axis, -1)
    return fn(moved.reshape(-1, g.shape[axis])).reshape(moved.shape) \
        .movedim(-1, axis)


def _yx(g, k, radius, bf16, blur):
    """The y/x pass in the mode's order with ``blur`` (one_tap_order or
    run_order): float32 x then y; bfloat16 y then x, the staged slab and the
    first pass's outputs rounded."""
    def one(t):
        return blur(t, k, radius)

    if bf16:
        return _along(one, fused._rnd(_along(one, fused._rnd(g), 2)), 3)
    return _along(one, _along(one, g, 3), 2)


def _walk(o):
    """The DRC walk of zblur_drc_kernel over rays [L, D] of z-blurred
    occupancy -> (sil, depth)."""
    L, d = o.shape
    trans, s, dep = torch.ones(L), torch.zeros(L), torch.zeros(L)
    for z in range(d):
        oc = o[:, z].clamp(0.0, 1.0 - 1e-5)
        p = oc * trans
        s = s + p
        dep = dep + ((z + 0.5) / d - 0.5) * p
        trans = trans * (1.0 - oc)
    return s, dep + trans


def _drc_bwd(o, gs, gd):
    """The DRC backward's suffix form over rays [L, D] -> dL/do [L, D],
    zero where the forward clipped."""
    L, d = o.shape
    top = torch.tensor(1.0 - 1e-5, dtype=torch.float32)
    tr, trans = [], torch.ones(L)
    for z in range(d):
        tr.append(trans)
        trans = trans * (1.0 - o[:, z].clamp(0.0, top))
    out, suffix = torch.zeros(L, d), gd * 1.0
    for z in range(d - 1, -1, -1):
        raw = o[:, z]
        oc = raw.clamp(0.0, top)
        phi = gs + gd * ((z + 0.5) / d - 0.5)
        out[:, z] = torch.where(raw < top, tr[z] * (phi - suffix), 0.0)
        suffix = oc * phi + (1.0 - oc) * suffix
    return out


def _rays(g):
    """[R, Z, Y, X] -> the rays [R Y X, Z]."""
    return g.permute(0, 2, 3, 1).reshape(-1, g.shape[1])


def _grid(rays, g):
    R, d = g.shape[0], g.shape[1]
    return rays.reshape(R, d, d, d).permute(0, 3, 1, 2)


def parent_route(g, k, radius, bf16, gs, gd):
    """The fused walks: at D <= 64 blur_yx_kernel, zblur_drc_kernel<bf16,
    true>, then zblur_drc_bwd_kernel<64, bf16> (one-tap z-blur of the
    y/x-blurred grid, inputs rounded in bf16; dL/do rounded before its
    one-tap z transpose) and blur_yx_kernel on dgrid; in float32 above D 64
    the same with blur_slab_kernel<false, false> (whose sums are the
    one-tap loops'), zblur_drc_kernel<true> and zblur_drc_bwd_kernel."""
    rnd = fused._rnd if bf16 else (lambda t: t)
    yx = _yx(g, k, radius, bf16, one_tap_order)
    o = one_tap_order(_rays(rnd(yx)), k, radius)
    sil, depth = _walk(o)
    dodz = rnd(_drc_bwd(o, gs, gd))
    dgrid = _grid(one_tap_order(dodz, k, radius), g)
    return sil, depth, _yx(dgrid, k, radius, bf16, one_tap_order)


def split_route(g, k, radius, bf16, gs, gd):
    """blur_slab_kernel<bf16, bf16>, blur_z_kernel<false, bf16, false> in
    place (the staged tile rounded in bf16), zblur_drc_kernel on the stored
    grid; then drc_bwd_kernel (drc_bwd_tile_kernel above D 64),
    blur_z_kernel<true, bf16, false> (dL/do rounded as it is staged, taps
    reversed) and blur_slab_kernel on dgrid. Also returns the stored
    grid."""
    rnd = fused._rnd if bf16 else (lambda t: t)
    yx = _yx(g, k, radius, bf16, run_order)
    full = _grid(run_order(_rays(rnd(yx)), k, radius), g)  # stored
    sil, depth = _walk(_rays(full))
    dodz = _drc_bwd(_rays(full), gs, gd)
    dgrid = _grid(run_order(rnd(dodz), k, radius, flip=True), g)
    return sil, depth, _yx(dgrid, k, radius, bf16, run_order), full


def _hold_routes(d, radius, bf16, R):
    """split_route against parent_route on R seeded grids, bit for bit."""
    rng = np.random.default_rng(d * 64 + radius)
    # sparse occupancy with dense clumps: some rays saturate and clip
    g = rng.exponential(4.0, size=(R, d, d, d)) * (
        rng.random((R, d, d, d)) < 0.25)
    g = torch.tensor(g, dtype=torch.float32)
    gs = torch.tensor(rng.normal(size=R * d * d), dtype=torch.float32)
    gd = torch.tensor(rng.normal(size=R * d * d), dtype=torch.float32)
    k = gauss_kernel_1d(torch.tensor(0.05 * d + 0.1 * radius), radius)
    assert torch.equal(k, k.flip(0))  # the transpose's reversed taps
    if bf16:
        k = fused._rnd(k)
    want = parent_route(g, k, radius, bf16, gs, gd)
    *got, full = split_route(g, k, radius, bf16, gs, gd)
    clipped = (full >= 1.0 - 1e-5).float().mean().item()
    assert 0.0 < clipped < 1.0  # the walks clip some cells and not others
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("d,radius", [(8, 7), (20, 1), (20, 3), (20, 19),
                                      (24, 5), (24, 23), (32, 6), (32, 31),
                                      (64, 8), (64, 63)])
def test_split_route_is_the_fused_walks(d, radius, bf16):
    """K1/K2 at D <= 64: the new route (y/x pass, z pass, walks on the
    stored grid, z transpose of dL/do) against the fused walks and one-tap
    loops it replaced, bit for bit: sil, depth and the cotangent grid."""
    _hold_routes(d, radius, bf16, 2)


@pytest.mark.parametrize("d,radius,renders", [(72, 5, 2), (72, 71, 2),
                                              (128, 16, 1)])
def test_split_route_is_the_fused_walks_above_d64(d, radius, renders):
    """K3 and K4 + K5 in float32 above D 64: the same route (the DRC
    backward there is drc_bwd_tile_kernel) against the fused walks that
    float32 kept there before, bit for bit: sil, depth and the cotangent
    grid."""
    _hold_routes(d, radius, False, renders)
