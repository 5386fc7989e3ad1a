"""Fused splat -> blur -> DRC renderer (port of
``dpcx/render/pallas_kernel.py::pallas_project_t``: the K1 forward and the
K2 backward for D <= 64, and the depth-blocked K3 forward and K4/K5
backward of ``dpcx/render/pallas_blocked.py`` for 64 < D <= 128).

One route reaches the card: ``fused_project_world`` takes world clouds
[C, N, 3] and cameras [R, 4] (R a multiple of C), and on CUDA tensors runs a
``torch.autograd.Function`` whose forward and backward launch the
hand-written CUDA kernels of ``csrc/fused_render.cu``; one kernel family
covers every D <= 128. Their splat stages run the camera transform of
``pc_perspective_transform_t`` and the NDC -> grid affine in registers,
forward and backward (the cameras' gradients included), so no [R, 3, N]
tensor and no batched 3x3 GEMM reaches the card. ``pointcloud_project_fn``
takes it. On CPU tensors it is that transform followed by
``fused_project_t``.

``fused_project_t`` takes NDC coordinates [R, 3, N] on CPU tensors and is
the plain version: ``fused_project_reference``, differentiated by
autograd, in float32 mode, and ``fused_project_plain`` in bfloat16 mode.
It refuses tensors on the card, where the kernels take world clouds. The
plain versions run on any device, and are the yardstick the kernels are
checked against on the card.

``save_grid`` mirrors ``pallas_project_t``'s: at D > 64 the forward keeps
its grid (8 MiB per render at 128^3) for the backward, or,
when False (``cfg.remat``), keeps only coords, weights and taps, and the
backward re-splats and re-blurs into fresh scratch first. At D <= 64 the
grid is always kept, as ``save_grid`` has no effect there in dpcx.

``acc_dtype`` "bfloat16" is the Pallas kernels' bfloat16 operand mode:
every value they type bfloat16 is rounded to nearest-even where they round
it, sums stay f32, and so does the grid in memory. The rounding points
differ with D. At D <= 64 they are K1/K2's: the blur runs y, x, z, its
transpose z, y, x, then dG is rounded. At D > 64 they are K3-K5's: the blur
runs z, x, y, its transpose x, y, then the banded z transpose of each
z-block of ``blocked_dz(D)`` rows, whose rounded partial sums add up to dG
(so a row in the halo of several blocks is not the rounding of its full
cotangent). The grid the forward saves is the fully blurred one, in either
mode at every D. Its plain version is
``fused_project_reference(..., acc_dtype="bfloat16")``
forward and ``fused_backward_reference`` backward, written out because
autograd through the rounded forward would round other quantities than the
kernels do; CPU tensors take them through ``fused_project_plain``. In
float32 mode ``fused_backward_reference`` is K2's function too, hat
derivative 0 at an exactly integer coordinate included, where autograd
through the plain forward is floor-based.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from dpcx_torch.geometry.quaternion import quaternion_to_matrix
from dpcx_torch.render.drc import drc_projection
from dpcx_torch.render.gauss import (
    blur_matrix,
    gauss_kernel_1d,
    smoothen_voxels3d,
)
from dpcx_torch.render.transform import (
    CAMERA_DISTANCE,
    FOCAL_LENGTH,
    pc_perspective_transform_t,
)
from dpcx_torch.render.voxelize import pointcloud2voxels_scatter
from dpcx_torch.utils.profiling import span

MAX_FUSED_VOX = 128  # the kernels' grid is D^3 f32 per render, D <= 128
BLOCKED_VOX = 64  # above this, dpcx runs the depth-blocked kernels K3-K5
ACC_DTYPES = ("float32", "bfloat16")

# kernel launches by name; counted only where a launch happens. D <= 64
# counts as fused_*, D > 64 as blocked_* (the K3-K5 counterparts); the
# bfloat16 mode adds _bf16. The recompute backward runs only at D > 64
# (_FusedWorldRender keeps the grid at D <= 64)
LAUNCHES: dict[str, int] = {
    "fused_render": 0,
    "fused_render_bwd": 0,
    "fused_render_bf16": 0,
    "fused_render_bwd_bf16": 0,
    "blocked_render": 0,
    "blocked_render_bwd": 0,
    "blocked_render_bwd_recompute": 0,
    "blocked_render_bf16": 0,
    "blocked_render_bwd_bf16": 0,
    "blocked_render_bwd_recompute_bf16": 0,
}


def launch_family(vox: int) -> str:
    """The launch counters' prefix at grid size ``vox``."""
    return "blocked" if vox > BLOCKED_VOX else "fused"


def _rnd(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest bfloat16 (ties to even), back to f32."""
    return x.to(torch.bfloat16).float()


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


def _corners(ndc_t: torch.Tensor, vox: int):
    """Per point and axis (rows z, y, x of [R, 3, N]): the low corner cell
    (floor of the grid coordinate) and the hats of dpcx's Pallas kernels,
    relu(1 - |g - c|), at the low and the high corner, and their
    derivatives (_dhat_t: 0 at an exactly integer coordinate)."""
    g = (ndc_t.flip(1) + 0.5) * vox - 0.5
    lo = torch.floor(g)
    t = g - lo
    hats = (1.0 - t, 1.0 - (t - 1.0).abs())
    off = (t != 0).float()
    dhats = (-off, off)
    return lo.to(torch.int64), hats, dhats


def _corner_index(lo, dz, dy, dx, vox):
    """Flat cell of corner (dz, dy, dx) in [R, D^3] and whether it lies in
    the grid, each [R, N]."""
    iz, iy, ix = lo[:, 0] + dz, lo[:, 1] + dy, lo[:, 2] + dx
    valid = ((iz >= 0) & (iz < vox) & (iy >= 0) & (iy < vox)
             & (ix >= 0) & (ix < vox))
    cell = ((iz.clamp(0, vox - 1) * vox + iy.clamp(0, vox - 1)) * vox
            + ix.clamp(0, vox - 1))
    return cell, valid


def _splat(ndc_t, vox, point_weights, rnd):
    """The trilinear splat [R, D, D, D] f32: a corner adds a h_x with a =
    rnd(rnd(h_z pw) rnd(h_y)), each h_x rounded too (``rnd``: ``_rnd``
    in bfloat16 mode, ``_keep`` in float32), summed in f32."""
    R, _, N = ndc_t.shape
    lo, hats, _ = _corners(ndc_t, vox)
    pw = (torch.ones(R, N, dtype=ndc_t.dtype, device=ndc_t.device)
          if point_weights is None else point_weights)
    grid = torch.zeros(R, vox**3, dtype=torch.float32, device=ndc_t.device)
    for dz in (0, 1):
        wzp = rnd(hats[dz][:, 0] * pw)  # (h_z pw) rounded once
        for dy in (0, 1):
            a = rnd(wzp * rnd(hats[dy][:, 1]))
            for dx in (0, 1):
                cell, valid = _corner_index(lo, dz, dy, dx, vox)
                w = torch.where(valid, a * rnd(hats[dx][:, 2]), 0.0)
                grid.scatter_add_(1, cell, w)
    return grid.reshape(R, vox, vox, vox)


# one blur pass along an axis of [R, z, y, x] (K is symmetric)
_PASS = {"z": "bzyx,zi->biyx", "y": "bzyx,yi->bzix", "x": "bzyx,xi->bzyi"}


def _blur(grid, K, axes: str, rnd):
    """Blur passes along ``axes`` in order, each pass's input rounded by
    ``rnd``; the output of the last pass is not rounded."""
    for axis in axes:
        grid = torch.einsum(_PASS[axis], rnd(grid), K)
    return grid


def blocked_mode(vox: int, acc_dtype: str) -> bool:
    """Whether the bfloat16 mode is K3-K5's (D > 64) rather than K1/K2's:
    they round at other points (the module docstring)."""
    return acc_dtype == "bfloat16" and vox > BLOCKED_VOX


def blocked_dz(vox: int) -> int:
    """The z-block of dpcx's depth-blocked kernels (``blocked_params``):
    the largest of 32, 16, 8 that divides D. K5's bfloat16 mode rounds the
    banded z transpose per z-block, so its function depends on it."""
    for dz in (32, 16, 8):
        if vox % dz == 0:
            return dz
    raise ValueError(
        f"the bfloat16 mode at vox_size {vox} > {BLOCKED_VOX} is the "
        f"depth-blocked kernels', which need vox_size % 8 == 0")


def _blurred(ndc_t, vox, sigma_vox, radius, point_weights, rnd, blocked):
    """The splat and the three blur passes, rounded by ``rnd``: y, x, z as
    K1 (``blocked`` False), or z, x, y as K3 (``blocked``) -> (the blurred
    grid [R, D, D, D] f32, the blur matrix K as rounded)."""
    K = rnd(blur_matrix(sigma_vox, vox, radius).float())
    grid = _splat(ndc_t, vox, point_weights, rnd)
    return _blur(grid, K, "zxy" if blocked else "yxz", rnd), K


def _zblock_transpose(dg, K, dz, radius):
    """K5's banded z transpose in bfloat16 mode: z-block k (rows [k dz,
    k dz + dz)) spreads its rounded rows over its raw rows [k dz - R,
    k dz + dz + R) with the rounded taps; each block's partial sums are
    rounded, and a raw row in several blocks' ranges sums their rounded
    partials in f32 (``_blocked_bwd_kernel`` writes each block's transpose
    into its own scratch, and its splat backward rounds what it reads)."""
    D = dg.shape[1]
    x = _rnd(dg)
    out = torch.zeros_like(dg)
    for z0 in range(0, D, dz):
        lo, hi = max(z0 - radius, 0), min(z0 + dz + radius, D)
        out[:, lo:hi] += _rnd(torch.einsum(
            "bzyx,zi->biyx", x[:, z0:z0 + dz], K[z0:z0 + dz, lo:hi]))
    return out


def fused_project_reference(
    ndc_t: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None = None,
    with_depth: bool = False,
    acc_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the kernel: scatter splat + separable blur
    + DRC. ndc_t [R, 3, N] (rows x, y, z_ndc) -> sil [R, D, D], depth.

    ``acc_dtype`` "bfloat16": the bfloat16 mode's forward, rounded where
    dpcx's K1 (``_fused_kernel``, D <= 64: splat, blur y, x, z) or K3
    (``_blocked_fwd_kernel``, D > 64: splat, blur z, x, y) rounds (the
    module docstring); differentiate it with ``fused_backward_reference``,
    not autograd.

    Its forward is the kernels' function. Its gradient, by autograd through
    the floor-based trilinear weights, is that of dpcx's XLA scatter
    (``dpcx/render/voxelize.py:72``), and so differs from the kernels' (and
    from the Pallas kernels', whose hat derivative is ``_dhat_t``) only at
    an exactly integer grid coordinate: there the floor-based derivative
    along that axis is one-sided (-v(c) + v(c + 1)) where the kernels give
    0."""
    if acc_dtype == "bfloat16":
        grid, _ = _blurred(ndc_t, vox_size, sigma_vox, kernel_radius,
                           point_weights, _rnd,
                           blocked_mode(vox_size, acc_dtype))
        return drc_projection(grid, with_depth=with_depth)
    grid = pointcloud2voxels_scatter(
        ndc_t.transpose(1, 2), vox_size, point_weights=point_weights
    )
    grid = smoothen_voxels3d(grid, sigma_vox, kernel_radius)
    return drc_projection(grid, with_depth=with_depth)


def fused_backward_reference(
    ndc_t: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None,
    with_depth: bool,
    dsil: torch.Tensor,
    ddepth: torch.Tensor | None,
    acc_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (and of K4 + K5): the cotangents dsil, ddepth
    [R, D, D] (ddepth None: zero) -> (d ndc_t [R, 3, N], d weights [R,
    N]). Float32 mode rounds nothing; bfloat16 mode rounds as below.

    As ``_fused_bwd_kernel`` (``dpcx/render/pallas_kernel.py:254``): the
    grid as the forward makes it; the DRC cotangent in f32 by Total minus
    prefix (summed from the back: like the kernel's suffix form, it avoids
    the subtraction), zero where the forward clipped; the blur transposes
    z, then y, then x, each input rounded; the splat backward with dG, h_y,
    h_x rounded, a = rnd(rnd(rnd(h_z) rnd(pw)) rnd(h_y)), v = sum_x dG h_x,
    P = sum_y v h_y, Q = sum_y v dh_y, t1 = sum_zy dG a, and h_z, dh_z, pw
    unrounded.

    In bfloat16 mode at D > 64, as ``_blocked_total_kernel`` and
    ``_blocked_bwd_kernel`` (``dpcx/render/pallas_blocked.py:376``,
    ``:451``): the grid in K3's order (``fused_project_reference``); the
    DRC cotangent as above; the blur transposes x, then y, each input
    rounded; then the banded z transpose per z-block (``_zblock_transpose``:
    each block's partial sums rounded, a raw row in several blocks' ranges
    the f32 sum of their rounded partials, which is dG, read unrounded);
    the splat backward rounds as K2's."""
    R, _, N = ndc_t.shape
    D = vox_size
    rnd = _rnd if acc_dtype == "bfloat16" else _keep
    blocked = blocked_mode(D, acc_dtype)
    o_raw, K = _blurred(ndc_t, D, sigma_vox, kernel_radius, point_weights,
                        rnd, blocked)
    top = 1.0 - 1e-5
    o = o_raw.clamp(0.0, top)
    one_minus = 1.0 - o
    trans = torch.cat([torch.ones_like(o[:, :1]),
                       torch.cumprod(one_minus, dim=1)[:, :-1]], dim=1)
    phi = dsil[:, None].expand_as(o)
    if with_depth and ddepth is not None:
        d_z = (torch.arange(D, dtype=torch.float32, device=o.device)
               + 0.5) / D - 0.5
        phi = phi + ddepth[:, None] * d_z[:, None, None]
    # Total minus prefix, summed from the back: the terms after z (and the
    # background's), which a subtraction would lose where a saturated ray
    # has taken almost all of Total before z
    terms = o * trans * phi
    after = torch.cat([terms.flip(1).cumsum(1).flip(1)[:, 1:],
                       torch.zeros_like(terms[:, :1])], dim=1)
    if with_depth and ddepth is not None:
        after = after + (ddepth * (trans[:, -1] * one_minus[:, -1]))[:, None]
    do = trans * phi - after / one_minus
    do = torch.where(o_raw < top, do, 0.0)
    # blur transposes (K is symmetric: each pass is its own transpose),
    # each input rounded: K2's z, y, x, then dG rounded; or K5's x, y, then
    # the z transpose per z-block, whose rounded partials sum to dG
    if blocked:
        dg = _zblock_transpose(_blur(do, K, "xy", rnd), K, blocked_dz(D),
                               kernel_radius)
    else:
        dg = rnd(_blur(do, K, "zyx", rnd))
    dg = dg.reshape(R, -1)

    lo, hats, dhats = _corners(ndc_t, D)
    pw = (torch.ones(R, N, dtype=ndc_t.dtype, device=ndc_t.device)
          if point_weights is None else point_weights)
    pw_r = rnd(pw)
    zero = torch.zeros(R, N, dtype=torch.float32, device=ndc_t.device)
    agz, agy, apw, t1 = zero, zero, zero, [zero, zero]
    for dz in (0, 1):
        hz, dhz = hats[dz][:, 0], dhats[dz][:, 0]
        hzp = rnd(rnd(hz) * pw_r)
        P = Q = zero
        for dy in (0, 1):
            hy, dhy = rnd(hats[dy][:, 1]), dhats[dy][:, 1]
            a = rnd(hzp * hy)
            v = zero
            for dx in (0, 1):
                cell, valid = _corner_index(lo, dz, dy, dx, D)
                g = torch.where(valid, torch.gather(dg, 1, cell), 0.0)
                v = v + g * rnd(hats[dx][:, 2])
                t1[dx] = t1[dx] + g * a
            P = P + v * hy
            Q = Q + v * dhy
        agz = agz + dhz * P
        agy = agy + hz * Q
        apw = apw + hz * P
    agx = t1[0] * dhats[0][:, 2] + t1[1] * dhats[1][:, 2]
    dcoords = torch.stack([agz * pw, agy * pw, agx], dim=1)  # rows z, y, x
    return D * dcoords.flip(1), apw


class _PlainRender(torch.autograd.Function):
    """The plain forward and the plain K2 backward written out (no gradient
    reaches sigma, as on the kernels)."""

    @staticmethod
    def forward(ctx, ndc_t, point_weights, sigma_vox, vox, radius,
                with_depth, acc_dtype):
        ctx.save_for_backward(ndc_t, point_weights, sigma_vox)
        ctx.vox, ctx.radius, ctx.with_depth = vox, radius, with_depth
        ctx.acc_dtype = acc_dtype
        ctx.set_materialize_grads(False)
        with span("render.fwd"):
            sil, depth = fused_project_reference(
                ndc_t, vox, sigma_vox, radius, point_weights, with_depth,
                acc_dtype=acc_dtype)
        return (sil, depth) if with_depth else sil

    @staticmethod
    @once_differentiable
    def backward(ctx, dsil, ddepth=None):
        ndc_t, point_weights, sigma_vox = ctx.saved_tensors
        if dsil is None:  # only the depth output reached the loss
            dsil = torch.zeros_like(ddepth)
        with span("render.bwd"):
            d_ndc, d_w = fused_backward_reference(
                ndc_t, ctx.vox, sigma_vox, ctx.radius, point_weights,
                ctx.with_depth, dsil, ddepth, ctx.acc_dtype)
        return (d_ndc, None if point_weights is None else d_w,
                None, None, None, None, None)


def fused_project_plain(
    ndc_t: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None = None,
    with_depth: bool = False,
    acc_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The plain version with K2's backward written out
    (``fused_backward_reference``), on any device: what CPU tensors take
    in bfloat16 mode, and what a kernel-vs-plain check on the card compares
    the kernels with in either mode."""
    sigma = torch.as_tensor(sigma_vox, dtype=torch.float32,
                            device=ndc_t.device)
    out = _PlainRender.apply(ndc_t, point_weights, sigma, vox_size,
                             kernel_radius, with_depth, acc_dtype)
    return out if with_depth else (out, None)


def _check_grid(vox_size, kernel_radius, acc_dtype) -> None:
    """The grid, blur and operand mode the kernels cover."""
    if acc_dtype not in ACC_DTYPES:
        raise ValueError(f"acc_dtype must be one of {ACC_DTYPES}, "
                         f"got {acc_dtype!r}")
    if not 1 <= vox_size <= MAX_FUSED_VOX:
        raise ValueError(
            f"fused renderer covers 1 <= vox_size <= {MAX_FUSED_VOX}, "
            f"got {vox_size}"
        )
    if not 0 <= kernel_radius < vox_size:
        raise ValueError(
            f"kernel_radius must be in [0, {vox_size}), got {kernel_radius}"
        )
    if blocked_mode(vox_size, acc_dtype):
        blocked_dz(vox_size)  # raises where dpcx's blocked kernels do


def _check_shape(name, t, shape) -> None:
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")


def _check_f32(device, **tensors) -> None:
    """The kernels read float32 on the card they run on."""
    for name, t in tensors.items():
        if t is not None and (t.device != device or t.dtype != torch.float32):
            raise ValueError(
                f"{name} must be float32 on {device}, "
                f"got {t.dtype} on {t.device}"
            )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _counted(name: str, err: int) -> None:
    """Raise on a launcher's CUDA error, else count the launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _bwd_name(vox: int, recompute: bool, bf16: bool) -> str:
    return (f"{launch_family(vox)}_render_bwd"
            + ("_recompute" if recompute else "") + ("_bf16" if bf16 else ""))


def _launch_world_forward(points, weights, rot, trans, camera, taps, radius,
                          vox, with_depth, bf16):
    """Forward (K1, or K3 at D > 64) from world clouds: points [C, N, 3],
    weights [C, N] or None, rot [R, 3, 3], trans [R, 3] or None, camera
    (focal length, camera distance); the splat stage projects each point
    through its render's camera in registers. -> (sil, depth or None, the
    fully blurred grid [R, D, D, D])."""
    from dpcx_torch import _build

    C, N, _ = points.shape
    R, D = rot.shape[0], vox
    dev = points.device
    grid = torch.empty((R, D, D, D), dtype=torch.float32, device=dev)
    sil = torch.empty((R, D, D), dtype=torch.float32, device=dev)
    depth = torch.empty_like(sil) if with_depth else None
    with torch.cuda.device(dev):
        err = _build.load().dpcx_fused_render_world(
            points.data_ptr(), _ptr(weights), rot.data_ptr(), _ptr(trans),
            *camera, R // C, taps.data_ptr(), radius, grid.data_ptr(),
            sil.data_ptr(), _ptr(depth), R, N, D, int(with_depth), int(bf16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _counted(f"{launch_family(vox)}_render" + ("_bf16" if bf16 else ""), err)
    return sil, depth, grid


def _launch_world_backward(points, weights, rot, trans, camera, taps, radius,
                           grid, dsil, ddepth, vox, with_depth,
                           want_dweights, want_camera, bf16):
    """Backward (K2, or K4 + K5 at D > 64) from world clouds, the inputs as
    ``_launch_world_forward``'s; ``grid`` the forward's, or None at
    D > 64: re-splat and re-blur first. -> (d points [C, N, 3], d weights
    [C, N] or None, d rot [R, 3, 3] and d trans [R, 3] (None without
    ``want_camera``; d trans None without trans))."""
    from dpcx_torch import _build

    C, N, _ = points.shape
    R, D = rot.shape[0], vox
    dev = points.device
    recompute = grid is None
    if recompute and vox <= BLOCKED_VOX:
        raise ValueError(
            f"the recompute backward runs only above D {BLOCKED_VOX} "
            f"(_FusedWorldRender keeps the grid below), got D {vox}")
    if recompute:
        grid = torch.empty((R, D, D, D), dtype=torch.float32, device=dev)
    dgrid = torch.empty_like(grid)
    dpoints = torch.empty_like(points)
    dweights = (torch.empty((C, N), dtype=torch.float32, device=dev)
                if want_dweights else None)
    drot = torch.empty_like(rot) if want_camera else None
    dtrans = (torch.empty_like(trans)
              if want_camera and trans is not None else None)
    with torch.cuda.device(dev):
        err = _build.load().dpcx_fused_render_world_bwd(
            points.data_ptr(), _ptr(weights), rot.data_ptr(), _ptr(trans),
            *camera, R // C, taps.data_ptr(), radius, grid.data_ptr(),
            int(recompute), dsil.data_ptr(), _ptr(ddepth), dgrid.data_ptr(),
            dpoints.data_ptr(), _ptr(dweights), _ptr(drot), _ptr(dtrans), R,
            N, D, int(with_depth), int(bf16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _counted(_bwd_name(vox, recompute, bf16), err)
    return dpoints, dweights, drot, dtrans


class _FusedWorldRender(torch.autograd.Function):
    """Kernel forward and backward from world clouds and their cameras
    (``fused_project_world``). Returns sil, or (sil, depth) with depth.
    Gradients reach the points, the weights, the rotations and the
    translations; none the taps (the blur sigma is a schedule, not a
    learned parameter), as the zero ``dkmat`` of ``_fused_bwd`` in
    ``dpcx/render/pallas_kernel.py``."""

    @staticmethod
    def forward(ctx, points, weights, rot, trans, camera, taps, radius, vox,
                with_depth, save_grid, bf16):
        with span("render.fwd"):
            sil, depth, grid = _launch_world_forward(
                points, weights, rot, trans, camera, taps, radius, vox,
                with_depth, bf16)
        keep = save_grid or vox <= BLOCKED_VOX
        ctx.save_for_backward(points, weights, rot, trans, taps,
                              grid if keep else None)
        ctx.camera, ctx.radius, ctx.vox = camera, radius, vox
        ctx.with_depth, ctx.bf16 = with_depth, bf16
        ctx.set_materialize_grads(False)
        return (sil, depth) if with_depth else sil

    @staticmethod
    @once_differentiable
    def backward(ctx, dsil, ddepth=None):
        points, weights, rot, trans, taps, grid = ctx.saved_tensors
        want = ctx.needs_input_grad
        with span("render.bwd"):
            if dsil is None:  # only the depth output reached the loss
                dsil = torch.zeros_like(ddepth)
            dpoints, dweights, drot, dtrans = _launch_world_backward(
                points, weights, rot, trans, ctx.camera, taps, ctx.radius,
                grid, dsil.contiguous(),
                None if ddepth is None else ddepth.contiguous(), ctx.vox,
                ctx.with_depth, want[1], want[2] or want[3], ctx.bf16)
        return (dpoints if want[0] else None, dweights,
                drot if want[2] else None, dtrans if want[3] else None,
                None, None, None, None, None, None, None)


def fused_project_t(
    ndc_t: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None = None,
    with_depth: bool = False,
    acc_dtype: str = "float32",
    save_grid: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """CHANNEL-MAJOR fused projection: ndc_t [R, 3, N] (rows x, y, z_ndc,
    from pc_perspective_transform_t) -> (sil [R, D, D], depth or None).

    Mirrors ``dpcx.render.pallas_kernel.pallas_project_t``, gradients,
    ``acc_dtype`` and ``save_grid`` included, by the plain version (where
    ``save_grid`` changes nothing), on CPU tensors only: the kernels take
    world clouds (``fused_project_world``), and tensors on the card are
    refused rather than rendered by the plain version.
    """
    _check_grid(vox_size, kernel_radius, acc_dtype)
    if ndc_t.dim() != 3 or ndc_t.shape[1] != 3:
        raise ValueError(f"ndc_t must be [R, 3, N], got {tuple(ndc_t.shape)}")
    R, _, N = ndc_t.shape
    _check_shape("point_weights", point_weights, (R, N))
    if ndc_t.device.type != "cpu":
        raise ValueError(
            f"fused_project_t runs on cpu, not {ndc_t.device.type}: on the "
            "card the fused renderer takes world clouds and cameras, "
            "fused_project_world")
    if acc_dtype == "bfloat16":
        return fused_project_plain(ndc_t, vox_size, sigma_vox, kernel_radius,
                                   point_weights, with_depth, acc_dtype)
    return fused_project_reference(ndc_t, vox_size, sigma_vox, kernel_radius,
                                   point_weights, with_depth)


def fused_project_world(
    points: torch.Tensor,
    quat: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None = None,
    translation: torch.Tensor | None = None,
    focal_length: float = FOCAL_LENGTH,
    camera_distance: float = CAMERA_DISTANCE,
    with_depth: bool = False,
    acc_dtype: str = "float32",
    save_grid: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """World clouds through cameras: points [C, N, 3], quat [R, 4] and
    translation [R, 3] or None, R a multiple of C (render r shows cloud
    r // (R / C)), point_weights [C, N] or None -> (sil [R, D, D], depth or
    None): ``pc_perspective_transform_t`` and ``fused_project_t`` in one.

    CUDA tensors: the rotations ``quaternion_to_matrix(quat)`` [R, 3, 3],
    then the kernels, whose splat stages run the camera transform in
    registers; no [R, 3, N] coordinates reach memory, and each cloud is
    read once for its R / C renders. Gradients reach points, point_weights,
    quat (through the rotations) and translation. CPU tensors: the clouds
    fanned out to R rows, ``pc_perspective_transform_t``, then
    ``fused_project_t``: the composition the kernels are held to.
    """
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(
            f"points must be [C, N, 3], got {tuple(points.shape)}")
    C, N, _ = points.shape
    R = quat.shape[0]
    if quat.shape != (R, 4) or C == 0 or R % C:
        raise ValueError(
            f"quat must be [R, 4] with R a multiple of the {C} clouds, got "
            f"{tuple(quat.shape)}")
    _check_shape("point_weights", point_weights, (C, N))
    _check_shape("translation", translation, (R, 3))
    if points.device.type != "cuda":
        fan = R // C
        if fan > 1:
            points = points.repeat_interleave(fan, dim=0)
            if point_weights is not None:
                point_weights = point_weights.repeat_interleave(fan, dim=0)
        ndc_t = pc_perspective_transform_t(
            points, quat, focal_length=focal_length,
            camera_distance=camera_distance, translation=translation)
        return fused_project_t(ndc_t, vox_size, sigma_vox, kernel_radius,
                               point_weights, with_depth, acc_dtype,
                               save_grid)
    _check_grid(vox_size, kernel_radius, acc_dtype)
    _check_f32(points.device, points=points, quat=quat,
               point_weights=point_weights, translation=translation)
    sigma = torch.as_tensor(sigma_vox, dtype=torch.float32,
                            device=points.device)
    taps = gauss_kernel_1d(sigma, kernel_radius).contiguous()
    out = _FusedWorldRender.apply(
        points.contiguous(),
        None if point_weights is None else point_weights.contiguous(),
        quaternion_to_matrix(quat).contiguous(),
        None if translation is None else translation.contiguous(),
        (float(focal_length), float(camera_distance)), taps, kernel_radius,
        vox_size, with_depth, save_grid, acc_dtype == "bfloat16")
    return out if with_depth else (out, None)
