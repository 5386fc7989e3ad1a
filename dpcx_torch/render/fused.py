"""Fused splat -> blur -> DRC renderer (port of
``dpcx/render/pallas_kernel.py::pallas_project_t``: the K1 forward and the
K2 backward for D <= 64, and the depth-blocked K3 forward and K4/K5
backward of ``dpcx/render/pallas_blocked.py`` for 64 < D <= 128).

``fused_project_t`` runs, for CUDA tensors, a ``torch.autograd.Function``
whose forward and backward launch the hand-written CUDA kernels of
``csrc/fused_render.cu``; one kernel family covers every D <= 128. For CPU
tensors it runs the plain version, ``fused_project_reference``, and
autograd differentiates that. Any other device raises. The plain version
is also the yardstick the kernels are checked against on the card.

``save_grid`` mirrors ``pallas_project_t``'s: at D > 64 the forward keeps
the x/y-blurred grid (8 MiB per render at 128^3) for the backward, or,
when False (``cfg.remat``), keeps only coords, weights and taps, and the
backward re-splats and re-blurs into fresh scratch first. At D <= 64 the
grid is always kept, as ``save_grid`` has no effect there in dpcx.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from dpcx_torch.render.drc import drc_projection
from dpcx_torch.render.gauss import gauss_kernel_1d, smoothen_voxels3d
from dpcx_torch.render.voxelize import pointcloud2voxels_scatter

MAX_FUSED_VOX = 128  # the kernels' grid is D^3 f32 per render, D <= 128
BLOCKED_VOX = 64  # above this, dpcx runs the depth-blocked kernels K3-K5

# kernel launches by name; counted only where a launch happens. D <= 64
# counts as fused_*, D > 64 as blocked_* (the K3-K5 counterparts)
LAUNCHES: dict[str, int] = {
    "fused_render": 0,
    "fused_render_bwd": 0,
    "blocked_render": 0,
    "blocked_render_bwd": 0,
    "blocked_render_bwd_recompute": 0,
}


def launch_family(vox: int) -> str:
    """The launch counters' prefix at grid size ``vox``."""
    return "blocked" if vox > BLOCKED_VOX else "fused"


def fused_project_reference(
    ndc_t: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None = None,
    with_depth: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the kernel: scatter splat + separable blur
    + DRC. ndc_t [R, 3, N] (rows x, y, z_ndc) -> sil [R, D, D], depth.

    Its forward is the kernels' function. Its gradient, by autograd through
    the floor-based trilinear weights, is that of dpcx's XLA scatter
    (``dpcx/render/voxelize.py:72``), and so differs from the kernels' (and
    from the Pallas kernels', whose hat derivative is ``_dhat_t``) only at
    an exactly integer grid coordinate: there the floor-based derivative
    along that axis is one-sided (-v(c) + v(c + 1)) where the kernels give
    0."""
    grid = pointcloud2voxels_scatter(
        ndc_t.transpose(1, 2), vox_size, point_weights=point_weights
    )
    grid = smoothen_voxels3d(grid, sigma_vox, kernel_radius)
    return drc_projection(grid, with_depth=with_depth)


def _check_inputs(ndc_t, vox_size, kernel_radius, point_weights) -> None:
    if ndc_t.dim() != 3 or ndc_t.shape[1] != 3:
        raise ValueError(f"ndc_t must be [R, 3, N], got {tuple(ndc_t.shape)}")
    if not 1 <= vox_size <= MAX_FUSED_VOX:
        raise ValueError(
            f"fused renderer covers 1 <= vox_size <= {MAX_FUSED_VOX}, "
            f"got {vox_size}"
        )
    if not 0 <= kernel_radius < vox_size:
        raise ValueError(
            f"kernel_radius must be in [0, {vox_size}), got {kernel_radius}"
        )
    R, _, N = ndc_t.shape
    if point_weights is not None and tuple(point_weights.shape) != (R, N):
        raise ValueError(
            f"point_weights must be [{R}, {N}], "
            f"got {tuple(point_weights.shape)}"
        )


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _launch_forward(coords, weights, taps, radius, vox, with_depth):
    """Forward (K1, or K3 at D > 64): coords [R, 3, N] (z, y, x grid
    units), weights [R, N] or None, taps [2 radius + 1] -> (sil, depth or
    None, the x/y-blurred grid [R, D, D, D] that the backward may read)."""
    from dpcx_torch import _build

    R, _, N = coords.shape
    D = vox
    grid = torch.empty((R, D, D, D), dtype=torch.float32, device=coords.device)
    sil = torch.empty((R, D, D), dtype=torch.float32, device=coords.device)
    depth = torch.empty_like(sil) if with_depth else None
    lib = _build.load()
    with torch.cuda.device(coords.device):
        err = lib.dpcx_fused_render(
            coords.data_ptr(), _ptr(weights), taps.data_ptr(), radius,
            grid.data_ptr(), sil.data_ptr(), _ptr(depth), R, N, D,
            int(with_depth),
            torch.cuda.current_stream(coords.device).cuda_stream,
        )
    name = f"{launch_family(vox)}_render"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return sil, depth, grid


def _launch_backward(coords, weights, taps, radius, grid, dsil, ddepth,
                     vox, with_depth, want_dweights):
    """Backward (K2, or K4 + K5 at D > 64): cotangents dsil [R, D, D] and
    ddepth (or None: zero) -> (d coords [R, 3, N], d weights [R, N] or
    None). ``grid`` is the forward's x/y-blurred grid, or None: then the
    recompute launcher re-splats and re-blurs it into scratch first."""
    from dpcx_torch import _build

    R, _, N = coords.shape
    D = vox
    recompute = grid is None
    if recompute:
        grid = torch.empty((R, D, D, D), dtype=torch.float32,
                           device=coords.device)
    dgrid = torch.empty_like(grid)
    dcoords = torch.empty_like(coords)
    dweights = (
        torch.empty((R, N), dtype=torch.float32, device=coords.device)
        if want_dweights else None
    )
    lib = _build.load()
    launch = (lib.dpcx_fused_render_bwd_recompute if recompute
              else lib.dpcx_fused_render_bwd)
    with torch.cuda.device(coords.device):
        err = launch(
            coords.data_ptr(), _ptr(weights), taps.data_ptr(), radius,
            grid.data_ptr(), dsil.data_ptr(), _ptr(ddepth), dgrid.data_ptr(),
            dcoords.data_ptr(), _ptr(dweights), R, N, D, int(with_depth),
            torch.cuda.current_stream(coords.device).cuda_stream,
        )
    name = (f"{launch_family(vox)}_render_bwd"
            + ("_recompute" if recompute else ""))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return dcoords, dweights


class _FusedRender(torch.autograd.Function):
    """Kernel forward, kernel backward. Returns sil, or (sil, depth) with
    depth.

    No gradient reaches the taps (the blur sigma is a schedule, not a
    learned parameter), as the zero ``dkmat`` of ``_fused_bwd`` in
    ``dpcx/render/pallas_kernel.py``.
    """

    @staticmethod
    def forward(ctx, coords, weights, taps, radius, vox, with_depth,
                save_grid):
        sil, depth, grid = _launch_forward(
            coords, weights, taps, radius, vox, with_depth
        )
        keep = save_grid or vox <= BLOCKED_VOX
        ctx.save_for_backward(coords, weights, taps, grid if keep else None)
        ctx.radius, ctx.vox, ctx.with_depth = radius, vox, with_depth
        # an output the loss never reads arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return (sil, depth) if with_depth else sil

    @staticmethod
    @once_differentiable
    def backward(ctx, dsil, ddepth=None):
        coords, weights, taps, grid = ctx.saved_tensors
        want_coords, want_weights = ctx.needs_input_grad[:2]
        if dsil is None:  # only the depth output reached the loss
            dsil = torch.zeros_like(ddepth)
        dcoords, dweights = _launch_backward(
            coords, weights, taps, ctx.radius, grid, dsil.contiguous(),
            None if ddepth is None else ddepth.contiguous(),
            ctx.vox, ctx.with_depth, want_weights,
        )
        return (dcoords if want_coords else None, dweights,
                None, None, None, None, None)


def _kernel_project(ndc_t, vox_size, sigma_vox, kernel_radius, point_weights,
                    with_depth, save_grid=True):
    """The kernel path: the NDC -> grid affine stays outside the Function,
    so autograd chains d/d(ndc) = D d/d(coords), as pallas_project_t."""
    for name, t in (("ndc_t", ndc_t), ("point_weights", point_weights)):
        if t is not None and (
            t.device != ndc_t.device or t.dtype != torch.float32
        ):
            raise ValueError(
                f"{name} must be float32 on {ndc_t.device}, "
                f"got {t.dtype} on {t.device}"
            )
    D = vox_size
    # NDC -> grid units, rows (z, y, x), as pallas_project_t does
    coords = ((ndc_t.flip(1) + 0.5) * D - 0.5).contiguous()
    pw = None if point_weights is None else point_weights.contiguous()
    sigma = torch.as_tensor(sigma_vox, dtype=torch.float32,
                            device=ndc_t.device)
    taps = gauss_kernel_1d(sigma, kernel_radius).contiguous()
    out = _FusedRender.apply(coords, pw, taps, kernel_radius, D, with_depth,
                             save_grid)
    return out if with_depth else (out, None)


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

    Mirrors ``dpcx.render.pallas_kernel.pallas_project_t``, gradients and
    ``save_grid`` included. CUDA tensors go through the CUDA kernels, CPU
    tensors through the plain version (where ``save_grid`` changes
    nothing).
    """
    if acc_dtype != "float32":
        raise NotImplementedError(
            f"acc_dtype={acc_dtype!r}: only the float32 mode of the fused "
            "kernel is ported"
        )
    _check_inputs(ndc_t, vox_size, kernel_radius, point_weights)
    if ndc_t.device.type == "cpu":
        return fused_project_reference(
            ndc_t, vox_size, sigma_vox, kernel_radius, point_weights,
            with_depth,
        )
    if ndc_t.device.type != "cuda":
        raise ValueError(
            f"fused renderer runs on cuda (kernel) or cpu (plain version), "
            f"not {ndc_t.device.type}"
        )
    return _kernel_project(
        ndc_t, vox_size, sigma_vox, kernel_radius, point_weights, with_depth,
        save_grid,
    )
