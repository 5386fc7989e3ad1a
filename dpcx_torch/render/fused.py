"""Fused splat -> blur -> DRC renderer (port of
``dpcx/render/pallas_kernel.py``: the K1 forward and the K2 backward for
D <= 64).

``fused_project_t`` runs, for CUDA tensors, a ``torch.autograd.Function``
whose forward launches the hand-written CUDA kernel K1 and whose backward
launches K2 (both in ``csrc/fused_render.cu``); for CPU tensors it runs
the plain version, ``fused_project_reference``, and autograd differentiates
that. Any other device raises. The plain version is also the yardstick
both kernels are checked against on the card.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from dpcx_torch.render.drc import drc_projection
from dpcx_torch.render.gauss import gauss_kernel_1d, smoothen_voxels3d
from dpcx_torch.render.voxelize import pointcloud2voxels_scatter

MAX_FUSED_VOX = 64  # the kernel's grid is D^3 f32 per render, D <= 64

# kernel launches by name; counted only where a launch happens
LAUNCHES: dict[str, int] = {"fused_render": 0, "fused_render_bwd": 0}


def fused_project_reference(
    ndc_t: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None = None,
    with_depth: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the kernel: scatter splat + separable blur
    + DRC. ndc_t [R, 3, N] (rows x, y, z_ndc) -> sil [R, D, D], depth."""
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
    """K1: coords [R, 3, N] (z, y, x grid units), weights [R, N] or None,
    taps [2 radius + 1] -> (sil, depth or None, the x/y-blurred grid
    [R, D, D, D] that K2 reads)."""
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
    if err != 0:
        raise RuntimeError(f"fused_render kernel launch failed: cudaError {err}")
    LAUNCHES["fused_render"] += 1
    return sil, depth, grid


def _launch_backward(coords, weights, taps, radius, grid, dsil, ddepth,
                     vox, with_depth, want_dweights):
    """K2: cotangents dsil [R, D, D] and ddepth (or None: zero) ->
    (d coords [R, 3, N], d weights [R, N] or None)."""
    from dpcx_torch import _build

    R, _, N = coords.shape
    dgrid = torch.empty_like(grid)
    dcoords = torch.empty_like(coords)
    dweights = (
        torch.empty((R, N), dtype=torch.float32, device=coords.device)
        if want_dweights else None
    )
    lib = _build.load()
    with torch.cuda.device(coords.device):
        err = lib.dpcx_fused_render_bwd(
            coords.data_ptr(), _ptr(weights), taps.data_ptr(), radius,
            grid.data_ptr(), dsil.data_ptr(), _ptr(ddepth), dgrid.data_ptr(),
            dcoords.data_ptr(), _ptr(dweights), R, N, vox, int(with_depth),
            torch.cuda.current_stream(coords.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_render_bwd kernel launch failed: cudaError {err}"
        )
    LAUNCHES["fused_render_bwd"] += 1
    return dcoords, dweights


class _FusedRender(torch.autograd.Function):
    """K1 forward, K2 backward. Returns sil, or (sil, depth) with depth.

    No gradient reaches the taps (the blur sigma is a schedule, not a
    learned parameter), as the zero ``dkmat`` of ``_fused_bwd`` in
    ``dpcx/render/pallas_kernel.py``.
    """

    @staticmethod
    def forward(ctx, coords, weights, taps, radius, vox, with_depth):
        sil, depth, grid = _launch_forward(
            coords, weights, taps, radius, vox, with_depth
        )
        ctx.save_for_backward(coords, weights, taps, grid)
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
                None, None, None, None)


def _kernel_project(ndc_t, vox_size, sigma_vox, kernel_radius, point_weights,
                    with_depth):
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
    out = _FusedRender.apply(coords, pw, taps, kernel_radius, D, with_depth)
    return out if with_depth else (out, None)


def fused_project_t(
    ndc_t: torch.Tensor,
    vox_size: int,
    sigma_vox: torch.Tensor | float,
    kernel_radius: int,
    point_weights: torch.Tensor | None = None,
    with_depth: bool = False,
    acc_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """CHANNEL-MAJOR fused projection: ndc_t [R, 3, N] (rows x, y, z_ndc,
    from pc_perspective_transform_t) -> (sil [R, D, D], depth or None).

    Mirrors ``dpcx.render.pallas_kernel.pallas_project_t``, gradients
    included. CUDA tensors go through the CUDA kernels, CPU tensors
    through the plain version.
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
        ndc_t, vox_size, sigma_vox, kernel_radius, point_weights, with_depth
    )
