"""Anisotropic Gaussian splats with RGB alpha-compositing (port of
``dpcx/render/gsplat.py``).

Each point carries a full 3-D covariance Sigma = R(q) diag(s^2) R(q)^T (s in
NDC units, q a local orientation) and an opacity. The density field is the
sum of normalised anisotropic Gaussians on the voxel grid; per-cell alpha is
1 - exp(-density), so the DRC transmittance recurrence over the alpha grid
is alpha compositing along the ray; the rendered colour is the expectation
of the density-weighted cell colour over the ray-termination events. Under
the camera the local orientation composes with the camera rotation
(q_cam * q_n); the perspective divide's shear of the covariance is ignored,
as in the reference.

``cfg.gsplat_impl`` selects the density: "dense" is the all-cells oracle
(every point on every cell, the quadratic form clamped at 0); "pallas" is
the z-windowed function of dpcx's Pallas kernel, run by the CUDA kernels of
``render/aniso.py`` on CUDA tensors and by their plain version on CPU
tensors, in either operand mode (``cfg.pallas_acc_dtype``); "windowed" is
dpcx's eager form with per-point (z, y) windows of a fixed edge, placed by
one-hot products (dpcx runs no Pallas kernel there, and neither does the
port): its window truncation gives other numbers than either.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from dpcx_torch.config import Config
from dpcx_torch.geometry.quaternion import (
    quaternion_multiply,
    quaternion_to_matrix,
)
from dpcx_torch.render.aniso import MAX_ANISO_VOX, aniso_density
from dpcx_torch.render.drc import drc_event_probabilities, drc_projection
from dpcx_torch.render.project import RenderOut
from dpcx_torch.render.transform import pc_perspective_transform
from dpcx_torch.render.voxelize import ndc_to_grid

_NORM = (2.0 * math.pi) ** (-1.5)


def _precision_zyx(scales_vox: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Per-point precision matrix A = Sigma^-1 [..., 3, 3] in (z, y, x) grid
    axes. scales_vox [..., 3] are standard deviations along the point's
    local axes (voxel units); rot [..., 4] rotates local -> world (x, y, z).
    """
    Rm = quaternion_to_matrix(rot)  # [..., 3, 3], world <- local, xyz
    inv_var = 1.0 / scales_vox.clamp_min(1e-4) ** 2
    A = torch.einsum("...ik,...k,...jk->...ij", Rm, inv_var, Rm)
    return A.flip(-1).flip(-2)  # xyz -> zyx on both index axes


def _weights(scales_vox: torch.Tensor,
             point_weights: torch.Tensor | None) -> torch.Tensor:
    """The normalised Gaussian's weight, times the point weights."""
    norm = _NORM / scales_vox.prod(dim=-1).clamp_min(1e-12)
    return norm if point_weights is None else norm * point_weights


def anisotropic_density_grid(
    points_ndc: torch.Tensor,     # [B, N, 3]
    scales_ndc: torch.Tensor,     # [B, N, 3] stddevs in NDC units
    rot: torch.Tensor,            # [B, N, 4] local orientation quats
    vox_size: int,
    point_weights: torch.Tensor | None = None,  # [B, N]
    rgb: torch.Tensor | None = None,            # [B, N, 3]
    chunk: int = 512,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Sum-of-anisotropic-Gaussians density on every cell: density
    [B, D, D, D] and, with rgb, the density-weighted colour grid
    [B, D, D, D, 3]. One z-slab at a time, points in chunks, as dpcx."""
    B, N, _ = points_ndc.shape
    D = vox_size
    mu = ndc_to_grid(points_ndc, D)            # [B, N, 3] (z, y, x)
    s_vox = scales_ndc * D
    A = _precision_zyx(s_vox, rot)             # [B, N, 3, 3]
    w = _weights(s_vox, point_weights)
    cells = torch.arange(D, dtype=points_ndc.dtype, device=points_ndc.device)

    dens_slabs, col_slabs = [], []
    for z in range(D):
        dens = points_ndc.new_zeros((B, D, D))
        col = points_ndc.new_zeros((B, D, D, 3))
        for s in range(0, N, chunk):
            muk, Ak, wk = mu[:, s:s + chunk], A[:, s:s + chunk], w[:, s:s + chunk]
            dz = z - muk[..., 0]                            # [B, C]
            dy = cells - muk[..., 1, None]                  # [B, C, D]
            dx = cells - muk[..., 2, None]                  # [B, C, D]
            # the full quadratic form before the exp: PSD, so exp(-quad)
            # <= 1, where per-axis factors could overflow one by one
            q_y = (0.5 * Ak[..., 1, 1, None] * dy**2
                   + (Ak[..., 0, 1] * dz)[..., None] * dy)
            q_x = (0.5 * Ak[..., 2, 2, None] * dx**2
                   + (Ak[..., 0, 2] * dz)[..., None] * dx)
            quad = ((0.5 * Ak[..., 0, 0] * dz**2)[..., None, None]
                    + q_y[..., :, None] + q_x[..., None, :]
                    + Ak[..., 1, 2, None, None]
                    * dy[..., :, None] * dx[..., None, :])  # [B, C, D, D]
            contrib = wk[..., None, None] * torch.exp(-quad.clamp_min(0.0))
            dens = dens + contrib.sum(dim=1)
            if rgb is not None:
                col = col + torch.einsum("bcyx,bck->byxk", contrib,
                                         rgb[:, s:s + chunk])
        dens_slabs.append(dens)
        col_slabs.append(col)
    density = torch.stack(dens_slabs, dim=1)  # [B, D, D, D]
    if rgb is None:
        return density
    rgb_grid = torch.stack(col_slabs, dim=1) / density[..., None].clamp_min(
        1e-6)
    return density, rgb_grid


def anisotropic_density_grid_windowed(
    points_ndc: torch.Tensor,     # [B, N, 3]
    scales_ndc: torch.Tensor,     # [B, N, 3] stddevs in NDC units
    rot: torch.Tensor,            # [B, N, 4] local orientation quats
    vox_size: int,
    point_weights: torch.Tensor | None = None,  # [B, N]
    rgb: torch.Tensor | None = None,            # [B, N, 3]
    chunk: int = 128,
    max_scale_ndc: float = 0.06,
    truncate: float = 3.0,
    remat: bool = True,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """dpcx's windowed density: each point is evaluated on a window of
    (W, W, D) cells around its centre, W = min(D, 2 ceil(radius) + 2) with
    radius = truncate * max_scale_ndc * D, its (z, y) start clamped inside
    the grid; mass beyond the window is dropped. Per chunk of points: the
    full quadratic form on the window, exp(-max(quad, 0)) times the weight,
    a one-hot product that places the window's y rows, and one product
    that places its z planes and sums the chunk's points, with the colour
    rows [1, r, g, b] as extra output rows. Batched over renders; chunks in
    order, each under ``torch.utils.checkpoint`` with ``remat``. Returns
    density [B, D, D, D] and, with rgb, the colour grid [B, D, D, D, 3].
    The products must run in f32 (TF32 off, PyTorch's default), as dpcx's
    run at HIGHEST precision."""
    B, N, _ = points_ndc.shape
    D = vox_size
    dtype, dev = points_ndc.dtype, points_ndc.device
    radius = truncate * max_scale_ndc * D
    W = min(D, 2 * math.ceil(radius) + 2)  # static window edge
    mu = ndc_to_grid(points_ndc, D)            # [B, N, 3] (z, y, x)
    s_vox = scales_ndc * D
    A = _precision_zyx(s_vox, rot)             # [B, N, 3, 3]
    w = _weights(s_vox, point_weights)
    ones = points_ndc.new_ones((B, N, 1))
    rgb_b = ones if rgb is None else torch.cat([ones, rgb], dim=-1)
    K = rgb_b.shape[-1]  # 1 (density) or 4 (density and colour rows)

    pad = -N % chunk
    if pad:
        mu = torch.cat([mu, mu.new_full((B, pad, 3), -1e4)], dim=1)
        A = torch.cat([A, torch.eye(3, dtype=dtype, device=dev).expand(
            B, pad, 3, 3)], dim=1)
        w = torch.cat([w, w.new_zeros((B, pad))], dim=1)
        rgb_b = torch.cat([rgb_b, rgb_b.new_zeros((B, pad, K))], dim=1)
    # window starts, clamped inside the grid (round half to even, as
    # jnp.round); constants of the points, so no gradient
    starts = (torch.round(mu[..., :2].detach()) - W // 2).clamp(0, D - W)
    win = torch.arange(W, dtype=dtype, device=dev)
    cells = torch.arange(D, dtype=dtype, device=dev)

    def chunk_density(muk, Ak, wk, rgbk, startk):
        C = muk.shape[1]
        z0k, y0k = startk[..., 0], startk[..., 1]           # [B, C]
        dz = z0k[..., None] + win - muk[..., 0, None]        # [B, C, W]
        dy = y0k[..., None] + win - muk[..., 1, None]        # [B, C, W]
        dx = cells - muk[..., 2, None]                       # [B, C, D]
        # the full PSD quadratic form before the exp, as the dense form
        t_z = 0.5 * Ak[..., 0, 0, None] * dz**2
        t_y = 0.5 * Ak[..., 1, 1, None] * dy**2
        t_x = 0.5 * Ak[..., 2, 2, None] * dx**2
        zy = Ak[..., 0, 1, None, None] * dz[..., :, None] * dy[..., None, :]
        zx = Ak[..., 0, 2, None, None] * dz[..., :, None] * dx[..., None, :]
        yx = Ak[..., 1, 2, None, None] * dy[..., :, None] * dx[..., None, :]
        quad = (
            (t_z[..., :, None, None] + t_y[..., None, :, None])
            + zy[..., None]
            + (t_x[..., None, None, :] + zx[..., :, None, :])
            + yx[..., None, :, :]
        )  # [B, C, W(z), W(y), D(x)]
        contrib = wk[..., None, None, None] * torch.exp(-quad.clamp_min(0.0))
        # y-placement: a one-hot [D, W] a point
        Sy = (cells[:, None] == y0k[..., None, None] + win).to(dtype)
        tmp = torch.einsum("bcyv,bcwvx->bcwyx", Sy, contrib)  # [B,C,W,D,D]
        # z-placement, the sum over the chunk's points and the colour rows
        Sz = (cells[:, None] == z0k[..., None, None] + win).to(dtype)
        M = Sz[:, :, None] * rgbk[..., None, None]            # [B,C,K,D,W]
        M = M.permute(0, 2, 3, 1, 4).reshape(B, K * D, C * W)
        return torch.bmm(M, tmp.reshape(B, C * W, D * D))

    acc = points_ndc.new_zeros((B, K * D, D * D))
    for s in range(0, N + pad, chunk):
        args = (mu[:, s:s + chunk], A[:, s:s + chunk], w[:, s:s + chunk],
                rgb_b[:, s:s + chunk], starts[:, s:s + chunk])
        if remat and torch.is_grad_enabled():
            add = checkpoint(chunk_density, *args, use_reentrant=False)
        else:
            add = chunk_density(*args)
        acc = acc + add
    acc = acc.reshape(B, K, D, D, D)
    density = acc[:, 0]
    if rgb is None:
        return density
    rgb_grid = acc[:, 1:].movedim(1, -1) / density[..., None].clamp_min(1e-6)
    return density, rgb_grid


def splat_params(
    points_ndc: torch.Tensor,
    scales_ndc: torch.Tensor,
    rot: torch.Tensor,
    vox_size: int,
    point_weights: torch.Tensor | None = None,
    truncate: float = 3.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' inputs: centres mu [B, N, 3] in grid units (z, y, x),
    precision entries A6 [B, N, 6] (A00, A01, A02, A11, A12, A22), weights
    w [B, N] (normalisation times point weights) and the z-window radius
    rz [B, N] = truncate * sqrt(Sigma_zz) in cells."""
    D = vox_size
    mu = ndc_to_grid(points_ndc, D)
    s_vox = scales_ndc * D
    A = _precision_zyx(s_vox, rot)
    A6 = torch.stack([A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                      A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]], dim=-1)
    # z-extent of the truncate-sigma ellipsoid: sqrt(Sigma_zz), Sigma =
    # R diag(s^2) R^T in xyz axes, z = xyz index 2
    Rm = quaternion_to_matrix(rot)
    sigma_zz = torch.sum(Rm[..., 2, :] ** 2 * s_vox**2, dim=-1)
    rz = truncate * torch.sqrt(sigma_zz.clamp_min(1e-12))
    return mu, A6, _weights(s_vox, point_weights), rz


def anisotropic_density_grid_pallas(
    points_ndc: torch.Tensor,
    scales_ndc: torch.Tensor,
    rot: torch.Tensor,
    vox_size: int,
    point_weights: torch.Tensor | None = None,
    rgb: torch.Tensor | None = None,
    truncate: float = 3.0,
    acc_dtype: str = "float32",
    density_fn=None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The z-windowed density of dpcx's Pallas path (same name and
    arguments, less ``interpret``): each point's z-window is rz = truncate *
    sqrt(Sigma_zz) cells, widened to its chunk's band (``render/aniso.py``).
    ``density_fn`` (default ``aniso.aniso_density``: the CUDA kernels on
    CUDA tensors, their plain version on CPU tensors) takes (mu, A6, w, rgb,
    rz, vox, acc_dtype); a caller may hand another, e.g. the plain version
    on the card."""
    D = vox_size
    density_fn = density_fn or aniso_density
    mu, A6, w, rz = splat_params(points_ndc, scales_ndc, rot, D,
                                 point_weights, truncate)
    if rgb is None:
        return density_fn(mu, A6, w, None, rz, D, acc_dtype)
    dens, cols = density_fn(mu, A6, w, rgb, rz, D, acc_dtype)
    rgb_grid = cols.movedim(1, -1) / dens[..., None].clamp_min(1e-6)
    return dens, rgb_grid


def alpha_from_density(density: torch.Tensor) -> torch.Tensor:
    """Exact volumetric compositing transform: alpha = 1 - exp(-density)."""
    return 1.0 - torch.exp(-density)


def gsplat_project(
    cfg: Config,
    points: torch.Tensor,        # [B, N, 3] world/canonical frame
    quat: torch.Tensor,          # [B, 4] camera quaternion
    scales_ndc: torch.Tensor,    # [B, N, 3]
    rot: torch.Tensor,           # [B, N, 4] local orientations
    opacity: torch.Tensor | None = None,  # [B, N]
    rgb: torch.Tensor | None = None,      # [B, N, 3]
    translation: torch.Tensor | None = None,
    density_fn=None,
) -> RenderOut:
    """Render anisotropic RGB splats through the DRC compositing pipeline:
    silhouette [B, D, D], depth or None, rgb [B, D, D, 3] or None.
    ``density_fn``: as ``anisotropic_density_grid_pallas``'s, used with
    ``gsplat_impl: pallas``."""
    D = cfg.vox_size
    ndc = pc_perspective_transform(
        points, quat, focal_length=cfg.focal_length,
        camera_distance=cfg.camera_distance, translation=translation,
    )
    rot_cam = quaternion_multiply(quat[:, None, :], rot)
    if cfg.gsplat_impl == "pallas":
        if D > MAX_ANISO_VOX:
            # dpcx refuses it: its kernel's whole-grid VMEM scratch does not
            # fit beyond D 64; the port adds no path the reference lacks
            raise ValueError(
                f"gsplat_impl='pallas' supports vox_size<=64 (got {D}): "
                "the kernel's whole-grid VMEM scratch does not fit "
                "beyond D=64. Use gsplat_impl='dense' for this config."
            )
        out = anisotropic_density_grid_pallas(
            ndc, scales_ndc, rot_cam, D, point_weights=opacity, rgb=rgb,
            acc_dtype=cfg.pallas_acc_dtype, density_fn=density_fn,
        )
    elif cfg.gsplat_impl == "windowed":
        out = anisotropic_density_grid_windowed(
            ndc, scales_ndc, rot_cam, D, point_weights=opacity, rgb=rgb,
            max_scale_ndc=cfg.gauss_scale_max, remat=cfg.gsplat_remat,
        )
    else:
        out = anisotropic_density_grid(
            ndc, scales_ndc, rot_cam, D, point_weights=opacity, rgb=rgb,
        )
    density, rgb_grid = out if rgb is not None else (out, None)
    alpha = alpha_from_density(density)
    sil, depth = drc_projection(alpha, logsum=cfg.drc_logsum,
                                with_depth=cfg.proj_depth)
    rgb_proj = None
    if rgb_grid is not None:
        p_stop, _ = drc_event_probabilities(alpha, logsum=cfg.drc_logsum)
        rgb_proj = torch.einsum("bzyx,bzyxc->byxc", p_stop, rgb_grid)
    return RenderOut(silhouette=sil, depth=depth, voxels=None, rgb=rgb_proj)
