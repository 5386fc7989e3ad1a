"""Point- and grid-sharded renderers over a process mesh (port of
``dpcx/render/sharded.py``).

Inputs are replicated (every rank holds all of ``points``) and so are the
outputs. The point-sharded renderer splats the rank's point shard into a
whole D^3 grid with the scatter splat, sums the grids over the ranks (one
``all_sum``; with rgb the colour numerator too, un-normalised), then blurs
and projects on every rank, as one device does. The grid-sharded renderer
gives each rank a z-block of the grid plus a blur halo of ``radius`` slabs
on each side: it splats every point into that slab, blurs and crops it, and
runs DRC blockwise across the ranks through a gather of the blocks'
transmittances. No rank holds a D^3 grid there.

Gradients follow dpcx's ``shard_map`` convention (``parallel/mesh.py``):
each output's cotangent is divided by the ranks where it leaves, every sum
over ranks sums its cotangents, and a replicated input that a rank uses on
its own sums its cotangents over the ranks. So each rank's gradient with
respect to the replicated inputs is the whole one, the unsharded
renderer's.
"""

from __future__ import annotations

import torch

from dpcx_torch.config import Config
from dpcx_torch.parallel.mesh import (
    Mesh,
    all_sum,
    gather_slots,
    scale_grad,
    shard_bounds,
    sum_grad,
)
from dpcx_torch.render.drc import (
    drc_event_probabilities,
    drc_projection,
    sum_projection,
)
from dpcx_torch.render.gauss import blur_matrix, kernel_radius, \
    smoothen_voxels3d
from dpcx_torch.render.project import RenderOut
from dpcx_torch.render.transform import pc_perspective_transform
from dpcx_torch.render.voxelize import splat_raw


def _radius(cfg: Config) -> int:
    return kernel_radius(max(cfg.pc_relative_sigma, cfg.pc_relative_sigma_end),
                         cfg.vox_size, cfg.gauss_kernel_truncate)


def _transform(cfg: Config, points, quat):
    return pc_perspective_transform(points, quat,
                                    focal_length=cfg.focal_length,
                                    camera_distance=cfg.camera_distance)


def _outputs(cfg: Config, mesh: Mesh, sil, depth, rgb_proj) -> RenderOut:
    return RenderOut(
        silhouette=scale_grad(sil, mesh),
        depth=scale_grad(depth, mesh) if cfg.proj_depth else None,
        rgb=None if rgb_proj is None else scale_grad(rgb_proj, mesh),
    )


def pointcloud_project_point_sharded(
    cfg: Config,
    mesh: Mesh,
    points: torch.Tensor,     # [B, N, 3], N divisible by mesh.size
    quat: torch.Tensor,       # [B, 4]
    sigma_rel,
    point_weights: torch.Tensor | None = None,  # [B, N]
    rgb: torch.Tensor | None = None,            # [B, N, 3]
    axis: str = "data",
) -> RenderOut:
    """Silhouette, optional depth and optional rgb with the point axis
    sharded over the mesh's slots (a member without a slot splats nothing).
    ``axis`` names dpcx's mesh axis; the port's mesh has the one."""
    D = cfg.vox_size
    radius = _radius(cfg)
    sigma_vox = torch.as_tensor(sigma_rel, dtype=points.dtype,
                                device=points.device) * D
    lo, hi = shard_bounds(points.shape[1], mesh)
    pts = sum_grad(points, mesh)[:, lo:hi]
    pw = (None if point_weights is None
          else sum_grad(point_weights, mesh)[:, lo:hi])
    col_pts = None if rgb is None else sum_grad(rgb, mesh)[:, lo:hi]
    ndc = _transform(cfg, pts, sum_grad(quat, mesh))
    partial_grid, col = splat_raw(ndc, D, point_weights=pw, rgb=col_pts)
    grid_raw = all_sum(partial_grid, mesh)
    grid = smoothen_voxels3d(grid_raw, sigma_vox, radius)
    if cfg.proj_type == "drc":
        sil, depth = drc_projection(grid, logsum=cfg.drc_logsum,
                                    with_depth=cfg.proj_depth)
    else:
        sil, depth = sum_projection(grid)
    if depth is None:  # sum mode, or drc with proj_depth off
        depth = torch.zeros_like(sil)
    rgb_proj = None
    if rgb is not None:
        # the colour numerator sums over the shards, then normalises by
        # the merged raw density, as the unsharded splat normalises
        rgb_grid = all_sum(col, mesh) / grid_raw[..., None].clamp_min(1e-6)
        p_stop, _ = drc_event_probabilities(grid, logsum=cfg.drc_logsum)
        rgb_proj = torch.einsum("bzyx,bzyxc->byxc", p_stop, rgb_grid)
    return _outputs(cfg, mesh, sil, depth, rgb_proj)


def gt_pose_projection_loss_sharded(
    cfg: Config,
    mesh: Mesh,
    points: torch.Tensor,      # [M, N, 3] (M = batch x views, pre-tiled)
    quats: torch.Tensor,       # [M, 4]
    masks: torch.Tensor,       # [M, D, D]
    sigma_rel,
    rgb: torch.Tensor | None = None,
    images_tgt: torch.Tensor | None = None,  # [M, D, D, 3]
    point_weights: torch.Tensor | None = None,  # [M, N]
) -> torch.Tensor:
    """The GT-pose re-projection loss over the point-sharded renderer:
    squared-L2 silhouette, plus the masked colour error with rgb and
    targets (the GT branch of ``models/losses.py::compute_loss``)."""
    out = pointcloud_project_point_sharded(
        cfg, mesh, points, quats, sigma_rel, point_weights=point_weights,
        rgb=rgb)
    loss = torch.mean((out.silhouette - masks) ** 2)
    if rgb is not None and images_tgt is not None:
        rgb_cmp = out.rgb + (1.0 - out.silhouette[..., None]) * \
            cfg.rgb_background
        w = masks[..., None]
        loss = loss + cfg.rgb_weight * (
            torch.sum(w * (rgb_cmp - images_tgt) ** 2)
            / (torch.sum(w) * 3.0).clamp_min(1.0))
    return loss


def pointcloud_project_grid_sharded(
    cfg: Config,
    mesh: Mesh,
    points: torch.Tensor,     # [B, N, 3]
    quat: torch.Tensor,       # [B, 4]
    sigma_rel,
    point_weights: torch.Tensor | None = None,
    rgb: torch.Tensor | None = None,            # [B, N, 3]
    axis: str = "data",
) -> RenderOut:
    """Grid-sharded renderer: the rank at slot i owns z-block
    ``[i Zl, (i + 1) Zl)``, ``Zl = D / size``, and splats every point into
    it and a halo of ``radius`` slabs each side (corners outside dropped,
    as out-of-grid ones); the halo carries the neighbours' mass through the
    z blur, so the cropped block is exact. DRC composes blockwise: each
    block's transmittance is gathered, the product of the blocks before a
    block is the transmittance entering it, and silhouette, depth and
    colour assemble with sums over the ranks. ``rgb`` needs ``proj_type:
    drc``; every member of the mesh must hold a block."""
    D = cfg.vox_size
    ndev = mesh.size
    if D % ndev:
        raise ValueError(f"vox_size {D} does not split into {ndev} z-blocks")
    Zl = D // ndev
    R = _radius(cfg)  # halo slabs carried on each side of the block
    if R > Zl:
        raise ValueError(f"blur radius {R} exceeds z-block {Zl}; use fewer "
                         "ranks or a smaller sigma")
    if rgb is not None and cfg.proj_type != "drc":
        raise ValueError(
            "grid-sharded rgb requires proj_type='drc' (color composites "
            "through the blockwise DRC stop probabilities)")
    if mesh.index is None or mesh.world != ndev:
        raise ValueError("every rank of a grid-sharded mesh holds a block")
    di = mesh.index
    z0 = di * Zl
    sigma_vox = torch.as_tensor(sigma_rel, dtype=points.dtype,
                                device=points.device) * D
    pw = None if point_weights is None else sum_grad(point_weights, mesh)
    col_pts = None if rgb is None else sum_grad(rgb, mesh)
    ndc = _transform(cfg, sum_grad(points, mesh), sum_grad(quat, mesh))
    grid, col = splat_raw(ndc, D, point_weights=pw, rgb=col_pts,
                          z_range=(z0 - R, z0 + Zl + R))  # [B, Zl + 2R, D, D]
    if col is not None:
        # colour is never blurred: the block's raw numerator over its raw
        # density, as the unsharded splat normalises
        rgb_grid_loc = col[:, R:R + Zl] / \
            grid[:, R:R + Zl, ..., None].clamp_min(1e-6)
    # blur: y/x with the full-width Toeplitz, z with a band over the
    # extended block; the halo makes the crop exact
    Kf = blur_matrix(sigma_vox, D, R).to(grid.dtype)
    Kz = blur_matrix(sigma_vox, Zl + 2 * R, R).to(grid.dtype)
    grid = torch.einsum("bzyx,xi->bzyi", grid, Kf)
    grid = torch.einsum("bzyx,yi->bzix", grid, Kf)
    grid = torch.einsum("bzyx,zi->biyx", grid, Kz)
    o_loc = grid[:, R:R + Zl]

    if cfg.proj_type != "drc":
        # the clipped sum is linear in z: sum the blocks' sums
        sil = all_sum(o_loc.sum(1), mesh).clamp(0.0, 1.0)
        return _outputs(cfg, mesh, sil, torch.zeros_like(sil), None)

    p_loc, t_blk = drc_event_probabilities(o_loc, logsum=cfg.drc_logsum)
    t_all = gather_slots(t_blk, mesh)  # [ndev, B, Y, X]
    before = (torch.arange(ndev, device=t_all.device) < di).to(
        t_all.dtype)[:, None, None, None]
    t_in = torch.prod(t_all * before + (1.0 - before), dim=0)
    total = torch.prod(t_all, dim=0)
    sil = 1.0 - total
    weights = p_loc * t_in[:, None]
    rgb_proj = None
    if rgb is not None:
        rgb_proj = all_sum(torch.einsum("bzyx,bzyxc->byxc", weights,
                                        rgb_grid_loc), mesh)
    depth = torch.zeros_like(sil)
    if cfg.proj_depth:
        zs = (z0 + torch.arange(Zl, dtype=o_loc.dtype, device=o_loc.device)
              + 0.5) / D - 0.5
        depth = all_sum(torch.einsum("bzyx,z->byx", weights, zs), mesh) \
            + 1.0 * total
    return _outputs(cfg, mesh, sil, depth, rgb_proj)
