"""Projection pipeline: transform -> splat -> blur -> DRC (port of
``dpcx/render/project.py``), with the sigma-anneal and keep-prob schedules.

``cfg.renderer`` selects the path as in the reference: "xla" runs the eager
ops below; "pallas" runs the fused renderer (``render/fused.py``), which is
the hand-written CUDA kernel for CUDA tensors and its plain version for CPU
tensors; on the card its splat stages also run the camera transform
(``fused_project_world``). Configurations the fused kernel does not cover
fall through to the eager ops, as the reference falls through to XLA. Colour (``rgb``) always
takes the eager ops, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dpcx_torch.config import Config
from dpcx_torch.render.drc import (
    drc_event_probabilities,
    drc_projection,
    sum_projection,
)
from dpcx_torch.render.fused import MAX_FUSED_VOX, fused_project_world
from dpcx_torch.render.gauss import kernel_radius, smoothen_voxels3d
from dpcx_torch.render.transform import (
    pc_perspective_transform,
    pc_perspective_transform_t,
)
from dpcx_torch.render.voxelize import pointcloud2voxels_scatter
from dpcx_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RenderOut:
    """Renderer outputs: projection [B, Y, X], optional depth, voxel grid."""

    silhouette: torch.Tensor
    depth: torch.Tensor | None = None
    voxels: torch.Tensor | None = None
    rgb: torch.Tensor | None = None


def _step_frac(step, total_steps: int) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    return (step / max(total_steps, 1)).clamp(0.0, 1.0)


def sigma_schedule(cfg: Config, step, device=None) -> torch.Tensor:
    """Exponential coarse->fine anneal of the relative Gaussian sigma: a
    float32 0-d tensor on ``device`` (None: the default device).

    The value is computed on the host in float32 from the host's ``step``
    and reaches ``device`` as the argument of a fill: a copy of a host
    tensor to the card would synchronise the stream once a step and drain
    the card's queue. The card's ``expf`` may differ from the host's in
    the last bit, so the exponential stays on the host."""
    frac = _step_frac(step, cfg.sigma_anneal_steps)
    log_s0 = math.log(cfg.pc_relative_sigma)
    log_s1 = math.log(cfg.pc_relative_sigma_end)
    sigma = torch.exp(log_s0 + (log_s1 - log_s0) * frac)
    return torch.full((), sigma.item(), dtype=torch.float32, device=device)


def keep_prob_schedule(cfg: Config, step) -> torch.Tensor:
    """Linear ramp of point-dropout keep-prob from initial value to 1.0."""
    frac = _step_frac(step, cfg.pc_point_dropout_steps)
    return cfg.pc_point_dropout + (1.0 - cfg.pc_point_dropout) * frac


def _fused_route(cfg: Config, rgb, return_voxels: bool) -> bool:
    """Whether a call takes the fused renderer (else the eager ops)."""
    return (
        cfg.renderer == "pallas"
        and rgb is None  # colour never reaches the fused renderer
        and cfg.proj_type == "drc"
        and not cfg.drc_logsum
        and not return_voxels
        and cfg.vox_size % 8 == 0
        and cfg.vox_size <= MAX_FUSED_VOX  # 128, as dpcx; larger: eager ops
    )


def pointcloud_project_fn(
    cfg: Config,
    points: torch.Tensor,
    quat: torch.Tensor,
    sigma_rel: torch.Tensor,
    point_weights: torch.Tensor | None = None,
    rgb: torch.Tensor | None = None,
    translation: torch.Tensor | None = None,
    return_voxels: bool = False,
    project_fn=None,
) -> RenderOut:
    """Project world-frame clouds [B, N, 3] through cameras [B, 4]; with
    ``rgb`` [B, N, 3], also the expected colour along each ray [B, Y, X, 3].
    ``project_fn``: the fused renderer, with ``fused_project_t``'s
    signature (None: ``fused_project_world``, whose kernels on the card run
    the camera transform in their splat stages).

    Spanned as ``render.project``.
    """
    with span("render.project"):
        return _project(cfg, points, quat, sigma_rel, point_weights, rgb,
                        translation, return_voxels, project_fn)


def _project(cfg, points, quat, sigma_rel, point_weights, rgb, translation,
             return_voxels, project_fn) -> RenderOut:
    dtype = getattr(torch, cfg.renderer_dtype)
    points = points.to(dtype)
    quat = quat.to(dtype)
    D = cfg.vox_size
    trans = None if translation is None else translation.to(dtype)

    # radius covers the widest sigma the anneal will ever use
    radius = kernel_radius(
        max(cfg.pc_relative_sigma, cfg.pc_relative_sigma_end),
        D,
        cfg.gauss_kernel_truncate,
    )
    sigma_vox = torch.as_tensor(sigma_rel, dtype=dtype, device=points.device) * D

    if _fused_route(cfg, rgb, return_voxels):
        kw = dict(
            point_weights=point_weights,
            with_depth=cfg.proj_depth,
            acc_dtype=cfg.pallas_acc_dtype,
            # remat: at D > 64 the backward re-splats and re-blurs instead
            # of keeping the blurred grid (8 MiB per render at 128^3)
            save_grid=not cfg.remat,
        )
        if project_fn is None:
            sil, depth = fused_project_world(
                points, quat, D, sigma_vox, radius, translation=trans,
                focal_length=cfg.focal_length,
                camera_distance=cfg.camera_distance, **kw)
        else:
            ndc_t = pc_perspective_transform_t(
                points,
                quat,
                focal_length=cfg.focal_length,
                camera_distance=cfg.camera_distance,
                translation=trans,
            )
            sil, depth = project_fn(ndc_t, D, sigma_vox, radius, **kw)
        return RenderOut(silhouette=sil, depth=depth)

    ndc = pc_perspective_transform(
        points,
        quat,
        focal_length=cfg.focal_length,
        camera_distance=cfg.camera_distance,
        translation=trans,
    )
    rgb_grid = None
    if rgb is None:
        grid = pointcloud2voxels_scatter(ndc, D, point_weights=point_weights)
    else:
        grid, rgb_grid = pointcloud2voxels_scatter(
            ndc, D, point_weights=point_weights, rgb=rgb.to(dtype)
        )
    grid = smoothen_voxels3d(grid, sigma_vox, radius)
    if cfg.proj_type == "drc":
        sil, depth = drc_projection(
            grid, logsum=cfg.drc_logsum, with_depth=cfg.proj_depth
        )
    else:
        sil, depth = sum_projection(grid)
    rgb_proj = None
    if rgb_grid is not None:
        # expected colour along each ray, weighted by stop probabilities
        p_stop, _ = drc_event_probabilities(grid, logsum=cfg.drc_logsum)
        rgb_proj = torch.einsum("bzyx,bzyxc->byxc", p_stop, rgb_grid)
    return RenderOut(
        silhouette=sil,
        depth=depth,
        voxels=grid if return_voxels else None,
        rgb=rgb_proj,
    )


# dpcx's jitted convenience name; eager PyTorch needs no second function
pointcloud_project = pointcloud_project_fn
