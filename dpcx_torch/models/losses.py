"""GT-pose loss forward (port of the ``not cfg.predict_pose`` branch of
``dpcx/models/losses.py::compute_loss``).

Every target view is rendered with its known camera; the loss is the
squared-L2 silhouette error, plus the masked colour error with rgb, plus
the masked depth error when the config renders depth, plus the scale
regulariser. With ``renderer: pallas`` the render goes through the fused
CUDA kernels (forward and backward, at any D <= 128); with ``pc_gauss`` it
is the anisotropic splat renderer (``render/gsplat.py``), whose
``gsplat_impl: pallas`` runs the CUDA kernels of ``render/aniso.py``.
With ``train=True`` and ``pc_point_dropout < 1`` the points carry Bernoulli
keep weights drawn from the ``generator`` passed in, where the reference
takes a ``jax.random`` key.

Masks, depths and target images stored at another resolution than
``vox_size`` are resized at loss time as the reference resizes them with
``jax.image.resize``: masks and images bilinearly with antialiasing
(``F.interpolate(mode="bilinear", antialias=True)``), depths to the
nearest sample (``mode="nearest-exact"``; plain "nearest" picks other
samples). Not ported yet, and refused: predicted pose.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dpcx_torch.config import Config
from dpcx_torch.render.gsplat import gsplat_project
from dpcx_torch.render.project import (
    keep_prob_schedule,
    pointcloud_project_fn,
    sigma_schedule,
)
from dpcx_torch.render.voxelize import pc_point_dropout_weights


def _masked_depth_loss(
    depth: torch.Tensor, gt_depth: torch.Tensor, gt_mask: torch.Tensor
) -> torch.Tensor:
    """L2 on depth inside the GT silhouette (per-sample mean)."""
    se = gt_mask * (depth - gt_depth) ** 2
    return se.sum(dim=(-2, -1)) / gt_mask.sum(dim=(-2, -1)).clamp_min(1.0)


def _resize(x: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """[..., S, S] images to [..., size, size], each plane on its own;
    ``mode`` "bilinear" (antialiased) or "nearest-exact"."""
    lead = x.shape[:-2]
    kw = dict(antialias=True, align_corners=False) if mode == "bilinear" \
        else {}
    out = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=(size, size),
                        mode=mode, **kw)
    return out.reshape(*lead, size, size)


def compute_loss(
    cfg: Config,
    preds: dict[str, torch.Tensor],
    batch: dict[str, torch.Tensor],
    step,
    generator: torch.Generator | None = None,
    train: bool = True,
    density_fn=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss + metrics dict.

    batch: masks [B, V, S, S], depths [B, V, S, S] (with depth), quats
    [B, V, 4], images_tgt [B, V, H, H, 3] (with rgb). ``generator`` (on
    the points' device) draws the point dropout weights; it is needed only
    when ``train`` and ``pc_point_dropout < 1``. ``density_fn`` goes to
    ``gsplat_project`` (None: the kernels' dispatcher).
    """
    if cfg.predict_pose:
        raise NotImplementedError("predicted-pose loss is not ported yet")
    points = preds["points"]  # [B, N, 3]
    B = points.shape[0]
    masks = batch["masks"]
    V = masks.shape[1]
    D = cfg.vox_size
    # external datasets may store masks/depths at another resolution than
    # the projection grid: resized here, so any mask size trains at any D
    if masks.shape[-1] != D:
        masks = _resize(masks, D, "bilinear")
    depths = batch.get("depths")
    if cfg.proj_depth and depths is not None and depths.shape[-1] != D:
        # nearest: bilinear would blend background depth into silhouette
        # boundary pixels and corrupt the masked depth loss
        depths = _resize(depths, D, "nearest-exact")
    sigma_rel = sigma_schedule(cfg, step).to(points.device)
    point_weights = None
    if train and cfg.pc_point_dropout < 1.0:
        if generator is None:
            raise ValueError("point dropout needs a torch.Generator")
        keep = keep_prob_schedule(cfg, step)
        point_weights = pc_point_dropout_weights(
            generator, B, points.shape[1], keep
        )
    metrics: dict[str, torch.Tensor] = {"sigma_rel": sigma_rel}

    # render B*V views in one batched call
    pts = points.repeat_interleave(V, dim=0)  # [B*V, N, 3]
    pw = (None if point_weights is None
          else point_weights.repeat_interleave(V, dim=0))
    quats = batch["quats"].reshape(B * V, 4)
    rgb = None
    if cfg.pc_rgb and "rgb" in preds:
        rgb = preds["rgb"].repeat_interleave(V, dim=0)
    if cfg.pc_gauss and "gauss_scales" in preds:
        # anisotropic alpha-composited splats; dropout folds into opacity
        opacity = preds["gauss_opacity"].repeat_interleave(V, dim=0)
        if pw is not None:
            opacity = opacity * pw
        out = gsplat_project(
            cfg, pts, quats,
            preds["gauss_scales"].repeat_interleave(V, dim=0),
            preds["gauss_rot"].repeat_interleave(V, dim=0),
            opacity=opacity, rgb=rgb, density_fn=density_fn,
        )
    else:
        out = pointcloud_project_fn(cfg, pts, quats, sigma_rel,
                                    point_weights=pw, rgb=rgb)
    sil, depth, rgb_proj = out.silhouette.reshape(B, V, D, D), out.depth, \
        out.rgb
    proj_loss = torch.mean((sil - masks) ** 2)
    total = cfg.proj_weight * proj_loss
    metrics["loss_proj"] = proj_loss
    if rgb_proj is not None and "images_tgt" in batch:
        # colour re-projection inside the GT silhouette against the target
        # view, resized to the mask resolution. The targets are
        # background-composited renders, so the background is composited
        # into the prediction first
        tgt = batch["images_tgt"]
        if tgt.shape[-2] != D:
            tgt = _resize(tgt.movedim(-1, -3), D, "bilinear").movedim(-3, -1)
        rgb_proj = rgb_proj.reshape(B, V, D, D, 3)
        rgb_proj = rgb_proj + (1.0 - sil[..., None]) * cfg.rgb_background
        w = masks[..., None]
        rgb_loss = torch.sum(w * (rgb_proj - tgt) ** 2) / (
            torch.sum(w) * 3.0).clamp_min(1.0)
        total = total + cfg.rgb_weight * rgb_loss
        metrics["loss_rgb"] = rgb_loss
    if cfg.proj_depth and cfg.drc_weight > 0:
        depth = depth.reshape(B, V, D, D)
        d_loss = torch.mean(_masked_depth_loss(depth, depths, masks))
        total = total + cfg.drc_weight * d_loss
        metrics["loss_depth"] = d_loss
    # IoU diagnostic on the first target view
    pred_m = sil[:, 0] > 0.4
    gt_m = masks[:, 0] > 0.5
    inter = (pred_m & gt_m).sum(dim=(-2, -1))
    union = (pred_m | gt_m).sum(dim=(-2, -1)).clamp_min(1)
    metrics["iou"] = torch.mean(inter / union)

    if cfg.predict_scale and cfg.scale_weight > 0 and "scale" in preds:
        s_loss = torch.mean((preds["scale"] - 0.7) ** 2)
        total = total + cfg.scale_weight * s_loss
        metrics["loss_scale"] = s_loss

    metrics["loss_total"] = total
    return total, metrics
