"""GT-pose loss forward (port of the ``not cfg.predict_pose`` branch of
``dpcx/models/losses.py::compute_loss``).

Every target view is rendered with its known camera; the loss is the
squared-L2 silhouette error, plus the masked depth error when the config
renders depth, plus the scale regulariser. With ``renderer: pallas`` the
render goes through the fused CUDA kernels (forward and backward, at any
D <= 128).
With ``train=True`` and ``pc_point_dropout < 1`` the points carry Bernoulli
keep weights drawn from the ``generator`` passed in, where the reference
takes a ``jax.random`` key. Not ported yet, and refused: predicted pose,
rgb and gauss splats, and masks or depths stored at another resolution
than ``vox_size`` (the reference resizes them with ``jax.image.resize``,
which antialiases).
"""

from __future__ import annotations

import torch

from dpcx_torch.config import Config
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


def compute_loss(
    cfg: Config,
    preds: dict[str, torch.Tensor],
    batch: dict[str, torch.Tensor],
    step,
    generator: torch.Generator | None = None,
    train: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss + metrics dict.

    batch: masks [B, V, D, D], depths [B, V, D, D] (with depth), quats
    [B, V, 4]. ``generator`` (on the points' device) draws the point
    dropout weights; it is needed only when ``train`` and
    ``pc_point_dropout < 1``.
    """
    if cfg.predict_pose:
        raise NotImplementedError("predicted-pose loss is not ported yet")
    if cfg.pc_gauss or (cfg.pc_rgb and "rgb" in preds):
        raise NotImplementedError("rgb / gauss-splat losses are not ported yet")
    points = preds["points"]  # [B, N, 3]
    B = points.shape[0]
    masks = batch["masks"]
    V = masks.shape[1]
    D = cfg.vox_size
    if masks.shape[-1] != D or (
        cfg.proj_depth and "depths" in batch
        and batch["depths"].shape[-1] != D
    ):
        raise NotImplementedError(
            f"masks/depths at another size than vox_size={D}: the "
            "loss-time resize is not ported yet"
        )
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
    out = pointcloud_project_fn(cfg, pts, quats, sigma_rel, point_weights=pw)
    sil, depth = out.silhouette.reshape(B, V, D, D), out.depth
    proj_loss = torch.mean((sil - masks) ** 2)
    total = cfg.proj_weight * proj_loss
    metrics["loss_proj"] = proj_loss
    if cfg.proj_depth and cfg.drc_weight > 0:
        depth = depth.reshape(B, V, D, D)
        d_loss = torch.mean(_masked_depth_loss(depth, batch["depths"], masks))
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
