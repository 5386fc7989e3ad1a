"""Volumetric 3D IoU between predicted and GT point clouds (port of
``dpcx/eval/iou.py``).

Occupancy is nearest-cell binary: a cell is occupied iff at least one point
rounds into it, with the renderer's grid mapping (``ndc_to_grid``). A mass
threshold would couple the metric to the point count. The resolution must
suit the point budget, since surface sampling floors the score of even a
perfect prediction; ``predict.evaluate`` reports D 16 (``iou_3d_16``), as
dpcx does.
"""

from __future__ import annotations

import torch

from dpcx_torch.render.voxelize import ndc_to_grid


def _occupancy(points: torch.Tensor, vox_size: int) -> torch.Tensor:
    """[B, N, 3] NDC points -> [B, D, D, D] bool nearest-cell occupancy.
    Out-of-grid points are dropped. ``torch.round`` rounds half to even,
    as ``jnp.round`` does."""
    B, N, _ = points.shape
    D = vox_size
    idx = torch.round(ndc_to_grid(points, D)).long()  # (z, y, x) cells
    valid = ((idx >= 0) & (idx < D)).all(-1)
    b = torch.arange(B, device=points.device)[:, None].expand(B, N)
    flat = ((b * D + idx[..., 0]) * D + idx[..., 1]) * D + idx[..., 2]
    occ = torch.zeros(B * D**3, dtype=torch.bool, device=points.device)
    occ[flat[valid]] = True  # the max of the valid points' hits
    return occ.reshape(B, D, D, D)


def voxel_iou(pred: torch.Tensor, gt: torch.Tensor,
              vox_size: int = 32) -> torch.Tensor:
    """[B] IoU of the nearest-cell occupancy grids at vox_size^3 of pred
    [B, N, 3] and gt [B, M, 3], both in the +-0.5 NDC box."""
    occ_p = _occupancy(pred, vox_size)
    occ_g = _occupancy(gt, vox_size)
    inter = (occ_p & occ_g).sum((1, 2, 3)).float()
    union = (occ_p | occ_g).sum((1, 2, 3)).float()
    return inter / union.clamp_min(1.0)
