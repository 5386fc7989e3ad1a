"""Evaluation: Chamfer distance, voxel IoU, pose metrics and the canonical
alignment (port of ``dpcx/eval/``)."""

from dpcx_torch.eval.chamfer import chamfer_distance, directed_distance
from dpcx_torch.eval.iou import voxel_iou
from dpcx_torch.eval.pose_metrics import (
    align_canonical_frame,
    pose_error_metrics,
)

__all__ = [
    "chamfer_distance",
    "directed_distance",
    "voxel_iou",
    "pose_error_metrics",
    "align_canonical_frame",
]
