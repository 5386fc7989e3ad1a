"""Stage 1: pose + perspective transform (port of ``dpcx/render/transform.py``).

  x_ndc = x_cam * f / z_full      (z_full = z_cam + camera_distance)
  y_ndc = y_cam * f / z_full
  z_ndc = z_cam
"""

from __future__ import annotations

import torch

from dpcx_torch.geometry.quaternion import (
    quaternion_rotate,
    quaternion_to_matrix,
)

# the default camera of the port's transforms and fused renderer (dpcx's)
FOCAL_LENGTH = 1.875
CAMERA_DISTANCE = 2.0


def pc_perspective_transform(
    points: torch.Tensor,
    quat: torch.Tensor,
    focal_length: float = FOCAL_LENGTH,
    camera_distance: float = CAMERA_DISTANCE,
    translation: torch.Tensor | None = None,
) -> torch.Tensor:
    """World points [..., N, 3] + camera quats [..., 4] -> NDC [..., N, 3]."""
    p = quaternion_rotate(points, quat)
    if translation is not None:
        p = p + translation[..., None, :]
    x, y, z = p.unbind(-1)
    # guard the divide against a wild predicted translation
    z_safe = (z + camera_distance).clamp_min(1e-2)
    return torch.stack(
        [x * focal_length / z_safe, y * focal_length / z_safe, z], dim=-1
    )


def pc_perspective_transform_t(
    points: torch.Tensor,
    quat: torch.Tensor,
    focal_length: float = FOCAL_LENGTH,
    camera_distance: float = CAMERA_DISTANCE,
    translation: torch.Tensor | None = None,
) -> torch.Tensor:
    """Same math, CHANNEL-MAJOR output: points [..., N, 3] -> NDC [..., 3, N]
    (rows x, y, z_ndc), the layout ``fused_project_t`` takes.

    On the card the fused renderer has one route, and it runs this
    transform inside its splat stages
    (``render/fused.py::fused_project_world``, world clouds and cameras
    in): no kernel takes these NDC coordinates. These ops remain the CPU
    route of that entry, the route of ``pointcloud_project_fn`` when a
    ``project_fn`` is handed in (the kernel-vs-plain checks), and the
    composition the card's tests hold the kernels to."""
    return pc_perspective_transform_rot_t(
        points, quaternion_to_matrix(quat), focal_length, camera_distance,
        translation)


def pc_perspective_transform_rot_t(
    points: torch.Tensor,
    rot: torch.Tensor,
    focal_length: float = FOCAL_LENGTH,
    camera_distance: float = CAMERA_DISTANCE,
    translation: torch.Tensor | None = None,
) -> torch.Tensor:
    """``pc_perspective_transform_t`` from rotation matrices rot [..., 3, 3]
    (p_cam = rot p + translation) instead of quaternions."""
    # out[j, n] = sum_i R[j, i] * p[n, i]
    p = rot @ points.transpose(-1, -2)
    if translation is not None:
        p = p + translation[..., :, None]
    x, y, z = p.unbind(-2)
    z_safe = (z + camera_distance).clamp_min(1e-2)
    return torch.stack(
        [x * focal_length / z_safe, y * focal_length / z_safe, z], dim=-2
    )
