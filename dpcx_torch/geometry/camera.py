"""Camera model: view angles -> quaternion, look-at frames, intrinsics
(port of ``dpcx/geometry/camera.py``).

Conventions as in the reference: world y-up; a camera at (azimuth,
elevation) on a sphere of radius ``camera_distance`` looks at the origin
(azimuth 0, elevation 0 is on +z); the extrinsic quaternion maps world ->
camera; the camera frame is right-handed CV (+x right, +y down, +z into
the scene).
"""

from __future__ import annotations

import torch

from dpcx_torch.geometry.quaternion import quaternion_normalize


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w,x,y,z).

    Branchless: all four candidate solutions (one per largest component),
    selected by trace comparisons.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def _stack(a, b, c, d):
        return torch.stack([a, b, c, d], dim=-1)

    def _root(x):
        return torch.sqrt(x.clamp_min(1e-12)) * 2.0

    tr = m00 + m11 + m22
    sw = _root(1.0 + tr)
    qw = _stack(0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                (m10 - m01) / sw)
    sx = _root(1.0 + m00 - m11 - m22)
    qx = _stack((m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                (m02 + m20) / sx)
    sy = _root(1.0 - m00 + m11 - m22)
    qy = _stack((m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                (m12 + m21) / sy)
    sz = _root(1.0 - m00 - m11 + m22)
    qz = _stack((m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz,
                0.25 * sz)

    use_w = (tr > 0.0)[..., None]
    use_x = ((m00 >= m11) & (m00 >= m22))[..., None]
    use_y = (m11 >= m22)[..., None]
    q = torch.where(use_w, qw,
                    torch.where(use_x, qx, torch.where(use_y, qy, qz)))
    return quaternion_normalize(q)


def look_at_quaternion(
    camera_pos: torch.Tensor, up: torch.Tensor | None = None
) -> torch.Tensor:
    """World->camera quaternion for a camera at ``camera_pos`` [..., 3]
    looking at the origin: z_cam = -normalize(pos) (forward), x_cam =
    normalize(z_cam x up) (right), y_cam = z_cam x x_cam (down)."""
    if up is None:
        up = camera_pos.new_tensor([0.0, 1.0, 0.0]).expand_as(camera_pos)
    fwd = -camera_pos / torch.linalg.vector_norm(
        camera_pos, dim=-1, keepdim=True
    ).clamp_min(1e-12)
    right = torch.linalg.cross(fwd, up, dim=-1)
    right = right / torch.linalg.vector_norm(
        right, dim=-1, keepdim=True
    ).clamp_min(1e-12)
    down = torch.linalg.cross(fwd, right, dim=-1)
    # rows of the world->camera matrix are the camera basis in world
    return matrix_to_quaternion(torch.stack([right, down, fwd], dim=-2))


def camera_from_view_angles(
    azimuth, elevation, distance: float | torch.Tensor = 2.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(azimuth, elevation) [radians, broadcastable] -> (quaternion,
    position)."""
    azimuth = torch.as_tensor(azimuth, dtype=torch.float32)
    elevation = torch.as_tensor(elevation, dtype=torch.float32,
                                device=azimuth.device)
    ce = torch.cos(elevation)
    pos = torch.stack(
        [ce * torch.sin(azimuth), torch.sin(elevation),
         ce * torch.cos(azimuth)],
        dim=-1,
    ) * torch.as_tensor(distance, dtype=torch.float32,
                        device=azimuth.device)[..., None]
    return look_at_quaternion(pos), pos


def intrinsics_matrix(
    focal_length: float, image_size: int, dtype=torch.float32
) -> torch.Tensor:
    """Pinhole intrinsics for a unit-sensor camera: NDC in [-0.5, 0.5] maps
    to pixel coordinates [0, image_size)."""
    f = focal_length * image_size
    c = (image_size - 1) / 2.0
    return torch.tensor([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]],
                        dtype=dtype)
