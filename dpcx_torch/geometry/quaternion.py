"""Quaternion math on tensors (port of ``dpcx/geometry/quaternion.py``).

Conventions as in the reference: component order ``(w, x, y, z)``; unit
quaternions are ACTIVE rotations, ``rotate(p, q) == R(q) @ p``.
"""

from __future__ import annotations

import math

import torch


def quaternion_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize to unit quaternion along the last axis."""
    norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / norm.clamp_min(eps)


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (w, -x, -y, -z). Inverse for unit quaternions.
    Made on ``q``'s device (a host constant would be a copy that
    synchronises a card's stream)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2; composes rotations: R(q1*q2) = R(q1)R(q2)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3] (active)."""
    q = quaternion_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_rotate(points: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., N, 3] by quaternions [..., 4]: ``p @ R(q)^T``."""
    return points @ quaternion_to_matrix(q).transpose(-1, -2)


def quaternion_from_axis_angle(
    axis: torch.Tensor, angle: torch.Tensor
) -> torch.Tensor:
    """Unit axis [..., 3] + angle [...] (radians) -> quaternion [..., 4]."""
    axis = axis / torch.linalg.vector_norm(
        axis, dim=-1, keepdim=True
    ).clamp_min(1e-12)
    half = angle[..., None] * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quaternion_angular_distance(
    q1: torch.Tensor, q2: torch.Tensor
) -> torch.Tensor:
    """Angular distance in radians between rotations, in [0, pi].

    Sign-invariant (q and -q are the same rotation).
    """
    q1 = quaternion_normalize(q1)
    q2 = quaternion_normalize(q2)
    dot = torch.abs(torch.sum(q1 * q2, dim=-1))
    return 2.0 * torch.arccos(dot.clamp(0.0, 1.0))


def random_quaternion(
    generator: torch.Generator,
    shape: tuple = (),
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Uniform random rotations (Shoemake): shape + (4,), unit norm.

    Draws from ``generator``, which must live on ``device``; the stream
    differs from ``jax.random``, so tests compare distributions.
    """
    u1, u2, u3 = torch.rand(
        (3,) + tuple(shape), generator=generator, device=device
    )
    a, b = torch.sqrt(1.0 - u1), torch.sqrt(u1)
    t2, t3 = 2.0 * math.pi * u2, 2.0 * math.pi * u3
    return torch.stack(
        [b * torch.cos(t3), a * torch.sin(t2), a * torch.cos(t2),
         b * torch.sin(t3)],
        dim=-1,
    )
