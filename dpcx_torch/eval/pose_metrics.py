"""Pose accuracy metrics and the canonical-frame alignment (port of
``dpcx/eval/pose_metrics.py``).

The angular error between predicted and GT camera rotations gives
accuracy@30deg and the median error. An unsupervised pose is defined only
up to a global rotation of the object frame, so ``align_canonical_frame``
estimates that rotation first: a quasi-uniform grid of rotations, then a
local re-search around the best.
"""

from __future__ import annotations

import math

import torch

from dpcx_torch.geometry.quaternion import (
    quaternion_angular_distance,
    quaternion_conjugate,
    quaternion_multiply,
    quaternion_normalize,
)


def gauge_spread_deg(
    pred_quats: torch.Tensor, cam_quats: torch.Tensor
) -> torch.Tensor:
    """Per-model cross-view gauge-coherence dispersion, in degrees.

    ``pred_quats``/``cam_quats`` are ``[V, M, 4]``: the predicted
    object->camera quaternion and the known camera-rig quaternion of view v
    of model m. A gauge-coherent predictor has ``pred[v, m] = cam[v, m] o
    g[m]``, so the residual ``conj(cam) o pred`` is constant over v and its
    dispersion needs no object-pose annotation. Returns the ``[M]`` mean
    angular distance of each model's residuals to their chordal mean.

    As dpcx, each residual takes the sign of view 0's (a per-pair dot): at
    large spreads (dot ~ 0) that choice is arbitrary and the chordal mean
    can nearly cancel, so the number is noisy there (dpcx's too).
    """
    r = quaternion_multiply(quaternion_conjugate(cam_quats), pred_quats)
    # sign coherence per model: q and -q are one rotation
    sign = torch.where((r * r[:1]).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    r = r * sign
    m = quaternion_normalize(r.mean(0))
    dist = quaternion_angular_distance(r, m[None]).mean(0)
    return dist * (180.0 / math.pi)


def _median(x: torch.Tensor) -> torch.Tensor:
    """The median as ``jnp.median`` takes it: the mean of the two middle
    values of an even count (``torch.median`` returns the lower one)."""
    s = torch.sort(x.flatten()).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) / 2.0


def pose_error_metrics(
    pred_quats: torch.Tensor, gt_quats: torch.Tensor
) -> dict[str, torch.Tensor]:
    """pred/gt [M, 4] -> angular errors (deg), accuracy@30deg, median."""
    deg = quaternion_angular_distance(pred_quats, gt_quats) * 180.0 / math.pi
    return {
        "angular_err_deg": deg,
        "acc_30deg": (deg <= 30.0).float().mean(),
        "median_err_deg": _median(deg),
    }


# pi about the object's vertical (y) axis, (w, x, y, z): the azimuth mirror
# mode that dominates unsupervised-pose errors on near-symmetric categories
FLIP_QUAT = torch.tensor([0.0, 0.0, 1.0, 0.0])


def pose_error_metrics_up_to_flip(
    aligned_pred: torch.Tensor, gt_quats: torch.Tensor
) -> dict[str, torch.Tensor]:
    """:func:`pose_error_metrics` where each sample may also compose the
    180-degree vertical-axis flip on the object side (``aligned_pred`` is
    already in the GT canonical frame, as :func:`align_canonical_frame`
    returns it). A category whose plain acc@30 is ~0.5 and flip-aware acc
    ~1.0 is mirror-limited, not noisy. ``flip_rate`` is the fraction of
    samples the flip helps."""
    e0 = quaternion_angular_distance(aligned_pred, gt_quats)
    flipped = quaternion_multiply(aligned_pred, FLIP_QUAT.to(aligned_pred))
    e1 = quaternion_angular_distance(flipped, gt_quats)
    deg = torch.minimum(e0, e1) * 180.0 / math.pi
    return {
        "acc_30deg_up_to_flip": (deg <= 30.0).float().mean(),
        "median_err_deg_up_to_flip": _median(deg),
        "flip_rate": (e1 < e0).float().mean(),
    }


def _rotation_grid(n: int = 512, device=None) -> torch.Tensor:
    """Quasi-uniform grid of n unit quaternions (a super-Fibonacci-like
    spiral)."""
    i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    s = i / n
    t = i / 1.61803398875  # golden ratio spiral
    u = i / 2.41421356237
    a, b = torch.sqrt(1.0 - s), torch.sqrt(s)
    return quaternion_normalize(torch.stack([
        a * torch.sin(2 * math.pi * t),
        a * torch.cos(2 * math.pi * t),
        b * torch.sin(2 * math.pi * u),
        b * torch.cos(2 * math.pi * u),
    ], dim=-1))


def _axis_sphere(n: int, device=None) -> torch.Tensor:
    """n quasi-uniform unit axes (Fibonacci sphere)."""
    i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    phi = 2.0 * math.pi * i / 1.61803398875
    cos_t = 1.0 - 2.0 * i / n
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, min=0.0))
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def align_canonical_frame(
    pred_quats: torch.Tensor,
    gt_quats: torch.Tensor,
    grid_size: int = 2048,
    refine_iters: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The global q_align that minimises the mean angular error of
    ``pred * q_align`` against gt [M, 4]. Returns (q_align,
    aligned_pred_quats).

    The predicted pose maps object -> camera, so the unknown canonical
    offset composes on the object side (on the right). Two stages: a
    coarse quasi-uniform SO(3) grid, then ``refine_iters`` rounds over the
    incumbent and 48 Fibonacci axes x 2 magnitudes around it, the angular
    scale shrinking 0.35x a round. Every candidate's error is one row of a
    [candidates, M] tensor; ``argmin`` takes the first minimum, as dpcx's.
    """
    device = pred_quats.device

    def mean_errs(cands: torch.Tensor) -> torch.Tensor:
        aligned = quaternion_multiply(pred_quats[None], cands[:, None])
        return quaternion_angular_distance(aligned, gt_quats[None]).mean(-1)

    grid = _rotation_grid(grid_size, device)  # [G, 4]
    best = grid[torch.argmin(mean_errs(grid))]

    axes = _axis_sphere(48, device)  # [A, 3]
    scale = 0.25  # rad, about the 2048-grid's covering radius
    for _ in range(refine_iters):
        half = torch.tensor([scale, 0.5 * scale],
                            device=device)[:, None, None] / 2.0
        delta = torch.cat([
            torch.cos(half).expand(2, axes.shape[0], 1),
            torch.sin(half) * axes[None],
        ], dim=-1).reshape(-1, 4)  # [2A, 4] small rotations
        cands = torch.cat([best[None], quaternion_multiply(best[None], delta)])
        best = cands[torch.argmin(mean_errs(cands))]
        scale *= 0.35

    return best, quaternion_multiply(pred_quats, best[None])
