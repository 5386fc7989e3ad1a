"""Pose metrics (port of ``gauge_spread_deg`` from
``dpcx/eval/pose_metrics.py``; the rest of that module is eval's, ROADMAP
queue 1 item 1)."""

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
