"""Pose heads: K-candidate quaternion ensemble + student quaternion (port of
``dpcx/nets/pose.py``).

FC (leaky ReLU 0.2) -> K x 4 candidate quaternions, identity-biased and
normalised (``correction_quats``), each composed on the right with a fixed
azimuth offset theta_k = 2 pi k / K about the vertical (y) axis
(``quats``); a student quaternion distilled from the winning candidate;
optionally a per-candidate camera-frame translation 0.2 tanh(.). Candidate
selection and the student loss live in ``models/losses.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dpcx_torch.geometry.quaternion import (
    quaternion_multiply,
    quaternion_normalize,
)
from dpcx_torch.nets.layers import Dense


def _plus_identity(q: torch.Tensor) -> torch.Tensor:
    """``q + (1, 0, 0, 0)`` over the last axis, made on ``q``'s device: a
    constant built on the host would reach a card through a copy that
    synchronises the stream."""
    return torch.cat([q[..., :1] + 1.0, q[..., 1:]], dim=-1)


class PoseHead(nn.Module):
    def __init__(
        self,
        features_in: int = 1024,
        num_candidates: int = 4,
        with_student: bool = True,
        hidden: int = 256,
        predict_translation: bool = False,
        candidate_offsets: bool = True,
        compute_dtype=torch.bfloat16,
        device=None,
    ):
        super().__init__()
        self.num_candidates = num_candidates
        self.candidate_offsets = candidate_offsets
        K = num_candidates
        self.fc0 = Dense(features_in, hidden, compute_dtype, device)
        self.fc_quats = Dense(hidden, K * 4, compute_dtype, device)
        # flax creates fc_student before fc_trans
        self.fc_student = (Dense(hidden, 4, compute_dtype, device)
                           if with_student else None)
        self.fc_trans = (Dense(hidden, K * 3, compute_dtype, device)
                         if predict_translation else None)

    def forward(self, pose_inp: torch.Tensor) -> dict[str, torch.Tensor]:
        """pose_inp [B, F] -> {"quats": [B, K, 4], "correction_quats":
        [B, K, 4], "student_quat"?: [B, 4], "translation"?: [B, K, 3]}."""
        x = F.leaky_relu(self.fc0(pose_inp), 0.2)
        B, K = x.shape[0], self.num_candidates
        quats = quaternion_normalize(
            _plus_identity(self.fc_quats(x).float().reshape(B, K, 4)))
        corrections = quats
        if self.candidate_offsets and K > 1:
            theta = 2.0 * math.pi * torch.arange(
                K, dtype=torch.float32, device=x.device) / K
            zeros = torch.zeros_like(theta)
            off = torch.stack([torch.cos(theta / 2), zeros,
                               torch.sin(theta / 2), zeros], dim=-1)
            quats = quaternion_multiply(quats, off)
        out = {"quats": quats, "correction_quats": corrections}
        if self.fc_student is not None:
            out["student_quat"] = quaternion_normalize(
                _plus_identity(self.fc_student(x).float()))
        if self.fc_trans is not None:
            out["translation"] = 0.2 * torch.tanh(
                self.fc_trans(x).float()).reshape(B, K, 3)
        return out
