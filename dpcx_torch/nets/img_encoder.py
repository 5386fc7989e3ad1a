"""Image encoder: strided convnet -> latent (port of
``dpcx/nets/img_encoder.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dpcx_torch.nets.layers import Conv3x3s2, Dense


class ImageEncoder(nn.Module):
    def __init__(
        self,
        image_size: int = 128,
        filters: tuple[int, ...] = (32, 64, 96, 128, 192),
        latent_dim: int = 1024,
        fc_hidden: int = 1024,
        compute_dtype=torch.bfloat16,
        device=None,
    ):
        super().__init__()
        self.num_convs = len(filters)
        size, ch = image_size, 3
        for i, f in enumerate(filters):
            setattr(self, f"conv{i}",
                    Conv3x3s2(ch, f, compute_dtype, device))
            size, ch = -(-size // 2), f
        # fc1 reads the NHWC-flattened feature map, as flax flattens it
        self.fc1 = Dense(size * size * ch, fc_hidden, compute_dtype, device)
        self.fc_latent = Dense(fc_hidden, latent_dim, compute_dtype, device)
        # the pose branch's input layer exists in every config, as in flax
        self.fc_pose = Dense(fc_hidden, fc_hidden, compute_dtype, device)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """images [B, H, W, 3] -> {"latent": [B, L], "pose_inp": [B, F]}."""
        x = images.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        feat = F.leaky_relu(self.fc1(x), 0.2)
        latent = self.fc_latent(feat)
        pose_inp = F.leaky_relu(self.fc_pose(feat), 0.2)
        return {"latent": latent.float(), "pose_inp": pose_inp.float()}
