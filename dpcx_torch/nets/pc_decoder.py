"""Point-cloud decoder: FC stack -> N x 3 points, optional per-point RGB,
optional anisotropic Gaussian splat heads, optional global scale (port of
``dpcx/nets/pc_decoder.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dpcx_torch.nets.layers import Dense


class PointCloudDecoder(nn.Module):
    def __init__(
        self,
        latent_dim: int = 1024,
        num_points: int = 8000,
        hidden: tuple[int, ...] = (1024, 1024, 1024),
        predict_rgb: bool = False,
        predict_scale: bool = True,
        predict_gauss: bool = False,
        gauss_scale_min: float = 0.005,
        gauss_scale_max: float = 0.06,
        compute_dtype=torch.bfloat16,
        device=None,
    ):
        super().__init__()
        self.num_points = num_points
        self.num_hidden = len(hidden)
        width = latent_dim
        for i, h in enumerate(hidden):
            setattr(self, f"fc{i}",
                    Dense(width, h, compute_dtype, device))
            width = h
        self.fc_points = Dense(width, num_points * 3, compute_dtype, device)
        self.fc_rgb = (
            Dense(width, num_points * 3, compute_dtype, device)
            if predict_rgb else None
        )
        # per-point stddevs (sigmoid-bounded, NDC units), local orientation
        # (identity-biased quaternion) and opacity
        self.fc_gauss = (
            Dense(width, num_points * 8, compute_dtype, device)
            if predict_gauss else None
        )
        self.gauss_scale_min = gauss_scale_min
        self.gauss_scale_max = gauss_scale_max
        self.fc_scale = (
            Dense(width, 1, compute_dtype, device)
            if predict_scale else None
        )

    def forward(self, latent: torch.Tensor) -> dict[str, torch.Tensor]:
        """latent [B, L] -> {"points": [B, N, 3], "rgb"?, "scale"?,
        "gauss_scales"?, "gauss_rot"?, "gauss_opacity"?}."""
        x = latent
        for i in range(self.num_hidden):
            x = F.leaky_relu(getattr(self, f"fc{i}")(x), 0.2)
        B, N = x.shape[0], self.num_points
        raw = self.fc_points(x)
        out = {"points": 0.5 * torch.tanh(raw.float()).reshape(B, N, 3)}
        if self.fc_rgb is not None:
            out["rgb"] = torch.sigmoid(self.fc_rgb(x).float()).reshape(B, N, 3)
        if self.fc_gauss is not None:
            g = self.fc_gauss(x).float().reshape(B, N, 8)
            lo, hi = self.gauss_scale_min, self.gauss_scale_max
            out["gauss_scales"] = lo + (hi - lo) * torch.sigmoid(g[..., 0:3])
            rot = g[..., 3:7] * 0.1 + g.new_tensor([1.0, 0.0, 0.0, 0.0])
            out["gauss_rot"] = rot / torch.linalg.vector_norm(
                rot, dim=-1, keepdim=True)
            out["gauss_opacity"] = torch.sigmoid(g[..., 7])
        if self.fc_scale is not None:
            out["scale"] = torch.sigmoid(self.fc_scale(x).float())
        return out
