"""Model assembly: encoder -> points, scale, rgb and the gauss splat heads
(port of ``dpcx/models/model_pc.py``; the pose head and ``pose_only`` come
with predicted pose)."""

from __future__ import annotations

import torch
from torch import nn

from dpcx_torch.config import Config
from dpcx_torch.nets.net_factory import get_network


class ModelPointCloud(nn.Module):
    """Parameters are drawn from ``generator`` (a ``torch.Generator`` on
    ``device``), or from one seeded with ``cfg.seed`` when none is given."""

    def __init__(self, cfg: Config, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.predict_pose:
            raise NotImplementedError("predicted pose is not ported yet")
        self.cfg = cfg
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(cfg.seed)
        dtype = getattr(torch, cfg.compute_dtype)
        self.encoder = get_network("img_encoder")(
            image_size=cfg.image_size,
            filters=cfg.encoder_filters,
            latent_dim=cfg.latent_dim,
            fc_hidden=cfg.fc_hidden,
            compute_dtype=dtype,
            generator=generator,
            device=device,
        )
        self.decoder = get_network("pc_decoder")(
            latent_dim=cfg.latent_dim,
            num_points=cfg.pc_num_points,
            hidden=cfg.pc_decoder_hidden,
            predict_rgb=cfg.pc_rgb,
            predict_scale=cfg.predict_scale,
            predict_gauss=cfg.pc_gauss,
            gauss_scale_min=cfg.gauss_scale_min,
            gauss_scale_max=cfg.gauss_scale_max,
            compute_dtype=dtype,
            generator=generator,
            device=device,
        )

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """images [B, H, W, 3] -> {"points": [B, N, 3], "scale"?: [B, 1],
        "rgb"?: [B, N, 3], "gauss_scales"?: [B, N, 3], "gauss_rot"?:
        [B, N, 4], "gauss_opacity"?: [B, N]} (points already scaled when the
        config predicts a scale)."""
        dec = self.decoder(self.encoder(images)["latent"])
        points = dec["points"]
        out: dict[str, torch.Tensor] = {}
        if "scale" in dec:
            # global scale in (0, 1], biased toward 1 at init
            scale = 0.4 + 0.6 * dec["scale"]
            points = points * scale[..., None]
            out["scale"] = scale
        out["points"] = points
        for k in ("rgb", "gauss_scales", "gauss_rot", "gauss_opacity"):
            if k in dec:
                out[k] = dec[k]
        return out
