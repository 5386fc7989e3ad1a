"""Model assembly: encoder -> points, scale, rgb and the gauss splat heads,
and with ``predict_pose`` the pose head (port of
``dpcx/models/model_pc.py``)."""

from __future__ import annotations

import torch
from torch import nn

from dpcx_torch.config import Config
from dpcx_torch.nets.layers import flax_init_
from dpcx_torch.nets.net_factory import get_network


class ModelPointCloud(nn.Module):
    """Parameters are dpcx's init, ``model.init(PRNGKey(seed))`` with
    ``seed`` (``cfg.seed`` when None) through ``nets.layers.flax_init_``,
    the same on every device."""

    def __init__(self, cfg: Config, device=None, seed: int | None = None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        self.encoder = get_network("img_encoder")(
            image_size=cfg.image_size,
            filters=cfg.encoder_filters,
            latent_dim=cfg.latent_dim,
            fc_hidden=cfg.fc_hidden,
            compute_dtype=dtype,
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
            device=device,
        )
        self.pose_head = (
            get_network("pose_head")(
                features_in=cfg.fc_hidden,
                num_candidates=cfg.pose_predict_num_candidates,
                with_student=cfg.pose_student,
                predict_translation=cfg.predict_translation,
                candidate_offsets=cfg.pose_candidate_offsets,
                compute_dtype=dtype,
                device=device,
            )
            if cfg.predict_pose else None
        )
        flax_init_(self, cfg.seed if seed is None else seed)

    def forward(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """images [B, H, W, 3] -> {"points": [B, N, 3], "scale"?: [B, 1],
        "rgb"?: [B, N, 3], "gauss_scales"?: [B, N, 3], "gauss_rot"?:
        [B, N, 4], "gauss_opacity"?: [B, N]} (points already scaled when the
        config predicts a scale), and with ``predict_pose`` the pose head's
        outputs (``PoseHead.forward``)."""
        enc = self.encoder(images)
        dec = self.decoder(enc["latent"])
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
        if self.pose_head is not None:
            out.update(self.pose_head(enc["pose_inp"]))
        return out

    def pose_only(self, images: torch.Tensor) -> dict[str, torch.Tensor]:
        """The encoder and the pose head only: images [M, H, W, 3] ->
        ``PoseHead.forward``'s outputs. ``pose_from_views`` predicts each
        target view's pose from its own image with it; the decoder (most
        of the parameters) runs once, on the input view."""
        return self.pose_head(self.encoder(images)["pose_inp"])
