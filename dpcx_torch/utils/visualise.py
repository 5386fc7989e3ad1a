"""Visualisation helpers (port of ``dpcx/utils/visualise.py``): render
predicted clouds to depth-shaded images with the port's renderer, and a
stdlib PNG grid writer for summaries."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from dpcx_torch.config import Config
from dpcx_torch.geometry.camera import camera_from_view_angles
from dpcx_torch.render.project import pointcloud_project


def render_cloud_image(
    cfg: Config,
    points: torch.Tensor,
    azimuth: float = 0.7,
    elevation: float = 0.4,
) -> np.ndarray:
    """points [N, 3] -> depth-shaded grayscale image [D, D] in [0, 1]."""
    quat, _ = camera_from_view_angles(azimuth, elevation,
                                      cfg.camera_distance)
    out = pointcloud_project(
        cfg.replace(proj_depth=True, renderer="xla"),
        points[None],
        quat[None].to(points.device),
        torch.tensor(1.5 / cfg.vox_size),
    )
    sil = out.silhouette[0].detach().cpu().numpy()
    depth = out.depth[0].detach().cpu().numpy()
    mask = sil > 0.3
    return np.where(mask, np.clip(1.25 - (depth + 0.5), 0.0, 1.0), 0.0)


def save_image_grid(
    images: list[np.ndarray], path: str | Path, cols: int = 4
) -> None:
    """Tile grayscale images into a grid and write a PNG (pure-python PNG
    writer; no imaging dependency)."""
    n = len(images)
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    h, w = images[0].shape
    canvas = np.zeros((rows * h, cols * w), dtype=np.float32)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * h : (r + 1) * h, c * w : (c + 1) * w] = im
    img8 = (np.clip(canvas, 0, 1) * 255).astype(np.uint8)

    height, width = img8.shape
    raw = b"".join(
        b"\x00" + img8[row].tobytes() for row in range(height)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(
            b"IHDR",
            struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0),
        )
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(png)
