"""Stage 2: trilinear scatter-splat into a D^3 grid (port of
``dpcx/render/voxelize.py``: the scatter oracle, its rgb path, point
dropout as per-point weights, and the dense isotropic RBF voxelizer).

Grid convention: ``grid[b, z, y, x]``. NDC p in [-0.5, 0.5] maps to grid
units g = (p + 0.5) * D - 0.5; cell i is centred at g = i.
"""

from __future__ import annotations

import math

import torch

from dpcx_torch.utils import prng


def ndc_to_grid(points_ndc: torch.Tensor, vox_size: int) -> torch.Tensor:
    """NDC [-0.5, 0.5] -> grid units, (x, y, z) -> (z, y, x) order."""
    g = (points_ndc + 0.5) * vox_size - 0.5
    return g.flip(-1)


def pc_point_dropout_weights(key, batch: int, num_points: int, keep_prob,
                             device="cpu") -> torch.Tensor:
    """Per-point Bernoulli keep weights [batch, num_points] on ``device``,
    rescaled by 1/keep_prob: dpcx's ``jax.random.bernoulli(key, keep_prob,
    (batch, num_points)) / max(keep_prob, 1e-6)`` bit for bit, ``key`` a
    ``utils.prng`` key and ``keep_prob`` dpcx's float32 keep-prob. The
    draw kernel on a CUDA device (``csrc/prng.cu``), its plain version on
    the CPU."""
    if prng.device_type(device) == "cpu":
        return prng.dropout_weights_plain(key, batch, num_points, keep_prob,
                                          device)
    return prng.launch_dropout_weights(key, batch, num_points, keep_prob,
                                       device)


def splat_raw(
    points_ndc: torch.Tensor,
    vox_size: int,
    point_weights: torch.Tensor | None = None,
    rgb: torch.Tensor | None = None,
    z_range: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The scatter-add splat before colour normalisation: points_ndc
    [B, N, 3] -> (density [B, Z, D, D], colour numerator [B, Z, D, D, 3] or
    None), of grid slabs ``z_range = (lo, hi)`` (default all D; slabs
    outside the grid stay 0).

    Each point adds its 8 trilinear corner weights (times its point weight)
    with ``index_add_`` on a flattened grid; out-of-grid corners and corners
    outside the slabs are dropped.
    """
    B, N, _ = points_ndc.shape
    D = vox_size
    lo, hi = (0, D) if z_range is None else z_range
    Z = hi - lo
    g = ndc_to_grid(points_ndc, D)  # [B, N, 3] in (z, y, x)
    i0 = torch.floor(g)
    frac = g - i0
    i0 = i0.to(torch.int64)
    base = torch.arange(B, device=g.device)[:, None] * (Z * D * D)  # [B, 1]

    grid = torch.zeros(B * Z * D * D, dtype=points_ndc.dtype,
                       device=g.device)
    rgb_grid = (
        None if rgb is None
        else torch.zeros(B * Z * D * D, 3, dtype=points_ndc.dtype,
                         device=g.device)
    )
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                wz = frac[..., 0] if dz else 1.0 - frac[..., 0]
                wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
                wx = frac[..., 2] if dx else 1.0 - frac[..., 2]
                w = wz * wy * wx
                if point_weights is not None:
                    w = w * point_weights
                iz = i0[..., 0] + dz
                iy = i0[..., 1] + dy
                ix = i0[..., 2] + dx
                # torch negative indices wrap like JAX's, so out-of-grid
                # corners must be masked, not just clipped
                valid = (
                    (iz >= max(lo, 0)) & (iz < min(hi, D))
                    & (iy >= 0) & (iy < D)
                    & (ix >= 0) & (ix < D)
                )
                w = torch.where(valid, w, torch.zeros_like(w))
                flat = (base + (
                    (iz - lo).clamp(0, Z - 1) * D + iy.clamp(0, D - 1)
                ) * D + ix.clamp(0, D - 1)).reshape(-1)
                grid.index_add_(0, flat, w.reshape(-1))
                if rgb_grid is not None:
                    rgb_grid.index_add_(
                        0, flat, (w[..., None] * rgb).reshape(-1, 3)
                    )
    grid = grid.reshape(B, Z, D, D)
    if rgb_grid is not None:
        rgb_grid = rgb_grid.reshape(B, Z, D, D, 3)
    return grid, rgb_grid


def pointcloud2voxels_scatter(
    points_ndc: torch.Tensor,
    vox_size: int,
    point_weights: torch.Tensor | None = None,
    rgb: torch.Tensor | None = None,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add splat. points_ndc [B, N, 3] -> grid [B, D, D, D]
    (``splat_raw``). With ``rgb`` [B, N, 3], also returns rgb_grid
    [B, D, D, D, 3] holding weight-normalised colours.
    """
    grid, rgb_grid = splat_raw(points_ndc, vox_size, point_weights, rgb)
    if rgb_grid is None:
        return grid
    return grid, rgb_grid / grid[..., None].clamp_min(1e-6)


def pointcloud2voxels_rbf(points_ndc: torch.Tensor, vox_size: int,
                          sigma_vox, chunk: int = 512) -> torch.Tensor:
    """The dense voxelizer: one isotropic Gaussian RBF a point, evaluated
    over the whole grid -> [B, D, D, D] (dpcx's ``pointcloud2voxels_rbf``,
    an independent oracle of splat + blur; no config renders with it).

    Separable: per-axis weights ``exp(-d^2 / (2 s^2)) / (sqrt(2 pi) s)``
    with ``s = max(sigma_vox, 1e-6)`` in cells, contracted over the points
    one z slab at a time, ``chunk`` points at a time (the memory bound)."""
    D = vox_size
    g = ndc_to_grid(points_ndc, D)  # [B, N, 3] (z, y, x)
    cells = torch.arange(D, dtype=points_ndc.dtype, device=points_ndc.device)
    s = torch.as_tensor(sigma_vox, dtype=points_ndc.dtype,
                        device=points_ndc.device).clamp_min(1e-6)

    def gweights(col):
        d = col[..., None] - cells
        return torch.exp(-0.5 * (d / s) ** 2) / (math.sqrt(2.0 * math.pi)
                                                 * s)

    wz, wy, wx = (gweights(g[..., a]) for a in range(3))  # [B, N, D]
    B, N = g.shape[:2]
    grid = points_ndc.new_zeros((B, D, D, D))
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        for z in range(D):
            wzy = wz[:, lo:hi, z, None] * wy[:, lo:hi]
            grid[:, z] += torch.einsum("bny,bnx->byx", wzy, wx[:, lo:hi])
    return grid
