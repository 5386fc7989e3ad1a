"""The benchmark's inputs, made from ``--seed`` on the run's device with a
``torch.Generator`` in a few large calls: the training records, the model's
initial weights and the renderer's clouds, cameras and cotangents. The same
seed gives the same tensors; both the program and the reference are handed
them.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for input ``stream`` of ``seed`` (any
    whole number: it is folded to 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % (1 << 63))
    return g


def unit_quats(g: torch.Generator, shape, device) -> torch.Tensor:
    q = torch.randn(tuple(shape) + (4,), generator=g, device=device)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def records(seed: int, models: int, views: int, image: int, mask: int,
            device) -> dict[str, torch.Tensor]:
    """Synthetic records [M, V, ...] in the layout the port's training
    step gathers from: ``images`` [M, V, image, image, 3] (a tinted
    ellipse on a white background), ``masks`` [M, V, mask, mask] (the
    ellipse, 0 or 1), ``depths`` (a dome inside the mask, 1.0 outside) and
    ``quats`` [M, V, 4] (unit cameras). Each view's ellipse has its own
    centre, radii and angle."""
    g = generator(seed, device, 1)
    n = models * views
    u = torch.rand(n, 6, generator=g, device=device)
    centre = (u[:, 0:2] - 0.5) * 0.3
    radii = 0.15 + 0.2 * u[:, 2:4]
    angle = math.pi * u[:, 4]
    tint = torch.rand(n, 3, generator=g, device=device)

    def ellipse(size):
        c = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) \
            / size - 0.5
        y, x = c[:, None], c[None, :]
        dx = x[None] - centre[:, 0, None, None]
        dy = y[None] - centre[:, 1, None, None]
        ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None,
                                                                    None]
        a = (ca * dx + sa * dy) / radii[:, 0, None, None]
        b = (-sa * dx + ca * dy) / radii[:, 1, None, None]
        return a * a + b * b  # < 1 inside

    r2 = ellipse(mask)
    inside = (r2 < 1).float()
    depths = torch.where(inside > 0, -0.3 * torch.sqrt((1 - r2).clamp_min(0)),
                         torch.ones_like(r2))
    ri = ellipse(image)
    fg = (ri < 1).float()[..., None]
    shade = (1 - 0.5 * ri.clamp(0, 1))[..., None]
    images = fg * tint[:, None, None, :] * shade + (1 - fg)
    quats = unit_quats(g, (n,), device)
    return {
        "images": images.reshape(models, views, image, image, 3),
        "masks": inside.reshape(models, views, mask, mask),
        "depths": depths.reshape(models, views, mask, mask),
        "quats": quats.reshape(models, views, 4),
    }


def weights(seed: int, shapes: dict[str, tuple[int, ...]],
            device) -> dict[str, torch.Tensor]:
    """Initial weights for ``shapes`` (parameter name -> torch shape): a
    kernel ``[out, in, ...]`` normal with standard deviation 1 / sqrt(fan
    in), a bias (one dimension) zero. One draw for all the kernels."""
    g = generator(seed, device, 2)
    kernels = {k: s for k, s in shapes.items() if len(s) > 1}
    total = sum(math.prod(s) for s in kernels.values())
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        if len(s) == 1:
            out[k] = torch.zeros(s, device=device)
            continue
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s) / math.sqrt(math.prod(s[1:]))
        at += n
    return out


def clouds(seed: int, sets: int, renders: int, points: int,
           device) -> list[dict[str, torch.Tensor]]:
    """``sets`` renderer inputs: clouds [renders, points, 3] on the
    surfaces of ellipsoids (centre within 0.1 of the origin, semi-axes
    0.15-0.35) and unit cameras [renders, 4]."""
    g = generator(seed, device, 3)
    out = []
    for _ in range(sets):
        d = torch.randn(renders, points, 3, generator=g, device=device)
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        u = torch.rand(renders, 1, 6, generator=g, device=device)
        pts = (u[..., 0:3] - 0.5) * 0.2 + d * (0.15 + 0.2 * u[..., 3:6])
        out.append({"points": pts.contiguous(),
                    "quats": unit_quats(g, (renders,), device)})
    return out


def cotangents(seed: int, sets: int, renders: int, vox: int,
               device) -> list[dict[str, torch.Tensor]]:
    """Seeded cotangents of the silhouettes and depths [renders, D, D]
    of each input set: standard normal over D^2, the scale a mean loss's
    gradient has."""
    g = generator(seed, device, 4)
    return [{k: torch.randn(renders, vox, vox, generator=g, device=device)
             / vox**2 for k in ("silhouette", "depth")} for _ in range(sets)]
