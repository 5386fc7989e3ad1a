"""Procedural ShapeNet-like shapes and multi-view rendering (port of
``dpcx/data/synthetic.py``).

Shapes are unions of axis-aligned boxes with category structure (chair /
car / airplane / car_asym), surface-sampled into point clouds; views are
rendered with the port's own renderer at high fidelity (dense GT cloud,
small sigma, thresholded silhouette), so at ``renderer: pallas`` the GT
views go through the fused CUDA kernel on the card.

Random draws are dpcx's: ``jax.random``'s threefry bits
(``utils/prng.py``) from the keys ``split(PRNGKey(seed), num_models)``,
split and drawn site by site as dpcx's ``make_model`` does. They run on
the CPU (a few hundred words a model), so a model's draws do not depend on
the device it is rendered on. ``choice`` with probabilities is jax's
(``cumsum(p)[-1] * (1 - uniform)``, then ``searchsorted``), with the
cumsum in XLA:CPU's order (``cumsum_xla``); the area sum that normalises
``p`` is summed in torch's order, so where it differs from XLA's by an
ulp an index may flip at a cumsum boundary (rarely; the tests count
them). Everything after the draws (box layout, surface points, cameras,
shading, renders) computes what dpcx computes on the same draws.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from dpcx_torch.config import Config
from dpcx_torch.geometry.camera import camera_from_view_angles
from dpcx_torch.geometry.quaternion import (
    quaternion_conjugate,
    quaternion_rotate,
)
from dpcx_torch.render.project import pointcloud_project
from dpcx_torch.utils import prng

# --- category templates: each shape = K boxes (center xyz, half-size xyz),
# fitting in the [-0.5, 0.5]^3 box, y-up, "front" facing +z ---


def _boxes(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        torch.stack([torch.as_tensor(v, dtype=like.dtype, device=like.device)
                     for v in row])
        for row in rows
    ])


def _chair_boxes(u: torch.Tensor) -> torch.Tensor:
    """u [8] uniform(0, 1) -> [7, 6] boxes: 4 legs, seat, back, and a
    one-sided armrest (the symmetry breaker every category carries)."""
    seat_h = 0.04 + 0.02 * u[0]
    seat_w = 0.26 + 0.10 * u[1]
    seat_d = 0.24 + 0.08 * u[2]
    leg_h = 0.12 + 0.06 * u[3]
    leg_t = 0.02 + 0.02 * u[4]
    back_h = 0.15 + 0.08 * u[5]
    back_t = 0.03 + 0.02 * u[6]
    seat_y = -0.5 + 2 * leg_h + seat_h
    lx, lz = seat_w - leg_t, seat_d - leg_t
    legs = [
        [sx * lx, -0.5 + leg_h, sz * lz, leg_t, leg_h, leg_t]
        for sx in (-1, 1)
        for sz in (-1, 1)
    ]
    seat = [0.0, seat_y, 0.0, seat_w, seat_h, seat_d]
    back = [0.0, seat_y + seat_h + back_h, -(seat_d - back_t),
            seat_w, back_h, back_t]
    arm_h = 0.06 + 0.04 * u[7]
    arm = [seat_w - leg_t, seat_y + seat_h + arm_h, 0.0,
           leg_t, arm_h, seat_d * 0.7]
    return _boxes(legs + [seat, back, arm], u)


def _car_boxes(u: torch.Tensor) -> torch.Tensor:
    body_h = 0.10 + 0.04 * u[0]
    body_w = 0.18 + 0.06 * u[1]
    body_l = 0.40 + 0.08 * u[2]
    cab_h = 0.08 + 0.04 * u[3]
    cab_l = body_l * (0.4 + 0.15 * u[4])
    wheel_r = 0.05 + 0.02 * u[5]
    body_y = -0.5 + 2 * wheel_r + body_h
    body = [0.0, body_y, 0.0, body_w, body_h, body_l]
    cabin = [0.0, body_y + body_h + cab_h, -0.05 * body_l,
             body_w * 0.85, cab_h, cab_l]
    wheels = [
        [sx * body_w, -0.5 + wheel_r, sz * body_l * 0.6,
         wheel_r * 0.5, wheel_r, wheel_r]
        for sx in (-1, 1)
        for sz in (-1, 1)
    ]
    # one-sided mirror stalk: symmetry breaker
    mirror = [body_w + 0.02, body_y + body_h + cab_h * 0.8, cab_l * 0.45,
              0.02, 0.02 + 0.01 * u[6], 0.015]
    return _boxes([body, cabin] + wheels + [mirror], u)


def _car_asym_boxes(u: torch.Tensor) -> torch.Tensor:
    """The car with a rear-set cab (pickup-like): front/back symmetry
    broken by shape, the identifiability control of the car."""
    body_h = 0.10 + 0.04 * u[0]
    body_w = 0.18 + 0.06 * u[1]
    body_l = 0.40 + 0.08 * u[2]
    cab_h = 0.11 + 0.05 * u[3]
    cab_l = body_l * (0.30 + 0.10 * u[4])
    wheel_r = 0.05 + 0.02 * u[5]
    body_y = -0.5 + 2 * wheel_r + body_h
    body = [0.0, body_y, 0.0, body_w, body_h, body_l]
    cabin = [0.0, body_y + body_h + cab_h, -(body_l - cab_l) * 0.85,
             body_w * 0.85, cab_h, cab_l]
    wheels = [
        [sx * body_w, -0.5 + wheel_r, sz * body_l * 0.6,
         wheel_r * 0.5, wheel_r, wheel_r]
        for sx in (-1, 1)
        for sz in (-1, 1)
    ]
    mirror = [body_w + 0.02, body_y + body_h + cab_h * 0.8,
              -(body_l - cab_l) * 0.85 + cab_l * 0.9,
              0.02, 0.02 + 0.01 * u[6], 0.015]
    return _boxes([body, cabin] + wheels + [mirror], u)


def _airplane_boxes(u: torch.Tensor) -> torch.Tensor:
    fus_r = 0.04 + 0.02 * u[0]
    fus_l = 0.40 + 0.08 * u[1]
    wing_span = 0.35 + 0.12 * u[2]
    wing_c = 0.08 + 0.04 * u[3]
    tail_span = wing_span * (0.35 + 0.1 * u[4])
    fuselage = [0.0, 0.0, 0.0, fus_r, fus_r, fus_l]
    wings = [0.0, 0.0, 0.05 * fus_l, wing_span, fus_r * 0.4, wing_c]
    tail_h = [0.0, 0.0, -(fus_l - wing_c * 0.5), tail_span, fus_r * 0.4,
              wing_c * 0.6]
    tail_v = [0.0, fus_r + 0.06, -(fus_l - wing_c * 0.5), fus_r * 0.3, 0.06,
              wing_c * 0.6]
    # one-sided wing pod: symmetry breaker
    pod = [wing_span * 0.55, -fus_r * 0.6, 0.05 * fus_l,
           0.03 + 0.01 * u[5], 0.03, 0.06]
    pad = [0.0] * 6  # every category has the static shape [7, 6]
    return _boxes([fuselage, wings, tail_h, tail_v, pod, pad, pad], u)


_CATEGORY_FNS = {"chair": _chair_boxes, "car": _car_boxes,
                 "airplane": _airplane_boxes,
                 "car_asym": _car_asym_boxes}
CATEGORIES = tuple(_CATEGORY_FNS)
# "multi" datasets cycle the reference's trio only; car_asym comes after,
# so category_idx values match dpcx's
MULTI_CATEGORIES = CATEGORIES[:3]


def _box_surface(boxes: torch.Tensor, choice: torch.Tensor,
                 uv: torch.Tensor):
    """Points on the chosen faces: choice [n] indexes the K*6 faces, uv
    [n, 2] in [-1, 1] places the point on its face -> (points [n, 3],
    box ids [n], outward normals [n, 3])."""
    box_idx, face_idx = choice // 6, choice % 6
    c, h = boxes[box_idx, :3], boxes[box_idx, 3:]
    axis = face_idx // 2  # 0: x, 1: y, 2: z
    sign = torch.where(face_idx % 2 == 0, 1.0, -1.0).to(boxes.dtype)
    n = choice.shape[0]
    offs = torch.zeros((n, 3), dtype=boxes.dtype, device=boxes.device)
    normals = torch.zeros_like(offs)
    for a in range(3):
        others = [b for b in range(3) if b != a]
        local = torch.zeros_like(offs)
        local[:, a] = sign * h[:, a]
        local[:, others[0]] = uv[:, 0] * h[:, others[0]]
        local[:, others[1]] = uv[:, 1] * h[:, others[1]]
        on_a = (axis == a)[:, None]
        offs = torch.where(on_a, local, offs)
        nrm = torch.zeros_like(offs)
        nrm[:, a] = sign
        normals = torch.where(on_a, nrm, normals)
    return c + offs, box_idx, normals


def _scan_f32(x: torch.Tensor) -> torch.Tensor:
    """Sequential float32 prefix sums along the last axis (torch.cumsum
    accumulates float32 in float64 on the CPU)."""
    cols = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., j])
    return torch.stack(cols, -1)


XLA_SCAN_BLOCK = 16  # XLA:CPU's ReduceWindowRewriter base length


def cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` of a float32 vector in XLA:CPU's order: its
    ``ReduceWindowRewriter`` scans blocks of XLA_SCAN_BLOCK in sequence,
    scans the blocks' totals (recursively), and adds each block's
    exclusive prefix."""
    n, base = x.shape[0], XLA_SCAN_BLOCK
    if n <= base:
        return _scan_f32(x)
    nb = -(-n // base)
    inner = _scan_f32(F.pad(x, (0, nb * base - n)).reshape(nb, base))
    prefix = F.pad(cumsum_xla(inner[:, -1])[:-1], (1, 0))
    return (inner + prefix[:, None]).reshape(-1)[:n]


def choice_p(key, probs: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.choice(key, len(probs), (n,), p=probs)`` with
    replacement (``jax/_src/random.py::choice``)."""
    p_cuml = cumsum_xla(probs)
    r = p_cuml[-1] * (1.0 - prng.uniform(key, (n,)))
    return torch.searchsorted(p_cuml, r)


def _sample_box_surface(key, boxes: torch.Tensor, n: int):
    """n points on the union of box surfaces, area-weighted -> (points
    [n, 3], box ids [n], outward normals [n, 3])."""
    kb, _, ku = prng.split(key, 3)
    half = boxes[:, 3:]
    ax = half[:, 1] * half[:, 2]
    ay = half[:, 0] * half[:, 2]
    az = half[:, 0] * half[:, 1]
    areas = torch.stack([ax, ax, ay, ay, az, az], dim=-1).reshape(-1)
    probs = areas / areas.sum().clamp_min(1e-9)
    choice = choice_p(kb, probs, n)
    uv = prng.uniform(ku, (n, 2), minval=-1.0, maxval=1.0)
    return _box_surface(boxes, choice, uv)


def sample_category_surface(key, category: str, n: int = 16000):
    """One model from the key pair ``key``: random jitter + surface sample
    -> (points [n, 3], box ids [n], outward normals [n, 3])."""
    kj, ks = prng.split(key)
    u = prng.uniform(kj, (8,))
    return _sample_box_surface(ks, _CATEGORY_FNS[category](u), n)


def sample_category_points(key, category: str,
                           n: int = 16000) -> torch.Tensor:
    """GT dense cloud [n, 3]."""
    return sample_category_surface(key, category, n)[0]


def _render_gt_views(cfg: Config, points: torch.Tensor, quats: torch.Tensor):
    """GT masks and depths [V, D, D] of one model's V views: the renderer
    at a small fixed sigma on the dense cloud, then a threshold."""
    V = quats.shape[0]
    out = pointcloud_project(
        cfg.replace(proj_depth=True, proj_type="drc"),
        points[None].expand(V, -1, -1),
        quats,
        torch.tensor(1.0 / cfg.vox_size),
    )
    mask = (out.silhouette > 0.4).float()
    depth = torch.where(mask > 0, out.depth, torch.ones_like(out.depth))
    return mask, depth


def _render_images(cfg: Config, points: torch.Tensor, quats: torch.Tensor,
                   colors: torch.Tensor) -> torch.Tensor:
    """RGB views [V, H, W, 3]: expected colour through the DRC rgb path
    over a white background, bilinearly resized from D to image_size."""
    V = quats.shape[0]
    out = pointcloud_project(
        cfg.replace(proj_depth=False, proj_type="drc"),
        points[None].expand(V, -1, -1),
        quats,
        torch.tensor(1.0 / cfg.vox_size),
        rgb=colors,
    )
    img = out.rgb + (1.0 - out.silhouette[..., None])  # white background
    size = cfg.image_size
    # jax.image.resize's bilinear is half-pixel, edge-clamped, and
    # antialiased when it shrinks
    img = F.interpolate(img.permute(0, 3, 1, 2), size=(size, size),
                        mode="bilinear", align_corners=False,
                        antialias=size < cfg.vox_size)
    return img.permute(0, 2, 3, 1).clamp(0.0, 1.0)


def make_model(key, cfg: Config, category: str, gt_points: int = 16000,
               device=None) -> dict:
    """One dataset record from the key pair ``key`` (dpcx's ``make_model``
    key): V views of one randomized model, rendered on ``device``: images
    [V, H, W, 3] (textured, lambertian-shaded RGB over a white background),
    masks [V, D, D], depths [V, D, D], quats [V, 4], gt_points
    [gt_points, 3]."""
    kp, kv, kc, kt = prng.split(key, 4)
    points, box_idx, normals = sample_category_surface(kp, category,
                                                       gt_points)
    ka, ke = prng.split(kv)
    V = cfg.num_views
    azim = prng.uniform(ka, (V,), minval=0.0, maxval=2 * math.pi)
    elev = prng.uniform(ke, (V,), minval=0.1, maxval=0.6)
    quats, _ = camera_from_view_angles(azim, elev, cfg.camera_distance)

    # --- textured RGB appearance ---
    palette = prng.uniform(kc, (8, 3), minval=0.15, maxval=0.95)
    if cfg.texture_mode == "lowfreq":
        # two-tone front/back split (< 1 cycle across the object)
        kd, kf, kb = prng.split(kt, 3)
        tilt = 0.35 * prng.normal(kd, (2,))
        axis = torch.stack([tilt[0], tilt[1], torch.tensor(1.0)])
        axis = axis / torch.linalg.vector_norm(axis)
        t = torch.sigmoid((points @ axis) / 0.06)[:, None]  # [N, 1]
        front = prng.uniform(kf, (3,), minval=0.55, maxval=0.95)
        back = prng.uniform(kb, (3,), minval=0.05, maxval=0.45)
        two_tone = t * front + (1.0 - t) * back.flip(0)
        albedo = 0.4 * palette[box_idx % 8] + 0.6 * two_tone
    else:
        stripe_dir = prng.normal(kt, (3,))
        stripes = 0.85 + 0.15 * torch.sin(
            40.0 * points @ (stripe_dir / torch.linalg.vector_norm(stripe_dir))
        )
        albedo = palette[box_idx % 8] * stripes[:, None]  # [N, 3]
    # per-view lambertian shading: a lamp fixed in camera space, rotated
    # into the world frame per view, two-sided
    light_cam = torch.tensor([0.35, 0.5, 0.79])
    light_world = quaternion_rotate(
        light_cam.expand(V, 1, 3), quaternion_conjugate(quats)
    )  # [V, 1, 3]
    lambert = torch.einsum("nc,vkc->vn", normals, light_world).abs()
    shade = 0.35 + 0.65 * lambert  # [V, N]
    colors = albedo[None] * shade[..., None]  # [V, N, 3]

    points, quats, colors = (t.to(device) for t in (points, quats, colors))
    masks, depths = _render_gt_views(cfg, points, quats)
    return {
        "images": _render_images(cfg, points, quats, colors),
        "masks": masks,
        "depths": depths,
        "quats": quats,
        "gt_points": points,
    }


def make_dataset(
    cfg: Config, num_models: int, seed: int = 0, category: str | None = None,
    gt_points: int = 16000,
    process_index: int = 0,
    process_count: int = 1,
    device=None,
) -> dict:
    """Stacked records for ``num_models`` models, rendered on ``device``.

    ``category="multi"`` cycles through the three reference categories;
    the per-model category index is recorded in ``category_idx``. Process
    ``p`` of ``P`` makes the strided slice ``p::P`` of the model list, with
    the same per-model keys as one process would use: dpcx's
    ``split(PRNGKey(seed), num_models)``.
    """
    category = category or cfg.category
    if category == "multi":
        cats = [MULTI_CATEGORIES[i % len(MULTI_CATEGORIES)]
                for i in range(num_models)]
    else:
        if category not in _CATEGORY_FNS:
            category = "chair"
        cats = [category] * num_models
    keys = prng.split(prng.prng_key(seed), num_models)
    mine = range(process_index, num_models, process_count)
    records = [
        make_model(keys[i], cfg, cats[i], gt_points, device) for i in mine
    ]
    out = {k: torch.stack([r[k] for r in records]) for k in records[0]}
    out["category_idx"] = torch.tensor(
        [CATEGORIES.index(cats[i]) for i in mine], dtype=torch.int32
    )
    return out
