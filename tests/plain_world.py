"""The world renderer's autograd.Function on the CPU.

``render/fused.py::_FusedWorldRender`` launches two kernels on the card
(``_launch_world_forward``, ``_launch_world_backward``). ``patch_launches``
puts plain stand-ins in their place: the clouds fanned out to their
renders, the camera transform from their rotation matrices
(``pc_perspective_transform_rot_t``), then ``fused_project_reference``; the backward is autograd's VJP of that
composition. ``render_world`` applies the Function as
``fused_project_world`` does on a card, so a CPU test holds its wiring
(saved tensors, absent cotangents, which inputs get a gradient, the
recompute request) against plain autograd through
``fused_project_world``'s CPU route.
"""

import torch

from dpcx_torch.geometry.quaternion import quaternion_to_matrix
from dpcx_torch.render import fused
from dpcx_torch.render.gauss import gauss_kernel_1d
from dpcx_torch.render.transform import (
    CAMERA_DISTANCE,
    FOCAL_LENGTH,
    pc_perspective_transform_rot_t,
)


def plain_world(points, weights, rot, trans, camera, sigma, radius, vox,
                with_depth):
    """The kernels' function from world clouds, in plain ops."""
    fan = rot.shape[0] // points.shape[0]
    p = points.repeat_interleave(fan, dim=0)
    w = None if weights is None else weights.repeat_interleave(fan, dim=0)
    ndc = pc_perspective_transform_rot_t(p, rot, *camera, trans)
    return fused.fused_project_reference(ndc, vox, sigma, radius, w,
                                         with_depth)


def patch_launches(monkeypatch, sigma):
    """Replace the two launches; -> the dict each backward call fills with
    what it was handed (grid, ddepth, want_dweights, want_camera)."""
    seen = {}

    def forward(points, weights, rot, trans, camera, taps, radius, vox,
                with_depth, bf16):
        assert not bf16
        sil, depth = plain_world(points, weights, rot, trans, camera, sigma,
                                 radius, vox, with_depth)
        return sil, depth, torch.zeros(1)  # the grid the backward is handed

    def backward(points, weights, rot, trans, camera, taps, radius, grid,
                 dsil, ddepth, vox, with_depth, want_dweights, want_camera,
                 bf16):
        assert not bf16
        seen.update(grid=grid, ddepth=ddepth, want_dweights=want_dweights,
                    want_camera=want_camera)
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in (points, weights, rot, trans)]
        with torch.enable_grad():
            sil, depth = plain_world(*leaves, camera, sigma, radius, vox,
                                     with_depth)
            loss = (sil * dsil).sum()
            if ddepth is not None:
                loss = loss + (depth * ddepth).sum()
            live = [t for t in leaves if t is not None]
            grads = dict(zip(map(id, live), torch.autograd.grad(loss, live)))
        dp, dw, drot, dtrans = (None if t is None else grads[id(t)]
                                for t in leaves)
        return (dp, dw if want_dweights else None,
                drot if want_camera else None,
                dtrans if want_camera else None)

    monkeypatch.setattr(fused, "_launch_world_forward", forward)
    monkeypatch.setattr(fused, "_launch_world_backward", backward)
    return seen


def render_world(points, weights, quat, trans, vox, sigma, radius,
                 with_depth, save_grid=True):
    """``_FusedWorldRender`` as ``fused_project_world`` applies it on a
    card -> (sil, depth or None)."""
    out = fused._FusedWorldRender.apply(
        points, weights, quaternion_to_matrix(quat), trans, (FOCAL_LENGTH, CAMERA_DISTANCE),
        gauss_kernel_1d(sigma, radius), radius, vox, with_depth, save_grid,
        False)
    return out if with_depth else (out, None)


def world_grads(render, points, weights, quat, trans, learn, use_sil,
                use_depth):
    """Gradients of sum(sil^2) (``use_sil``) + sum(depth^2) (``use_depth``)
    -> [d points, d weights, d quat, d trans], each None where its input is
    None or asks for none: ``learn`` names the camera inputs that do,
    "cameras" (quat and trans), "translation" or "none"."""
    p = points.clone().requires_grad_()
    w = None if weights is None else weights.clone().requires_grad_()
    q = quat.clone().requires_grad_(learn == "cameras")
    t = (None if trans is None
         else trans.clone().requires_grad_(learn != "none"))
    sil, depth = render(p, w, q, t)
    loss = (sil**2).sum() if use_sil else 0.0
    if use_depth:
        loss = loss + (depth**2).sum()
    loss.backward()
    return [None if x is None else x.grad for x in (p, w, q, t)]


def scene(rng, clouds, fan, n, weights, translation):
    """World clouds [C, N, 3] in front of the camera, weights [C, N] or
    None, cameras quat [C fan, 4] and translations [C fan, 3] or None."""
    def f32(a):
        return torch.from_numpy(a.astype("float32"))

    r = clouds * fan
    points = f32(rng.uniform(-0.4, 0.4, (clouds, n, 3)))
    pw = f32(rng.uniform(0, 2, (clouds, n))) if weights else None
    quat = f32(rng.normal(size=(r, 4)))
    trans = f32(rng.normal(0, 0.05, (r, 3))) if translation else None
    return points, pw, quat, trans
