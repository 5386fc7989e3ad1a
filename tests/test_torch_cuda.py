"""The port's CUDA kernels on the card, against their plain PyTorch version.

Every test here needs a CUDA card and skips without one. Run them on the
card with:

    python -m pytest tests/test_torch_cuda.py -q

The renderer's kernels (K1-K5) take world clouds and cameras
(``fused_project_world``). The tests of their arithmetic draw NDC
coordinates as dpcx's kernel tests do and place world points in front of
an identity camera that projects them there (``_world``): the camera
transform is then exact on both sides, so the kernels see the grid
coordinates of the plain version they are held to, the torch transform
and ``fused_project_plain`` (whose backward is K2's function, hat
derivative 0 at an exactly integer coordinate included). Random cameras,
whose rotation may move a coordinate by an ulp, are
``tests/test_torch_front_cuda.py``'s.

Tolerance: sil and depth atol 1e-4 — atomics reorder the f32 splat sums
from run to run, so the kernel is not bitwise stable; gradients within
1e-3 of the largest plain gradient, for the same reason. D > 64 runs the
counterparts of dpcx's depth-blocked kernels (K3-K5), in both backward
modes (the saved grid, and the recompute that ``remat`` selects).

The anisotropic splat kernels (K6/K7 counterparts, ``render/aniso.py``)
sum without atomics but in another order than the plain version, and the
density peaks at ~1e2 where one f32 ulp is ~1e-5: their grids are held to
1e-4 of the largest plain value (at least 1e-4 absolute), their gradients
to 2e-4 relative L2 (dpcx's own kernel-vs-oracle bound); two launches on
the same inputs are bitwise equal.
"""

import json
import math
import warnings

import numpy as np
import pytest
import torch

from dpcx_torch.config import Config
from dpcx_torch.render import aniso, fused, gsplat
from dpcx_torch.render.project import pointcloud_project_fn
from dpcx_torch.render.transform import (
    CAMERA_DISTANCE as DIST,
    FOCAL_LENGTH as FOCAL,
    pc_perspective_transform_t,
)

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _world(ndc):
    """World points [R, N, 3] and identity cameras [R, 4] that
    ``fused_project_world`` (at its default focal length and camera
    distance) projects to ndc [R, 3, N] (rows x, y, z), up to rounding."""
    x, y, z = ndc.unbind(1)
    scale = (z + DIST) / FOCAL
    points = torch.stack([x * scale, y * scale, z], dim=-1).contiguous()
    quat = torch.zeros(ndc.shape[0], 4, device=ndc.device)
    quat[:, 0] = 1.0
    return points, quat


def _report(what, a, b, limit):
    """Print the largest |a - b| beside its limit (``pytest -s`` shows it);
    a and b tensors or arrays, or a precomputed error with b None."""
    err = a if b is None else float(abs(a - b).max())
    print(f"\n  {what}: largest error {err:.4g}, limit {float(limit):.4g}",
          end="")


def _kernel(points, quat, vox, sigma, radius, pw=None, with_depth=False,
            acc="float32", save_grid=True, trans=None):
    """The kernels: ``fused_project_world``, one render a cloud."""
    return fused.fused_project_world(
        points, quat, vox, sigma, radius, point_weights=pw,
        translation=trans, with_depth=with_depth, acc_dtype=acc,
        save_grid=save_grid)


def _plain(points, quat, vox, sigma, radius, pw=None, with_depth=False,
           acc="float32", save_grid=True, trans=None):
    """The plain version: the torch transform, then
    ``fused_project_plain`` (save_grid is the kernels' choice alone)."""
    ndc = pc_perspective_transform_t(points, quat, translation=trans)
    return fused.fused_project_plain(ndc, vox, sigma, radius, pw,
                                     with_depth, acc)


@pytest.mark.parametrize(
    "renders,n,vox,radius,with_depth,weights,lim",
    [
        (4, 1000, 16, 2, True, True, 0.7),
        (3, 777, 20, 3, False, False, 0.45),  # D % 8 != 0, odd N
        (8, 16000, 64, 8, True, True, 0.6),
        (2, 5000, 64, 63, True, False, 0.55),  # the widest radius
        (1, 1, 8, 1, True, False, 0.45),
        (2, 4000, 72, 9, True, True, 0.6),  # D > 64, points past both ends
        (4, 16000, 128, 16, False, True, 0.6),  # the multicat_128 step
        (2, 4000, 98, 30, True, True, 0.6),  # D % 4 != 0 above 64
        (256, 2048, 32, 6, False, True, 0.6),  # the chair_pred_pose render
        (2, 600, 8, 7, True, True, 0.6),  # one run a line, the widest R
    ],
)
def test_kernel_matches_plain(cuda, renders, n, vox, radius, with_depth,
                              weights, lim):
    rng = np.random.default_rng(vox + n)
    ndc = torch.tensor(rng.uniform(-lim, lim, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    points, quat = _world(ndc)
    pw = (torch.tensor(rng.uniform(0, 1, (renders, n)), dtype=torch.float32,
                       device=cuda) if weights else None)
    sigma = torch.tensor(0.05 * vox, device=cuda)
    key = "blocked_render" if vox > 64 else "fused_render"
    before = fused.LAUNCHES[key]
    s_k, d_k = _kernel(points, quat, vox, sigma, radius, pw, with_depth)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    s_p, d_p = _plain(points, quat, vox, sigma, radius, pw, with_depth)
    assert s_k.shape == (renders, vox, vox) and s_k.device.type == "cuda"
    _report("sil", s_k, s_p, ATOL)
    torch.testing.assert_close(s_k, s_p, atol=ATOL, rtol=0)
    if with_depth:
        _report("depth", d_k, d_p, ATOL)
        torch.testing.assert_close(d_k, d_p, atol=ATOL, rtol=0)
    else:
        assert d_k is None


def test_kernel_refuses_bad_inputs(cuda):
    """``fused_project_world``'s refusals on the card: float64, a tensor on
    another device, bad shapes, a grid or operand mode the kernels do not
    cover; an input that requires grad goes through K1 and, backward,
    K2."""
    points, quat = _world(torch.zeros(2, 3, 64, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        _kernel(points.double(), quat, 16, 0.8, 2)
    with pytest.raises(ValueError, match="quat must be float32"):
        _kernel(points, quat.double(), 16, 0.8, 2)
    with pytest.raises(ValueError, match="point_weights must be float32"):
        _kernel(points, quat, 16, 0.8, 2, pw=torch.ones(2, 64))  # on cpu
    with pytest.raises(ValueError, match="translation must be float32"):
        _kernel(points, quat, 16, 0.8, 2, trans=torch.zeros(2, 3))  # on cpu
    with pytest.raises(ValueError, match=r"\[C, N, 3\]"):
        _kernel(points.transpose(1, 2), quat, 16, 0.8, 2)
    with pytest.raises(ValueError, match="multiple"):
        _kernel(points, quat.new_ones(3, 4), 16, 0.8, 2)  # 3 over 2 clouds
    with pytest.raises(ValueError, match="point_weights must be"):
        _kernel(points, quat, 16, 0.8, 2, pw=points.new_ones(2, 63))
    with pytest.raises(ValueError, match="translation must be"):
        _kernel(points, quat, 16, 0.8, 2, trans=points.new_zeros(2, 4))
    with pytest.raises(ValueError, match="vox_size"):
        _kernel(points, quat, 136, 0.8, 2)
    with pytest.raises(ValueError, match="acc_dtype"):
        _kernel(points, quat, 16, 0.8, 2, acc="float16")
    before = dict(fused.LAUNCHES)
    points.requires_grad_()
    sil, _ = _kernel(points, quat, 16, 0.8, 2)
    sil.sum().backward()
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_render"] == before["fused_render"] + 1
    assert fused.LAUNCHES["fused_render_bwd"] == \
        before["fused_render_bwd"] + 1
    assert points.grad.shape == points.shape


def _grads(fn, points, pw, quat, dsil, ddepth, trans=None, cameras=False):
    """d/d(points), d/d(weights) (when given) and, with ``cameras``,
    d/d(quat) and d/d(trans) (when given) of <dsil, sil> +
    <ddepth, depth>, for fn(points, quat, weights, trans)."""
    leaves = [points.detach().requires_grad_(),
              None if pw is None else pw.detach().requires_grad_(),
              quat.detach().requires_grad_(cameras),
              None if trans is None
              else trans.detach().requires_grad_(cameras)]
    sil, depth = fn(leaves[0], leaves[2], leaves[1], leaves[3])
    loss = (sil * dsil).sum()
    if depth is not None:
        loss = loss + (depth * ddepth).sum()
    return torch.autograd.grad(
        loss, [t for t in leaves if t is not None and t.requires_grad])


def _assert_grads_close(got, plain):
    """Each kernel gradient within 1e-3 of the largest plain one."""
    for i, (a, b) in enumerate(zip(got, plain, strict=True)):
        bound = 1e-3 * b.abs().max().item()
        _report(f"gradient {i}", a, b, bound)
        assert bound > 0
        assert (a - b).abs().max().item() <= bound


@pytest.mark.parametrize(
    "renders,n,vox,radius,with_depth,weights,lim",
    [
        (32, 16000, 64, 8, True, True, 0.6),  # the car_64_depth step
        (64, 8000, 32, 4, False, True, 0.6),  # the chair_gt_pose step
        (4, 1000, 16, 2, True, False, 0.7),
        (3, 777, 24, 3, False, False, 0.45),
        (2, 5000, 64, 63, True, True, 0.55),  # the widest radius
        (256, 2048, 32, 6, False, True, 0.6),  # the chair_pred_pose render
        (2, 600, 8, 7, True, True, 0.6),  # one run a line, the widest R
        (3, 777, 20, 19, True, False, 0.5),  # D % 8 != 0, the widest R
    ],
)
def test_backward_kernel_matches_plain(cuda, renders, n, vox, radius,
                                       with_depth, weights, lim):
    """K2's gradients, the cameras' (through a zero translation) included,
    against the plain version's, for a random linear functional of sil and
    depth. Bound: 1e-3 of the largest plain gradient (atomic splat sums
    reorder from run to run)."""
    rng = np.random.default_rng(vox + n + 1)
    ndc = torch.tensor(rng.uniform(-lim, lim, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    points, quat = _world(ndc)
    trans = torch.zeros(renders, 3, device=cuda)
    pw = (torch.tensor(rng.uniform(0, 2, (renders, n)), dtype=torch.float32,
                       device=cuda) if weights else None)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)

    def grads(route):
        return _grads(
            lambda p, q, w, t: route(p, q, vox, sigma, radius, w,
                                     with_depth, trans=t),
            points, pw, quat, dsil, ddepth, trans, cameras=True)

    before = fused.LAUNCHES["fused_render_bwd"]
    g_k = grads(_kernel)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_render_bwd"] == before + 1
    _assert_grads_close(g_k, grads(_plain))


def test_pallas_renderer_on_card(cuda):
    """renderer: pallas reaches the fused kernel at D <= 64 and the
    blocked counterparts at 64 < D <= 128 (save_grid = not remat), and
    falls through to the plain ops above 128, as dpcx does."""
    pts = torch.rand(2, 500, 3, device=cuda) - 0.5
    q = torch.tensor([[1.0, 0, 0, 0]] * 2, device=cuda)
    cfg = Config(vox_size=32, renderer="pallas", proj_depth=True)
    for vox, key in ((32, "fused_render"), (128, "blocked_render")):
        c = cfg.replace(vox_size=vox)
        before = fused.LAUNCHES[key]
        out = pointcloud_project_fn(c, pts, q, torch.tensor(0.05))
        assert fused.LAUNCHES[key] == before + 1
        ref = pointcloud_project_fn(c.replace(renderer="xla"), pts, q,
                                    torch.tensor(0.05))
        torch.testing.assert_close(out.silhouette, ref.silhouette,
                                   atol=ATOL, rtol=0)
        torch.testing.assert_close(out.depth, ref.depth, atol=ATOL, rtol=0)
    before = dict(fused.LAUNCHES)
    out = pointcloud_project_fn(cfg.replace(vox_size=136), pts, q,
                                torch.tensor(0.05))
    assert fused.LAUNCHES == before and out.silhouette.shape == (2, 136, 136)


@pytest.mark.parametrize("save_grid", [True, False])
@pytest.mark.parametrize(
    "renders,n,vox,radius,with_depth,lim",
    [
        (16, 16000, 128, 16, False, 0.6),  # the multicat_128 step
        (4, 16000, 128, 16, True, 0.6),
        (3, 3000, 72, 9, True, 0.7),  # points past both z ends
        (2, 2000, 72, 71, False, 0.55),  # the widest radius
        (2, 2000, 98, 12, True, 0.6),  # D % 4 != 0: runs and bands ragged
    ],
)
def test_blocked_backward_matches_plain(cuda, save_grid, renders, n, vox,
                                        radius, with_depth, lim):
    """The D > 64 backward (the counterparts of K4 + K5), with the saved
    grid and with the recompute, against the plain version, with dropout
    weights; the two modes against each other."""
    rng = np.random.default_rng(vox + n + radius)
    ndc = torch.tensor(rng.uniform(-lim, lim, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    points, quat = _world(ndc)
    pw = torch.tensor((rng.random((renders, n)) < 0.5) / 0.5,
                      dtype=torch.float32, device=cuda)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)
    key = "blocked_render_bwd" + ("" if save_grid else "_recompute")
    before = dict(fused.LAUNCHES)

    def grads(route, save):
        return _grads(
            lambda p, q, w, t: route(p, q, vox, sigma, radius, w,
                                     with_depth, save_grid=save),
            points, pw, quat, dsil, ddepth)

    g_k = grads(_kernel, save_grid)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before[key] + 1
    assert fused.LAUNCHES["blocked_render"] == before["blocked_render"] + 1
    g_p = grads(_plain, save_grid)
    _assert_grads_close(g_k, g_p)
    g_o = grads(_kernel, not save_grid)
    for a, b, o in zip(g_k, g_p, g_o):
        _report("the other grid mode", a, o, 1e-3 * b.abs().max().item())
        assert (a - o).abs().max().item() <= 1e-3 * b.abs().max().item()


def test_blur_yx_launch_at_d128(cuda):
    """At D 128 blur_slab_kernel needs 66 KiB of shared memory and more
    with the widest radius (above the 48 KiB default): the launch is
    accepted and the result right."""
    rng = np.random.default_rng(128)
    ndc = torch.tensor(rng.uniform(-0.5, 0.5, (2, 3, 3000)),
                       dtype=torch.float32, device=cuda)
    points, quat = _world(ndc)
    for radius in (16, 127):
        sigma = torch.tensor(0.02 * 128 * (1 + radius / 16), device=cuda)
        s_k, d_k = _kernel(points, quat, 128, sigma, radius, with_depth=True)
        torch.cuda.synchronize()
        s_p, d_p = _plain(points, quat, 128, sigma, radius, with_depth=True)
        _report(f"R {radius} sil", s_k, s_p, ATOL)
        _report(f"R {radius} depth", d_k, d_p, ATOL)
        torch.testing.assert_close(s_k, s_p, atol=ATOL, rtol=0)
        torch.testing.assert_close(d_k, d_p, atol=ATOL, rtol=0)


def _tile_grads(cuda, ndc, pw, mode, seed):
    """The kernels' d points and d weights of <dsil, sil> + <ddepth,
    depth> at D 128, radius 16 (seeded cotangents), from the world points
    of ndc, with one launch of the forward and one of the saved-grid
    backward in ``mode``; and the plain version's."""
    renders, vox = ndc.shape[0], 128
    points, quat = _world(ndc)
    rng = np.random.default_rng(seed)
    dsil, ddepth = (torch.tensor(rng.normal(size=(renders, vox, vox)),
                                 dtype=torch.float32, device=cuda)
                    for _ in range(2))
    sigma = torch.tensor(0.05 * vox, device=cuda)
    suffix = "_bf16" if mode == "bfloat16" else ""

    def grads(route):
        return _grads(
            lambda p, q, w, t: route(p, q, vox, sigma, 16, w, True, mode),
            points, pw, quat, dsil, ddepth)

    before = dict(fused.LAUNCHES)
    got = grads(_kernel)
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in fused.LAUNCHES.items()}
    assert made == {k: int(k in (f"blocked_render{suffix}",
                                 f"blocked_render_bwd{suffix}"))
                    for k in made}
    return got, grads(_plain)


def test_drc_bwd_tile_launch_at_d128(cuda):
    """Above D 64 the DRC backward is drc_bwd_tile_kernel, whose blocks need
    74,240 bytes of shared memory at D 128 (above the 48 KiB default): the
    saved-grid backward's launch is accepted, and its gradients are within
    1e-3 of the largest of the plain version's, on a core of ~3 cells whose
    occupancy passes 1 (the clipped cells' zero cotangent)."""
    rng = np.random.default_rng(130)
    n = 6000
    ndc = torch.tensor(rng.uniform(-0.5, 0.5, (2, 3, n)),
                       dtype=torch.float32, device=cuda)
    ndc[:, :, : n // 3] *= 0.02
    pw = torch.tensor(rng.uniform(0, 8, (2, n)), dtype=torch.float32,
                      device=cuda)
    points, quat = _world(ndc)
    sil, _ = _kernel(points, quat, 128, torch.tensor(6.4, device=cuda), 16,
                     pw, with_depth=True)
    assert (sil > 1.0 - 1e-4).any()  # saturated rays: clipped cells
    got, want = _tile_grads(cuda, ndc, pw, "float32", 131)
    for i, (a, b) in enumerate(zip(got, want)):
        peak = b.abs().max().item()
        _report(f"gradient {i}", a, b, 1e-3 * peak)
        assert peak > 0
        assert (a - b).abs().max().item() <= 1e-3 * peak


def test_drc_bwd_tile_launch_at_d128_bf16(cuda):
    """test_drc_bwd_tile_launch_at_d128 in bfloat16 operand mode, on
    test_bf16_blocked_kernels_match_plain's kind of cloud (a dense core,
    one point in ten weighing 10): the gradients within BF16_SHARE of the
    largest plain one and BF16_GRAD_L2 in relative L2."""
    rng = np.random.default_rng(132)
    n = 3000
    ndc = torch.tensor(rng.uniform(-0.6, 0.6, (2, 3, n)),
                       dtype=torch.float32, device=cuda)
    ndc[:, :, : n // 2] *= 0.4
    pw = torch.tensor((rng.random((2, n)) < 0.1) * 10.0,
                      dtype=torch.float32, device=cuda)
    got, want = _tile_grads(cuda, ndc, pw, "bfloat16", 133)
    for i, (a, b) in enumerate(zip(got, want)):
        peak = b.abs().max().item()
        _report(f"gradient {i}", a, b, BF16_SHARE * peak)
        _report(f"gradient {i} rel L2", _rel_l2(a, b), None, BF16_GRAD_L2)
        assert peak > 0
        assert (a - b).abs().max().item() <= BF16_SHARE * peak
        assert _rel_l2(a, b) <= BF16_GRAD_L2


def test_blur_yx_launch_at_d128_bf16(cuda):
    """test_blur_yx_launch_at_d128 in bfloat16 operand mode (K3's z pass
    and blur_slab_kernel<true>): the forward at R 16 and the widest R 127
    within BF16_FWD_SHARE of the largest plain value."""
    rng = np.random.default_rng(129)
    ndc = torch.tensor(rng.uniform(-0.5, 0.5, (2, 3, 3000)),
                       dtype=torch.float32, device=cuda)
    points, quat = _world(ndc)
    for radius in (16, 127):
        sigma = torch.tensor(0.02 * 128 * (1 + radius / 16), device=cuda)
        with torch.no_grad():
            k = _kernel(points, quat, 128, sigma, radius, with_depth=True,
                        acc="bfloat16")
            torch.cuda.synchronize()
            p = _plain(points, quat, 128, sigma, radius, with_depth=True,
                       acc="bfloat16")
        for what, a, b in zip(("sil", "depth"), k, p):
            peak = b.abs().max().item()
            _report(f"R {radius} {what}", a, b, BF16_FWD_SHARE * peak)
            assert (a - b).abs().max().item() <= BF16_FWD_SHARE * peak


def _reach(g, p0, grid):
    """For grid coordinates g (floats holding integers), a first guess p0
    (f32) and grid, the f32 arithmetic that maps a world coordinate to its
    grid coordinate: the f32 coordinate among p0's neighbours that lands at
    exactly g, and where one does (a mask); elsewhere p0."""
    f32 = np.float32
    p, hit = p0.copy(), np.zeros(g.shape, bool)
    for k in sorted(range(-32, 33), key=abs):  # f32 neighbours of p0
        c = (p0.view(np.int32) + k).view(f32)
        new = ~hit & (grid(c) == g)
        p[new], hit = c[new], hit | new
    return p, hit


def _on_grid(g, pz, vox):
    """For grid coordinates g (floats holding integers) and world z pz (f32
    arrays [R, N]): the x (or y) of a world point in front of an identity
    camera at fused_project_world's focal length and camera distance that
    ``project()`` in csrc/fused_render.cu (x f / (z + dist), then
    (ndc + 0.5) D - 0.5, each step rounded once in f32) puts at exactly g,
    and where f32 arithmetic can put it there (a mask)."""
    f32 = np.float32
    zs = pz + f32(DIST)
    p0 = (((g.astype(np.float64) + 0.5) / vox - 0.5) * zs / FOCAL).astype(f32)
    return _reach(g, p0, lambda p: ((p * f32(FOCAL)) / zs + f32(0.5))
                  * f32(vox) - f32(0.5))


def _z_on_grid(g, vox):
    """The world z that ``project()`` puts at exactly grid z g behind an
    identity camera ((z + 0.5) D - 0.5 in f32), and where it can (a mask)."""
    f32 = np.float32
    p0 = ((g.astype(np.float64) + 0.5) / vox - 0.5).astype(f32)
    return _reach(g, p0, lambda p: (p + f32(0.5)) * f32(vox) - f32(0.5))


@pytest.mark.parametrize("vox,save_grid,bf16", [(32, True, False),
                                                (72, True, False),
                                                (72, False, False),
                                                (32, True, True)])
def test_integer_coordinate_gradient_is_zero(cuda, vox, save_grid, bf16):
    """Along an axis whose grid coordinate is an exact integer the hat's
    derivative is 0, as dpcx's _dhat_t gives (a floor-based derivative is
    one-sided there): K2's backward in both operand modes and the D > 64
    backward in both grid modes. World points in front of an identity
    camera land at integer y (the first group), x (the second) or z (the
    third) where f32 arithmetic lets them (``_on_grid``, ``_z_on_grid``;
    at D 72 not every integer is reachable). d points along y or x is
    d(grid) times f / (z + dist), so it must be 0 there. The third group
    sits at camera-frame x = y = 0, where NDC x and y do not depend on z:
    d points along z is the z hat's derivative alone, and must be 0."""
    rng = np.random.default_rng(vox)
    R, N, NZ, radius = 2, 400, 16, 3
    half = N // 2
    g = rng.uniform(2, vox - 3, (R, 3, N)).astype(np.float32)  # z, y, x
    pz = ((g[:, 0] + 0.5) / vox - 0.5).astype(np.float32)
    g[:, 1, :half] = np.round(g[:, 1, :half])  # integer y
    g[:, 2, half:] = np.round(g[:, 2, half:])  # integer x
    py, on_y = _on_grid(g[:, 1], pz, vox)
    px, on_x = _on_grid(g[:, 2], pz, vox)
    on_y[:, half:], on_x[:, :half] = False, False
    assert on_y[:, :half].mean() > 0.8 and on_x[:, half:].mean() > 0.8
    # integer z (the first half), and off the integers (a control)
    gz = rng.integers(2, vox - 3, (R, NZ)).astype(np.float32)
    gz[:, NZ // 2:] += rng.uniform(0.1, 0.9, (R, NZ // 2))
    zz, on_z = _z_on_grid(gz, vox)
    on_z[:, NZ // 2:] = False
    assert on_z[:, :NZ // 2].mean() > 0.8
    zero = np.zeros((R, NZ), np.float32)
    points = torch.tensor(np.concatenate(
        [np.stack([px, py, pz], axis=-1), np.stack([zero, zero, zz], -1)],
        axis=1), device=cuda)
    on_y, on_x = (np.pad(m, ((0, 0), (0, NZ))) for m in (on_y, on_x))
    on_z = np.pad(on_z, ((0, 0), (N, 0)))
    quat = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * R, device=cuda)
    # the plain transform lands there too: the emulation is the card's
    gc = (pc_perspective_transform_t(points, quat).flip(1) + 0.5) * vox - 0.5
    for axis, on in ((0, on_z), (1, on_y), (2, on_x)):
        assert bool((gc[:, axis][torch.tensor(on, device=cuda)] % 1
                     == 0).all())
    sigma = torch.tensor(1.5, device=cuda)
    dsil = torch.tensor(rng.normal(size=(R, vox, vox)), dtype=torch.float32,
                        device=cuda)
    acc = "bfloat16" if bf16 else "float32"

    def grads(route):
        (d,) = _grads(
            lambda p, q, w, t: route(p, q, vox, sigma, radius, w, False, acc,
                                     save_grid),
            points, None, quat, dsil, None)
        return d.cpu().numpy()

    d = grads(_kernel)
    _report("d points along an integer axis (y, x, z)", max(
        np.abs(d[..., 1][on_y]).max(), np.abs(d[..., 0][on_x]).max(),
        np.abs(d[..., 2][on_z]).max()), None, 0)
    assert (d[..., 1][on_y] == 0).all() and (d[..., 0][on_x] == 0).all()
    assert (d[..., 2][on_z] == 0).all()
    if bf16:
        # rounded cotangents are often exactly equal at a point's two
        # corners (rays with no occupancy take dsil at every z), so exact
        # zeros arise off the integers too: hold the gradient to the plain
        # bfloat16 backward instead, which gives 0 where the kernel must
        want = grads(_plain)
        _report("d points", d, want, BF16_SHARE * np.abs(want).max())
        assert np.abs(d - want).max() <= BF16_SHARE * np.abs(want).max()
        return
    assert (d[:, :half, 0] != 0).mean() > 0.99  # x off the integers
    assert (d[:, half:N, 1] != 0).mean() > 0.99  # y off the integers
    assert (d[:, N + NZ // 2:, 2] != 0).all()  # z off the integers


def _splat_inputs(cuda, renders, n, vox, seed, keep=None):
    """Seeded kernel inputs as the renderer makes them (splat_params):
    points in [-0.45, 0.45], scales in rgb_splats' bounds, random local
    rotations, opacity times dropout weights (0 or 1 / keep) when keep."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(renders, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pw = rng.uniform(size=(renders, n))
    if keep is not None:
        pw = pw * (rng.random((renders, n)) < keep) / keep
    arrs = [rng.uniform(-0.45, 0.45, (renders, n, 3)),
            rng.uniform(0.005, 0.06, (renders, n, 3)), q, pw,
            rng.uniform(size=(renders, n, 3))]
    pts, scales, rot, pw, rgb = (
        torch.tensor(a, dtype=torch.float32, device=cuda) for a in arrs)
    mu, A6, w, rz = gsplat.splat_params(pts, scales, rot, vox, pw)
    return mu, A6, w, rgb, rz


@pytest.mark.parametrize(
    "renders,n,vox,with_rgb",
    [
        (32, 4096, 32, True),  # the rgb_splats training render
        (8, 4096, 32, False),  # density only
        (3, 1000, 16, True),  # N % 128 != 0: pads in the last chunk
        (2, 2000, 64, True),  # D 64: 16 cells a thread
        (4, 300, 8, False),  # D 8: 1 cell a thread
        (4, 256, 32, True),  # one chunk, C 256
        (3, 1000, 64, True),  # D 64 with pads in the last chunk
        (2, 500, 24, True),  # D 24: rows of 6 threads, 4 x each
    ],
)
def test_aniso_kernel_matches_plain(cuda, renders, n, vox, with_rgb):
    mu, A6, w, rgb, rz = _splat_inputs(cuda, renders, n, vox, vox + n,
                                       keep=0.1)
    rgb = rgb if with_rgb else None
    before = aniso.LAUNCHES["aniso_render"]
    got = aniso.aniso_density(mu, A6, w, rgb, rz, vox)
    torch.cuda.synchronize()
    assert aniso.LAUNCHES["aniso_render"] == before + 1
    want = aniso.aniso_density_reference(mu, A6, w, rgb, rz, vox)
    got, want = (got, want) if with_rgb else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.device.type == "cuda"
        bound = 1e-4 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= bound
    assert want[0].max() > 0


@pytest.mark.parametrize("renders,n,vox,with_rgb", [
    (32, 4096, 32, True),  # the rgb_splats training render
    (4, 1000, 16, False),
    (2, 700, 64, True),
    (4, 256, 32, True),  # one chunk, C 256: two blocks a render
    (3, 1000, 64, True),  # quarter-plane stages, pads in the last chunk
    (2, 500, 24, True),  # D 24: the kernel's any-D form
])
def test_aniso_backward_matches_plain(cuda, renders, n, vox, with_rgb):
    """K7's gradients to (mu, A6, w, rgb) against autograd through the
    plain version, for a random linear functional of the density and
    colour grids, with opacity and dropout weights (keep 0.1)."""
    mu, A6, w, rgb, rz = _splat_inputs(cuda, renders, n, vox, vox + n + 1,
                                       keep=0.1)
    rng = np.random.default_rng(vox)
    ct = torch.tensor(rng.normal(size=(renders, 4 if with_rgb else 1, vox,
                                       vox, vox)),
                      dtype=torch.float32, device=cuda)

    def grads(fn):
        ins = [t.detach().requires_grad_()
               for t in (mu, A6, w, rgb if with_rgb else None)
               if t is not None]
        out = fn(*ins[:3], ins[3] if with_rgb else None, rz, vox)
        out = torch.cat([out[0][:, None], out[1]], 1) if with_rgb \
            else out[:, None]
        return torch.autograd.grad((out * ct).sum(), ins)

    before = aniso.LAUNCHES["aniso_render_bwd"]
    g_k = grads(aniso.aniso_density)
    torch.cuda.synchronize()
    assert aniso.LAUNCHES["aniso_render_bwd"] == before + 1
    g_p = grads(aniso.aniso_density_reference)
    for a, b in zip(g_k, g_p):
        assert b.abs().max() > 0
        rel = (torch.linalg.vector_norm(a - b)
               / torch.linalg.vector_norm(b)).item()
        assert rel <= 2e-4


def test_gsplat_project_on_card(cuda):
    """gsplat_impl: pallas reaches K6 and, backward, K7 once each, in each
    operand mode; dense launches nothing."""
    cfg = Config(vox_size=32, pc_rgb=True, pc_gauss=True,
                 gsplat_impl="pallas")
    rng = np.random.default_rng(5)
    pts = torch.tensor(rng.uniform(-0.3, 0.3, (2, 500, 3)),
                       dtype=torch.float32, device=cuda, requires_grad=True)
    scales = torch.full((2, 500, 3), 0.03, device=cuda)
    rot = torch.tensor([1.0, 0, 0, 0], device=cuda).repeat(2, 500, 1)
    opac = torch.rand(2, 500, device=cuda)
    rgb = torch.rand(2, 500, 3, device=cuda)
    q = torch.tensor([[1.0, 0, 0, 0]] * 2, device=cuda)
    before = dict(aniso.LAUNCHES)
    out = gsplat.gsplat_project(cfg, pts, q, scales, rot, opac, rgb)
    (out.silhouette.sum() + out.rgb.sum()).backward()
    torch.cuda.synchronize()
    assert aniso.LAUNCHES["aniso_render"] == before["aniso_render"] + 1
    assert aniso.LAUNCHES["aniso_render_bwd"] == \
        before["aniso_render_bwd"] + 1
    assert pts.grad.abs().max() > 0
    ref = gsplat.gsplat_project(cfg.replace(gsplat_impl="dense"), pts, q,
                                scales, rot, opac, rgb)
    assert (ref.silhouette - out.silhouette).abs().max() < 0.02
    assert aniso.LAUNCHES["aniso_render"] == before["aniso_render"] + 1
    pts.grad = None
    out = gsplat.gsplat_project(cfg.replace(pallas_acc_dtype="bfloat16"), pts,
                                q, scales, rot, opac, rgb)
    (out.silhouette.sum() + out.rgb.sum()).backward()
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in aniso.LAUNCHES.items()}
    assert made == {"aniso_render": 1, "aniso_render_bwd": 1,
                    "aniso_render_bf16": 1, "aniso_render_bwd_bf16": 1}, made
    assert pts.grad.isfinite().all() and pts.grad.abs().max() > 0


BF16_SHARE = 2.0**-8  # of the largest plain value: the splat's atomics
# reorder f32 sums, which can flip a bfloat16 rounding downstream


@pytest.mark.parametrize(
    "renders,n,vox,radius,with_depth,weights",
    [
        (32, 16000, 64, 8, True, True),  # the car_64_depth render
        (256, 2048, 32, 6, False, True),  # the chair_pred_pose render
        (4, 1000, 16, 2, True, False),
        (3, 777, 20, 3, False, True),  # D % 8 != 0, odd N
        (2, 600, 8, 7, True, True),  # one run a line, the widest R
        (3, 777, 20, 19, True, False),  # D % 8 != 0, the widest R
        (2, 5000, 64, 63, True, True),  # the widest radius at D 64
    ],
)
def test_bf16_kernels_match_plain(cuda, renders, n, vox, radius, with_depth,
                                  weights):
    """K1 and K2 in bfloat16 operand mode against the plain bfloat16
    forward and fused_backward_reference, on the same inputs: sil, depth
    and gradients within BF16_SHARE of the largest plain value; launches
    count under fused_render_bf16 and fused_render_bwd_bf16."""
    rng = np.random.default_rng(vox + n + 2)
    ndc = torch.tensor(rng.uniform(-0.6, 0.6, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    points, quat = _world(ndc)
    pw = (torch.tensor(rng.uniform(0, 2, (renders, n)), dtype=torch.float32,
                       device=cuda) if weights else None)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)

    def grads(route):
        return _grads(
            lambda p, q, w, t: route(p, q, vox, sigma, radius, w, with_depth,
                                     "bfloat16"),
            points, pw, quat, dsil, ddepth)

    before = dict(fused.LAUNCHES)
    g_k = grads(_kernel)
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in fused.LAUNCHES.items()}
    assert made == {k: int(k in ("fused_render_bf16",
                                 "fused_render_bwd_bf16")) for k in made}
    with torch.no_grad():
        s_k, d_k = _kernel(points, quat, vox, sigma, radius, pw, with_depth,
                           "bfloat16")
        s_p, d_p = _plain(points, quat, vox, sigma, radius, pw, with_depth,
                          "bfloat16")
    for a, b in ((s_k, s_p), (d_k, d_p)) if with_depth else ((s_k, s_p),):
        _report("forward", a, b, BF16_SHARE * b.abs().max())
        assert (a - b).abs().max().item() <= BF16_SHARE * b.abs().max()
    for i, (a, b) in enumerate(zip(g_k, grads(_plain))):
        bound = BF16_SHARE * b.abs().max().item()
        _report(f"gradient {i}", a, b, bound)
        assert bound > 0
        assert (a - b).abs().max().item() <= bound


BF16_FWD_SHARE, BF16_GRAD_L2 = 1e-5, 1e-3  # chip_smoke.py phase 3h's


@pytest.mark.parametrize("save_grid", [True, False])
@pytest.mark.parametrize(
    "renders,n,vox,radius,with_depth,weights",
    [
        (3, 3000, 72, 9, True, True),  # z-blocks of 8: up to 4 per halo row
        (2, 2000, 80, 10, False, True),  # z-blocks of 16
        (2, 2000, 96, 12, True, False),  # z-blocks of 32
        (2, 2000, 72, 71, True, True),  # the widest radius, z-blocks of 8
    ],
)
def test_bf16_blocked_kernels_match_plain(cuda, save_grid, renders, n, vox,
                                          radius, with_depth, weights):
    """The counterparts of K3 and K4 + K5 in bfloat16 operand mode (D > 64)
    against the plain bfloat16 forward and fused_backward_reference, with
    the saved grid and with the recompute: the forward within 1e-5 of the
    largest plain value, the gradients within BF16_SHARE of it and 1e-3 in
    relative L2; launches count as blocked_*_bf16 (the multicat_128 render
    itself: chip_smoke.py phase 3h). Control: the float32
    kernels on the same inputs miss the forward's and the relative L2
    limits."""
    rng = np.random.default_rng(vox + n + 3)
    ndc = torch.tensor(rng.uniform(-0.6, 0.6, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    ndc[:, :, : n // 2] *= 0.4  # a dense core: saturated rays
    points, quat = _world(ndc)
    pw = (torch.tensor((rng.random((renders, n)) < 0.1) * 10.0,
                       dtype=torch.float32, device=cuda) if weights else None)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)

    def grads(route, acc):
        return _grads(
            lambda p, q, w, t: route(p, q, vox, sigma, radius, w, with_depth,
                                     acc, save_grid),
            points, pw, quat, dsil, ddepth)

    before = dict(fused.LAUNCHES)
    g_k = grads(_kernel, "bfloat16")
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in fused.LAUNCHES.items()}
    bwd = ("blocked_render_bwd_bf16" if save_grid
           else "blocked_render_bwd_recompute_bf16")
    assert made == {k: int(k in ("blocked_render_bf16", bwd)) for k in made}
    g_f = grads(_kernel, "float32")
    with torch.no_grad():
        outs = [_kernel(points, quat, vox, sigma, radius, pw, with_depth, a)
                for a in ("bfloat16", "float32")]
        plain = _plain(points, quat, vox, sigma, radius, pw, with_depth,
                       "bfloat16")
    for i in range(2 if with_depth else 1):
        b = plain[i]
        peak = b.abs().max().item()
        _report(f"forward {i}", outs[0][i], b, BF16_FWD_SHARE * peak)
        _report(f"forward {i} control (must pass the limit)", outs[1][i], b,
                BF16_FWD_SHARE * peak)
        assert (outs[0][i] - b).abs().max().item() <= BF16_FWD_SHARE * peak
        assert (outs[1][i] - b).abs().max().item() > BF16_FWD_SHARE * peak
    g_p = grads(_plain, "bfloat16")
    seen = [((a - b).abs().max().item() / b.abs().max().item(),
             _rel_l2(a, b), _rel_l2(f, b)) for a, f, b in zip(g_k, g_f, g_p)]
    print(f"max abs of the largest, relative L2, control's relative L2: "
          f"{seen}")
    for share, rel, rel_f in seen:
        assert share <= BF16_SHARE
        assert rel <= BF16_GRAD_L2 < rel_f


def _rel_l2(a, b):
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def test_bf16_order_follows_the_grid_size(cuda):
    """At D 64 the bfloat16 kernels keep K1's pass order (y, x, z): they
    agree with the plain K1-order forward and lie farther from the K3-order
    one (z, x, y, what D > 64 takes), by more than the bound."""
    rng = np.random.default_rng(64)
    ndc = torch.tensor(rng.uniform(-0.5, 0.5, (4, 3, 8000)),
                       dtype=torch.float32, device=cuda)
    points, quat = _world(ndc)
    sigma = torch.tensor(0.05 * 64, device=cuda)
    with torch.no_grad():
        sil, _ = _kernel(points, quat, 64, sigma, 8, acc="bfloat16")
    seen = pc_perspective_transform_t(points, quat)  # the kernels' NDC
    k1, _ = fused.fused_project_reference(seen, 64, sigma, 8,
                                          acc_dtype="bfloat16")
    k3 = fused.drc_projection(fused._blurred(
        seen, 64, sigma, 8, None, fused._rnd, True)[0])[0]
    peak = k1.abs().max().item()
    _report("K1 order", sil, k1, BF16_FWD_SHARE * peak)
    _report("K3 order (must pass the limit)", sil, k3, BF16_FWD_SHARE * peak)
    assert (sil - k1).abs().max().item() <= BF16_FWD_SHARE * peak
    assert (sil - k3).abs().max().item() > BF16_FWD_SHARE * peak


def _lattice_world(cuda, renders, vox, seed):
    """World points [R, N, 3] and identity cameras whose grid coordinates
    put one point in each 2 x 2 x 2 block of cells, at a random offset in
    [0.01, 0.99) from the block's first cell (the margin takes the
    transform's rounding): every cell takes at most one splat
    contribution, so the atomics' order cannot change a sum."""
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(*[np.arange(0, vox - 1, 2)] * 3,
                                indexing="ij")).reshape(3, -1)
    g = base[None] + rng.uniform(0.01, 0.99, (renders, 3, base.shape[1]))
    ndc = torch.tensor((g[:, ::-1] + 0.5) / vox - 0.5, dtype=torch.float32,
                       device=cuda)
    return _world(ndc)


@pytest.mark.parametrize("vox,radius,with_depth", [(8, 7, True),
                                                   (20, 3, False),
                                                   (32, 6, False),
                                                   (64, 8, True),
                                                   (64, 63, True),
                                                   (72, 9, True),
                                                   (128, 16, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_kernels_repeat_bitwise(cuda, vox, radius, with_depth, bf16):
    """K1 and K2 at D <= 64, and the counterparts of K3 and K4 + K5 above,
    from world clouds, sum in a fixed order wherever no two points share a
    cell: two launches of the forward and of the backward on the saved
    grid give bitwise-equal outputs, and above D 64 (where remat selects
    it) two launches of the recompute backward equal the saved-grid one,
    in either operand mode. The cameras' gradients, summed by atomics
    across warps, are not asked for."""
    from dpcx_torch.render.gauss import gauss_kernel_1d

    renders = 3
    points, _ = _lattice_world(cuda, renders, vox, vox + radius)
    rot = torch.eye(3, device=cuda).expand(renders, 3, 3).contiguous()
    n = points.shape[1]
    gen = torch.Generator(device=cuda).manual_seed(vox)
    pw = torch.rand(renders, n, device=cuda, generator=gen) * 2
    dsil = torch.randn(renders, vox, vox, device=cuda, generator=gen)
    ddepth = (torch.randn(renders, vox, vox, device=cuda, generator=gen)
              if with_depth else None)
    taps = gauss_kernel_1d(torch.tensor(0.05 * vox + 0.1 * radius,
                                        device=cuda), radius).contiguous()
    camera = (FOCAL, DIST)
    fwd = [fused._launch_world_forward(points, pw, rot, None, camera, taps,
                                       radius, vox, with_depth, bf16)
           for _ in range(2)]
    grids = [fwd[0][2], fwd[1][2]] + [None, None] * (vox > 64)
    bwd = [fused._launch_world_backward(points, pw, rot, None, camera, taps,
                                        radius, grid, dsil, ddepth, vox,
                                        with_depth, True, False, bf16)
           for grid in grids]
    torch.cuda.synchronize()
    assert fwd[0][0].abs().max() > 0 and bwd[0][0].abs().max() > 0
    for a, b in zip(fwd[0], fwd[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    for out in bwd[1:]:
        for a, b in zip(bwd[0], out):
            assert (a is None and b is None) or torch.equal(a, b)


# K6/K7's bfloat16 mode against its plain version, per row group of the
# packed gradient (mu, A6, w, rgb)
SPLAT_GROUPS = (("mu", 0, 3), ("A6", 3, 9), ("w", 9, 10), ("rgb", 10, 13))


@pytest.mark.parametrize("renders,n,vox,with_rgb", [
    (4, 1000, 32, True),
    (4, 1000, 32, False),  # density only
    (2, 700, 64, True),  # D 64: quarter-plane stages, basis errors up to 8
    (3, 1000, 64, True),  # D 64 with pads in the last chunk
    (4, 256, 32, True),  # one chunk, C 256
])
def test_aniso_bf16_kernels_match_plain(cuda, renders, n, vox, with_rgb):
    """K6 and K7 in bfloat16 operand mode against the plain bfloat16
    forward and aniso_backward_reference (the raw moments of rnd(u) over
    dpcx's rounded basis): the forward within BF16_FWD_SHARE of the largest
    plain value, each gradient group within BF16_SHARE of its largest and
    BF16_GRAD_L2 in relative L2. The float32-mode kernels on the same inputs
    must miss the forward's and the relative L2 limits; launches count
    under aniso_render_bf16 and aniso_render_bwd_bf16."""
    mu, A6, w, rgb, rz = _splat_inputs(cuda, renders, n, vox, vox + n + 5,
                                       keep=0.1)
    pk = aniso.pack(mu, A6, w, rgb if with_rgb else None)
    z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, vox)
    table = aniso.chunk_table(mu[..., 0], rz, vox)
    ct = torch.randn(renders, 4 if with_rgb else 1, vox, vox, vox,
                     device=cuda, generator=torch.Generator(
                         device=cuda).manual_seed(vox))
    before = dict(aniso.LAUNCHES)
    fwd = {bf: aniso._launch_forward(pk, table, vox, with_rgb, bf)
           for bf in (True, False)}
    bwd = {bf: aniso._launch_backward(pk, table, ct, vox, with_rgb, bf)
           for bf in (True, False)}
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in aniso.LAUNCHES.items()}
    assert made == dict.fromkeys(made, 1), made
    want = aniso._render_plain(pk, z_lo, z_hi, vox, with_rgb, "bfloat16")
    peak = want.abs().max().item()
    err, ctl = ((fwd[bf] - want).abs().max().item() for bf in (True, False))
    print(f"forward: {err / peak:.3e} of the largest, control "
          f"{ctl / peak:.3e}")
    assert err <= BF16_FWD_SHARE * peak < ctl
    g_p = aniso.aniso_backward_reference(pk, z_lo, z_hi, ct, vox, with_rgb,
                                         "bfloat16")
    groups = SPLAT_GROUPS if with_rgb else SPLAT_GROUPS[:3]
    for label, a, b in groups:
        p = g_p[:, a:b]
        share = (bwd[True][:, a:b] - p).abs().max().item() / p.abs().max()
        rel, rel_f = (_rel_l2(bwd[bf][:, a:b], p) for bf in (True, False))
        print(f"d {label}: {share:.3e} of the largest, relative L2 "
              f"{rel:.3e}, control {rel_f:.3e}")
        assert share <= BF16_SHARE and rel <= BF16_GRAD_L2 < rel_f, label
    if not with_rgb:
        assert not bwd[True][:, 10:13].any()


def test_aniso_f32_backward_reference_is_the_derivative(cuda):
    """On the card, the float32 aniso_backward_reference against autograd
    through the plain forward: relative L2 within 2e-4 per row group (the
    plain side K7's kernel-vs-plain checks could take)."""
    mu, A6, w, rgb, rz = _splat_inputs(cuda, 4, 1000, 32, 77, keep=0.1)
    pk = aniso.pack(mu, A6, w, rgb).requires_grad_()
    z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, 32)
    ct = torch.randn(4, 4, 32, 32, 32, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(1))
    out = aniso._render_plain(pk, z_lo, z_hi, 32, True, "float32")
    want, = torch.autograd.grad((out * ct).sum(), pk)
    got = aniso.aniso_backward_reference(pk.detach(), z_lo, z_hi, ct, 32,
                                         True)
    for label, a, b in SPLAT_GROUPS:
        assert _rel_l2(got[:, a:b], want[:, a:b]) <= 2e-4, label


@pytest.mark.parametrize("renders,n,vox", [(8, 4096, 32), (3, 1000, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_aniso_kernels_repeat_bitwise(cuda, renders, n, vox, bf16):
    """K6 and K7 sum without atomics in a fixed order: two launches on the
    same inputs give bitwise-equal outputs, in either operand mode."""
    mu, A6, w, rgb, rz = _splat_inputs(cuda, renders, n, vox, n + vox,
                                       keep=0.1)
    pk = aniso.pack(mu, A6, w, rgb)
    table = aniso.chunk_table(mu[..., 0], rz, vox)
    ct = torch.randn(renders, 4, vox, vox, vox, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(n))
    fwd = [aniso._launch_forward(pk, table, vox, True, bf16)
           for _ in range(2)]
    bwd = [aniso._launch_backward(pk, table, ct, vox, True, bf16)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert fwd[0].abs().max() > 0 and bwd[0].abs().max() > 0
    assert torch.equal(fwd[0], fwd[1]) and torch.equal(bwd[0], bwd[1])


def _alignment_tie(cfg, params, card_params, ds):
    """The canonical alignments of the CPU's and the card's pooled poses:
    the rotation between the two picks (degrees, float64) and the relative
    gap between the CPU's mean errors at them."""
    from dpcx_torch.eval.pose_metrics import align_canonical_frame
    from dpcx_torch.geometry.quaternion import (
        quaternion_angular_distance,
        quaternion_multiply,
    )
    from dpcx_torch.predict import predict_dataset

    V = range(ds.num_views)
    gq = torch.from_numpy(np.concatenate(
        [ds.records["quats"][:, v] for v in V]).astype(np.float32))
    p_cpu, p_card = (torch.from_numpy(np.concatenate(
        [predict_dataset(cfg, p, ds, v, 2)["pose"] for v in V]))
        for p in (params, card_params))
    q_c, _ = align_canonical_frame(p_cpu, gq)
    q_g = align_canonical_frame(p_card.cuda(), gq.cuda())[0].cpu()

    def mean_err(q):
        return float(quaternion_angular_distance(
            quaternion_multiply(p_cpu, q[None]), gq).mean())

    a, b = q_c.double(), q_g.double() * torch.sign((q_c * q_g).sum())
    deg = np.degrees(4 * np.arctan2(float((a - b).norm()),
                                    float((a + b).norm())))
    return deg, abs(mean_err(q_g) - mean_err(q_c)) / mean_err(q_c)


def test_evaluate_on_card_matches_cpu(cuda):
    """predict.evaluate of one model on the card against the CPU, every
    branch (pooled views, flip resolve, per sample), at
    tests/test_torch_predict.py's config and tolerances: the metrics rtol
    1e-5 (the forward in float32, TF32 off), iou_3d_16 within 1e-2, the
    per-sample lists within one unit of their last decimal; the model runs
    where its params are, the metrics too. Where the two forwards' ~1e-6
    difference tips the canonical alignment's argmin between two
    candidates f32 cannot order (a tie: picks at most 1 degree apart, mean
    errors within 1e-5), the metrics that hang on it are held to the tie's
    bounds: 1 degree, 3 of the 15 samples, Chamfer 2e-3 relative, IoU
    2e-2."""
    from dpcx_torch.data.dataset import Dataset
    from dpcx_torch.data.synthetic import make_dataset
    from dpcx_torch.models.model_pc import ModelPointCloud
    from dpcx_torch.predict import evaluate

    cfg = Config(
        vox_size=16, mask_size=16, pc_num_points=256, image_size=16,
        encoder_filters=(8, 16), latent_dim=24, fc_hidden=32,
        pc_decoder_hidden=(32,), num_views=3, views_per_step=3,
        batch_size=2, compute_dtype="float32", pc_relative_sigma=0.1,
        predict_pose=True, pose_predict_num_candidates=4, pose_student=True,
        pose_from_views=True,
    )
    ds = Dataset({k: v.numpy() for k, v in make_dataset(
        cfg, 5, seed=3, gt_points=200).items()}, cfg)
    params = ModelPointCloud(cfg).state_dict()
    kw = dict(view_idx=None, flip_resolve=True, per_sample=True,
              batch_size=2)
    card_params = {k: v.to(cuda) for k, v in params.items()}
    want = evaluate(cfg, params, ds, **kw)
    got = evaluate(cfg, card_params, ds, **kw)
    assert list(got) == list(want)
    ps, ps_want = got.pop("per_sample"), want.pop("per_sample")
    assert list(ps) == list(ps_want)

    def misses(k) -> bool:
        if k == "iou_3d_16":
            return abs(got[k] - want[k]) > 1e-2
        return abs(got[k] - want[k]) > 1e-5 * abs(want[k]) + 1e-7

    def ps_misses(k) -> bool:
        unit = {"res_axis": 1e-4, "chamfer": 1e-6, "view": 0}.get(k, 1e-2)
        a, b = np.asarray(ps[k], float), np.asarray(ps_want[k], float)
        return bool((np.abs(a - b) > 1e-5 * np.abs(b) + unit * 1.001).any())

    missed = [k for k in want if misses(k)] + [k for k in ps if ps_misses(k)]
    if missed:
        # only a tie of the alignment's argmin may explain a miss: two picks
        # whose mean errors f32 cannot order (chip_smoke.py's TIE_* bounds)
        deg, gap = _alignment_tie(cfg, params, card_params, ds)
        assert 2e-3 < deg <= 2.0 and gap <= 1e-5, (missed, deg, gap)
        assert not {"view", "gauge_spread_deg",
                    "flip_resolve_changed"} & set(missed), missed
        for k in want:
            bound = (2e-2 if k == "iou_3d_16" else 2e-3 * want[k]
                     if "chamfer" in k else 1.0 if "deg" in k else 3 / 15)
            assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k])


def test_bench_on_card(cuda):
    """The bench at a small shape on the card: every key finite and
    positive, no error, parity true in both modes; each key's launches
    are its kernels' (the D 64 keys on the D <= 64 route in both modes,
    the D 128 ones on the blocked route, the pallas splat keys K6/K7),
    and the eager splat forms launch nothing."""
    from dpcx_torch import bench

    shapes = bench.Shapes(renders=4, points=2048, iters=3, b16_renders=2,
                          d128=(2, 2000), gsplat=(2, 512))
    rec = bench.bench(cuda, shapes)
    assert not bench.failed(rec), rec
    assert rec["parity_ok"] is True
    for key in bench.KEYS:
        for v in (rec[key], rec[key + "_host"], rec[key + "_ms"]):
            assert math.isfinite(v) and v > 0, (key, v)
        if "dense" in key or key == "gsplat_fwdbwd_value":
            assert rec[key + "_bound"] is None and not rec[key + "_launches"]
        else:
            assert 0 < rec[key + "_share"] < 1, (key, rec[key + "_share"])
    families = {
        "value": {"fused_render_bf16"},
        "fp32_value": {"fused_render"},
        "fwdbwd_value": {"fused_render_bf16", "fused_render_bwd_bf16"},
        "d128_value": {"blocked_render_bf16"},
        "d128_fwdbwd_value": {"blocked_render_bf16",
                              "blocked_render_bwd_bf16"},
        "gsplat_pallas_fwdbwd_value": {"aniso_render", "aniso_render_bwd"},
        "gsplat_pallas_d64_fwdbwd_value": {"aniso_render_bf16",
                                           "aniso_render_bwd_bf16"},
    }
    for key, names in families.items():
        assert set(rec[key + "_launches"]) == names, (key, rec)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_windowed_on_card_matches_cpu(cuda, with_rgb):
    """gsplat's windowed form (eager, remat on) on the card against the
    CPU on the same inputs: the density grid within 1e-5, the colour grid
    within 1e-5 where the density it is divided by exceeds 1e-3 (as
    tests/test_torch_gsplat.py holds colours), and the gradients of a
    squared error within 1e-5 of the largest (f32 with TF32 off, sums in
    other orders)."""
    rng = np.random.default_rng(21)
    B, N, D = 2, 700, 32
    rot = rng.normal(size=(B, N, 4))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    arrs = [rng.uniform(-0.4, 0.4, (B, N, 3)),
            rng.uniform(0.005, 0.06, (B, N, 3)), rot,
            rng.uniform(size=(B, N)), rng.uniform(size=(B, N, 3))]
    tgt = rng.uniform(size=(B, D, D, D))

    def run(device):
        pts, scales, rot_, opac, rgb = (
            torch.tensor(a, dtype=torch.float32, device=device) for a in arrs)
        ins = [t.requires_grad_() for t in (pts, scales, rot_, opac)]
        out = gsplat.anisotropic_density_grid_windowed(
            *ins[:3], D, ins[3], rgb if with_rgb else None)
        dens = out[0] if with_rgb else out
        loss = ((dens - torch.tensor(tgt, dtype=torch.float32,
                                     device=device)) ** 2).mean()
        if with_rgb:  # the colour weighted by the density it divides
            loss = loss + (out[1] * dens[..., None]).mean()
        grads = torch.autograd.grad(loss, ins)
        outs = out if with_rgb else (out,)
        return [t.detach().cpu() for t in (*outs, *grads)]

    got, want = run(cuda), run(torch.device("cpu"))
    if with_rgb:  # the colour where the density it divides is > 1e-3
        mask = want[0] > 1e-3
        assert mask.float().mean() > 0.05
        got[1], want[1] = got[1][mask], want[1][mask]
    n_out = 2 if with_rgb else 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert b.abs().max() > 0, i
        bound = 1e-5 if i < n_out else 1e-5 * b.abs().max().item()
        assert (a - b).abs().max().item() <= bound, (i, (a - b).abs().max())


def test_train_profile_dir_on_card(cuda, tmp_path):
    """train with profile_dir on the card: one Chrome trace, of the chunk
    after the first (log_every 2, save_every 3: steps 2 and 3 of 6), with
    the renderer's CUDA kernels in it; the logged losses equal those of
    the run without it within rtol 1e-5 (the splat's atomics reorder f32
    sums from run to run, with or without the trace)."""
    from dpcx_torch.data.dataset import Dataset
    from dpcx_torch.data.synthetic import make_dataset
    from dpcx_torch.train import train

    cfg = Config(
        vox_size=16, mask_size=16, pc_num_points=256, image_size=16,
        encoder_filters=(8, 16), latent_dim=24, fc_hidden=32,
        pc_decoder_hidden=(32,), num_views=3, views_per_step=2,
        batch_size=2, compute_dtype="float32", renderer="pallas",
        log_every=2, save_every=3, checkpoint_dir=str(tmp_path / "run"),
    )
    ds = Dataset({k: v.numpy() for k, v in make_dataset(
        cfg, 4, seed=3).items()}, cfg)
    _, want = train(cfg, dataset=ds, max_steps=6, device="cuda",
                    use_checkpoints=False)
    prof = tmp_path / "prof"
    before = fused.LAUNCHES["fused_render"]
    _, got = train(cfg.replace(profile_dir=str(prof)), dataset=ds,
                   max_steps=6, device="cuda", use_checkpoints=False)
    assert fused.LAUNCHES["fused_render"] == before + 6
    (path,) = prof.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("splat_kernel" in k for k in kernels), sorted(kernels)[:20]
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want):
        assert a["loss_total"] == pytest.approx(b["loss_total"], rel=1e-5)


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("batch,n,keep", [
    (8, 16000, 0.1),  # car_64_depth
    (4, 131072, 1.0),  # largecloud_pointshard
    (3, 777, 0.5),
    (1, 1, 0.3),
])
def test_dropout_weights_kernel_matches_plain(cuda, batch, n, keep):
    """csrc/prng.cu's dropout weights against the plain version in torch
    ops on the card, bitwise, one launch a call."""
    from dpcx_torch.render.voxelize import pc_point_dropout_weights
    from dpcx_torch.utils import prng

    before = prng.LAUNCHES["dropout_weights"]
    for step in (0, 9999, 2**31 - 1):
        key = prng.split(prng.fold_in(prng.prng_key(1), step), 4)[3]
        got = pc_point_dropout_weights(key, batch, n, keep, cuda)
        want = prng.dropout_weights_plain(key, batch, n, keep, cuda)
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and _same_bits(got, want), step
    assert prng.LAUNCHES["dropout_weights"] == before + 3


@pytest.mark.parametrize("B,M,V,V_use", [
    (8, 200, 5, 4),  # car_64_depth over 200 models
    (16, 32, 5, 4),
    (4, 3, 1, 1),
    (300, 7, 64, 3),  # two blocks of rows, the most views
])
@pytest.mark.parametrize("with_in2", [False, True])
def test_batch_draws_kernel_matches_plain(cuda, B, M, V, V_use, with_in2):
    """csrc/prng.cu's gather rows against the plain version on the card,
    bitwise, with and without the second input view."""
    from dpcx_torch.utils import prng

    before = prng.LAUNCHES["batch_draws"]
    for step in (0, 9999, 2**31 - 1):
        kk = prng.fold_in(prng.prng_key(1), step)
        keys = (*prng.split(kk, 4)[:3],
                prng.fold_in(kk, 7) if with_in2 else None)
        got = prng.batch_draws(*keys, B, M, V, V_use, cuda)
        want = prng.batch_draws_plain(*keys, B, M, V, V_use, cuda)
        torch.cuda.synchronize()
        assert _same_bits(got, want), step
    assert prng.LAUNCHES["batch_draws"] == before + 3


# a small car_64_depth: D 64, depth with DRC, point dropout, bf16 nets; two
# points a cloud, so no cell of K1's atomic splat takes more than two
# addends and its sums cannot reorder from run to run
SYNC_FREE = Config(
    vox_size=64, mask_size=64, pc_num_points=2, image_size=16,
    encoder_filters=(8, 16), latent_dim=24, fc_hidden=32,
    pc_decoder_hidden=(32,), num_views=3, views_per_step=2, batch_size=2,
    renderer="pallas", proj_depth=True, drc_weight=0.1,
    pc_point_dropout=0.5, compute_dtype="bfloat16", seed=2,
)  # seed 2: both steps keep a point, so the gradients are not zero


def _parent_loss_sigma(cfg, step, device=None):
    """The loss's sigma as the parent made it: a host tensor copied to the
    card, which synchronises the stream."""
    from dpcx_torch.render.project import sigma_schedule

    return sigma_schedule(cfg, step).to(device)


def _parent_predict_sigma(cfg, step, device=None):
    """The mirror pass's sigma as the parent made it: a host tensor, copied
    to the card by each renderer call."""
    from dpcx_torch.render.project import sigma_schedule

    return sigma_schedule(cfg, step)


def _sync_count(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``: (its result, the
    synchronising CUDA operations it made)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing" in str(w.message) for w in caught)


def test_train_chunk_makes_no_stream_sync(cuda, monkeypatch):
    """A two-step chunk of ``train_steps_scan`` raises nothing under
    ``set_sync_debug_mode("error")``, and gives the loss, metrics,
    parameters and Adam state, bit for bit, of the same steps with the
    sigma made as the parent made it (a host tensor copied to the card,
    which the mode refuses). The mirror pass of ``predict.py`` reads numpy
    and returns numpy, so it syncs for those; on the same two steps' clouds
    it makes one sync a batch fewer than with the parent's sigma, and the
    same flips."""
    from dpcx_torch import predict
    from dpcx_torch.data.dataset import Dataset
    from dpcx_torch.data.synthetic import make_dataset
    from dpcx_torch.models import losses
    from dpcx_torch.render.project import sigma_schedule
    from dpcx_torch.train import create_state, device_records, train_steps_scan
    from dpcx_torch.utils import prng

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = SYNC_FREE
    ds = Dataset({k: v.cpu().numpy() for k, v in make_dataset(
        cfg, 4, seed=5, gt_points=2000, device=cuda).items()}, cfg)
    records = device_records(ds, cuda)
    key = prng.prng_key(cfg.seed)

    def chunk(sigma_fn):
        state = create_state(cfg, cuda, seed=0)
        with monkeypatch.context() as m:
            m.setattr(losses, "sigma_schedule", sigma_fn)
            metrics = train_steps_scan(cfg, state, records, key, 2)
        torch.cuda.synchronize()
        return state, metrics

    want_state, want = chunk(_parent_loss_sigma)  # also loads the kernels
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_state, got = chunk(sigma_schedule)
        with pytest.raises(RuntimeError, match="synchroniz"):
            chunk(_parent_loss_sigma)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.keys() == want.keys() and "sigma_rel" in got
    assert want["grad_norm"].item() > 0
    assert got["sigma_rel"].device.type == "cuda"
    assert _same_bits(got["sigma_rel"].cpu(), sigma_schedule(cfg, 1))
    for k in want:
        assert _same_bits(got[k], want[k]), k
    assert got_state.step == want_state.step == 2
    for (k, a), b in zip(got_state.model.named_parameters(),
                         want_state.model.parameters()):
        assert _same_bits(a.detach(), b.detach()), k
        sa = got_state.optimizer.state[a]
        sb = want_state.optimizer.state[b]
        for m in ("exp_avg", "exp_avg_sq"):
            assert _same_bits(sa[m], sb[m]), (k, m)

    with torch.no_grad():
        points = got_state.model(records["images"][:, 0])["points"]
    args = (cfg, points.float().cpu().numpy(),
            records["quats"][:, 0].cpu().numpy(),
            records["masks"][:, 0].cpu().numpy())
    batches = 2  # 4 models, 2 a batch
    new, n_new = _sync_count(
        lambda: predict.resolve_pose_flips(*args, batch_size=2, device=cuda))
    with monkeypatch.context() as m:
        m.setattr(predict, "sigma_schedule", _parent_predict_sigma)
        old, n_old = _sync_count(lambda: predict.resolve_pose_flips(
            *args, batch_size=2, device=cuda))
    assert n_old - n_new == batches, (n_old, n_new)
    np.testing.assert_array_equal(new[0], old[0])
    assert new[1] == old[1]


def test_pose_chunk_makes_no_stream_sync(cuda):
    """A whole 100-step chunk of ``train_steps_scan`` at
    ``chair_pred_pose``'s configuration and the benchmark's B 512 (K 8
    candidates of 4 target views: 16,384 renders of 2,048 points at D 32
    a step, 2,560 images encoded) raises nothing under
    ``set_sync_debug_mode("error")``: the predicted-pose step makes no
    stream sync. Its metrics stay finite."""
    from pathlib import Path

    from dpcx_torch.config import load_config
    from dpcx_torch.train import create_state, train_steps_scan
    from dpcx_torch.utils import prng

    cfg = load_config(Path(__file__).resolve().parent.parent / "experiments"
                      / "chair_pred_pose.yaml").replace(batch_size=512)
    g = torch.Generator(device=cuda).manual_seed(11)
    M, V, S, D = 32, cfg.num_views, cfg.image_size, cfg.mask_size
    quats = torch.randn(M, V, 4, generator=g, device=cuda)
    records = {
        "images": torch.rand(M, V, S, S, 3, generator=g, device=cuda),
        "masks": (torch.rand(M, V, D, D, generator=g, device=cuda)
                  < 0.3).float(),
        "depths": torch.ones(M, V, D, D, device=cuda),
        "quats": quats / quats.norm(dim=-1, keepdim=True)}
    state = create_state(cfg, cuda, seed=0)
    key = prng.prng_key(1)
    train_steps_scan(cfg, state, records, key, 2)  # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = train_steps_scan(cfg, state, records, key, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 102
    assert {"loss_student", "gauge_spread_deg"} <= set(metrics)
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
