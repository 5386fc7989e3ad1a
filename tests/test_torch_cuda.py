"""The port's CUDA kernels on the card, against their plain PyTorch version.

Every test here needs a CUDA card and skips without one. Run them on the
card with:

    python -m pytest tests/test_torch_cuda.py -q

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

import numpy as np
import pytest
import torch

from dpcx_torch.config import Config
from dpcx_torch.render import aniso, fused, gsplat
from dpcx_torch.render.project import pointcloud_project_fn

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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
    ],
)
def test_kernel_matches_plain(cuda, renders, n, vox, radius, with_depth,
                              weights, lim):
    rng = np.random.default_rng(vox + n)
    ndc = torch.tensor(rng.uniform(-lim, lim, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    pw = (torch.tensor(rng.uniform(0, 1, (renders, n)), dtype=torch.float32,
                       device=cuda) if weights else None)
    sigma = torch.tensor(0.05 * vox, device=cuda)
    key = "blocked_render" if vox > 64 else "fused_render"
    before = fused.LAUNCHES[key]
    s_k, d_k = fused.fused_project_t(ndc, vox, sigma, radius,
                                     point_weights=pw, with_depth=with_depth)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    s_p, d_p = fused.fused_project_reference(
        ndc, vox, sigma, radius, point_weights=pw, with_depth=with_depth
    )
    assert s_k.shape == (renders, vox, vox) and s_k.device.type == "cuda"
    torch.testing.assert_close(s_k, s_p, atol=ATOL, rtol=0)
    if with_depth:
        torch.testing.assert_close(d_k, d_p, atol=ATOL, rtol=0)
    else:
        assert d_k is None


def test_kernel_refuses_bad_inputs(cuda):
    ndc = torch.zeros(2, 3, 64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fused.fused_project_t(ndc.double(), 16, 0.8, 2)
    with pytest.raises(ValueError, match="point_weights"):
        fused.fused_project_t(ndc, 16, 0.8, 2,
                              point_weights=torch.ones(2, 64))  # on cpu
    # an input that requires grad goes through K1 and, backward, K2
    before = dict(fused.LAUNCHES)
    sil, _ = fused.fused_project_t(ndc.requires_grad_(), 16, 0.8, 2)
    sil.sum().backward()
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_render"] == before["fused_render"] + 1
    assert fused.LAUNCHES["fused_render_bwd"] == \
        before["fused_render_bwd"] + 1
    assert ndc.grad.shape == ndc.shape


def _grads(fn, ndc, pw, dsil, ddepth):
    """d/d(ndc) and d/d(weights) of <dsil, sil> + <ddepth, depth>."""
    ndc = ndc.detach().requires_grad_()
    pw = None if pw is None else pw.detach().requires_grad_()
    sil, depth = fn(ndc, pw)
    loss = (sil * dsil).sum()
    if depth is not None:
        loss = loss + (depth * ddepth).sum()
    inputs = [ndc] if pw is None else [ndc, pw]
    return torch.autograd.grad(loss, inputs)


def _assert_grads_close(got, plain, ndc, vox):
    """Each kernel gradient within 1e-3 of the largest plain one. d ndc
    along an axis whose grid coordinate is an exact integer (a few of a
    million random f32 coordinates are) is 0 from the kernels, as dpcx's
    _dhat_t gives, and one-sided from the plain version's floor-based
    derivative: there it must be 0, and is not compared."""
    coords = (ndc.flip(1) + 0.5) * vox - 0.5  # as fused._kernel_project
    on_int = (coords == coords.floor()).flip(1)
    for i, (a, b) in enumerate(zip(got, plain)):
        bound = 1e-3 * b.abs().max().item()
        assert bound > 0
        if i == 0:
            assert (a[on_int] == 0).all()
            a, b = a[~on_int], b[~on_int]
        assert (a - b).abs().max().item() <= bound


@pytest.mark.parametrize(
    "renders,n,vox,radius,with_depth,weights,lim",
    [
        (32, 16000, 64, 8, True, True, 0.6),  # the car_64_depth step
        (64, 8000, 32, 4, False, True, 0.6),  # the chair_gt_pose step
        (4, 1000, 16, 2, True, False, 0.7),
        (3, 777, 24, 3, False, False, 0.45),
        (2, 5000, 64, 63, True, True, 0.55),  # the widest radius
    ],
)
def test_backward_kernel_matches_plain(cuda, renders, n, vox, radius,
                                       with_depth, weights, lim):
    """K2's gradients against autograd through the plain version, for a
    random linear functional of sil and depth. Bound: 1e-3 of the largest
    plain gradient (atomic splat sums reorder from run to run)."""
    rng = np.random.default_rng(vox + n + 1)
    ndc = torch.tensor(rng.uniform(-lim, lim, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    pw = (torch.tensor(rng.uniform(0, 2, (renders, n)), dtype=torch.float32,
                       device=cuda) if weights else None)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)
    before = fused.LAUNCHES["fused_render_bwd"]
    g_k = _grads(
        lambda x, w: fused.fused_project_t(
            x, vox, sigma, radius, point_weights=w, with_depth=with_depth),
        ndc, pw, dsil, ddepth,
    )
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_render_bwd"] == before + 1
    g_p = _grads(
        lambda x, w: fused.fused_project_reference(
            x, vox, sigma, radius, point_weights=w, with_depth=with_depth),
        ndc, pw, dsil, ddepth,
    )
    _assert_grads_close(g_k, g_p, ndc, vox)


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
    ],
)
def test_blocked_backward_matches_plain(cuda, save_grid, renders, n, vox,
                                        radius, with_depth, lim):
    """The D > 64 backward (the counterparts of K4 + K5), with the saved
    grid and with the recompute, against autograd through the plain
    version, with dropout weights; the two modes against each other."""
    rng = np.random.default_rng(vox + n + radius)
    ndc = torch.tensor(rng.uniform(-lim, lim, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    pw = torch.tensor((rng.random((renders, n)) < 0.5) / 0.5,
                      dtype=torch.float32, device=cuda)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)
    key = "blocked_render_bwd" + ("" if save_grid else "_recompute")
    before = dict(fused.LAUNCHES)

    def kernel(save):
        return _grads(
            lambda x, w: fused.fused_project_t(
                x, vox, sigma, radius, point_weights=w,
                with_depth=with_depth, save_grid=save),
            ndc, pw, dsil, ddepth,
        )

    g_k = kernel(save_grid)
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before[key] + 1
    assert fused.LAUNCHES["blocked_render"] == before["blocked_render"] + 1
    g_p = _grads(
        lambda x, w: fused.fused_project_reference(
            x, vox, sigma, radius, point_weights=w, with_depth=with_depth),
        ndc, pw, dsil, ddepth,
    )
    _assert_grads_close(g_k, g_p, ndc, vox)
    g_o = kernel(not save_grid)
    for a, b, o in zip(g_k, g_p, g_o):
        assert (a - o).abs().max().item() <= 1e-3 * b.abs().max().item()


def test_blur_yx_launch_at_d128(cuda):
    """At D 128 blur_yx_kernel needs 128 KiB of shared memory and more
    with the widest radius (above the 48 KiB default): the launch is
    accepted and the result right."""
    rng = np.random.default_rng(128)
    ndc = torch.tensor(rng.uniform(-0.5, 0.5, (2, 3, 3000)),
                       dtype=torch.float32, device=cuda)
    for radius in (16, 127):
        sigma = torch.tensor(0.02 * 128 * (1 + radius / 16), device=cuda)
        s_k, d_k = fused.fused_project_t(ndc, 128, sigma, radius,
                                         with_depth=True)
        torch.cuda.synchronize()
        s_p, d_p = fused.fused_project_reference(ndc, 128, sigma, radius,
                                                 with_depth=True)
        torch.testing.assert_close(s_k, s_p, atol=ATOL, rtol=0)
        torch.testing.assert_close(d_k, d_p, atol=ATOL, rtol=0)


@pytest.mark.parametrize("vox,save_grid,bf16", [(32, True, False),
                                                (72, True, False),
                                                (72, False, False),
                                                (32, True, True)])
def test_integer_coordinate_gradient_is_zero(cuda, vox, save_grid, bf16):
    """Along an axis whose grid coordinate is an exact integer the hat's
    derivative is 0, as dpcx's _dhat_t gives (the plain version's
    floor-based derivative is one-sided there): K2's backward in both
    operand modes and the D > 64 backward in both grid modes."""
    from dpcx_torch.render.gauss import gauss_kernel_1d

    rng = np.random.default_rng(vox)
    R, N, radius = 2, 400, 3
    g = rng.uniform(2, vox - 3, (R, 3, N)).astype(np.float32)
    g[:, 0, : N // 2] = np.round(g[:, 0, : N // 2])  # integer z
    g[:, 2, N // 2 :] = np.round(g[:, 2, N // 2 :])  # integer x
    coords = torch.tensor(g, device=cuda, requires_grad=True)
    taps = gauss_kernel_1d(torch.tensor(1.5, device=cuda), radius)
    sil = fused._FusedRender.apply(coords, None, taps.contiguous(), radius,
                                   vox, False, save_grid, bf16)
    dsil = torch.tensor(rng.normal(size=(R, vox, vox)), dtype=torch.float32,
                        device=cuda)
    (d,) = torch.autograd.grad((sil * dsil).sum(), coords)
    d = d.cpu().numpy()
    assert (d[:, 0, : N // 2] == 0).all() and (d[:, 2, N // 2 :] == 0).all()
    if bf16:
        # rounded cotangents are often exactly equal at a point's two
        # corners (rays with no occupancy take dsil at every z), so exact
        # zeros arise off the integers too: hold the gradient to the plain
        # bfloat16 backward instead, which gives 0 where the kernel must
        ndc = ((coords.detach() + 0.5) / vox - 0.5).flip(1)
        want, _ = fused.fused_backward_reference(
            ndc, vox, torch.tensor(1.5, device=cuda), radius, None, False,
            dsil, None, "bfloat16")
        want = (want / vox).flip(1).cpu().numpy()  # d ndc -> d coords
        assert np.abs(d - want).max() <= BF16_SHARE * np.abs(want).max()
        return
    assert (d[:, 1] != 0).mean() > 0.99  # y is never an integer here
    assert (d[:, 0, N // 2 :] != 0).mean() > 0.99


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
    pw = (torch.tensor(rng.uniform(0, 2, (renders, n)), dtype=torch.float32,
                       device=cuda) if weights else None)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)
    before = dict(fused.LAUNCHES)
    g_k = _grads(
        lambda x, w: fused.fused_project_t(
            x, vox, sigma, radius, point_weights=w, with_depth=with_depth,
            acc_dtype="bfloat16"),
        ndc, pw, dsil, ddepth,
    )
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in fused.LAUNCHES.items()}
    assert made == {k: int(k in ("fused_render_bf16",
                                 "fused_render_bwd_bf16")) for k in made}
    with torch.no_grad():
        s_k, d_k = fused.fused_project_t(
            ndc, vox, sigma, radius, point_weights=pw, with_depth=with_depth,
            acc_dtype="bfloat16")
    s_p, d_p = fused.fused_project_reference(
        ndc, vox, sigma, radius, point_weights=pw, with_depth=with_depth,
        acc_dtype="bfloat16")
    for a, b in ((s_k, s_p), (d_k, d_p)) if with_depth else ((s_k, s_p),):
        assert (a - b).abs().max().item() <= BF16_SHARE * b.abs().max()
    g_p = fused.fused_backward_reference(
        ndc, vox, sigma, radius, pw, with_depth, dsil,
        ddepth if with_depth else None, "bfloat16")
    for a, b in zip(g_k, g_p):
        bound = BF16_SHARE * b.abs().max().item()
        assert bound > 0
        assert (a - b).abs().max().item() <= bound


BF16_FWD_SHARE, BF16_GRAD_L2 = 1e-5, 1e-3  # chip_smoke.py phase 3c's


@pytest.mark.parametrize("save_grid", [True, False])
@pytest.mark.parametrize(
    "renders,n,vox,radius,with_depth,weights",
    [
        (3, 3000, 72, 9, True, True),  # z-blocks of 8: up to 4 per halo row
        (2, 2000, 80, 10, False, True),  # z-blocks of 16
        (2, 2000, 96, 12, True, False),  # z-blocks of 32
    ],
)
def test_bf16_blocked_kernels_match_plain(cuda, save_grid, renders, n, vox,
                                          radius, with_depth, weights):
    """The counterparts of K3 and K4 + K5 in bfloat16 operand mode (D > 64)
    against the plain bfloat16 forward and fused_backward_reference, with
    the saved grid and with the recompute: the forward within 1e-5 of the
    largest plain value, the gradients within BF16_SHARE of it and 1e-3 in
    relative L2; launches count as blocked_*_bf16 (the multicat_128 render
    itself: chip_smoke.py phase 3c). Control: the float32
    kernels on the same inputs miss the forward's and the relative L2
    limits."""
    rng = np.random.default_rng(vox + n + 3)
    ndc = torch.tensor(rng.uniform(-0.6, 0.6, (renders, 3, n)),
                       dtype=torch.float32, device=cuda)
    ndc[:, :, : n // 2] *= 0.4  # a dense core: saturated rays
    pw = (torch.tensor((rng.random((renders, n)) < 0.1) * 10.0,
                       dtype=torch.float32, device=cuda) if weights else None)
    dsil = torch.tensor(rng.normal(size=(renders, vox, vox)),
                        dtype=torch.float32, device=cuda)
    ddepth = torch.tensor(rng.normal(size=(renders, vox, vox)),
                          dtype=torch.float32, device=cuda)
    sigma = torch.tensor(0.05 * vox, device=cuda)

    def kernel(acc_dtype):
        return _grads(
            lambda x, w: fused.fused_project_t(
                x, vox, sigma, radius, point_weights=w,
                with_depth=with_depth, acc_dtype=acc_dtype,
                save_grid=save_grid),
            ndc, pw, dsil, ddepth)

    before = dict(fused.LAUNCHES)
    g_k = kernel("bfloat16")
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in fused.LAUNCHES.items()}
    bwd = ("blocked_render_bwd_bf16" if save_grid
           else "blocked_render_bwd_recompute_bf16")
    assert made == {k: int(k in ("blocked_render_bf16", bwd)) for k in made}
    g_f = kernel("float32")
    with torch.no_grad():
        outs = [fused.fused_project_t(ndc, vox, sigma, radius,
                                      point_weights=pw, with_depth=with_depth,
                                      acc_dtype=a)
                for a in ("bfloat16", "float32")]
    plain = fused.fused_project_reference(
        ndc, vox, sigma, radius, point_weights=pw, with_depth=with_depth,
        acc_dtype="bfloat16")
    for i in range(2 if with_depth else 1):
        b = plain[i]
        peak = b.abs().max().item()
        assert (outs[0][i] - b).abs().max().item() <= BF16_FWD_SHARE * peak
        assert (outs[1][i] - b).abs().max().item() > BF16_FWD_SHARE * peak
    g_p = fused.fused_backward_reference(
        ndc, vox, sigma, radius, pw, with_depth, dsil,
        ddepth if with_depth else None, "bfloat16")
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
    sigma = torch.tensor(0.05 * 64, device=cuda)
    with torch.no_grad():
        sil, _ = fused.fused_project_t(ndc, 64, sigma, 8,
                                       acc_dtype="bfloat16")
    k1, _ = fused.fused_project_reference(ndc, 64, sigma, 8,
                                          acc_dtype="bfloat16")
    k3 = fused.drc_projection(fused._blurred(
        ndc, 64, sigma, 8, None, fused._rnd, True)[0])[0]
    peak = k1.abs().max().item()
    assert (sil - k1).abs().max().item() <= BF16_FWD_SHARE * peak
    assert (sil - k3).abs().max().item() > BF16_FWD_SHARE * peak


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
