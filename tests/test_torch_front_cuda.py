"""The renderer from world clouds on the card: ``fused_project_world``,
whose splat stages (K1/K2 at D <= 64, K3-K5 above) run the camera
transform in registers, against the plain version of the function on the
same card and inputs: the clouds fanned out to one row a render,
``pc_perspective_transform_t``, then ``fused_project_plain`` (torch ops
throughout, its backward K2's function written out). Every test here
needs a CUDA card and skips without one:

    python -m pytest tests/test_torch_front_cuda.py -q

Tolerances, and why. The two sides differ in three sums: the rotation's
3-term sums (FMAs in the kernel, the GEMM's own order in the plain
version), which can move a grid coordinate by an ulp; the order of the
splat's f32 atomics, which already makes the kernels differ from
themselves run to run; and the camera gradients, which the kernel sums
over a render's points by warp shuffles and one atomicAdd a warp and the
plain version by autograd's reductions. So sil and depth are held to
atol 1e-4, and in the f32 mode every gradient (points, weights,
quaternions, translations) to 1e-3 of the largest plain one
(``chip_smoke.py``'s KERNEL_ATOL and GRAD_RTOL for the kernels against
the plain version) and to 1e-4 relative L2. In the bf16 operand mode a
coordinate an ulp away can also move a bf16-rounded hat weight by one
bf16 ulp, up to 2^-7 of it, so the gradients are held to 2^-7 of the
largest plain one and 1e-3 relative L2 (``chip_smoke.py``'s
BF16_FLIP_SHARE and BF16_GRAD_L2; at the same coordinates on both sides
its bf16 checks hold 2^-8).
"""

import pytest
import torch

from dpcx_torch.render import fused
from dpcx_torch.render.transform import (
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


def _scene(cuda, C, S, N, lim, weights, translation, seed, dist=2.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    R = C * S
    points = (torch.rand(C, N, 3, generator=g, device=cuda) * 2 - 1) * lim
    quat = torch.randn(R, 4, generator=g, device=cuda)
    pw = (torch.rand(C, N, generator=g, device=cuda) if weights else None)
    trans = (torch.randn(R, 3, generator=g, device=cuda) * 0.05
             if translation else None)
    if dist < 1.0:
        # render 0 looks down its z axis; cloud 0's first 64 points sit
        # just past the clamp of z + dist, inside the grid
        quat[0] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=cuda)
        if trans is not None:
            trans[0] = 0.0
        k = torch.arange(64, device=cuda, dtype=torch.float32)
        points[0, :64, 0] = (k % 8 - 3.5) * 1e-4
        points[0, :64, 1] = (k // 8 - 3.5) * 1e-4
        points[0, :64, 2] = -dist - 2e-3 - k * 1e-4
    return points, quat, pw, trans


def _run(route, points, quat, pw, trans, vox, sigma, radius, depth, acc,
         save_grid, dist, cam_grad, seed):
    """Forward, and the gradients of a seeded projection of the outputs
    into (points, weights, quat, translation)."""
    leaves = [points.detach().clone().requires_grad_(True),
              None if pw is None else pw.detach().clone().requires_grad_(),
              quat.detach().clone().requires_grad_(cam_grad),
              None if trans is None
              else trans.detach().clone().requires_grad_(cam_grad)]
    out = route(*leaves, vox, sigma, radius, depth, acc, save_grid, dist)
    g = torch.Generator(device=points.device).manual_seed(seed)
    total = sum((o * torch.rand(o.shape, generator=g, device=o.device)).sum()
                for o in out if o is not None)
    live = [t for t in leaves if t is not None and t.requires_grad]
    grads = torch.autograd.grad(total, live)
    return [o.detach() if o is not None else None for o in out], grads


def _world(points, pw, quat, trans, vox, sigma, radius, depth, acc,
           save_grid, dist):
    return fused.fused_project_world(
        points, quat, vox, sigma, radius, point_weights=pw,
        translation=trans, focal_length=FOCAL, camera_distance=dist,
        with_depth=depth, acc_dtype=acc, save_grid=save_grid)


def _composition(points, pw, quat, trans, vox, sigma, radius, depth, acc,
                 save_grid, dist):
    """The plain version (save_grid is the kernels' choice alone)."""
    S = quat.shape[0] // points.shape[0]
    ndc_t = pc_perspective_transform_t(points.repeat_interleave(S, dim=0),
                                       quat, FOCAL, dist, trans)
    return fused.fused_project_plain(
        ndc_t, vox, sigma, radius,
        None if pw is None else pw.repeat_interleave(S, dim=0), depth, acc)


def _close(got, want, vox, bf16, what):
    scale = float(want.abs().max())
    assert scale > 0, what
    lim = 2.0**-7 if bf16 else 1e-3
    err = float((got - want).abs().max())
    assert err <= lim * scale, (what, err, scale)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel <= (1e-3 if bf16 else 1e-4), (what, rel)


# (clouds C, renders a cloud S, N, D, bf16, save_grid, weights,
# translation, camera grad, depth, point spread, camera distance)
CASES = [
    # the pose cell's render (S 1, camera grad) and a fanned one (S 4, 32)
    (256, 1, 2048, 32, False, True, True, False, True, False, 0.6, 2.0),
    (16, 4, 2048, 32, False, True, True, True, True, False, 0.6, 2.0),
    (2, 32, 2048, 32, True, True, True, False, True, False, 0.6, 2.0),
    # car64's render, GT pose (no camera grad), and both modes with it
    (8, 4, 16000, 64, False, True, True, False, False, True, 0.6, 2.0),
    (2, 4, 16000, 64, True, True, False, True, True, True, 0.6, 2.0),
    # K3-K5: the saved grid and the recompute, both modes
    (4, 1, 16000, 128, False, True, True, False, False, False, 0.6, 2.0),
    (2, 2, 16000, 128, False, False, False, True, True, True, 0.6, 2.0),
    (2, 2, 4000, 128, True, False, True, True, True, False, 0.6, 2.0),
    # N % 32 != 0 (a warp across two clouds) and points outside the grid
    (3, 2, 777, 32, False, True, True, True, True, True, 1.2, 2.0),
    # points past the clamp of z + dist, inside the grid
    (2, 2, 2048, 32, False, True, True, True, True, True, 0.3, 0.5),
]


@pytest.mark.parametrize(
    "C,S,N,vox,bf16,save_grid,weights,translation,cam_grad,depth,lim,dist",
    CASES)
def test_world_kernels_match_composition(cuda, C, S, N, vox, bf16,
                                         save_grid, weights, translation,
                                         cam_grad, depth, lim, dist):
    seed = C * 7919 + S * 31 + vox + N
    points, quat, pw, trans = _scene(cuda, C, S, N, lim, weights,
                                     translation, seed, dist)
    if dist < 1.0:  # the clamp binds for the planted points, and they splat
        zf = (pc_perspective_transform_t(points[:1], quat[:1], FOCAL, dist)
              [0, 2, :64] + dist)
        assert bool((zf < 1e-2).all())
    sigma = torch.tensor(0.05 * vox, device=cuda)
    radius = max(2, vox // 10)
    acc = "bfloat16" if bf16 else "float32"
    family = fused.launch_family(vox)
    fwd_key = f"{family}_render" + ("_bf16" if bf16 else "")
    bwd_key = (f"{family}_render_bwd"
               + ("" if save_grid or vox <= 64 else "_recompute")
               + ("_bf16" if bf16 else ""))
    before = (fused.LAUNCHES[fwd_key], fused.LAUNCHES[bwd_key])
    args = (points, quat, pw, trans, vox, sigma, radius, depth, acc,
            save_grid, dist, cam_grad, seed)
    got_out, got_grads = _run(_world, *args)
    assert (fused.LAUNCHES[fwd_key], fused.LAUNCHES[bwd_key]) == (
        before[0] + 1, before[1] + 1)
    want_out, want_grads = _run(_composition, *args)
    torch.cuda.synchronize()
    assert float(want_out[0].max()) > 0
    for a, b in zip(got_out, want_out):
        assert (a is None) == (b is None)
        if b is not None:
            torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    names = ["points", "weights", "quat", "translation"]
    names = [n for n, on in zip(names, (True, weights, cam_grad,
                                        cam_grad and translation)) if on]
    assert len(got_grads) == len(names)
    for name, a, b in zip(names, got_grads, want_grads):
        assert a.shape == b.shape, name
        _close(a, b, vox, bf16, name)
    if dist < 1.0:
        # the planted points reach the grid: their gradients are not zero
        assert float(got_grads[0][0, :64].abs().max()) > 0


def test_world_route_makes_no_stream_sync(cuda):
    """The forward and backward from world clouds, camera gradient and
    translation included, raise nothing under
    ``set_sync_debug_mode("error")``."""
    points, quat, pw, trans = _scene(cuda, 8, 4, 2048, 0.6, True, True, 5)
    sigma = torch.tensor(2.0, device=cuda)
    args = (points, quat, pw, trans, 32, sigma, 3, True, "float32", True,
            2.0, True, 5)
    _run(_world, *args)  # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, grads = _run(_world, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_car64_chunk_makes_no_stream_sync(cuda):
    """A 20-step chunk of ``train_steps_scan`` at ``car_64_depth``'s
    configuration and the benchmark's B 256 (1,024 renders of 16,000
    points at D 64 a step, through ``fused_project_world``) raises nothing
    under ``set_sync_debug_mode("error")``; its metrics stay finite."""
    from pathlib import Path

    from dpcx_torch.config import load_config
    from dpcx_torch.train import create_state, train_steps_scan
    from dpcx_torch.utils import prng

    cfg = load_config(Path(__file__).resolve().parent.parent / "experiments"
                      / "car_64_depth.yaml").replace(batch_size=256)
    g = torch.Generator(device=cuda).manual_seed(13)
    M, V, S, D = 32, cfg.num_views, cfg.image_size, cfg.mask_size
    quats = torch.randn(M, V, 4, generator=g, device=cuda)
    masks = (torch.rand(M, V, D, D, generator=g, device=cuda) < 0.3).float()
    records = {
        "images": torch.rand(M, V, S, S, 3, generator=g, device=cuda),
        "masks": masks,
        "depths": torch.where(masks > 0, 0.1, 1.0),
        "quats": quats / quats.norm(dim=-1, keepdim=True)}
    state = create_state(cfg, cuda, seed=0)
    key = prng.prng_key(1)
    before = fused.LAUNCHES["fused_render"]
    train_steps_scan(cfg, state, records, key, 2)  # loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = train_steps_scan(cfg, state, records, key, 20)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert state.step == 22
    assert fused.LAUNCHES["fused_render"] == before + 22
    assert {"loss_depth", "iou"} <= set(metrics)
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
