"""The port's CUDA kernels on the card, against their plain PyTorch version.

Every test here needs a CUDA card and skips without one. Run them on the
card with:

    python -m pytest tests/test_torch_cuda.py -q

Tolerance: sil and depth atol 1e-4 — atomics reorder the f32 splat sums
from run to run, so the kernel is not bitwise stable; gradients within
1e-3 of the largest plain gradient, for the same reason.
"""

import numpy as np
import pytest
import torch

from dpcx_torch.config import Config
from dpcx_torch.render import fused
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
    before = fused.LAUNCHES["fused_render"]
    s_k, d_k = fused.fused_project_t(ndc, vox, sigma, radius,
                                     point_weights=pw, with_depth=with_depth)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["fused_render"] == before + 1
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
    for a, b in zip(g_k, g_p):
        bound = 1e-3 * b.abs().max().item()
        assert bound > 0
        assert (a - b).abs().max().item() <= bound


def test_pallas_renderer_on_card(cuda):
    """renderer: pallas reaches the kernel at D <= 64 and raises above
    (the blocked kernel is not ported) instead of running plain ops."""
    pts = torch.rand(2, 500, 3, device=cuda) - 0.5
    q = torch.tensor([[1.0, 0, 0, 0]] * 2, device=cuda)
    cfg = Config(vox_size=32, renderer="pallas", proj_depth=True)
    before = fused.LAUNCHES["fused_render"]
    out = pointcloud_project_fn(cfg, pts, q, torch.tensor(0.05))
    assert fused.LAUNCHES["fused_render"] == before + 1
    ref = pointcloud_project_fn(cfg.replace(renderer="xla"), pts, q,
                                torch.tensor(0.05))
    torch.testing.assert_close(out.silhouette, ref.silhouette, atol=ATOL,
                               rtol=0)
    torch.testing.assert_close(out.depth, ref.depth, atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError, match="vox_size=128"):
        pointcloud_project_fn(cfg.replace(vox_size=128), pts, q,
                              torch.tensor(0.05))
