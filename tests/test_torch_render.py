"""dpcx_torch renderer against dpcx on the same numpy inputs (CPU).

Tolerances:
- splat, blur and DRC against the dpcx XLA ops: atol 2e-5, the bound
  tests/test_pallas_kernel.py holds the Pallas kernel to (f32 sums in
  another order);
- the fused renderer's plain version against the Pallas kernel
  (``pallas_project_t``, interpret mode on the CPU): atol 2e-5 on
  silhouette and depth;
- ``pointcloud_project_fn`` on either path against dpcx's: atol 2e-5;
  its expected colour (rgb) and the colour grid atol 1e-4 (colour sums
  divided by the occupancy);
- the renderer's gradients against the Pallas backward kernel (interpret
  mode): atol 1e-4, ROADMAP's gradient tolerance; the autograd.Function's
  wiring against plain autograd: atol 1e-5 (the same plain ops; the
  cameras' rotations formed outside the Function).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.render import drc as jdrc
from dpcx.render import gauss as jgauss
from dpcx.render import voxelize as jvox
from dpcx.render.pallas_kernel import pallas_project_t
from dpcx.render.project import pointcloud_project_fn as j_project
from dpcx_torch.config import Config as TConfig
from dpcx_torch.render import drc as tdrc
from dpcx_torch.render import fused
from dpcx_torch.render import gauss as tgauss
from dpcx_torch.render import project as tproject
from dpcx_torch.render.transform import CAMERA_DISTANCE, FOCAL_LENGTH
from dpcx_torch.render import voxelize as tvox
from dpcx_torch.utils import prng
import plain_world
from torch_workers import share_cores

share_cores()

ATOL = 2e-5
D = 16


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


def _ndc(rng, b, n, lim=0.45):
    return rng.uniform(-lim, lim, (b, n, 3)).astype(np.float32)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("lim", [0.45, 0.7])  # 0.7: corners out of grid
def test_scatter_splat(weights, lim, rng):
    pts = _ndc(rng, 2, 300, lim)
    pw = rng.uniform(0, 1, (2, 300)).astype(np.float32) if weights else None
    g_j = jvox.pointcloud2voxels_scatter(
        jnp.asarray(pts), D, None if pw is None else jnp.asarray(pw)
    )
    g_t = tvox.pointcloud2voxels_scatter(
        torch.from_numpy(pts), D, None if pw is None else torch.from_numpy(pw)
    )
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)
    np.testing.assert_allclose(
        tvox.ndc_to_grid(torch.from_numpy(pts), D).numpy(),
        np.asarray(jvox.ndc_to_grid(jnp.asarray(pts), D)), atol=1e-6,
    )


@pytest.mark.parametrize("sigma_vox,radius", [(0.8, 2), (2.5, 6)])
def test_gauss_blur(sigma_vox, radius, rng):
    np.testing.assert_allclose(
        tgauss.gauss_kernel_1d(torch.tensor(sigma_vox), radius).numpy(),
        np.asarray(jgauss.gauss_kernel_1d(jnp.asarray(sigma_vox), radius)),
        atol=1e-7,
    )
    np.testing.assert_allclose(
        tgauss.blur_matrix(torch.tensor(sigma_vox), D, radius).numpy(),
        np.asarray(jgauss.blur_matrix(jnp.asarray(sigma_vox), D, radius)),
        atol=1e-7,
    )
    grid = rng.uniform(0, 1, (2, D, D, D)).astype(np.float32)
    out_j = jgauss.smoothen_voxels3d(
        jnp.asarray(grid), jnp.asarray(sigma_vox), radius
    )
    out_t = tgauss.smoothen_voxels3d(
        torch.from_numpy(grid), torch.tensor(sigma_vox), radius
    )
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)


@pytest.mark.parametrize("vox", [8, 32, 64, 128])
def test_kernel_radius(vox):
    for s in (0.016, 0.05, 0.3):
        assert tgauss.kernel_radius(s, vox) == jgauss.kernel_radius(s, vox)


@pytest.mark.parametrize("logsum", [False, True])
@pytest.mark.parametrize("with_depth", [False, True])
def test_drc_projection(logsum, with_depth, rng):
    occ = rng.uniform(0, 1.2, (2, D, D, D)).astype(np.float32)
    s_j, d_j = jdrc.drc_projection(
        jnp.asarray(occ), logsum=logsum, with_depth=with_depth
    )
    s_t, d_t = tdrc.drc_projection(
        torch.from_numpy(occ), logsum=logsum, with_depth=with_depth
    )
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)
    if with_depth:
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=ATOL)
    else:
        assert d_t is None and d_j is None
    p_j, t_j = jdrc.drc_event_probabilities(jnp.asarray(occ), logsum=logsum)
    p_t, t_t = tdrc.drc_event_probabilities(torch.from_numpy(occ),
                                            logsum=logsum)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=ATOL)


def test_sum_projection(rng):
    occ = rng.uniform(0, 0.2, (2, D, D, D)).astype(np.float32)
    s_t, d_t = tdrc.sum_projection(torch.from_numpy(occ))
    s_j, _ = jdrc.sum_projection(jnp.asarray(occ))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)
    assert d_t is None


@pytest.mark.parametrize(
    "with_depth,weights,n,lim",
    [
        (True, False, 256, 0.45),
        (False, True, 256, 0.45),
        (True, True, 1000, 0.7),  # N not a multiple of 128, OOB points
        (False, False, 1000, 0.7),
    ],
)
def test_fused_reference_matches_pallas_kernel(with_depth, weights, n, lim,
                                               rng):
    """The kernel's plain version computes K1's function: held against the
    Pallas kernel itself, run in interpret mode on the CPU."""
    ndc_t = rng.uniform(-lim, lim, (2, 3, n)).astype(np.float32)
    pw = rng.uniform(0, 1, (2, n)).astype(np.float32) if weights else None
    sigma, radius = 0.05 * D, 2
    s_j, d_j = pallas_project_t(
        jnp.asarray(ndc_t), D, jnp.asarray(sigma), radius,
        point_weights=None if pw is None else jnp.asarray(pw),
        with_depth=with_depth,
    )
    args = (torch.from_numpy(ndc_t), D, torch.tensor(sigma), radius)
    kw = dict(point_weights=None if pw is None else torch.from_numpy(pw),
              with_depth=with_depth)
    s_t, d_t = fused.fused_project_reference(*args, **kw)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=ATOL)
    if with_depth:
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=ATOL)
    else:
        assert d_t is None and d_j is None
    # a CPU tensor takes the plain version, and launches nothing
    before = dict(fused.LAUNCHES)
    s_w, d_w = fused.fused_project_t(*args, **kw)
    assert torch.equal(s_w, s_t)
    assert (d_w is None) if not with_depth else torch.equal(d_w, d_t)
    assert fused.LAUNCHES == before


def _linear_grads(render, ndc_t, pw, dsil, ddepth):
    """Port: d/d(ndc) and d/d(weights) of <dsil, sil> + <ddepth, depth>."""
    x = torch.from_numpy(ndc_t).requires_grad_()
    w = None if pw is None else torch.from_numpy(pw).requires_grad_()
    sil, depth = render(x, w)
    loss = (sil * torch.from_numpy(dsil)).sum()
    if depth is not None:
        loss = loss + (depth * torch.from_numpy(ddepth)).sum()
    loss.backward()
    return [x.grad.numpy()] + ([] if w is None else [w.grad.numpy()])


@pytest.mark.parametrize("vox", [8, 16])
@pytest.mark.parametrize("with_depth", [False, True])
@pytest.mark.parametrize("weights", [False, True])
def test_fused_gradients_match_pallas_backward(vox, with_depth, weights,
                                               rng):
    """The renderer's gradients on the port (autograd through
    fused_project_t) against dpcx's K2 (jax.grad through pallas_project_t,
    the Pallas backward kernel in interpret mode): d/d(ndc) and
    d/d(weights), atol 1e-4, with some points out of the grid."""
    R, N, radius = 2, 300, 2
    ndc_t = rng.uniform(-0.6, 0.6, (R, 3, N)).astype(np.float32)
    pw = rng.uniform(0, 2, (R, N)).astype(np.float32) if weights else None
    dsil = rng.normal(size=(R, vox, vox)).astype(np.float32)
    ddepth = rng.normal(size=(R, vox, vox)).astype(np.float32)
    sigma = 0.1 * vox

    def j_loss(x, w):
        sil, depth = pallas_project_t(x, vox, jnp.asarray(sigma), radius,
                                      point_weights=w, with_depth=with_depth,
                                      interpret=True)
        loss = jnp.sum(sil * dsil)
        return loss + jnp.sum(depth * ddepth) if with_depth else loss

    argnums = (0, 1) if weights else 0
    g_j = jax.grad(j_loss, argnums=argnums)(
        jnp.asarray(ndc_t), None if pw is None else jnp.asarray(pw))
    g_j = list(g_j) if weights else [g_j]
    g_t = _linear_grads(
        lambda x, w: fused.fused_project_t(
            x, vox, torch.tensor(sigma), radius, point_weights=w,
            with_depth=with_depth),
        ndc_t, pw, dsil, ddepth,
    )
    for a, b in zip(g_t, g_j):
        assert np.abs(b).max() > 0
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)


@pytest.mark.parametrize(
    "with_depth,weights,use_sil,use_depth,learn,translation,fan", [
        (True, True, True, True, "cameras", True, 1),
        # depth rendered, never read: no cotangent
        (True, True, True, False, "none", False, 2),
        (True, False, False, True, "cameras", False, 3),  # only depth read
        (False, False, True, False, "translation", True, 1),
        (False, True, True, False, "cameras", True, 2),
        (True, True, True, True, "none", True, 4),
    ])
def test_fused_function_wiring(with_depth, weights, use_sil, use_depth,
                               learn, translation, fan, rng, monkeypatch):
    """The autograd.Function the card runs (``_FusedWorldRender``), on the
    CPU with its two launches replaced by the plain forward and the plain
    VJP (``tests/plain_world.py``): it gives the gradients of plain
    autograd through ``fused_project_world``'s CPU route, to the clouds and
    weights summed over each cloud's ``fan`` renders, to the cameras
    through the rotations (quat) and the translations where they learn
    ("cameras", or "translation" alone) and None where they do not, none
    to sigma, and no cotangent for an output the loss never reads."""
    C, N, radius = 2, 200, 2
    sigma = torch.tensor(1.2, requires_grad=True)
    seen = plain_world.patch_launches(monkeypatch, sigma.detach())
    scene = plain_world.scene(rng, C, fan, N, weights, translation)

    def world(p, w, q, t):
        return plain_world.render_world(p, w, q, t, D, sigma, radius,
                                        with_depth)

    def plain(p, w, q, t):
        return fused.fused_project_world(
            p, q, D, sigma.detach(), radius, w, t, FOCAL_LENGTH,
            CAMERA_DISTANCE, with_depth)

    g_f = plain_world.world_grads(world, *scene, learn, use_sil, use_depth)
    assert sigma.grad is None  # the taps get no gradient
    assert (seen["ddepth"] is not None) == use_depth
    assert seen["want_camera"] == (learn != "none")
    assert seen["want_dweights"] == weights
    g_p = plain_world.world_grads(plain, *scene, learn, use_sil, use_depth)
    for a, b in zip(g_f, g_p):
        if b is None:
            assert a is None
        else:
            assert b.abs().max() > 0
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("weights", [False, True])
def test_scatter_splat_rgb(weights, rng):
    """The rgb path: weight-normalised colour grid, clamped at 1e-6."""
    pts = _ndc(rng, 2, 300, 0.6)
    rgb = rng.uniform(0, 1, (2, 300, 3)).astype(np.float32)
    pw = rng.uniform(0, 1, (2, 300)).astype(np.float32) if weights else None
    g_j, c_j = jvox.pointcloud2voxels_scatter(
        jnp.asarray(pts), D, None if pw is None else jnp.asarray(pw),
        rgb=jnp.asarray(rgb))
    g_t, c_t = tvox.pointcloud2voxels_scatter(
        torch.from_numpy(pts), D, None if pw is None else torch.from_numpy(pw),
        rgb=torch.from_numpy(rgb))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)


def test_point_dropout_weights():
    """Values in {0, 1/keep}, mean ~1, the same draws from the same seed."""
    keep = 0.25
    w = tvox.pc_point_dropout_weights(prng.prng_key(3), 64, 1000,
                                      torch.tensor(keep))
    assert w.shape == (64, 1000) and w.dtype == torch.float32
    assert set(torch.unique(w).tolist()) == {0.0, 1.0 / keep}
    assert abs(w.mean().item() - 1.0) < 0.05
    again = tvox.pc_point_dropout_weights(prng.prng_key(3), 64, 1000, keep)
    assert torch.equal(w, again)
    other = tvox.pc_point_dropout_weights(prng.prng_key(4), 64, 1000, keep)
    assert not torch.equal(w, other)
    ones = tvox.pc_point_dropout_weights(prng.prng_key(0), 2, 10, 1.0)
    assert torch.equal(ones, torch.ones(2, 10))


def test_fused_wrapper_refuses(rng):
    ndc_t = torch.from_numpy(rng.uniform(-0.4, 0.4, (2, 3, 64))
                             .astype(np.float32))
    sigma = torch.tensor(0.8)
    # the bfloat16 mode runs at D <= 64 (K1/K2's) and above (K3-K5's, which
    # need D % 8 == 0 as dpcx's blocked kernels do); other operand types
    # are refused
    for vox in (D, 72):
        sil_b, _ = fused.fused_project_t(ndc_t, vox, sigma, 2,
                                         acc_dtype="bfloat16")
        sil_f, _ = fused.fused_project_t(ndc_t, vox, sigma, 2)
        assert 0 < (sil_b - sil_f).abs().max() < 1e-2
    with pytest.raises(ValueError, match="vox_size % 8 == 0"):
        fused.fused_project_t(ndc_t, 68, sigma, 2, acc_dtype="bfloat16")
    with pytest.raises(ValueError, match="acc_dtype"):
        fused.fused_project_t(ndc_t, D, sigma, 2, acc_dtype="float16")
    # a gradient asked for on a CPU tensor: autograd through the plain
    # version, as fused_project_reference gives it
    x = ndc_t.clone().requires_grad_()
    sil, _ = fused.fused_project_t(x, D, sigma, 2)
    (sil**2).sum().backward()
    y = ndc_t.clone().requires_grad_()
    sil_p, _ = fused.fused_project_reference(y, D, sigma, 2)
    (sil_p**2).sum().backward()
    assert x.grad.abs().max() > 0
    torch.testing.assert_close(x.grad, y.grad, atol=0, rtol=0)
    with torch.no_grad():  # no gradient asked for: allowed
        fused.fused_project_t(ndc_t, D, sigma, 2)
    ndc_t = ndc_t.detach()
    with pytest.raises(ValueError, match=r"\[R, 3, N\]"):
        fused.fused_project_t(ndc_t.transpose(1, 2), D, sigma, 2)
    with pytest.raises(ValueError, match="vox_size"):
        fused.fused_project_t(ndc_t, 136, sigma, 2)  # above 128
    with pytest.raises(ValueError, match="kernel_radius"):
        fused.fused_project_t(ndc_t, D, sigma, D)
    with pytest.raises(ValueError, match="point_weights"):
        fused.fused_project_t(ndc_t, D, sigma, 2,
                              point_weights=torch.ones(2, 63))
    # not cpu: no silent plain version where the kernels take world clouds
    with pytest.raises(ValueError, match="runs on cpu.*fused_project_world"):
        fused.fused_project_t(ndc_t.to("meta"), D, sigma, 2)
    # the recompute backward exists only above D 64: refused before a launch
    points, rot = torch.zeros(2, 64, 3), torch.eye(3).expand(2, 3, 3)
    with pytest.raises(ValueError, match="only above D 64"):
        fused._launch_world_backward(
            points, None, rot, None, (FOCAL_LENGTH, CAMERA_DISTANCE),
            torch.ones(5), 2, None, torch.zeros(2, D, D), None, D, False,
            False, False, False)


# (config overrides, whether the fused renderer is taken) — the dispatch
# conditions of dpcx/render/project.py:102-118
DISPATCH_CASES = [
    ({"renderer": "pallas", "proj_depth": True}, True),
    ({"renderer": "pallas"}, True),
    ({"renderer": "xla", "proj_depth": True}, False),
    ({"renderer": "pallas", "drc_logsum": True, "proj_depth": True}, False),
    ({"renderer": "pallas", "vox_size": 12}, False),  # D % 8 != 0
    ({"renderer": "pallas", "proj_type": "sum"}, False),
]


@pytest.mark.parametrize("overrides,takes_fused", DISPATCH_CASES)
def test_project_dispatch_matches_dpcx(overrides, takes_fused, rng,
                                       monkeypatch):
    cfg = Config(vox_size=D, pc_num_points=200, pc_relative_sigma=0.1,
                 xla_splat="scatter").replace(**overrides)
    pts = rng.uniform(-0.4, 0.4, (2, 200, 3)).astype(np.float32)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    sigma_rel = 0.08
    calls = []
    real = tproject.fused_project_world

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tproject, "fused_project_world", spy)
    out_t = tproject.pointcloud_project_fn(
        _t(cfg), torch.from_numpy(pts), torch.from_numpy(q),
        torch.tensor(sigma_rel),
    )
    out_j = j_project(cfg, jnp.asarray(pts), jnp.asarray(q),
                      jnp.asarray(sigma_rel))
    assert bool(calls) == takes_fused
    np.testing.assert_allclose(out_t.silhouette.numpy(),
                               np.asarray(out_j.silhouette), atol=ATOL)
    if cfg.proj_depth and cfg.proj_type == "drc":
        np.testing.assert_allclose(out_t.depth.numpy(),
                                   np.asarray(out_j.depth), atol=ATOL)
    else:
        assert out_t.depth is None and out_j.depth is None


@pytest.mark.parametrize("renderer", ["pallas", "xla"])
def test_project_translation_matches_dpcx(renderer, rng):
    cfg = Config(vox_size=D, renderer=renderer, proj_depth=True,
                 pc_relative_sigma=0.1, xla_splat="scatter")
    pts = rng.uniform(-0.4, 0.4, (2, 150, 3)).astype(np.float32)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    tr = rng.normal(scale=0.05, size=(2, 3)).astype(np.float32)
    out_t = tproject.pointcloud_project_fn(
        _t(cfg), torch.from_numpy(pts), torch.from_numpy(q),
        torch.tensor(0.08), translation=torch.from_numpy(tr),
    )
    out_j = j_project(cfg, jnp.asarray(pts), jnp.asarray(q),
                      jnp.asarray(0.08), translation=jnp.asarray(tr))
    np.testing.assert_allclose(out_t.silhouette.numpy(),
                               np.asarray(out_j.silhouette), atol=ATOL)
    np.testing.assert_allclose(out_t.depth.numpy(), np.asarray(out_j.depth),
                               atol=ATOL)


def test_project_return_voxels_falls_through(rng):
    cfg = Config(vox_size=D, renderer="pallas", pc_relative_sigma=0.1)
    pts = rng.uniform(-0.4, 0.4, (1, 100, 3)).astype(np.float32)
    q = np.asarray([[1.0, 0.0, 0.0, 0.0]], np.float32)
    out_t = tproject.pointcloud_project_fn(
        _t(cfg), torch.from_numpy(pts), torch.from_numpy(q),
        torch.tensor(0.1), return_voxels=True,
    )
    out_j = j_project(cfg, jnp.asarray(pts), jnp.asarray(q),
                      jnp.asarray(0.1), return_voxels=True, splat="scatter")
    np.testing.assert_allclose(out_t.voxels.numpy(), np.asarray(out_j.voxels),
                               atol=ATOL)


def test_project_refuses_unported_paths(rng, monkeypatch):
    """Nothing here is refused any more. D > 64 with renderer: pallas
    takes the fused renderer (dpcx: the depth-blocked kernel, K3, held to
    the port in tests/test_torch_blocked.py) and matches dpcx's renderer
    at D 72; rgb takes the eager ops even with renderer: pallas (colour
    never reaches the fused renderer) and matches dpcx's expected-colour
    render."""
    pts = rng.uniform(-0.4, 0.4, (2, 50, 3)).astype(np.float32)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    cfg = Config(vox_size=72, renderer="pallas")  # the blocked kernel (K3)
    calls = []
    real = tproject.fused_project_world
    monkeypatch.setattr(tproject, "fused_project_world",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out_t = tproject.pointcloud_project_fn(_t(cfg), torch.from_numpy(pts),
                                           torch.from_numpy(q),
                                           torch.tensor(0.05))
    assert calls == [1]
    monkeypatch.undo()
    out_j = j_project(cfg.replace(renderer="xla", xla_splat="scatter"),
                      jnp.asarray(pts), jnp.asarray(q), jnp.asarray(0.05))
    assert float(out_t.silhouette.max()) > 0
    np.testing.assert_allclose(out_t.silhouette.numpy(),
                               np.asarray(out_j.silhouette), atol=3e-5)
    rgb = rng.uniform(0, 1, (2, 50, 3)).astype(np.float32)
    cfg = dataclasses.replace(cfg, vox_size=D, pc_relative_sigma=0.1,
                              proj_depth=True)
    monkeypatch.setattr(tproject, "fused_project_world",
                        lambda *a, **k: pytest.fail("rgb reached the kernel"))
    out_t = tproject.pointcloud_project(
        _t(cfg), torch.from_numpy(pts), torch.from_numpy(q),
        torch.tensor(0.08), rgb=torch.from_numpy(rgb),
    )
    out_j = j_project(cfg, jnp.asarray(pts), jnp.asarray(q),
                      jnp.asarray(0.08), rgb=jnp.asarray(rgb))
    assert out_t.rgb.shape == (2, D, D, 3)
    for k in ("silhouette", "depth", "rgb"):
        np.testing.assert_allclose(getattr(out_t, k).numpy(),
                                   np.asarray(getattr(out_j, k)), atol=1e-4,
                                   err_msg=k)


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


@pytest.mark.parametrize("step", [0, 30_000, 200_000, 1, 12_345,
                                  Config().sigma_anneal_steps, 10**9])
def test_schedules(step):
    """The sigma anneal is a float32 0-d tensor on the device asked for,
    with the bits of the host formula it is computed by (the exponential
    in float32 on the host) and of dpcx's schedule at these steps; the
    keep-prob ramp within 1e-6 of dpcx's."""
    from dpcx.render.project import keep_prob_schedule, sigma_schedule

    cfg = Config()
    frac = (torch.tensor(step, dtype=torch.float32)
            / cfg.sigma_anneal_steps).clamp(0.0, 1.0)
    log_s0 = math.log(cfg.pc_relative_sigma)
    host = torch.exp(
        log_s0 + (math.log(cfg.pc_relative_sigma_end) - log_s0) * frac)
    for device in (None, "cpu", torch.device("cpu")):
        got = tproject.sigma_schedule(_t(cfg), step, device)
        assert got.shape == () and got.dtype == torch.float32
        assert got.device == torch.device("cpu")
        assert _bits(got) == _bits(host)
    assert _bits(host) == _bits(sigma_schedule(cfg, jnp.asarray(step)))
    np.testing.assert_allclose(
        tproject.keep_prob_schedule(_t(cfg), step).numpy(),
        np.asarray(keep_prob_schedule(cfg, jnp.asarray(step))), rtol=1e-6,
    )
