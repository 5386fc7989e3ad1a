"""The port's anisotropic splats (``dpcx_torch/render/gsplat.py``,
``render/aniso.py``) against dpcx's on the CPU: the dense oracle, the
z-windowed function of the Pallas kernels K6/K7 (dpcx's in interpret mode,
the port's plain version), their z-ranges, gradients, the windowed form
(remat on and off), and ``gsplat_project``.

Inputs are drawn with numpy from a seed, as ``tests/test_pallas_gsplat.py``
draws them (B 2, N 256, D 16; N 200 pads the last chunk; N 1100 makes
three chunks whose bands differ). Tolerances: grids atol 2e-5 with rtol
2e-5 (dpcx's own kernel-vs-oracle bound; the same f32 formula summed in
another order), colour where density > 1e-3 at 1e-4; gradients relative
L2 2e-4 with rgb and 5e-4 density-only (dpcx's own bounds, against its
raw-moment assembly); silhouettes and colours of ``gsplat_project`` atol
2e-5. The windowed form runs the same formula as dpcx's in the same order
but for the products' sums: densities and silhouettes atol 2e-5,
gradients atol 1e-4 (the port's parity bounds, ROADMAP) and relative L2
1e-4 (f32 sums in another order; the gradients of the squared error are
~1e-2).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcx.render.gsplat as jgs
from dpcx.config import Config as JConfig
from dpcx.render import pallas_gsplat as jpg
from dpcx_torch.config import Config
from dpcx_torch.render import aniso
from dpcx_torch.render import gsplat as tgs
from torch_workers import share_cores

share_cores()

D = 16
B, N = 2, 256
ATOL = 2e-5


def _inputs(seed=0, n=N, b=B):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.4, 0.4, (b, n, 3))
    scales = rng.uniform(0.02, 0.08, (b, n, 3))
    rot = rng.normal(size=(b, n, 4))
    rot /= np.linalg.norm(rot, axis=-1, keepdims=True)
    opac = rng.uniform(size=(b, n))
    rgb = rng.uniform(size=(b, n, 3))
    return [a.astype(np.float32) for a in (pts, scales, rot, opac, rgb)]


def _j(*arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _assert_grids(got, want, with_rgb):
    if with_rgb:
        (d_t, c_t), (d_j, c_j) = got, want
    else:
        d_t, d_j = got, want
    d_j = np.asarray(d_j)
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=ATOL, atol=ATOL)
    if with_rgb:
        mask = d_j > 1e-3
        assert mask.mean() > 0.05
        np.testing.assert_allclose(c_t.numpy()[mask], np.asarray(c_j)[mask],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_dense_oracle_matches_dpcx(with_rgb):
    pts, scales, rot, opac, rgb = _inputs(1)
    rgb = rgb if with_rgb else None
    # scales in NDC: 0.02-0.08 of the grid is 0.3-1.3 cells at D 16
    want = jgs.anisotropic_density_grid(*_j(pts, scales, rot), D,
                                        *_j(opac, rgb))
    got = tgs.anisotropic_density_grid(*_t(pts, scales, rot), D,
                                       *_t(opac, rgb))
    _assert_grids(got, want, with_rgb)


@pytest.mark.parametrize(
    "truncate,with_rgb,n",
    [(3.0, True, N), (3.0, False, N), (100.0, True, N), (100.0, False, N),
     (3.0, False, 200), (100.0, True, 200), (3.0, True, 1100)],
)
def test_pallas_function_matches_dpcx(truncate, with_rgb, n):
    """The port's plain version of K6 against dpcx's Pallas kernel in
    interpret mode."""
    pts, scales, rot, opac, rgb = _inputs(2, n=n, b=1 if n > N else B)
    rgb = rgb if with_rgb else None
    want = jgs.anisotropic_density_grid_pallas(
        *_j(pts, scales, rot), D, *_j(opac, rgb), truncate=truncate,
        interpret=True)
    got = tgs.anisotropic_density_grid_pallas(
        *_t(pts, scales, rot), D, *_t(opac, rgb), truncate=truncate)
    _assert_grids(got, want, with_rgb)
    assert not any(aniso.LAUNCHES.values())  # CPU: no kernel launches


def test_truncation_band_drops_mass():
    """At D 32 (G 8) with three chunks, truncate 3 gives narrower bands
    than truncate 100, and the narrower band only drops mass."""
    pts, scales, rot, opac, _ = _inputs(2, n=1100, b=1)
    grids = [tgs.anisotropic_density_grid_pallas(
        *_t(pts, scales, rot), 32, *_t(opac), truncate=t) for t in (3.0, 100.0)]
    diff = grids[1] - grids[0]
    assert diff.abs().max() > 0 and diff.min() >= -ATOL
    mu_z = torch.from_numpy((pts[..., 2] + 0.5) * 32 - 0.5)
    widths = [torch.sub(*aniso.z_ranges(mu_z, torch.full_like(mu_z, r), 32)
                        [::-1]) for r in (3.0, 100.0)]
    assert (widths[0] <= widths[1]).all() and (widths[0] < widths[1]).any()


@pytest.mark.parametrize("n,vox", [(256, 16), (200, 16), (1100, 16),
                                   (1536, 32), (4096, 32)])
def test_z_ranges_match_window_metadata(n, vox):
    """Per-point [z_lo, z_hi) against dpcx's per-chunk _window_metadata on
    the same pads and depth sort, rounded up to whole G-slab trips and
    clipped at D."""
    rng = np.random.default_rng(n + vox)
    mu_z = rng.uniform(-3, vox + 2, (2, n)).astype(np.float32)
    rz = rng.uniform(0.5, 4.0, (2, n)).astype(np.float32)
    G, C = jpg._tiling(n, vox)
    assert aniso.tiling(n, vox) == (G, C)
    pad = (-n) % C
    mu_p = np.concatenate([mu_z, np.full((2, pad), 1e4, np.float32)], 1)
    rz_p = np.concatenate([rz, np.zeros((2, pad), np.float32)], 1)
    order = np.argsort(mu_p, axis=1, kind="stable")
    mu_s = np.take_along_axis(mu_p, order, 1)
    rz_s = np.take_along_axis(rz_p, order, 1)
    zb, nt = (np.asarray(a) for a in jpg._window_metadata(
        jnp.asarray(mu_s), jnp.asarray(rz_s), vox, G, C))
    lo_c, hi_c = zb, np.minimum(zb + nt * G, vox)
    want_lo = np.empty_like(mu_p, np.int32)
    want_hi = np.empty_like(mu_p, np.int32)
    np.put_along_axis(want_lo, order, np.repeat(lo_c, C, axis=1), 1)
    np.put_along_axis(want_hi, order, np.repeat(hi_c, C, axis=1), 1)
    z_lo, z_hi = aniso.z_ranges(torch.from_numpy(mu_z), torch.from_numpy(rz),
                                vox)
    assert z_lo.dtype == z_hi.dtype == torch.int32
    np.testing.assert_array_equal(z_lo.numpy(), want_lo[:, :n])
    np.testing.assert_array_equal(z_hi.numpy(), want_hi[:, :n])
    assert n <= C or torch.unique(z_lo).numel() > 1  # several bands


def _rel(a, b):
    b = np.asarray(b)
    return float(np.linalg.norm(np.asarray(a) - b) / (np.linalg.norm(b)
                                                      + 1e-12))


@pytest.mark.parametrize("with_rgb,truncate,bound",
                         [(True, 3.0, 2e-4), (False, 100.0, 5e-4)])
def test_gradients_match_dpcx_pallas_vjp(with_rgb, truncate, bound):
    """d loss / d (points, scales, opacity, rgb) through the port's plain
    version (autograd) against dpcx's Pallas VJP (K7) in interpret mode."""
    pts, scales, rot, opac, rgb = _inputs(3)
    rng = np.random.default_rng(9)
    tgt_d = rng.uniform(size=(B, D, D, D)).astype(np.float32)
    tgt_c = rng.uniform(size=(B, D, D, D, 3)).astype(np.float32)

    def j_loss(p, s, o, r):
        out = jgs.anisotropic_density_grid_pallas(
            p, s, jnp.asarray(rot), D, point_weights=o,
            rgb=r if with_rgb else None, truncate=truncate, interpret=True)
        if not with_rgb:
            return jnp.mean((out - tgt_d) ** 2)
        return (jnp.mean((out[0] - tgt_d) ** 2)
                + jnp.mean((out[1] - tgt_c) ** 2))

    g_j = jax.grad(j_loss, argnums=(0, 1, 2, 3))(*_j(pts, scales, opac, rgb))
    ins = [t.requires_grad_() for t in _t(pts, scales, opac, rgb)]
    out = tgs.anisotropic_density_grid_pallas(
        ins[0], ins[1], torch.from_numpy(rot), D, point_weights=ins[2],
        rgb=ins[3] if with_rgb else None, truncate=truncate)
    if with_rgb:
        loss = (torch.mean((out[0] - torch.from_numpy(tgt_d)) ** 2)
                + torch.mean((out[1] - torch.from_numpy(tgt_c)) ** 2))
    else:
        loss = torch.mean((out - torch.from_numpy(tgt_d)) ** 2)
    loss.backward()
    names = ("points", "scales", "opacity", "rgb")
    for name, t, g in list(zip(names, ins, g_j))[:4 if with_rgb else 3]:
        assert float(np.abs(np.asarray(g)).max()) > 0, name
        rel = _rel(t.grad.numpy(), g)
        assert rel < bound, f"{name}: rel grad err {rel}"


def _targets(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=sh).astype(np.float32) for sh in shapes]


@pytest.mark.parametrize("with_rgb", [True, False])
@pytest.mark.parametrize("remat", [True, False])
def test_windowed_density_matches_dpcx(with_rgb, remat):
    """anisotropic_density_grid_windowed against dpcx's: density and colour
    grids (N 300 pads the last chunk of 128), and the gradients of the
    squared error to seeded targets to points, scales, rotations and
    opacity."""
    pts, scales, rot, opac, rgb = _inputs(6, n=300)
    rgb = rgb if with_rgb else None
    tgt_d, tgt_c = _targets(7, (B, D, D, D), (B, D, D, D, 3))

    def functional(out, xp):
        if not with_rgb:
            return ((out - xp.asarray(tgt_d)) ** 2).mean()
        return (((out[0] - xp.asarray(tgt_d)) ** 2).mean()
                + ((out[1] - xp.asarray(tgt_c)) ** 2).mean())

    def j_loss(p, s, r, o):
        out = jgs.anisotropic_density_grid_windowed(
            p, s, r, D, o, None if rgb is None else jnp.asarray(rgb),
            remat=remat)
        return functional(out, jnp), out

    (_, want), g_j = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        *_j(pts, scales, rot, opac))
    ins = [t.requires_grad_() for t in _t(pts, scales, rot, opac)]
    got = tgs.anisotropic_density_grid_windowed(
        *ins[:3], D, ins[3], None if rgb is None else torch.from_numpy(rgb),
        remat=remat)
    got_d = got[0] if with_rgb else got
    want_d = np.asarray(want[0] if with_rgb else want)
    np.testing.assert_allclose(got_d.detach().numpy(), want_d, rtol=0,
                               atol=ATOL)
    if with_rgb:
        mask = want_d > 1e-3
        assert mask.mean() > 0.05
        np.testing.assert_allclose(got[1].detach().numpy()[mask],
                                   np.asarray(want[1])[mask], rtol=1e-4,
                                   atol=1e-4)
    functional(got, torch).backward()
    for name, t, g in zip(("points", "scales", "rotations", "opacity"), ins,
                          g_j):
        assert float(np.abs(np.asarray(g)).max()) > 0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4, err_msg=name)
        assert _rel(t.grad.numpy(), g) < 1e-4, name


@pytest.mark.parametrize("with_rgb", [True, False])
@pytest.mark.parametrize("remat", [True, False])
def test_gsplat_project_windowed_matches_dpcx(with_rgb, remat):
    """gsplat_project with gsplat_impl: windowed (gsplat_remat on and off)
    against dpcx's: silhouette (and colour), and the gradients of their
    squared error to seeded targets to points, scales, rotations and
    opacity."""
    jcfg, tcfg = _cfgs("windowed", gsplat_remat=remat)
    pts, scales, rot, opac, rgb = _inputs(8, n=300)
    rgb = rgb if with_rgb else None
    q = np.random.default_rng(12).normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tgt_s, tgt_c = _targets(13, (B, D, D), (B, D, D, 3))

    def functional(out, xp):
        loss = ((out.silhouette - xp.asarray(tgt_s)) ** 2).mean()
        return loss if out.rgb is None else loss + ((
            out.rgb - xp.asarray(tgt_c)) ** 2).mean()

    def j_render(p, s, r, o):
        out = jgs.gsplat_project(jcfg, p, jnp.asarray(q), s, r, o,
                                 None if rgb is None else jnp.asarray(rgb))
        return functional(out, jnp), out

    (_, out_j), g_j = jax.value_and_grad(j_render, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        *_j(pts, scales, rot, opac))
    ins = [t.requires_grad_() for t in _t(pts, scales, rot, opac)]
    out_t = tgs.gsplat_project(
        tcfg, ins[0], torch.from_numpy(q), ins[1], ins[2], ins[3],
        None if rgb is None else torch.from_numpy(rgb))
    np.testing.assert_allclose(out_t.silhouette.detach().numpy(),
                               np.asarray(out_j.silhouette), rtol=0,
                               atol=ATOL)
    if with_rgb:
        np.testing.assert_allclose(out_t.rgb.detach().numpy(),
                                   np.asarray(out_j.rgb), rtol=0, atol=ATOL)
    else:
        assert out_t.rgb is None and out_j.rgb is None
    functional(out_t, torch).backward()
    for name, t, g in zip(("points", "scales", "rotations", "opacity"), ins,
                          g_j):
        assert float(np.abs(np.asarray(g)).max()) > 0, name
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4, err_msg=name)
        assert _rel(t.grad.numpy(), g) < 1e-4, name


def _cfgs(impl, **kw):
    jcfg = JConfig(vox_size=D, pc_num_points=N, pc_rgb=True, pc_gauss=True,
                   gsplat_impl=impl, **kw)
    return jcfg, Config(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("impl,proj_depth", [("pallas", False),
                                             ("pallas", True),
                                             ("dense", False)])
def test_gsplat_project_matches_dpcx(impl, proj_depth, monkeypatch):
    """Silhouette, depth and colour of the whole splat renderer, and the
    gradient of their sum to every input."""
    jcfg, tcfg = _cfgs(impl, proj_depth=proj_depth)
    pts, scales, rot, opac, rgb = _inputs(4)
    q = np.random.default_rng(11).normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    orig = jgs.anisotropic_density_grid_pallas
    monkeypatch.setattr(jgs, "anisotropic_density_grid_pallas",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))

    def j_render(p, s, o, r):
        out = jgs.gsplat_project(jcfg, p, jnp.asarray(q), s, jnp.asarray(rot),
                                 o, r)
        loss = out.silhouette.sum() + out.rgb.sum()
        if proj_depth:
            loss = loss + out.depth.sum()
        return loss, out

    (_, out_j), g_j = jax.value_and_grad(j_render, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        *_j(pts, scales, opac, rgb))
    ins = [t.requires_grad_() for t in _t(pts, scales, opac, rgb)]
    out_t = tgs.gsplat_project(tcfg, ins[0], torch.from_numpy(q), ins[1],
                               torch.from_numpy(rot), ins[2], ins[3])
    pairs = [(out_t.silhouette, out_j.silhouette), (out_t.rgb, out_j.rgb)]
    if proj_depth:
        pairs.append((out_t.depth, out_j.depth))
    else:
        assert out_t.depth is None and out_j.depth is None
    for a, b in pairs:
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=ATOL, atol=ATOL)
    loss = out_t.silhouette.sum() + out_t.rgb.sum()
    if proj_depth:
        loss = loss + out_t.depth.sum()
    loss.backward()
    for name, t, g in zip(("points", "scales", "opacity", "rgb"), ins, g_j):
        rel = _rel(t.grad.numpy(), g)
        assert rel < 5e-4, f"{name}: rel grad err {rel}"


def test_gsplat_refusals():
    """D > 64 with the Pallas path raises as in dpcx; a device that is
    neither cpu nor cuda raises, and so does an operand mode dpcx lacks.
    bfloat16 operands run on the CPU (the plain version, K7's function as
    its backward) with finite gradients."""
    _, tcfg = _cfgs("pallas")
    pts, scales, rot, opac, rgb = _t(*_inputs(5, n=64))
    q = torch.tensor([[1.0, 0, 0, 0]] * B)
    ins = [t.clone().requires_grad_() for t in (pts, scales, opac, rgb)]
    out = tgs.gsplat_project(tcfg.replace(pallas_acc_dtype="bfloat16"),
                             ins[0], q, ins[1], rot, ins[2], ins[3])
    (out.silhouette.sum() + out.rgb.sum()).backward()
    assert all(t.grad.isfinite().all() and t.grad.abs().max() > 0
               for t in ins)
    with pytest.raises(ValueError, match="acc_dtype"):
        tgs.gsplat_project(tcfg.replace(pallas_acc_dtype="float16"), pts, q,
                           scales, rot, opac, rgb)
    with pytest.raises(ValueError, match="vox_size<=64"):
        tgs.gsplat_project(tcfg.replace(vox_size=72), pts, q, scales, rot,
                           opac, rgb)
    mu = torch.zeros(1, 4, 3, device="meta")
    with pytest.raises(ValueError, match="cuda .* or cpu"):
        aniso.aniso_density(mu, torch.zeros(1, 4, 6, device="meta"),
                            torch.zeros(1, 4, device="meta"), None,
                            torch.zeros(1, 4, device="meta"), 16)
    out = tgs.gsplat_project(tcfg, pts, q, scales, rot, opac, rgb)
    assert out.silhouette.shape == (B, D, D) and out.rgb.shape == (B, D, D, 3)
    assert not any(aniso.LAUNCHES.values())
