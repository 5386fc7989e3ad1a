"""The port's renderer above D 64 against dpcx's depth-blocked path (the
Pallas kernels K3-K5 of ``dpcx/render/pallas_blocked.py``, in interpret mode
on the CPU), the ``remat`` -> ``save_grid`` switch, and remat training.

On the CPU the port's fused renderer runs its plain version; the CUDA
kernels behind it are held to that plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:
- sil and depth atol 3e-5, the bound ``tests/test_pallas_blocked.py`` holds
  K3 to against the XLA oracle;
- gradients atol 1e-4, ROADMAP's gradient tolerance;
- train steps at ``compute_dtype: float32``: parameters atol 1e-6 and
  ``loss_total`` rtol 1e-4, as ``tests/test_torch_train.py``;
- remat on against off in the port: the same plain ops run twice, so
  equal to atol 1e-6 (recomputed activations may round differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcx.models.losses as jlosses
import dpcx.render.pallas_kernel as jpk
from dpcx.config import Config
from dpcx.render.gauss import blur_matrix
from dpcx.render.pallas_blocked import blocked_backward
from dpcx.render.project import pointcloud_project_fn as j_project
from dpcx.train import _prep_batch
from dpcx.train import create_state as j_create_state
from dpcx.train import train_step as j_train_step
from dpcx_torch import train as ttrain
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import adam_state_from_optax, params_from_flax
from dpcx_torch.models import losses as tlosses
from dpcx_torch.render import fused
from dpcx_torch.render import project as tproject
from dpcx_torch.render.transform import CAMERA_DISTANCE, FOCAL_LENGTH
from dpcx_torch.utils import prng
import plain_world
from torch_workers import share_cores

share_cores()

ATOL = 3e-5
D = 72  # > 64: dpcx's depth-blocked kernels (9 z-blocks of 8)

BASE = Config(vox_size=D, renderer="pallas", pc_relative_sigma=0.05,
              xla_splat="scatter")


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


def _scene(rng, b, n, lim=0.6):
    """World clouds [B, N, 3], half in a ball of radius 0.15 (dense
    enough to saturate rays) and half in a cube of half-width ``lim``
    (0.6: points past both z ends, and off the x/y edges); unit quats;
    0/2 dropout weights."""
    ball = rng.normal(size=(b, n // 2, 3))
    ball *= 0.15 * rng.random((b, n // 2, 1)) ** (1 / 3) / np.linalg.norm(
        ball, axis=-1, keepdims=True)
    box = rng.uniform(-lim, lim, (b, n - n // 2, 3))
    pts = np.concatenate([ball, box], axis=1).astype(np.float32)
    q = rng.normal(size=(b, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pw = ((rng.random((b, n)) < 0.5) / 0.5).astype(np.float32)
    return pts, q, pw


def _render_both(cfg, pts, q, pw, sigma_rel=0.05):
    out_j = j_project(cfg, jnp.asarray(pts), jnp.asarray(q),
                      jnp.asarray(sigma_rel),
                      point_weights=None if pw is None else jnp.asarray(pw))
    out_t = tproject.pointcloud_project_fn(
        _t(cfg), torch.from_numpy(pts), torch.from_numpy(q),
        torch.tensor(sigma_rel),
        point_weights=None if pw is None else torch.from_numpy(pw))
    return out_j, out_t


@pytest.mark.parametrize("with_depth", [False, True])
def test_forward_d72_matches_blocked_kernel(with_depth, rng):
    """pointcloud_project_fn at D 72 with dropout weights, against dpcx's
    K3 (blocked_forward via pallas_project_t, interpret mode)."""
    cfg = BASE.replace(proj_depth=with_depth)
    pts, q, pw = _scene(rng, 2, 200)
    out_j, out_t = _render_both(cfg, pts, q, pw)
    assert out_t.silhouette.shape == (2, D, D)
    assert float(out_t.silhouette.max()) > 0.3  # rays well past empty
    np.testing.assert_allclose(out_t.silhouette.numpy(),
                               np.asarray(out_j.silhouette), atol=ATOL)
    if with_depth:
        np.testing.assert_allclose(out_t.depth.numpy(),
                                   np.asarray(out_j.depth), atol=ATOL)
    else:
        assert out_t.depth is None and out_j.depth is None


def test_forward_d128_matches_blocked_kernel(rng):
    """The multicat_128 grid (dpcx: 4 z-blocks of 32), B 1, N 128, as
    tests/test_pallas_blocked.py's flagship case."""
    cfg = BASE.replace(vox_size=128, proj_depth=True)
    pts, q, _ = _scene(rng, 1, 128, lim=0.45)
    out_j, out_t = _render_both(cfg, pts, q, None, sigma_rel=0.02)
    np.testing.assert_allclose(out_t.silhouette.numpy(),
                               np.asarray(out_j.silhouette), atol=ATOL)
    np.testing.assert_allclose(out_t.depth.numpy(), np.asarray(out_j.depth),
                               atol=ATOL)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_d72_match_blocked_backward(remat, rng):
    """d loss / d points through pointcloud_project_fn at D 72, with depth
    and dropout weights, against dpcx's K4 + K5: with remat off the
    backward reads the saved grid (save_grid=True), with remat on it
    recomputes it (save_grid=False)."""
    cfg = BASE.replace(proj_depth=True, remat=remat)
    pts, q, pw = _scene(rng, 2, 160, lim=0.55)
    dsil = rng.normal(size=(2, D, D)).astype(np.float32)
    ddepth = rng.normal(size=(2, D, D)).astype(np.float32)

    def j_loss(p):
        out = j_project(cfg, p, jnp.asarray(q), jnp.asarray(0.05),
                        point_weights=jnp.asarray(pw))
        return jnp.sum(out.silhouette * dsil) + jnp.sum(out.depth * ddepth)

    g_j = np.asarray(jax.grad(j_loss)(jnp.asarray(pts)))
    p_t = torch.from_numpy(pts).requires_grad_()
    out = tproject.pointcloud_project_fn(
        _t(cfg), p_t, torch.from_numpy(q), torch.tensor(0.05),
        point_weights=torch.from_numpy(pw))
    loss = (out.silhouette * torch.from_numpy(dsil)).sum() + (
        out.depth * torch.from_numpy(ddepth)).sum()
    loss.backward()
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(p_t.grad.numpy(), g_j, atol=1e-4)


@pytest.mark.parametrize("vox,remat,takes_fused", [
    (72, False, True),
    (72, True, True),
    (128, False, True),
    (128, True, True),
    (136, False, False),  # above 128 both fall through to the plain ops
])
def test_dispatch_save_grid_matches_dpcx(vox, remat, takes_fused, rng,
                                         monkeypatch):
    """The port's project dispatch hands the fused renderer save_grid =
    not cfg.remat where dpcx hands it to pallas_project_t, and neither
    takes it above D 128."""
    cfg = BASE.replace(vox_size=vox, remat=remat)
    seen = {"port": [], "dpcx": []}

    def t_spy(points, quat, vox_size, *a, save_grid=None, **k):
        seen["port"].append(save_grid)
        return torch.zeros(quat.shape[0], vox_size, vox_size), None

    def j_spy(ndc_t, vox_size, *a, save_grid=None, **k):
        seen["dpcx"].append(save_grid)
        return jnp.zeros((ndc_t.shape[0], vox_size, vox_size)), None

    monkeypatch.setattr(tproject, "fused_project_world", t_spy)
    monkeypatch.setattr(jpk, "pallas_project_t", j_spy)
    pts, q, _ = _scene(rng, 1, 64, lim=0.3)
    out_j, out_t = _render_both(cfg, pts, q, None)
    want = [not remat] if takes_fused else []
    assert seen == {"port": want, "dpcx": want}
    if not takes_fused:
        np.testing.assert_allclose(out_t.silhouette.numpy(),
                                   np.asarray(out_j.silhouette), atol=ATOL)


@pytest.mark.parametrize("vox,save_grid,keeps_grid", [
    (72, True, True),
    (72, False, False),  # the recompute backward
    (16, False, True),  # save_grid has no effect at D <= 64, as in dpcx
])
def test_save_grid_wiring(vox, save_grid, keeps_grid, rng, monkeypatch):
    """The autograd.Function the card runs (``_FusedWorldRender``) on the
    CPU with its launches replaced by the plain forward and the plain VJP
    (``tests/plain_world.py``): at D > 64 with save_grid False it keeps no
    grid and its backward asks for the recompute (grid None); either way
    its gradients, the cameras' included, are plain autograd's through
    ``fused_project_world``'s CPU route."""
    radius = 3
    seen = plain_world.patch_launches(monkeypatch, 1.5)
    scene = plain_world.scene(rng, 2, 1, 150, True, True)

    def world(p, w, q, t):
        return plain_world.render_world(p, w, q, t, vox, torch.tensor(1.5),
                                        radius, True, save_grid)

    def plain(p, w, q, t):
        return fused.fused_project_world(
            p, q, vox, 1.5, radius, w, t, FOCAL_LENGTH,
            CAMERA_DISTANCE, True)

    g_f = plain_world.world_grads(world, *scene, "cameras", True, True)
    assert (seen["grid"] is not None) == keeps_grid
    g_p = plain_world.world_grads(plain, *scene, "cameras", True, True)
    for a, b in zip(g_f, g_p):
        assert b.abs().max() > 0
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_integer_coordinate_gradient_dpcx_gives_zero(rng):
    """At an exactly integer grid coordinate dpcx's Pallas backwards (K2
    at D 16 through pallas_project_t; K4 + K5 through blocked_backward)
    give 0 along that axis (``_dhat_t``), which the port's kernels copy;
    the floor-based derivative of dpcx's XLA scatter, and of the port's
    plain version, is one-sided there."""
    R, N, radius = 1, 256, 2
    vox = 16  # (g + 0.5) / 16 - 0.5 is exact, so NDC -> grid round-trips
    g = rng.uniform(2, vox - 3, (R, 3, N)).astype(np.float32)
    g[:, 0, : N // 2] = np.round(g[:, 0, : N // 2])  # integer z
    ndc_t = ((g[:, ::-1] + 0.5) / vox - 0.5).astype(np.float32)
    dsil = rng.normal(size=(R, vox, vox)).astype(np.float32)

    def j_loss(x):
        sil, _ = jpk.pallas_project_t(x, vox, jnp.asarray(1.2), radius,
                                      interpret=True)
        return jnp.sum(sil * dsil)

    d_k2 = np.asarray(jax.grad(j_loss)(jnp.asarray(ndc_t)))[:, ::-1]  # zyx
    x = torch.from_numpy(ndc_t.copy()).requires_grad_()
    sil, _ = fused.fused_project_t(x, vox, torch.tensor(1.2), radius)
    (sil * torch.from_numpy(dsil)).sum().backward()
    d_plain = x.grad.numpy()[:, ::-1]

    # K4 + K5 on the same grid coordinates (z-sorted, as dpcx sorts them)
    order = np.argsort(g[0, 0], kind="stable")
    st = np.concatenate([g[:, :, order], np.ones((R, 1, N), np.float32)], 1)
    d_blocked = np.asarray(blocked_backward(
        jnp.asarray(st), blur_matrix(jnp.asarray(1.2), vox, radius),
        jnp.asarray(dsil), jnp.zeros((R, vox, vox)), vox, radius, False,
        "float32", True))
    on_int = order < N // 2
    assert (d_k2[:, 0, : N // 2] == 0).all()
    assert (d_blocked[:, 0, on_int] == 0).all()
    assert (np.abs(d_plain[:, 0, : N // 2]) > 0).mean() > 0.9
    # off the integers the three agree
    np.testing.assert_allclose(d_plain[:, 0, N // 2 :], d_k2[:, 0, N // 2 :],
                               atol=1e-4)
    np.testing.assert_allclose(d_blocked[:, :3, ~on_int],
                               d_k2[:, :, order[~on_int]] / vox, atol=1e-4)


SMALL = Config(
    vox_size=D, pc_num_points=64, image_size=16, encoder_filters=(8,),
    latent_dim=16, fc_hidden=16, pc_decoder_hidden=(16,), num_views=2,
    views_per_step=2, batch_size=2, compute_dtype="float32",
    pc_relative_sigma=0.08, pc_relative_sigma_end=0.08, proj_depth=True,
    drc_weight=0.1, learning_rate=1e-4, renderer="pallas",
    pc_point_dropout=0.5, xla_splat="scatter",
)


def _batch(rng, cfg):
    """A numpy training batch: image, blob masks, depths, unit quats."""
    B, V, S, Dv = cfg.batch_size, cfg.num_views, cfg.image_size, cfg.vox_size
    yy, xx = np.mgrid[:Dv, :Dv] / Dv - 0.5
    r = rng.uniform(0.15, 0.35, (B, V, 1, 1))
    masks = ((yy**2 + xx**2) < r**2).astype(np.float32)
    q = rng.normal(size=(B, V, 4)).astype(np.float32)
    return {
        "image": rng.random((B, S, S, 3), np.float32),
        "masks": masks,
        "depths": np.where(masks > 0, rng.uniform(-0.3, 0.3, masks.shape),
                           1.0).astype(np.float32),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
    }


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_d72_match_dpcx(remat, rng, monkeypatch):
    """dpcx create_state + one step (Adam's moments warm), then params and
    Adam state carried across by convert.py: two more steps at D 72 with
    renderer: pallas agree with dpcx's train_step, remat off and on."""
    cfg = SMALL.replace(remat=remat)
    w = ((rng.random((cfg.batch_size, cfg.pc_num_points)) < 0.5) / 0.5
         ).astype(np.float32)  # the same dropout weights on both sides
    monkeypatch.setattr(jlosses, "pc_point_dropout_weights",
                        lambda *a: jnp.asarray(w))
    monkeypatch.setattr(tlosses, "pc_point_dropout_weights",
                        lambda *a: torch.from_numpy(w))
    batches = [_batch(rng, cfg) for _ in range(3)]
    key = jax.random.PRNGKey(1)
    jstate = j_create_state(cfg, jax.random.PRNGKey(0))
    jstate, _ = j_train_step(cfg, jstate, _prep_batch(batches[0], cfg), key)

    tcfg = _t(cfg)
    state = ttrain.create_state(tcfg, "cpu")
    state.model.load_state_dict(
        params_from_flax(jax.tree.map(np.asarray, jstate.params)))
    adam = jstate.opt_state[0]
    state.load_adam_state(adam_state_from_optax(
        jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu),
        adam.count))
    state.step = int(jstate.step)
    for b in batches[1:]:
        jstate, m_j = j_train_step(cfg, jstate, _prep_batch(b, cfg), key)
        m_t = ttrain.train_step(tcfg, state,
                                ttrain._prep_batch(b, "cpu", cfg),
                                prng.prng_key(1))
        np.testing.assert_allclose(m_t["loss_total"].item(),
                                   float(m_j["loss_total"]), rtol=1e-4)
        want = params_from_flax(jax.tree.map(np.asarray, jstate.params))
        for k, v in state.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6,
                                       err_msg=k)


def test_remat_step_equals_plain_step(rng, monkeypatch):
    """remat on against off in the port, with point dropout drawn from the
    step's key: the checkpointed forward runs twice (forward, then the
    recompute in the backward), draws the same dropout weights both times
    (and as the plain step), and gives the plain step's loss, gradients and
    parameters."""
    tcfg = _t(SMALL.replace(vox_size=16, pc_relative_sigma=0.15,
                            pc_relative_sigma_end=0.15))
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng, tcfg).items()}
    calls = []
    real = ttrain.compute_loss

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ttrain, "compute_loss", counting)
    drawn = []
    real_weights = tlosses.pc_point_dropout_weights

    def recorded(*a, **k):
        drawn.append(real_weights(*a, **k))
        return drawn[-1]

    monkeypatch.setattr(tlosses, "pc_point_dropout_weights", recorded)
    runs = {}
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat)
        state = ttrain.create_state(cfg, "cpu")
        calls.clear()
        m = ttrain.train_step(cfg, state, batch, prng.prng_key(11))
        runs[remat] = (m, {n: p.grad.clone() for n, p in
                           state.model.named_parameters()},
                       state.model.state_dict(), len(calls))
    (m0, g0, p0, n0), (m1, g1, p1, n1) = runs[False], runs[True]
    assert (n0, n1) == (1, 2)
    assert len(drawn) == 3 and (drawn[0] == 0).any()
    assert all(torch.equal(w, drawn[0]) for w in drawn[1:])
    np.testing.assert_allclose(m1["loss_total"].item(),
                               m0["loss_total"].item(), rtol=1e-6)
    assert any(g.abs().max() > 0 for g in g0.values())
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], atol=1e-6, rtol=0)
        torch.testing.assert_close(p1[k], p0[k], atol=1e-6, rtol=0)
