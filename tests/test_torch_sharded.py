"""The port's point- and grid-sharded renderers and ``shard_points``
training against dpcx's (CPU, gloo).

A world of 2 ranks, started once for the module (``tests/torch_ranks.py``),
renders seeded inputs with ``render/sharded.py`` and differentiates a fixed
loss of the outputs; dpcx's ``render/sharded.py`` does the same on
``jax.devices()[:2]`` of the 8 host devices that ``tests/conftest.py``
forces. Every rank's outputs and gradients are held to dpcx's. Tolerances
are ``tests/test_sharded_render.py``'s: silhouette atol 1e-5, depth and rgb
1e-4, gradients with respect to points, colours and weights 2e-5 (the
GT-pose loss's value: 1e-5).

One ``shard_points`` training step in the same world (remat off and on)
against dpcx's step on 2 devices: dpcx's loss shards the points over every
jax device, so its side runs in a subprocess with
``--xla_force_host_platform_device_count=2``, as
``tests/test_torch_train_flags.py`` runs its one-device side. Tolerances
``tests/test_torch_train.py``'s: ``loss_total`` and ``grad_norm`` rtol
1e-4, parameters atol 1e-6.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.parallel.mesh import make_mesh as j_make_mesh
from dpcx.render.sharded import (
    gt_pose_projection_loss_sharded,
    pointcloud_project_grid_sharded,
    pointcloud_project_point_sharded,
)
from dpcx.train import create_state as j_create_state
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import params_from_flax
from torch_ranks import run_world, sharded_world
from torch_workers import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
POINT = Config(vox_size=12, pc_relative_sigma=0.1)
GRID = Config(vox_size=24, pc_relative_sigma=0.05, pc_relative_sigma_end=0.05)
# name -> (kind, dpcx config, inputs with rgb, with weights)
RENDERS = {
    "point_sil": ("point", POINT, False, False),
    "point_depth_rgb_weights": ("point", POINT.replace(proj_depth=True,
                                                       pc_rgb=True),
                                True, True),
    "point_sum": ("point", POINT.replace(proj_type="sum", proj_depth=True),
                  False, False),
    "grid_depth_weights": ("grid", GRID.replace(proj_depth=True), False,
                           True),
    "grid_rgb_prod": ("grid", GRID.replace(proj_depth=True), True, True),
    "grid_rgb_logsum": ("grid", GRID.replace(proj_depth=True,
                                             drc_logsum=True), True, True),
    "grid_sum": ("grid", GRID.replace(proj_type="sum"), False, False),
    "gt_pose_loss": ("loss", POINT.replace(pc_rgb=True), True, True),
}
TOL = {"silhouette": 1e-5, "depth": 1e-4, "rgb": 1e-4, "loss": 1e-5,
       "grad_points": 2e-5, "grad_rgb": 2e-5, "grad_weights": 2e-5}
# largecloud_pointshard's knobs (GT pose, renderer xla, shard_points) at a
# small size, as tests/test_torch_train_flags.py's
STEP = Config(
    vox_size=16, pc_num_points=256, image_size=16, encoder_filters=(8,),
    latent_dim=16, fc_hidden=16, pc_decoder_hidden=(16,), num_views=2,
    views_per_step=2, batch_size=2, compute_dtype="float32",
    renderer="xla", shard_points=True, pc_point_dropout=1.0,
    learning_rate=1e-4)
STEPS = {"step_remat_off": STEP, "step_remat_on": STEP.replace(remat=True)}

DPCX_STEPS = r"""
import dataclasses
import sys
import warnings

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
from dpcx.config import Config
from dpcx.train import _prep_batch, create_state, train_step

assert len(jax.devices()) == 2, jax.devices()
tmp = sys.argv[1]
out = {}


def flat(tree, prefix):
    for k, v in tree.items():
        if hasattr(v, "items"):
            flat(v, f"{prefix}{k}/")
        else:
            out[prefix + k] = np.asarray(v)


for name, kw in STEPS.items():
    cfg = Config(**kw)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        cfg.validate()
    out[f"{name}/warnings"] = np.array([str(w.message) for w in seen] or [""])
    with np.load(f"{tmp}/{name}_batch.npz") as f:
        batch = {k: f[k] for k in f.files}
    state, m = train_step(cfg, create_state(cfg, jax.random.PRNGKey(0)),
                          _prep_batch(batch, cfg), jax.random.PRNGKey(1))
    for k, v in m.items():
        out[f"{name}/metric/{k}"] = np.asarray(v)
    flat(jax.device_get(state.params), f"{name}/param/")
np.savez(f"{tmp}/dpcx_steps.npz", **out)
""".replace("STEPS", repr({n: dataclasses.asdict(c) for n, c in
                           STEPS.items()}))


def _t(cfg: Config) -> TConfig:
    return TConfig(**dataclasses.asdict(cfg))


def _inputs(kind, cfg, with_rgb, with_pw, seed):
    """Seeded inputs: 2 renders of 16 points a rank (24 on the grid), unit
    quaternions, target silhouettes (masks and colour images for the
    loss)."""
    rng = np.random.default_rng(seed)
    B, D = 2, cfg.vox_size
    N = 2 * (24 if kind == "grid" else 16)
    q = rng.normal(size=(B, 4))
    inp = {"points": rng.uniform(-0.4, 0.4, (B, N, 3)),
           "quat": q / np.linalg.norm(q, axis=1, keepdims=True),
           "sigma": np.asarray(cfg.pc_relative_sigma),
           "target": rng.uniform(0.0, 1.0, (B, D, D))}
    if with_rgb:
        inp["rgb"] = rng.uniform(0.0, 1.0, (B, N, 3))
    if with_pw:
        inp["weights"] = np.linspace(0.3, 1.0, N)[None].repeat(B, 0)
    if kind == "loss":
        inp["masks"] = (rng.uniform(size=(B, D, D)) > 0.6).astype(float)
        inp["images_tgt"] = rng.uniform(0.0, 1.0, (B, D, D, 3))
        del inp["target"]
    return {k: np.asarray(v, np.float32) for k, v in inp.items()}


def _dpcx_render(kind, cfg, inp):
    """dpcx's outputs and the gradients of the same loss as the ranks'."""
    mesh = j_make_mesh(cfg, devices=jax.devices()[:2])
    leaves = {k: jnp.asarray(inp[k]) for k in ("points", "rgb", "weights")
              if k in inp}
    quat, sigma = jnp.asarray(inp["quat"]), jnp.asarray(inp["sigma"])
    outs = {}

    def loss_fn(lv):
        if kind == "loss":
            loss = gt_pose_projection_loss_sharded(
                cfg, mesh, lv["points"], quat, jnp.asarray(inp["masks"]),
                sigma, rgb=lv.get("rgb"),
                images_tgt=jnp.asarray(inp["images_tgt"]),
                point_weights=lv.get("weights"))
            return loss, {"loss": loss}
        fn = (pointcloud_project_grid_sharded if kind == "grid"
              else pointcloud_project_point_sharded)
        o = fn(cfg, mesh, lv["points"], quat, sigma,
               point_weights=lv.get("weights"), rgb=lv.get("rgb"))
        res = {"silhouette": o.silhouette}
        loss = jnp.mean((o.silhouette - jnp.asarray(inp["target"])) ** 2)
        if o.depth is not None:
            loss = loss + jnp.mean(o.depth ** 2)
            res["depth"] = o.depth
        if o.rgb is not None:
            loss = loss + jnp.mean(o.rgb ** 2)
            res["rgb"] = o.rgb
        return loss, res

    grads, res = jax.jit(jax.grad(loss_fn, has_aux=True))(leaves)
    outs.update({k: np.asarray(v) for k, v in res.items()})
    outs.update({f"grad_{k}": np.asarray(v) for k, v in grads.items()})
    return outs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of 2 ranks (every render case, both steps), dpcx's steps
    in a 2-device subprocess meanwhile, and dpcx's renders in-process."""
    tmp = tmp_path_factory.mktemp("sharded")
    for i, (name, (kind, cfg, rgb, pw)) in enumerate(RENDERS.items()):
        np.savez(tmp / f"{name}_in.npz", **_inputs(kind, cfg, rgb, pw, i))
    rng = np.random.default_rng(5)
    for name, cfg in STEPS.items():
        js = j_create_state(cfg, jax.random.PRNGKey(0))
        torch.save(params_from_flax(jax.tree.map(np.asarray, js.params)),
                   tmp / f"{name}_init.pt")
        B, V, D, S = cfg.batch_size, cfg.num_views, cfg.vox_size, \
            cfg.image_size
        yy, xx = np.mgrid[:D, :D] / D - 0.5
        r = rng.uniform(0.15, 0.35, (B, V, 1, 1))
        q = rng.normal(size=(B, V, 4))
        np.savez(tmp / f"{name}_batch.npz",
                 image=rng.random((B, S, S, 3)).astype(np.float32),
                 masks=((yy**2 + xx**2) < r**2).astype(np.float32),
                 depths=np.zeros((B, V, D, D), np.float32),
                 quats=(q / np.linalg.norm(q, axis=-1, keepdims=True)
                        ).astype(np.float32))
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        [f for f in env.get("XLA_FLAGS", "").split()
         if "xla_force_host_platform_device_count" not in f]
        + ["--xla_force_host_platform_device_count=2"])
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(
        [sys.executable, "-c", DPCX_STEPS, str(tmp)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_world(sharded_world, 2, tmp, {
            "renders": {n: {"kind": k, "cfg": dataclasses.asdict(_t(c))}
                        for n, (k, c, _, _) in RENDERS.items()},
            "steps": {n: dataclasses.asdict(_t(c))
                      for n, c in STEPS.items()}})
        ref = {}
        for name, (kind, cfg, _, _) in RENDERS.items():
            with np.load(tmp / f"{name}_in.npz") as f:
                ref[name] = _dpcx_render(kind, cfg,
                                         {k: f[k] for k in f.files})
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-4000:]
    with np.load(tmp / "dpcx_steps.npz") as f:
        ref["steps"] = {k: f[k] for k in f.files}
    return tmp, ref


def _got(tmp, name, rank) -> dict:
    with np.load(tmp / f"{name}_r{rank}.npz") as f:
        return {k: f[k] for k in f.files}


CASES = [(name, key) for name, (kind, _, rgb, pw) in RENDERS.items()
         for key in (["loss"] if kind == "loss" else ["silhouette"])
         + (["depth"] if RENDERS[name][1].proj_depth else [])
         + (["rgb"] if rgb and kind != "loss" else [])
         + ["grad_points"] + (["grad_rgb"] if rgb else [])
         + (["grad_weights"] if pw else [])]


@pytest.mark.parametrize("name,key", CASES)
def test_sharded_render_matches_dpcx(name, key, world):
    """Each sharded render at W 2 on every rank: the output, or the
    gradient of the loss with respect to the replicated input, against
    dpcx's on 2 devices (the whole gradient on each rank)."""
    tmp, ref = world
    want = ref[name][key]
    for rank in (0, 1):
        got = _got(tmp, name, rank)[key]
        assert got.shape == want.shape, (got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=TOL[key],
                                   err_msg=f"{name} {key} rank {rank}")


@pytest.mark.parametrize("name", list(STEPS))
@pytest.mark.parametrize("what", ["metrics", "params", "warnings"])
def test_shard_points_step_matches_dpcx(name, what, world):
    """One shard_points train step at W 2 (every rank the whole batch, the
    points split over both), remat off and on (the recompute runs the
    collectives again, in the same order on both ranks), from dpcx's init:
    loss_total and grad_norm, the parameters, and no one-device warning,
    against dpcx's step on 2 devices."""
    tmp, ref = world
    want = {k[len(name) + 1:]: v for k, v in ref["steps"].items()
            if k.startswith(name + "/")}
    for rank in (0, 1):
        got = _got(tmp, name, rank)
        if what == "warnings":
            assert list(got["warnings"]) == list(want["warnings"]) == [""]
        elif what == "metrics":
            for k in ("loss_total", "grad_norm"):
                np.testing.assert_allclose(got[f"metric/{k}"],
                                           want[f"metric/{k}"], rtol=1e-4,
                                           err_msg=f"{k} rank {rank}")
        else:
            flat = {}
            for k, v in want.items():
                if k.startswith("param/"):
                    *path, leaf = k[len("param/"):].split("/")
                    node = flat
                    for p in path:
                        node = node.setdefault(p, {})
                    node[leaf] = v
            params = params_from_flax(flat)
            for k, v in params.items():
                np.testing.assert_allclose(got[f"param/{k}"], v.numpy(),
                                           atol=1e-6, err_msg=f"{k} {rank}")


def test_grid_sharded_refusals():
    """dpcx's refusals: z-blocks that do not split D, a blur radius above
    the block, and grid-sharded colour without DRC."""
    from dpcx_torch.parallel.mesh import Mesh
    from dpcx_torch.render.sharded import pointcloud_project_grid_sharded

    pts, quat = torch.zeros(1, 4, 3), torch.tensor([[1.0, 0, 0, 0]])
    for cfg, size, match in (
            (_t(GRID).replace(vox_size=25), 2, "does not split"),
            (_t(GRID).replace(pc_relative_sigma=0.4), 2, "exceeds z-block"),
            (_t(GRID).replace(proj_type="sum"), 1, "requires proj_type")):
        mesh = Mesh(shape=(size,), axes=("data",), rank=0, index=0,
                    device=torch.device("cpu"), members=tuple(range(size)))
        with pytest.raises(ValueError, match=match):
            pointcloud_project_grid_sharded(
                cfg, mesh, pts, quat, 0.05,
                rgb=torch.zeros(1, 4, 3) if "proj_type" in match else None)
