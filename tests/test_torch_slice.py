"""The port's slice end to end against dpcx: serve clouds, then score them
with the GT-pose loss forward; plus the HTTP front end, the CLI verb, and
the port's independence from jax and from dpcx.

Tolerances: served outputs at ``compute_dtype=float32`` atol 1e-5 (the
model tests' bound); loss and metrics rtol 1e-4 (f32 renders summed in
another order, then averaged).
"""

import ast
import dataclasses
import http.server
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import load_config as j_load_config
from dpcx.models.losses import compute_loss as j_compute_loss
from dpcx.render.project import pointcloud_project_fn as j_project
from dpcx.serve import ServingModel as JServingModel
from dpcx.train import create_state
from dpcx_torch import cli
from dpcx_torch.config import Config, load_config
from dpcx_torch.convert import params_from_flax
from dpcx_torch.models.losses import compute_loss
from dpcx_torch.render import fused
from dpcx_torch.serve import ServingModel, serve
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-4


@pytest.fixture
def tiny_yaml(tmp_path):
    p = tmp_path / "tiny.yaml"
    p.write_text(
        "\n".join(
            [
                "name: tiny",
                f"checkpoint_dir: {tmp_path}/run",
                "vox_size: 16",
                "mask_size: 16",
                "pc_num_points: 256",
                "image_size: 16",
                "encoder_filters: [8, 16]",
                "latent_dim: 32",
                "fc_hidden: 32",
                "pc_decoder_hidden: [32]",
                "batch_size: 2",
                "renderer: pallas",
                "proj_depth: true",
                "drc_weight: 0.1",
                "compute_dtype: float32",
            ]
        )
    )
    return str(p)


def _params(cfg):
    state = create_state(j_load_config(None, **dataclasses.asdict(cfg)),
                         jax.random.PRNGKey(0))
    return state.params, params_from_flax(jax.tree.map(np.asarray,
                                                       state.params))


def _targets(cfg, models, views, seed=4):
    """Masks/depths [M, V, D, D] of seeded clouds from seeded cameras,
    rendered by dpcx's XLA path; quats [M, V, 4]."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(models, 400, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = (pts * rng.uniform(0.15, 0.4, (models, 1, 3))).astype(np.float32)
    q = rng.normal(size=(models, views, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    out = j_project(
        cfg.replace(renderer="xla", proj_depth=True),
        jnp.repeat(jnp.asarray(pts), views, axis=0),
        jnp.asarray(q.reshape(-1, 4)),
        jnp.asarray(cfg.pc_relative_sigma_end),
    )
    D = cfg.vox_size
    return {
        "masks": np.array(out.silhouette).reshape(models, views, D, D),
        "depths": np.array(out.depth).reshape(models, views, D, D),
        "quats": q,
    }


@pytest.mark.parametrize(
    "overrides",
    [
        {},  # car_64_depth's renderer settings: pallas + depth loss
        {"proj_depth": False, "drc_weight": 0.0},
        {"renderer": "xla", "xla_splat": "scatter"},
        {"scale_weight": 0.5},
    ],
)
@pytest.mark.parametrize("step", [0, 60_000])
def test_serve_then_score_matches_dpcx(tiny_yaml, overrides, step, rng):
    cfg = j_load_config(tiny_yaml).replace(**overrides)
    tcfg = Config(**dataclasses.asdict(cfg))  # the port's, same fields
    params_j, params_t = _params(cfg)
    imgs = rng.random((3, cfg.image_size, cfg.image_size, 3), np.float32)
    served_j = JServingModel(cfg, params_j, batch_size=2)(imgs)
    served_t = ServingModel(tcfg, params_t, batch_size=2)(imgs)
    assert served_t.keys() == served_j.keys() == {"points", "scale"}
    for k in served_t:
        np.testing.assert_allclose(served_t[k], served_j[k], atol=1e-5)

    batch = _targets(cfg, models=3, views=2)
    total_j, metrics_j = j_compute_loss(
        cfg, {k: jnp.asarray(v) for k, v in served_j.items()},
        {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(step), jax.random.PRNGKey(0), train=False,
    )
    total_t, metrics_t = compute_loss(
        tcfg, {k: torch.from_numpy(v) for k, v in served_t.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()},
        step, train=False,
    )
    assert metrics_t.keys() == set(metrics_j)
    if cfg.proj_depth:
        assert "loss_depth" in metrics_t
    for k, v in metrics_t.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(metrics_j[k]),
                                   rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(total_t.numpy(), np.asarray(total_j),
                               rtol=RTOL)
    assert not any(fused.LAUNCHES.values())  # CPU: no kernel launches


def test_compute_loss_refuses_unported(tiny_yaml):
    cfg = load_config(tiny_yaml)
    preds = {"points": torch.zeros(2, cfg.pc_num_points, 3)}
    D = cfg.vox_size
    batch = {"masks": torch.zeros(2, 2, D, D), "depths": torch.zeros(2, 2, D, D),
             "quats": torch.tensor([1.0, 0, 0, 0]).repeat(2, 2, 1)}
    # point dropout is ported: train=True draws the keep weights from the
    # key passed in, and needs one
    drop = cfg.replace(pc_point_dropout=0.5)
    with pytest.raises(ValueError, match="key"):
        compute_loss(drop, preds, batch, 0, train=True)
    totals = [compute_loss(drop, preds, batch, 0, prng.prng_key(s),
                           train=True)[0]
              for s in (1, 1, 2)]
    assert all(torch.isfinite(t) for t in totals)
    assert totals[0] == totals[1]
    # predicted pose, once refused: the candidates' renders and the winner
    K = 3
    pp = cfg.replace(predict_pose=True, pose_predict_num_candidates=K)
    quats = torch.tensor([1.0, 0, 0, 0]).repeat(2, K, 1)
    total, m = compute_loss(pp, {**preds, "quats": quats},
                            {**batch, "quat_in": batch["quats"][:, 0]}, 0,
                            train=False)
    assert torch.isfinite(total) and m["cand_spread"].item() == 0.0
    # dropout off: train=True is the same forward
    total, _ = compute_loss(cfg.replace(pc_point_dropout=1.0), preds, batch,
                            0, train=True)
    assert torch.isfinite(total)


@pytest.mark.parametrize("overrides", [
    # rgb_splats' renderer: anisotropic splats through gsplat_impl pallas
    {"pc_rgb": True, "pc_gauss": True, "gsplat_impl": "pallas"},
    {"pc_rgb": True, "pc_gauss": True, "gsplat_impl": "dense",
     "proj_depth": True, "drc_weight": 0.1},
    # the isotropic colour path and the depth resize
    {"pc_rgb": True, "renderer": "xla", "xla_splat": "scatter",
     "proj_depth": True, "drc_weight": 0.1},
])
def test_rgb_loss_and_resize_match_dpcx(overrides):
    """The GT-pose loss with masks, depths and target images stored at 2x
    the grid (resized at loss time: bilinear with antialiasing, depths to
    the nearest sample), the colour term with the background composite,
    and the gauss-splat branch, against dpcx's compute_loss (its gsplat
    runs in interpret mode off-TPU), dropout off: every metric to 1e-5
    relative."""
    D, S, B, V, N = 8, 16, 2, 2, 64
    cfg = j_load_config(None, vox_size=D, mask_size=2 * D, image_size=S,
                        pc_num_points=N, pc_point_dropout=1.0,
                        **overrides)
    tcfg = Config(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(7)
    lo, hi = cfg.gauss_scale_min, cfg.gauss_scale_max
    rot = rng.normal(size=(B, N, 4))
    preds = {
        "points": rng.uniform(-0.35, 0.35, (B, N, 3)),
        "rgb": rng.uniform(size=(B, N, 3)),
        "gauss_scales": lo + (hi - lo) * rng.uniform(size=(B, N, 3)),
        "gauss_rot": rot / np.linalg.norm(rot, axis=-1, keepdims=True),
        "gauss_opacity": rng.uniform(size=(B, N)),
    }
    if not cfg.pc_gauss:
        preds = {k: preds[k] for k in ("points", "rgb")}
    masks = (rng.uniform(size=(B, V, 2 * D, 2 * D)) < 0.5)
    q = rng.normal(size=(B, V, 4))
    batch = {
        "masks": masks,
        "depths": np.where(masks, rng.uniform(-0.3, 0.3, masks.shape), 1.0),
        "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
        "images_tgt": rng.uniform(size=(B, V, S, S, 3)),
    }
    preds, batch = (
        {k: np.asarray(v, np.float32) for k, v in d.items()}
        for d in (preds, batch))
    total_j, m_j = j_compute_loss(
        cfg, {k: jnp.asarray(v) for k, v in preds.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0),
        jax.random.PRNGKey(0), train=True)
    total_t, m_t = compute_loss(
        tcfg, {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, 0, train=True)
    assert m_t.keys() == set(m_j)
    assert {"loss_rgb", "loss_proj", "loss_total"} <= m_t.keys()
    assert ("loss_depth" in m_t) == cfg.proj_depth
    for k, v in m_t.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(total_t.numpy(), np.asarray(total_j),
                               rtol=1e-5)


def _post(port, data):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=data, method="POST"
    )
    return urllib.request.urlopen(req, timeout=60)


def test_serve_http_roundtrip(tiny_yaml):
    """Mirrors tests/test_cli.py::test_serve_http_roundtrip on the port:
    POST npz images -> npz predictions, padding/chunking across the fixed
    serving batch, healthz counter, 400 on a bad body."""
    cfg = load_config(tiny_yaml)
    _, params = _params(cfg)
    srv = serve(cfg, params, port=0, batch_size=2)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        imgs = np.random.default_rng(0).random(
            (3, cfg.image_size, cfg.image_size, 3), np.float32
        )
        buf = io.BytesIO()
        np.savez(buf, images=imgs)
        with _post(port, buf.getvalue()) as resp:
            assert resp.status == 200
            with np.load(io.BytesIO(resp.read())) as f:
                pts = f["points"]
                scale = f["scale"]
        assert pts.shape == (3, cfg.pc_num_points, 3)
        assert scale.shape == (3, 1)
        assert np.isfinite(pts).all()
        np.testing.assert_array_equal(pts, srv.model(imgs)["points"])

        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as resp:
            health = json.loads(resp.read())
        # warmup + the POST + the direct call
        assert health == {"status": "ok", "requests": 3, "batch": 2}

        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, b"junk")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_serving_model_bf16_and_uint8(tiny_yaml):
    """Mirrors tests/test_cli.py::test_serving_model_bf16_and_chunking."""
    cfg = load_config(tiny_yaml)
    _, params = _params(cfg)
    m32 = ServingModel(cfg, params, batch_size=2)
    m16 = ServingModel(cfg, params, batch_size=2, cast_bf16=True)
    assert all(p.dtype == torch.bfloat16 for p in m16.model.parameters())
    imgs = np.random.default_rng(1).random(
        (5, cfg.image_size, cfg.image_size, 3), np.float32
    )
    p32 = m32(imgs)["points"]
    p16 = m16(imgs)["points"]
    assert p32.shape == p16.shape == (5, cfg.pc_num_points, 3)
    assert p32.dtype == p16.dtype == np.float32
    assert float(np.abs(p32 - p16).mean()) < 0.05
    pu8 = m32((imgs * 255).astype(np.uint8))["points"]
    assert float(np.abs(pu8 - p32).max()) < 0.05
    # chunking + padding give what one row at a time gives
    one = np.concatenate([m32(imgs[i : i + 1])["points"] for i in range(5)])
    np.testing.assert_allclose(p32, one, atol=1e-6)
    assert m32.warmup() > 0.0


def test_cli_serve(tiny_yaml, monkeypatch, capsys):
    """The serve verb serves the seeded init when checkpoint_dir holds no
    checkpoint, also when the config asks for point-sharded rendering (on
    one process a no-op that warns, as dpcx on one device), and refuses to
    start when checkpoint_dir holds an Orbax checkpoint (dpcx's, which the
    port cannot read). (Serving the port's own checkpoint:
    tests/test_torch_train.py.)"""
    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever",
                        lambda self, *a, **k: None)
    cli.main(["serve", "-f", tiny_yaml, "--port", "0", "--batch", "2",
              "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch"] == 2 and out["serving"] > 0

    sharded = Path(tiny_yaml).with_name("sharded.yaml")
    sharded.write_text(Path(tiny_yaml).read_text() + "\nshard_points: true\n")
    with pytest.warns(UserWarning, match="shard_points on a single device"):
        cli.main(["serve", "-f", str(sharded), "--port", "0", "--batch",
                  "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch"] == 2 and out["serving"] > 0

    cfg = load_config(tiny_yaml)
    ckpt = Path(cfg.checkpoint_dir) / "ckpt" / "100"
    ckpt.mkdir(parents=True)
    with pytest.raises(SystemExit, match="Orbax.*cannot read"):
        cli.main(["serve", "-f", tiny_yaml, "--device", "cpu"])


def test_port_imports_no_jax():
    """Importing every dpcx_torch module (train, data, geometry.camera,
    utils and the splat renderer among them) leaves jax, flax and dpcx
    out."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dpcx_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dpcx_torch.__path__,"
        " 'dpcx_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dpcx'))\n"
        "need = {'dpcx_torch.train', 'dpcx_torch.data.dataset',\n"
        "        'dpcx_torch.data.synthetic', 'dpcx_torch.geometry.camera',\n"
        "        'dpcx_torch.utils.visualise', 'dpcx_torch.render.gsplat',\n"
        "        'dpcx_torch.render.aniso'}\n"
        "assert need <= set(names), need - set(names)\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 29, proc.stdout


FORBIDDEN = ("dpcx", "jax", "jaxlib", "flax")


@pytest.mark.parametrize("path", sorted(
    [REPO / "chip_smoke.py", *(REPO / "dpcx_torch").rglob("*.py")]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_dpcx(path):
    """No import or from-import anywhere in the port's sources or in
    chip_smoke.py (deferred ones inside functions included) names a module
    whose top level is dpcx, jax, jaxlib or flax."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad += [f"{n} (line {node.lineno})" for n in names
                if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_fails_without_cuda():
    """On a machine without a CUDA card the smoke run exits non-zero and
    prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda" in proc.stderr.lower()
