"""dpcx_torch data (numpy Dataset, shards, synthetic datagen) against dpcx.

- ``Dataset.batch``: bit for bit, from the same ``np.random.Generator``.
- Shards: each package loads what the other wrote, under dpcx's cache name.
- Datagen: the box templates on the same ``u`` (atol 1e-7); the GT views
  and the RGB image render on the same points, cameras and colours. Masks
  are a threshold of the silhouette at 0.4, so a pixel within float error
  of it may flip: at most 0.5% may; depths atol 2e-5 elsewhere; images
  atol 1e-4 (colour normalised by the grid, then resized).
  The random draws are dpcx's jax.random bits; whole datasets are held
  against dpcx's in tests/test_torch_datagen_draws.py, and here on their
  properties.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.data import dataset as jds
from dpcx.data import synthetic as jsyn
from dpcx.render.project import pointcloud_project as j_project
from dpcx_torch.config import Config as TConfig
from dpcx_torch.data import dataset as tds
from dpcx_torch.data import synthetic as tsyn
from dpcx_torch.geometry.camera import camera_from_view_angles
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

SMALL = dict(vox_size=8, pc_num_points=64, num_views=3, views_per_step=2,
             renderer="pallas", pc_relative_sigma=0.1)


def _t(cfg: Config) -> TConfig:
    """The port's Config with the same fields as dpcx's."""
    return TConfig(**dataclasses.asdict(cfg))


def _records(rng, models=5, views=4, size=8, D=8):
    return {
        "images": rng.random((models, views, size, size, 3), np.float32),
        "masks": (rng.random((models, views, D, D)) > 0.5).astype(np.float32),
        "depths": rng.random((models, views, D, D), np.float32),
        "quats": rng.normal(size=(models, views, 4)).astype(np.float32),
        "gt_points": rng.random((models, 20, 3), np.float32),
    }


@pytest.mark.parametrize("overrides", [
    {},
    {"pc_rgb": True, "pose_from_views": True, "pose_consistency_weight": 0.1},
    {"views_per_step": 9},  # more than the views there are
])
def test_batch_matches_dpcx_bit_for_bit(overrides, rng):
    cfg = Config(**overrides)
    recs = _records(rng)
    b_j = jds.Dataset(recs, cfg).batch(np.random.default_rng(7), 6)
    b_t = tds.Dataset(recs, _t(cfg)).batch(np.random.default_rng(7), 6)
    assert b_t.keys() == b_j.keys()
    for k in b_t:
        np.testing.assert_array_equal(b_t[k], b_j[k], err_msg=k)
    ds = tds.Dataset(recs, _t(cfg))
    np.testing.assert_array_equal(ds.eval_batch(np.arange(3))["image"],
                                  jds.Dataset(recs, cfg).eval_batch(
                                      np.arange(3))["image"])


def test_shards_cross_load(tmp_path, rng):
    """dpcx's shard in the cache file name is read by the port's
    load_or_make, the port's by dpcx's, and external shards by both."""
    cfg = Config(category="car", num_views=4, vox_size=8,
                 data_dir=str(tmp_path / "a"))
    recs = _records(rng)
    name = "car_m5_v4_d8_s3.npz"
    jds.save_shards(recs, tmp_path / "a" / name)
    got = tds.load_or_make(_t(cfg), 5, seed=3)  # must load, not generate
    for k, v in recs.items():
        np.testing.assert_array_equal(got.records[k], v)

    cfg_b = cfg.replace(data_dir=str(tmp_path / "b"))
    tds.save_shards(recs, tmp_path / "b" / name)
    back = jds.load_or_make(cfg_b, 5, seed=3)
    for k, v in recs.items():
        np.testing.assert_array_equal(back.records[k], v)

    ext = {k: v for k, v in recs.items() if k not in ("depths", "gt_points")}
    tds.save_shards(ext, tmp_path / "ext" / "s0.npz")
    jds.save_shards(ext, tmp_path / "ext" / "s1.npz")
    for load, c in ((tds.load_external, _t(cfg)), (jds.load_external, cfg)):
        ds = load(tmp_path / "ext" / "*.npz", c, limit=7)
        assert ds.num_models == 7
        assert ds.records["depths"].shape == (7, 4, 8, 8)


@pytest.mark.parametrize("category", ["chair", "car", "car_asym",
                                      "airplane"])
def test_box_templates_match_dpcx(category, rng):
    u = rng.random(8).astype(np.float32)
    b_j = jsyn._CATEGORY_FNS[category](jnp.asarray(u))
    b_t = tsyn._CATEGORY_FNS[category](torch.from_numpy(u))
    assert b_t.shape == (7, 6)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-7)
    assert tsyn.CATEGORIES == jsyn.CATEGORIES
    assert tsyn.MULTI_CATEGORIES == jsyn.MULTI_CATEGORIES


def _scene(rng, cfg, n=600):
    """A car's surface points, cameras from datagen's angle ranges, and
    per-view colours, as numpy."""
    key = prng.prng_key(int(rng.integers(1 << 30)))
    pts, _, _ = tsyn.sample_category_surface(key, "car", n)
    azim = rng.uniform(0, 2 * np.pi, cfg.num_views).astype(np.float32)
    elev = rng.uniform(0.1, 0.6, cfg.num_views).astype(np.float32)
    quats, _ = camera_from_view_angles(torch.from_numpy(azim),
                                       torch.from_numpy(elev),
                                       cfg.camera_distance)
    colors = rng.uniform(0.05, 0.95, (cfg.num_views, n, 3))
    return pts.numpy(), quats.numpy(), colors.astype(np.float32)


@pytest.mark.parametrize("image_size", [16, 32])  # x2 (car_64), x4 (chair)
def test_gt_views_and_images_match_dpcx(image_size, rng):
    cfg = Config(**SMALL, image_size=image_size)
    pts, quats, colors = _scene(rng, cfg)
    m_j, d_j = jsyn._render_gt_views(cfg, jnp.asarray(pts),
                                     jnp.asarray(quats))
    m_t, d_t = tsyn._render_gt_views(_t(cfg), torch.from_numpy(pts),
                                     torch.from_numpy(quats))
    flips = np.abs(m_t.numpy() - np.asarray(m_j)) > 0
    assert flips.mean() <= 0.005
    same = ~flips
    np.testing.assert_allclose(d_t.numpy()[same], np.asarray(d_j)[same],
                               atol=2e-5)
    assert 0.05 < m_t.numpy().mean() < 0.95

    # make_model's image render (dpcx/data/synthetic.py:296-308)
    V = cfg.num_views
    out = j_project(cfg.replace(proj_depth=False, proj_type="drc"),
                    jnp.tile(jnp.asarray(pts)[None], (V, 1, 1)),
                    jnp.asarray(quats), jnp.asarray(1.0 / cfg.vox_size),
                    rgb=jnp.asarray(colors))
    img = out.rgb + (1.0 - out.silhouette[..., None])
    img_j = jnp.clip(jax.image.resize(img, (V, image_size, image_size, 3),
                                      method="bilinear"), 0.0, 1.0)
    img_t = tsyn._render_images(_t(cfg), torch.from_numpy(pts),
                                torch.from_numpy(quats),
                                torch.from_numpy(colors))
    assert img_t.shape == (V, image_size, image_size, 3)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)


def test_surface_samples_lie_on_the_boxes():
    key = prng.prng_key(0)
    pts, box_idx, normals = tsyn.sample_category_surface(key, "chair", 2000)
    assert pts.shape == normals.shape == (2000, 3)
    assert torch.equal(normals.abs().sum(-1), torch.ones(2000))
    # the template jitter u is drawn from the key's first split, as dpcx's
    boxes = tsyn._chair_boxes(prng.uniform(prng.split(key)[0], (8,)))
    c, h = boxes[box_idx, :3], boxes[box_idx, 3:]
    rel = (pts - c) / h.clamp_min(1e-9)
    assert (rel.abs() <= 1 + 1e-5).all()
    # each point sits on the face its normal names
    face = (rel * normals).sum(-1)
    torch.testing.assert_close(face, torch.ones(2000), atol=1e-5, rtol=0)


def test_make_dataset_seeded_and_sliced():
    cfg = TConfig(**SMALL, image_size=16, category="multi")
    full = tsyn.make_dataset(cfg, 3, seed=5, gt_points=128)
    assert full["images"].shape == (3, 3, 16, 16, 3)
    assert full["masks"].shape == full["depths"].shape == (3, 3, 8, 8)
    assert full["quats"].shape == (3, 3, 4)
    assert full["gt_points"].shape == (3, 128, 3)
    assert full["category_idx"].tolist() == [0, 1, 2]
    assert all(torch.isfinite(v.float()).all() for v in full.values())
    assert ((full["images"] >= 0) & (full["images"] <= 1)).all()
    again = tsyn.make_dataset(cfg, 3, seed=5, gt_points=128)
    for k in full:
        assert torch.equal(full[k], again[k]), k
    # process 1 of 2 makes models 1 and 3 of 4, as one process would
    part = tsyn.make_dataset(cfg, 4, seed=5, gt_points=128,
                             process_index=1, process_count=2)
    whole = tsyn.make_dataset(cfg, 4, seed=5, gt_points=128)
    for k in whole:
        assert torch.equal(part[k], whole[k][1::2]), k
    other = tsyn.make_dataset(cfg, 3, seed=6, gt_points=128)
    assert not torch.equal(full["gt_points"], other["gt_points"])
