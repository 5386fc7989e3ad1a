"""The port's tfrecord -> npz converter (``dpcx_torch/data/convert.py``,
``cli convert``) against dpcx's ``convert_tfrecords`` on the same files
(CPU).

Three inputs, written once a module: tests/test_convert.py's two fixture
layouts (A: flat float features and unit quaternions; B: PNG views under
other names, 4 x 4 extrinsics, masks at image size block-averaged to the
grid), and the output of ``scripts/make_adversarial_tfrecords.py`` (PNG
masks at image resolution 20, resized to 8: a size that does not divide,
so the antialiased bilinear resize runs).

Tolerances: the same keys, shapes and dtypes; images, depths, GT points
and block means exact (the same numpy); quaternions from matrices atol
1e-6 (the same branchless formula in torch ops); the non-dividing resize
atol 1e-6 (torch's antialiased bilinear against ``jax.image.resize``'s
"linear", both float32; measured 1.8e-7 with jax 0.9.0 and torch
2.13.0 on the CPU); the stats dict equal.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

from dpcx.data.convert import convert_tfrecords as j_convert  # noqa: E402
from dpcx_torch import cli  # noqa: E402
from dpcx_torch.data.convert import convert_tfrecords  # noqa: E402
from torch_workers import share_cores  # noqa: E402

share_cores()

REPO = Path(__file__).resolve().parents[1]
V, H, DM = 3, 16, 8
RESIZE_ATOL = 1e-6
QUAT_ATOL = 1e-6


def _floats(x):
    return tf.train.Feature(
        float_list=tf.train.FloatList(value=np.asarray(x, np.float32).ravel()))


def _ints(x):
    return tf.train.Feature(
        int64_list=tf.train.Int64List(value=np.asarray(x).ravel()))


def _bytes(vals):
    return tf.train.Feature(bytes_list=tf.train.BytesList(value=vals))


def _write(path, examples):
    with tf.io.TFRecordWriter(str(path)) as w:
        for ex in examples:
            w.write(ex.SerializeToString())


def _layout_a(path):
    """Flat float_list features, unit quaternions, GT clouds of two
    lengths (the shorter padded by its last point)."""
    rng = np.random.default_rng(0)
    exs = []
    for n_gt in (50, 40):
        q = rng.normal(size=(V, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        exs.append(tf.train.Example(features=tf.train.Features(feature={
            "image": _floats(rng.random((V, H, H, 3))),
            "mask": _floats(rng.random((V, DM, DM)) > 0.5),
            "depth": _floats(rng.random((V, DM, DM))),
            "quaternion": _floats(q),
            "gt_points": _floats(rng.random((n_gt, 3))),
            "num_views": _ints([V]),
        })))
    _write(path, exs)


def _layout_b(path):
    """PNG views, other key names, 4 x 4 extrinsics, masks at image
    size."""
    rng = np.random.default_rng(1)
    exs = []
    for _ in range(2):
        img = (rng.random((V, H, H, 3)) * 255).astype(np.uint8)
        mask = (rng.random((V, H, H, 1)) > 0.5).astype(np.uint8) * 255
        q = rng.normal(size=(V, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        w, x, y, z = q.T
        rot = np.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ], -1).reshape(V, 3, 3)
        m44 = np.tile(np.eye(4), (V, 1, 1))
        m44[:, :3, :3] = rot
        exs.append(tf.train.Example(features=tf.train.Features(feature={
            "rgb": _bytes([tf.io.encode_png(i).numpy() for i in img]),
            "silhouette": _bytes([tf.io.encode_png(m).numpy()
                                  for m in mask]),
            "extrinsics": _floats(m44),
            "num_views": _ints([V]),
        })))
    _write(path, exs)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{layout: (tfrecord path, mask_size)}."""
    root = tmp_path_factory.mktemp("records")
    _layout_a(root / "a.tfrecord")
    _layout_b(root / "b.tfrecord")
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, str(REPO / "scripts/make_adversarial_tfrecords.py"),
         "--out", str(root / "adv.tfrecord"), "--models", "3",
         "--image-size", "20", "--views", "3"],
        check=True, cwd=REPO, env=env, capture_output=True)
    return {"float_features": (root / "a.tfrecord", None),
            "png_matrices_block_mean": (root / "b.tfrecord", DM),
            "adversarial_resize": (root / "adv.tfrecord", DM)}


def _hold_npz(got_path, want_path):
    with np.load(got_path) as g, np.load(want_path) as w:
        got, want = dict(g), dict(w)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
    return got, want


@pytest.mark.parametrize("layout", ["float_features",
                                    "png_matrices_block_mean",
                                    "adversarial_resize"])
def test_convert_matches_dpcx(layout, records, tmp_path):
    path, mask_size = records[layout]
    want_stats = j_convert(path, tmp_path / "j.npz", mask_size=mask_size)
    stats = convert_tfrecords(path, tmp_path / "t.npz", mask_size=mask_size,
                              device="cpu")
    assert stats == {**want_stats, "out": str(tmp_path / "t.npz")}
    got, want = _hold_npz(tmp_path / "t.npz", tmp_path / "j.npz")
    for k in ("images", "depths", "gt_points"):
        if k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["quats"], want["quats"], rtol=0,
                               atol=QUAT_ATOL)
    if layout == "adversarial_resize":
        assert stats["image_size"] % DM != 0
        err = np.abs(got["masks"] - want["masks"]).max()
        print(f"resize: max abs err {err:.3e}")
        assert err <= RESIZE_ATOL
        assert not stats["has_depth"] and stats["has_gt_points"]
    else:  # no resize, or the block mean: the same numpy
        np.testing.assert_array_equal(got["masks"], want["masks"])


def test_cli_convert_end_to_end(records, tmp_path, capsys):
    """``cli convert -i -o --mask-size --device cpu`` prints dpcx's stats
    line and writes dpcx's npz; ``-n`` limits the models (0, the verb's
    default, means all)."""
    path, _ = records["adversarial_resize"]
    out = tmp_path / "shard0.npz"
    cli.main(["convert", "-i", str(path), "-o", str(out), "--mask-size",
              str(DM), "--device", "cpu"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = j_convert(path, tmp_path / "j.npz", mask_size=DM)
    assert stats == {**want, "out": str(out)}
    got, want_npz = _hold_npz(out, tmp_path / "j.npz")
    np.testing.assert_allclose(got["masks"], want_npz["masks"], rtol=0,
                               atol=RESIZE_ATOL)
    cli.main(["convert", "-i", str(path), "-o", str(out), "-n", "2",
              "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "models"] == 2
