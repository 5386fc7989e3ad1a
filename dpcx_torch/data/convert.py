"""Reference tfrecords -> npz shards (port of ``dpcx/data/convert.py``).

The reference trains from tfrecords of rendered ShapeNet views: per-model
records of V views of image/mask/depth plus the camera. The feature names
and encodings vary, so the converter is tolerant:

- **key variants**: image/rgb/images/img, mask/masks/silhouette(s)/seg,
  depth/depths, quaternion/quat(s)/camera_quaternion/pose,
  extrinsics/extrinsic/matrix/camera_mat, azimuth+elevation angles,
  gt_points/points/pointcloud.
- **payload variants**: flat ``float_list`` tensors (shapes inferred from
  ``num_views``), PNG-encoded ``bytes_list`` entries (one per view), or raw
  little-endian float32 bytes.
- **camera variants**: unit quaternions (w,x,y,z), 3x3 / 3x4 / 4x4
  extrinsic matrices (rotation block -> quaternion), or
  (azimuth, elevation) view angles.

Output is one compressed npz in the ``load_external`` schema
(``data/dataset.py``): ``images [M,V,H,W,3]`` float in [0,1],
``masks [M,V,D,D]``, ``quats [M,V,4]``, optional ``depths`` and
``gt_points``. Masks/depths can be area-resized to ``mask_size``: a block
mean where the size divides (numpy, as dpcx), else the loss's antialiased
bilinear resize (``models/losses.py::_resize``, what dpcx's
``jax.image.resize(..., "linear")`` computes) on ``device``.

tensorflow parses the records and decodes PNG/JPEG views; it is imported
only when a record is read, as in dpcx. A machine without tensorflow
cannot convert, so this is a CPU tool (``cli convert --device cpu``).
"""

from __future__ import annotations

import glob as _glob
from pathlib import Path

import numpy as np
import torch

IMAGE_KEYS = ("image", "images", "rgb", "img", "view", "views")
MASK_KEYS = ("mask", "masks", "silhouette", "silhouettes", "seg", "alpha")
DEPTH_KEYS = ("depth", "depths", "depth_map", "depth_maps")
QUAT_KEYS = (
    "quaternion",
    "quaternions",
    "quat",
    "quats",
    "camera_quaternion",
    "cam_quat",
    "pose",
    "poses",
)
MATRIX_KEYS = (
    "extrinsics",
    "extrinsic",
    "matrix",
    "matrices",
    "camera_mat",
    "cam_matrix",
    "world2cam",
    "RT",
)
GT_KEYS = ("gt_points", "points", "pointcloud", "point_cloud", "vertices")


def _first(feats: dict, names: tuple[str, ...]):
    for n in names:
        if n in feats:
            return feats[n]
    return None


def _feature_payload(feat) -> tuple[str, object]:
    """tf.train.Feature -> ('float'|'int'|'bytes', value)."""
    kind = feat.WhichOneof("kind")
    if kind == "float_list":
        return "float", np.asarray(feat.float_list.value, np.float32)
    if kind == "int64_list":
        return "int", np.asarray(feat.int64_list.value, np.int64)
    return "bytes", list(feat.bytes_list.value)


def _decode_image_bytes(blob: bytes) -> np.ndarray:
    """One encoded view -> float32 [H, W, C] in [0, 1].

    PNG/JPEG via tf.io.decode_image; anything else is treated as raw
    little-endian float32 (caller reshapes)."""
    import tensorflow as tf

    if blob[:8] == b"\x89PNG\r\n\x1a\n" or blob[:2] == b"\xff\xd8":
        arr = tf.io.decode_image(blob, expand_animations=False).numpy()
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        if arr.dtype == np.uint16:
            return arr.astype(np.float32) / 65535.0
        return arr.astype(np.float32)
    return np.frombuffer(blob, np.float32).copy()


def _square_hw(n_px: float) -> int:
    h = int(round(float(n_px) ** 0.5))
    if h * h != int(round(n_px)):
        raise ValueError(f"cannot infer square image side from {n_px} pixels")
    return h


def _views_from_feature(feat, num_views: int, channels: int) -> np.ndarray:
    """Feature -> [V, H, W, C] (C==1 squeezed later by the caller)."""
    kind, val = _feature_payload(feat)
    if kind == "bytes":
        views = [_decode_image_bytes(b) for b in val]
        out = []
        for v in views:
            if v.ndim == 1:  # raw floats: assume square, `channels` deep
                h = _square_hw(v.size / channels)
                v = v.reshape(h, h, channels)
            if v.ndim == 2:
                v = v[..., None]
            if channels == 3 and v.shape[-1] == 1:
                v = np.repeat(v, 3, axis=-1)
            if channels == 3 and v.shape[-1] == 4:
                v = v[..., :3]
            out.append(v.astype(np.float32))
        return np.stack(out)
    flat = np.asarray(val, np.float32)
    h = _square_hw(flat.size / (num_views * channels))
    return flat.reshape(num_views, h, h, channels)


def _rotations_to_quats(mats: np.ndarray) -> np.ndarray:
    """[V, 3, 3] rotation blocks -> [V, 4] (w,x,y,z) quaternions through
    the branchless ``geometry.camera.matrix_to_quaternion``."""
    from dpcx_torch.geometry.camera import matrix_to_quaternion

    return matrix_to_quaternion(
        torch.from_numpy(mats.astype(np.float32))).numpy()


def _cameras(feats: dict, num_views: int) -> np.ndarray:
    q = _first(feats, QUAT_KEYS)
    if q is not None:
        _, val = _feature_payload(q)
        val = np.asarray(val, np.float32).reshape(num_views, -1)
        if val.shape[-1] == 4:
            n = np.maximum(
                np.linalg.norm(val, axis=-1, keepdims=True), 1e-12
            )
            if np.max(np.abs(n - 1.0)) <= 1e-3:  # already unit: keep bits
                return val
            return val / n
        raise ValueError(f"quaternion feature has width {val.shape[-1]}")
    m = _first(feats, MATRIX_KEYS)
    if m is not None:
        _, val = _feature_payload(m)
        flat = np.asarray(val, np.float32)
        per = flat.size // num_views
        if per == 9:
            mats = flat.reshape(num_views, 3, 3)
        elif per == 12:
            mats = flat.reshape(num_views, 3, 4)[:, :3, :3]
        elif per == 16:
            mats = flat.reshape(num_views, 4, 4)[:, :3, :3]
        else:
            raise ValueError(f"extrinsics feature has {per} values/view")
        return _rotations_to_quats(mats)
    az = feats.get("azimuth")
    el = feats.get("elevation")
    if az is not None and el is not None:
        from dpcx_torch.geometry.camera import camera_from_view_angles

        a = np.asarray(_feature_payload(az)[1], np.float32).reshape(-1)
        e = np.asarray(_feature_payload(el)[1], np.float32).reshape(-1)
        quats, _ = camera_from_view_angles(torch.from_numpy(a),
                                           torch.from_numpy(e))
        return quats.numpy()
    raise ValueError(
        "no camera feature found (tried quaternions, extrinsic matrices, "
        "view angles)"
    )


def _area_resize(x: np.ndarray, size: int, device="cpu") -> np.ndarray:
    """[..., H, W] -> [..., size, size]; block-mean when divisible (exact
    area resize), else antialiased bilinear on ``device``."""
    h = x.shape[-1]
    if h == size:
        return x
    if h % size == 0:
        f = h // size
        shp = x.shape[:-2] + (size, f, size, f)
        return x.reshape(shp).mean(axis=(-3, -1))
    from dpcx_torch.models.losses import _resize

    out = _resize(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                  size, "bilinear")
    return out.cpu().numpy()


def _num_views(feats: dict) -> int:
    nv = feats.get("num_views")
    if nv is not None:
        return int(np.asarray(_feature_payload(nv)[1]).ravel()[0])
    img = _first(feats, IMAGE_KEYS)
    if img is not None:
        kind, val = _feature_payload(img)
        if kind == "bytes":
            return len(val)
    q = _first(feats, QUAT_KEYS)
    if q is not None:
        return np.asarray(_feature_payload(q)[1]).size // 4
    raise ValueError("cannot infer num_views (no num_views/bytes/quats)")


def convert_tfrecords(
    inp: str | Path,
    out: str | Path,
    mask_size: int | None = None,
    limit: int | None = None,
    device="cpu",
) -> dict:
    """Convert reference-format tfrecord(s) to one npz shard.

    ``inp`` is a path or glob; ``mask_size`` area-resizes masks/depths to
    a D x D grid (a resize that is not a block mean runs on ``device``);
    ``limit`` stops after N models. Returns dpcx's stats dict."""
    import tensorflow as tf

    from dpcx_torch.data.dataset import save_shards

    paths = sorted(_glob.glob(str(inp)))
    if not paths:
        raise FileNotFoundError(f"no tfrecords match {inp}")

    images, masks, depths, quats, gts = [], [], [], [], []
    n_views = None
    for rec in tf.data.TFRecordDataset(paths):
        if limit is not None and len(images) >= limit:
            break
        ex = tf.train.Example()
        ex.ParseFromString(rec.numpy())
        feats = dict(ex.features.feature)

        v = _num_views(feats)
        if n_views is None:
            n_views = v
        elif v != n_views:
            raise ValueError(f"inconsistent view counts: {v} vs {n_views}")

        img_f = _first(feats, IMAGE_KEYS)
        if img_f is None:
            raise ValueError("no image feature found")
        images.append(_views_from_feature(img_f, v, 3))

        mask_f = _first(feats, MASK_KEYS)
        if mask_f is None:
            raise ValueError("no mask feature found")
        masks.append(_views_from_feature(mask_f, v, 1)[..., 0])

        depth_f = _first(feats, DEPTH_KEYS)
        if depth_f is not None:
            depths.append(_views_from_feature(depth_f, v, 1)[..., 0])

        quats.append(_cameras(feats, v))

        gt_f = _first(feats, GT_KEYS)
        if gt_f is not None:
            _, val = _feature_payload(gt_f)
            gts.append(np.asarray(val, np.float32).reshape(-1, 3))

    if not images:
        raise ValueError(f"no examples in {inp}")

    records: dict[str, np.ndarray] = {
        "images": np.stack(images),
        "masks": np.stack(masks),
        "quats": np.stack(quats).astype(np.float32),
    }
    if depths and len(depths) == len(images):
        records["depths"] = np.stack(depths)
    if gts and len(gts) == len(images):
        n_max = max(g.shape[0] for g in gts)
        # pad each cloud by repeating its last point so Chamfer is unbiased
        records["gt_points"] = np.stack(
            [
                np.concatenate(
                    [g, np.repeat(g[-1:], n_max - g.shape[0], axis=0)]
                )
                if g.shape[0] < n_max
                else g
                for g in gts
            ]
        )

    if mask_size:
        records["masks"] = _area_resize(records["masks"], mask_size, device)
        if "depths" in records:
            records["depths"] = _area_resize(records["depths"], mask_size,
                                             device)

    save_shards(records, out)
    return {
        "models": int(records["images"].shape[0]),
        "views": int(records["images"].shape[1]),
        "image_size": int(records["images"].shape[2]),
        "mask_size": int(records["masks"].shape[-1]),
        "has_depth": "depths" in records,
        "has_gt_points": "gt_points" in records,
        "out": str(out),
    }
