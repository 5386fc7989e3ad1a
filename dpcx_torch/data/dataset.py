"""Dataset container, batch sampling, and npz shard IO (port of the numpy
part of ``dpcx/data/dataset.py``).

The shard format is dpcx's: one ``np.savez_compressed`` file per shard,
per-model arrays stacked on axis 0, so either package reads what the other
wrote. ``Dataset.batch`` consumes its ``np.random.Generator`` exactly as
dpcx's does, so the same generator gives the same batch in both.
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np

from dpcx_torch.config import Config


class Dataset:
    """In-memory dataset of model records; batches for training.

    records: dict of arrays stacked over models —
      images [M, V, H, W, 3], masks [M, V, D, D], depths [M, V, D, D],
      quats [M, V, 4], gt_points [M, Ngt, 3]
    """

    def __init__(self, records: dict, cfg: Config):
        self.records = {k: np.asarray(v) for k, v in records.items()}
        self.cfg = cfg
        self.num_models = self.records["images"].shape[0]
        self.num_views = self.records["images"].shape[1]

    def batch_indices(self, rng: np.random.Generator, batch_size: int):
        """The draws of one batch, in dpcx's order: model ids [B], input
        views [B], target views [B, V_use] (without replacement per model),
        and the second input view [B] (another view of the same model) of
        the consistency loss, or None when it draws none."""
        V_use = min(self.cfg.views_per_step, self.num_views)
        m = rng.integers(0, self.num_models, size=batch_size)
        v_in = rng.integers(0, self.num_views, size=batch_size)
        v_tgt = np.stack(
            [
                rng.choice(self.num_views, size=V_use, replace=False)
                for _ in range(batch_size)
            ]
        )
        v_in2 = None
        if self.cfg.pose_consistency_weight > 0 and self.num_views >= 2:
            v_in2 = (
                v_in
                + 1
                + rng.integers(0, self.num_views - 1, size=batch_size)
            ) % self.num_views
        return m, v_in, v_tgt, v_in2

    def batch(self, rng: np.random.Generator, batch_size: int) -> dict:
        """Sample a batch: one random input view per model + views_per_step
        random target views (with replacement across models)."""
        m, v_in, v_tgt, v_in2 = self.batch_indices(rng, batch_size)
        rec = self.records
        batch = {
            "image": rec["images"][m, v_in],
            "masks": rec["masks"][m[:, None], v_tgt],
            "depths": rec["depths"][m[:, None], v_tgt],
            "quats": rec["quats"][m[:, None], v_tgt],
            "quat_in": rec["quats"][m, v_in],
            "model_idx": m,
        }
        if self.cfg.pc_rgb:
            batch["images_tgt"] = rec["images"][m[:, None], v_tgt]
        if self.cfg.pose_from_views:
            batch["images_v"] = rec["images"][m[:, None], v_tgt]
        if v_in2 is not None:
            batch["image_in2"] = rec["images"][m, v_in2]
        return batch

    def eval_batch(self, model_idx: np.ndarray, view_idx: int = 0) -> dict:
        return {
            "image": self.records["images"][model_idx, view_idx],
            "quats": self.records["quats"][model_idx, view_idx],
            "gt_points": self.records["gt_points"][model_idx],
        }


def load_external(
    pattern: str | Path, cfg: Config, limit: int | None = None
) -> Dataset:
    """Externally produced npz shards behind the Dataset interface.

    Each shard holds per-model arrays with matching view counts:
    ``images [M, V, H, W, 3]`` in [0, 1], ``masks [M, V, D, D]``, ``quats
    [M, V, 4]`` (w, x, y, z world->camera), optional ``depths`` and
    ``gt_points``. Shards are concatenated along the model axis.
    """
    paths = sorted(glob.glob(str(pattern)))
    if not paths:
        raise FileNotFoundError(f"no shards match {pattern}")
    parts = [load_shards(p) for p in paths]
    keys = set(parts[0])
    for p in parts[1:]:
        keys &= set(p)
    records = {
        k: np.concatenate([np.asarray(p[k]) for p in parts], axis=0)
        for k in keys
    }
    if "depths" not in records:
        records["depths"] = np.ones_like(records["masks"], np.float32)
    if "gt_points" not in records:
        records["gt_points"] = np.zeros(
            (records["images"].shape[0], 1, 3), np.float32
        )
    if limit:
        records = {k: v[:limit] for k, v in records.items()}
    return Dataset(records, cfg)


def save_shards(records: dict, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path, **{k: np.asarray(v) for k, v in records.items()}
    )


def load_shards(path: str | Path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def load_or_make(cfg: Config, num_models: int, seed: int = 0,
                 device=None) -> Dataset:
    """Load cached shards if present, else generate (rendering on
    ``device``) and cache, under dpcx's cache file name. The name names
    the same data in both packages: the port's ``make_dataset`` draws
    dpcx's ``jax.random`` bits, so its shard of a seed is dpcx's within the
    renderer's parity (atol 2e-5; tests/test_torch_datagen_draws.py).

    cfg.dataset == "npz" ingests externally produced shards from
    cfg.data_dir instead of generating synthetic data."""
    from dpcx_torch.data.synthetic import make_dataset

    if cfg.dataset == "npz":
        return load_external(
            Path(cfg.data_dir) / "*.npz", cfg, limit=num_models or None
        )

    cache = (
        Path(cfg.data_dir)
        / f"{cfg.category}_m{num_models}_v{cfg.num_views}"
          f"_d{cfg.vox_size}_s{seed}.npz"
    )
    if cache.exists():
        return Dataset(load_shards(cache), cfg)
    records = make_dataset(cfg, num_models, seed=seed, device=device)
    records = {k: v.cpu().numpy() for k, v in records.items()}
    save_shards(records, cache)
    return Dataset(records, cfg)
