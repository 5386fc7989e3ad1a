"""The port's synthetic shards against dpcx's ``make_dataset`` (CPU).

Since the port draws dpcx's ``jax.random`` bits (``data/synthetic.py``:
the model keys ``split(PRNGKey(seed), num_models)``, dpcx's splits site by
site, ``uniform`` with jax's ``minval``/``maxval`` formula, ``normal``
through XLA's ``erf_inv``, ``choice`` with jax's cumsum in XLA:CPU's
order), a shard made from a seed is dpcx's shard of that seed. Before,
the port drew from a ``torch.Generator`` and its points lay O(1) from
dpcx's (other models altogether) under the same cache name.

Tolerance: the renderer's parity, atol 2e-5, on points, quats, masks,
depths and images, and on the palette and stripe/two-tone draws. A
``choice`` index may flip where torch's area sum and XLA's differ by an
ulp; a flipped surface point lies on another face (off by O(0.1)). The
flips are counted on the points and held to MAX_FLIPS; with jax 0.9.0
and torch 2.13.0+cpu there are 0 of the 24,000 draws below.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dpcx.config import Config
from dpcx.data import synthetic as jsyn
from dpcx_torch.config import Config as TConfig
from dpcx_torch.data import synthetic as tsyn
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

ATOL = 2e-5
MODELS, GT_POINTS, SEED = 6, 2000, 3  # 2 of each of the trio
MAX_FLIPS = 24  # 1e-3 of the 24,000 choices


def _key(jkey) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jkey))


@pytest.fixture(scope="module", params=["stripes", "lowfreq"])
def shards(request):
    cfg = Config(vox_size=16, image_size=16, num_views=3, category="multi",
                 texture_mode=request.param)
    want = jsyn.make_dataset(cfg, MODELS, seed=SEED, gt_points=GT_POINTS)
    got = tsyn.make_dataset(TConfig(**dataclasses.asdict(cfg)), MODELS,
                            seed=SEED, gt_points=GT_POINTS)
    return cfg, {k: np.asarray(v) for k, v in want.items()}, \
        {k: v.numpy() for k, v in got.items()}


def test_shard_is_dpcx_shard(shards):
    cfg, want, got = shards
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["category_idx"], want["category_idx"])
    off = np.abs(got["gt_points"] - want["gt_points"]).max(-1) > ATOL
    flips = int(off.sum())
    print(f"{cfg.texture_mode}: {flips} choice flips of {off.size}")
    assert flips <= MAX_FLIPS
    flipped_models = off.any(-1)
    np.testing.assert_allclose(got["gt_points"][~off],
                               want["gt_points"][~off], atol=ATOL)
    np.testing.assert_allclose(got["quats"], want["quats"], atol=ATOL)
    # a flip moves a point of the dense cloud the views are rendered from
    for k in ("masks", "depths", "images"):
        np.testing.assert_allclose(got[k][~flipped_models],
                                   want[k][~flipped_models], atol=ATOL,
                                   err_msg=k)


def test_appearance_draws_are_dpcx_draws(shards):
    """The palette and the stripe / two-tone draws of each model, from
    the port's keys against jax's on dpcx's splits."""
    cfg = shards[0]
    jkeys = jax.random.split(jax.random.PRNGKey(SEED), MODELS)
    keys = prng.split(prng.prng_key(SEED), MODELS)
    for jk, k in zip(jkeys, keys):
        assert _key(jk) == k
        _, _, jkc, jkt = jax.random.split(jk, 4)
        _, _, kc, kt = prng.split(k, 4)
        pairs = [(jax.random.uniform(jkc, (8, 3), minval=0.15, maxval=0.95),
                  prng.uniform(kc, (8, 3), minval=0.15, maxval=0.95))]
        if cfg.texture_mode == "lowfreq":
            jkd, jkf, jkb = jax.random.split(jkt, 3)
            kd, kf, kb = prng.split(kt, 3)
            pairs += [
                (jax.random.normal(jkd, (2,)), prng.normal(kd, (2,))),
                (jax.random.uniform(jkf, (3,), minval=0.55, maxval=0.95),
                 prng.uniform(kf, (3,), minval=0.55, maxval=0.95)),
                (jax.random.uniform(jkb, (3,), minval=0.05, maxval=0.45),
                 prng.uniform(kb, (3,), minval=0.05, maxval=0.45))]
        else:
            pairs.append((jax.random.normal(jkt, (3,)),
                          prng.normal(kt, (3,))))
        for want, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)


@pytest.mark.parametrize("n", [6, 16, 60, 257, 300])
def test_cumsum_is_xla_cumsum(n):
    """``cumsum_xla`` is ``jnp.cumsum``'s bits (XLA:CPU's blocked scan)
    at the area vectors' lengths (6 faces x 1-10 boxes) and past one
    level of blocks."""
    rng = np.random.default_rng(n)
    for _ in range(20):
        x = (rng.random(n) * rng.random()).astype(np.float32)
        want = np.asarray(jax.jit(jax.numpy.cumsum)(x))
        np.testing.assert_array_equal(
            tsyn.cumsum_xla(torch.from_numpy(x)).numpy(), want)
