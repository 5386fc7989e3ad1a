"""``dpcx_torch/utils/prng.py`` against ``jax.random`` (CPU), bitwise.

The port draws dpcx's training stream itself: the keys (``PRNGKey``,
``fold_in``, ``split``), the 32-bit words, ``uniform``, ``randint`` and
``bernoulli`` must give jax's bits at every seed and shape, and so must the
point-dropout weights (``render/voxelize.py::pc_point_dropout_weights``,
the plain version of the draw kernel) and the float32 keep-prob schedule
they take. No tolerance: every comparison is of bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcx.render.project as jproject
import dpcx.render.voxelize as jvox
from dpcx.config import Config
from dpcx_torch.config import Config as TConfig
from dpcx_torch.render import project as tproject
from dpcx_torch.render import voxelize as tvox
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

SEEDS = (0, 1, 7, 123457)
SHAPES = ((8,), (3, 40), (4, 1000), (16, 16000))


def _key(jkey) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jkey))


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS + (2**31 - 1,))
def test_keys_match_jax(seed):
    """PRNGKey, fold_in at steps 0 .. 2^31 - 1 and split(., n)."""
    jk = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    assert _key(jk) == k
    for data in (0, 1, 7, 9999, 60000, 2**31 - 1):
        assert _key(jax.random.fold_in(jk, data)) == prng.fold_in(k, data)
    for n in (2, 4):
        assert [_key(s) for s in jax.random.split(jk, n)] == prng.split(k, n)
    # a chain, as dpcx's scan derives its keys
    kk = jax.random.fold_in(jax.random.fold_in(jk, 5), 7)
    assert _key(kk) == prng.fold_in(prng.fold_in(k, 5), 7)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_match_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    k = prng.fold_in(prng.prng_key(seed), 3)
    np.testing.assert_array_equal(
        prng.random_bits(k, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))
    u = prng.uniform(k, shape)
    assert u.dtype == torch.float32 and u.shape == shape
    np.testing.assert_array_equal(_bits(u.numpy()),
                                  _bits(jax.random.uniform(jk, shape)))
    for p in (0.1, 0.3, 0.9):
        np.testing.assert_array_equal(
            prng.bernoulli(k, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, np.float32(p), shape)))


@pytest.mark.parametrize("span", [1, 3, 5, 200, 2**20])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed, span):
    """Spans 1 (a single value), small odd, 200 models and 2^20 (the
    multiplier 2^32 mod span wraps to 0); an offset range and an empty one
    (jax returns the low end)."""
    jk = jax.random.PRNGKey(seed)
    k = prng.prng_key(seed)
    for shape in ((8,), (16, 1000)):
        np.testing.assert_array_equal(
            prng.randint(k, shape, 0, span).numpy(),
            np.asarray(jax.random.randint(jk, shape, 0, span)))
    np.testing.assert_array_equal(
        prng.randint(k, (64,), 5, 5 + span).numpy(),
        np.asarray(jax.random.randint(jk, (64,), 5, 5 + span)))
    np.testing.assert_array_equal(
        prng.randint(k, (8,), 4, 4).numpy(),
        np.asarray(jax.random.randint(jk, (8,), 4, 4)))


@pytest.mark.parametrize("step", [0, 7, 60000])
@pytest.mark.parametrize("batch,points,dropout", [
    (8, 16000, 0.1),  # car_64_depth
    (4, 1000, 0.5),
    (3, 64, 1.0),
])
def test_dropout_weights_match_dpcx(batch, points, dropout, step):
    """pc_point_dropout_weights at dpcx's keep-prob of ``step`` and its
    dropout key, the host-fed one fold_in(PRNGKey(seed + 1), step): the
    same float32 bits as dpcx's, 1 / keep where kept."""
    cfg = Config(pc_point_dropout=dropout)
    keep_j = jproject.keep_prob_schedule(cfg, jnp.asarray(step))
    keep_t = tproject.keep_prob_schedule(TConfig(pc_point_dropout=dropout),
                                         step)
    jk = jax.random.fold_in(jax.random.PRNGKey(1), step)
    want = np.asarray(jvox.pc_point_dropout_weights(jk, batch, points,
                                                    keep_j))
    got = tvox.pc_point_dropout_weights(
        prng.fold_in(prng.prng_key(1), step), batch, points, keep_t)
    assert got.dtype == torch.float32 and got.shape == (batch, points)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    kept = want > 0
    assert 0 < kept.mean() <= 1
    np.testing.assert_array_equal(np.unique(want[kept]),
                                  np.float32(1) / np.float32(keep_j))


def test_dropout_weights_refuse_other_devices():
    with pytest.raises(ValueError, match="no draw kernel"):
        tvox.pc_point_dropout_weights((0, 1), 2, 8, 0.5, device="meta")


@pytest.mark.parametrize("dropout,steps", [
    (0.1, 50_000), (0.3, 60), (0.5, 7), (1.0, 100)])
def test_keep_prob_schedule_bits_match_dpcx(dropout, steps):
    """keep_prob_schedule's float32 bits equal dpcx's at steps across the
    ramp, its end and past it."""
    cfg = Config(pc_point_dropout=dropout, pc_point_dropout_steps=steps)
    tcfg = TConfig(pc_point_dropout=dropout, pc_point_dropout_steps=steps)
    for step in (0, 1, 7, steps // 3, steps - 1, steps, 10 * steps + 3,
                 2**31 - 1):
        want = np.asarray(jproject.keep_prob_schedule(cfg, jnp.asarray(step)))
        got = tproject.keep_prob_schedule(tcfg, step)
        assert got.dtype == torch.float32
        assert _bits(got.numpy()) == _bits(want), (step, got, want)
