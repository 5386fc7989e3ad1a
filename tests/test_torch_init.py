"""dpcx's parameter init in the port, against flax and jax.random (CPU).

dpcx inits with ``model.init(PRNGKey(seed), dummy)`` (``dpcx/train.py::
create_state``) and its gauge reseed with ``PRNGKey(seed + 7919 *
attempt)``. Every kernel is flax's ``lecun_normal``: jax's
``truncated_normal(key, -2, 2)`` times ``sqrt(1 / fan_in) / 0.8796``,
each parameter's key flax's ``_fold_in_static`` of its module path and
its scope's counter; biases are zero. The port draws the same
(``utils/prng.py``, ``nets/layers.py::flax_init_``).

What is bitwise and what is not (measured on the CPU with jax 0.9.0, flax
0.12.3 and torch 2.13.0+cpu):

- the keys (``fold_in_static``, ``param_key``), the bits, and the
  uniforms are bitwise; so are the erf bounds of ``truncated_normal``;
- ``erf_inv`` is XLA:CPU's float32 program (Giles' polynomial in FMAs,
  over XLA's log1p and Eigen's log) in torch ops; it differs from jax's on
  2 of 100,000 uniforms in (-1, 1), by at most 2 ulp (1.2e-7 absolute):
  XLA's log keeps a few other roundings. Held here to at most 1e-4 of
  the inputs, 2 ulp. Over 2^20 draws of ``truncated_normal`` 22 values
  differ, of ``normal`` 36 (up to 3 ulp, 4.8e-7, in its tails); held to
  1e-4 of the draws, 3 ulp;
- so a leaf of the init may differ from flax's on a few elements, by an
  ulp of the value. At seed 3 every leaf of these configs is bitwise
  flax's (and of the reseeds'); at seed 5, 3 of 30 leaves differ, on
  0.01-0.02% of their elements, by at most 2 ulp of the leaf's largest
  value: the bound held below, 2 * spacing(max |w|), on at most 0.1% of
  a leaf's elements.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.core import scope as flax_scope

from dpcx.config import Config
from dpcx.train import create_state as j_create_state
from dpcx_torch.config import Config as TConfig
from dpcx_torch.convert import params_from_flax
from dpcx_torch.nets.layers import (
    Conv3x3s2,
    Dense,
    flax_init_,
    weight_from_kernel,
)
from dpcx_torch.train import create_state
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

BASE = dict(image_size=16, encoder_filters=(8, 16), latent_dim=24,
            fc_hidden=32, pc_decoder_hidden=(32, 32), pc_num_points=40,
            compute_dtype="float32")
# every head: rgb + gauss splats; K pose candidates with the student and
# the translation; K 1 without offsets
HEADS = {
    "points": dict(),
    "rgb_gauss": dict(pc_rgb=True, pc_gauss=True, predict_scale=False),
    "pose_student_translation": dict(
        predict_pose=True, pose_predict_num_candidates=4, pose_student=True,
        predict_translation=True, pc_rgb=True),
    "pose_k1": dict(predict_pose=True, pose_predict_num_candidates=1,
                    pose_student=False, pose_candidate_offsets=False),
}
MAX_DIFF_SHARE = 1e-3  # of a leaf's elements that may differ by an ulp


def _key(jkey) -> tuple[int, int]:
    return tuple(int(w) for w in np.asarray(jkey))


def _flax_init(cfg: Config, seed: int) -> dict[str, torch.Tensor]:
    state = j_create_state(cfg, jax.random.PRNGKey(seed))
    return params_from_flax(jax.tree.map(np.asarray, state.params))


def _hold_to_flax(got: dict, want: dict) -> tuple[int, int]:
    """Every leaf within 2 ulp of its largest value and on at most
    MAX_DIFF_SHARE of its elements; returns (bitwise leaves, leaves)."""
    assert got.keys() == want.keys()
    equal = 0
    for name, w in want.items():
        g = got[name].detach().cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith(".bias"):
            assert not g.any(), name
        diff = (g - w).abs()
        bound = 2.0 * float(np.spacing(np.float32(w.abs().max())))
        assert float(diff.max()) <= bound, (name, float(diff.max()), bound)
        assert float((diff > 0).float().mean()) <= MAX_DIFF_SHARE, name
        equal += bool(torch.equal(g, w))
    return equal, len(want)


@pytest.mark.parametrize("head", HEADS)
def test_create_state_is_dpcx_init(head):
    cfg = Config(**BASE, **HEADS[head], seed=3)
    got = create_state(TConfig(**dataclasses.asdict(cfg)), "cpu")
    equal, leaves = _hold_to_flax(got.model.state_dict(),
                                  _flax_init(cfg, cfg.seed))
    print(f"{head}: {equal} of {leaves} leaves bitwise")
    # most leaves are the same bits
    assert equal >= leaves * 0.8


@pytest.mark.parametrize("attempt", [1, 2])
def test_reseed_init_is_dpcx_reinit(attempt):
    """The gauge reseed's re-init (``seed + 7919 * attempt``,
    ``dpcx/train.py:659``), as ``train`` calls ``create_state``."""
    cfg = Config(**BASE, **HEADS["pose_student_translation"], seed=3)
    seed = cfg.seed + 7919 * attempt
    got = create_state(TConfig(**dataclasses.asdict(cfg)), "cpu", seed=seed)
    _hold_to_flax(got.model.state_dict(), _flax_init(cfg, seed))


def test_generator_init_is_not_dpcx_init():
    """The port's init before this draw, ``nn.init.trunc_normal_`` from a
    ``torch.Generator`` seeded with ``cfg.seed``: same distribution, other
    numbers, O(std) apart from dpcx's."""
    cfg = Config(**BASE, seed=3)
    want = _flax_init(cfg, cfg.seed)["decoder.fc_points.weight"]
    std = float(prng.lecun_std(want.shape[1]))
    old = torch.nn.init.trunc_normal_(
        torch.empty(want.shape), 0.0, std, -2.0 * std, 2.0 * std,
        generator=torch.Generator().manual_seed(cfg.seed))
    assert float((old - want).abs().max()) > std


def test_fold_in_static_and_param_keys_match_flax():
    root = jax.random.PRNGKey(11)
    for path in [("encoder", "conv0", 1), ("decoder", "fc_points", 2),
                 ("pose_head", "fc_student", 1), ("a",), (300, "b"), ()]:
        assert (prng.fold_in_static(prng.prng_key(11), path)
                == _key(flax_scope._fold_in_static(root, path)))
    # the key flax's Dense draws its kernel from, read off flax itself
    seen = {}

    def kernel_init(key, shape, dtype=np.float32):
        seen["key"] = _key(key)
        return jax.numpy.zeros(shape, dtype)

    import flax.linen as nn

    class Outer(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(3, kernel_init=kernel_init, name="fc_x")(x)

    Outer().init(jax.random.PRNGKey(11), np.zeros((1, 2), np.float32))
    assert seen["key"] == prng.param_key(11, ("fc_x",), 1)


def test_erf_inv_matches_xla():
    x = np.random.default_rng(0).uniform(-1, 1, 100_000).astype(np.float32)
    want = np.asarray(jax.jit(jax.scipy.special.erfinv)(x))
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    differ = got != want
    print(f"erf_inv: {differ.sum()} of {x.size} differ")
    assert differ.mean() <= 1e-4
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 2


# the shapes of shipped configs' smaller kernels (conv0, fc_scale, a
# 1024 x 1024 Dense) and of dpcx's datagen draws
SHAPES = ((3, 3, 3, 32), (1024, 1), (1024, 1024), (2,), (3,), (8, 3))


@pytest.mark.parametrize("shape", SHAPES)
def test_truncated_normal_and_normal_match_jax(shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(5), len(shape))
    k = prng.fold_in(prng.prng_key(5), len(shape))
    for name, want, got in [
        ("truncated_normal",
         jax.random.truncated_normal(jk, -2, 2, shape),
         prng.truncated_normal(k, -2, 2, shape)),
        ("normal", jax.random.normal(jk, shape), prng.normal(k, shape)),
        ("uniform", jax.random.uniform(jk, shape, minval=0.15, maxval=0.95),
         prng.uniform(k, shape, minval=0.15, maxval=0.95)),
    ]:
        want = np.asarray(want)
        got = got.numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        differ = got != want
        print(f"{name} {shape}: {differ.sum()} of {want.size} differ")
        assert differ.mean() <= 1e-4, name
        assert np.abs(got.view(np.int32) - want.view(np.int32)).max() <= 3


def test_chunked_draw_is_the_whole_draw():
    """A leaf drawn whole and drawn in two chunks of its counter range
    are the same bits: the guarantee the card's chunked draw rests on."""
    key = prng.param_key(7, ("decoder", "fc_points"), 1)
    shape, fan_in = (64, 1000), 64
    whole = prng.lecun_normal(key, shape, fan_in, chunk=64_000)
    halves = prng.lecun_normal(key, shape, fan_in, chunk=32_001)
    assert torch.equal(whole, halves)
    # and a chunk is the draw of its counters alone
    part = prng.truncated_normal_bits(
        prng.random_bits_range(key, 32_001, 64_000), -2.0, 2.0)
    assert torch.equal(whole.reshape(-1)[32_001:],
                       part * prng.lecun_std(fan_in))


def test_flax_init_draws_a_module_tree_as_flax():
    """A Dense and a conv are zero until ``flax_init_`` draws them; then
    each kernel is flax's init of the same tree, through
    ``weight_from_kernel``, and each bias stays zero."""
    import flax.linen as fnn

    class Tree(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv0 = Conv3x3s2(3, 4, torch.float32)
            self.fc_x = Dense(36, 5, torch.float32)

    class FlaxTree(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(4, (3, 3), strides=2, padding="SAME",
                         name="conv0")(x)
            return fnn.Dense(5, name="fc_x")(x.reshape(x.shape[0], -1))

    tree = Tree()
    assert not any(p.any() for p in tree.parameters())
    flax_init_(tree, 9)
    want = FlaxTree().init(jax.random.PRNGKey(9),
                           np.zeros((1, 6, 6, 3), np.float32))["params"]
    for name in ("conv0", "fc_x"):
        mod = getattr(tree, name)
        kernel = np.asarray(want[name]["kernel"])
        assert mod.flax_shape == kernel.shape
        np.testing.assert_array_equal(mod.weight.detach().numpy(),
                                      weight_from_kernel(kernel))
        assert not mod.bias.any()
