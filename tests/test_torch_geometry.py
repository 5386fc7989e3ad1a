"""dpcx_torch geometry and transform against dpcx, on the same numpy inputs.

Tolerance: fp32, atol 1e-6 — the same elementwise formulas in the same
precision; only matmul summation order may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.geometry import camera as jc
from dpcx.geometry import quaternion as jq
from dpcx.render import transform as jt
from dpcx_torch.geometry import camera as tc
from dpcx_torch.geometry import quaternion as tq
from dpcx_torch.render import transform as tt
from torch_workers import share_cores

share_cores()

ATOL = 1e-6


def _quats(rng, shape):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(fn_j, fn_t, *arrays):
    out_j = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    out_t = fn_t(*[torch.from_numpy(a) for a in arrays]).numpy()
    return out_j, out_t


@pytest.mark.parametrize(
    "name", ["quaternion_normalize", "quaternion_conjugate",
             "quaternion_to_matrix"],
)
def test_unary_quaternion_ops(name, rng):
    q = rng.normal(size=(5, 3, 4)).astype(np.float32)
    out_j, out_t = _both(getattr(jq, name), getattr(tq, name), q)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


@pytest.mark.parametrize(
    "name", ["quaternion_multiply", "quaternion_angular_distance"]
)
def test_binary_quaternion_ops(name, rng):
    q1, q2 = _quats(rng, (7,)), _quats(rng, (7,))
    out_j, out_t = _both(getattr(jq, name), getattr(tq, name), q1, q2)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_quaternion_rotate(rng):
    pts = rng.uniform(-0.5, 0.5, (4, 50, 3)).astype(np.float32)
    q = _quats(rng, (4,))
    out_j, out_t = _both(jq.quaternion_rotate, tq.quaternion_rotate, pts, q)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_quaternion_from_axis_angle(rng):
    axis = rng.normal(size=(6, 3)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, (6,)).astype(np.float32)
    out_j, out_t = _both(
        jq.quaternion_from_axis_angle, tq.quaternion_from_axis_angle,
        axis, angle,
    )
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_random_quaternion_properties():
    """The stream differs from jax.random; check unit norm, shape, the
    seeded generator's reproducibility and Shoemake's uniform spread."""
    g = torch.Generator().manual_seed(3)
    q = tq.random_quaternion(g, (4000,))
    assert q.shape == (4000, 4)
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    again = tq.random_quaternion(torch.Generator().manual_seed(3), (4000,))
    assert torch.equal(q, again)
    # uniform on SO(3): each component has mean 0 and E[c^2] = 1/4
    np.testing.assert_allclose(q.mean(0).numpy(), 0.0, atol=0.03)
    np.testing.assert_allclose((q**2).mean(0).numpy(), 0.25, atol=0.02)


@pytest.mark.parametrize("with_translation", [False, True])
@pytest.mark.parametrize("channel_major", [False, True])
def test_perspective_transform(with_translation, channel_major, rng):
    pts = rng.uniform(-0.5, 0.5, (3, 64, 3)).astype(np.float32)
    q = _quats(rng, (3,))
    tr = (
        rng.normal(scale=0.1, size=(3, 3)).astype(np.float32)
        if with_translation else None
    )
    name = "pc_perspective_transform_t" if channel_major else \
        "pc_perspective_transform"
    kw = dict(focal_length=1.875, camera_distance=2.0)
    out_j = np.asarray(getattr(jt, name)(
        jnp.asarray(pts), jnp.asarray(q),
        translation=None if tr is None else jnp.asarray(tr), **kw,
    ))
    out_t = getattr(tt, name)(
        torch.from_numpy(pts), torch.from_numpy(q),
        translation=None if tr is None else torch.from_numpy(tr), **kw,
    ).numpy()
    assert out_t.shape == ((3, 3, 64) if channel_major else (3, 64, 3))
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)


def test_camera_from_view_angles_matches_dpcx(rng):
    """The datagen cameras: quaternion and position from the same angles
    (azimuth over the full circle, elevation in dpcx's datagen range and
    at the branch edges of matrix_to_quaternion)."""
    azim = np.concatenate([rng.uniform(0, 2 * np.pi, 64),
                           [0.0, np.pi / 2, np.pi, 1.5 * np.pi]])
    elev = np.concatenate([rng.uniform(0.1, 0.6, 64),
                           [0.0, 0.3, -0.4, 1.2]])
    azim, elev = azim.astype(np.float32), elev.astype(np.float32)
    q_j, p_j = jc.camera_from_view_angles(jnp.asarray(azim),
                                          jnp.asarray(elev), 2.0)
    q_t, p_t = tc.camera_from_view_angles(torch.from_numpy(azim),
                                          torch.from_numpy(elev), 2.0)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=ATOL)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-5)
    # scalar angles, as render_cloud_image passes them
    q1, _ = tc.camera_from_view_angles(0.7, 0.4, 2.0)
    q1_j, _ = jc.camera_from_view_angles(jnp.asarray(0.7), jnp.asarray(0.4))
    np.testing.assert_allclose(q1.numpy(), np.asarray(q1_j), atol=1e-5)


def test_matrix_to_quaternion_and_intrinsics_match_dpcx(rng):
    m = np.asarray(jq.quaternion_to_matrix(jnp.asarray(_quats(rng, (50,)))))
    out_j, out_t = _both(jc.matrix_to_quaternion, tc.matrix_to_quaternion, m)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_allclose(tc.intrinsics_matrix(1.875, 64).numpy(),
                               np.asarray(jc.intrinsics_matrix(1.875, 64)))
