"""The dense isotropic RBF voxelizer (``render/voxelize.py::
pointcloud2voxels_rbf``) against dpcx's, and the port's splat + blur and
isotropic gsplat against it, as dpcx's tests hold dpcx's (CPU).

Tolerances: dpcx's voxelizer, atol 2e-5 (the renderer's parity; the same
f32 weights, contracted in another order); splat + blur, dpcx's
tests/test_utils.py bounds (mass rtol 0.02, every cell within a tenth of
the peak: the trilinear hat is a second-order approximation); the
isotropic gsplat, dpcx's tests/test_gsplat.py bounds (rtol 2e-4, atol
1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.render.voxelize import pointcloud2voxels_rbf as j_rbf
from dpcx_torch.render.gauss import blur_matrix
from dpcx_torch.render.gsplat import anisotropic_density_grid
from dpcx_torch.render.voxelize import (
    pointcloud2voxels_rbf,
    pointcloud2voxels_scatter,
)
from dpcx_torch.utils import prng
from torch_workers import share_cores

share_cores()

D = 16
ATOL = 2e-5


def _pts(seed, b=2, n=64, lim=0.35):
    rng = np.random.default_rng(seed)
    return rng.uniform(-lim, lim, (b, n, 3)).astype(np.float32)


@pytest.mark.parametrize("sigma,n,chunk", [(1.2, 700, 256), (0.3, 300, 512),
                                           (0.0, 50, 512)])
def test_rbf_matches_dpcx(sigma, n, chunk):
    """Chunks of points that do and do not divide N; sigma 0 takes the
    1e-6 floor."""
    pts = _pts(n, n=n, lim=0.45)
    want = np.asarray(j_rbf(jnp.asarray(pts), D, jnp.asarray(sigma)))
    got = pointcloud2voxels_rbf(torch.from_numpy(pts), D, sigma, chunk=chunk)
    assert got.shape == (2, D, D, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_rbf_matches_splat_plus_blur():
    """tests/test_utils.py's oracle check on the port, on its points
    (``jax.random.uniform(PRNGKey(0), (1, 50, 3), -0.3, 0.3)``, drawn by
    ``utils/prng.py``): RBF voxelization against the trilinear splat
    blurred by the Gaussian band matrix, for interior points."""
    pts = prng.uniform(prng.prng_key(0), (1, 50, 3), minval=-0.3,
                       maxval=0.3)
    sigma = torch.tensor(1.2)
    rbf = pointcloud2voxels_rbf(pts, D, sigma)
    grid = pointcloud2voxels_scatter(pts, D)
    K = blur_matrix(sigma, D, radius=5)
    blurred = torch.einsum("bzyx,xi->bzyi", grid, K)
    blurred = torch.einsum("bzyx,yi->bzix", blurred, K)
    blurred = torch.einsum("bzyx,zi->biyx", blurred, K)
    np.testing.assert_allclose(float(rbf.sum()), float(blurred.sum()),
                               rtol=0.02)
    assert float((rbf - blurred).abs().max()) < 0.1 * float(blurred.max())


def test_isotropic_gsplat_matches_rbf():
    """tests/test_gsplat.py's check on the port: equal scales under any
    rotation give the isotropic RBF density (the per-axis normalisations
    multiply into the 3-D one)."""
    pts = torch.from_numpy(_pts(1))
    rot = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, 4)).astype(np.float32))
    rot = rot / torch.linalg.vector_norm(rot, dim=-1, keepdim=True)
    sigma_ndc = 0.06
    dens = anisotropic_density_grid(pts, torch.full((2, 64, 3), sigma_ndc),
                                    rot, D)
    want = pointcloud2voxels_rbf(pts, D, sigma_ndc * D)
    np.testing.assert_allclose(dens.numpy(), want.numpy(), rtol=2e-4,
                               atol=1e-6)
