"""The chunk table the anisotropic splat kernels K6/K7 walk, and the sum
order of K7, on the CPU.

``render/aniso.py::chunk_table`` is checked against dpcx's own chunking
(``pallas_gsplat._sort_packed`` and ``_window_metadata`` on the same numpy
inputs, padded as dpcx pads): the order is a permutation with the pads
last, every 128 sorted points lie in one chunk, the bands are dpcx's
(zbase, zbase + ntrips G) clipped at D, and ``z_ranges`` built on the
table is the per-point scatter it replaces, bit for bit.

K7 (``csrc/aniso_splat.cu``) gives each point a thread that walks the rows
(z, y) of its chunk's band: per row it sums over x, and folds the row sums
into the point's moments. That order is written out here in torch and held
against ``aniso_backward_reference`` on rgb_splats-like inputs (scales
0.005-0.06 of the grid, random rotations, dropout weights at keep 0.1):

- float32: per row sum u, u dx, (u dx) dx and e ct_c, folded into the ten
  centred moments with the row's dz and dy; within 1e-5 relative L2 per
  gradient group (mu, A6, w, rgb), the f32 rounding of another order;
- bfloat16: per row sum rnd(u), rnd(u) dx, (rnd(u) dx) dx and rnd(e ct_c),
  folded into the ten raw moments over dpcx's basis (1, z, y, rnd(z z),
  rnd(z y), rnd(y y)), then centred in f32; within chip_smoke.py's
  BF16_SHARE of each group's largest and BF16_GRAD_L2 relative L2, with the
  raw moments in float64 (the kernel's: the fold's products are exact) and
  in float32 (about twice as far from the reference on A6, still inside),
  while the float32 mode on the same inputs misses BF16_GRAD_L2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcx.render import pallas_gsplat as jpg
from dpcx_torch.render import aniso
from dpcx_torch.render.fused import _rnd
from dpcx_torch.render.gsplat import splat_params

BF16_SHARE, BF16_GRAD_L2 = 2.0**-8, 1e-3  # chip_smoke.py's limits
F32_RTOL = 1e-5
GROUPS = (("mu", 0, 3), ("A6", 3, 9), ("w", 9, 10), ("rgb", 10, 13))


def _depths(n, vox, seed):
    rng = np.random.default_rng(seed)
    mu_z = rng.uniform(-3, vox + 2, (2, n)).astype(np.float32)
    rz = rng.uniform(0.5, 4.0, (2, n)).astype(np.float32)
    return mu_z, rz


def _dpcx_chunks(mu_z, rz, vox):
    """dpcx's own sort and window metadata on its own padding."""
    B, n = mu_z.shape
    G, C = jpg._tiling(n, vox)
    pk = np.zeros((B, 13, n), np.float32)
    pk[:, 0] = mu_z
    pk_p, rz_p = jpg._pad_points([jnp.asarray(pk), jnp.asarray(rz)], n, C)
    pk_s, rz_s, order = jpg._sort_packed(pk_p, rz_p, True)
    zb, nt = jpg._window_metadata(pk_s[:, 0], rz_s, vox, G, C)
    return (np.asarray(order), np.asarray(zb), np.asarray(nt), G, C)


def _old_z_ranges(mu_z, rz, vox):
    """The per-point scatter z_ranges computed before the chunk table."""
    B, N = mu_z.shape
    G, C = aniso.tiling(N, vox)
    pad = (-N) % C
    mu, r = mu_z.float(), rz.float()
    if pad:
        mu = torch.cat([mu, mu.new_full((B, pad), aniso.PAD_MU_Z)], dim=1)
        r = torch.cat([r, r.new_zeros((B, pad))], dim=1)
    mu_s, order = torch.sort(mu, dim=1, stable=True)
    r_s = torch.gather(r, 1, order)
    n_chunks = mu_s.shape[1] // C
    lo = torch.floor((mu_s - r_s).reshape(B, n_chunks, C).amin(-1))
    hi = torch.floor((mu_s + r_s).reshape(B, n_chunks, C).amax(-1)) + 1.0
    zb, ze = lo.clamp(0, vox - 1), hi.clamp(0, vox - 1)
    nt = torch.ceil((ze - zb + 1.0) / G)
    nt = torch.where((hi < 0) | (lo > vox - 1), torch.zeros_like(nt), nt)
    lo_s = zb.to(torch.int32).repeat_interleave(C, dim=1)
    hi_s = (zb + nt * G).clamp(max=vox).to(torch.int32).repeat_interleave(
        C, dim=1)
    z_lo = torch.empty_like(lo_s).scatter_(1, order, lo_s)[:, :N]
    z_hi = torch.empty_like(hi_s).scatter_(1, order, hi_s)[:, :N]
    return z_lo, z_hi


@pytest.mark.parametrize("n,vox", [(1000, 32), (1000, 16), (1000, 8),
                                   (256, 16), (256, 32), (4096, 32)])
def test_chunk_table_matches_dpcx(n, vox):
    mu_z, rz = _depths(n, vox, n + vox)
    order, band_lo, band_hi = aniso.chunk_table(
        torch.from_numpy(mu_z), torch.from_numpy(rz), vox)
    j_order, zb, nt, G, C = _dpcx_chunks(mu_z, rz, vox)
    assert order.dtype == band_lo.dtype == band_hi.dtype == torch.int32
    np_ = n + (-n) % C
    assert order.shape == (2, np_) and band_lo.shape == (2, np_ // C)
    o = order.numpy()
    # a permutation of the padded points, the pads (index >= n) last
    assert (np.sort(o, axis=1) == np.arange(np_)).all()
    assert (o[:, :n] < n).all() and (o[:, n:] >= n).all()
    # the same depth sort as dpcx's (its pads tie, so only the real ones)
    assert (o[:, :n] == j_order[:, :n]).all()
    # every tile of 128 sorted points lies in one chunk
    assert C % 128 == 0
    starts = np.arange(0, np_, 128)
    assert (starts // C == (starts + 127) // C).all()
    # the bands are dpcx's, rounded up to whole G-slab trips, clipped at D
    np.testing.assert_array_equal(band_lo.numpy(), zb)
    np.testing.assert_array_equal(band_hi.numpy(),
                                  np.minimum(zb + nt * G, vox))
    # z_ranges on the table is the scatter it replaces, bit for bit
    new = aniso.z_ranges(torch.from_numpy(mu_z), torch.from_numpy(rz), vox)
    old = _old_z_ranges(torch.from_numpy(mu_z), torch.from_numpy(rz), vox)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _splat_case(vox, n, with_rgb, seed):
    """rgb_splats-like packed points, chunk bands per point, cotangents."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pw = rng.uniform(size=(2, n)) * (rng.random((2, n)) < 0.1) / 0.1
    pts, scales, rot, pw, rgb = (
        torch.tensor(a, dtype=torch.float32) for a in (
            rng.uniform(-0.45, 0.45, (2, n, 3)),
            rng.uniform(0.005, 0.06, (2, n, 3)), q, pw,
            rng.uniform(size=(2, n, 3))))
    mu, A6, w, rz = splat_params(pts, scales, rot, vox, pw)
    pk = aniso.pack(mu, A6, w, rgb if with_rgb else None)
    z_lo, z_hi = aniso.z_ranges(mu[..., 0], rz, vox)
    ct = torch.tensor(rng.normal(size=(2, 4 if with_rgb else 1, vox, vox,
                                       vox)), dtype=torch.float32)
    return pk, z_lo, z_hi, ct


def _row_order_backward(pk, z_lo, z_hi, ct, vox, with_rgb, bf16,
                        acc=torch.float32):
    """K7's function in the kernel's order: per row (z, y) the sums over x,
    folded into the point's moments row by row (centred in f32; raw over
    dpcx's basis in bf16, accumulated in ``acc``, centred in f32)."""
    rnd = _rnd if bf16 else (lambda t: t)
    B, _, N = pk.shape
    muz, muy, mux, a00, a01, a02, a11, a12, a22, w = pk[:, :10].unbind(1)
    cells = torch.arange(vox, dtype=torch.float32)
    dx = cells - mux[..., None]                           # [B, N, D(x)]
    s = [torch.zeros(B, N, dtype=acc) for _ in range(10)]
    v = torch.zeros(B, 3, N)
    for z in range(vox):
        u, t = aniso._cell_terms(aniso._gauss(z, pk, z_lo, z_hi, vox),
                                 ct[:, :, z], pk, with_rgb)
        for c, tc in enumerate(t):
            v[:, c] += rnd(tc).sum((-2, -1))
        u = rnd(u)
        ud = u * dx[:, :, None]
        rows = (u.sum(-1), ud.sum(-1), (ud * dx[:, :, None]).sum(-1))
        dz = z - muz
        for y in range(vox):
            r0, r1, r2 = (r[..., y].to(acc) for r in rows)
            if bf16:  # F = (1, z, y, rnd(z z), rnd(z y), rnd(y y))
                f = [float(z), float(y)] + [
                    _rnd(torch.tensor(float(a * b))).item()
                    for a, b in ((z, z), (z, y), (y, y))]
                terms = (r0, f[0] * r0, f[1] * r0, f[2] * r0, f[3] * r0,
                         f[4] * r0, r1, f[0] * r1, f[1] * r1, r2)
            else:
                dy = y - muy
                terms = (r0, dz * r0, dy * r0, r1, (dz * dz) * r0,
                         (dz * dy) * r0, dz * r1, (dy * dy) * r0, dy * r1,
                         r2)
            for k, term in enumerate(terms):
                s[k] = s[k] + term
    s = [x.float() for x in s]
    if bf16:  # the raw moments, centred as the kernel's centre() does
        p000, pz00, py00, pzz0, pzy0, pyy0, p001, pz01, py01, p002 = s
        s = [p000, pz00 - muz * p000, py00 - muy * p000, p001,
             (pzz0 - (2.0 * muz) * pz00) + (muz * muz) * p000,
             ((pzy0 - muz * py00) - muy * pz00) + (muz * muy) * p000,
             pz01 - muz * p001,
             (pyy0 - (2.0 * muy) * py00) + (muy * muy) * p000,
             py01 - muy * p001, p002]
    s0, sz, sy, sx, szz, szy, szx, syy, syx, sxx = s
    return torch.stack([
        a00 * sz + a01 * sy + a02 * sx, a01 * sz + a11 * sy + a12 * sx,
        a02 * sz + a12 * sy + a22 * sx,
        -0.5 * szz, -szy, -szx, -0.5 * syy, -syx, -0.5 * sxx,
        torch.where(w > 1e-30, s0 / w.clamp_min(1e-30), 0.0),
        *v.unbind(1)], dim=1)


def _rel(a, b):
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


@pytest.mark.parametrize("vox,n,with_rgb", [(16, 1024, True),
                                            (32, 1000, True),
                                            (32, 512, False)])
def test_row_order_matches_reference(vox, n, with_rgb):
    pk, z_lo, z_hi, ct = _splat_case(vox, n, with_rgb, vox + n)
    groups = GROUPS if with_rgb else GROUPS[:3]
    f32 = _row_order_backward(pk, z_lo, z_hi, ct, vox, with_rgb, False)
    want = aniso.aniso_backward_reference(pk, z_lo, z_hi, ct, vox, with_rgb)
    for name, a, b in groups:
        assert _rel(f32[:, a:b], want[:, a:b]) <= F32_RTOL, name
    want = aniso.aniso_backward_reference(pk, z_lo, z_hi, ct, vox, with_rgb,
                                          "bfloat16")
    got = {acc: _row_order_backward(pk, z_lo, z_hi, ct, vox, with_rgb, True,
                                    acc)
           for acc in (torch.float32, torch.float64)}
    for name, a, b in groups:
        p = want[:, a:b]
        for acc, g in got.items():
            share = ((g[:, a:b] - p).abs().max() / p.abs().max()).item()
            rel = _rel(g[:, a:b], p)
            print(f"D {vox} {name} {acc}: share {share:.3e}, relative L2 "
                  f"{rel:.3e}; f32 mode {_rel(f32[:, a:b], p):.3e}")
            assert share <= BF16_SHARE and rel <= BF16_GRAD_L2, (name, acc)
        assert _rel(f32[:, a:b], p) > BF16_GRAD_L2, name
