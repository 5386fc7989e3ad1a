"""Anisotropic Gaussian splat density and colour (port of
``dpcx/render/pallas_gsplat.py``: the K6 forward ``_aniso_fwd_kernel`` and
the K7 backward ``_aniso_bwd_kernel``).

Each point n (centre mu in grid units (z, y, x), precision A = Sigma^-1 as
six entries (A00, A01, A02, A11, A12, A22), weight w, optional colour) adds

    e_n(c) = exp(log(max(w_n, 1e-30)) - 1/2 (c - mu_n)^T A_n (c - mu_n))

to the density of every cell c = (z, y, x) with z in its z-range
[z_lo_n, z_hi_n), every y and every x, and e_n(c) rgb_n to the three colour
accumulators. The quadratic form is not clamped at 0 (dpcx's dense oracle
clamps, its Pallas kernel does not; this is the Pallas kernel's function).

The z-range is dpcx's, and it depends on the Pallas kernel's chunking: the
points are padded to a multiple of the chunk C (pads: mu_z 1e4, rz 0, w 0),
sorted by mu_z, and cut into chunks of C; a chunk covers the cells
[zb, zb + nt G) with zb = clip(floor(min(mu_z - rz)), 0, D - 1) and nt whole
trips of G slabs up to clip(floor(max(mu_z + rz)) + 1, 0, D - 1), clipped
at D (``_window_metadata`` and ``_tiling``). Every point of a chunk adds to
every cell of the chunk's band, not only within its own +-rz. ``z_ranges``
computes that band for each point and hands it back in the original point
order, so the kernels need neither the sort nor an un-sort.

``aniso_density`` runs, for CUDA tensors, a ``torch.autograd.Function``
whose forward and backward launch the hand-written CUDA kernels of
``csrc/aniso_splat.cu``; for CPU tensors the plain version,
``aniso_density_reference``, which autograd differentiates. Any other
device raises. Neither gets a gradient for rz or the integer z-ranges, as
dpcx's VJP gives rz a zero cotangent.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

MAX_ANISO_VOX = 64  # dpcx's gsplat_impl: pallas refuses D > 64
PAD_MU_Z = 1e4  # pads sort to the end and take no mass

# kernel launches by name; counted only where a launch happens
LAUNCHES: dict[str, int] = {"aniso_render": 0, "aniso_render_bwd": 0}


def tiling(num_points: int, vox: int) -> tuple[int, int]:
    """dpcx's (z_group G, chunk C): G*D ~ 256 rows per trip, C points per
    chunk (``pallas_gsplat._tiling`` without its bench-only overrides)."""
    g = max(1, min(vox, 256 // vox))
    while vox % g:
        g -= 1
    c = min(512, 128 * (-(-num_points // 128)))
    return g, c


@torch.no_grad()
def z_ranges(mu_z: torch.Tensor, rz: torch.Tensor,
             vox: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point z-range [z_lo, z_hi) of the cells the point adds to, by
    the chunk rule of dpcx's Pallas kernel; mu_z, rz [B, N] -> two int32
    [B, N] in the original point order (z_hi == z_lo: no cell)."""
    B, N = mu_z.shape
    D = vox
    G, C = tiling(N, D)
    pad = (-N) % C
    mu = mu_z.float()
    r = rz.float()
    if pad:
        mu = torch.cat([mu, mu.new_full((B, pad), PAD_MU_Z)], dim=1)
        r = torch.cat([r, r.new_zeros((B, pad))], dim=1)
    mu_s, order = torch.sort(mu, dim=1, stable=True)
    r_s = torch.gather(r, 1, order)
    n_chunks = mu_s.shape[1] // C
    lo = torch.floor((mu_s - r_s).reshape(B, n_chunks, C).amin(-1))
    hi = torch.floor((mu_s + r_s).reshape(B, n_chunks, C).amax(-1)) + 1.0
    zb = lo.clamp(0, D - 1)
    ze = hi.clamp(0, D - 1)
    nt = torch.ceil((ze - zb + 1.0) / G)
    nt = torch.where((hi < 0) | (lo > D - 1), torch.zeros_like(nt), nt)
    z_lo_c = zb.to(torch.int32)
    z_hi_c = (zb + nt * G).clamp(max=D).to(torch.int32)
    # chunk -> sorted point -> original point
    lo_s = z_lo_c.repeat_interleave(C, dim=1)
    hi_s = z_hi_c.repeat_interleave(C, dim=1)
    z_lo = torch.empty_like(lo_s).scatter_(1, order, lo_s)[:, :N]
    z_hi = torch.empty_like(hi_s).scatter_(1, order, hi_s)[:, :N]
    return z_lo.contiguous(), z_hi.contiguous()


def pack(mu: torch.Tensor, A6: torch.Tensor, w: torch.Tensor,
         rgb: torch.Tensor | None) -> torch.Tensor:
    """[B, 13, N] float32 rows (mu zyx, A6, w, rgb; rgb rows zero without
    colour), dpcx's ``_pack``."""
    B, N, _ = mu.shape
    rgb_rows = (mu.new_zeros((B, 3, N)) if rgb is None
                else rgb.transpose(1, 2))
    return torch.cat(
        [mu.transpose(1, 2), A6.transpose(1, 2), w[:, None, :], rgb_rows],
        dim=1,
    ).float().contiguous()


def _slab(z: int, pk: torch.Tensor, z_lo: torch.Tensor, z_hi: torch.Tensor,
          vox: int, with_rgb: bool) -> torch.Tensor:
    """One z-slab of the plain version: [B, CH, D, D]. The quadratic form
    is assembled in the order the kernels assemble it."""
    D = vox
    cells = torch.arange(D, dtype=pk.dtype, device=pk.device)
    muz, muy, mux, a00, a01, a02, a11, a12, a22, w = pk[:, :10].unbind(1)
    lw = torch.log(w.clamp_min(1e-30))                    # [B, N]
    dz = z - muz                                          # [B, N]
    dy = cells - muy[..., None]                           # [B, N, D(y)]
    dx = cells - mux[..., None]                           # [B, N, D(x)]
    ty = (0.5 * a11)[..., None] * dy * dy
    base = lw[..., None] - (((0.5 * a00) * dz * dz)[..., None]
                            + (a01 * dz)[..., None] * dy + ty)
    m = (a02 * dz)[..., None] + a12[..., None] * dy       # [B, N, D(y)]
    hx = ((0.5 * a22)[..., None] * dx) * dx               # [B, N, D(x)]
    e = torch.exp(base[..., :, None]
                  - (m[..., :, None] * dx[..., None, :] + hx[..., None, :]))
    inside = (z_lo <= z) & (z < z_hi)                     # [B, N]
    e = torch.where(inside[..., None, None], e, torch.zeros_like(e))
    dens = e.sum(1)[:, None]                              # [B, 1, D, D]
    if not with_rgb:
        return dens
    cols = torch.einsum("bnyx,bcn->bcyx", e, pk[:, 10:13])
    return torch.cat([dens, cols], dim=1)


def aniso_density_reference(
    mu: torch.Tensor,
    A6: torch.Tensor,
    w: torch.Tensor,
    rgb: torch.Tensor | None,
    rz: torch.Tensor,
    vox: int = 32,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels' function, the same z-ranges
    and the same formula: -> density [B, D, D, D], or (density, colour
    accumulators [B, 3, D, D, D]) with rgb. One z-slab at a time; under
    autograd each slab is checkpointed (recomputed in the backward), so
    only one slab's [B, N, D, D] intermediates are live: 32 renders x 4096
    points at D 32 are 512 MiB a slab."""
    from torch.utils.checkpoint import checkpoint

    z_lo, z_hi = z_ranges(mu[..., 0], rz, vox)
    pk = pack(mu, A6, w, rgb)
    args = (pk, z_lo, z_hi, vox, rgb is not None)
    if torch.is_grad_enabled() and pk.requires_grad:
        slabs = [checkpoint(_slab, z, *args, use_reentrant=False)
                 for z in range(vox)]
    else:
        slabs = [_slab(z, *args) for z in range(vox)]
    out = torch.stack(slabs, dim=2)
    return out[:, 0] if rgb is None else (out[:, 0], out[:, 1:4])


def _launch_forward(pk, z_lo, z_hi, vox, with_rgb) -> torch.Tensor:
    """K6: packed points [B, 13, N], z-ranges [B, N] -> [B, CH, D, D, D]
    (CH 4 with rgb, else 1)."""
    from dpcx_torch import _build

    B, _, N = pk.shape
    D = vox
    out = torch.empty((B, 4 if with_rgb else 1, D, D, D),
                      dtype=torch.float32, device=pk.device)
    lib = _build.load()
    with torch.cuda.device(pk.device):
        err = lib.dpcx_aniso_render(
            pk.data_ptr(), z_lo.data_ptr(), z_hi.data_ptr(), out.data_ptr(),
            B, N, D, int(with_rgb),
            torch.cuda.current_stream(pk.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"aniso_render kernel launch failed: cudaError {err}")
    LAUNCHES["aniso_render"] += 1
    return out


def _launch_backward(pk, z_lo, z_hi, ct, vox, with_rgb) -> torch.Tensor:
    """K7: the cotangent of the forward's output [B, CH, D, D, D] -> the
    gradient of the packed points [B, 13, N] (colour rows zero without
    rgb)."""
    from dpcx_torch import _build

    B, _, N = pk.shape
    dpk = torch.empty_like(pk)
    lib = _build.load()
    with torch.cuda.device(pk.device):
        err = lib.dpcx_aniso_render_bwd(
            pk.data_ptr(), z_lo.data_ptr(), z_hi.data_ptr(), ct.data_ptr(),
            dpk.data_ptr(), B, N, vox, int(with_rgb),
            torch.cuda.current_stream(pk.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"aniso_render_bwd kernel launch failed: cudaError {err}")
    LAUNCHES["aniso_render_bwd"] += 1
    return dpk


class _AnisoSplat(torch.autograd.Function):
    """K6 forward, K7 backward (a one-pass recompute: nothing but the
    packed points and the z-ranges is kept). No gradient reaches the
    z-ranges."""

    @staticmethod
    def forward(ctx, pk, z_lo, z_hi, vox, with_rgb):
        out = _launch_forward(pk, z_lo, z_hi, vox, with_rgb)
        ctx.save_for_backward(pk, z_lo, z_hi)
        ctx.vox, ctx.with_rgb = vox, with_rgb
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        pk, z_lo, z_hi = ctx.saved_tensors
        dpk = _launch_backward(pk, z_lo, z_hi, dout.contiguous(), ctx.vox,
                               ctx.with_rgb)
        return dpk, None, None, None, None


def aniso_density(
    mu: torch.Tensor,
    A6: torch.Tensor,
    w: torch.Tensor,
    rgb: torch.Tensor | None,
    rz: torch.Tensor,
    vox: int = 32,
    acc_dtype: str = "float32",
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Mirrors ``dpcx.render.pallas_gsplat.aniso_density_pallas``: mu
    [B, N, 3] grid coords (z, y, x), A6 [B, N, 6], w [B, N], rgb [B, N, 3]
    or None, rz [B, N] z-window radius in cells -> density [B, D, D, D],
    or (density, colour accumulators [B, 3, D, D, D]) with rgb.

    CUDA tensors go through the CUDA kernels, CPU tensors through the
    plain version."""
    if acc_dtype != "float32":
        raise NotImplementedError(
            f"acc_dtype={acc_dtype!r}: only the float32 mode of the "
            "anisotropic splat kernels is ported (the bfloat16 mode of "
            "K6/K7 is ROADMAP queue 2)"
        )
    if not 1 <= vox <= MAX_ANISO_VOX:
        raise ValueError(f"anisotropic splats cover 1 <= vox <= "
                         f"{MAX_ANISO_VOX}, got {vox}")
    if mu.device.type == "cpu":
        return aniso_density_reference(mu, A6, w, rgb, rz, vox)
    if mu.device.type != "cuda":
        raise ValueError(
            "anisotropic splats run on cuda (kernel) or cpu (plain "
            f"version), not {mu.device.type}"
        )
    for name, t in (("A6", A6), ("w", w), ("rgb", rgb), ("rz", rz)):
        if t is not None and t.device != mu.device:
            raise ValueError(f"{name} is on {t.device}, mu on {mu.device}")
    z_lo, z_hi = z_ranges(mu[..., 0], rz, vox)
    out = _AnisoSplat.apply(pack(mu, A6, w, rgb), z_lo, z_hi, vox,
                            rgb is not None)
    return out[:, 0] if rgb is None else (out[:, 0], out[:, 1:4])
