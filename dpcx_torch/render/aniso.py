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
every cell of the chunk's band, not only within its own +-rz.
``chunk_table`` computes the sort order and the chunks' bands once; the
kernels take them (K6 walks only the chunks whose band covers its plane,
K7 gives each block 128 sorted points, which share one band), and
``z_ranges`` hands each point its band in the original point order for
the plain versions.

``acc_dtype`` "bfloat16" is the Pallas kernels' bfloat16 operand mode. The
forward rounds e to bfloat16 (nearest-even) and the colours once, and sums
in f32. The backward does not round e; it rounds u = e ct_d + (r e ct_r +
g e ct_g + b e ct_b) and e ct_c, and sums raw moments of them over dpcx's
rounded basis of absolute cell coordinates (1, z, y, rnd(z z), rnd(z y),
rnd(y y)), centred in f32 at the end (``aniso_backward_reference``). So
the gradient is not the derivative of the rounded forward; away from the
grid origin the rounded basis moves the precision gradients (and through
them the scale and rotation gradients) far from the f32 mode's, as it
does in dpcx.

``aniso_density`` runs, for CUDA tensors, a ``torch.autograd.Function``
whose forward and backward launch the hand-written CUDA kernels of
``csrc/aniso_splat.cu``, in either mode. For CPU tensors it runs the plain
version: in float32 ``aniso_density_reference``, which autograd
differentiates; in bfloat16 ``aniso_density_plain``, the plain forward with
K7's function written out as its backward. Any other device raises.
Neither gets a gradient for rz or the integer chunk table, as dpcx's VJP
gives rz a zero cotangent.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from dpcx_torch.render.fused import ACC_DTYPES, _keep, _rnd

MAX_ANISO_VOX = 64  # dpcx's gsplat_impl: pallas refuses D > 64
PAD_MU_Z = 1e4  # pads sort to the end and take no mass

# kernel launches by name; counted only where a launch happens; the
# bfloat16 mode adds _bf16
LAUNCHES: dict[str, int] = {
    "aniso_render": 0,
    "aniso_render_bwd": 0,
    "aniso_render_bf16": 0,
    "aniso_render_bwd_bf16": 0,
}


def tiling(num_points: int, vox: int) -> tuple[int, int]:
    """dpcx's (z_group G, chunk C): G*D ~ 256 rows per trip, C points per
    chunk (``pallas_gsplat._tiling`` without its bench-only overrides)."""
    g = max(1, min(vox, 256 // vox))
    while vox % g:
        g -= 1
    c = min(512, 128 * (-(-num_points // 128)))
    return g, c


@torch.no_grad()
def chunk_table(mu_z: torch.Tensor, rz: torch.Tensor,
                vox: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dpcx's chunking of the points (``_sort_packed`` and
    ``_window_metadata``): mu_z, rz [B, N] -> (order [B, Np] int32, the
    stable depth sort of the points padded to Np, a multiple of the chunk
    C: sorted position -> original index, pads >= N; band_lo, band_hi
    [B, Np // C] int32, each chunk's z-band [lo, hi), hi == lo for none).
    C is a multiple of 128, so every 128 sorted points share one band."""
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
    band_lo = zb.to(torch.int32)
    band_hi = (zb + nt * G).clamp(max=D).to(torch.int32)
    return (order.to(torch.int32).contiguous(), band_lo.contiguous(),
            band_hi.contiguous())


@torch.no_grad()
def z_ranges(mu_z: torch.Tensor, rz: torch.Tensor,
             vox: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point z-range [z_lo, z_hi) of the cells the point adds to, by
    the chunk rule of dpcx's Pallas kernel (``chunk_table``'s band of the
    point's chunk); mu_z, rz [B, N] -> two int32 [B, N] in the original
    point order (z_hi == z_lo: no cell)."""
    N = mu_z.shape[1]
    order, band_lo, band_hi = chunk_table(mu_z, rz, vox)
    C = order.shape[1] // band_lo.shape[1]
    order = order.long()
    # chunk -> sorted point -> original point
    lo_s = band_lo.repeat_interleave(C, dim=1)
    hi_s = band_hi.repeat_interleave(C, dim=1)
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


def _gauss(z: int, pk: torch.Tensor, z_lo: torch.Tensor, z_hi: torch.Tensor,
           vox: int) -> torch.Tensor:
    """e of every point at every cell of z-plane z, [B, N, D(y), D(x)] f32,
    zero where the point's z-range excludes z. The quadratic form is
    assembled in the order the kernels assemble it, one rounding per
    operation."""
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
    return torch.where(inside[..., None, None], e, torch.zeros_like(e))


def _slab(z: int, pk: torch.Tensor, z_lo: torch.Tensor, z_hi: torch.Tensor,
          vox: int, with_rgb: bool, acc_dtype: str) -> torch.Tensor:
    """One z-slab of the plain forward: [B, CH, D, D]. In bfloat16 e and
    the colours are rounded (K6's operands), the sums stay f32."""
    rnd = _rnd if acc_dtype == "bfloat16" else _keep
    e = rnd(_gauss(z, pk, z_lo, z_hi, vox))
    dens = e.sum(1)[:, None]                              # [B, 1, D, D]
    if not with_rgb:
        return dens
    cols = torch.einsum("bnyx,bcn->bcyx", e, rnd(pk[:, 10:13]))
    return torch.cat([dens, cols], dim=1)


def _render_plain(pk, z_lo, z_hi, vox, with_rgb, acc_dtype) -> torch.Tensor:
    """The plain forward of packed points: [B, CH, D, D, D]. Under autograd
    each slab is checkpointed (recomputed in the backward), so only one
    slab's [B, N, D, D] intermediates are live: 32 renders x 4096 points at
    D 32 are 512 MiB a slab."""
    from torch.utils.checkpoint import checkpoint

    args = (pk, z_lo, z_hi, vox, with_rgb, acc_dtype)
    if torch.is_grad_enabled() and pk.requires_grad:
        slabs = [checkpoint(_slab, z, *args, use_reentrant=False)
                 for z in range(vox)]
    else:
        slabs = [_slab(z, *args) for z in range(vox)]
    return torch.stack(slabs, dim=2)


def aniso_density_reference(
    mu: torch.Tensor,
    A6: torch.Tensor,
    w: torch.Tensor,
    rgb: torch.Tensor | None,
    rz: torch.Tensor,
    vox: int = 32,
    acc_dtype: str = "float32",
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels' forward, the same z-ranges and
    the same formula: -> density [B, D, D, D], or (density, colour
    accumulators [B, 3, D, D, D]) with rgb; one z-slab at a time
    (``_render_plain``). Autograd through it is K7's function in float32
    only, so in bfloat16 it refuses inputs that require grad: there take
    ``aniso_density_plain``."""
    pk = pack(mu, A6, w, rgb)
    if (acc_dtype == "bfloat16" and torch.is_grad_enabled()
            and pk.requires_grad):
        raise ValueError(
            "autograd through the bfloat16 plain forward is not K7's "
            "function (the backward rounds u and the basis, not e): use "
            "aniso_density_plain")
    z_lo, z_hi = z_ranges(mu[..., 0], rz, vox)
    out = _render_plain(pk, z_lo, z_hi, vox, rgb is not None, acc_dtype)
    return out[:, 0] if rgb is None else (out[:, 0], out[:, 1:4])


def _cell_terms(e, ct_z, pk, with_rgb):
    """u = e ct_d + (r t1 + g t2 + b t3) and t_c = e ct_c at every cell of a
    slab, in dpcx's order (``_aniso_bwd_kernel`` :297-302): e [B, N, D, D],
    ct_z [B, CH, D, D] -> (u, [t1, t2, t3] or [])."""
    u = e * ct_z[:, None, 0]
    if not with_rgb:
        return u, []
    t = [e * ct_z[:, None, c] for c in (1, 2, 3)]
    r, g, b = (pk[:, c, :, None, None] for c in (10, 11, 12))
    return u + (r * t[0] + g * t[1] + b * t[2]), t


def aniso_backward_reference(
    pk: torch.Tensor,
    z_lo: torch.Tensor,
    z_hi: torch.Tensor,
    ct: torch.Tensor,
    vox: int,
    with_rgb: bool,
    acc_dtype: str = "float32",
) -> torch.Tensor:
    """K7's function written out with plain tensor ops: the cotangent ct
    [B, CH, D, D, D] of the forward's output -> the gradient of the packed
    points [B, 13, N] (colour rows zero without rgb). One z-slab at a time,
    so the rgb_splats render (32 x 4096, D 32) fits on the card.

    Per point, over the cells of its z-range, e is recomputed (f32, not
    rounded in either mode), u and t_c as ``_cell_terms``. Each slab adds,
    per x column, six row sums sum_y F_k u:

    - float32 (the kernels' f32 mode): F = (1, dz, dy, dz^2, dz dy, dy^2),
      centred on mu, so the sums S are the gradients' moments at once;
    - bfloat16 (dpcx's ``_aniso_bwd_kernel`` with ``acc_dtype`` bfloat16,
      pallas_gsplat.py:245-339): u and t_c rounded (``red``, :289-294) and
      F = (1, z, y, rnd(z z), rnd(z y), rnd(y y)) over absolute cell
      coordinates (:247-255). The raw moments P000 .. Pyy0 are the sums
      over x, P001, Pz01, Py01 those of the row sums times dx = x - mu_x,
      P002 of (P dx) dx (:303-311); they are centred in f32 as at
      :327-339.

    The 13 gradients are assembled as at :344-362: d mu = A (S_dz, S_dy,
    S_dx), d A00 = -S_dzdz / 2, d A01 = -S_dzdy, ..., d w = S_0 / w where
    w > 1e-30 (else 0), d rgb_c = sum t_c."""
    bf16 = acc_dtype == "bfloat16"
    rnd = _rnd if bf16 else _keep
    D = vox
    B, _, N = pk.shape
    muz, muy, mux, a00, a01, a02, a11, a12, a22, w = pk[:, :10].unbind(1)
    cells = torch.arange(D, dtype=pk.dtype, device=pk.device)
    dy = cells - muy[..., None]                           # [B, N, D(y)]
    dx = cells - mux[..., None]                           # [B, N, D(x)]
    rows = torch.zeros(B, N, 6, D, dtype=pk.dtype, device=pk.device)
    v = torch.zeros(B, 3, N, dtype=pk.dtype, device=pk.device)
    for z in range(D):
        u, t = _cell_terms(_gauss(z, pk, z_lo, z_hi, vox), ct[:, :, z], pk,
                           with_rgb)
        for c, tc in enumerate(t):
            v[:, c] += rnd(tc).sum((-2, -1))
        if bf16:
            zy = z * cells
            F = torch.stack([torch.ones_like(cells), torch.full_like(cells, z),
                             cells, rnd(torch.full_like(cells, z * z)),
                             rnd(zy), rnd(cells * cells)])  # [6, D(y)]
            rows += torch.einsum("bnyx,ky->bnkx", rnd(u), F)
        else:
            dz = (z - muz)[..., None].expand_as(dy)
            F = torch.stack([torch.ones_like(dy), dz, dy, dz * dz, dz * dy,
                             dy * dy], dim=2)             # [B, N, 6, D(y)]
            rows += torch.einsum("bnyx,bnky->bnkx", u, F)
    S = rows.sum(-1)                                      # [B, N, 6]
    Sx = (rows[:, :, :3] * dx[:, :, None]).sum(-1)        # [B, N, 3]
    Sxx = ((rows[:, :, 0] * dx) * dx).sum(-1)             # [B, N]
    s0, sz, sy, szz, szy, syy = S.unbind(-1)
    sx, szx, syx = Sx.unbind(-1)
    if bf16:  # centre the raw moments (P000 = s0, Pz00 = sz, ...)
        sz, sy, szz, szy, syy, szx, syx = (
            sz - muz * s0,
            sy - muy * s0,
            szz - 2.0 * muz * sz + muz * muz * s0,
            szy - muz * sy - muy * sz + muz * muy * s0,
            syy - 2.0 * muy * sy + muy * muy * s0,
            szx - muz * sx,
            syx - muy * sx,
        )
    return torch.stack([
        a00 * sz + a01 * sy + a02 * sx,                   # d mu_z
        a01 * sz + a11 * sy + a12 * sx,                   # d mu_y
        a02 * sz + a12 * sy + a22 * sx,                   # d mu_x
        -0.5 * szz, -szy, -szx, -0.5 * syy, -syx, -0.5 * Sxx,  # d A6
        torch.where(w > 1e-30, s0 / w.clamp_min(1e-30), 0.0),  # d w
        *v.unbind(1),                                     # d rgb
    ], dim=1)


class _PlainAniso(torch.autograd.Function):
    """The plain forward, and K7's function written out as its backward (no
    gradient reaches the z-ranges)."""

    @staticmethod
    def forward(ctx, pk, z_lo, z_hi, vox, with_rgb, acc_dtype):
        ctx.save_for_backward(pk, z_lo, z_hi)
        ctx.vox, ctx.with_rgb, ctx.acc_dtype = vox, with_rgb, acc_dtype
        return _render_plain(pk, z_lo, z_hi, vox, with_rgb, acc_dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        pk, z_lo, z_hi = ctx.saved_tensors
        dpk = aniso_backward_reference(pk, z_lo, z_hi, dout.contiguous(),
                                       ctx.vox, ctx.with_rgb, ctx.acc_dtype)
        return dpk, None, None, None, None, None


def aniso_density_plain(
    mu: torch.Tensor,
    A6: torch.Tensor,
    w: torch.Tensor,
    rgb: torch.Tensor | None,
    rz: torch.Tensor,
    vox: int = 32,
    acc_dtype: str = "float32",
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """``aniso_density_reference``'s forward with ``aniso_backward_reference``
    as its backward, on any device: what CPU tensors take in bfloat16 mode,
    and what a kernel-vs-plain check on the card compares the kernels with
    in that mode."""
    z_lo, z_hi = z_ranges(mu[..., 0], rz, vox)
    out = _PlainAniso.apply(pack(mu, A6, w, rgb), z_lo, z_hi, vox,
                            rgb is not None, acc_dtype)
    return out[:, 0] if rgb is None else (out[:, 0], out[:, 1:4])


def _launch_forward(pk, table, vox, with_rgb, bf16=False) -> torch.Tensor:
    """K6: packed points [B, 13, N], ``chunk_table``'s (order, band_lo,
    band_hi) -> [B, CH, D, D, D] (CH 4 with rgb, else 1). ``bf16``: the
    bfloat16 operand mode."""
    from dpcx_torch import _build

    B, _, N = pk.shape
    D = vox
    order, band_lo, band_hi = table
    out = torch.empty((B, 4 if with_rgb else 1, D, D, D),
                      dtype=torch.float32, device=pk.device)
    lib = _build.load()
    with torch.cuda.device(pk.device):
        err = lib.dpcx_aniso_render(
            pk.data_ptr(), order.data_ptr(), band_lo.data_ptr(),
            band_hi.data_ptr(), out.data_ptr(), B, N, order.shape[1],
            band_lo.shape[1], D, int(with_rgb), int(bf16),
            torch.cuda.current_stream(pk.device).cuda_stream,
        )
    name = "aniso_render" + ("_bf16" if bf16 else "")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return out


def _launch_backward(pk, table, ct, vox, with_rgb,
                     bf16=False) -> torch.Tensor:
    """K7: the cotangent of the forward's output [B, CH, D, D, D] -> the
    gradient of the packed points [B, 13, N] (colour rows zero without
    rgb); ``table`` as ``_launch_forward``'s. ``bf16``: the bfloat16
    operand mode (raw moments)."""
    from dpcx_torch import _build

    B, _, N = pk.shape
    order, band_lo, band_hi = table
    ct = ct.contiguous()
    if ct.data_ptr() % 16:  # the kernel stages it in 16-byte copies
        ct = ct.clone()
    dpk = torch.empty_like(pk)
    lib = _build.load()
    with torch.cuda.device(pk.device):
        err = lib.dpcx_aniso_render_bwd(
            pk.data_ptr(), order.data_ptr(), band_lo.data_ptr(),
            band_hi.data_ptr(), ct.data_ptr(), dpk.data_ptr(), B, N,
            order.shape[1], band_lo.shape[1], vox, int(with_rgb), int(bf16),
            torch.cuda.current_stream(pk.device).cuda_stream,
        )
    name = "aniso_render_bwd" + ("_bf16" if bf16 else "")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return dpk


class _AnisoSplat(torch.autograd.Function):
    """K6 forward, K7 backward (a one-pass recompute: nothing but the
    packed points and the chunk table is kept, so the sort runs once a
    step), in either operand mode. No gradient reaches the table."""

    @staticmethod
    def forward(ctx, pk, order, band_lo, band_hi, vox, with_rgb, bf16):
        table = (order, band_lo, band_hi)
        out = _launch_forward(pk, table, vox, with_rgb, bf16)
        ctx.save_for_backward(pk, *table)
        ctx.vox, ctx.with_rgb, ctx.bf16 = vox, with_rgb, bf16
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        pk, *table = ctx.saved_tensors
        dpk = _launch_backward(pk, table, dout, ctx.vox, ctx.with_rgb,
                               ctx.bf16)
        return dpk, None, None, None, None, None, None


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
    plain version, in either operand mode."""
    if acc_dtype not in ACC_DTYPES:
        raise ValueError(f"acc_dtype must be one of {ACC_DTYPES}, "
                         f"got {acc_dtype!r}")
    if not 1 <= vox <= MAX_ANISO_VOX:
        raise ValueError(f"anisotropic splats cover 1 <= vox <= "
                         f"{MAX_ANISO_VOX}, got {vox}")
    bf16 = acc_dtype == "bfloat16"
    if mu.device.type == "cpu":
        if bf16:
            return aniso_density_plain(mu, A6, w, rgb, rz, vox, acc_dtype)
        return aniso_density_reference(mu, A6, w, rgb, rz, vox)
    if mu.device.type != "cuda":
        raise ValueError(
            "anisotropic splats run on cuda (kernel) or cpu (plain "
            f"version), not {mu.device.type}"
        )
    for name, t in (("A6", A6), ("w", w), ("rgb", rgb), ("rz", rz)):
        if t is not None and t.device != mu.device:
            raise ValueError(f"{name} is on {t.device}, mu on {mu.device}")
    out = _AnisoSplat.apply(pack(mu, A6, w, rgb),
                            *chunk_table(mu[..., 0], rz, vox), vox,
                            rgb is not None, bf16)
    return out[:, 0] if rgb is None else (out[:, 0], out[:, 1:4])
