// Anisotropic Gaussian splats for NVIDIA Hopper (sm_90a): density and
// colour accumulators on a D^3 grid (D <= 64), forward and backward, in
// both operand modes.
//
// Forward. Replaces dpcx/render/pallas_gsplat.py::_aniso_fwd_kernel (K6,
// launched by _fwd_call). Point n, packed as rows of pk [R, 13, N]
// (mu_z, mu_y, mu_x in grid units, A00 A01 A02 A11 A12 A22 of its precision
// matrix in (z, y, x) axes, weight w, colour r g b), adds
//   e = exp(log(max(w, 1e-30)) - q),
//   q = 1/2 A00 dz^2 + A01 dz dy + 1/2 A11 dy^2 + (A02 dz + A12 dy) dx
//       + 1/2 A22 dx^2,  d = cell - mu,
// to the density of every cell whose z lies in the point's range
// [z_lo, z_hi) (all y, all x), and e * rgb to the three colour channels.
// q is assembled inside the exp as the TPU kernel assembles it, and is not
// clamped at 0 (the TPU kernel does not clamp either).
//
// The TPU kernel sorts the points by depth, walks chunks of 512 points
// through slabs of G z-planes, places each x column with a one-hot matmul
// and sums the points on the MXU, because the TPU has VMEM and a matrix
// unit and no scatter. What that structure computes is kept: the z-range
// of each point is its chunk's band, rounded up to whole G-slab trips,
// computed beforehand in PyTorch (render/aniso.py::z_ranges), in the
// original point order. None of the structure itself is needed here:
//   (a) forward: one block of 256 threads per (render, z-plane); each
//       thread owns ceil(D^2 / 256) cells of the plane and keeps their
//       channels in registers. Tiles of 256 points are staged in shared
//       memory with their z-dependent terms; a point whose range excludes
//       the plane is skipped (the test is the same for the whole block, so
//       no warp diverges on it). Each cell is written once: no atomics, and
//       the sum order is fixed, so the result is the same from run to run.
//       Bound by operations: about 20 f32 operations and one expf per
//       point and cell in range.
//   (b) backward (K7, _aniso_bwd_kernel): one warp per point, a one-pass
//       recompute. The lanes walk x, the warp walks the point's z-range
//       and every y; each lane forms e and u = e (ct_d + r ct_r + g ct_g +
//       b ct_b) and sums u, u d_a, u d_a d_b (centred on mu, so no raw
//       moments cancel) and e ct_c; the warp reduces them and lane 0
//       writes the 13 gradients:
//         d mu = A (sum u dz, sum u dy, sum u dx),
//         d A00 = -1/2 sum u dz^2, d A01 = -sum u dz dy, ...,
//         d w = sum u / w where w > 1e-30 (else 0), d rgb_c = sum e ct_c.
//       No atomics. Bound by operations like (a); the cotangent reads (4
//       floats per cell and point, from L1 or L2) are not the limit:
//       taking the points in depth order, so that the warps of a block
//       share their rows, gained 4%.
//
// Operand mode (bf16 = 1: dpcx's pallas_acc_dtype "bfloat16"). The Pallas
// kernels cast their matmul operands to bfloat16 and accumulate in f32; the
// exponent stays f32. Here every value they type bfloat16 is rounded to
// nearest-even (rnd: __float2bfloat16_rn) where they round it, and every
// sum stays f32:
//   (a) e = rnd(exp(...)) (_aniso_fwd_kernel :160) and the colours rnd(r),
//       rnd(g), rnd(b) (:140-144); the density sums e, colour c sums
//       e rnd(c), a product of two rounded values, exact in f32.
//   (b) e is not rounded (only the forward rounds it); t_c = e ct_c and
//       u = e ct_d + (r t1 + g t2 + b t3) are f32, and what is summed is
//       rnd(u) and rnd(t_c) (red, :289-311) over dpcx's reduction basis of
//       absolute cell coordinates F = (1, z, y, rnd(z z), rnd(z y),
//       rnd(y y)) (:247-255). Its products are exact integers before the
//       rounding, which loses bits once one exceeds 256 (up to 2 at D 32,
//       8 at D 64). So this mode sums raw moments, not centred ones: a lane
//       keeps, for each of its x columns x = lane + 32 j, the six sums
//       A_k = sum F_k rnd(u) over the point's z-range and every y, and
//       sum rnd(t_c); per column it folds P_k += A_k and the x moments with
//       dx = x - mu_x, A_k dx and (A_0 dx) dx, as dpcx multiplies by dx
//       after its row reduction. After the warp's reduction lane 0 centres
//       them in f32 as dpcx does (:327-339). The centring cancels digits
//       where a coordinate is far from 0; the rounded basis moves the scale
//       and rotation gradients of this mode far more than that (the
//       reference's function, matched).
//   The exponent, t_c and u are formed without contracted multiply-adds
//   (__fmul_rn, __fadd_rn), in the plain version's order: an f32 ulp more
//   or less there flips a bf16 rounding.
//   Bound: as the f32 mode (CUDA cores; the bf16 products are later work
//   for the tensor cores).
//
// The launchers run on the caller's stream, allocate nothing, and return
// the first CUDA error (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 13;
constexpr int kThreads = 256;
constexpr int kTile = kThreads;  // points staged per pass of (a)
constexpr int kMaxVox = 64;
constexpr int kSlots = kMaxVox / 32;  // x columns per lane in (b)'s bf16 mode

// round to the nearest bfloat16 (ties to even), back to f32
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the exponent's row terms and e itself with every f32 rounding the plain
// version makes (no contracted multiply-add): base_q = lw - ((qz + bz dy)
// + (h_y dy) dy), m = mz + a12 dy; e = exp(base_q - (m dx + (h_x dx) dx))
__device__ __forceinline__ void exact_row(float lw, float qz, float bz,
                                          float hy, float mz, float a12,
                                          float dy, float* base_q, float* m) {
  *base_q = __fsub_rn(lw, __fadd_rn(__fadd_rn(qz, __fmul_rn(bz, dy)),
                                    __fmul_rn(__fmul_rn(hy, dy), dy)));
  *m = __fadd_rn(mz, __fmul_rn(a12, dy));
}

__device__ __forceinline__ float exact_exp(float base_q, float m, float hx,
                                           float dx) {
  return expf(__fsub_rn(
      base_q, __fadd_rn(__fmul_rn(m, dx), __fmul_rn(__fmul_rn(hx, dx), dx))));
}

// per-point terms of (a) for the block's z-plane, in shared memory
struct StagedPoint {
  float qz, bz, mz;  // 1/2 A00 dz^2, A01 dz, A02 dz
  float muy, mux;
  float hy, a12, hx;  // 1/2 A11, A12, 1/2 A22
  float lw;           // log(max(w, 1e-30))
  float r, g, b;      // rounded in the bf16 mode
  int inside;         // the plane lies in the point's z-range
};

// (a) out [R, CH, D, D, D]; one block per (render, z). CPT: cells per
// thread, ceil(D^2 / kThreads) rounded up to a template value.
template <int CPT, bool RGB, bool BF16>
__global__ void __launch_bounds__(kThreads)
aniso_fwd_kernel(const float* __restrict__ pk, const int* __restrict__ z_lo,
                 const int* __restrict__ z_hi, float* __restrict__ out,
                 int n, int d) {
  constexpr int CH = RGB ? 4 : 1;
  __shared__ StagedPoint sp[kTile];
  const int r = blockIdx.x / d;
  const int z = blockIdx.x - r * d;
  const float zf = static_cast<float>(z);
  const int cells = d * d;
  const float* p = pk + static_cast<int64_t>(r) * kRows * n;
  const int* lo = z_lo + static_cast<int64_t>(r) * n;
  const int* hi = z_hi + static_cast<int64_t>(r) * n;

  float yf[CPT], xf[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * kThreads;
    yf[k] = static_cast<float>(c / d);
    xf[k] = static_cast<float>(c - (c / d) * d);
  }
  float acc[CPT][CH];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) acc[k][ch] = 0.f;
  }

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < cnt) {
      const int i = base + threadIdx.x;
      StagedPoint s;
      s.inside = lo[i] <= z && z < hi[i];
      const float dz = zf - p[i];
      const float a00 = p[3 * n + i], a01 = p[4 * n + i],
                  a02 = p[5 * n + i];
      s.qz = (0.5f * a00) * dz * dz;
      s.bz = a01 * dz;
      s.mz = a02 * dz;
      s.muy = p[n + i];
      s.mux = p[2 * n + i];
      s.hy = 0.5f * p[6 * n + i];
      s.a12 = p[7 * n + i];
      s.hx = 0.5f * p[8 * n + i];
      s.lw = logf(fmaxf(p[9 * n + i], 1e-30f));
      s.r = RGB ? p[10 * n + i] : 0.f;
      s.g = RGB ? p[11 * n + i] : 0.f;
      s.b = RGB ? p[12 * n + i] : 0.f;
      if (BF16) {
        s.r = rnd(s.r);
        s.g = rnd(s.g);
        s.b = rnd(s.b);
      }
      sp[threadIdx.x] = s;
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      if (!sp[j].inside) continue;  // block-uniform
      const StagedPoint s = sp[j];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const float dy = yf[k] - s.muy;
        const float dx = xf[k] - s.mux;
        float e;
        if (BF16) {
          float base_q, m;
          exact_row(s.lw, s.qz, s.bz, s.hy, s.mz, s.a12, dy, &base_q, &m);
          e = rnd(exact_exp(base_q, m, s.hx, dx));
        } else {
          const float base_q = s.lw - (s.qz + s.bz * dy + s.hy * dy * dy);
          const float m = s.mz + s.a12 * dy;
          e = expf(base_q - (m * dx + (s.hx * dx) * dx));
        }
        acc[k][0] += e;
        if (RGB) {
          acc[k][1] += e * s.r;
          acc[k][2] += e * s.g;
          acc[k][3] += e * s.b;
        }
      }
    }
  }

  const int64_t plane = static_cast<int64_t>(d) * d;
  const int64_t vol = plane * d;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * kThreads;
    if (c >= cells) continue;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      out[(static_cast<int64_t>(r) * CH + ch) * vol + z * plane + c] =
          acc[k][ch];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// the terms of one point that (b) reads in its loops
struct PointTerms {
  float muz, muy, mux, lw, h00, a01, a02, hy, a12, hx, cr, cg, cb;
};

// (b)'s f32 mode for one lane: s[0..9] = sum u, u dz, u dy, u dx, u dz dz,
// u dz dy, u dz dx, u dy dy, u dy dx, u dx dx over its cells (centred on
// mu); s[10..12] += sum e ct_c
template <bool RGB>
__device__ __forceinline__ void centred_moments(
    const float* __restrict__ ct_d, int64_t vol, int64_t plane, int d,
    int z0, int z1, int lane, const PointTerms& t, float* s) {
  for (int z = z0; z < z1; ++z) {
    const float dz = static_cast<float>(z) - t.muz;
    const float qz = t.h00 * dz * dz, bz = t.a01 * dz, mz = t.a02 * dz;
    for (int y = 0; y < d; ++y) {
      const float dy = static_cast<float>(y) - t.muy;
      const float base_q = t.lw - (qz + bz * dy + t.hy * dy * dy);
      const float m = mz + t.a12 * dy;
      const int64_t row = z * plane + static_cast<int64_t>(y) * d;
      for (int x = lane; x < d; x += 32) {
        const float dx = static_cast<float>(x) - t.mux;
        const float e = expf(base_q - (m * dx + (t.hx * dx) * dx));
        float u = e * ct_d[row + x];
        if (RGB) {
          const float t1 = e * ct_d[vol + row + x];
          const float t2 = e * ct_d[2 * vol + row + x];
          const float t3 = e * ct_d[3 * vol + row + x];
          u += t.cr * t1 + t.cg * t2 + t.cb * t3;
          s[10] += t1;
          s[11] += t2;
          s[12] += t3;
        }
        s[0] += u;
        s[1] += u * dz;
        s[2] += u * dy;
        s[3] += u * dx;
        s[4] += u * dz * dz;
        s[5] += u * dz * dy;
        s[6] += u * dz * dx;
        s[7] += u * dy * dy;
        s[8] += u * dy * dx;
        s[9] += u * dx * dx;
      }
    }
  }
}

// (b)'s bf16 mode for one lane: s[0..9] = the raw moments P000 Pz00 Py00
// Pzz0 Pzy0 Pyy0 P001 Pz01 Py01 P002 of rnd(u) over dpcx's rounded basis;
// s[10..12] += sum rnd(t_c)
template <bool RGB>
__device__ __forceinline__ void raw_moments(
    const float* __restrict__ ct_d, int64_t vol, int64_t plane, int d,
    int z0, int z1, int lane, const PointTerms& t, float* s) {
  float a[kSlots][6];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
#pragma unroll
    for (int k = 0; k < 6; ++k) a[j][k] = 0.f;
  }
  for (int z = z0; z < z1; ++z) {
    const float zf = static_cast<float>(z);
    const float dz = zf - t.muz;
    const float qz = t.h00 * dz * dz, bz = t.a01 * dz, mz = t.a02 * dz;
    const float fzz = rnd(zf * zf);
    for (int y = 0; y < d; ++y) {
      const float yf = static_cast<float>(y);
      float base_q, m;
      exact_row(t.lw, qz, bz, t.hy, mz, t.a12, yf - t.muy, &base_q, &m);
      const float fzy = rnd(zf * yf), fyy = rnd(yf * yf);
      const int64_t row = z * plane + static_cast<int64_t>(y) * d;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int x = lane + 32 * j;
        if (x >= d) continue;
        const float e =
            exact_exp(base_q, m, t.hx, static_cast<float>(x) - t.mux);
        float u = __fmul_rn(e, ct_d[row + x]);
        if (RGB) {
          const float t1 = __fmul_rn(e, ct_d[vol + row + x]);
          const float t2 = __fmul_rn(e, ct_d[2 * vol + row + x]);
          const float t3 = __fmul_rn(e, ct_d[3 * vol + row + x]);
          u = __fadd_rn(u, __fadd_rn(__fadd_rn(__fmul_rn(t.cr, t1),
                                               __fmul_rn(t.cg, t2)),
                                     __fmul_rn(t.cb, t3)));
          s[10] += rnd(t1);
          s[11] += rnd(t2);
          s[12] += rnd(t3);
        }
        const float ru = rnd(u);  // each F_k ru is exact in f32
        a[j][0] += ru;
        a[j][1] += zf * ru;
        a[j][2] += yf * ru;
        a[j][3] += fzz * ru;
        a[j][4] += fzy * ru;
        a[j][5] += fyy * ru;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int x = lane + 32 * j;
    if (x >= d) continue;
    const float dx = static_cast<float>(x) - t.mux;
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] += a[j][k];
    s[6] += a[j][0] * dx;
    s[7] += a[j][1] * dx;
    s[8] += a[j][2] * dx;
    s[9] += (a[j][0] * dx) * dx;
  }
}

// dpcx's centring of the raw moments (_aniso_bwd_kernel :331-339) with the
// plain version's f32 roundings: s[0..9] raw -> the centred layout of
// centred_moments
__device__ __forceinline__ void centre(float muz, float muy, float* s) {
  const float p000 = s[0], pz00 = s[1], py00 = s[2], pzz0 = s[3],
              pzy0 = s[4], pyy0 = s[5], p001 = s[6], pz01 = s[7],
              py01 = s[8], p002 = s[9];
  s[1] = __fsub_rn(pz00, __fmul_rn(muz, p000));
  s[2] = __fsub_rn(py00, __fmul_rn(muy, p000));
  s[3] = p001;
  s[4] = __fadd_rn(__fsub_rn(pzz0, __fmul_rn(__fmul_rn(2.f, muz), pz00)),
                   __fmul_rn(__fmul_rn(muz, muz), p000));
  s[5] = __fadd_rn(
      __fsub_rn(__fsub_rn(pzy0, __fmul_rn(muz, py00)), __fmul_rn(muy, pz00)),
      __fmul_rn(__fmul_rn(muz, muy), p000));
  s[6] = __fsub_rn(pz01, __fmul_rn(muz, p001));
  s[7] = __fadd_rn(__fsub_rn(pyy0, __fmul_rn(__fmul_rn(2.f, muy), py00)),
                   __fmul_rn(__fmul_rn(muy, muy), p000));
  s[8] = __fsub_rn(py01, __fmul_rn(muy, p001));
  s[9] = p002;
}

// (b) ct [R, CH, D, D, D] -> gout [R, 13, N]; one warp per point.
template <bool RGB, bool BF16>
__global__ void __launch_bounds__(kThreads)
aniso_bwd_kernel(const float* __restrict__ pk, const int* __restrict__ z_lo,
                 const int* __restrict__ z_hi, const float* __restrict__ ct,
                 float* __restrict__ gout, int renders, int n, int d) {
  constexpr int CH = RGB ? 4 : 1;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<int64_t>(renders) * n) return;  // whole warp
  const int64_t r = warp / n;
  const int64_t i = warp - r * n;
  const float* p = pk + r * kRows * n + i;
  const float a00 = p[3 * n], a01 = p[4 * n], a02 = p[5 * n];
  const float a11 = p[6 * n], a12 = p[7 * n], a22 = p[8 * n];
  const float w = p[9 * n];
  PointTerms t;
  t.muz = p[0];
  t.muy = p[n];
  t.mux = p[2 * n];
  t.lw = logf(fmaxf(w, 1e-30f));
  t.h00 = 0.5f * a00;
  t.a01 = a01;
  t.a02 = a02;
  t.hy = 0.5f * a11;
  t.a12 = a12;
  t.hx = 0.5f * a22;
  t.cr = RGB ? p[10 * n] : 0.f;
  t.cg = RGB ? p[11 * n] : 0.f;
  t.cb = RGB ? p[12 * n] : 0.f;
  const int z0 = z_lo[warp], z1 = z_hi[warp];
  const int64_t plane = static_cast<int64_t>(d) * d;
  const int64_t vol = plane * d;
  const float* ct_d = ct + r * CH * vol;

  float s[13];
#pragma unroll
  for (int k = 0; k < 13; ++k) s[k] = 0.f;
  if (BF16) {
    raw_moments<RGB>(ct_d, vol, plane, d, z0, z1, lane, t, s);
  } else {
    centred_moments<RGB>(ct_d, vol, plane, d, z0, z1, lane, t, s);
  }
#pragma unroll
  for (int k = 0; k < 13; ++k) s[k] = warp_sum(s[k]);
  if (lane != 0) return;
  if (BF16) centre(t.muz, t.muy, s);
  float* g = gout + r * kRows * n + i;
  g[0] = a00 * s[1] + a01 * s[2] + a02 * s[3];      // d mu_z
  g[n] = a01 * s[1] + a11 * s[2] + a12 * s[3];      // d mu_y
  g[2 * n] = a02 * s[1] + a12 * s[2] + a22 * s[3];  // d mu_x
  g[3 * n] = -0.5f * s[4];                          // d A00
  g[4 * n] = -s[5];                                 // d A01
  g[5 * n] = -s[6];                                 // d A02
  g[6 * n] = -0.5f * s[7];                          // d A11
  g[7 * n] = -s[8];                                 // d A12
  g[8 * n] = -0.5f * s[9];                          // d A22
  g[9 * n] = w > 1e-30f ? s[0] / w : 0.f;           // d w
  g[10 * n] = s[10];                                // d rgb (0 without)
  g[11 * n] = s[11];
  g[12 * n] = s[12];
}

bool bad_args(int renders, int n, int d) {
  return renders < 0 || n < 0 || d < 1 || d > kMaxVox;
}

template <bool RGB, bool BF16>
cudaError_t launch_fwd(const float* pk, const int* z_lo, const int* z_hi,
                       float* out, int renders, int n, int d,
                       cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(renders) * d;
  const int cpt = (d * d + kThreads - 1) / kThreads;
  if (cpt <= 1) {
    aniso_fwd_kernel<1, RGB, BF16><<<blocks, kThreads, 0, s>>>(
        pk, z_lo, z_hi, out, n, d);
  } else if (cpt <= 4) {
    aniso_fwd_kernel<4, RGB, BF16><<<blocks, kThreads, 0, s>>>(
        pk, z_lo, z_hi, out, n, d);
  } else {
    aniso_fwd_kernel<16, RGB, BF16><<<blocks, kThreads, 0, s>>>(
        pk, z_lo, z_hi, out, n, d);
  }
  return cudaGetLastError();
}

template <bool RGB, bool BF16>
cudaError_t launch_bwd(const float* pk, const int* z_lo, const int* z_hi,
                       const float* ct, float* gout, int renders, int n,
                       int d, cudaStream_t s) {
  constexpr int warps = kThreads / 32;
  const int64_t points = static_cast<int64_t>(renders) * n;
  const unsigned blocks = static_cast<unsigned>((points + warps - 1) / warps);
  aniso_bwd_kernel<RGB, BF16><<<blocks, kThreads, 0, s>>>(
      pk, z_lo, z_hi, ct, gout, renders, n, d);
  return cudaGetLastError();
}

}  // namespace

// Forward (K6). pk [R, 13, N] f32; z_lo, z_hi [R, N] int32 (each point's
// z-range, z_hi == z_lo for none); out [R, CH, D, D, D] f32, CH 4 when
// with_rgb (density, r, g, b accumulators), else 1; bf16: the operand mode.
// Returns a cudaError_t as int.
extern "C" int dpcx_aniso_render(const float* pk, const int* z_lo,
                                 const int* z_hi, float* out, int renders,
                                 int n, int d, int with_rgb, int bf16,
                                 void* stream) {
  if (bad_args(renders, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (renders == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_rgb) {
    err = bf16 ? launch_fwd<true, true>(pk, z_lo, z_hi, out, renders, n, d, s)
               : launch_fwd<true, false>(pk, z_lo, z_hi, out, renders, n, d,
                                         s);
  } else {
    err = bf16 ? launch_fwd<false, true>(pk, z_lo, z_hi, out, renders, n, d,
                                         s)
               : launch_fwd<false, false>(pk, z_lo, z_hi, out, renders, n, d,
                                          s);
  }
  return static_cast<int>(err);
}

// Backward (K7). ct [R, CH, D, D, D] f32, the cotangent of the forward's
// out; gout [R, 13, N] f32, the gradient of pk (colour rows 0 without
// rgb); bf16: the operand mode (raw moments). Returns a cudaError_t as int.
extern "C" int dpcx_aniso_render_bwd(const float* pk, const int* z_lo,
                                     const int* z_hi, const float* ct,
                                     float* gout, int renders, int n, int d,
                                     int with_rgb, int bf16, void* stream) {
  if (bad_args(renders, n, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(renders) * n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_rgb) {
    err = bf16 ? launch_bwd<true, true>(pk, z_lo, z_hi, ct, gout, renders, n,
                                        d, s)
               : launch_bwd<true, false>(pk, z_lo, z_hi, ct, gout, renders,
                                         n, d, s);
  } else {
    err = bf16 ? launch_bwd<false, true>(pk, z_lo, z_hi, ct, gout, renders,
                                         n, d, s)
               : launch_bwd<false, false>(pk, z_lo, z_hi, ct, gout, renders,
                                          n, d, s);
  }
  return static_cast<int>(err);
}
