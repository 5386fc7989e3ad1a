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
// to the density of every cell whose z lies in its chunk's band (all y,
// all x), and e * rgb to the three colour channels. q is not clamped at 0
// (the TPU kernel does not clamp either), and points of weight 0 are not
// skipped (they add 1e-30 exp(-q)).
//
// The chunks are dpcx's: the points, padded to a multiple of the chunk C,
// sorted by mu_z and cut into chunks of C (a multiple of 128); each chunk
// adds to the planes of its band [lo, hi). render/aniso.py::chunk_table
// computes the sort order (sorted position -> point, pads >= N) and the
// bands in PyTorch; both kernels take them. The TPU kernel places each x
// column with a one-hot matmul and sums on the MXU; here:
//   (a) forward (K6): one block of 256 threads per (render, z-plane). Each
//       thread owns XPT consecutive x of one row (1 at D <= 16, 4 at
//       D <= 32, 16 at D <= 64) and keeps their channels in registers. The
//       block tests the n_chunks bands against its plane and walks only
//       the covering chunks' points, gathered through the order into
//       shared memory 256 at a time with their plane terms (double
//       buffered: the next tile's indices are loaded before this one is
//       summed, and it is staged into the other buffer after, one barrier
//       a tile). Per (point, row) a thread forms dy and the row's
//       coefficients once; per cell the exponent is a quadratic in dx,
//       two FMAs. Each cell is written once: no atomics, a fixed order.
//   (b) backward (K7, _aniso_bwd_kernel): a thread per point, one block of
//       128 sorted points, which lie in one chunk and so walk one band.
//       The block stages the band's cotangent, 1024 cells a channel at a
//       time (a plane at D 32, a quarter plane at D 64), in shared memory
//       with cp.async, double buffered, so the next stage lands while this
//       one is summed; every thread reads the same cell at once (a shared
//       memory broadcast; at D 32 a float4 of 4 x a channel). Per row
//       (z, y) a thread forms its row terms once, walks x summing u, u dx
//       and (u dx) dx (and e ct_c), and folds the row sums into the
//       point's moments at the row's end. Each thread writes its 13 gradients
//       once, through the order: no atomics, no second pass, the same
//       result from run to run:
//         d mu = A (sum u dz, sum u dy, sum u dx),
//         d A00 = -1/2 sum u dz^2, d A01 = -sum u dz dy, ...,
//         d w = sum u / w where w > 1e-30 (else 0), d rgb_c = sum e ct_c,
//       with u = e (ct_d + r ct_r + g ct_g + b ct_b).
// What bounds them: the FP32 issue rate. Per point-cell in the f32 mode K6
// spends ~8 instructions (dx, 2 FMAs, ex2, 4 sums), K7 ~16 (the same
// exponent, u, the colour sums, 3 moment sums, a float4 broadcast load a
// channel per 4 cells), with the row and plane terms amortised over D
// cells. The f32 mode's exponential is one ex2.approx (MUFU, 16 a clock
// per SM: ~0.5 ms at the rgb_splats render) on coefficients pre-scaled by
// log2(e). The cotangent traffic is the band once per 128 points, from L2.
//
// Operand mode (bf16 = 1: dpcx's pallas_acc_dtype "bfloat16"). The Pallas
// kernels cast their matmul operands to bfloat16 and accumulate in f32; the
// exponent stays f32. Here every value they type bfloat16 is rounded to
// nearest-even (rnd: __float2bfloat16_rn) where they round it:
//   (a) e = rnd(exp(...)) (_aniso_fwd_kernel :160) and the colours rnd(r),
//       rnd(g), rnd(b) (:140-144); the density sums e, colour c sums
//       e rnd(c), a product of two rounded values, exact in f32. At D 32
//       the sums run on the tensor cores as dpcx's matmul does
//       (aniso_fwd_kernel_mma: mma.sync m16n8k16, A = rnd(e) for 16 cells
//       x 16 points, B = rnd([1, r, g, b]) padded to 8 columns, f32 sums);
//       at other D on the CUDA cores (FMAs of the same exact products).
//   (b) e is not rounded (only the forward rounds it); t_c = e ct_c and
//       u = e ct_d + (r t1 + g t2 + b t3) are f32, and what is summed is
//       rnd(u) and rnd(t_c) (red, :289-311) over dpcx's reduction basis of
//       absolute cell coordinates F = (1, z, y, rnd(z z), rnd(z y),
//       rnd(y y)) (:247-255). So this mode sums raw moments: per row the
//       sums of rnd(u), rnd(u) dx and (rnd(u) dx) dx over x, folded at the
//       row's end into the ten raw moments P_k = sum F_k rnd(u) (and their
//       x moments), kept in float64 so the fold's products F_k R are exact
//       (dpcx sums per x column over rows and multiplies by dx after: only
//       the f32 summation order differs, no rounding point moves). At the
//       end they are centred in f32 as dpcx does (:327-339); the centring
//       cancels digits where a coordinate is far from 0, and the rounded
//       basis moves the scale and rotation gradients of this mode far more
//       than that (the reference's function, matched).
//   The exponent (expf, not ex2), t_c and u are formed without contracted
//   multiply-adds (__fmul_rn, __fadd_rn), in the plain version's order: an
//   f32 ulp more or less there flips a bf16 rounding; (b) rounds two values
//   a conversion (cvt.rn.bf16x2). Bound: as the f32 mode, the FP32 issue
//   rate, with ~1.3x (a, tensor-core sums) and ~2.3x (b) its instructions
//   a point-cell: the exact exponent (expf alone is ~8), u and the
//   roundings.
//
// The launchers run on the caller's stream, allocate nothing, and return
// the first CUDA error (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 13;
constexpr int kMaxVox = 64;
constexpr int kFwdThreads = 256;  // (a): threads, and points staged a tile
constexpr int kTile = 128;        // (b): sorted points (threads) a block
constexpr int kStageCells = 1024;  // (b): cotangent cells a channel a stage
constexpr float kLog2e = 1.4426950408889634f;

// round to the nearest bfloat16 (ties to even), back to f32
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 2^v on the MUFU (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
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

// the terms of one point the kernels read in their loops: in (a) those of
// the block's plane, in (b) the point's own (qz, bz, mz then hold
// 1/2 A00, A01, A02). The f32 mode's exponent terms are in log2 units.
struct __align__(16) PointTerms {
  float qz, bz, mz, lw;  // 1/2 A00 dz^2, A01 dz, A02 dz; log(max(w, 1e-30))
  float muy, mux, hy, a12;  // hy = 1/2 A11
  float hx, r, g, b;        // hx = 1/2 A22; colours (rounded in (a)'s bf16)
};

// point i's terms: with plane, (a)'s at z = zf (dz = zf - mu_z, colours
// rounded in the bf16 mode); without, (b)'s (1/2 A00, A01, A02 raw, the
// colours as they are); a pad (i >= n) gets lw = -inf and adds 0
template <bool RGB, bool BF16>
__device__ __forceinline__ PointTerms point_terms(const float* __restrict__ p,
                                                  int n, int i, bool plane,
                                                  float zf) {
  PointTerms t;
  if (i >= n) {
    t.qz = t.bz = t.mz = t.muy = t.mux = t.hy = t.a12 = t.hx = 0.f;
    t.r = t.g = t.b = 0.f;
    t.lw = __int_as_float(0xff800000);  // -inf
    return t;
  }
  const float s = BF16 ? 1.f : kLog2e;
  const float a00 = p[3 * n + i], a01 = p[4 * n + i], a02 = p[5 * n + i];
  const float w = p[9 * n + i];
  if (plane) {
    const float dz = zf - p[i];
    t.qz = (s * (0.5f * a00)) * dz * dz;
    t.bz = (s * a01) * dz;
    t.mz = (s * a02) * dz;
  } else {
    t.qz = s * (0.5f * a00);
    t.bz = s * a01;
    t.mz = s * a02;
  }
  t.lw = BF16 ? logf(fmaxf(w, 1e-30f)) : log2f(fmaxf(w, 1e-30f));
  t.muy = p[n + i];
  t.mux = p[2 * n + i];
  t.hy = s * (0.5f * p[6 * n + i]);
  t.a12 = s * p[7 * n + i];
  t.hx = s * (0.5f * p[8 * n + i]);
  t.r = RGB ? p[10 * n + i] : 0.f;
  t.g = RGB ? p[11 * n + i] : 0.f;
  t.b = RGB ? p[12 * n + i] : 0.f;
  if (BF16 && plane) {  // K6 rounds the colours, K7 takes them as they are
    t.r = rnd(t.r);
    t.g = rnd(t.g);
    t.b = rnd(t.b);
  }
  return t;
}

// the row's exponent terms: e = exp(base - dx (m + hx dx)) (f32 mode,
// log2 units) or exact_row's (bf16 mode)
template <bool BF16>
__device__ __forceinline__ void row_terms(const PointTerms& t, float qz,
                                          float bz, float mz, float dy,
                                          float* base, float* m) {
  if (BF16) {
    exact_row(t.lw, qz, bz, t.hy, mz, t.a12, dy, base, m);
  } else {
    *base = t.lw - fmaf(fmaf(t.hy, dy, bz), dy, qz);
    *m = fmaf(t.a12, dy, mz);
  }
}

template <bool BF16>
__device__ __forceinline__ float cell_exp(float base, float m, float hx,
                                          float dx) {
  if (BF16) return exact_exp(base, m, hx, dx);
  return ex2(fmaf(-dx, fmaf(hx, dx, m), base));
}

// (a)'s walk over the points of the chunks whose band covers plane z:
// kFwdThreads sorted points a tile, staged through the order with their
// plane terms in sp (double buffered: the next tile's indices load before
// this tile is summed, its terms are staged into the other buffer after,
// one barrier a tile); every thread calls sum(tile, count) for each tile
template <bool RGB, bool BF16, class Sum>
__device__ __forceinline__ void walk_plane(PointTerms (*sp)[kFwdThreads],
                                           const float* __restrict__ p,
                                           const int* __restrict__ ord,
                                           const int* __restrict__ blo,
                                           const int* __restrict__ bhi, int n,
                                           int chunk, int n_chunks, int z,
                                           Sum sum) {
  const float zf = static_cast<float>(z);
  auto next_cover = [&](int c) {
    while (c < n_chunks && !(blo[c] <= z && z < bhi[c])) ++c;
    return c;
  };
  int c = next_cover(0), off = 0;
  if (c < n_chunks && threadIdx.x < min(kFwdThreads, chunk)) {
    sp[0][threadIdx.x] =
        point_terms<RGB, BF16>(p, n, ord[c * chunk + threadIdx.x], true, zf);
  }
  __syncthreads();
  int cur = 0;
  while (c < n_chunks) {
    const int cnt = min(kFwdThreads, chunk - off);  // a multiple of 128
    int nc = c, noff = off + kFwdThreads;
    if (noff >= chunk) {
      nc = next_cover(c + 1);
      noff = 0;
    }
    const bool stage = nc < n_chunks && threadIdx.x < min(kFwdThreads,
                                                          chunk - noff);
    const int ni = stage ? ord[nc * chunk + noff + threadIdx.x] : 0;
    sum(sp[cur], cnt);
    if (stage) {
      sp[cur ^ 1][threadIdx.x] = point_terms<RGB, BF16>(p, n, ni, true, zf);
    }
    __syncthreads();  // the next tile is staged, this one consumed
    cur ^= 1;
    c = nc;
    off = noff;
  }
}

// (a) out [R, CH, D, D, D]; one block per (render, z); XPT x per thread
template <int XPT, bool RGB, bool BF16>
__global__ void __launch_bounds__(kFwdThreads)
aniso_fwd_kernel(const float* __restrict__ pk, const int* __restrict__ order,
                 const int* __restrict__ band_lo,
                 const int* __restrict__ band_hi, float* __restrict__ out,
                 int n, int n_sorted, int n_chunks, int d) {
  constexpr int CH = RGB ? 4 : 1;
  __shared__ PointTerms sp[2][kFwdThreads];
  const int r = blockIdx.x / d;
  const int z = blockIdx.x - r * d;
  const int tpr = (d + XPT - 1) / XPT;  // threads a row
  const int y = threadIdx.x / tpr;
  const int x0 = (threadIdx.x - y * tpr) * XPT;
  const bool active = y < d;
  const float yf = static_cast<float>(y);

  float acc[XPT][CH];
#pragma unroll
  for (int k = 0; k < XPT; ++k) {
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) acc[k][ch] = 0.f;
  }
  walk_plane<RGB, BF16>(
      sp, pk + static_cast<int64_t>(r) * kRows * n,
      order + static_cast<int64_t>(r) * n_sorted,
      band_lo + static_cast<int64_t>(r) * n_chunks,
      band_hi + static_cast<int64_t>(r) * n_chunks, n, n_sorted / n_chunks,
      n_chunks, z, [&](const PointTerms* tile, int cnt) {
        if (!active) return;
        for (int j = 0; j < cnt; ++j) {
          const PointTerms s = tile[j];  // a broadcast
          float base, m;
          row_terms<BF16>(s, s.qz, s.bz, s.mz, yf - s.muy, &base, &m);
#pragma unroll
          for (int k = 0; k < XPT; ++k) {
            const float dx = static_cast<float>(x0 + k) - s.mux;
            float e = cell_exp<BF16>(base, m, s.hx, dx);
            if (BF16) e = rnd(e);
            acc[k][0] += e;
            if (RGB) {
              acc[k][1] = fmaf(e, s.r, acc[k][1]);
              acc[k][2] = fmaf(e, s.g, acc[k][2]);
              acc[k][3] = fmaf(e, s.b, acc[k][3]);
            }
          }
        }
      });

  if (!active) return;
  const int64_t plane = static_cast<int64_t>(d) * d;
  const int64_t vol = plane * d;
#pragma unroll
  for (int k = 0; k < XPT; ++k) {
    if (x0 + k >= d) continue;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      out[(static_cast<int64_t>(r) * CH + ch) * vol + z * plane + y * d + x0 +
          k] = acc[k][ch];
    }
  }
}

// two f32 values rounded to bfloat16 (nearest-even), packed lo | hi << 16
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a)'s bf16 mode at D 32 with the sums on the tensor cores, as dpcx sums
// them (_aniso_fwd_kernel :140-165): E rnd([1, r, g, b]) with A = rnd(e)
// [16 cells x 16 points] and B = [16 points x 8 columns] (1, rnd r, rnd g,
// rnd b, then 0) by mma.sync m16n8k16 (bf16 operands, f32 sums; each
// product is exact in f32). Warp w owns rows 4w .. 4w + 3 of the plane, 8
// tiles of 16 cells; lane (g, t) = (lane / 4, lane % 4) forms the A
// fragment's e for its points 2t, 2t + 1, 2t + 8, 2t + 9 of each 16 and its
// cells x = g, g + 8, g + 16, g + 24 of each row, the row terms once per
// (point, row). out as aniso_fwd_kernel's.
template <bool RGB>
__global__ void __launch_bounds__(kFwdThreads)
aniso_fwd_kernel_mma(const float* __restrict__ pk,
                     const int* __restrict__ order,
                     const int* __restrict__ band_lo,
                     const int* __restrict__ band_hi, float* __restrict__ out,
                     int n, int n_sorted, int n_chunks) {
  constexpr int D = 32;
  constexpr int CH = RGB ? 4 : 1;
  static_assert(kFwdThreads / 32 * 4 == D, "8 warps of 4 rows");
  __shared__ PointTerms sp[2][kFwdThreads];
  const int r = blockIdx.x / D;
  const int z = blockIdx.x - r * D;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int y0 = 4 * (threadIdx.x >> 5);

  float acc[4][2][4];  // [row][half of the row][d0..d3]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][h][k] = 0.f;
    }
  }
  // column g of B for a staged point
  auto column = [&](const PointTerms& s) {
    if (g == 0) return 1.f;
    if (!RGB) return 0.f;
    return g == 1 ? s.r : g == 2 ? s.g : g == 3 ? s.b : 0.f;
  };
  walk_plane<RGB, true>(
      sp, pk + static_cast<int64_t>(r) * kRows * n,
      order + static_cast<int64_t>(r) * n_sorted,
      band_lo + static_cast<int64_t>(r) * n_chunks,
      band_hi + static_cast<int64_t>(r) * n_chunks, n, n_sorted / n_chunks,
      n_chunks, z, [&](const PointTerms* tile, int cnt) {
        for (int k0 = 0; k0 < cnt; k0 += 16) {
          PointTerms q[4];
          q[0] = tile[k0 + 2 * t];
          q[1] = tile[k0 + 2 * t + 1];
          q[2] = tile[k0 + 2 * t + 8];
          q[3] = tile[k0 + 2 * t + 9];
          const uint32_t b0 = pack_bf16(column(q[0]), column(q[1]));
          const uint32_t b1 = pack_bf16(column(q[2]), column(q[3]));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float yf = static_cast<float>(y0 + j);
            float base[4], m[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              row_terms<true>(q[i], q[i].qz, q[i].bz, q[i].mz, yf - q[i].muy,
                              &base[i], &m[i]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float e[2][4];  // [cell x = 16h + g + 8c][point i]
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const float xf = static_cast<float>(16 * h + g + 8 * cc);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  e[cc][i] = exact_exp(base[i], m[i], q[i].hx, xf - q[i].mux);
                }
              }
              const uint32_t a0 = pack_bf16(e[0][0], e[0][1]);
              const uint32_t a1 = pack_bf16(e[1][0], e[1][1]);
              const uint32_t a2 = pack_bf16(e[0][2], e[0][3]);
              const uint32_t a3 = pack_bf16(e[1][2], e[1][3]);
              float* c = acc[j][h];
              asm volatile(
                  "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                  "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                  "{%0, %1, %2, %3};\n"
                  : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                  : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
            }
          }
        }
      });

  // d0, d1: cell x = 16h + g, columns 2t, 2t + 1; d2, d3: cell x + 8
  constexpr int64_t plane = D * D, vol = plane * D;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = 2 * t + (k & 1);
        if (ch >= CH) continue;
        const int x = 16 * h + g + 8 * (k >> 1);
        out[(static_cast<int64_t>(r) * CH + ch) * vol + z * plane +
            (y0 + j) * D + x] = acc[j][h][k];
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// (b)'s running sums of one thread: the row's, then the point's
struct Sums {
  float r0, r1, r2;   // this row: sum u, u dx, (u dx) dx
  float t[3];         // sum e ct_c (bf16: rnd(e ct_c)), never reset
  float s[10];        // f32: the centred moments (layout of centre's out)
  double p[10];       // bf16: P000 Pz00 Py00 Pzz0 Pzy0 Pyy0 P001 Pz01 Py01
                      // P002, the raw moments over dpcx's basis
};

// one cell of (b): e, u and the row's sums
template <bool RGB, bool BF16>
__device__ __forceinline__ void bwd_cell(const PointTerms& t, float base,
                                         float m, float x, float cd, float cr,
                                         float cg, float cb, Sums& a) {
  const float dx = x - t.mux;
  const float e = cell_exp<BF16>(base, m, t.hx, dx);
  float u;
  if (BF16) {
    u = __fmul_rn(e, cd);
    if (RGB) {
      const float t1 = __fmul_rn(e, cr), t2 = __fmul_rn(e, cg),
                  t3 = __fmul_rn(e, cb);
      u = __fadd_rn(u, __fadd_rn(__fadd_rn(__fmul_rn(t.r, t1),
                                           __fmul_rn(t.g, t2)),
                                 __fmul_rn(t.b, t3)));
      // four roundings in two conversions
      const __nv_bfloat162 r12 = __floats2bfloat162_rn(t1, t2);
      const __nv_bfloat162 r3u = __floats2bfloat162_rn(t3, u);
      a.t[0] += __low2float(r12);
      a.t[1] += __high2float(r12);
      a.t[2] += __low2float(r3u);
      u = __high2float(r3u);
    } else {
      u = rnd(u);
    }
  } else if (RGB) {
    u = e * fmaf(t.b, cb, fmaf(t.g, cg, fmaf(t.r, cr, cd)));
    a.t[0] = fmaf(e, cr, a.t[0]);
    a.t[1] = fmaf(e, cg, a.t[1]);
    a.t[2] = fmaf(e, cb, a.t[2]);
  } else {
    u = e * cd;
  }
  a.r0 += u;
  const float ud = u * dx;
  a.r1 += ud;
  a.r2 = fmaf(ud, dx, a.r2);
}

// the row's sums into the point's moments: f32 centred with dz, dy; bf16
// raw over F = (1, z, y, rnd(z z), rnd(z y), rnd(y y)) in float64
template <bool BF16>
__device__ __forceinline__ void fold_row(float zf, float yf, float dz,
                                         float dy, Sums& a) {
  if (BF16) {
    const double r0 = a.r0, r1 = a.r1, z = zf, y = yf;
    a.p[0] += r0;
    a.p[1] = fma(z, r0, a.p[1]);
    a.p[2] = fma(y, r0, a.p[2]);
    a.p[3] = fma(static_cast<double>(rnd(zf * zf)), r0, a.p[3]);
    a.p[4] = fma(static_cast<double>(rnd(zf * yf)), r0, a.p[4]);
    a.p[5] = fma(static_cast<double>(rnd(yf * yf)), r0, a.p[5]);
    a.p[6] += r1;
    a.p[7] = fma(z, r1, a.p[7]);
    a.p[8] = fma(y, r1, a.p[8]);
    a.p[9] += static_cast<double>(a.r2);
  } else {
    a.s[0] += a.r0;
    a.s[1] = fmaf(dz, a.r0, a.s[1]);
    a.s[2] = fmaf(dy, a.r0, a.s[2]);
    a.s[3] += a.r1;
    a.s[4] = fmaf(dz * dz, a.r0, a.s[4]);
    a.s[5] = fmaf(dz * dy, a.r0, a.s[5]);
    a.s[6] = fmaf(dz, a.r1, a.s[6]);
    a.s[7] = fmaf(dy * dy, a.r0, a.s[7]);
    a.s[8] = fmaf(dy, a.r1, a.s[8]);
    a.s[9] += a.r2;
  }
  a.r0 = a.r1 = a.r2 = 0.f;
}

// dpcx's centring of the raw moments (_aniso_bwd_kernel :331-339) with the
// plain version's f32 roundings: s[0..9] raw -> the centred layout (sum u,
// u dz, u dy, u dx, u dz dz, u dz dy, u dz dx, u dy dy, u dy dx, u dx dx)
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

// (b) ct [R, CH, D, D, D] -> gout [R, 13, N]; one block per (render, 128
// sorted points), a thread per point. DT: D at compile time (32, the
// shipped rgb_splats D: float4 staging and loads, x unrolled), or 0 (any
// D, d at run time).
template <int DT, bool RGB, bool BF16>
__global__ void __launch_bounds__(kTile)
aniso_bwd_kernel(const float* __restrict__ pk, const int* __restrict__ order,
                 const int* __restrict__ band_lo,
                 const int* __restrict__ band_hi, const float* __restrict__ ct,
                 float* __restrict__ gout, int n, int n_sorted, int n_chunks,
                 int d_run) {
  constexpr int CH = RGB ? 4 : 1;
  constexpr bool VEC = DT > 0;
  static_assert(DT % 4 == 0 && kStageCells % (DT > 0 ? DT : 1) == 0,
                "DT: a multiple of 4 that divides a stage");
  __shared__ __align__(16) float sct[2][CH][kStageCells];
  const int d = DT > 0 ? DT : d_run;
  const int tiles = n_sorted / kTile;
  const int r = blockIdx.x / tiles;
  const int tile = blockIdx.x - r * tiles;
  const int c = tile * kTile / (n_sorted / n_chunks);
  const int lo = band_lo[r * n_chunks + c];
  const int hi = band_hi[r * n_chunks + c];
  const int i = order[static_cast<int64_t>(r) * n_sorted + tile * kTile +
                      threadIdx.x];
  const bool valid = i < n;
  const float* p = pk + static_cast<int64_t>(r) * kRows * n;
  const PointTerms t = point_terms<RGB, BF16>(p, n, i, false, 0.f);
  const float muz = valid ? p[i] : 0.f;

  const int64_t plane = static_cast<int64_t>(d) * d;
  const int64_t vol = plane * d;
  const float* src = ct + static_cast<int64_t>(r) * CH * vol + lo * plane;
  const int rows = max(hi - lo, 0) * d;  // the band's rows (z, y)
  const int rps = kStageCells / d;       // rows a stage
  const int stages = (rows + rps - 1) / rps;
  auto stage = [&](int s) {
    const int first = s * rps;
    const int cells = min(rps, rows - first) * d;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const float* g = src + ch * vol + static_cast<int64_t>(first) * d;
      float* sh = sct[s & 1][ch];
      if (VEC) {
        for (int k = 4 * threadIdx.x; k < cells; k += 4 * kTile) {
          cp_async16(sh + k, g + k);
        }
      } else {
        for (int k = threadIdx.x; k < cells; k += kTile) {
          cp_async4(sh + k, g + k);
        }
      }
    }
  };

  Sums a;
  a.r0 = a.r1 = a.r2 = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.t[k] = 0.f;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    a.s[k] = 0.f;
    a.p[k] = 0.0;
  }
  if (stages > 0) stage(0);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) stage(s + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();  // stage s has landed, every thread's part of it
    if (valid) {
      const float* sd = sct[s & 1][0];
      const float* sr = sct[s & 1][RGB ? 1 : 0];
      const float* sg = sct[s & 1][RGB ? 2 : 0];
      const float* sb = sct[s & 1][RGB ? 3 : 0];
      const int first = s * rps;
      const int nrows = min(rps, rows - first);
      for (int k = 0; k < nrows; ++k) {
        const int row = first + k;
        const int zi = lo + row / d;
        const int yi = row - (row / d) * d;
        const float zf = static_cast<float>(zi), yf = static_cast<float>(yi);
        const float dz = zf - muz, dy = yf - t.muy;
        float base, m;
        if (BF16) {  // point_terms kept 1/2 A00, A01, A02 in qz, bz, mz
          row_terms<true>(t, t.qz * dz * dz, t.bz * dz, t.mz * dz, dy, &base,
                          &m);
        } else {
          row_terms<false>(t, t.qz * dz * dz, t.bz * dz, t.mz * dz, dy,
                           &base, &m);
        }
        const int o = k * d;
        if (VEC) {
#pragma unroll
          for (int x = 0; x < (DT > 0 ? DT : 4); x += 4) {
            const float4 vd = *reinterpret_cast<const float4*>(sd + o + x);
            float4 vr = vd, vg = vd, vb = vd;
            if (RGB) {
              vr = *reinterpret_cast<const float4*>(sr + o + x);
              vg = *reinterpret_cast<const float4*>(sg + o + x);
              vb = *reinterpret_cast<const float4*>(sb + o + x);
            }
            const float xf = static_cast<float>(x);
            bwd_cell<RGB, BF16>(t, base, m, xf, vd.x, vr.x, vg.x, vb.x, a);
            bwd_cell<RGB, BF16>(t, base, m, xf + 1.f, vd.y, vr.y, vg.y, vb.y,
                                a);
            bwd_cell<RGB, BF16>(t, base, m, xf + 2.f, vd.z, vr.z, vg.z, vb.z,
                                a);
            bwd_cell<RGB, BF16>(t, base, m, xf + 3.f, vd.w, vr.w, vg.w, vb.w,
                                a);
          }
        } else {
          for (int x = 0; x < d; ++x) {
            bwd_cell<RGB, BF16>(t, base, m, static_cast<float>(x), sd[o + x],
                                RGB ? sr[o + x] : 0.f, RGB ? sg[o + x] : 0.f,
                                RGB ? sb[o + x] : 0.f, a);
          }
        }
        fold_row<BF16>(zf, yf, dz, dy, a);
      }
    }
    __syncthreads();  // stage s is consumed before its buffer is refilled
  }
  if (!valid) return;

  float s[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    s[k] = BF16 ? static_cast<float>(a.p[k]) : a.s[k];
  }
  if (BF16) centre(muz, t.muy, s);
  const float a00 = p[3 * n + i], a01 = p[4 * n + i], a02 = p[5 * n + i];
  const float a11 = p[6 * n + i], a12 = p[7 * n + i], a22 = p[8 * n + i];
  const float w = p[9 * n + i];
  float* g = gout + static_cast<int64_t>(r) * kRows * n + i;
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
  g[10 * n] = a.t[0];                               // d rgb (0 without)
  g[11 * n] = a.t[1];
  g[12 * n] = a.t[2];
}

// the chunk table's shape: Np sorted positions in n_chunks chunks of a
// multiple of kTile, at least one position a point
bool bad_args(int renders, int n, int n_sorted, int n_chunks, int d) {
  return renders < 0 || n < 1 || d < 1 || d > kMaxVox || n_chunks < 1 ||
         n_sorted < n || n_sorted % n_chunks != 0 ||
         (n_sorted / n_chunks) % kTile != 0;
}

template <bool RGB, bool BF16>
cudaError_t launch_fwd(const float* pk, const int* order, const int* band_lo,
                       const int* band_hi, float* out, int renders, int n,
                       int n_sorted, int n_chunks, int d, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(renders) * d;
  if (BF16 && d == 32) {
    aniso_fwd_kernel_mma<RGB><<<blocks, kFwdThreads, 0, s>>>(
        pk, order, band_lo, band_hi, out, n, n_sorted, n_chunks);
  } else if (d <= 16) {
    aniso_fwd_kernel<1, RGB, BF16><<<blocks, kFwdThreads, 0, s>>>(
        pk, order, band_lo, band_hi, out, n, n_sorted, n_chunks, d);
  } else if (d <= 32) {
    aniso_fwd_kernel<4, RGB, BF16><<<blocks, kFwdThreads, 0, s>>>(
        pk, order, band_lo, band_hi, out, n, n_sorted, n_chunks, d);
  } else {
    aniso_fwd_kernel<16, RGB, BF16><<<blocks, kFwdThreads, 0, s>>>(
        pk, order, band_lo, band_hi, out, n, n_sorted, n_chunks, d);
  }
  return cudaGetLastError();
}

template <bool RGB, bool BF16>
cudaError_t launch_bwd(const float* pk, const int* order, const int* band_lo,
                       const int* band_hi, const float* ct, float* gout,
                       int renders, int n, int n_sorted, int n_chunks, int d,
                       cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(renders) * (n_sorted / kTile);
#define DPCX_BWD(DT)                                                        \
  aniso_bwd_kernel<DT, RGB, BF16><<<blocks, kTile, 0, s>>>(                 \
      pk, order, band_lo, band_hi, ct, gout, n, n_sorted, n_chunks, d)
  if (d == 32) {
    DPCX_BWD(32);
  } else {
    DPCX_BWD(0);
  }
#undef DPCX_BWD
  return cudaGetLastError();
}

}  // namespace

// Forward (K6). pk [R, 13, N] f32; order [R, Np] int32 (sorted position ->
// point, pads >= N), band_lo, band_hi [R, n_chunks] int32 (each chunk's
// z-band, hi == lo for none): render/aniso.py::chunk_table; out [R, CH, D,
// D, D] f32, CH 4 when with_rgb (density, r, g, b accumulators), else 1;
// bf16: the operand mode. Returns a cudaError_t as int.
extern "C" int dpcx_aniso_render(const float* pk, const int* order,
                                 const int* band_lo, const int* band_hi,
                                 float* out, int renders, int n, int n_sorted,
                                 int n_chunks, int d, int with_rgb, int bf16,
                                 void* stream) {
  if (bad_args(renders, n, n_sorted, n_chunks, d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (renders == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_rgb) {
    err = bf16 ? launch_fwd<true, true>(pk, order, band_lo, band_hi, out,
                                        renders, n, n_sorted, n_chunks, d, s)
               : launch_fwd<true, false>(pk, order, band_lo, band_hi, out,
                                         renders, n, n_sorted, n_chunks, d,
                                         s);
  } else {
    err = bf16 ? launch_fwd<false, true>(pk, order, band_lo, band_hi, out,
                                         renders, n, n_sorted, n_chunks, d,
                                         s)
               : launch_fwd<false, false>(pk, order, band_lo, band_hi, out,
                                          renders, n, n_sorted, n_chunks, d,
                                          s);
  }
  return static_cast<int>(err);
}

// Backward (K7). ct [R, CH, D, D, D] f32, the cotangent of the forward's
// out, 16-byte aligned; gout [R, 13, N] f32, the gradient of pk (colour
// rows 0 without rgb); the chunk table as the forward's; bf16: the operand
// mode (raw moments). Returns a cudaError_t as int.
extern "C" int dpcx_aniso_render_bwd(const float* pk, const int* order,
                                     const int* band_lo, const int* band_hi,
                                     const float* ct, float* gout,
                                     int renders, int n, int n_sorted,
                                     int n_chunks, int d, int with_rgb,
                                     int bf16, void* stream) {
  if (bad_args(renders, n, n_sorted, n_chunks, d) ||
      reinterpret_cast<uintptr_t>(ct) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (renders == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (with_rgb) {
    err = bf16 ? launch_bwd<true, true>(pk, order, band_lo, band_hi, ct, gout,
                                        renders, n, n_sorted, n_chunks, d, s)
               : launch_bwd<true, false>(pk, order, band_lo, band_hi, ct,
                                         gout, renders, n, n_sorted, n_chunks,
                                         d, s);
  } else {
    err = bf16 ? launch_bwd<false, true>(pk, order, band_lo, band_hi, ct,
                                         gout, renders, n, n_sorted, n_chunks,
                                         d, s)
               : launch_bwd<false, false>(pk, order, band_lo, band_hi, ct,
                                          gout, renders, n, n_sorted,
                                          n_chunks, d, s);
  }
  return static_cast<int>(err);
}
