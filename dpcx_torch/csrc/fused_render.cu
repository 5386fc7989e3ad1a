// Fused point-cloud renderer for NVIDIA Hopper (sm_90a):
// trilinear splat -> separable Gaussian blur -> DRC projection, D <= 128.
//
// Forward. Replaces two TPU kernels that compute one function:
// dpcx/render/pallas_kernel.py::_fused_kernel (K1, D <= 64, launched by
// _pallas_forward) and dpcx/render/pallas_blocked.py::_blocked_fwd_kernel
// (K3, D > 64, launched by blocked_forward). Per render, points in grid
// units (z, y, x) with a weight are splatted trilinearly into a D^3
// occupancy grid (out-of-grid corners dropped), the grid is blurred by three
// 1-D Gaussian passes (SAME zero padding, x then y then z, taps computed from
// a runtime sigma), and each ray along z is reduced with o clipped to
// [0, 1 - 1e-5]:
//   p_z = o_z T_z,  sil = sum_z p_z,
//   depth = sum_z d_z p_z + 1.0 * T_D,  d_z = (z + 0.5) / D - 0.5.
//
// The TPU kernels z-sort the points, build per-chunk window metadata and
// splat with dense matmuls because the TPU has no atomic scatter; K3 also
// blocks z into slabs of 32 with a 2R halo and carries the transmittance
// across grid steps, because a 128^3 f32 grid (8 MiB per render) does not
// fit in VMEM. Hopper has fast atomics, and its 80 GB of device memory hold
// the whole grid of every render (128 MiB at 16 renders of 128^3), so this
// design keeps none of that, and one kernel family covers every D <= 128:
//   (a) splat: one thread per point, 8 atomicAdds into a zeroed f32 grid
//       [R, D, D, D] in device memory (R = renders). Bound by atomics:
//       8 per point, contended where many points share a cell.
//   (b) blur y and x: one block per (render, z-slab). D <= 64: the D x D
//       slab and the x- (or y-) blurred copy sit in shared memory, the
//       second pass is written back in place (256 threads, <= 32 KiB).
//       D > 64 (blur_slab_kernel): one slab buffer of padded(D) rows of
//       slab_pitch(D) floats (66 KiB at D 128: 128 x 132), so three blocks
//       share an SM and one block's loads overlap another's arithmetic;
//       the slab arrives by cp.async, all of it in flight at once.
//       Register blocking (blur_run): a thread forms a run of 8
//       consecutive outputs from aligned chunks of 8 inputs and the 15
//       taps they meet, 6-12 shared loads (16-byte ones where the data is
//       contiguous) per 64 FMAs instead of one load per FMA. The x pass
//       runs 32 rows at a time (a lane a row), holds its runs in registers
//       until every warp has read those rows, and writes them back into
//       the buffer; the y pass (a lane a column) writes straight to device
//       memory.
//   (c) blur z fused with DRC: one thread per ray (render, y, x) walks z,
//       forms each z-blurred occupancy from its 2R+1 neighbours (a warp
//       reads 32 neighbouring x, so the reads coalesce and mostly hit L1),
//       and carries T, sil and depth in registers. No z-blocking and no
//       carried state between blocks: a ray is one thread's loop.
// (b) and (c) are bound by bytes: the grid is written once by (a) and (b)
// and read twice, by (b) and (c); at D = 128 that is 8 MiB per render, and
// one pass over 16 renders (134 MB read, 134 MB written) takes at least
// 0.080 ms at 3.35 TB/s against 0.031 ms for its FMAs at 67 TFLOP/s.
//
// Backward. Replaces dpcx/render/pallas_kernel.py::_fused_bwd_kernel (K2,
// D <= 64) and the two passes of the depth-blocked backward,
// dpcx/render/pallas_blocked.py::_blocked_total_kernel (K4: per-ray Total)
// and ::_blocked_bwd_kernel (K5: dL/do_z, the blur transposes, the splat
// backward): the gradient of (sil, depth) with respect to each point's
// (z, y, x, w) in grid units. The TPU kernels recompute the grid because a
// second D^3 buffer does not fit in VMEM. Here the forward's x/y-blurred
// grid may stay in device memory as the residual (dpcx_fused_render_bwd;
// the saved-grid mode), or the backward re-splats and re-blurs into fresh
// scratch first (dpcx_fused_render_bwd_recompute; the recompute mode that
// remat selects). Then:
//   (d) z-blur + DRC backward + z-blur transpose: one thread per ray walks
//       z up to form T_z, then down with the suffix
//         S_{D-1} = ddepth * 1.0,  S_{z-1} = o_z phi_z + (1 - o_z) S_z,
//         dL/do_z = T_z (phi_z - S_z),  phi_z = dsil + ddepth d_z,
//       zero where the forward clipped (o_raw >= 1 - 1e-5). The reference
//       forms the same quantity as T_z phi_z - (Total - prefix_z) / (1 - o_z),
//       where K4's Total is a separate pass; here Total is the suffix S after
//       the last step of the downward walk (S_{-1}), so K4 needs no pass of
//       its own, and the suffix form needs no division by (1 - o) down to
//       1e-5 and no difference of two nearly equal f32 sums. The taps are
//       symmetric, so the z-blur's transpose is the same z-blur. The ray's
//       o and T live in two per-thread arrays sized by a template bound:
//       512 B at D <= 64, 1 KiB at D <= 128 (local memory, bound by bytes).
//   (e) y/x blur transpose: (b) again, in place on the cotangent grid (the
//       two axes commute and each pass is its own transpose).
//   (f) splat backward: one thread per point gathers the cotangent at its
//       in-grid corners, no atomics: dw = sum h_z h_y h_x dG and
//       d(g_a) = w sum dh_a (other hats) dG, summed in the Pallas kernel's
//       grouping (below), dh = -1 / +1 on the low / high corner, and dh = 0
//       along an axis whose coordinate is an exact integer, as the
//       reference's _dhat_t gives (a floor-based form would be one-sided
//       there).
// (d) and (f) are bound by bytes like (c) and the forward splat.
//
// Operand mode (bf16 = 1: dpcx's pallas_acc_dtype "bfloat16"). The Pallas
// kernels cast their matmul operands to bfloat16 and accumulate in f32;
// here every value they type bfloat16 is rounded to nearest-even
// (__float2bfloat16_rn) where they round it, products of two rounded values
// are exact in f32, and every sum stays f32, as does the grid in device
// memory (dpcx's f32 scratch). The rounding points are K1/K2's at D <= 64
// and K3-K5's above (Mode below):
//   taps        rounded (kmat, kronA, kronB, kronz, kronzT are cast);
//   splat       a corner adds f32(rnd(rnd(h_z pw) rnd(h_y))) rnd(h_x), with
//               dpcx's hats relu(1 - |g - c|) (both);
//   blur        each pass's input rounded. K1: y, then x, then z
//               (blur_yx_kernel<true, true> blurs y first, zblur_drc_kernel
//               rounds each tap input). K3: z, then x, then y (blur_z_kernel
//               <false> first, in place, then blur_slab_kernel<true>), and
//               the DRC walk reads the fully blurred grid. The f32 mode
//               keeps x, y, z: there the order does not change the result;
//   DRC         f32;
//   backward    the DRC cotangent in f32 (the suffix form). K2: rounded
//               before the z transpose, then y, x (inputs rounded), then dG
//               rounded. K5: x, then y (inputs rounded), then the banded z
//               transpose of each z-block of dpcx's Dz rows
//               (blur_z_kernel<true>): the block's partial sums are
//               rounded, and a row in the halo of several blocks sums their
//               rounded partials in f32, which is dG (read unrounded), as
//               _blocked_bwd_kernel writes each block's transpose into its
//               own scratch and rounds what its splat backward reads. Then
//               splat_bwd_kernel<true> rounds h_y, h_x and
//               a = rnd(rnd(rnd(h_z) rnd(pw)) rnd(h_y)) (not the forward's
//               rnd(h_z pw)); h_z, dh_z and pw enter unrounded.
// The register-blocked passes (blur_run) sum each output's taps in
// ascending order as the one-tap loops did; a tap past the grid or past
// the window meets a zero (padded input or padded tap), and an FMA with a
// zero product leaves a sum bit for bit as it was, so the results are the
// loops' own.
// Bound: as the f32 mode, by bytes (CUDA cores; the tensor cores are later
// work). blur_z_kernel stages a [D, 32] tile of whole z columns of one
// (render, y) in shared memory (16 KiB at D 128) by cp.async along x,
// blurs it with blur_run and writes the columns back in place: no
// per-thread column.
//
// The launchers run on the caller's stream, allocate nothing, and return
// the first CUDA error (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxVox = 128;
constexpr int kMaxTaps = 2 * (kMaxVox - 1) + 1;  // radius <= D - 1
constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kRun = 8;  // outputs a thread forms along the blur axis
constexpr int kTapPad = 2 * kRun;  // zero taps staged on either side
constexpr int kSlabThreads = 256;  // blur_slab_kernel, blur_z_kernel
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kTileW = 32;  // blur_z_kernel: x columns a tile
constexpr int kFusedMaxVox = 64;  // above: dpcx's depth-blocked K3-K5

// The operand mode: f32; the bf16 mode of K1/K2 (D <= 64); the bf16 mode of
// K3-K5 (D > 64), whose rounding points differ (the header).
enum class Mode { kF32, kBf16, kBf16Blocked };

Mode mode_of(int bf16, int d) {
  return !bf16 ? Mode::kF32 : d > kFusedMaxVox ? Mode::kBf16Blocked
                                               : Mode::kBf16;
}

// dpcx's z-block (blocked_params): the largest of 32, 16, 8 dividing D, or
// 0 where none does (the blocked kernels refuse that D)
int z_block(int d) {
  for (int b = 32; b >= 8; b /= 2) {
    if (d % b == 0) return b;
  }
  return 0;
}

// round to the nearest bfloat16 (ties to even), back to f32
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// an operand as the mode types it: rounded in the bf16 mode
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (kBf16) {
    return rnd(v);
  } else {
    return v;
  }
}

// dpcx's trilinear hat relu(1 - |g - c|) at the low (c = floor g, t = g - c)
// and the high (c + 1) corner; in f32 1 - |t - 1| is not always t
__device__ __forceinline__ float hat(float t, int hi) {
  return hi ? 1.f - fabsf(t - 1.f) : 1.f - t;
}

// (a) coords [R, 3, N] rows (z, y, x) in grid units; weights [R, N] or null.
// A corner adds a h_x with a = (h_z pw) h_y, each operand rounded in the
// bf16 mode as the Pallas kernel's matmul operands are.
template <bool kBf16>
__global__ void splat_kernel(const float* __restrict__ coords,
                             const float* __restrict__ weights,
                             float* __restrict__ grid, int renders, int n,
                             int d) {
  const int64_t total = static_cast<int64_t>(renders) * n;
  const int64_t cells = static_cast<int64_t>(d) * d * d;
  const float top = static_cast<float>(d - 1);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / n;
    const int64_t p = i - r * n;
    const float* c = coords + r * 3 * n + p;
    const float gz = c[0], gy = c[n], gx = c[2 * static_cast<int64_t>(n)];
    const float fz = floorf(gz), fy = floorf(gy), fx = floorf(gx);
    const float tz = gz - fz, ty = gy - fy, tx = gx - fx;
    const float pw = weights != nullptr ? weights[i] : 1.f;
    float* g = grid + r * cells;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float cz = fz + dz;
      // compare as floats: far-away points must not overflow an int cast
      if (!(cz >= 0.f && cz <= top)) continue;
      const float wzp = operand<kBf16>(hat(tz, dz) * pw);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float cy = fy + dy;
        if (!(cy >= 0.f && cy <= top)) continue;
        const float a = operand<kBf16>(wzp * operand<kBf16>(hat(ty, dy)));
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float cx = fx + dx;
          if (!(cx >= 0.f && cx <= top)) continue;
          const int64_t cell =
              (static_cast<int64_t>(cz) * d + static_cast<int64_t>(cy)) * d +
              static_cast<int64_t>(cx);
          atomicAdd(g + cell, a * operand<kBf16>(hat(tx, dx)));
        }
      }
    }
  }
}

// (b) at D <= 64, one block per (render, z): blur the slab along two axes,
// in place. out[i] = sum_t in[i + t] * taps[t + radius], zero outside the
// grid. kYFirst blurs y, then x (K1's bf16 mode: dpcx's kronA @ x, then @
// kmat); else x, then y (the f32 mode). bf16 rounds each pass's input and
// the taps.
template <bool kBf16, bool kYFirst>
__global__ void __launch_bounds__(kThreads)
    blur_yx_kernel(float* __restrict__ grid, const float* __restrict__ taps,
                   int radius, int d) {
  extern __shared__ float smem[];
  float* a = smem;          // [D, D] the slab
  float* b = smem + d * d;  // [D, D] after the first pass
  float* k = b + d * d;     // [2R + 1] taps
  const int ntaps = 2 * radius + 1;
  const int dd = d * d;
  // the first pass runs along y (stride D) or x (stride 1)
  const int s1 = kYFirst ? d : 1, s2 = kYFirst ? 1 : d;
  float* slab = grid + static_cast<int64_t>(blockIdx.x) * dd;
  for (int i = threadIdx.x; i < ntaps; i += blockDim.x) {
    k[i] = operand<kBf16>(taps[i]);
  }
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    a[i] = operand<kBf16>(slab[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    const int y = i / d, x = i - y * d;
    const int c = kYFirst ? y : x;
    const int lo = max(-radius, -c), hi = min(radius, d - 1 - c);
    float s = 0.f;
    for (int t = lo; t <= hi; ++t) s += a[i + t * s1] * k[t + radius];
    b[i] = operand<kBf16>(s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dd; i += blockDim.x) {
    const int y = i / d, x = i - y * d;
    const int c = kYFirst ? x : y;
    const int lo = max(-radius, -c), hi = min(radius, d - 1 - c);
    float s = 0.f;
    for (int t = lo; t <= hi; ++t) s += b[i + t * s2] * k[t + radius];
    slab[i] = s;
  }
}

// Shared floats stage_taps fills: the 2R + 1 taps, kTapPad zeros before
// and after, and up to 3 more so that every chunk's taps start at a
// multiple of 4 floats.
__host__ __device__ constexpr int staged_taps(int radius) {
  return 2 * radius + 1 + 2 * kTapPad + 4;
}

// Where tap 0 sits in the staged taps: the taps of a chunk whose first
// input is a multiple of kRun after z0 start at first_tap + R - (kRun - 1)
// + a multiple of kRun, which this puts at a multiple of 4 floats.
__device__ __forceinline__ int first_tap(int radius) {
  return kTapPad + ((kRun - 1 - radius) & 3);
}

// The taps staged by the block into ks (16-byte aligned): tap(t) at
// ks[first_tap + R + t], zero elsewhere; bf16: rounded; kFlip: reversed,
// tap(z - i) in the transpose's tap(i - z) slot.
template <bool kBf16, bool kFlip>
__device__ void stage_taps(float* ks, const float* taps, int radius) {
  const int n = 2 * radius + 1, t0 = first_tap(radius);
  for (int i = threadIdx.x; i < staged_taps(radius); i += blockDim.x) {
    const int t = i - t0;
    ks[i] = t >= 0 && t < n ? operand<kBf16>(taps[kFlip ? n - 1 - t : t])
                            : 0.f;
  }
}

// A run of kRun outputs along one line of d cells, out[j] for the cell
// z0 + j (z0 a multiple of kRun): sum_t in(z0 + j + t) tap(t), t from -R
// to R in ascending order, inputs outside [0, d) zero; ks from
// stage_taps. The inputs come in chunks of kRun aligned to a multiple of
// kRun (load(i, c) fills c with inputs i..i + kRun - 1, zero past d), with
// the 2 kRun - 1 taps the chunk meets (four 16-byte loads), all in
// registers. kBlocks (K5's bf16 z transpose): the sum is split at
// multiples of zb (a multiple of kRun), each part is rounded to bfloat16,
// and the parts are summed in f32 in block order.
template <bool kBlocks, typename Load>
__device__ __forceinline__ void blur_run(Load load, const float* ks,
                                         int radius, int d, int z0, int zb,
                                         float (&out)[kRun]) {
  float acc[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) out[j] = acc[j] = 0.f;
  const int lo = max(z0 - radius, 0) & ~(kRun - 1);
  const int hi = min(z0 + kRun - 1 + radius, d - 1);
  const float4* kb = reinterpret_cast<const float4*>(
      ks + first_tap(radius) + radius - (kRun - 1) + lo - z0);
  // unrolled by two: a chunk's loads overlap the previous chunk's FMAs
#pragma unroll 2
  for (int ic = lo; ic <= hi; ic += kRun, kb += kRun / 4) {
    if constexpr (kBlocks) {
      if (ic % zb == 0) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          out[j] += rnd(acc[j]);
          acc[j] = 0.f;
        }
      }
    }
    float c[kRun];
    load(ic, c);
    // kk[q] is tap(m - j) for q = m - j + kRun - 1
    float kk[2 * kRun];
#pragma unroll
    for (int q = 0; q < kRun / 2; ++q) {
      const float4 v = kb[q];
      kk[4 * q] = v.x;
      kk[4 * q + 1] = v.y;
      kk[4 * q + 2] = v.z;
      kk[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        acc[j] = fmaf(c[m], kk[m - j + kRun - 1], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    out[j] = kBlocks ? out[j] + rnd(acc[j]) : acc[j];
  }
}

// 16 bytes from device to shared memory without registers (cp.async: the
// copies of a whole tile are in flight at once); copy_wait waits for the
// thread's own copies.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(src));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// round the 4 floats at v to bfloat16 in place
__device__ __forceinline__ void round4(float* v) {
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m] = rnd(v[m]);
}

// d rounded up to a whole run: the rows and columns the buffers hold
__host__ __device__ constexpr int padded(int d) {
  return (d + kRun - 1) / kRun * kRun;
}

// The slab buffer's row pitch: padded(d) + 4 floats keeps rows 16-byte
// aligned, and a quarter warp's 8 lanes on 8 rows read 16 bytes each from
// 32 different banks.
__host__ __device__ constexpr int slab_pitch(int d) { return padded(d) + 4; }

// (b) at D > 64, one block per (render, z): blur the slab along x, then y
// (the f32 mode, K3's bf16 forward and K5's bf16 transpose), in place, in
// one padded(D) x slab_pitch(D) shared buffer, zero past D. bf16 rounds
// the taps, the slab as it is staged and the x pass's outputs before the
// y pass reads them.
template <bool kBf16>
__global__ void __launch_bounds__(kSlabThreads, 3)
    blur_slab_kernel(float* __restrict__ grid, const float* __restrict__ taps,
                     int radius, int d) {
  extern __shared__ float4 smem4[];
  float* a = reinterpret_cast<float*>(smem4);  // the slab
  const int p = slab_pitch(d), dp = padded(d);
  float* ks = a + dp * p;  // the taps
  stage_taps<kBf16, false>(ks, taps, radius);
  float* slab = grid + static_cast<int64_t>(blockIdx.x) * d * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (d % 4 == 0) {  // rows of whole 16-byte pieces: copy them in flight
    for (int y = warp; y < dp; y += kSlabWarps) {
      for (int x = 4 * lane; x < dp; x += 128) {
        if (y < d && x < d) {
          copy16(a + y * p + x, slab + y * d + x);
        } else {
          *reinterpret_cast<float4*>(a + y * p + x) = {0.f, 0.f, 0.f, 0.f};
        }
      }
    }
    copy_wait();
    if constexpr (kBf16) {
      for (int y = warp; y < d; y += kSlabWarps) {
        for (int x = 4 * lane; x < d; x += 128) round4(a + y * p + x);
      }
    }
  } else {
    for (int y = warp; y < dp; y += kSlabWarps) {
      for (int x = lane; x < dp; x += 32) {
        a[y * p + x] = y < d && x < d ? operand<kBf16>(slab[y * d + x]) : 0.f;
      }
    }
  }
  __syncthreads();
  const int runs = dp / kRun;  // 9..16: at most two a warp
  const int r0 = warp, r1 = warp + kSlabWarps;
  // x: 32 rows at a time, a lane a row, warp w its runs w and w + 8; every
  // warp reads the rows before any writes them back
  for (int y0 = 0; y0 < d; y0 += 32) {
    const int y = y0 + lane;
    float* row = a + y * p;
    const auto load = [row](int i, float (&c)[kRun]) {
#pragma unroll
      for (int m = 0; m < kRun; m += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + i + m);
        c[m] = v.x;
        c[m + 1] = v.y;
        c[m + 2] = v.z;
        c[m + 3] = v.w;
      }
    };
    float o0[kRun], o1[kRun];
    const bool live = y < d;
    if (live) {
      blur_run<false>(load, ks, radius, d, r0 * kRun, 0, o0);
      if (r1 < runs) blur_run<false>(load, ks, radius, d, r1 * kRun, 0, o1);
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (r0 * kRun + j < d) row[r0 * kRun + j] = operand<kBf16>(o0[j]);
        if (r1 < runs && r1 * kRun + j < d) {
          row[r1 * kRun + j] = operand<kBf16>(o1[j]);
        }
      }
    }
  }
  __syncthreads();
  // y: a lane a column of 32, a warp a run of rows, into the slab
  const int tiles = (d + 31) / 32;
  for (int item = warp; item < tiles * runs; item += kSlabWarps) {
    const int x = item % tiles * 32 + lane, z0 = item / tiles * kRun;
    if (x >= d) continue;
    float o[kRun];
    blur_run<false>(
        [a, p, x](int i, float (&c)[kRun]) {
#pragma unroll
          for (int m = 0; m < kRun; ++m) c[m] = a[(i + m) * p + x];
        },
        ks, radius, d, z0, 0, o);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (z0 + j < d) slab[(z0 + j) * d + x] = o[j];
    }
  }
}

// K3's bf16 z pass (kBlocks false) and K5's bf16 banded z transpose per
// z-block of zb rows (kBlocks), in place: one block per (render, y, 32
// consecutive x) stages the tile of whole z columns, each value rounded,
// in shared memory (zero past D in x), and a lane blurs its column's runs
// of 8 with rounded taps. The transpose: block k (rows [k zb, k zb + zb))
// reaches raw rows [k zb - R, k zb + zb + R); row r takes, from each block
// whose raw range holds it, rnd(sum over the block's rows i of
// c_i tap(r - i)), and sums those in f32.
template <bool kBlocks>
__global__ void __launch_bounds__(kSlabThreads)
    blur_z_kernel(float* __restrict__ grid, const float* __restrict__ taps,
                  int radius, int d, int zb) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);  // [padded(D), kTileW]
  const int dp = padded(d);
  float* ks = t + dp * kTileW;
  stage_taps<true, kBlocks>(ks, taps, radius);
  const int tiles = (d + kTileW - 1) / kTileW;
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ry = blockIdx.x / tiles;  // render * d + y
  const int64_t r = ry / d;
  const int x0 = static_cast<int>(blockIdx.x % tiles) * kTileW;
  float* base = grid + r * dd * d + (ry - r * d) * d + x0;
  // D % 8 == 0 (the bf16 mode above D 64), so dp is D and a z row of the
  // tile is 8 whole 16-byte pieces, in flight at once; past D, zeros
  {
    const int f = 4 * (threadIdx.x & 7);
    for (int z = threadIdx.x >> 3; z < d; z += kSlabThreads / 8) {
      if (x0 + f < d) {
        copy16(t + z * kTileW + f, base + z * dd + f);
      } else {
        *reinterpret_cast<float4*>(t + z * kTileW + f) = {0.f, 0.f, 0.f, 0.f};
      }
    }
    copy_wait();
    for (int z = threadIdx.x >> 3; z < d; z += kSlabThreads / 8) {
      round4(t + z * kTileW + f);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = x0 + lane < d;
  float* col = base + lane;
  if (!live) return;
  const int runs = dp / kRun;
  for (int run = warp; run < runs; run += kSlabWarps) {
    const int z0 = run * kRun;
    float o[kRun];
    blur_run<kBlocks>(
        [t, lane](int i, float (&c)[kRun]) {
#pragma unroll
          for (int m = 0; m < kRun; ++m) c[m] = t[(i + m) * kTileW + lane];
        },
        ks, radius, d, z0, zb, o);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (z0 + j < d) col[(z0 + j) * dd] = o[j];
    }
  }
}

// (c) one thread per ray (render, y, x): z-blur on the fly (kZBlur; bf16:
// each tap input rounded), then DRC in f32. Without kZBlur the grid is the
// fully blurred one (K3's bf16 mode) and the taps are not read.
template <bool kBf16, bool kZBlur>
__global__ void zblur_drc_kernel(const float* __restrict__ grid,
                                 const float* __restrict__ taps, int radius,
                                 float* __restrict__ sil,
                                 float* __restrict__ depth, int renders,
                                 int d, int with_depth) {
  __shared__ float k[kMaxTaps];
  if constexpr (kZBlur) {
    for (int i = threadIdx.x; i < 2 * radius + 1; i += blockDim.x) {
      k[i] = operand<kBf16>(taps[i]);
    }
  }
  __syncthreads();
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ray = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (ray >= renders * dd) return;
  const int64_t r = ray / dd;
  const float* col = grid + r * dd * d + (ray - r * dd);
  const float fd = static_cast<float>(d);
  float trans = 1.f, s = 0.f, dep = 0.f;
  for (int z = 0; z < d; ++z) {
    float o = 0.f;
    if constexpr (kZBlur) {
      const int lo = max(-radius, -z), hi = min(radius, d - 1 - z);
      for (int t = lo; t <= hi; ++t) {
        o += operand<kBf16>(col[(z + t) * dd]) * k[t + radius];
      }
    } else {
      o = col[z * dd];
    }
    o = fminf(fmaxf(o, 0.f), 1.f - 1e-5f);
    const float p = o * trans;
    s += p;
    if (with_depth) dep += ((static_cast<float>(z) + 0.5f) / fd - 0.5f) * p;
    trans *= 1.f - o;
  }
  sil[ray] = s;
  if (with_depth) depth[ray] = dep + 1.f * trans;
}

// (d) one thread per ray: z-blur of the y/x-blurred grid, DRC backward, and
// the z-blur's transpose into dgrid. dsil, ddepth [R, D, D]; ddepth may be
// null (a zero cotangent). kMaxD bounds D and sizes the per-ray arrays, so
// the D <= 64 instantiation keeps a 512 B frame. bf16: the z-blur's inputs
// and taps are rounded as in (c), and dL/do before its transpose.
template <int kMaxD, bool kBf16>
__global__ void zblur_drc_bwd_kernel(const float* __restrict__ grid,
                                     const float* __restrict__ taps,
                                     int radius,
                                     const float* __restrict__ dsil,
                                     const float* __restrict__ ddepth,
                                     float* __restrict__ dgrid, int renders,
                                     int d, int with_depth) {
  __shared__ float k[2 * kMaxD - 1];
  for (int i = threadIdx.x; i < 2 * radius + 1; i += blockDim.x) {
    k[i] = operand<kBf16>(taps[i]);
  }
  __syncthreads();
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ray = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (ray >= renders * dd) return;
  const int64_t r = ray / dd;
  const int64_t off = r * dd * d + (ray - r * dd);
  const float* col = grid + off;
  const float fd = static_cast<float>(d);
  constexpr float kTop = 1.f - 1e-5f;
  float o[kMaxD];  // raw occupancy, then dL/do_raw
  float tr[kMaxD];  // transmittance before z
  float trans = 1.f;
  for (int z = 0; z < d; ++z) {
    const int lo = max(-radius, -z), hi = min(radius, d - 1 - z);
    float s = 0.f;
    for (int t = lo; t <= hi; ++t) {
      s += operand<kBf16>(col[(z + t) * dd]) * k[t + radius];
    }
    o[z] = s;
    tr[z] = trans;
    trans *= 1.f - fminf(fmaxf(s, 0.f), kTop);
  }
  const float gs = dsil[ray];
  const float gd = (with_depth && ddepth != nullptr) ? ddepth[ray] : 0.f;
  float suffix = gd * 1.f;  // background depth 1.0 past the volume
  for (int z = d - 1; z >= 0; --z) {
    const float raw = o[z];
    const float oc = fminf(fmaxf(raw, 0.f), kTop);
    const float phi = gs + gd * ((static_cast<float>(z) + 0.5f) / fd - 0.5f);
    o[z] = operand<kBf16>(raw < kTop ? tr[z] * (phi - suffix) : 0.f);
    suffix = oc * phi + (1.f - oc) * suffix;
  }
  float* dcol = dgrid + off;
  for (int z = 0; z < d; ++z) {
    const int lo = max(-radius, -z), hi = min(radius, d - 1 - z);
    float s = 0.f;
    for (int t = lo; t <= hi; ++t) s += o[z + t] * k[t + radius];
    dcol[z * dd] = s;
  }
}

// (d) in K5's bf16 mode: the grid is the fully blurred one, so one thread per
// ray runs the DRC backward alone, into dgrid: the walk up stores T_z in
// dgrid's column, the walk down (the suffix form, f32) replaces it by dL/do
// (zero where the forward clipped). No per-thread array.
__global__ void drc_bwd_kernel(const float* __restrict__ grid,
                               const float* __restrict__ dsil,
                               const float* __restrict__ ddepth,
                               float* __restrict__ dgrid, int renders, int d,
                               int with_depth) {
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ray = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (ray >= renders * dd) return;
  const int64_t r = ray / dd;
  const int64_t off = r * dd * d + (ray - r * dd);
  const float* col = grid + off;
  float* dcol = dgrid + off;
  const float fd = static_cast<float>(d);
  constexpr float kTop = 1.f - 1e-5f;
  float trans = 1.f;
  for (int z = 0; z < d; ++z) {
    dcol[z * dd] = trans;
    trans *= 1.f - fminf(fmaxf(col[z * dd], 0.f), kTop);
  }
  const float gs = dsil[ray];
  const float gd = (with_depth && ddepth != nullptr) ? ddepth[ray] : 0.f;
  float suffix = gd * 1.f;  // background depth 1.0 past the volume
  for (int z = d - 1; z >= 0; --z) {
    const float raw = col[z * dd];
    const float oc = fminf(fmaxf(raw, 0.f), kTop);
    const float phi = gs + gd * ((static_cast<float>(z) + 0.5f) / fd - 0.5f);
    dcol[z * dd] = raw < kTop ? dcol[z * dd] * (phi - suffix) : 0.f;
    suffix = oc * phi + (1.f - oc) * suffix;
  }
}

// (f) one thread per point: d(z, y, x) into dcoords [R, 3, N] and, when
// dweights is not null, dw into dweights [R, N]. Reduced as the Pallas
// kernel does: per z corner P = sum_y v h_y and Q = sum_y v dh_y with
// v = sum_x dG h_x, per x corner t1 = sum_zy dG a with a = (h_z pw) h_y;
// then d z = pw sum dh_z P, d y = pw sum h_z Q, d x = sum dh_x t1 and
// dw = sum h_z P. The bf16 mode rounds h_y, h_x and a's operands
// (rnd(rnd(h_z) rnd(pw)), not the forward's rnd(h_z pw)), and dG with
// kRoundDg (K2's; K5's dG is a sum of rounded partials); h_z, dh_z, pw
// enter the sums unrounded.
template <bool kBf16, bool kRoundDg>
__global__ void splat_bwd_kernel(const float* __restrict__ coords,
                                 const float* __restrict__ weights,
                                 const float* __restrict__ dgrid,
                                 float* __restrict__ dcoords,
                                 float* __restrict__ dweights, int renders,
                                 int n, int d) {
  const int64_t total = static_cast<int64_t>(renders) * n;
  const int64_t cells = static_cast<int64_t>(d) * d * d;
  const float top = static_cast<float>(d - 1);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / n;
    const int64_t p = i - r * n;
    const float* c = coords + r * 3 * n + p;
    const float gz = c[0], gy = c[n], gx = c[2 * static_cast<int64_t>(n)];
    const float fz = floorf(gz), fy = floorf(gy), fx = floorf(gx);
    const float tz = gz - fz, ty = gy - fy, tx = gx - fx;
    const float* g = dgrid + r * cells;
    const float pw = weights != nullptr ? weights[i] : 1.f;
    float az = 0.f, ay = 0.f, aw = 0.f;
    float t1[2] = {0.f, 0.f};
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float cz = fz + dz;
      if (!(cz >= 0.f && cz <= top)) continue;
      const float hz = hat(tz, dz);
      // dh = -1 / +1 on the low / high corner, 0 at an integer coordinate
      const float sz = tz == 0.f ? 0.f : (dz ? 1.f : -1.f);
      const float hzp = operand<kBf16>(operand<kBf16>(hz) *
                                       operand<kBf16>(pw));
      float pz = 0.f, qz = 0.f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float cy = fy + dy;
        if (!(cy >= 0.f && cy <= top)) continue;
        const float hy = operand<kBf16>(hat(ty, dy));
        const float sy = ty == 0.f ? 0.f : (dy ? 1.f : -1.f);
        const float a = operand<kBf16>(hzp * hy);
        float v = 0.f;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float cx = fx + dx;
          if (!(cx >= 0.f && cx <= top)) continue;
          const int64_t cell =
              (static_cast<int64_t>(cz) * d + static_cast<int64_t>(cy)) * d +
              static_cast<int64_t>(cx);
          const float dg = operand<kRoundDg>(g[cell]);
          v += dg * operand<kBf16>(hat(tx, dx));
          t1[dx] += dg * a;
        }
        pz += v * hy;
        qz += v * sy;
      }
      az += sz * pz;
      ay += hz * qz;
      aw += hz * pz;
    }
    const float sx = tx == 0.f ? 0.f : 1.f;
    float* out = dcoords + r * 3 * n + p;
    out[0] = az * pw;
    out[n] = ay * pw;
    out[2 * static_cast<int64_t>(n)] = (t1[1] - t1[0]) * sx;
    if (dweights != nullptr) dweights[i] = aw;
  }
}

int64_t splat_blocks(int64_t points) {
  const int64_t blocks = (points + kThreads - 1) / kThreads;
  return blocks > 65535 * 16 ? 65535 * 16 : blocks;
}

bool bad_args(int renders, int n, int d, int radius, int bf16) {
  return d < 1 || d > kMaxVox || radius < 0 || radius > d - 1 ||
         renders < 0 || n < 0 ||
         (mode_of(bf16, d) == Mode::kBf16Blocked && z_block(d) == 0);
}

// one thread per ray (render, y, x)
unsigned ray_blocks(int renders, int d) {
  const int64_t rays = static_cast<int64_t>(renders) * d * d;
  return static_cast<unsigned>((rays + kThreads - 1) / kThreads);
}

// (b) at D > 64 on every slab of grid [R, D, D, D], in place: three blocks
// an SM at D 128 (67,860 bytes each with the taps at R 16), which needs the
// shared-memory carveout at its largest and the kernel's limit raised
// above the 48 KiB default.
template <bool kBf16>
cudaError_t launch_blur_slab(float* grid, const float* taps, int radius,
                             int renders, int d, cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(padded(d)) * slab_pitch(d) +
                       staged_taps(radius)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      blur_slab_kernel<kBf16>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(blur_slab_kernel<kBf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  blur_slab_kernel<kBf16><<<static_cast<unsigned>(renders * d), kSlabThreads,
                            smem, s>>>(grid, taps, radius, d);
  return cudaGetLastError();
}

// (b) on every slab of grid [R, D, D, D], in place, in the order of the
// mode: y then x for K1's bf16 mode, else x then y (blur_slab_kernel above
// D 64; at most 32 KiB of shared memory at D <= 64).
cudaError_t launch_blur_yx(Mode m, float* grid, const float* taps,
                           int radius, int renders, int d, cudaStream_t s) {
  if (d > kFusedMaxVox) {
    return m == Mode::kF32
               ? launch_blur_slab<false>(grid, taps, radius, renders, d, s)
               : launch_blur_slab<true>(grid, taps, radius, renders, d, s);
  }
  const size_t smem =
      (2 * static_cast<size_t>(d) * d + 2 * radius + 1) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>(renders * d);
  if (m == Mode::kBf16) {
    blur_yx_kernel<true, true><<<blocks, kThreads, smem, s>>>(grid, taps,
                                                              radius, d);
  } else {
    blur_yx_kernel<false, false><<<blocks, kThreads, smem, s>>>(grid, taps,
                                                                radius, d);
  }
  return cudaGetLastError();
}

// K3's bf16 z pass or K5's bf16 z transpose (kBlocks), in place.
template <bool kBlocks>
cudaError_t launch_blur_z(float* grid, const float* taps, int radius,
                          int renders, int d, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(padded(d)) * kTileW + staged_taps(radius)) *
      sizeof(float);
  const unsigned blocks = static_cast<unsigned>(
      renders * d * ((d + kTileW - 1) / kTileW));
  blur_z_kernel<kBlocks><<<blocks, kSlabThreads, smem, s>>>(
      grid, taps, radius, d, z_block(d));
  return cudaGetLastError();
}

// (a) + (b): the grid the DRC walk reads, into the scratch grid: x/y-blurred
// (f32, K1's bf16), or fully blurred with the z pass first (K3's bf16).
cudaError_t launch_grid(Mode m, const float* coords, const float* weights,
                        const float* taps, int radius, float* grid,
                        int renders, int n, int d, cudaStream_t s) {
  const size_t cells = static_cast<size_t>(renders) * d * d * d;
  cudaError_t err = cudaMemsetAsync(grid, 0, cells * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const int64_t points = static_cast<int64_t>(renders) * n;
  if (points > 0) {
    const unsigned blocks = static_cast<unsigned>(splat_blocks(points));
    if (m == Mode::kF32) {
      splat_kernel<false><<<blocks, kThreads, 0, s>>>(coords, weights, grid,
                                                      renders, n, d);
    } else {
      splat_kernel<true><<<blocks, kThreads, 0, s>>>(coords, weights, grid,
                                                     renders, n, d);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (m == Mode::kBf16Blocked) {
    err = launch_blur_z<false>(grid, taps, radius, renders, d, s);
    if (err != cudaSuccess) return err;
  }
  return launch_blur_yx(m, grid, taps, radius, renders, d, s);
}

// (c): the DRC (after the z-blur, where the grid is only x/y-blurred).
cudaError_t launch_drc(Mode m, const float* grid, const float* taps,
                       int radius, float* sil, float* depth, int renders,
                       int d, int with_depth, cudaStream_t s) {
  const unsigned blocks = ray_blocks(renders, d);
  switch (m) {
    case Mode::kF32:
      zblur_drc_kernel<false, true><<<blocks, kThreads, 0, s>>>(
          grid, taps, radius, sil, depth, renders, d, with_depth);
      break;
    case Mode::kBf16:
      zblur_drc_kernel<true, true><<<blocks, kThreads, 0, s>>>(
          grid, taps, radius, sil, depth, renders, d, with_depth);
      break;
    case Mode::kBf16Blocked:
      zblur_drc_kernel<false, false><<<blocks, kThreads, 0, s>>>(
          grid, taps, radius, sil, depth, renders, d, with_depth);
      break;
  }
  return cudaGetLastError();
}

// (d) + (e) + (f) on the grid launch_grid makes.
cudaError_t launch_bwd_stages(Mode m, const float* coords,
                              const float* weights, const float* taps,
                              int radius, const float* grid,
                              const float* dsil, const float* ddepth,
                              float* dgrid, float* dcoords, float* dweights,
                              int renders, int n, int d, int with_depth,
                              cudaStream_t s) {
  const unsigned blocks = ray_blocks(renders, d);
  const unsigned point_blocks = static_cast<unsigned>(
      splat_blocks(static_cast<int64_t>(renders) * n));
  cudaError_t err;
  if (m == Mode::kBf16Blocked) {
    drc_bwd_kernel<<<blocks, kThreads, 0, s>>>(grid, dsil, ddepth, dgrid,
                                               renders, d, with_depth);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = launch_blur_yx(m, dgrid, taps, radius, renders, d, s);
    if (err != cudaSuccess) return err;
    err = launch_blur_z<true>(dgrid, taps, radius, renders, d, s);
    if (err != cudaSuccess || n == 0) return err;
    splat_bwd_kernel<true, false><<<point_blocks, kThreads, 0, s>>>(
        coords, weights, dgrid, dcoords, dweights, renders, n, d);
    return cudaGetLastError();
  }
  const bool bf16 = m == Mode::kBf16;
  if (d <= kFusedMaxVox) {
    if (bf16) {
      zblur_drc_bwd_kernel<kFusedMaxVox, true><<<blocks, kThreads, 0, s>>>(
          grid, taps, radius, dsil, ddepth, dgrid, renders, d, with_depth);
    } else {
      zblur_drc_bwd_kernel<kFusedMaxVox, false><<<blocks, kThreads, 0, s>>>(
          grid, taps, radius, dsil, ddepth, dgrid, renders, d, with_depth);
    }
  } else {
    zblur_drc_bwd_kernel<kMaxVox, false><<<blocks, kThreads, 0, s>>>(
        grid, taps, radius, dsil, ddepth, dgrid, renders, d, with_depth);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_blur_yx(m, dgrid, taps, radius, renders, d, s);
  if (err != cudaSuccess || n == 0) return err;
  if (bf16) {
    splat_bwd_kernel<true, true><<<point_blocks, kThreads, 0, s>>>(
        coords, weights, dgrid, dcoords, dweights, renders, n, d);
  } else {
    splat_bwd_kernel<false, false><<<point_blocks, kThreads, 0, s>>>(
        coords, weights, dgrid, dcoords, dweights, renders, n, d);
  }
  return cudaGetLastError();
}

}  // namespace

// Forward. grid: scratch [R, D, D, D] f32 that holds the grid the DRC walk
// read afterwards (x/y-blurred; fully blurred in K3's bf16 mode); sil,
// depth: [R, D, D] f32 (depth may be null when with_depth is 0); bf16: the
// operand mode (1: bfloat16; above D 64, D % 8 == 0). Returns a cudaError_t
// as int.
extern "C" int dpcx_fused_render(const float* coords, const float* weights,
                                 const float* taps, int radius, float* grid,
                                 float* sil, float* depth, int renders, int n,
                                 int d, int with_depth, int bf16,
                                 void* stream) {
  if (bad_args(renders, n, d, radius, bf16) ||
      (with_depth && depth == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (renders == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mode m = mode_of(bf16, d);
  cudaError_t err =
      launch_grid(m, coords, weights, taps, radius, grid, renders, n, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_drc(m, grid, taps, radius, sil, depth,
                                     renders, d, with_depth, s));
}

// Backward, saved-grid mode. grid: the forward's grid [R, D, D, D] (read
// only); dgrid: scratch [R, D, D, D]; dsil [R, D, D];
// ddepth [R, D, D] or null (zero); dcoords out [R, 3, N] (z, y, x);
// dweights out [R, N] or null (not wanted). weights null means every point
// weighs 1; bf16 as the forward's. Returns a cudaError_t as int.
extern "C" int dpcx_fused_render_bwd(const float* coords, const float* weights,
                                     const float* taps, int radius,
                                     const float* grid, const float* dsil,
                                     const float* ddepth, float* dgrid,
                                     float* dcoords, float* dweights,
                                     int renders, int n, int d, int with_depth,
                                     int bf16, void* stream) {
  if (bad_args(renders, n, d, radius, bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (renders == 0) return 0;
  return static_cast<int>(launch_bwd_stages(
      mode_of(bf16, d), coords, weights, taps, radius, grid, dsil, ddepth,
      dgrid, dcoords, dweights, renders, n, d, with_depth,
      static_cast<cudaStream_t>(stream)));
}

// Backward, recompute mode: as dpcx_fused_render_bwd, but grid is scratch
// [R, D, D, D] that is first re-splatted and re-blurred from coords, weights
// and taps, as the forward made it.
extern "C" int dpcx_fused_render_bwd_recompute(
    const float* coords, const float* weights, const float* taps, int radius,
    float* grid, const float* dsil, const float* ddepth, float* dgrid,
    float* dcoords, float* dweights, int renders, int n, int d,
    int with_depth, int bf16, void* stream) {
  if (bad_args(renders, n, d, radius, bf16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (renders == 0) return 0;
  const cudaError_t err =
      launch_grid(mode_of(bf16, d), coords, weights, taps, radius, grid,
                  renders, n, d, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return dpcx_fused_render_bwd(coords, weights, taps, radius, grid, dsil,
                               ddepth, dgrid, dcoords, dweights, renders, n,
                               d, with_depth, bf16, stream);
}
