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
//   (a) splat: 8 atomicAdds a point and render into a zeroed f32 grid
//       [R, D, D, D] in device memory (R = renders). Bound by atomics:
//       8 per point, contended where many points share a cell. The points
//       come as world clouds [C, N, 3] with each render's camera: a thread
//       takes one point of a cloud, reads it once, and for each of the
//       cloud's R / C renders runs dpcx's camera transform (rotation,
//       translation, perspective divide with its clamp) and the NDC -> grid
//       affine in registers before it splats. No coordinate tensor, and no
//       batched 3x3 GEMM, reaches device memory.
//   (b) blur y and x (blur_slab_kernel): one block per (render, z) holds
//       the slab in one buffer of padded(D) rows of slab_pitch(D) floats
//       (17 KiB at D 64, 66 KiB at D 128, where three blocks share an SM
//       and one block's loads overlap another's arithmetic), staged by
//       cp.async, all of it in flight at once. Register blocking
//       (blur_run): a thread forms a run of 8 consecutive outputs from
//       aligned chunks of 8 inputs and the 15 taps they meet, 6-12 shared
//       loads (16-byte ones where the data is contiguous) per 64 FMAs
//       instead of one load per FMA. A block has a warp for each run of a
//       line at D <= 64 (padded(D) / 8 warps) and 8 warps above. The first
//       pass runs in place, 32 lines at a time (a lane a line), and holds
//       its runs in registers until every warp has read those lines. The
//       second writes to device memory: the y pass straight (a lane a
//       column); the x pass (K1's bf16 order, y first) in place, then the
//       slab is copied out.
//   (c) blur z (blur_z_kernel), in place, at every D and in both modes:
//       one block per (render, y, 32 consecutive x) stages a [padded(D),
//       32] tile of whole z columns in shared memory and blurs it with
//       blur_run, a warp a run; no per-thread column.
//   (d) DRC (zblur_drc_kernel): one thread per ray (render, y, x) walks z
//       on the fully blurred grid, one value a z step, and carries T, sil
//       and depth in registers; a warp reads 32 neighbouring x, so the
//       reads coalesce.
// (b)-(d) are bound by bytes: the grid is written by (a), read and written
// by (b) and (c), and read by (d); at D 64 a pass over 32 renders reads and
// writes 33.5 MB each way, at least 0.020 ms at 3.35 TB/s; at D 128 over
// 16 renders, 134 MB each way, 0.080 ms against 0.031 ms for its FMAs at
// 67 TFLOP/s.
//
// Backward. Replaces dpcx/render/pallas_kernel.py::_fused_bwd_kernel (K2,
// D <= 64) and the two passes of the depth-blocked backward,
// dpcx/render/pallas_blocked.py::_blocked_total_kernel (K4: per-ray Total)
// and ::_blocked_bwd_kernel (K5: dL/do_z, the blur transposes, the splat
// backward): the gradient of (sil, depth) with respect to each point's
// (z, y, x, w) in grid units, carried back to the world clouds and the
// cameras. The TPU kernels recompute the grid because a second D^3 buffer
// does not fit in VMEM. Here the forward's grid may stay in device memory as
// the residual (the saved-grid mode), or the backward re-splats and
// re-blurs into fresh scratch first (recompute 1 of
// dpcx_fused_render_world_bwd; the recompute mode that remat selects). On
// the fully blurred grid:
//   (e) DRC backward (drc_bwd_kernel): one thread per ray walks z up to
//       form T_z, then down with the suffix
//         S_{D-1} = ddepth * 1.0,  S_{z-1} = o_z phi_z + (1 - o_z) S_z,
//         dL/do_z = T_z (phi_z - S_z),  phi_z = dsil + ddepth d_z,
//       zero where the forward clipped (o_raw >= 1 - 1e-5), into dgrid. The
//       reference forms the same quantity as T_z phi_z - (Total - prefix_z)
//       / (1 - o_z), where K4's Total is a separate pass; here Total is the
//       suffix S after the last step of the downward walk (S_{-1}), so K4
//       needs no pass of its own, and the suffix form needs no division by
//       (1 - o) down to 1e-5 and no difference of two nearly equal f32
//       sums. At D <= 64 (drc_bwd_kernel) T_z waits in shared memory
//       ([D][128] floats, 32 KiB at D 64: the grid is read twice and dgrid
//       written once). Above (drc_bwd_tile_kernel) a warp stages a tile of
//       32 whole z columns in shared memory with 16-byte cp.async copies
//       and keeps every 8th T_z beside it; the walk down forms the 7
//       between again from it by the same products, so the grid is read
//       once and dgrid written once, coalesced across x.
//   (f) the blur transposes, in place on dgrid: the z transpose
//       (blur_z_kernel<true, ...>, which reads the taps reversed, tap(z - i);
//       dpcx's taps are symmetric) and the y/x transpose (blur_slab_kernel;
//       the two axes commute and each pass is its own transpose).
//   (g) splat backward: one thread per point gathers the cotangent at its
//       in-grid corners, no atomics: dw = sum h_z h_y h_x dG and
//       d(g_a) = w sum dh_a (other hats) dG, summed in the Pallas kernel's
//       grouping (below), dh = -1 / +1 on the low / high corner, and dh = 0
//       along an axis whose coordinate is an exact integer, as the
//       reference's _dhat_t gives (a floor-based form would be one-sided
//       there). The thread projects the point again, as the forward did,
//       carries d(grid) through the affine, the divide and the clamp and
//       the transposed rotation, and sums the cloud's renders in registers
//       into d points [C, N, 3] and d weights [C, N], each written once;
//       where the cameras want a gradient, d rot and d trans of each render
//       are summed over a warp by shuffles, one atomicAdd a value a warp.
// (e) and (g) are bound by bytes like (d) and the forward splat.
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
//   blur        each pass's input rounded. K1: y, then x
//               (blur_slab_kernel<true, true>: the staged slab and the y
//               pass's outputs rounded), then z (blur_z_kernel<false, true,
//               false>: the staged tile rounded). K3: z, then x, then y
//               (blur_z_kernel first, then blur_slab_kernel<true, false>).
//               The DRC walk reads the fully blurred grid. The f32 mode
//               keeps x, y, z: there the order does not change the result;
//   DRC         f32;
//   backward    the DRC cotangent in f32 (the suffix form). K2: rounded as
//               the z transpose stages it, then y, x (inputs rounded), then
//               dG rounded. K5: x, then y (inputs rounded), then the banded
//               z transpose of each z-block of dpcx's Dz rows
//               (blur_z_kernel<true, true, true>): the block's partial sums
//               are rounded, and a row in the halo of several blocks sums
//               their rounded partials in f32, which is dG (read unrounded),
//               as _blocked_bwd_kernel writes each block's transpose into its
//               own scratch and rounds what its splat backward reads. Then
//               splat_bwd_kernel<true> rounds h_y, h_x and
//               a = rnd(rnd(rnd(h_z) rnd(pw)) rnd(h_y)) (not the forward's
//               rnd(h_z pw)); h_z, dh_z and pw enter unrounded.
// The register-blocked passes (blur_run) sum each output's taps in
// ascending order as the one-tap loops they replaced did; a tap past the
// grid or past the window meets a zero (padded input or padded tap), and an
// FMA with a zero product leaves a sum bit for bit as it was, so the
// results are the loops' own. A z pass stores the f32 value the fused walks
// formed in registers, so the walks on the stored grid give their results
// too. Bound: as the f32 mode, by bytes (CUDA cores; the tensor cores are
// later work).
//
// The launchers run on the caller's stream, allocate nothing, and return
// the first CUDA error (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxVox = 128;
constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kRun = 8;  // outputs a thread forms along the blur axis
constexpr int kTapPad = 2 * kRun;  // zero taps staged on either side
constexpr int kSlabThreads = 256;  // blur_slab_kernel, blur_z_kernel
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kTileW = 32;  // blur_z_kernel: x columns a tile
constexpr int kFusedMaxVox = 64;  // above: dpcx's depth-blocked K3-K5
constexpr int kDrcThreads = 128;  // drc_bwd_kernel: 32 KiB of T at D 64
constexpr int kDrcTileWarps = 4;  // drc_bwd_tile_kernel: tiles a block

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

// The points of the splat stages as world clouds: points [C, N, 3], and
// render r's camera, rot [R, 3, 3] (p_cam = rot p + trans) and trans [R, 3]
// or null, with the focal length and the camera distance. Render r reads
// cloud r / per_cloud (per_cloud = R / C).
struct World {
  const float* points;
  const float* rot;
  const float* trans;
  float focal, dist;
  int per_cloud;
};

constexpr float kMinDepth = 1e-2f;  // the perspective divide's clamp

// One point seen by render r's camera, in the f32 operations of
// render/transform.py::pc_perspective_transform_t and the NDC -> grid affine
// of render/fused.py: the rotation's 3-term sums as FMAs in the order a
// GEMM accumulates them, then, with nothing contracted, + trans, z + dist
// clamped below at kMinDepth (NaN passes, as clamp_min), x f / z and
// y f / z, and (ndc + 0.5) D - 0.5 per axis.
struct Projected {
  float cam[3];   // the camera-frame point
  float xn, yn;   // its NDC x and y
  float zs;       // z + dist, clamped
  bool clamped;   // z + dist below the clamp: no gradient reaches it
  float g[3];     // grid coordinates, rows (z, y, x)
};

__device__ __forceinline__ float to_grid(float ndc, float fd) {
  return __fsub_rn(__fmul_rn(__fadd_rn(ndc, 0.5f), fd), 0.5f);
}

__device__ __forceinline__ Projected project(const World& w, int64_t r,
                                             float px, float py, float pz,
                                             float fd) {
  Projected q;
  const float* m = w.rot + r * 9;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    q.cam[j] = fmaf(__ldg(m + 3 * j + 2), pz,
                    fmaf(__ldg(m + 3 * j + 1), py,
                         __fmul_rn(__ldg(m + 3 * j), px)));
    if (w.trans != nullptr) {
      q.cam[j] = __fadd_rn(q.cam[j], __ldg(w.trans + r * 3 + j));
    }
  }
  const float zf = __fadd_rn(q.cam[2], w.dist);
  q.clamped = !(zf >= kMinDepth);
  q.zs = zf < kMinDepth ? kMinDepth : zf;
  q.xn = __fdiv_rn(__fmul_rn(q.cam[0], w.focal), q.zs);
  q.yn = __fdiv_rn(__fmul_rn(q.cam[1], w.focal), q.zs);
  q.g[0] = to_grid(q.cam[2], fd);
  q.g[1] = to_grid(q.yn, fd);
  q.g[2] = to_grid(q.xn, fd);
  return q;
}

// (a) for one point of one render: grid g [D, D, D]; (gz, gy, gx) in grid
// units; weight pw. A corner adds a h_x with a = (h_z pw) h_y, each operand
// rounded in the bf16 mode as the Pallas kernel's matmul operands are.
template <bool kBf16>
__device__ __forceinline__ void splat_point(float* __restrict__ g, float gz,
                                            float gy, float gx, float pw,
                                            int d) {
  const float top = static_cast<float>(d - 1);
  const float fz = floorf(gz), fy = floorf(gy), fx = floorf(gx);
  const float tz = gz - fz, ty = gy - fy, tx = gx - fx;
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

// (a) from world clouds (World): one thread per (cloud, point) reads the
// point and its weight (weights [C, N] or null) once and splats it into
// each of the cloud's per_cloud renders through that render's camera.
// Bound by contended atomics: the launch bounds keep its registers, so
// that as many atomics are in flight.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    splat_kernel(World w, const float* __restrict__ weights,
                             float* __restrict__ grid, int renders, int n,
                             int d) {
  const int64_t total = static_cast<int64_t>(renders / w.per_cloud) * n;
  const int64_t cells = static_cast<int64_t>(d) * d * d;
  const float fd = static_cast<float>(d);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t c = i / n;
    const float* p = w.points + 3 * i;
    const float px = p[0], py = p[1], pz = p[2];
    const float pw = weights != nullptr ? weights[i] : 1.f;
    for (int s = 0; s < w.per_cloud; ++s) {
      const int64_t r = c * w.per_cloud + s;
      const Projected q = project(w, r, px, py, pz, fd);
      splat_point<kBf16>(grid + r * cells, q.g[0], q.g[1], q.g[2], pw, d);
    }
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

// The threads of a blur_slab_kernel or blur_z_kernel block: a warp for
// each run of a line at D <= 64 (padded(D) / kRun warps), kSlabWarps above.
__host__ __device__ constexpr int slab_threads(int d) {
  return 32 * (padded(d) / kRun < kSlabWarps ? padded(d) / kRun : kSlabWarps);
}

// One pass of the slab in place in its shared buffer a (pitch p, zero past
// D): along x (kAlongX; a lane a row, 16-byte loads) or along y (a lane a
// column). 32 lines at a time, warp w forms its runs w and w + nw of each
// line (nw = kSlabWarps, at most 2 nw runs; kOneRun: a warp a run, nw from
// the block's size, run w alone, which frees the second run's registers)
// and holds them in registers
// until every warp has read those lines, then writes them back, rounded
// with kRound. Lines are independent, so the next 32 need no second
// barrier; the caller's __syncthreads ends the pass.
template <bool kAlongX, bool kRound, bool kOneRun>
__device__ __forceinline__ void pass_in_place(float* a, int p, const float* ks,
                                              int radius, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = kOneRun ? blockDim.x >> 5 : kSlabWarps;
  const int runs = padded(d) / kRun;
  const int r0 = warp, r1 = warp + nw;
  for (int l0 = 0; l0 < d; l0 += 32) {
    const int l = l0 + lane;  // the lane's row (x pass) or column (y pass)
    const auto load = [a, p, l](int i, float (&c)[kRun]) {
      if constexpr (kAlongX) {
#pragma unroll
        for (int m = 0; m < kRun; m += 4) {
          const float4 v = *reinterpret_cast<const float4*>(a + l * p + i + m);
          c[m] = v.x;
          c[m + 1] = v.y;
          c[m + 2] = v.z;
          c[m + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < kRun; ++m) c[m] = a[(i + m) * p + l];
      }
    };
    float o0[kRun], o1[kOneRun ? 1 : kRun];
    const bool live = l < d;
    if (live) {
      if (r0 < runs) blur_run<false>(load, ks, radius, d, r0 * kRun, 0, o0);
      if constexpr (!kOneRun) {
        if (r1 < runs) blur_run<false>(load, ks, radius, d, r1 * kRun, 0, o1);
      }
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int i0 = r0 * kRun + j, i1 = r1 * kRun + j;
        if (r0 < runs && i0 < d) {
          a[kAlongX ? l * p + i0 : i0 * p + l] = operand<kRound>(o0[j]);
        }
        if constexpr (!kOneRun) {
          if (r1 < runs && i1 < d) {
            a[kAlongX ? l * p + i1 : i1 * p + l] = operand<kRound>(o1[j]);
          }
        }
      }
    }
  }
}

// (b) one block per (render, z): blur the slab along two axes, in place in
// one padded(D) x slab_pitch(D) shared buffer, zero past D, and write it
// back. kFused: K1/K2's launch at D <= 64, where the block has a warp for
// each run of a line. x then y (the f32 mode, K3's bf16 forward and K5's
// bf16 transpose), or y then x (K1/K2's bf16 mode, kBf16 and kFused:
// dpcx's kronA @ x, then @ kmat). bf16 rounds the taps, the slab as it is
// staged and the first pass's outputs, and nothing else.
template <bool kBf16, bool kFused>
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
  // the block's threads and warps: kSlabThreads above D 64
  const int nt = kFused ? static_cast<int>(blockDim.x) : kSlabThreads;
  const int nw = nt >> 5;
  const int pieces = dp / 4;  // 16-byte pieces a buffer row
  if (d % 4 == 0) {  // rows of whole 16-byte pieces: copy them in flight
    for (int i = threadIdx.x; i < dp * pieces; i += nt) {
      const int y = i / pieces, x = 4 * (i - y * pieces);
      if (y < d && x < d) {
        copy16(a + y * p + x, slab + y * d + x);
      } else {
        *reinterpret_cast<float4*>(a + y * p + x) = {0.f, 0.f, 0.f, 0.f};
      }
    }
    copy_wait();
    if constexpr (kBf16) {
      for (int i = threadIdx.x; i < dp * pieces; i += nt) {
        round4(a + i / pieces * p + 4 * (i % pieces));
      }
    }
  } else {
    for (int y = warp; y < dp; y += nw) {
      for (int x = lane; x < dp; x += 32) {
        a[y * p + x] = y < d && x < d ? operand<kBf16>(slab[y * d + x]) : 0.f;
      }
    }
  }
  __syncthreads();
  if constexpr (kBf16 && kFused) {
    pass_in_place<false, kBf16, true>(a, p, ks, radius, d);
    __syncthreads();
    pass_in_place<true, false, true>(a, p, ks, radius, d);
    __syncthreads();
    if (d % 4 == 0) {
      const int row = d / 4;  // 16-byte pieces a slab row
      for (int i = threadIdx.x; i < d * row; i += blockDim.x) {
        const int y = i / row, x = 4 * (i - y * row);
        *reinterpret_cast<float4*>(slab + y * d + x) =
            *reinterpret_cast<const float4*>(a + y * p + x);
      }
    } else {
      for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
        slab[i] = a[i / d * p + i % d];
      }
    }
    return;
  }
  pass_in_place<true, kBf16, kFused>(a, p, ks, radius, d);
  __syncthreads();
  // y: a lane a column of 32, a warp a run of rows, into the slab
  const int tiles = (d + 31) / 32, runs = dp / kRun;
  for (int item = warp; item < tiles * runs; item += nw) {
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

// (c) the z pass (K1's and K3's) or the z transpose (kTranspose: K2's, and
// with kBlocks K5's bf16 banded one per z-block of zb rows), in place: one
// block per (render, y, 32 consecutive x) stages the tile of whole z
// columns in shared memory (bf16: each value rounded; zero past D), and a
// warp blurs a run of 8 of each of its lanes' columns with the taps (bf16:
// rounded; the transpose reads them reversed, tap(z - i)). The banded
// transpose: block k (rows [k zb, k zb + zb)) reaches raw rows
// [k zb - R, k zb + zb + R); row r takes, from each block whose raw range
// holds it, rnd(sum over the block's rows i of c_i tap(r - i)), and sums
// those in f32.
template <bool kTranspose, bool kBf16, bool kBlocks>
__global__ void __launch_bounds__(kSlabThreads)
    blur_z_kernel(float* __restrict__ grid, const float* __restrict__ taps,
                  int radius, int d, int zb) {
  extern __shared__ float4 smem4[];
  float* t = reinterpret_cast<float*>(smem4);  // [padded(D), kTileW]
  const int dp = padded(d);
  float* ks = t + dp * kTileW;
  stage_taps<kBf16, kTranspose>(ks, taps, radius);
  const int tiles = (d + kTileW - 1) / kTileW;
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ry = blockIdx.x / tiles;  // render * d + y
  const int64_t r = ry / d;
  const int x0 = static_cast<int>(blockIdx.x % tiles) * kTileW;
  float* base = grid + r * dd * d + (ry - r * d) * d + x0;
  if (d % 4 == 0) {
    // a z row of the tile is 8 pieces of 16 bytes, whole inside or past D,
    // all in flight at once
    const int f = 4 * (threadIdx.x & 7);
    for (int z = threadIdx.x >> 3; z < dp; z += blockDim.x >> 3) {
      if (z < d && x0 + f < d) {
        copy16(t + z * kTileW + f, base + z * dd + f);
      } else {
        *reinterpret_cast<float4*>(t + z * kTileW + f) = {0.f, 0.f, 0.f, 0.f};
      }
    }
    copy_wait();
    if constexpr (kBf16) {
      for (int z = threadIdx.x >> 3; z < d; z += blockDim.x >> 3) {
        round4(t + z * kTileW + f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < dp * kTileW; i += blockDim.x) {
      const int z = i / kTileW, x = i % kTileW;
      t[i] = z < d && x0 + x < d ? operand<kBf16>(base[z * dd + x]) : 0.f;
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (x0 + lane >= d) return;
  float* col = base + lane;
  const int runs = dp / kRun;
  for (int run = warp; run < runs; run += blockDim.x >> 5) {
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

// (d) one thread per ray (render, y, x): DRC in f32 on the fully blurred
// grid.
__global__ void zblur_drc_kernel(const float* __restrict__ grid,
                                 float* __restrict__ sil,
                                 float* __restrict__ depth, int renders,
                                 int d, int with_depth) {
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ray = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (ray >= renders * dd) return;
  const int64_t r = ray / dd;
  const float* col = grid + r * dd * d + (ray - r * dd);
  const float fd = static_cast<float>(d);
  float trans = 1.f, s = 0.f, dep = 0.f;
  for (int z = 0; z < d; ++z) {
    const float o = fminf(fmaxf(col[z * dd], 0.f), 1.f - 1e-5f);
    const float p = o * trans;
    s += p;
    if (with_depth) dep += ((static_cast<float>(z) + 0.5f) / fd - 0.5f) * p;
    trans *= 1.f - o;
  }
  sil[ray] = s;
  if (with_depth) depth[ray] = dep + 1.f * trans;
}

// (e) at D <= 64, on the fully blurred grid, one thread per ray, into
// dgrid: the walk up keeps T_z in shared memory ([D][blockDim.x] floats);
// the walk down (the suffix form, f32) writes dL/do there (zero where the
// forward clipped). No per-thread array.
__global__ void drc_bwd_kernel(const float* __restrict__ grid,
                               const float* __restrict__ dsil,
                               const float* __restrict__ ddepth,
                               float* __restrict__ dgrid, int renders, int d,
                               int with_depth) {
  extern __shared__ float tz[];  // T_z of the block's rays
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ray = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (ray >= renders * dd) return;
  const int64_t r = ray / dd;
  const int64_t off = r * dd * d + (ray - r * dd);
  const float* col = grid + off;
  float* dcol = dgrid + off;
  float* t = tz + threadIdx.x;  // T_z at t[z blockDim.x]
  const float fd = static_cast<float>(d);
  constexpr float kTop = 1.f - 1e-5f;
  float trans = 1.f;
  for (int z = 0; z < d; ++z) {
    t[z * blockDim.x] = trans;
    trans *= 1.f - fminf(fmaxf(col[z * dd], 0.f), kTop);
  }
  const float gs = dsil[ray];
  const float gd = (with_depth && ddepth != nullptr) ? ddepth[ray] : 0.f;
  float suffix = gd * 1.f;  // background depth 1.0 past the volume
  for (int z = d - 1; z >= 0; --z) {
    const float raw = col[z * dd];
    const float oc = fminf(fmaxf(raw, 0.f), kTop);
    const float phi = gs + gd * ((static_cast<float>(z) + 0.5f) / fd - 0.5f);
    dcol[z * dd] = raw < kTop ? t[z * blockDim.x] * (phi - suffix) : 0.f;
    // oc phi + (1 - oc) suffix as one FMA on the first product, written
    // out: nvcc fuses either product of such a sum as the code around it
    // leads it, and the results are held to this one bit for bit
    suffix = fmaf(oc, phi, (1.f - oc) * suffix);
  }
}

// Shared floats of one drc_bwd_tile_kernel tile: the [padded(D), 32] tile
// of the grid and every kRun-th T_z of its 32 rays, [padded(D) / kRun, 32].
__host__ __device__ constexpr int drc_tile_floats(int d) {
  return (padded(d) + padded(d) / kRun) * kTileW;
}

// (e) at D > 64, drc_bwd_kernel's arithmetic in its order, into dgrid: a
// warp a tile of 32 whole z columns (one render, one y, 32 consecutive x,
// as blur_z_kernel tiles them), a lane a ray, kDrcTileWarps tiles a block.
// The warp stages its tile in shared memory (16-byte cp.async copies, or
// one float a lane where D % 4 != 0; zero past D); the d_z of the block
// wait in a shared table. The walk up keeps T at every kRun-th z
// (checkpoints, 2 KiB a tile at D 128 against 16 KiB for every T_z, so
// three blocks of 4 tiles share an SM); the walk down takes the column in
// chunks of kRun from the top, forms the chunk's T_z again from its
// checkpoint by the walk up's very products, and writes dL/do (zero where
// the forward clipped), a z row of 32 floats a step across the warp. The
// chunks live in registers: no per-thread array in local memory.
__global__ void __launch_bounds__(32 * kDrcTileWarps)
    drc_bwd_tile_kernel(const float* __restrict__ grid,
                        const float* __restrict__ dsil,
                        const float* __restrict__ ddepth,
                        float* __restrict__ dgrid, int renders, int d,
                        int with_depth) {
  extern __shared__ float4 smem4[];
  const int dp = padded(d);
  float* dz = reinterpret_cast<float*>(smem4);  // [padded(D)] d_z
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* t = dz + dp + warp * drc_tile_floats(d);  // [padded(D), kTileW]
  float* ck = t + dp * kTileW;  // [padded(D) / kRun, kTileW] T checkpoints
  const float fd = static_cast<float>(d);
  for (int z = threadIdx.x; z < dp; z += blockDim.x) {
    dz[z] = (static_cast<float>(z) + 0.5f) / fd - 0.5f;
  }
  __syncthreads();
  const int tiles = (d + kTileW - 1) / kTileW;
  const int64_t tile =
      static_cast<int64_t>(blockIdx.x) * kDrcTileWarps + warp;
  if (tile >= static_cast<int64_t>(renders) * d * tiles) return;
  const int64_t dd = static_cast<int64_t>(d) * d;
  const int64_t ry = tile / tiles;  // render * d + y
  const int64_t r = ry / d;
  const int x0 = static_cast<int>(tile % tiles) * kTileW;
  const int64_t off = r * dd * d + (ry - r * d) * d + x0;
  const float* base = grid + off;
  if (d % 4 == 0) {
    // a z row of the tile is 8 pieces of 16 bytes, whole inside or past D
    const int f = 4 * (lane & 7);
    for (int z = lane >> 3; z < dp; z += 4) {
      if (z < d && x0 + f < d) {
        copy16(t + z * kTileW + f, base + z * dd + f);
      } else {
        *reinterpret_cast<float4*>(t + z * kTileW + f) = {0.f, 0.f, 0.f, 0.f};
      }
    }
    copy_wait();
  } else {
#pragma unroll 8
    for (int z = 0; z < dp; ++z) {
      t[z * kTileW + lane] = z < d && x0 + lane < d ? base[z * dd + lane] : 0.f;
    }
  }
  __syncwarp();
  if (x0 + lane >= d) return;
  constexpr float kTop = 1.f - 1e-5f;
  // the walk up: T before z, kept at z = 0, kRun, 2 kRun, ...; past D the
  // staged zeros multiply T by 1
  float trans = 1.f;
  for (int z0 = 0; z0 < dp; z0 += kRun) {
    float c[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) c[j] = t[(z0 + j) * kTileW + lane];
    ck[z0 / kRun * kTileW + lane] = trans;
#pragma unroll
    for (int j = 0; j < kRun; ++j) trans *= 1.f - fminf(fmaxf(c[j], 0.f), kTop);
  }
  const int64_t ray = ry * d + x0 + lane;
  const float gs = dsil[ray];
  const float gd = (with_depth && ddepth != nullptr) ? ddepth[ray] : 0.f;
  float suffix = gd * 1.f;  // background depth 1.0 past the volume
  float* dcol = dgrid + off + lane;
  for (int z0 = dp - kRun; z0 >= 0; z0 -= kRun) {
    float c[kRun], tr[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) c[j] = t[(z0 + j) * kTileW + lane];
    tr[0] = ck[z0 / kRun * kTileW + lane];
#pragma unroll
    for (int j = 1; j < kRun; ++j) {
      tr[j] = tr[j - 1] * (1.f - fminf(fmaxf(c[j - 1], 0.f), kTop));
    }
#pragma unroll
    for (int j = kRun - 1; j >= 0; --j) {
      const int z = z0 + j;
      if (z >= d) continue;
      const float raw = c[j];
      const float oc = fminf(fmaxf(raw, 0.f), kTop);
      const float phi = gs + gd * dz[z];
      dcol[z * dd] = raw < kTop ? tr[j] * (phi - suffix) : 0.f;
      // drc_bwd_kernel's FMA (left to nvcc, this unrolled loop would fuse
      // the other product)
      suffix = fmaf(oc, phi, (1.f - oc) * suffix);
    }
  }
}

// (g) for one point of one render, dgrid g [D, D, D] of that render:
// d(z, y, x) in grid units into dc, and dw. Reduced as the Pallas kernel
// does: per z corner P = sum_y v h_y and Q = sum_y v dh_y with
// v = sum_x dG h_x, per x corner t1 = sum_zy dG a with a = (h_z pw) h_y;
// then d z = pw sum dh_z P, d y = pw sum h_z Q, d x = sum dh_x t1 and
// dw = sum h_z P. The bf16 mode rounds h_y, h_x and a's operands
// (rnd(rnd(h_z) rnd(pw)), not the forward's rnd(h_z pw)), and dG with
// kRoundDg (K2's; K5's dG is a sum of rounded partials); h_z, dh_z, pw
// enter the sums unrounded.
template <bool kBf16, bool kRoundDg>
__device__ __forceinline__ void splat_bwd_point(const float* __restrict__ g,
                                                float gz, float gy, float gx,
                                                float pw, int d, float* dc,
                                                float& dw) {
  const float top = static_cast<float>(d - 1);
  const float fz = floorf(gz), fy = floorf(gy), fx = floorf(gx);
  const float tz = gz - fz, ty = gy - fy, tx = gx - fx;
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
  dc[0] = az * pw;
  dc[1] = ay * pw;
  dc[2] = (t1[1] - t1[0]) * sx;
  dw = aw;
}

// Sums 16 values of every lane over the warp in 16 shuffles: each step
// halves the values a lane keeps and adds its partner's copies of them.
// Lane l returns the warp's sum of v[l / 2].
__device__ __forceinline__ float warp_sum16(float (&v)[16], int lane) {
#pragma unroll
  for (int half = 8, o = 16; half >= 1; half >>= 1, o >>= 1) {
    const bool upper = lane & o;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? v[k] : v[k + half];
      const float keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// (g) from world clouds (World), one thread per (cloud, point), with the
// camera transform's backward in registers: per render, the grid cotangent
// D d(z, y, x) through x f / z and y f / z (z + dist clamped: no gradient
// where it was below kMinDepth), the chain rule autograd applies to the
// torch ops, then d p = rot^T d p_cam. The cloud's renders sum into d points
// [C, N, 3] and d weights [C, N] (or null), each written once. kCamGrad:
// also d rot[r] = sum_n d p_cam p^T into drot [R, 3, 3] and d trans[r] =
// sum_n d p_cam into dtrans [R, 3] (or null), both zeroed before: summed
// over the warp by shuffles where its lanes share the render (N % 32 == 0
// makes that every warp), then one atomicAdd a value a warp. The chain's
// divides share one reciprocal of z + dist, so its gradients may differ
// from autograd's in the last bits; the coordinates are the forward's,
// bit for bit. The launch bounds hold it to 48 registers, for the gathers
// in flight: the fastest of 4-6 blocks an SM at the car_64_depth and
// chair_pred_pose renders, from training's clouds and the benchmark's.
template <bool kBf16, bool kRoundDg, bool kCamGrad>
__global__ void __launch_bounds__(kThreads, 5)
    splat_bwd_kernel(World w, const float* __restrict__ weights,
                                 const float* __restrict__ dgrid,
                                 float* __restrict__ dpoints,
                                 float* __restrict__ dweights,
                                 float* __restrict__ drot,
                                 float* __restrict__ dtrans, int renders,
                                 int n, int d) {
  const int64_t total = static_cast<int64_t>(renders / w.per_cloud) * n;
  const int64_t cells = static_cast<int64_t>(d) * d * d;
  const float fd = static_cast<float>(d);
  const int lane = threadIdx.x & 31;
  // warp-uniform trips: a lane past the end computes nothing and adds 0
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i - lane < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool live = i < total;
    const int64_t c = (live ? i : i - lane) / n;
    float px = 0.f, py = 0.f, pz = 0.f, pw = 0.f;
    if (live) {
      const float* p = w.points + 3 * i;
      px = p[0], py = p[1], pz = p[2];
      pw = weights != nullptr ? weights[i] : 1.f;
    }
    float dpx = 0.f, dpy = 0.f, dpz = 0.f, dw = 0.f;
    for (int s = 0; s < w.per_cloud; ++s) {
      const int64_t r = c * w.per_cloud + s;
      const Projected q = project(w, r, px, py, pz, fd);
      float dc[3] = {0.f, 0.f, 0.f}, dws = 0.f;
      if (live) {
        splat_bwd_point<kBf16, kRoundDg>(dgrid + r * cells, q.g[0], q.g[1],
                                         q.g[2], pw, d, dc, dws);
      }
      // d ndc = D d(grid), then through the divides and the clamp
      const float dzn = __fmul_rn(dc[0], fd);
      const float dyn = __fmul_rn(dc[1], fd);
      const float dxn = __fmul_rn(dc[2], fd);
      const float inv = __frcp_rn(q.zs);
      const float fi = __fmul_rn(w.focal, inv);
      const float dx = __fmul_rn(dxn, fi);
      const float dy = __fmul_rn(dyn, fi);
      const float dzs = -__fmul_rn(
          fmaf(dyn, q.yn, __fmul_rn(dxn, q.xn)), inv);
      const float dz = q.clamped ? dzn : __fadd_rn(dzn, dzs);
      const float* m = w.rot + r * 9;
      dpx = __fadd_rn(dpx, fmaf(__ldg(m + 6), dz, fmaf(__ldg(m + 3), dy,
                                __fmul_rn(__ldg(m), dx))));
      dpy = __fadd_rn(dpy, fmaf(__ldg(m + 7), dz, fmaf(__ldg(m + 4), dy,
                                __fmul_rn(__ldg(m + 1), dx))));
      dpz = __fadd_rn(dpz, fmaf(__ldg(m + 8), dz, fmaf(__ldg(m + 5), dy,
                                __fmul_rn(__ldg(m + 2), dx))));
      dw = __fadd_rn(dw, dws);
      if constexpr (kCamGrad) {
        // d rot[r] row-major (9), then d trans[r] (3), padded to 16
        float v[16] = {__fmul_rn(dx, px), __fmul_rn(dx, py),
                       __fmul_rn(dx, pz), __fmul_rn(dy, px),
                       __fmul_rn(dy, py), __fmul_rn(dy, pz),
                       __fmul_rn(dz, px), __fmul_rn(dz, py),
                       __fmul_rn(dz, pz), dx, dy, dz, 0.f, 0.f, 0.f, 0.f};
        const int64_t r0 = __shfl_sync(0xffffffffu, r, 0);
        if (__all_sync(0xffffffffu, r == r0)) {
          const float sum = warp_sum16(v, lane);
          const int k = lane >> 1;
          if ((lane & 1) == 0 && k < 9) atomicAdd(drot + r * 9 + k, sum);
          if ((lane & 1) == 0 && k >= 9 && k < 12 && dtrans != nullptr) {
            atomicAdd(dtrans + r * 3 + (k - 9), sum);
          }
        } else if (live) {  // a warp across two clouds (N % 32 != 0)
#pragma unroll
          for (int k = 0; k < 9; ++k) atomicAdd(drot + r * 9 + k, v[k]);
          if (dtrans != nullptr) {
#pragma unroll
            for (int k = 0; k < 3; ++k) atomicAdd(dtrans + r * 3 + k, v[9 + k]);
          }
        }
      }
    }
    if (live) {
      float* out = dpoints + 3 * i;
      out[0] = dpx;
      out[1] = dpy;
      out[2] = dpz;
      if (dweights != nullptr) dweights[i] = dw;
    }
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

// one thread per ray (render, y, x), in blocks of `threads`
unsigned ray_blocks(int renders, int d, int threads = kThreads) {
  const int64_t rays = static_cast<int64_t>(renders) * d * d;
  return static_cast<unsigned>((rays + threads - 1) / threads);
}

// (b) on every slab of grid [R, D, D, D], in place, in the mode's order
// (the fused form at D <= 64): three blocks an SM at D 128 (67,860 bytes
// each with the taps at R 16), which needs the shared-memory carveout at
// its largest and the kernel's limit raised above the 48 KiB default;
// 17 KiB at D 64.
template <bool kBf16>
cudaError_t launch_blur_slab(float* grid, const float* taps, int radius,
                             int renders, int d, cudaStream_t s) {
  const size_t smem = (static_cast<size_t>(padded(d)) * slab_pitch(d) +
                       staged_taps(radius)) * sizeof(float);
  const auto kernel = d <= kFusedMaxVox ? blur_slab_kernel<kBf16, true>
                                        : blur_slab_kernel<kBf16, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(renders * d), slab_threads(d), smem, s>>>(
      grid, taps, radius, d);
  return cudaGetLastError();
}

// (c) the z pass, or the z transpose (kTranspose), in place, in the
// operand mode's form (kBf16; kBlocks: K5's banded transpose).
template <bool kTranspose, bool kBf16, bool kBlocks = false>
cudaError_t launch_blur_z(float* grid, const float* taps, int radius,
                          int renders, int d, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(padded(d)) * kTileW + staged_taps(radius)) *
      sizeof(float);
  const unsigned blocks = static_cast<unsigned>(
      renders * d * ((d + kTileW - 1) / kTileW));
  blur_z_kernel<kTranspose, kBf16, kBlocks>
      <<<blocks, slab_threads(d), smem, s>>>(grid, taps, radius, d,
                                             z_block(d));
  return cudaGetLastError();
}

// The splat stages' threads: one a (cloud, point).
int64_t splat_units(const World& w, int renders, int n) {
  return static_cast<int64_t>(renders / w.per_cloud) * n;
}

// (a) + (b) + (c): the fully blurred grid the DRC walk reads, into the
// scratch grid (y/x, then z; K3's bf16 mode: z first).
cudaError_t launch_grid(Mode m, const World& w, const float* weights,
                        const float* taps, int radius, float* grid,
                        int renders, int n, int d, cudaStream_t s) {
  const size_t cells = static_cast<size_t>(renders) * d * d * d;
  cudaError_t err = cudaMemsetAsync(grid, 0, cells * sizeof(float), s);
  if (err != cudaSuccess) return err;
  const int64_t units = splat_units(w, renders, n);
  if (units > 0) {
    const unsigned blocks = static_cast<unsigned>(splat_blocks(units));
    if (m == Mode::kF32) {
      splat_kernel<false><<<blocks, kThreads, 0, s>>>(w, weights, grid,
                                                      renders, n, d);
    } else {
      splat_kernel<true><<<blocks, kThreads, 0, s>>>(w, weights, grid,
                                                     renders, n, d);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  switch (m) {
    case Mode::kF32:
      err = launch_blur_slab<false>(grid, taps, radius, renders, d, s);
      if (err != cudaSuccess) return err;
      return launch_blur_z<false, false>(grid, taps, radius, renders, d, s);
    case Mode::kBf16:
      err = launch_blur_slab<true>(grid, taps, radius, renders, d, s);
      if (err != cudaSuccess) return err;
      return launch_blur_z<false, true>(grid, taps, radius, renders, d, s);
    case Mode::kBf16Blocked:
      err = launch_blur_z<false, true>(grid, taps, radius, renders, d, s);
      if (err != cudaSuccess) return err;
      return launch_blur_slab<true>(grid, taps, radius, renders, d, s);
  }
  return cudaErrorInvalidValue;
}

// (d): the DRC walk on the fully blurred grid.
cudaError_t launch_drc(const float* grid, float* sil, float* depth,
                       int renders, int d, int with_depth, cudaStream_t s) {
  zblur_drc_kernel<<<ray_blocks(renders, d), kThreads, 0, s>>>(
      grid, sil, depth, renders, d, with_depth);
  return cudaGetLastError();
}

// (e): drc_bwd_kernel at D <= 64; above, drc_bwd_tile_kernel, whose blocks
// take 74,240 bytes of shared memory at D 128 (three blocks an SM), which
// needs the shared-memory carveout at its largest and the kernel's limit
// raised above the 48 KiB default.
cudaError_t launch_drc_bwd(const float* grid, const float* dsil,
                           const float* ddepth, float* dgrid, int renders,
                           int d, int with_depth, cudaStream_t s) {
  if (d <= kFusedMaxVox) {
    drc_bwd_kernel<<<ray_blocks(renders, d, kDrcThreads), kDrcThreads,
                     static_cast<size_t>(d) * kDrcThreads * sizeof(float),
                     s>>>(grid, dsil, ddepth, dgrid, renders, d, with_depth);
    return cudaGetLastError();
  }
  const size_t smem =
      (static_cast<size_t>(padded(d)) +
       static_cast<size_t>(kDrcTileWarps) * drc_tile_floats(d)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      drc_bwd_tile_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(drc_bwd_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles =
      static_cast<int64_t>(renders) * d * ((d + kTileW - 1) / kTileW);
  drc_bwd_tile_kernel<<<static_cast<unsigned>(
                            (tiles + kDrcTileWarps - 1) / kDrcTileWarps),
                        32 * kDrcTileWarps, smem, s>>>(
      grid, dsil, ddepth, dgrid, renders, d, with_depth);
  return cudaGetLastError();
}

// (g) in the operand mode's form into dpoints [C, N, 3], and, where drot
// is not null, the cameras' gradients into drot and dtrans (or null),
// zeroed here first.
template <bool kBf16, bool kRoundDg>
cudaError_t launch_splat_bwd(const World& w, const float* weights,
                             const float* dgrid, float* dpoints,
                             float* dweights, float* drot, float* dtrans,
                             int renders, int n, int d, cudaStream_t s) {
  const int64_t units = splat_units(w, renders, n);
  const unsigned blocks = static_cast<unsigned>(splat_blocks(units));
  if (drot == nullptr) {
    if (units == 0) return cudaSuccess;
    splat_bwd_kernel<kBf16, kRoundDg, false><<<blocks, kThreads, 0, s>>>(
        w, weights, dgrid, dpoints, dweights, nullptr, nullptr, renders, n,
        d);
    return cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(
      drot, 0, static_cast<size_t>(renders) * 9 * sizeof(float), s);
  if (err == cudaSuccess && dtrans != nullptr) {
    err = cudaMemsetAsync(dtrans, 0,
                          static_cast<size_t>(renders) * 3 * sizeof(float), s);
  }
  if (err != cudaSuccess || units == 0) return err;
  splat_bwd_kernel<kBf16, kRoundDg, true><<<blocks, kThreads, 0, s>>>(
      w, weights, dgrid, dpoints, dweights, drot, dtrans, renders, n, d);
  return cudaGetLastError();
}

// (e) + (f) + (g) on the grid launch_grid makes.
cudaError_t launch_bwd_stages(Mode m, const World& w,
                              const float* weights, const float* taps,
                              int radius, const float* grid,
                              const float* dsil, const float* ddepth,
                              float* dgrid, float* dpoints, float* dweights,
                              float* drot, float* dtrans, int renders, int n,
                              int d, int with_depth, cudaStream_t s) {
  cudaError_t err =
      launch_drc_bwd(grid, dsil, ddepth, dgrid, renders, d, with_depth, s);
  if (err == cudaSuccess) {
    switch (m) {  // the transposes in the mode's order
      case Mode::kF32:
        err = launch_blur_z<true, false>(dgrid, taps, radius, renders, d, s);
        if (err == cudaSuccess) {
          err = launch_blur_slab<false>(dgrid, taps, radius, renders, d, s);
        }
        break;
      case Mode::kBf16:
        err = launch_blur_z<true, true>(dgrid, taps, radius, renders, d, s);
        if (err == cudaSuccess) {
          err = launch_blur_slab<true>(dgrid, taps, radius, renders, d, s);
        }
        break;
      case Mode::kBf16Blocked:
        err = launch_blur_slab<true>(dgrid, taps, radius, renders, d, s);
        if (err == cudaSuccess) {
          err = launch_blur_z<true, true, true>(dgrid, taps, radius, renders,
                                                d, s);
        }
        break;
    }
  }
  if (err != cudaSuccess) return err;
  switch (m) {
    case Mode::kF32:
      return launch_splat_bwd<false, false>(w, weights, dgrid, dpoints,
                                            dweights, drot, dtrans, renders,
                                            n, d, s);
    case Mode::kBf16:  // K2 rounds dG
      return launch_splat_bwd<true, true>(w, weights, dgrid, dpoints,
                                          dweights, drot, dtrans, renders, n,
                                          d, s);
    case Mode::kBf16Blocked:
      return launch_splat_bwd<true, false>(w, weights, dgrid, dpoints,
                                           dweights, drot, dtrans, renders,
                                           n, d, s);
  }
  return cudaErrorInvalidValue;
}

// The forward; the backward, re-splatting and re-blurring into grid first
// where recompute.
cudaError_t forward(const World& w, const float* weights,
                    const float* taps, int radius, float* grid, float* sil,
                    float* depth, int renders, int n, int d, int with_depth,
                    int bf16, void* stream) {
  if (bad_args(renders, n, d, radius, bf16) ||
      (with_depth && depth == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (renders == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_grid(mode_of(bf16, d), w, weights, taps,
                                      radius, grid, renders, n, d, s);
  if (err != cudaSuccess) return err;
  return launch_drc(grid, sil, depth, renders, d, with_depth, s);
}

cudaError_t backward(const World& w, const float* weights,
                     const float* taps, int radius, float* grid,
                     bool recompute, const float* dsil, const float* ddepth,
                     float* dgrid, float* dpoints, float* dweights, float* drot,
                     float* dtrans, int renders, int n, int d, int with_depth,
                     int bf16, void* stream) {
  if (bad_args(renders, n, d, radius, bf16)) return cudaErrorInvalidValue;
  if (renders == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mode m = mode_of(bf16, d);
  if (recompute) {
    const cudaError_t err =
        launch_grid(m, w, weights, taps, radius, grid, renders, n, d, s);
    if (err != cudaSuccess) return err;
  }
  return launch_bwd_stages(m, w, weights, taps, radius, grid, dsil, ddepth,
                           dgrid, dpoints, dweights, drot, dtrans, renders, n,
                           d, with_depth, s);
}

// World clouds and cameras as the C entries take them; a bad per_cloud
// gives null points, which the entries refuse.
World world_source(const float* points, const float* rot,
                   const float* trans, float focal, float dist,
                   int per_cloud, int renders) {
  const bool ok = points != nullptr && rot != nullptr && per_cloud >= 1 &&
                  renders % per_cloud == 0;
  return World{ok ? points : nullptr, rot, trans, focal, dist,
               ok ? per_cloud : 1};
}

}  // namespace

// Forward from world clouds: points [C, N, 3] f32, weights [C, N] or null,
// and per render r its camera, rot [R, 3, 3] and trans [R, 3] or null, with
// focal and dist (render/transform.py's focal length and camera distance);
// render r shows cloud r / per_cloud, R = C per_cloud. The splat stage
// projects each point in registers (World). taps [2 radius + 1]. grid:
// scratch [R, D, D, D] f32 that holds the fully blurred grid the DRC walk
// read afterwards; sil, depth: [R, D, D] f32 (depth may be null when
// with_depth is 0); bf16: the operand mode (1: bfloat16; above D 64,
// D % 8 == 0). Returns a cudaError_t as int.
extern "C" int dpcx_fused_render_world(
    const float* points, const float* weights, const float* rot,
    const float* trans, float focal, float dist, int per_cloud,
    const float* taps, int radius, float* grid, float* sil, float* depth,
    int renders, int n, int d, int with_depth, int bf16, void* stream) {
  const World w =
      world_source(points, rot, trans, focal, dist, per_cloud, renders);
  if (w.points == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(forward(w, weights, taps, radius, grid, sil,
                                  depth, renders, n, d, with_depth, bf16,
                                  stream));
}

// Backward from world clouds, the inputs as dpcx_fused_render_world's:
// grid is the forward's grid, or (recompute 1) scratch that is re-splatted
// and re-blurred first. dgrid: scratch [R, D, D, D]; dsil [R, D, D];
// ddepth [R, D, D] or null (zero); dpoints out [C, N, 3]; dweights out
// [C, N] or null (not wanted); drot out [R, 3, 3] or null (no camera
// gradient), dtrans out [R, 3] or null. Returns a cudaError_t as int.
extern "C" int dpcx_fused_render_world_bwd(
    const float* points, const float* weights, const float* rot,
    const float* trans, float focal, float dist, int per_cloud,
    const float* taps, int radius, float* grid, int recompute,
    const float* dsil, const float* ddepth, float* dgrid, float* dpoints,
    float* dweights, float* drot, float* dtrans, int renders, int n, int d,
    int with_depth, int bf16, void* stream) {
  const World w =
      world_source(points, rot, trans, focal, dist, per_cloud, renders);
  if (w.points == nullptr || (dtrans != nullptr && trans == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(backward(
      w, weights, taps, radius, grid, recompute != 0, dsil, ddepth, dgrid,
      dpoints, dweights, drot, dtrans, renders, n, d, with_depth, bf16,
      stream));
}
