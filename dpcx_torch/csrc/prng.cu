// The random draws of one training step for NVIDIA Hopper (sm_90a):
// jax.random's threefry2x32 stream, as dpcx's jitted step draws it.
//
// dpcx has no Pallas kernel here: its draws are jax.random calls that XLA
// compiles (dpcx/train.py:153-190, the batch of the device-resident scan;
// dpcx/render/voxelize.py:54, the point-dropout mask). The port draws the
// same bits (dpcx_torch/utils/prng.py documents the stream and holds the
// plain versions in torch ops, which the kernels must equal bitwise):
//
//   bits(key, i)    = x0 ^ x1 of threefry2x32(key, (0, i)), i the flat
//                     index (jax_threefry_partitionable; 32-bit counters);
//   uniform         = bitcast((bits >> 9) | 0x3F800000) - 1 (exact);
//   randint(0, s)   = ((hi % s) * ((2^16 % s)^2 % s) + lo % s) % s in
//                     uint32, hi and lo the bits of the key's two halves.
//
// (a) dpcx_dropout_weights: [B, N] float32 point-dropout weights, one thread
//     an element: bits -> uniform -> (u < keep) / max(keep, 1e-6), the
//     division IEEE-rounded as XLA's.
// (b) dpcx_batch_draws: one thread a batch row b writes int64 gather rows
//     [B, 2 + V_use] of the records viewed as [M * V, ...] (dpcx's take_mv):
//     m V + v_in, m V + v_in2 (-1 where the step draws none), then
//     m V + perm[0 .. V_use), m, v_in and v_in2 from word b of each randint
//     half, perm the stable argsort of the row's V uniforms at counters
//     b V + v (jnp.argsort is stable): each view's place is the number of
//     views whose uniform is smaller, or equal at a smaller index.
//
// Keys arrive as uint32 launch arguments (the host derives them: fold_in
// and split are a few evaluations a step), so neither launch reads host
// memory after it is queued or syncs the host.
//
// What bounds them: integer issue. Beyond the key schedule, which is the
// launch's (k2 and each injection's k + i are the same for every thread),
// a threefry2x32 word is 20 rounds of add, funnel-shift rotate and xor
// (60), the counter's add, the injections' adds and the xor of the two
// halves: 68 integer operations, 41 of them shifts and xors that only the
// ALU pipe (64 lanes an SM) issues, against one 4-byte store a dropout
// weight (dpcx_torch/bench.py::draw_bound). (b) is a few threads of
// latency-bound serial work, B(6 + V) words a step; its time is the
// launch's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxViews = 64;  // utils/prng.py::MAX_VIEWS

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, R1); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, R2); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, R3); x1 ^= x0;
}

// x0 ^ x1 of threefry2x32((k0, k1), (0, count))
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t count) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;  // the high counter word is 0
  uint32_t x1 = count + k1;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t count) {
  return __uint_as_float((threefry_bits(k0, k1, count) >> 9) | 0x3F800000u) -
         1.0f;
}

// key: the two halves of a randint key (split(key, 2)), 4 words
__device__ __forceinline__ uint32_t randint_at(const uint32_t* key,
                                               uint32_t count, uint32_t span) {
  const uint32_t hi = threefry_bits(key[0], key[1], count);
  const uint32_t lo = threefry_bits(key[2], key[3], count);
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  return ((hi % span) * mult + lo % span) % span;
}

__global__ void dropout_weights_kernel(float* __restrict__ out, int size,
                                       uint32_t k0, uint32_t k1, float keep) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const float scale = 1.0f / fmaxf(keep, 1e-6f);
  out[i] = uniform_at(k0, k1, static_cast<uint32_t>(i)) < keep ? scale : 0.0f;
}

// The keys of one step's batch: each randint key's two halves, and the
// target views' uniform key.
struct DrawKeys {
  uint32_t m[4], v_in[4], tgt[2], v_in2[4];
};

__global__ void batch_draws_kernel(long long* __restrict__ rows, int batch,
                                   int models, int views, int views_use,
                                   int with_in2, DrawKeys keys) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const uint32_t ub = static_cast<uint32_t>(b);
  const uint32_t m = randint_at(keys.m, ub, models);
  const uint32_t v_in = randint_at(keys.v_in, ub, views);
  const long long base = static_cast<long long>(m) * views;
  long long* row = rows + static_cast<long long>(b) * (2 + views_use);
  row[0] = base + v_in;
  row[1] = with_in2
               ? base + (v_in + 1 +
                         randint_at(keys.v_in2, ub,
                                    views > 1 ? views - 1 : 1)) % views
               : -1;
  float u[kMaxViews];
  for (int v = 0; v < views; ++v) {
    u[v] = uniform_at(keys.tgt[0], keys.tgt[1], ub * views + v);
  }
  for (int v = 0; v < views; ++v) {
    int place = 0;
    for (int w = 0; w < views; ++w) {
      place += (u[w] < u[v]) || (u[w] == u[v] && w < v);
    }
    if (place < views_use) row[2 + place] = base + v;
  }
}

}  // namespace

// out [size] f32 (size = B * N < 2^31), key (k0, k1), keep: dpcx's float32
// keep-prob. Returns a cudaError_t as int.
extern "C" int dpcx_dropout_weights(float* out, int size, uint32_t k0,
                                    uint32_t k1, float keep, void* stream) {
  if (size < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (size == 0) return 0;
  dropout_weights_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(out, size, k0,
                                                                k1, keep);
  return static_cast<int>(cudaGetLastError());
}

// keys: 14 host words, read before the launch: m's two halves (4), v_in's
// (4), the target views' key (2), v_in2's halves (4, read when with_in2);
// rows [batch, 2 + views_use] int64. Returns a cudaError_t as int.
extern "C" int dpcx_batch_draws(const uint32_t* keys, long long* rows,
                                int batch, int models, int views,
                                int views_use, int with_in2, void* stream) {
  if (batch < 0 || models < 1 || views < 1 || views > kMaxViews ||
      views_use < 1 || views_use > views) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  DrawKeys k;
  for (int i = 0; i < 4; ++i) {
    k.m[i] = keys[i];
    k.v_in[i] = keys[4 + i];
    k.v_in2[i] = keys[10 + i];
  }
  k.tgt[0] = keys[8];
  k.tgt[1] = keys[9];
  batch_draws_kernel<<<(batch + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, batch, models, views, views_use, with_in2, k);
  return static_cast<int>(cudaGetLastError());
}
