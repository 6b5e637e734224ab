// The renderer's random draws, for Hopper (sm_90a): threefry-2x32 (20
// rounds, Salmon et al. 2011), keyed and laid out as jax.random's
// partitionable threefry, one lane a thread.
//
// Replaces no TPU kernel.  The JAX package draws with jax.random, which XLA
// fuses into the surrounding computation; the port computed the same hash
// as separate int64 torch operations (sampling/rng.py::threefry2x32): about
// 170 launches a draw, each reading and writing 8 bytes a lane.  A 2048 x
// 2048 render pass makes 50 such draws, 224 of its 280 device ms.  This
// kernel is each draw in one launch, with the same bits; the torch ops stay
// as the CPU's path and as its oracle.
//
// Two entry points cover every draw of sampling/rng.py:
//   - rng_uniform_ids: counter (pixel id, bounce * 16 + decision) -> the top
//     24 bits of the first output word times 2^-24, as float32 (uniform_ids).
//     The ids are read in their own type (int32 or int64); only their low
//     32 bits enter, as (ids + ks0) & MASK does in the torch ops.
//   - rng_random_bits: counter (0, offset + i) -> the word y0 ^ y1, written
//     as int64 (random_bits' dtype) or, with as_float, as jax.random.uniform's
//     float in [0, 1): 23 bits under the exponent of 1.0, minus 1.0 (uniform,
//     raw_uniform).  sampling/rng.py has checked offset + n <= 2^32, and
//     the launcher refuses more, so the counter never wraps.
//
// Bound.  A lane is 2 + 5 * (4 * 3 + 2) = 72 int32 operations of the hash
// (a round is an add, a rotate as one funnel shift and an xor; each of the
// 5 key injections two adds), and a few more for its output; 2^22 lanes
// (a 2048 x 2048 draw) are 3.02e8 operations of the hash, 18.1 us at the
// H100's int32 rate (64 a clock on each of 132 SMs at 1.98 GHz).  Bytes:
// the ids read and one float written, 12 bytes a lane with int64 ids, 50 MB
// a 2^22 draw, 15.0 us at 3.35 TB/s; random_bits reads nothing and writes 4
// or 8 bytes a lane.  So the operations bound both draws, closely followed
// by the bytes in uniform_ids.
//
// Design.  One lane a thread in blocks of 256, loads and stores coalesced;
// the keys, their schedule and the second counter word are kernel
// arguments, uniform across the grid, so they live in uniform registers.
// Blocks stride over the lanes only past kMaxBlocks blocks.  Integer
// arithmetic throughout: the result is the same bits as the torch ops'.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = rotl(x1, R0) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R1) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R2) ^ x0;
  x0 += x1;
  x1 = rotl(x1, R3) ^ x0;
}

// sampling/rng.py::threefry2x32: the counter pair (x0, x1) hashed in place
// under the key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
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
}

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    rng_uniform_ids_kernel(const Index* __restrict__ ids, long long n,
                           uint32_t k0, uint32_t k1, uint32_t counter,
                           float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t x0 = static_cast<uint32_t>(ids[i]);
    uint32_t x1 = counter;
    threefry2x32(k0, k1, x0, x1);
    out[i] = static_cast<float>(x0 >> 8) * 5.9604644775390625e-08f;
  }
}

template <bool kUnitFloat>
__global__ void __launch_bounds__(kThreads)
    rng_random_bits_kernel(long long offset, long long n, uint32_t k0,
                           uint32_t k1, void* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    uint32_t x0 = 0u;
    uint32_t x1 = static_cast<uint32_t>(offset + i);
    threefry2x32(k0, k1, x0, x1);
    const uint32_t w = x0 ^ x1;
    if (kUnitFloat) {
      static_cast<float*>(out)[i] =
          __uint_as_float((w >> 9) | 0x3F800000u) - 1.0f;
    } else {
      static_cast<long long*>(out)[i] = static_cast<long long>(w);
    }
  }
}

int blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// ids: n indices of id_bytes (4 or 8) bytes; out: n float32.  Launches on
// `stream` and returns the CUDA error of the launch (0 = launched).
extern "C" int rng_uniform_ids(const void* ids, int id_bytes, long long n,
                               uint32_t k0, uint32_t k1, uint32_t counter,
                               float* out, cudaStream_t stream) {
  if (n < 0 || (id_bytes != 4 && id_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  if (id_bytes == 8) {
    rng_uniform_ids_kernel<int64_t><<<blocks_for(n), kThreads, 0, stream>>>(
        static_cast<const int64_t*>(ids), n, k0, k1, counter, out);
  } else {
    rng_uniform_ids_kernel<int32_t><<<blocks_for(n), kThreads, 0, stream>>>(
        static_cast<const int32_t*>(ids), n, k0, k1, counter, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: n int64 words (as_float 0) or n float32 in [0, 1) (as_float 1), for
// the counters offset .. offset + n - 1, which must lie in [0, 2^32).
extern "C" int rng_random_bits(long long offset, long long n, uint32_t k0,
                               uint32_t k1, int as_float, void* out,
                               cudaStream_t stream) {
  if (n < 0 || offset < 0 || offset + n > (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  if (as_float) {
    rng_random_bits_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(
        offset, n, k0, k1, out);
  } else {
    rng_random_bits_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(
        offset, n, k0, k1, out);
  }
  return static_cast<int>(cudaGetLastError());
}
