// (ray, treelet) pair test for Hopper (sm_90a): the constant-form
// Moller-Trumbore of one ray against the T_LEAF = 128 triangles of one
// treelet, for every pair.
//
// Replaces the TPU kernel raytracingrenderer_tpu/ops/treelet.py::_pair_kernel
// (Pallas, launched by _pair_test).  It computes what that kernel computes
// per pair (ops/treelet.py, pair_test_plain):
//   consts (K*16, 128) f32: per treelet 16 rows [N e1 e2 P1 P2 c0], one
//          column per triangle (N = e1 x e2, P1 = p0 x e1, P2 = p0 x e2,
//          c0 = p0 . N; empty columns are zero);
//   feats  (P, 16) f32: per pair its ray's [d o G 1 radius 0...], G = o x d;
//   tid    (P,) i32: the pair's treelet, pairs sorted by it; a tid outside
//          [0, K) is no pair;
//   -> t (P,) f32: the nearest t among the hits with det >= eps, u, v >= 0,
//          u + v <= 1, 0 < t < radius (INF = 3e38 if none);
//      col (P,) i32: its column, the first among equal t (-1 if none).
// With det = -(d . N), t*det = o . N - c0, u*det = G . e2 + d . P2,
// v*det = -(G . e1 + d . P1), signs folded by sgn(det).
//
// The TPU kernel runs the four 16-deep contractions of a 1024-pair tile on
// its matrix unit at precision=HIGHEST and loops over the distinct treelet
// ids of the tile.  Hopper's fp32 matrix path is TF32 (10-bit mantissa),
// which would lose the exactness of the hit decisions, so this kernel stays
// in IEEE fp32 on the CUDA cores, summing only the nonzero terms of each
// contraction, left to right in constant-row order.
//
// Bound.  Per pair and column 33 operations of contraction and 16 of
// epilogue, all on operands that stay on chip: operations bound it (49 a
// column over the FP32 peak: 0.210 ms for the 2,243,692 pairs of a 1024 x
// 1024 primary call on an H100), and since every product and sum is rounded
// (--fmad=false, for the bit-for-bit check) the floor is the issue rate, one
// instruction a cycle and scheduler: twice the bound, 0.420 ms.  With the
// constants read from global memory, one column at a time, the first design
// issued 16 loads, each of one address by a whole warp (which costs as a full
// load), beside the 60 or so instructions a column that the arithmetic, its
// compares and the branch around the division come to, and ran at one
// instruction a cycle: 0.705 ms.  This design takes 0.531 ms there, 79% of
// the issue floor, and 3.25 ms against 4.02 over the 12 calls of a sample
// pass (11.5 M pairs).  What it does:
//   - A block is 128 threads over 128 consecutive pairs, one pair a thread,
//     and walks the runs of equal treelet id in that range (the pairs are
//     sorted; a pass's calls have runs of 600 pairs down to 24; any order
//     stays correct, a run is then shorter): it marks where
//     tid[i] != tid[i - 1], counts the marks with warp votes and one pass
//     through shared memory, and keeps the runs' ids in shared memory.
//   - A run's constants are 16 x 128 contiguous floats: one thread brings
//     the tiles of up to kWindow runs in, one cp.async.bulk each, completion
//     counted on one mbarrier.  A thread then reads its own run's tile: a
//     16-byte load of one constant row feeds 4 columns, 16 loads for 4
//     columns' arithmetic; the threads of a warp read one address (a
//     broadcast) or, where a run ends inside the warp, two.  No pair is
//     tested against a tile that is not its own: a warp that straddles a run
//     costs a second address a load, not a second pass.  A block with more
//     runs than the window holds takes them window by window, between two
//     barriers of the block.
//   - The features are not negated: (-dx) nx + (-dy) ny + (-dz) nz is, under
//     round-to-nearest, bit for bit -(dx nx + dy ny + dz nz), because a
//     negation is exact and rounding is symmetric; so is v's sum.  (A sum
//     that cancels comes out as -0 for +0, which no comparison of the
//     epilogue tells apart and which reaches neither t nor col.)
//   - sgn(det) is not multiplied in: |det| is the sum's magnitude, and u, v
//     and t get det's sign as a flip of their sign bit, one logic operation
//     each for a compare, a select and four products.  x * (+-1) is that flip
//     bit for bit; the two differ only for det = -0 or NaN, which fail
//     |det| >= eps either way.
//   - Columns are walked in ascending order with a strict `<`, so the first
//     column among equal t is kept, as the plain version's min keeps it; two
//     groups of four columns a loop step.
// Tried and dropped (times for the primary call and the pass): 4 and 2 pairs
// a thread over one tile's loads, a block walking its runs through a ring of
// tiles (1.03 and 0.69 ms; 19.8 and 7.9 ms: a warp tests every tile its pairs
// straddle, whole, and the 4 x 4 loop is 1,300 instructions of 16 branch
// regions); the tile's columns in the lanes' registers and the min by
// butterfly (1.07; 5.4); the first design with 16-byte loads from global
// memory (0.70; 3.8); a window of 2 or 4 tiles (within 1% or slower);
// products by sgn(det), one group a step (0.56; 3.4).  Built with FMA allowed
// it takes 0.46 and 2.9 ms and changes t or col of 9% of the pairs.
//
// Build with --fmad=false and IEEE division (the default), so that it
// rounds as pair_test_plain does, operation for operation.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLeaf = 128;                 // columns of a tile
constexpr int kTileFloats = 16 * kLeaf;    // a treelet's constants
constexpr uint32_t kTileBytes = kTileFloats * 4;
constexpr int kWarps = 4;                  // warps a block
constexpr int kThreads = 32 * kWarps;      // and pairs
constexpr int kWindow = 3;                 // tiles resident at a time
constexpr int kBlocksPerSm = 8;
constexpr float kInf = 3.0e38f;
constexpr float kDetEps = 1e-12f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait that outlasts two seconds is a fault of the ring: trap, so that the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > 2000000000ull) {
      __trap();
    }
  }
}

// Tell the barrier that `bytes` bytes of asynchronous copies are under way,
// and arrive on it.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One asynchronous copy of `bytes` contiguous bytes (a multiple of 16, both
// ends 16-byte aligned) from device memory to shared memory, counted on the
// barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

// s.e = f * a.e, and s.e = s.e + f * a.e, for the 4 columns of a group
__device__ __forceinline__ float4 mul4(float f, const float4& a) {
  return make_float4(f * a.x, f * a.y, f * a.z, f * a.w);
}

__device__ __forceinline__ float4 mad4(const float4& s, float f,
                                       const float4& a) {
  return make_float4(s.x + f * a.x, s.y + f * a.y, s.z + f * a.z,
                     s.w + f * a.w);
}

// A pair's ray as it lies in its feature row: d, o, G = o x d, the radius.
struct Ray {
  float dx, dy, dz, ox, oy, oz, gx, gy, gz, radius;
};

// One column's epilogue: sd = d . N = -det, st = t det, su = u det,
// sv = -(v det), the sums as the contractions leave them.
__device__ __forceinline__ void column(float sd, float st, float su, float sv,
                                       float radius, int c, float& tmin,
                                       int& col) {
  // |det|, and the sign of det folded into u, v and t by flipping their sign
  // bit: x * sgn(det) bit for bit wherever |det| >= eps (det = -0 or NaN
  // fail that test either way).  det = -sd, so det < 0 where sd's sign bit
  // is clear; v's sum carries one more negation.
  const uint32_t sd_sign = __float_as_uint(sd) & 0x80000000u;
  const uint32_t flip = sd_sign ^ 0x80000000u;
  const float ad = fabsf(sd);
  const float u = __uint_as_float(__float_as_uint(su) ^ flip);
  const float v = __uint_as_float(__float_as_uint(sv) ^ sd_sign);
  const float tt = __uint_as_float(__float_as_uint(st) ^ flip);
  if (ad >= kDetEps && u >= 0.0f && v >= 0.0f && u + v <= ad && tt > 0.0f &&
      tt < radius * ad) {
    const float t = tt / ad;
    if (t < tmin) {  // strict: the first column among equal t
      tmin = t;
      col = c;
    }
  }
}

// A pair against the 128 columns of its treelet's `tile`.
__device__ __forceinline__ void test_tile(const float* __restrict__ tile,
                                          const Ray& r, float& tmin,
                                          int& col) {
#pragma unroll 2
  for (int c = 0; c < kLeaf; c += 4) {
    const float* p = tile + c;
    // u det = G . e2 + d . P2: rows 6-8 and 12-14
    float4 su = mul4(r.gx, ld4(p + 6 * kLeaf));
    su = mad4(su, r.gy, ld4(p + 7 * kLeaf));
    su = mad4(su, r.gz, ld4(p + 8 * kLeaf));
    su = mad4(su, r.dx, ld4(p + 12 * kLeaf));
    su = mad4(su, r.dy, ld4(p + 13 * kLeaf));
    su = mad4(su, r.dz, ld4(p + 14 * kLeaf));
    // -(v det) = G . e1 + d . P1: rows 3-5 and 9-11
    float4 sv = mul4(r.gx, ld4(p + 3 * kLeaf));
    sv = mad4(sv, r.gy, ld4(p + 4 * kLeaf));
    sv = mad4(sv, r.gz, ld4(p + 5 * kLeaf));
    sv = mad4(sv, r.dx, ld4(p + 9 * kLeaf));
    sv = mad4(sv, r.dy, ld4(p + 10 * kLeaf));
    sv = mad4(sv, r.dz, ld4(p + 11 * kLeaf));
    // -det = d . N and t det = o . N - c0: rows 0-2 and 15
    const float4 n0 = ld4(p), n1 = ld4(p + kLeaf), n2 = ld4(p + 2 * kLeaf);
    const float4 sd = mad4(mad4(mul4(r.dx, n0), r.dy, n1), r.dz, n2);
    float4 st = mad4(mad4(mul4(r.ox, n0), r.oy, n1), r.oz, n2);
    const float4 c0 = ld4(p + 15 * kLeaf);
    st = make_float4(st.x - c0.x, st.y - c0.y, st.z - c0.z, st.w - c0.w);
    column(sd.x, st.x, su.x, sv.x, r.radius, c, tmin, col);
    column(sd.y, st.y, su.y, sv.y, r.radius, c + 1, tmin, col);
    column(sd.z, st.z, su.z, sv.z, r.radius, c + 2, tmin, col);
    column(sd.w, st.w, su.w, sv.w, r.radius, c + 3, tmin, col);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
pair_test_kernel(const float* __restrict__ consts,
                 const float* __restrict__ feats, const int* __restrict__ tid,
                 float* __restrict__ t_out, int* __restrict__ col_out, int n,
                 int n_treelets) {
  __shared__ __align__(128) float tiles[kWindow * kTileFloats];
  __shared__ int run_tid[kThreads];  // the treelet of each run
  __shared__ int warp_runs[kWarps];  // runs that start in each warp
  __shared__ __align__(8) unsigned long long bar;  // a window has landed
  const uint32_t tiles_a = smem_addr(tiles);
  const uint32_t bar_a = smem_addr(&bar);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool producer = threadIdx.x == 0;
  const int p = blockIdx.x * kThreads + threadIdx.x;  // the thread's pair

  if (producer) {
    mbar_init(bar_a, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // The runs of the block's pairs: a run starts at a pair of a treelet in
  // [0, K) whose predecessor in the block has another id.
  int k = p < n ? tid[p] : -1;
  if (k < 0 || k >= n_treelets) k = -1;
  const bool start = k >= 0 && (threadIdx.x == 0 || tid[p - 1] != k);
  const uint32_t starts = __ballot_sync(0xffffffffu, start);
  if (lane == 0) warp_runs[warp] = __popc(starts);
  __syncthreads();  // warp_runs, and the barrier's initial state
  int run = __popc(starts & (0xffffffffu >> (31 - lane))) - 1;
  int n_runs = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) run += warp_runs[w];
    n_runs += warp_runs[w];
  }
  // the run the pair lies in: as many runs start at or before it, less one
  if (k < 0) run = -1;
  if (start) run_tid[run] = k;

  // the pair's features, while the tiles are brought in
  Ray r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1.f};
  if (run >= 0) {
    const float4* f4 =
        reinterpret_cast<const float4*>(feats) + static_cast<size_t>(p) * 4;
    const float4 a = __ldg(f4 + 0);  // dx dy dz ox
    const float4 b = __ldg(f4 + 1);  // oy oz gx gy
    const float4 c = __ldg(f4 + 2);  // gz 1 maxt 0
    r = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.z};
  }
  float tmin = kInf;
  int col = -1;

  uint32_t parity = 0;
  for (int w0 = 0; w0 < n_runs; w0 += kWindow) {
    // run_tid is written, and every thread has left the window before
    __syncthreads();
    if (producer) {
      const int count = min(kWindow, n_runs - w0);
      // the threads' reads of the tiles before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_expect(bar_a, count * kTileBytes);
      for (int i = 0; i < count; ++i) {
        bulk_copy(tiles_a + i * kTileBytes,
                  consts + static_cast<size_t>(run_tid[w0 + i]) * kTileFloats,
                  kTileBytes, bar_a);
      }
    }
    mbar_wait(bar_a, parity);
    parity ^= 1;
    if (run >= w0 && run < w0 + kWindow) {
      test_tile(tiles + (run - w0) * kTileFloats, r, tmin, col);
    }
  }

  if (p < n) {
    t_out[p] = tmin;
    col_out[p] = tmin < kInf ? col : -1;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).  The
// caller guarantees 16-byte aligned consts and feats.
extern "C" int treelet_pair_test(const float* consts, const float* feats,
                                 const int* tid, float* t, int* col, int n,
                                 int n_treelets, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n - 1) / kThreads + 1;
  pair_test_kernel<<<grid, kThreads, 0, stream>>>(consts, feats, tid, t, col,
                                                  n, n_treelets);
  return static_cast<int>(cudaGetLastError());
}
