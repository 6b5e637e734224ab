// The transpose of a row gather from a small table, for Hopper (sm_90a):
// out[c][r] = sum of grads[c][i] over the i with idx[i] == r, for k columns
// sharing one index.
//
// Replaces no TPU kernel.  The JAX package's ops/gather.py::gather_cols
// routes small tables on the TPU through a one-hot matmul, whose transpose
// is another matmul; the port's forward is plain indexing, whose backward in
// PyTorch is index_put_(accumulate=True): it sorts the indices, then one
// warp walks each run of equal ones serially, about 14 ms for 262,144
// indices into 36 rows (a 512x512 training step made 90 such calls, 96% of
// its device time).  This kernel is that backward for the gathers of
// ops/gather.py.
//
// Bound.  Bytes: each index and its k gradient values read once,
// n * (4k + 8) bytes with int64 indices (5.2 MB for 262,144 indices at k = 3,
// 1.6 us at 3.35 TB/s), plus the blocks' partial tables (rows * k doubles a
// block, written once and read once) and the output.  There is almost no
// arithmetic: an add a value.  At the shapes of a training step the two
// launches' latency, not the bytes, sets the time.
//
// Design.  Sums are taken in double and rounded to float once, at the end,
// and in an order fixed by the shapes alone, so the result is the same bits
// from run to run (no float atomics) and within an ulp of the exact sum.
//   - First pass: block b takes indices [b * kChunk, (b + 1) * kChunk) and
//     each of its kWarps warps every kWarps-th batch of 32 of them, kUnroll
//     batches loaded before any is summed (coalesced loads, several in
//     flight a warp).  A batch's lanes split into runs of one row (a frame's
//     hits are coherent: a warp's 32 pixels mostly hit one or two
//     triangles); a tree of shuffles over each run (5 steps) leaves its sum
//     in the run's first lane.  The heads of one row's runs find each other
//     with __match_any_sync; the first of them adds their sums, in lane
//     order (read from a staging row in shared memory), to its warp's table
//     in shared memory.  Each warp owns its table, so no two lanes write
//     one entry at once.  The block then sums its warps' tables in warp
//     order into its partial table in device memory (partials[e * blocks +
//     b], entry e = row * k + column).  kChunk = 512 gives 512 blocks for a
//     512 x 512 frame, 16 warps an SM to hide the loads' latency.
//   Measured on the H100 (device time, 262,144 indices into 36 rows at
//     k = 3, in runs of 64 / on random rows): 9.8 / 12.0 us.  The first
//     design had the first lane of each row sum all its batch's values
//     serially: 73 / 21 us; the run trees with blocks of 2048 indices
//     (4 warps an SM): 23.6 / 31.5 us; the runs' heads added to the table
//     one at a time instead of grouped by __match_any_sync: 20.5 / 32.7 us.
//     index_put_, the backward of plain indexing: 2,409 / 2,211 us.
//   - Second pass: one warp an entry, its lanes over the blocks (lane l takes
//     blocks l, l + 32, ... in order), then a shuffle tree; lane 0 writes
//     out[column][row] as a float.  Every entry is written, so the output
//     needs no zeroing, and an empty index gives zeros.
//   - Shared memory: kWarps tables of rows * k doubles and the staging rows,
//     at most kTableMax entries (2048 rows at k = 3): 200 KB.  The wrapper
//     takes plain indexing for larger tables (few duplicates a row there:
//     another design, sort or atomics, would suit them).
// Negative indices count from the end, as indexing's do; an index outside
// [-rows, rows) is skipped (the forward's indexing has refused it already).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 512;       // indices a block (ops/gather.py CHUNK)
constexpr int kUnroll = 4;        // batches of 32 a warp loads at once
constexpr int kMaxCols = 3;       // ops/gather.py KMAX
constexpr int kTableMax = 6144;   // rows * k (ops/gather.py TABLE_MAX)
constexpr int kFinishThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory a block

struct Cols {
  const float* p[kMaxCols];
};

template <typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_transpose_partials_kernel(Cols cols, int k,
                                     const Index* __restrict__ idx,
                                     long long n, int rows,
                                     double* __restrict__ partials,
                                     int blocks) {
  extern __shared__ double smem[];
  const int entries = rows * k;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  double* table = smem + warp * entries;
  double* stage = smem + kWarps * entries + warp * 32 * kMaxCols;
  for (int e = threadIdx.x; e < kWarps * entries; e += kThreads) smem[e] = 0.0;
  __syncthreads();

  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(n, start + kChunk);
  for (long long base = start + warp * 32; base < end;
       base += kWarps * 32 * kUnroll) {
    int r[kUnroll];
    float v[kUnroll][kMaxCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i =
          base + static_cast<long long>(u) * kWarps * 32 + lane;
      const bool in = i < end;
      long long ri = in ? static_cast<long long>(idx[i]) : -1;
      if (in && ri < 0) ri += rows;
      r[u] = (in && ri >= 0 && ri < rows) ? static_cast<int>(ri) : -1;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        v[u][c] = (in && c < k) ? cols.p[c][i] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ru = r[u];
      // the batch's runs of one row: a run's head is its first lane, and
      // each lane's run ends before the next head
      const int prev = __shfl_up_sync(kAll, ru, 1);
      const unsigned heads = __ballot_sync(kAll, lane == 0 || prev != ru);
      const unsigned later =
          lane == 31 ? 0u : (heads >> (lane + 1)) << (lane + 1);
      const int last = later != 0u ? __ffs(later) - 2 : 31;
      double s[kMaxCols];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) s[c] = v[u][c];
      // a tree over each run: after the step of `off`, a lane holds the
      // sum of its run's lanes [lane, min(lane + 2 off - 1, last)]
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          if (c < k) {
            const double o = __shfl_down_sync(kAll, s[c], off);
            if (lane + off <= last) s[c] += o;
          }
        }
      }
      // the heads of one row's runs, summed by the first in lane order
      const bool head = (heads >> lane) & 1u;
      const unsigned peers = __match_any_sync(kAll, head ? ru : -1);
      if (head) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          if (c < k) stage[c * 32 + lane] = s[c];
        }
      }
      __syncwarp();
      if (head && ru >= 0 && lane == __ffs(peers) - 1) {
        for (int c = 0; c < k; ++c) {
          double t = 0.0;
          for (unsigned m = peers; m != 0u; m &= m - 1u) {
            t += stage[c * 32 + __ffs(m) - 1];
          }
          table[ru * k + c] += t;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < entries; e += kThreads) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += smem[w * entries + e];
    partials[static_cast<long long>(e) * blocks + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    gather_transpose_finish_kernel(const double* __restrict__ partials,
                                   int blocks, int entries, int k, int rows,
                                   float* __restrict__ out) {
  const int e = static_cast<int>(
      (static_cast<long long>(blockIdx.x) * kFinishThreads + threadIdx.x) >>
      5);
  const int lane = threadIdx.x & 31;
  if (e >= entries) return;  // whole warps: an entry is a warp's
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32) {
    s += partials[static_cast<long long>(e) * blocks + b];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(kAll, s, off);
  }
  if (lane == 0) {
    out[static_cast<long long>(e % k) * rows + e / k] = static_cast<float>(s);
  }
}

template <typename Index>
cudaError_t launch_partials(const Cols& c, int k, const void* idx, long long n,
                            int rows, double* partials, int blocks,
                            size_t smem, cudaStream_t stream) {
  auto kernel = gather_transpose_partials_kernel<Index>;
  if (smem > kDefaultSmem) {  // above the default only when asked for
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      c, k, static_cast<const Index*>(idx), n, rows, partials, blocks);
  return cudaGetLastError();
}

}  // namespace

// cols: a host array of k device pointers, each to n float32 gradients;
// idx: n indices of idx_bytes (4 or 8) bytes; partials: rows * k * blocks
// doubles of scratch, blocks = ceil(n / 512); out: (k, rows) float32.
// Launches both passes on `stream` and returns the first CUDA error of a
// launch (0 = launched).
extern "C" int gather_transpose(const float* const* cols, int k,
                                const void* idx, int idx_bytes, long long n,
                                int rows, double* partials, float* out,
                                cudaStream_t stream) {
  if (k < 1 || k > kMaxCols || rows < 0 || n < 0 ||
      static_cast<long long>(rows) * k > kTableMax ||
      (idx_bytes != 4 && idx_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int entries = rows * k;
  if (entries == 0) return 0;
  const long long blocks64 = (n + kChunk - 1) / kChunk;
  if (blocks64 > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>(blocks64);
  if (blocks > 0) {
    Cols c{};
    for (int i = 0; i < k; ++i) c.p[i] = cols[i];
    const size_t smem =
        (kWarps * entries + kWarps * 32 * kMaxCols) * sizeof(double);
    const cudaError_t err =
        idx_bytes == 8
            ? launch_partials<int64_t>(c, k, idx, n, rows, partials, blocks,
                                       smem, stream)
            : launch_partials<int32_t>(c, k, idx, n, rows, partials, blocks,
                                       smem, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long threads = static_cast<long long>(entries) * 32;
  const int grid =
      static_cast<int>((threads + kFinishThreads - 1) / kFinishThreads);
  gather_transpose_finish_kernel<<<grid, kFinishThreads, 0, stream>>>(
      partials, blocks, entries, k, rows, out);
  return static_cast<int>(cudaGetLastError());
}
