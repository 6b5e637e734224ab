// The transpose of a row gather, for Hopper (sm_90a): out[c][r] = sum of
// grads[c][i] over the i with idx[i] == r, for k columns sharing one index.
// Two designs, chosen by the table's size (ops/gather.py small_table): G1
// for tables of up to kTableMax entries (rows * k), G2 for larger ones.
//
// G1.  Replaces no TPU kernel.  The JAX package's ops/gather.py::gather_cols
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
//     at most kTableMax entries (2048 rows at k = 3): 200 KB.  Larger tables
//     take G2 (few duplicates a row there, and the partial tables, rows * k
//     doubles a block, would take gigabytes).
//
// G2.  Replaces no TPU kernel either: the JAX package's gather_cols sends
// only small tables through the one-hot matmul, and leaves larger ones (a
// BVH scene's triangles) to indexing, whose transpose is XLA's scatter-add.
// In the port that transpose was index_put_ a column at a time, which
// sorts the indices and walks each run of equal rows serially: 28 ms for a
// frame's three columns into cornell-tetra's tri_p0 (262,156 rows), 94.5%
// of the device time of a 1024x1024 training step, whose gathers hold a few
// rows (the room's walls, the light) with some 10^5 indices each and a long
// tail with 0 to 10.
//
// Bound.  Bytes: the index and the k columns read once, each entry (a
// distinct (block, row) pair) written and read once with its k double sums
// and its number, a count and a cursor a row written and read, and the
// output: about 6.9 us at 513,365 indices in a frame's order into 262,156
// rows x 3 (19% of them entries), 13.8 us at random rows, at 3.35 TB/s.
//
// Design.  The same blocks of kChunk indices as G1; every float sum in
// double, in an order fixed by the index positions; integer atomics only
// count and claim places, and no sum's order depends on them.
//   - Count: each block puts its batches' run heads in a hash table of the
//     rows it holds (shared memory, atomicCAS on the row) and adds 1 to
//     cnt[row] for each: the number of blocks holding each row.
//   - Alloc: a scan of cnt over 256 rows a block, one atomic a block for
//     its rows' segments (their places in memory follow the atomics, which
//     no sum depends on); rows no block holds get their zeros here, rows
//     held by more than kShortMax blocks go to the hot list.
//   - Sums: each block again, its batches' runs summed by G1's shuffle
//     trees and their heads grouped by __match_any_sync, then added to the
//     block's table of its rows warp by warp, a warp's batches in order, so
//     in position order.  Entry e = block * kChunk + slot keeps its k sums
//     at sums[e * k], and e goes to the next free place of its row's
//     segment: the segment is the row's blocks in any order, and since a
//     block holds a row once, e's order is the blocks' order.
//   - Short rows (1 to kShortMax blocks): one thread a row sorts its
//     segment (in registers up to kShortRegs entries) and sums it in block
//     order.
//   - Hot rows: a block a row, its blocks laid out by number in windows of
//     kWindow, 16 consecutive blocks a thread, a shuffle tree a warp, the
//     warps in order, the windows in order.
//   Scratch (ops/gather.py sorted_scratch): 4 + 8k bytes an index (an
//   entry number and k sums an entry, at most one entry an index) and 8
//   bytes a row, with the hot list; index_put_ sorts 8-byte keys and
//   8-byte positions, each with a copy, once a column.
//   Measured on the H100 (device time, 262,156 rows x 3; 513,365 /
//   1,048,576 indices): 37.2 / 54.9 us in a frame's order, 76.7 / 134.1 us
//   at random rows (count 4.5, alloc 3.7, sums 13.6, short rows 9.9, hot
//   rows 4.4 and the counts' zero fill 1.2 us of the 37.2); index_put_ on
//   the same columns 8,599 / 15,682 us and 626 / 1,057 us; a 1024x1024
//   training step's 12 calls 24-60 us each, 0.49 ms in all, where
//   index_put_ took 675 ms.  Dropped: the entries' sums copied into their
//   row's segment at placement, 51.0 / 73.5 and 99.1 / 209.1 us; the
//   segments claimed with one atomic a warp of rows, 50.7 / 70.3 and
//   81.6 / 142.5 us (the alloc pass 8.5 us for 3.7).
// In both, negative indices count from the end, as indexing's do; an index
// outside [-rows, rows) is skipped (the forward's indexing has refused it
// already), and every output entry is written, so none needs a zero fill.

#include <cuda_runtime.h>

#include <algorithm>
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
constexpr int kHash = 2 * kChunk;  // G2: a block's open-addressed row table
constexpr int kShortMax = 32;     // G2: blocks a row that one thread sums
constexpr int kShortRegs = 8;     // G2: of those, sorted in registers
constexpr int kWindow = 4096;     // G2: blocks a hot row's window
constexpr int kHotThreads = 256;  // G2: threads of a hot row's block
constexpr int kHotBlocks = 528;   // G2: blocks over the hot rows (4 an SM)
constexpr int kRowThreads = 256;  // G2: threads of the per-row kernels
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

// ---- G2: tables of more than kTableMax entries ----------------------------

// Warp w of a block takes the 4 consecutive batches of 32 indices at
// [start + 128 w, start + 128 w + 128): lane l's u-th index is
// start + 128 w + 32 u + l.  The row of index i, or -1 past the end or out
// of range.
template <typename Index>
__device__ __forceinline__ int row_at(const Index* __restrict__ idx,
                                      long long i, long long end,
                                      int rows) {
  if (i >= end) return -1;
  long long r = static_cast<long long>(idx[i]);
  if (r < 0) r += rows;
  return (r >= 0 && r < rows) ? static_cast<int>(r) : -1;
}

// Whether lane's index heads a run of one row in its batch.
__device__ __forceinline__ bool run_head(int r, int lane) {
  const int prev = __shfl_up_sync(kAll, r, 1);
  return lane == 0 || prev != r;
}

// Insert row r into the block's table (linear probing; at most kChunk
// distinct rows in kHash slots) and return its slot.
__device__ __forceinline__ int table_insert(int* keys, int r) {
  int h = static_cast<int>((static_cast<unsigned>(r) * 2654435761u) >>
                           (32 - 10));
  while (true) {
    const int old = atomicCAS(&keys[h], -1, r);
    if (old == -1 || old == r) return h;
    h = (h + 1) & (kHash - 1);
  }
}

// Pass 1: the number of blocks holding each row (cnt[row] += 1 for each
// distinct row of a block).
template <typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_sorted_count_kernel(const Index* __restrict__ idx, long long n,
                               int rows, int* __restrict__ cnt) {
  __shared__ int keys[kHash];
  for (int e = threadIdx.x; e < kHash; e += kThreads) keys[e] = -1;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(n, start + kChunk);
  int r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    r[u] = row_at(idx, start + warp * 128 + u * 32 + lane, end, rows);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (run_head(r[u], lane) && r[u] >= 0) table_insert(keys, r[u]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kHash; e += kThreads) {
    if (keys[e] >= 0) atomicAdd(&cnt[keys[e]], 1);
  }
}

// Pass 2: each row's segment of the entries (one a block holding the
// row): cur[row] = its first place, claimed with one atomic a block of
// rows; rows held by no block get their zeros here, rows held by more
// than kShortMax blocks go to the hot list.  The segments' places in
// memory are the atomics' order, which no sum depends on.
__global__ void __launch_bounds__(kRowThreads)
    gather_sorted_alloc_kernel(const int* __restrict__ cnt, int rows, int k,
                               int* __restrict__ top, int* __restrict__ cur,
                               int* __restrict__ n_hot,
                               int* __restrict__ hot,
                               float* __restrict__ out) {
  __shared__ int warp_total[kRowThreads / 32];
  __shared__ int block_base;
  const int r = blockIdx.x * kRowThreads + threadIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = r < rows ? cnt[r] : 0;
  int incl = m;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kRowThreads / 32; ++w) total += warp_total[w];
    block_base = total > 0 ? atomicAdd(top, total) : 0;
  }
  __syncthreads();
  if (r >= rows) return;
  if (m == 0) {
    for (int c = 0; c < k; ++c) out[static_cast<long long>(c) * rows + r] = 0.f;
    return;
  }
  int base = block_base + incl - m;
  for (int w = 0; w < warp; ++w) base += warp_total[w];
  cur[r] = base;
  if (m > kShortMax) hot[atomicAdd(n_hot, 1)] = r;
}

// Pass 3: a block's sums of the rows it holds, in double.  Each batch's
// runs summed by the trees of G1's first pass, the heads of one row in
// lane order; the block's table (a slot a distinct row, in the order of
// the row table) takes the warps' batch sums in turn, warp by warp and a
// warp's batches in order, so in position order.  Slot s of block b is
// entry e = b * kChunk + s: its k sums go to sums[e k ..] (a block's
// entries side by side), and e itself to the next free place of its
// row's segment.
template <typename Index>
__global__ void __launch_bounds__(kThreads)
    gather_sorted_sums_kernel(Cols cols, int k, const Index* __restrict__ idx,
                              long long n, int rows, int* __restrict__ cur,
                              int* __restrict__ seg,
                              double* __restrict__ sums) {
  constexpr int kPerThread = kHash / kThreads;
  __shared__ int keys[kHash];
  __shared__ int slot_of[kHash];
  __shared__ int slot_row[kChunk];
  __shared__ double table[kChunk * kMaxCols];
  __shared__ double stage[kWarps][kMaxCols][32];
  __shared__ int warp_slots[kWarps];
  for (int e = threadIdx.x; e < kHash; e += kThreads) keys[e] = -1;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long start = static_cast<long long>(blockIdx.x) * kChunk;
  const long long end = min(n, start + kChunk);
  int r[kUnroll];
  int h[kUnroll];
  float v[kUnroll][kMaxCols];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + warp * 128 + u * 32 + lane;
    r[u] = row_at(idx, i, end, rows);
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      v[u][c] = (i < end && c < k) ? cols.p[c][i] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool head = run_head(r[u], lane);
    h[u] = (head && r[u] >= 0) ? table_insert(keys, r[u]) : -1;
  }
  __syncthreads();
  // slots in the row table's order: thread t numbers the rows in its
  // kPerThread places after those of the threads before it
  int mine = 0;
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    mine += keys[threadIdx.x * kPerThread + q] >= 0;
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_slots[warp] = incl;
  __syncthreads();
  int next = incl - mine;
  for (int w = 0; w < warp; ++w) next += warp_slots[w];
  int slots = 0;
  for (int w = 0; w < kWarps; ++w) slots += warp_slots[w];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x * kPerThread + q;
    if (keys[e] >= 0) {
      slot_of[e] = next;
      slot_row[next++] = keys[e];
    }
  }
  for (int e = threadIdx.x; e < slots * k; e += kThreads) table[e] = 0.0;

  int lead[kUnroll];
  double t[kUnroll][kMaxCols];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int ru = r[u];
    const bool head = run_head(ru, lane);
    const unsigned heads = __ballot_sync(kAll, head);
    const unsigned later =
        lane == 31 ? 0u : (heads >> (lane + 1)) << (lane + 1);
    const int last = later != 0u ? __ffs(later) - 2 : 31;
    double s[kMaxCols];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) s[c] = v[u][c];
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
    const unsigned peers = __match_any_sync(kAll, head ? ru : -1);
    if (head) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < k) stage[warp][c][lane] = s[c];
      }
    }
    __syncwarp();
    lead[u] = -1;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) t[u][c] = 0.0;
    if (head && ru >= 0 && lane == __ffs(peers) - 1) {
      lead[u] = slot_of[h[u]];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < k) {
          for (unsigned m = peers; m != 0u; m &= m - 1u) {
            t[u][c] += stage[warp][c][__ffs(m) - 1];
          }
        }
      }
    }
    __syncwarp();
  }
  for (int w = 0; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (lead[u] >= 0) {
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) {
            if (c < k) table[lead[u] * k + c] += t[u][c];
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  const int first = blockIdx.x * kChunk;
  for (int e = threadIdx.x; e < slots * k; e += kThreads) {
    sums[static_cast<long long>(first) * k + e] = table[e];
  }
  for (int q = threadIdx.x; q < slots; q += kThreads) {
    seg[atomicAdd(&cur[slot_row[q]], 1)] = first + q;
  }
}

// Pass 4: a row held by 1 to kShortMax blocks, one thread: its entries
// (the segment ends at cur[row] after pass 3) in block order, summed one
// after the other.  Up to kShortRegs entries are held in registers and
// sorted there, their sums loaded together; more are taken as the least
// entry after the last, one at a time.
__global__ void __launch_bounds__(kRowThreads)
    gather_sorted_short_kernel(const int* __restrict__ cnt,
                               const int* __restrict__ cur,
                               const int* __restrict__ seg,
                               const double* __restrict__ sums, int rows,
                               int k, float* __restrict__ out) {
  const int r = blockIdx.x * kRowThreads + threadIdx.x;
  if (r >= rows) return;
  const int m = cnt[r];
  if (m == 0 || m > kShortMax) return;
  const int first = cur[r] - m;
  double s[kMaxCols] = {0.0, 0.0, 0.0};
  if (m <= kShortRegs) {
    int e[kShortRegs];
#pragma unroll
    for (int j = 0; j < kShortRegs; ++j) {
      e[j] = j < m ? seg[first + j] : INT_MAX;
    }
    // an odd-even transposition sort: kShortRegs rounds sort kShortRegs
#pragma unroll
    for (int round = 0; round < kShortRegs; ++round) {
#pragma unroll
      for (int j = round & 1; j + 1 < kShortRegs; j += 2) {
        const int lo = min(e[j], e[j + 1]);
        e[j + 1] = max(e[j], e[j + 1]);
        e[j] = lo;
      }
    }
    double v[kShortRegs][kMaxCols];
#pragma unroll
    for (int j = 0; j < kShortRegs; ++j) {
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        v[j][c] = (j < m && c < k)
                      ? sums[static_cast<long long>(e[j]) * k + c] : 0.0;
      }
    }
#pragma unroll
    for (int j = 0; j < kShortRegs; ++j) {
      if (j < m) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) s[c] += v[j][c];
      }
    }
  } else {
    int last = -1;
    for (int j = 0; j < m; ++j) {
      int best = INT_MAX;
      for (int q = first; q < first + m; ++q) {
        const int e = seg[q];
        if (e > last && e < best) best = e;
      }
      for (int c = 0; c < k; ++c) {
        s[c] += sums[static_cast<long long>(best) * k + c];
      }
      last = best;
    }
  }
  for (int c = 0; c < k; ++c) {
    out[static_cast<long long>(c) * rows + r] = static_cast<float>(s[c]);
  }
}

// Pass 5: a block a hot row (more than kShortMax blocks hold it), the
// blocks taken in windows of kWindow: each entry's place in the window
// by its block's number (one entry a block), then thread t sums places
// [16 t, 16 t + 16) in order, a shuffle tree a warp, the warps' sums in
// warp order; the windows one after the other.
__global__ void __launch_bounds__(kHotThreads)
    gather_sorted_hot_kernel(const int* __restrict__ cnt,
                             const int* __restrict__ cur,
                             const int* __restrict__ n_hot,
                             const int* __restrict__ hot,
                             const int* __restrict__ seg,
                             const double* __restrict__ sums, int blocks,
                             int rows, int k, float* __restrict__ out) {
  constexpr int kPer = kWindow / kHotThreads;
  constexpr int kHotWarps = kHotThreads / 32;
  __shared__ int place[kWindow];
  __shared__ double warp_sum[kHotWarps][kMaxCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hots = *n_hot;
  for (int i = blockIdx.x; i < hots; i += gridDim.x) {
    const int r = hot[i];
    const int m = cnt[r];
    const int first = cur[r] - m;
    double total[kMaxCols] = {0.0, 0.0, 0.0};
    for (int w0 = 0; w0 < blocks; w0 += kWindow) {
      for (int e = threadIdx.x; e < kWindow; e += kHotThreads) place[e] = -1;
      __syncthreads();
      for (int j = threadIdx.x; j < m; j += kHotThreads) {
        const int e = seg[first + j];
        const int b = e / kChunk - w0;
        if (b >= 0 && b < kWindow) place[b] = e;
      }
      __syncthreads();
      // the places' sums loaded together, then added in order (a place
      // without an entry adds nothing)
      double v[kPer][kMaxCols];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = place[threadIdx.x * kPer + q];
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          v[q][c] = (e >= 0 && c < k)
                        ? sums[static_cast<long long>(e) * k + c] : 0.0;
        }
      }
      double a[kMaxCols] = {0.0, 0.0, 0.0};
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (place[threadIdx.x * kPer + q] >= 0) {
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) a[c] += v[q][c];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          a[c] += __shfl_down_sync(kAll, a[c], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) warp_sum[warp][c] = a[c];
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int c = 0; c < k; ++c) {
          double ws = 0.0;
          for (int w = 0; w < kHotWarps; ++w) ws += warp_sum[w][c];
          total[c] += ws;
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      for (int c = 0; c < k; ++c) {
        out[static_cast<long long>(c) * rows + r] =
            static_cast<float>(total[c]);
      }
    }
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

// G2.  cols, k, idx, idx_bytes, n and rows as gather_transpose's, for any
// rows; ints: 2 rows + 2 + hot_cap + n int32 of scratch, hot_cap =
// min(rows, n / (kShortMax + 1) + 1) (ops/gather.py sorted_scratch);
// sums: k n doubles of scratch; out: (k, rows) float32.  Launches the
// zero fill of the counts and the five passes on `stream` and returns the
// first CUDA error (0 = launched).
extern "C" int gather_transpose_sorted(const float* const* cols, int k,
                                       const void* idx, int idx_bytes,
                                       long long n, int rows, int* ints,
                                       double* sums, float* out,
                                       cudaStream_t stream) {
  static_assert(kHash == 1024, "table_insert hashes to 10 bits");
  if (k < 1 || k > kMaxCols || rows < 0 || n < 0 || n > INT_MAX ||
      (idx_bytes != 4 && idx_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const long long hot_cap = std::min(static_cast<long long>(rows),
                                     n / (kShortMax + 1) + 1);
  int* cnt = ints;
  int* top = cnt + rows;
  int* n_hot = top + 1;
  int* cur = n_hot + 1;
  int* hot = cur + rows;
  int* seg = hot + hot_cap;
  cudaError_t err = cudaMemsetAsync(
      cnt, 0, (static_cast<size_t>(rows) + 2) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = static_cast<int>((n + kChunk - 1) / kChunk);
  if (blocks > 0) {
    if (idx_bytes == 8) {
      gather_sorted_count_kernel<int64_t><<<blocks, kThreads, 0, stream>>>(
          static_cast<const int64_t*>(idx), n, rows, cnt);
    } else {
      gather_sorted_count_kernel<int32_t><<<blocks, kThreads, 0, stream>>>(
          static_cast<const int32_t*>(idx), n, rows, cnt);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int row_grid = (rows + kRowThreads - 1) / kRowThreads;
  gather_sorted_alloc_kernel<<<row_grid, kRowThreads, 0, stream>>>(
      cnt, rows, k, top, cur, n_hot, hot, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
  Cols c{};
  for (int i = 0; i < k; ++i) c.p[i] = cols[i];
  if (idx_bytes == 8) {
    gather_sorted_sums_kernel<int64_t><<<blocks, kThreads, 0, stream>>>(
        c, k, static_cast<const int64_t*>(idx), n, rows, cur, seg, sums);
  } else {
    gather_sorted_sums_kernel<int32_t><<<blocks, kThreads, 0, stream>>>(
        c, k, static_cast<const int32_t*>(idx), n, rows, cur, seg, sums);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_sorted_short_kernel<<<row_grid, kRowThreads, 0, stream>>>(
      cnt, cur, seg, sums, rows, k, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hot_grid =
      static_cast<int>(std::min(hot_cap, static_cast<long long>(kHotBlocks)));
  gather_sorted_hot_kernel<<<hot_grid, kHotThreads, 0, stream>>>(
      cnt, cur, n_hot, hot, seg, sums, blocks, rows, k, out);
  return static_cast<int>(cudaGetLastError());
}
