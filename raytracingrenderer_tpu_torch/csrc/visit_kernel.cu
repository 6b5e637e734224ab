// Visits of a constants table by blocks of rays for Hopper (sm_90a): the
// K = 16 contraction under the treelet pair test, in the layouts and the
// two precisions that the matrix-unit probes measured; and the probes'
// dot and relayout kernels.
//
// Replaces the TPU kernels of the probe scripts (Pallas, one program per
// block of R = 4096 rays, on the TPU's matrix unit):
//   visit_run       scripts/probe_mxu.py::visit_kernel (:51, call :106),
//                   scripts/probe_mxu2.py::k_full, k_static_tile,
//                   k_no_reduce, k_rays_major, k_batched8 (:58-126, call
//                   :40) and scripts/probe_mxu3.py::k_full (:29, call :52);
//   visit_dot       the inline dot kernel of probe_mxu.py (:133, call :139);
//   visit_relayout  the inline relayout kernel of probe_mxu.py (:153, call
//                   :168).
// What each computes is written out in ops/visit.py (visit_plain,
// dot_plain, relayout_loop_plain), the kernels' reference on the card.
//
// The fp32 min visit (visit_min_kernel: k_full, k_static_tile, k_batched8
// and probe_mxu.py's visit at HIGHEST).  Per ray and visit 16 x TT
// multiply-adds and TT mins on operands that stay on chip: operations
// bound it, and since every product and sum is rounded (--fmad=false, for
// the bit-for-bit check) a multiply-add is two instructions, so the floor
// is the FP32 issue rate, half of the 67 TFLOP/s peak.  With one ray a
// thread the kernel is held below that floor by shared memory instead:
// every float4 of the tile, a broadcast load, feeds 32 instructions of one
// ray, and the load's return path is shared by the SM's four schedulers.
// The design:
//   - A thread holds the 16 features of 4 consecutive rays (64 registers),
//     so a float4 of the tile feeds 128 instructions in 16 independent
//     sums: a quarter of the loads a multiply-add.
//   - A warp so covers 128 rays.  A block is 8 warps over the same 128
//     rays; warp w takes columns [w TT/8, (w+1) TT/8) of every tile and
//     keeps its own running min.  The mins of the 8 warps meet once, after
//     the last visit, through shared memory: a min is exact in any order
//     and every sum is left as it was, so the result equals the plain
//     version's bit for bit.  256 blocks of 256 threads, two to an SM at
//     no more than 128 registers, fill 124 of the 132 SMs twice over.
//   - A tile (16 consecutive rows of the table) is one contiguous block of
//     memory, so one thread brings it in with one cp.async.bulk, completion
//     counted on an mbarrier.  A ring of up to 3 tiles (as many as fit half
//     of the SM's shared memory, so that a second block stays resident) is
//     kept full: the sequence of tiles is known ahead.  A warp waits on the
//     tile's `full` barrier, computes, and arrives on its `empty` barrier;
//     the producer thread refills a slot when all 8 warps have left it.  No
//     barrier of the whole block stands in the loop.  A batched step is 8
//     visits of 8 consecutive tiles, not laid side by side: a min over all
//     its columns does not care where a column sits.  (A 64 KB slot a step
//     leaves room for one slot, or one block an SM: both measured slower.)
// The pair test (csrc/treelet_kernel.cu) is the same contraction with an
// epilogue a column.  It took over the float4 of columns and the bulk copy
// of a treelet's constants on an mbarrier, but not the 4 rays (there: pairs)
// a thread: its pairs change treelet every few dozen, a warp of 128 pairs
// would test every tile it straddles, and measured slower than one pair a
// thread that reads its own treelet's tile.
//
// The lane visit (visit_lane_kernel, fp32, the counterpart of k_rays_major,
// whose (R, 16) x (16, TT) product takes its min over TT across lanes) does
// the min visit's multiply-adds and mins on its own layout: a warp takes 16
// rays, lane l holds columns 4l .. 4l + 3 of the tile in registers (a float4
// of each row, 64 values) and reads each ray's features from shared memory
// (four broadcast float4).  Its first design staged every tile with the
// whole block between two barriers and, for each ray and visit, ran a
// 5-step butterfly of shuffles and mins on the dependent chain: about 11 of
// every 150 instructions, and a shuffle's latency each step.  Now:
//   - the tiles come through the min visit's ring of bulk copies on full /
//     empty mbarriers, and a warp leaves a slot as soon as its columns are
//     in registers; no barrier of the whole block stands in the loop;
//   - each lane keeps a running min of each of its warp's rays over its
//     own columns of every visit, and the butterfly runs once, after the
//     last visit.
// The running mins live in shared memory, a load and a store a ray-visit,
// in a loop of 2 rays a step, and a warp takes 16 rays, not 32 (PERF.md, PR
// 8): 32 mins in registers need the rays' loop unrolled, some 4,200
// instructions a visit, which ran 7% slower than the rolled loop (its code
// outgrows the instruction caches); 16 rays a warp then give the card twice
// the warps to hide latency with, 3.5% more.
//
// The other visit kernels keep their first design: one thread block over
// 128 rays, the visited tile staged in dynamic shared memory by the whole
// block, float4 by float4, between two barriers.
//   ray layout (visit_ray_kernel: the MT epilogue, whose test needs the
//     ray's best t as it stood before the visit, and reduce "first8", 8
//     columns a visit): one thread per ray, its 16 features in registers,
//     the tile read as float4 broadcasts.
//   TF32 (precision "default"): mma.sync.m16n8k8 with TF32 operands, two
//     k-steps for K = 16; what XLA does on a GPU for an f32 dot at DEFAULT
//     precision.  A warp takes 32 rays (4 n-tiles of 8).  The features
//     are rounded (cvt.rna.tf32.f32) into B fragments once; the tile is
//     rounded as it is staged, its rows padded to TT + 8 floats so that
//     the A-fragment loads of a warp fall in 32 distinct banks; per
//     16-triangle m-tile each lane folds its accumulator rows into a
//     running min, and the min across the 8 lanes of a fragment column is
//     taken once, after the last visit.  It runs its multiply-adds on the
//     tensor cores (495 TFLOP/s dense, through wgmma; mma.sync reaches
//     less) and its min on the FP32 pipes.
// The fp32 kernels sum K left to right, every product and sum rounded,
// and min is exact, so they equal the plain version bit for bit in any
// layout.  The TF32 kernel differs from its plain version only in the
// tensor core's accumulation order and rounding (ops/visit.py,
// TF32_KERNEL_BOUND).
//
// The dot kernel (P1b) writes the whole (TT, R) product, 2 MB for 17
// MFLOP at the probe's size: bytes bound it (0.7 us), but a launch of
// this size cannot take less than the card's floor for any launch (an
// empty kernel of the same grid, visit_floor), and the arithmetic without
// FMA is 0.5 us of issue on all SMs.  With one ray and 16 rows a thread
// the fp32 kernel issued a scalar load of `a` for every product, 256 a
// thread, and a load of one global address by a whole warp costs as a full
// load.  Now (dot_fp32_kernel) a thread holds a float4 of 4 consecutive
// rays of each of b's 16 rows and computes kDotRows consecutive rows of the
// output for them; the block's slice of `a` is staged once in shared
// memory, where a read of one address by the whole warp is a broadcast; a
// value of `a` serves 4 rays, 4 kDotRows sums are in flight, and `out` is
// written as float4s.  A block's warps take consecutive row groups of the
// same 128 rays, so b's loads of all but the first warp are served by L1.
// TF32 (dot_tf32_kernel): one warp per 16 x 32 tile of the output.
//
// The relayout kernel (P1c).  No relayout exists here: a torch tensor's
// shape is its strides, and a reshape of a contiguous (32, 128) block to
// (1, 4096) moves no data, where the TPU moves values between its (8, 128)
// register tiles.  What is left is n_iter additions of 1.0 per element,
// kept in a register, and its 2 MB of reads and writes bound it.  It is a
// trivial elementwise pass; it stays CUDA to keep one build per source.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kK = 16;        // feature rows: the contraction depth
constexpr int kSpan = 128;    // rays of a thread block
constexpr int kRows = 8;      // rows of reduce "first8"
constexpr float kBig = 3.0e38f;
constexpr float kDetEps = 1e-12f;
// an SM's shared memory (228 KB, 1 KB of it kept back for each block) shared
// by two blocks: what a ring may take and leave room for a second block
constexpr int kRingBudget = (228 / 2 - 1) * 1024;

enum TileMode { kDynamic, kStatic, kBatched8 };
enum Reduce { kFirst8, kMt };

// The tile that visit i reads; in a batched run, whose step i / 8 reads 8
// consecutive tiles, the (i % 8)-th of them.
template <int kMode>
__device__ __forceinline__ int tile_of(int i, int n_tiles) {
  if (kMode == kStatic) return 0;
  if (kMode == kBatched8) return 8 * ((i / 8 * 7) % (n_tiles / 8)) + i % 8;
  return (i * 7) % n_tiles;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Stage tile `tile` of the table into s as a 16 x tt row-major matrix with
// a row stride of `stride` floats; with kRound, rounded to TF32.
// Consecutive threads of the 128 read consecutive float4s of the table.
template <bool kRound>
__device__ __forceinline__ void stage(float* s, const float* __restrict__ tab,
                                      int tile, int tt, int stride) {
  const int q4 = tt / 4;
  const float4* src = reinterpret_cast<const float4*>(tab) +
                      static_cast<size_t>(tile) * kK * q4;
  for (int e = threadIdx.x; e < kK * q4; e += kSpan) {
    const int row = e / q4;
    const int j4 = e - row * q4;
    float4 v = __ldg(src + e);
    if (kRound) {
      v.x = __uint_as_float(to_tf32(v.x));
      v.y = __uint_as_float(to_tf32(v.y));
      v.z = __uint_as_float(to_tf32(v.z));
      v.w = __uint_as_float(to_tf32(v.w));
    }
    *reinterpret_cast<float4*>(s + row * stride + 4 * j4) = v;
  }
}

__device__ __forceinline__ float4 ld4(const float* s) {
  return *reinterpret_cast<const float4*>(s);
}

// o: the sum of a ray's 16 features, left to right.
__device__ __forceinline__ void write_feature_sum(
    const float* __restrict__ feats, float* __restrict__ o_out, int b, int r,
    int ray) {
  const float* fb = feats + static_cast<size_t>(b) * kK * r + ray;
  float s = fb[0];
#pragma unroll
  for (int k = 1; k < kK; ++k) s = s + fb[static_cast<size_t>(k) * r];
  o_out[static_cast<size_t>(b) * r + ray] = s;
}

// ------------------------------------------------- the fp32 min visit (P1a)
constexpr int kMinWarps = 8;   // warps of a block: the column slices
constexpr int kMinThreads = 32 * kMinWarps;
constexpr int kRays = 4;       // consecutive rays a thread
constexpr int kMinSpan = 32 * kRays;  // rays of a block: kSpan
constexpr int kMaxStages = 3;  // tiles the ring holds at most
// shared memory beside the ring: the warps' mins, the full and empty barriers
constexpr int kMinFixed = kMinWarps * kMinSpan * 4 + 2 * kMaxStages * 8;
static_assert(kMinSpan == kSpan, "ops/visit.py checks R against SPAN");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

// One asynchronous copy of `bytes` contiguous bytes (a multiple of 16, both
// ends 16-byte aligned) from device memory to shared memory; the bytes are
// counted on the barrier, on which the caller arrives here too.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Dynamic shared memory: the ring (`stages` slots of one tile, 16 x tt
// floats as they lie in the table), the warps' mins (kMinWarps x kMinSpan
// floats), then the barriers full[kMaxStages] and empty[kMaxStages].  Visit
// i lives in slot i % stages and is the (i / stages)-th use of that slot,
// which is the parity it waits with.  A batched step is 8 visits, of 8
// consecutive tiles: a min over all its columns does not care whether they
// lie side by side.
template <int kMode>
__global__ void __launch_bounds__(kMinThreads, 2)
visit_min_kernel(const float* __restrict__ tab,
                 const float* __restrict__ feats, float* __restrict__ t_out,
                 float* __restrict__ o_out, int r, int tt, int n_tiles,
                 int n_visits, int stages) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tile_floats = kK * tt;
  float* comb = ring + static_cast<size_t>(stages) * tile_floats;
  const uint32_t ring_a = smem_addr(ring);
  const uint32_t full_a = smem_addr(comb + kMinWarps * kMinSpan);
  const uint32_t empty_a = full_a + 8 * kMaxStages;
  const uint32_t tile_bytes = static_cast<uint32_t>(tile_floats) * 4;
  const int visits = kMode == kBatched8 ? n_visits / 8 * 8 : n_visits;
  // tiles brought in: the static one once
  const int loads = kMode == kStatic ? (visits > 0 ? 1 : 0) : visits;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ray0 = blockIdx.x * kMinSpan;
  const bool producer = threadIdx.x == 0;

  const auto load_tile = [&](int j) {  // the tile of visit j
    const int s = j % stages;
    bulk_load(ring_a + s * tile_bytes,
              tab + static_cast<size_t>(tile_of<kMode>(j, n_tiles)) *
                        tile_floats,
              tile_bytes, full_a + 8 * s);
  };
  if (producer) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, kMinWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    for (int j = 0; j < stages && j < loads; ++j) load_tile(j);
  }

  // the features of rays ray0 + kRays lane .. + kRays - 1, while the first
  // tiles arrive
  float f[kRays][kK];
  {
    const float* fb =
        feats + static_cast<size_t>(b) * kK * r + ray0 + kRays * lane;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        f[j][k] = __ldg(fb + static_cast<size_t>(k) * r + j);
      }
    }
  }
  float m[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) m[j] = kBig;
  const int cols = tt / kMinWarps;  // this warp's columns of a tile: 4 | cols

  int s = 0;             // visit i's slot, i % stages, and
  uint32_t parity = 0;   // the parity of its use of it, (i / stages) & 1
  for (int i = 0; i < visits; ++i) {
    if (kMode != kStatic || i == 0) mbar_wait(full_a + 8 * s, parity);
    const float* tile =
        ring + static_cast<size_t>(s) * tile_floats + warp * cols;
    for (int c = 0; c < cols; c += 4) {
      const float* p = tile + c;
      float sum[kRays][4];
      float4 a = ld4(p);
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        sum[j][0] = a.x * f[j][0]; sum[j][1] = a.y * f[j][0];
        sum[j][2] = a.z * f[j][0]; sum[j][3] = a.w * f[j][0];
      }
#pragma unroll
      for (int k = 1; k < kK; ++k) {
        p += tt;
        a = ld4(p);
#pragma unroll
        for (int j = 0; j < kRays; ++j) {
          sum[j][0] = sum[j][0] + a.x * f[j][k];
          sum[j][1] = sum[j][1] + a.y * f[j][k];
          sum[j][2] = sum[j][2] + a.z * f[j][k];
          sum[j][3] = sum[j][3] + a.w * f[j][k];
        }
      }
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        m[j] = fminf(m[j], fminf(fminf(sum[j][0], sum[j][1]),
                                 fminf(sum[j][2], sum[j][3])));
      }
    }
    if (kMode != kStatic) {
      // this warp has left slot s; when all have, the producer refills it
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_a + 8 * s);
      if (producer && i + stages < loads) {
        mbar_wait(empty_a + 8 * s, parity);
        // the warps' reads of the slot before the copy engine's writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load_tile(i + stages);
      }
      if (++s == stages) {
        s = 0;
        parity ^= 1;
      }
    }
  }

  // The warps' mins meet.  A min is exact in any grouping; where a ray's
  // least value is a zero, the grouping may pick -0.0 where the plain
  // version has +0.0 (or the reverse), which compare equal.
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    comb[warp * kMinSpan + kRays * lane + j] = m[j];
  }
  __syncthreads();
  if (threadIdx.x < kMinSpan) {
    float v = comb[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kMinWarps; ++w) {
      v = fminf(v, comb[w * kMinSpan + threadIdx.x]);
    }
    t_out[static_cast<size_t>(b) * r + ray0 + threadIdx.x] = v;
    write_feature_sum(feats, o_out, b, r, ray0 + threadIdx.x);
  }
}

// ---------------------------------------------------------------- ray layout
// One thread per ray, visit i reads tile (i * 7) % n_tiles: reduce "first8"
// and the MT epilogue.
template <int kReduce>
__global__ void __launch_bounds__(kSpan)
visit_ray_kernel(const float* __restrict__ tab,
                 const float* __restrict__ feats, float* __restrict__ t_out,
                 float* __restrict__ o_out, int r, int tt, int n_tiles,
                 int n_visits) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int ray = blockIdx.x * kSpan + threadIdx.x;
  const float* fb = feats + static_cast<size_t>(b) * kK * r + ray;
  float f[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) f[k] = fb[static_cast<size_t>(k) * r];
  constexpr int kAcc = kReduce == kFirst8 ? kRows : 1;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = kBig;

  for (int i = 0; i < n_visits; ++i) {
    __syncthreads();  // every thread is done with the previous tile
    stage<false>(s, tab, tile_of<kDynamic>(i, n_tiles), tt, tt);
    __syncthreads();
    if (kReduce == kFirst8) {
      // rows 0..7 of the product: the tile's first 8 columns
      float sum[kRows];
      float4 a = ld4(s), a2 = ld4(s + 4);
      sum[0] = a.x * f[0]; sum[1] = a.y * f[0]; sum[2] = a.z * f[0];
      sum[3] = a.w * f[0]; sum[4] = a2.x * f[0]; sum[5] = a2.y * f[0];
      sum[6] = a2.z * f[0]; sum[7] = a2.w * f[0];
#pragma unroll
      for (int k = 1; k < kK; ++k) {
        a = ld4(s + k * tt);
        a2 = ld4(s + k * tt + 4);
        sum[0] = sum[0] + a.x * f[k]; sum[1] = sum[1] + a.y * f[k];
        sum[2] = sum[2] + a.z * f[k]; sum[3] = sum[3] + a.w * f[k];
        sum[4] = sum[4] + a2.x * f[k]; sum[5] = sum[5] + a2.y * f[k];
        sum[6] = sum[6] + a2.z * f[k]; sum[7] = sum[7] + a2.w * f[k];
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = fminf(acc[j], sum[j]);
    } else {
      // the constant-form MT epilogue: columns [det | tdet | udet | vdet]
      // of q = tt / 4 triangles, every one held to the ray's best t as
      // it stood before this visit
      const int q = tt / 4;
      const float tb = acc[0];
      float m = acc[0];
      // two groups of 4 triangles in flight: without it the compiler leaves
      // the loads of a group one step ahead of their use
#pragma unroll 2
      for (int c = 0; c < q; c += 4) {
        float sm[4][4];  // [quarter][triangle]
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 a = ld4(s + h * q + c);
          sm[h][0] = a.x * f[0]; sm[h][1] = a.y * f[0];
          sm[h][2] = a.z * f[0]; sm[h][3] = a.w * f[0];
        }
#pragma unroll
        for (int k = 1; k < kK; ++k) {
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float4 a = ld4(s + k * tt + h * q + c);
            sm[h][0] = sm[h][0] + a.x * f[k];
            sm[h][1] = sm[h][1] + a.y * f[k];
            sm[h][2] = sm[h][2] + a.z * f[k];
            sm[h][3] = sm[h][3] + a.w * f[k];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float det = sm[0][e];
          const float sgn = det < 0.0f ? -1.0f : 1.0f;
          const float ad = det * sgn;
          const float st = sm[1][e] * sgn;
          const float su = sm[2][e] * sgn;
          const float sv = sm[3][e] * sgn;
          if (ad >= kDetEps && su >= 0.0f && sv >= 0.0f && su + sv <= ad &&
              st > 0.0f && st < tb * ad) {
            m = fminf(m, st / ad);
          }
        }
      }
      acc[0] = m;
    }
  }
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    t_out[(static_cast<size_t>(b) * kAcc + j) * r + ray] = acc[j];
  }
  write_feature_sum(feats, o_out, b, r, ray);
}

// --------------------------------------------------------------- lane layout
constexpr int kLaneTT = 128;
constexpr int kLaneWarps = 4;                      // warps of a block
constexpr int kLaneRays = 16;                      // rays of a warp
constexpr int kLaneThreads = 32 * kLaneWarps;
constexpr int kLaneSpan = kLaneWarps * kLaneRays;  // rays of a block
constexpr int kLaneTile = kK * kLaneTT * 4;        // bytes of a tile
// shared memory beside the ring: the block's features, the barriers
constexpr int kLaneFixed = kLaneSpan * kK * 4 + 2 * kMaxStages * 8;
static_assert(kSpan % kLaneSpan == 0, "ops/visit.py checks R against SPAN");
static_assert(kLaneRays <= 32, "lane j of a warp writes its ray j");

// Dynamic shared memory: the ring (`stages` slots of one 16 x 128 tile as it
// lies in the table), the block's features ray-major (16 floats a ray), then
// the barriers full[kMaxStages] and empty[kMaxStages]; visit i lives in slot
// i % stages with parity (i / stages) & 1, as in visit_min_kernel.  Lane l
// takes columns 4l .. 4l + 3 of every tile (a float4 of each row) and keeps,
// for each of its warp's kLaneRays rays, the running min over its own
// columns of every visit, in static shared memory (acc: a word of its own a
// lane and ray); the min across the lanes is taken once, after the last
// visit.  A warp leaves a slot as soon as its columns are in registers.
__global__ void __launch_bounds__(kLaneThreads)
visit_lane_kernel(const float* __restrict__ tab,
                  const float* __restrict__ feats, float* __restrict__ t_out,
                  float* __restrict__ o_out, int r, int n_tiles, int n_visits,
                  int stages) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  float4* sf = smem4 + stages * (kLaneTile / 16);
  const uint32_t ring_a = smem_addr(ring);
  const uint32_t full_a = smem_addr(sf + kLaneSpan * (kK / 4));
  const uint32_t empty_a = full_a + 8 * kMaxStages;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kLaneSpan;
  const bool producer = threadIdx.x == 0;

  const auto load_tile = [&](int j) {  // the tile of visit j
    const int s = j % stages;
    bulk_load(ring_a + s * kLaneTile,
              tab + static_cast<size_t>(tile_of<kDynamic>(j, n_tiles)) * kK *
                        kLaneTT,
              kLaneTile, full_a + 8 * s);
  };
  if (producer) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, kLaneWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  {
    float* sff = reinterpret_cast<float*>(sf);
    const float* fb = feats + static_cast<size_t>(b) * kK * r + r0;
    for (int e = threadIdx.x; e < kLaneSpan * kK; e += kLaneThreads) {
      const int k = e / kLaneSpan, ray = e - k * kLaneSpan;
      sff[ray * kK + k] = fb[static_cast<size_t>(k) * r + ray];
    }
  }
  __syncthreads();
  if (producer) {
    for (int j = 0; j < stages && j < n_visits; ++j) load_tile(j);
  }

  const float4* fw = sf + warp * kLaneRays * (kK / 4);
  // this lane's running min of each ray of the warp: its own words, which
  // no other thread reads or writes, so no barrier orders them
  __shared__ float acc[kLaneWarps][kLaneRays][32];
  for (int j = 0; j < kLaneRays; ++j) acc[warp][j][lane] = kBig;
  int s = 0;             // visit i's slot, i % stages, and
  uint32_t parity = 0;   // the parity of its use of it, (i / stages) & 1
  for (int i = 0; i < n_visits; ++i) {
    mbar_wait(full_a + 8 * s, parity);
    float4 a[kK];  // columns 4 lane .. 4 lane + 3, row by row
    const float4* tile =
        reinterpret_cast<const float4*>(ring + s * (kLaneTile / 4)) + lane;
#pragma unroll
    for (int k = 0; k < kK; ++k) a[k] = tile[k * (kLaneTT / 4)];
    // this warp has left slot s; when all have, the producer refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_a + 8 * s);
    if (producer && i + stages < n_visits) {
      mbar_wait(empty_a + 8 * s, parity);
      // the warps' reads of the slot before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(i + stages);
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
#pragma unroll 2
    for (int j = 0; j < kLaneRays; ++j) {  // 2 rays a step
      float f[kK];
#pragma unroll
      for (int k4 = 0; k4 < kK / 4; ++k4) {  // a broadcast load a float4
        const float4 v = fw[j * (kK / 4) + k4];
        f[4 * k4] = v.x; f[4 * k4 + 1] = v.y;
        f[4 * k4 + 2] = v.z; f[4 * k4 + 3] = v.w;
      }
      float s0 = a[0].x * f[0], s1 = a[0].y * f[0];
      float s2 = a[0].z * f[0], s3 = a[0].w * f[0];
#pragma unroll
      for (int k = 1; k < kK; ++k) {
        s0 = s0 + a[k].x * f[k];
        s1 = s1 + a[k].y * f[k];
        s2 = s2 + a[k].z * f[k];
        s3 = s3 + a[k].w * f[k];
      }
      float& m = acc[warp][j][lane];
      m = fminf(m, fminf(fminf(s0, s1), fminf(s2, s3)));
    }
  }

  // The min across the lanes, once: a 5-step butterfly a ray, lane j keeps
  // ray j's.  A min is exact in any grouping; where a ray's least value is
  // a zero, the grouping may pick -0.0 where the plain version has +0.0 (or
  // the reverse), which compare equal.
  float mine = kBig;
#pragma unroll
  for (int j = 0; j < kLaneRays; ++j) {
    float m = acc[warp][j][lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == j) mine = m;
  }
  if (lane < kLaneRays) {
    t_out[static_cast<size_t>(b) * r + r0 + warp * kLaneRays + lane] = mine;
  }
  for (int ray = threadIdx.x; ray < kLaneSpan; ray += kLaneThreads) {
    write_feature_sum(feats, o_out, b, r, r0 + ray);
  }
}

// ---------------------------------------------------------------------- TF32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of k-step ks for the 16 rows (triangles) from m0 of a 16 x N
// matrix s (row stride `stride`) read as its transpose: A[m][k] = s[k][m].
// a0 (m = g, k = q), a1 (m = g+8, k = q), a2 (m = g, k = q+4),
// a3 (m = g+8, k = q+4), g = lane / 4, q = lane % 4.
template <typename Load>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], Load load,
                                           int ks, int m0, int g, int q) {
  a[0] = load(ks * 8 + q, m0 + g);
  a[1] = load(ks * 8 + q, m0 + g + 8);
  a[2] = load(ks * 8 + q + 4, m0 + g);
  a[3] = load(ks * 8 + q + 4, m0 + g + 8);
}

__global__ void __launch_bounds__(kSpan)
visit_tf32_kernel(const float* __restrict__ tab,
                  const float* __restrict__ feats, float* __restrict__ t_out,
                  float* __restrict__ o_out, int r, int tt, int n_tiles,
                  int n_visits) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int stride = tt + 8;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r_w = blockIdx.x * kSpan + warp * 32;  // the warp's first ray
  const float* fb = feats + static_cast<size_t>(b) * kK * r + r_w;
  // B fragments (k x n = feature x ray): b0 (k = q, n = g), b1 (k = q+4)
  uint32_t bf[4][2][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      bf[nt][ks][0] =
          to_tf32(fb[static_cast<size_t>(ks * 8 + q) * r + nt * 8 + g]);
      bf[nt][ks][1] =
          to_tf32(fb[static_cast<size_t>(ks * 8 + q + 4) * r + nt * 8 + g]);
    }
  }
  float mn[4][2];  // [n-tile][column 2q, 2q+1 of it]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) mn[nt][0] = mn[nt][1] = kBig;
  const auto load = [&](int k, int m) {
    return __float_as_uint(s[k * stride + m]);
  };

  for (int i = 0; i < n_visits; ++i) {
    __syncthreads();
    stage<true>(s, tab, tile_of<kDynamic>(i, n_tiles), tt, stride);
    __syncthreads();
    for (int m0 = 0; m0 < tt; m0 += 16) {
      uint32_t a0[4], a1[4];
      a_fragment(a0, load, 0, m0, g, q);
      a_fragment(a1, load, 1, m0, g, q);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(d, a0, bf[nt][0][0], bf[nt][0][1]);
        mma_tf32(d, a1, bf[nt][1][0], bf[nt][1][1]);
        // d0, d1: rows g, columns 2q, 2q+1; d2, d3: rows g + 8
        mn[nt][0] = fminf(mn[nt][0], fminf(d[0], d[2]));
        mn[nt][1] = fminf(mn[nt][1], fminf(d[1], d[3]));
      }
    }
  }
  // the min over the 8 lanes (g) that share a fragment column
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mn[nt][e] =
            fminf(mn[nt][e], __shfl_xor_sync(0xffffffffu, mn[nt][e], off));
      }
    }
  }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* out = t_out + static_cast<size_t>(b) * r + r_w + nt * 8 + 2 * q;
      out[0] = mn[nt][0];
      out[1] = mn[nt][1];
    }
  }
  write_feature_sum(feats, o_out, b, r, blockIdx.x * kSpan + threadIdx.x);
}

// ----------------------------------------------------------------------- dot
// fp32: a thread takes 4 consecutive rays (a float4 of each of b's 16 rows,
// in registers) and kDotRows consecutive rows of the output; a block's
// warps take consecutive row groups of the same 128 rays, and the block's
// slice of a (16 x kDotBlockRows) goes through shared memory.
constexpr int kDotRows = 8;
constexpr int kDotWarps = 4;
constexpr int kDotBlockRows = kDotWarps * kDotRows;

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 mul4(float a, const float4& f) {
  return make_float4(a * f.x, a * f.y, a * f.z, a * f.w);
}

__device__ __forceinline__ float4 add4(const float4& s, const float4& p) {
  return make_float4(s.x + p.x, s.y + p.y, s.z + p.z, s.w + p.w);
}

__global__ void __launch_bounds__(32 * kDotWarps)
dot_fp32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int tt, int r) {
  __shared__ float4 sa[kK][kDotBlockRows / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mb = blockIdx.y * kDotBlockRows;
  const int ray = blockIdx.x * kSpan + 4 * lane;
  float4 f[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    f[k] = ldg4(b + static_cast<size_t>(k) * r + ray);
  }
  // rows mb .. of a^T (tt is a multiple of 16: a float4 never straddles it)
  for (int e = threadIdx.x; e < kK * (kDotBlockRows / 4);
       e += 32 * kDotWarps) {
    const int k = e / (kDotBlockRows / 4), q = e % (kDotBlockRows / 4);
    if (mb + 4 * q < tt) sa[k][q] = ldg4(a + k * tt + mb + 4 * q);
  }
  __syncthreads();
  const int m0 = mb + warp * kDotRows;
  if (m0 >= tt) return;
  float4 sum[kDotRows];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
#pragma unroll
    for (int j = 0; j < kDotRows / 4; ++j) {
      // one address for the whole warp: a broadcast
      const float4 v = sa[k][warp * (kDotRows / 4) + j];
      if (k == 0) {
        sum[4 * j] = mul4(v.x, f[0]);
        sum[4 * j + 1] = mul4(v.y, f[0]);
        sum[4 * j + 2] = mul4(v.z, f[0]);
        sum[4 * j + 3] = mul4(v.w, f[0]);
      } else {
        sum[4 * j] = add4(sum[4 * j], mul4(v.x, f[k]));
        sum[4 * j + 1] = add4(sum[4 * j + 1], mul4(v.y, f[k]));
        sum[4 * j + 2] = add4(sum[4 * j + 2], mul4(v.z, f[k]));
        sum[4 * j + 3] = add4(sum[4 * j + 3], mul4(v.w, f[k]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kDotRows; ++j) {
    *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + j) * r + ray) =
        sum[j];
  }
}

// TF32: one warp per 16 x 32 tile of the output (4 n-tiles of 8 rays).
__global__ void __launch_bounds__(kSpan)
dot_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int tt, int r) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r_w = blockIdx.x * kSpan + warp * 32;
  const int m0 = blockIdx.y * 16;
  const auto load = [&](int k, int m) {
    return to_tf32(__ldg(a + k * tt + m));
  };
  uint32_t a0[4], a1[4];
  a_fragment(a0, load, 0, m0, g, q);
  a_fragment(a1, load, 1, m0, g, q);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float* bc = b + r_w + nt * 8 + g;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(d, a0, to_tf32(bc[static_cast<size_t>(q) * r]),
             to_tf32(bc[static_cast<size_t>(q + 4) * r]));
    mma_tf32(d, a1, to_tf32(bc[static_cast<size_t>(8 + q) * r]),
             to_tf32(bc[static_cast<size_t>(12 + q) * r]));
    float* o = out + static_cast<size_t>(m0 + g) * r + r_w + nt * 8 + 2 * q;
    *reinterpret_cast<float2*>(o) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(o + static_cast<size_t>(8) * r) =
        make_float2(d[2], d[3]);
  }
}

// ------------------------------------------------------------------ relayout
constexpr int kRelayoutBlock = 256;

__global__ void __launch_bounds__(kRelayoutBlock)
relayout_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                int n_iter) {
  const int i = blockIdx.x * kRelayoutBlock + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int it = 0; it < n_iter; ++it) v = v + 1.0f;
  out[i] = v;
}

// Launch with `smem` bytes of dynamic shared memory (raising the kernel's
// limit above the default 48 KB first) -> the CUDA error, 0 if launched.
// A refused attribute or launch leaves no error behind for later calls.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int block, int smem,
           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Grid and block of the dot's launch over a (16, tt), b (16, r).
struct Shape {
  dim3 grid;
  int block;
};

Shape dot_shape(int tf32, int tt, int r) {
  if (tf32) return {dim3(r / kSpan, tt / 16), kSpan};
  return {dim3(r / kSpan, (tt + kDotBlockRows - 1) / kDotBlockRows),
          32 * kDotWarps};
}

Shape relayout_shape(int n) {
  return {dim3((n + kRelayoutBlock - 1) / kRelayoutBlock), kRelayoutBlock};
}

__global__ void empty_kernel() {}

// The min visit in tile mode kMode: as many ring slots as fit in half of
// an SM's shared memory, so that two blocks stay resident, at most
// kMaxStages, at least the one it cannot do without (a launch that does not
// fit even that is refused by the card).
template <int kMode>
int launch_min(int blocks, cudaStream_t stream, const float* tab,
               const float* feats, float* t, float* o, int r, int tt,
               int n_tiles, int n_visits) {
  const dim3 grid(r / kMinSpan, blocks);
  const long long tile = static_cast<long long>(kK) * tt * 4;
  long long stages = kMode == kStatic ? 1 : (kRingBudget - kMinFixed) / tile;
  stages = stages < 1 ? 1 : (stages > kMaxStages ? kMaxStages : stages);
  const long long smem = stages * tile + kMinFixed;
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch(visit_min_kernel<kMode>, grid, kMinThreads,
                static_cast<int>(smem), stream, tab, feats, t, o, r, tt,
                n_tiles, n_visits, static_cast<int>(stages));
}

// The lane visit: as many ring slots as fit beside kLaneFixed in half of an
// SM's shared memory, at most kMaxStages (the tile is 8 KB: kMaxStages).
int launch_lane(int blocks, cudaStream_t stream, const float* tab,
                const float* feats, float* t, float* o, int r, int n_tiles,
                int n_visits) {
  int stages = (kRingBudget - kLaneFixed) / kLaneTile;
  stages = stages < 1 ? 1 : (stages > kMaxStages ? kMaxStages : stages);
  return launch(visit_lane_kernel, dim3(r / kLaneSpan, blocks), kLaneThreads,
                stages * kLaneTile + kLaneFixed, stream, tab, feats, t, o, r,
                n_tiles, n_visits, stages);
}

}  // namespace

// The visit kernel of variant `variant` (ops/visit.py, VARIANTS order) over
// tab (n_tiles * 16, tt) and feats (blocks * 16, r); writes t (blocks, 8, r)
// for reduce "first8", else (blocks, 1, r), and o (blocks, 1, r).  The
// caller guarantees r % 128 == 0, tt % 32 == 0 (tt == 128 for the lane
// layout), n_tiles >= 8 for the batched variant and a 16-byte aligned tab
// and feats.  Launches on `stream` and returns the CUDA error (0 = launched).
extern "C" int visit_run(int variant, const float* tab, const float* feats,
                         float* t, float* o, int blocks, int r, int tt,
                         int n_tiles, int n_visits, cudaStream_t stream) {
  if (blocks <= 0 || r <= 0) return 0;
  const dim3 grid(r / kSpan, blocks);
  const int tile = kK * tt * 4;
  switch (variant) {
    case 0:
      return launch_min<kDynamic>(blocks, stream, tab, feats, t, o, r, tt,
                                  n_tiles, n_visits);
    case 1:
      return launch(visit_tf32_kernel, grid, kSpan, kK * (tt + 8) * 4, stream,
                    tab, feats, t, o, r, tt, n_tiles, n_visits);
    case 2:
      return launch(visit_ray_kernel<kMt>, grid, kSpan, tile, stream, tab,
                    feats, t, o, r, tt, n_tiles, n_visits);
    case 3:
      return launch_min<kStatic>(blocks, stream, tab, feats, t, o, r, tt,
                                 n_tiles, n_visits);
    case 4:
      return launch(visit_ray_kernel<kFirst8>, grid, kSpan, tile, stream, tab,
                    feats, t, o, r, tt, n_tiles, n_visits);
    case 5:
      return launch_lane(blocks, stream, tab, feats, t, o, r, n_tiles,
                         n_visits);
    case 6:
      return launch_min<kBatched8>(blocks, stream, tab, feats, t, o, r, tt,
                                   n_tiles, n_visits);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (tt, r) = a^T b for a (16, tt), b (16, r), in fp32 (tf32 = 0) or
// TF32 (tf32 = 1); tt % 16 == 0, r % 128 == 0, 16-byte aligned pointers.
extern "C" int visit_dot(int tf32, const float* a, const float* b, float* out,
                         int tt, int r, cudaStream_t stream) {
  if (tt <= 0 || r <= 0) return 0;
  const Shape sh = dot_shape(tf32, tt, r);
  return launch(tf32 ? dot_tf32_kernel : dot_fp32_kernel, sh.grid, sh.block, 0,
                stream, a, b, out, tt, r);
}

// out = x + 1.0 added n_iter times, element by element, over n floats.
extern "C" int visit_relayout(const float* x, float* out, int n, int n_iter,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const Shape sh = relayout_shape(n);
  return launch(relayout_kernel, sh.grid, sh.block, 0, stream, x, out, n,
                n_iter);
}

// An empty kernel with the grid and block of the dot's launch (kind 0:
// fp32, 1: TF32; n0 = tt, n1 = r) or the relayout's (kind 2; n0 = n): what
// the card takes for any launch of that size, the floor under those
// kernels' times.
extern "C" int visit_floor(int kind, int n0, int n1, cudaStream_t stream) {
  if (kind < 0 || kind > 2 || n0 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh = kind == 2 ? relayout_shape(n0) : dot_shape(kind, n0, n1);
  return launch(empty_kernel, sh.grid, sh.block, 0, stream);
}
