// Visits of a constants table by blocks of rays for Hopper (sm_90a): the
// K = 16 contraction under the treelet pair test, in the layouts and the
// two precisions that the matrix-unit probes measured; and the probes'
// dot and relayout kernels.
//
// Replaces the TPU kernels of the probe scripts (Pallas, one program per
// block of R = 4096 rays, on the TPU's matrix unit):
//   visit_run,      scripts/probe_mxu.py::visit_kernel (:51, call :106),
//   visit_tf32
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
// The MT visit (visit_mt_kernel: reduce "mt", fp32) tests each visit's
// tt / 4 triangles (the columns [det | tdet | udet | vdet]) against the
// ray's best t as it stood before the visit.  Its operations bound it as
// the min visit's do (2 x 16 a column, 15 a triangle), and its first design,
// one ray a thread and the tile staged by the whole block between two
// barriers, reached 56% of that issue floor.  Now:
//   - 2 rays a thread: a float4 of a quarter (4 triangles) feeds 16
//     instructions.  (4 rays a thread, as the min visit has, need more than
//     128 registers: spilled at two blocks an SM, or one block an SM, both
//     slower; the times are in PERF.md.)
//   - A warp takes 8 rays and all the tile's triangles: lane l on rays 2 (l
//     % 4), + 1 and the groups of 4 triangles l / 4, l / 4 + 8, ...  The
//     tiles come through a ring of bulk copies that a producer warp keeps
//     full; a warp leaves a slot after its last group.  (The min visit's
//     producer thread in warp 0 waits there each visit for the slowest
//     warp, and that warp then ends last: 3.2% slower here.)
//   - A best t private to a lane would not be exact: a lane whose own best
//     is above the ray's can accept a hit with st == fl(tb ad) that the
//     plain version rejects, and fl(st / ad) may be an ulp below tb.  So
//     after each visit the 8 lanes of a ray take the min of their partial
//     bests (a butterfly of 3 shuffles), and every lane holds the next
//     visit against the same best.  The exchange stays inside a warp: no
//     barrier between warps stands in the loop.  (Warps splitting the
//     triangles, with the bests exchanged through shared memory on
//     mbarriers, ran 1.5% slower.)
//   - The sums of a group go quarter by quarter (det, udet, vdet, tdet),
//     which keeps 48 sums live, not 64; the terms of the test that need no
//     best t run first, and the division runs on a hit only.
// The TF32 visit (visit_tf32_kernel, precision "default", reduce "min")
// runs its contraction on wgmma, the only path to the tensor cores' 495
// TFLOP/s, and its min (one a column, 268 M at the probes' size, about half
// the contraction's time at the FP32 issue rate) on the FP32 pipes: rays
// are wgmma's M (a warpgroup's 64, their features rounded once into shared
// memory), triangles its N (128 a step), K = 16 two k8 wgmmas.  wgmma
// takes TF32 operands K-major only, and the table lies triangle-contiguous,
// so the wrapper's call first packs the visited tiles, rounded, in the
// layout wgmma reads (pack_tf32_kernel, made anew on every call); a
// producer warp brings them into a ring of bulk copies.  A step is waited
// on and folded before the next is issued: while one warpgroup folds, the
// SM's other warpgroups keep the tensor cores busy.  The first design's
// mma.sync.m16n8k8 stays in the TF32 dot.
// first8 (visit_first8_kernel) needs 8 columns of each visited tile, 512
// of its bytes.  Its first design staged the whole tile with the whole block
// between two barriers, one ray a thread, and reached 26% of its issue
// floor.  Now a warp brings in only its visits' columns (one 16-byte
// cp.async a lane, on an mbarrier a slot) through a ring of 16 slots that
// it refills itself, and runs 4 rays a thread; the 4 warps of a block split the
// visits and meet once, after the last (the kernel's comment has the
// partition).  The TF32 dot runs mma.sync.m16n8k8, 16 rows x 16 rays a
// warp, 16 warps a block (dot_tf32_kernel).
// The fp32 kernels sum K left to right, every product and sum rounded,
// and min is exact, so they equal the plain version bit for bit in any
// layout.  The TF32 kernels differ from their plain versions only in the
// tensor core's accumulation order and rounding (ops/visit.py,
// TF32_KERNEL_BOUND: per k8 step, 8 exact products and the accumulator).
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
//
// The relayout kernel (P1c).  No relayout exists here: a torch tensor's
// shape is its strides, and a reshape of a contiguous (32, 128) block to
// (1, 4096) moves no data, where the TPU moves values between its (8, 128)
// register tiles.  What is left is n_iter additions of 1.0 per element,
// each rounded (so not one addition of n_iter, which rounds otherwise for
// fractions and for |x| >= 2^24).  At the probe's 2^18 floats and n_iter
// 65 its bound is its 2 MB of reads and writes (0.63 us), its additions
// are 0.51 us of FP32 issue, and an empty launch of its first grid (1,024
// blocks of 256 threads, one float a thread) took 1.44 us of its 2.17.
// Now a thread loads kRelayoutVecs float4s (LDG.128), runs their
// 4 * kRelayoutVecs independent chains of additions side by side, so the
// adds' latency overlaps, and stores float4s; the grid is one wave at
// most (kRelayoutBlocksPerSm blocks of the 132 SMs), walking longer
// inputs by a grid stride: 128 blocks at the probe's size.

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

// --------------------------------------------------------- the MT visit (P1a)
constexpr int kMtWarps = 8;    // warps of a block, each on rays of its own
constexpr int kMtThreads = 32 * kMtWarps + 32;  // and a producer warp
constexpr int kMtRays = 2;     // consecutive rays a thread
constexpr int kMtWarpRays = 4 * kMtRays;         // rays of a warp: 4 slots
constexpr int kMtSpan = kMtWarps * kMtWarpRays;  // rays of a block
constexpr int kMtTris = 4;     // triangles of a group: a float4 a quarter
constexpr int kMtFixed = 2 * kMaxStages * 8;  // the full and empty barriers
static_assert(kSpan % kMtSpan == 0, "ops/visit.py checks R against SPAN");
static_assert(kMtRays == 2, "a thread's rays are written as one float2");

// The kMtTris floats of a group at p, one float4 load.
__device__ __forceinline__ void ld_tris(float (&v)[kMtTris],
                                        const float* p) {
  const float4 a = ld4(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// The 16-deep sums of quarter h (0 det, 1 tdet, 2 udet, 3 vdet) of triangles
// c .. c + kMtTris - 1 of a tile (rows of tt floats, quarters of q) for a
// thread's rays, left to right, every product and sum rounded.
__device__ __forceinline__ void mt_quarter(float (&sum)[kMtRays][kMtTris],
                                           const float* tile, int tt, int q,
                                           int h, int c,
                                           const float (&f)[kMtRays][kK]) {
  const float* p = tile + h * q + c;
  float a[kMtTris];
  ld_tris(a, p);
#pragma unroll
  for (int j = 0; j < kMtRays; ++j) {
#pragma unroll
    for (int e = 0; e < kMtTris; ++e) sum[j][e] = a[e] * f[j][0];
  }
#pragma unroll
  for (int k = 1; k < kK; ++k) {
    p += tt;
    ld_tris(a, p);
#pragma unroll
    for (int j = 0; j < kMtRays; ++j) {
#pragma unroll
      for (int e = 0; e < kMtTris; ++e) sum[j][e] = sum[j][e] + a[e] * f[j][k];
    }
  }
}

// The part of the MT test of a group's triangles that needs no best t:
// -> st (tdet * sgn where it is > 0, else NaN) and ad (det * sgn where
// ad >= kDetEps, su >= 0, sv >= 0 and su + sv <= ad, else NaN).  The test
// `st < tb * ad` is then false wherever the plain version's conjunction
// fails before it, and is its last term elsewhere.
__device__ __forceinline__ void mt_group(float (&st)[kMtRays][kMtTris],
                                         float (&ad)[kMtRays][kMtTris],
                                         const float* tile, int tt, int q,
                                         int c,
                                         const float (&f)[kMtRays][kK]) {
  const float nan = __int_as_float(0x7fffffff);
  float det[kMtRays][kMtTris], su[kMtRays][kMtTris], w[kMtRays][kMtTris];
  mt_quarter(det, tile, tt, q, 0, c, f);
  mt_quarter(w, tile, tt, q, 2, c, f);
#pragma unroll
  for (int j = 0; j < kMtRays; ++j) {
#pragma unroll
    for (int e = 0; e < kMtTris; ++e) {
      su[j][e] = w[j][e] * (det[j][e] < 0.0f ? -1.0f : 1.0f);
    }
  }
  mt_quarter(w, tile, tt, q, 3, c, f);
#pragma unroll
  for (int j = 0; j < kMtRays; ++j) {
#pragma unroll
    for (int e = 0; e < kMtTris; ++e) {
      const float sgn = det[j][e] < 0.0f ? -1.0f : 1.0f;
      const float a = det[j][e] * sgn;
      const float sv = w[j][e] * sgn;
      const bool ok = a >= kDetEps && su[j][e] >= 0.0f && sv >= 0.0f &&
                      su[j][e] + sv <= a;
      ad[j][e] = ok ? a : nan;
    }
  }
  mt_quarter(w, tile, tt, q, 1, c, f);
#pragma unroll
  for (int j = 0; j < kMtRays; ++j) {
#pragma unroll
    for (int e = 0; e < kMtTris; ++e) {
      const float s = w[j][e] * (det[j][e] < 0.0f ? -1.0f : 1.0f);
      st[j][e] = s > 0.0f ? s : nan;
    }
  }
}

// The hits of a group against the best t as it stood before the visit.
__device__ __forceinline__ void mt_hits(float (&m)[kMtRays],
                                        const float (&st)[kMtRays][kMtTris],
                                        const float (&ad)[kMtRays][kMtTris],
                                        const float (&tb)[kMtRays]) {
#pragma unroll
  for (int j = 0; j < kMtRays; ++j) {
#pragma unroll
    for (int e = 0; e < kMtTris; ++e) {
      if (st[j][e] < tb[j] * ad[j][e]) m[j] = fminf(m[j], st[j][e] / ad[j][e]);
    }
  }
}

// Dynamic shared memory: the ring (`stages` slots of one tile as it lies in
// the table; visit i in slot i % stages with parity (i / stages) & 1), then
// the barriers full[kMaxStages] and empty[kMaxStages], as in
// visit_min_kernel.  Warp kMtWarps is the producer: one lane refills a
// slot once every warp has left it.
__global__ void __launch_bounds__(kMtThreads, 2)
visit_mt_kernel(const float* __restrict__ tab,
                const float* __restrict__ feats, float* __restrict__ t_out,
                float* __restrict__ o_out, int r, int tt, int n_tiles,
                int n_visits, int stages) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int tile_floats = kK * tt;
  const uint32_t tile_bytes = static_cast<uint32_t>(tile_floats) * 4;
  const uint32_t ring_a = smem_addr(ring);
  const uint32_t full_a = ring_a + stages * tile_bytes;
  const uint32_t empty_a = full_a + 8 * kMaxStages;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = lane >> 2;  // the lane's first group of triangles
  const int ray0 =
      blockIdx.x * kMtSpan + warp * kMtWarpRays + (lane & 3) * kMtRays;

  const auto load_tile = [&](int j) {  // the tile of visit j
    const int s = j % stages;
    bulk_load(ring_a + s * tile_bytes,
              tab + static_cast<size_t>(tile_of<kDynamic>(j, n_tiles)) *
                        tile_floats,
              tile_bytes, full_a + 8 * s);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, kMtWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == kMtWarps) {  // the producer
    if (lane == 0) {
      for (int j = 0; j < n_visits; ++j) {
        const int s = j % stages;
        if (j >= stages) {
          mbar_wait(empty_a + 8 * s, (j / stages - 1) & 1);
          // the warps' reads of the slot before the copy engine's writes
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        load_tile(j);
      }
    }
    return;
  }

  // the features of rays ray0, ray0 + 1, while the first tiles arrive
  float f[kMtRays][kK];
  {
    const float* fb = feats + static_cast<size_t>(b) * kK * r + ray0;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int j = 0; j < kMtRays; ++j) {
        f[j][k] = __ldg(fb + static_cast<size_t>(k) * r + j);
      }
    }
  }
  const int q = tt / 4;
  const int groups = q / kMtTris;  // tt % 32 == 0: q is a multiple of 8
  // the best t before the visit, the same in the 8 lanes of a ray
  float tb[kMtRays] = {kBig, kBig};
  int s = 0;             // visit i's slot, i % stages, and
  uint32_t parity = 0;   // the parity of its use of it, (i / stages) & 1
  for (int i = 0; i < n_visits; ++i) {
    mbar_wait(full_a + 8 * s, parity);
    const float* tile = ring + static_cast<size_t>(s) * tile_floats;
    float m[kMtRays] = {tb[0], tb[1]};
    for (int g = first; g < groups; g += 8) {
      float st[kMtRays][kMtTris], ad[kMtRays][kMtTris];
      mt_group(st, ad, tile, tt, q, kMtTris * g, f);
      mt_hits(m, st, ad, tb);
    }
    // this warp has left slot s; when all have, the producer refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_a + 8 * s);
    // the 8 lanes of a ray (lane ^ 4, ^ 8, ^ 16) agree on its best t
#pragma unroll
    for (int j = 0; j < kMtRays; ++j) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        m[j] = fminf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
      }
      tb[j] = m[j];
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
  if (first == 0) {
    *reinterpret_cast<float2*>(t_out + static_cast<size_t>(b) * r + ray0) =
        make_float2(tb[0], tb[1]);
  }
  if (threadIdx.x < kMtSpan) {
    write_feature_sum(feats, o_out, b, r, blockIdx.x * kMtSpan + threadIdx.x);
  }
}

// ------------------------------------------------------------------ first8
constexpr int kF8Rays = 4;      // consecutive rays a thread
constexpr int kF8Span = 32 * kF8Rays;  // rays of a block
constexpr int kF8Warps = 4;     // of a block: warp w takes visits w, w + 4, ..
constexpr int kF8Threads = 32 * kF8Warps;
constexpr int kF8Slots = 16;    // a warp's slots of one tile's 8 columns
constexpr int kF8Slot = kK * kRows * 4;  // bytes of a slot: 32 chunks of 16
// dynamic shared memory: the warps' slots, their barriers, the warps' mins
constexpr int kF8Smem =
    kF8Warps * kF8Slots * (kF8Slot + 8) + kF8Warps * kRows * kF8Span * 4;
static_assert(kSpan % kF8Span == 0, "ops/visit.py checks R against SPAN");
static_assert(kF8Slot == 32 * 16, "a lane copies one 16-byte chunk a slot");

// One 16-byte copy from device memory to shared memory (cp.async, through
// L2 only), and an arrival on the barrier at `bar` once every earlier copy
// of this thread has landed.
__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// Rows 0..7 of each visit's tile^T f, a running min each.  Only those 8
// columns of a tile are read: 16 rows x 32 bytes, one 16-byte cp.async a
// lane.  A block takes kF8Span rays, kF8Rays consecutive ones a thread (a
// float4 of the tile feeds 32 instructions); warp w takes the visits w, w
// + kF8Warps, ...  Each warp brings its own visits' columns into a ring of
// kF8Slots slots of its own, on a barrier a slot (its 32 lanes' copies):
// visit j in slot j % kF8Slots, the (j / kF8Slots)-th use of it, the parity
// it waits with; the warp refills a slot once it has read it.  A warp with
// at most kF8Slots visits (the probe's shape) loads each once, up front.
// No barrier between warps stands in the loop.  The warps' mins meet once,
// after the last visit, through shared memory (a min is exact in any order,
// and every sum is left as it was).  (Warps on 4 of the 8 columns, twice
// the warps, ran 10% slower: PERF.md.)
__global__ void __launch_bounds__(kF8Threads, 3)
visit_first8_kernel(const float* __restrict__ tab,
                    const float* __restrict__ feats, float* __restrict__ t_out,
                    float* __restrict__ o_out, int r, int tt, int n_tiles,
                    int n_visits) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* slots =
      reinterpret_cast<float*>(smem4) + warp * kF8Slots * (kF8Slot / 4);
  const uint32_t slots_a = smem_addr(slots);
  const uint32_t bar_a = smem_addr(smem4) + kF8Warps * kF8Slots * kF8Slot +
                         warp * kF8Slots * 8;
  float* comb = reinterpret_cast<float*>(smem4) +
                kF8Warps * kF8Slots * (kF8Slot + 8) / 4;
  const int b = blockIdx.y;
  const int ray0 = blockIdx.x * kF8Span;
  const int n_w =  // this warp's visits
      n_visits > warp ? (n_visits - warp + kF8Warps - 1) / kF8Warps : 0;

  // the warp's j-th visit (visit warp + kF8Warps j) into slot s: lane l
  // copies the half l % 2 of row l / 2
  const int row = lane >> 1, half = lane & 1;
  const auto load = [&](int j, int s) {
    const int tile = tile_of<kDynamic>(warp + kF8Warps * j, n_tiles);
    copy16(slots_a + s * kF8Slot + (row * kRows + 4 * half) * 4,
           tab + (static_cast<size_t>(tile) * kK + row) * tt + 4 * half);
    copies_arrive(bar_a + 8 * s);
  };
  if (lane == 0) {
    for (int s = 0; s < kF8Slots; ++s) mbar_init(bar_a + 8 * s, 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int j = 0; j < kF8Slots && j < n_w; ++j) load(j, j);

  // the features of rays ray0 + kF8Rays lane .. + kF8Rays - 1, while the
  // first tiles arrive
  float f[kF8Rays][kK];
  {
    const float* fb =
        feats + static_cast<size_t>(b) * kK * r + ray0 + kF8Rays * lane;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int i = 0; i < kF8Rays; ++i) {
        f[i][k] = __ldg(fb + static_cast<size_t>(k) * r + i);
      }
    }
  }
  float m[kF8Rays][kRows];
#pragma unroll
  for (int i = 0; i < kF8Rays; ++i) {
#pragma unroll
    for (int c = 0; c < kRows; ++c) m[i][c] = kBig;
  }

  int s = 0;            // visit j's slot, j % kF8Slots, and
  uint32_t parity = 0;  // the parity of its use of it, (j / kF8Slots) & 1
  for (int j = 0; j < n_w; ++j) {
    mbar_wait(bar_a + 8 * s, parity);
    const float* p = slots + s * (kF8Slot / 4);
    float sum[kF8Rays][kRows];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int cc = 0; cc < kRows; cc += 4) {
        const float4 a = ld4(p + k * kRows + cc);
#pragma unroll
        for (int i = 0; i < kF8Rays; ++i) {
          if (k == 0) {
            sum[i][cc] = a.x * f[i][0];
            sum[i][cc + 1] = a.y * f[i][0];
            sum[i][cc + 2] = a.z * f[i][0];
            sum[i][cc + 3] = a.w * f[i][0];
          } else {
            sum[i][cc] = sum[i][cc] + a.x * f[i][k];
            sum[i][cc + 1] = sum[i][cc + 1] + a.y * f[i][k];
            sum[i][cc + 2] = sum[i][cc + 2] + a.z * f[i][k];
            sum[i][cc + 3] = sum[i][cc + 3] + a.w * f[i][k];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kF8Rays; ++i) {
#pragma unroll
      for (int c = 0; c < kRows; ++c) m[i][c] = fminf(m[i][c], sum[i][c]);
    }
    if (j + kF8Slots < n_w) {
      __syncwarp();  // every lane has read slot s
      load(j + kF8Slots, s);
    }
    if (++s == kF8Slots) {
      s = 0;
      parity ^= 1;
    }
  }

  // The warps' mins meet.  Where a ray's least value is a zero, the
  // grouping may pick -0.0 where the plain version has +0.0 (or the
  // reverse), which compare equal.
#pragma unroll
  for (int c = 0; c < kRows; ++c) {
#pragma unroll
    for (int i = 0; i < kF8Rays; ++i) {
      comb[(warp * kRows + c) * kF8Span + kF8Rays * lane + i] = m[i][c];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kF8Span; e += kF8Threads) {
    float v = comb[e];
#pragma unroll
    for (int w = 1; w < kF8Warps; ++w) {
      v = fminf(v, comb[w * kRows * kF8Span + e]);
    }
    const int rw = e / kF8Span, ray = e - rw * kF8Span;
    t_out[(static_cast<size_t>(b) * kRows + rw) * r + ray0 + ray] = v;
  }
  for (int ray = threadIdx.x; ray < kF8Span; ray += kF8Threads) {
    write_feature_sum(feats, o_out, b, r, ray0 + ray);
  }
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

// The TF32 visit on wgmma (m64n128k8, A and B from shared memory).  wgmma
// takes TF32 operands K-major only, so the wrapper's copy of the table
// (`packed`, made by pack_tf32_kernel on every call) holds each visited
// tile rounded to TF32 and laid out as wgmma reads B: triangle n, feature
// k at float (n / 8) * 128 + (k / 4) * 32 + (n % 8) * 4 + k % 4, core
// matrices of 8 triangles x 4 features (128 bytes), the four of a group of
// 8 triangles side by side along K (LBO 128 bytes), groups 512 bytes apart
// (SBO); a warpgroup's A, its rays' features, lies the same way.  A tile is
// padded to a multiple of kTfN triangles with copies of its last one: a min
// over columns taken twice is the same.  Tile p of the copy is the tile of
// visits p, p + n_packed, ...
constexpr int kTfWarpgroups = 2;          // consumer warpgroups of a block
constexpr int kTfSpan = 64 * kTfWarpgroups;  // rays of a block: kSpan
constexpr int kTfThreads = 128 * kTfWarpgroups + 32;  // and a producer warp
constexpr int kTfConsumerWarps = 4 * kTfWarpgroups;
constexpr int kTfN = 128;                 // triangles of a wgmma
constexpr int kTfStages = 8;              // tiles the ring holds at most
// beside the ring: the full and empty barriers, each warpgroup's features
constexpr int kTfFixed = 2 * kTfStages * 8 + kTfWarpgroups * 64 * kK * 4;
static_assert(kTfSpan == kSpan, "ops/visit.py checks R against SPAN");

// tt rounded up to whole wgmma steps: the packed tile's triangles
__host__ __device__ __forceinline__ int tf32_width(int tt) {
  return (tt + kTfN - 1) / kTfN * kTfN;
}

__device__ __forceinline__ int packed_offset(int n, int k) {
  return (n >> 3) * 128 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// packed[p] = the tile of visit p (p < n_packed), rounded to TF32, padded
// and laid out as above; a block a tile.
__global__ void __launch_bounds__(256)
pack_tf32_kernel(const float* __restrict__ tab, float* __restrict__ packed,
                 int tt, int n_tiles) {
  const int p = blockIdx.x;
  const int w = tf32_width(tt);
  const float* src =
      tab + static_cast<size_t>(tile_of<kDynamic>(p, n_tiles)) * kK * tt;
  float* dst = packed + static_cast<size_t>(p) * kK * w;
  for (int e = threadIdx.x; e < kK * w; e += 256) {
    const int k = e / w, n = e - k * w;
    dst[packed_offset(n, k)] =
        __uint_as_float(to_tf32(__ldg(src + k * tt + min(n, tt - 1))));
  }
}

// The shared-memory descriptor of a K-major, unswizzled operand (A or B)
// at shared address `addr`, in the layout above.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32);
}

// d (+)= A B for the warpgroup's 64 rays and 128 triangles, K = 8: A and B
// from shared memory through their descriptors; scale_d = 0 drops d's old
// value.  d[4 j ..]: row g, columns 8 j + 2q, + 1; row g + 8, the same (g =
// lane / 4, q = lane % 4).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t adesc,
                                         uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

// v[0] = the min of v[0..15], in 4 levels.
__device__ __forceinline__ void min_tree16(float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = fminf(v[j], v[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = fminf(v[j], v[j + 4]);
  v[0] = fminf(fminf(v[0], v[2]), fminf(v[1], v[3]));
}

// Dynamic shared memory: the ring (`stages` slots of one packed tile; visit
// i in slot i % stages with parity (i / stages) & 1), the barriers
// full[kTfStages] and empty[kTfStages], then each warpgroup's A.  Warp
// kTfConsumerWarps is the producer: one lane keeps the ring full by bulk
// copies.  Warpgroup g takes rays 64 g .. 64 g + 63 of the block's 128, their
// features rounded once into its A.  A visit is tf32_width(tt) / 128 steps,
// each two k8 wgmmas into one accumulator, committed, waited on and folded
// into the thread's running mins (rows g and g + 8 of its warp's 16).  (Two
// accumulators in turn, one step's fold beside the next step's wgmma, make
// ptxas serialize every wgmma; A in registers ran 37% slower than from
// shared memory: PERF.md.)  A warp leaves a slot after its visit's
// last step.  The min across the 4 lanes that share a row is taken once,
// after the last visit.
__global__ void __launch_bounds__(kTfThreads)
visit_tf32_kernel(const float* __restrict__ packed,
                  const float* __restrict__ feats, float* __restrict__ t_out,
                  float* __restrict__ o_out, int r, int tt, int n_packed,
                  int n_visits, int stages) {
  extern __shared__ float4 smem4[];
  const int width = tf32_width(tt);
  const uint32_t tile_bytes = static_cast<uint32_t>(kK * width) * 4;
  const uint32_t ring_a = smem_addr(smem4);
  const uint32_t full_a = ring_a + stages * tile_bytes;
  const uint32_t empty_a = full_a + 8 * kTfStages;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  // one value for the whole warp, as the compiler can see: a wgmma after a
  // branch on a value it cannot see to be warp-uniform is serialized
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, kTfConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kTfConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int j = 0; j < n_visits; ++j) {
        const int s = j % stages;
        if (j >= stages) mbar_wait(empty_a + 8 * s, (j / stages - 1) & 1);
        bulk_load(ring_a + s * tile_bytes,
                  packed + static_cast<size_t>(j % n_packed) * kK * width,
                  tile_bytes, full_a + 8 * s);
      }
    }
    return;
  }

  const int g = lane >> 2, q = lane & 3;
  // the warp's 16 rays: rows 16 (warp % 4) .. of its warpgroup's 64
  const int r_w = blockIdx.x * kTfSpan + 64 * (warp >> 2) + 16 * (warp & 3);
  // the warpgroup's A: its 64 rays' features rounded to TF32, K-major in
  // the layout of the packed tiles, written once and made visible to the
  // tensor cores' reads
  const uint32_t fa_a = empty_a + 8 * kTfStages + (warp >> 2) * 64 * kK * 4;
  {
    float* fa = reinterpret_cast<float*>(smem4) + (fa_a - ring_a) / 4;
    const float* fw = feats + static_cast<size_t>(b) * kK * r +
                      blockIdx.x * kTfSpan + 64 * (warp >> 2);
    for (int e = threadIdx.x & 127; e < 64 * kK; e += 128) {
      const int m = e & 63, k = e >> 6;
      fa[packed_offset(m, k)] =
          __uint_as_float(to_tf32(fw[static_cast<size_t>(k) * r + m]));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + (warp >> 2)) : "memory");
  }
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  float lo = kBig, hi = kBig;  // running mins of rows g and g + 8
  for (int i = 0; i < n_visits; ++i) {
    const int s = i % stages;
    mbar_wait(full_a + 8 * s, (i / stages) & 1);
    for (int c = 0; c < width; c += kTfN) {
      const uint32_t base = ring_a + s * tile_bytes + c / 8 * 512;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      wgmma_tf32(acc, operand_desc(fa_a), operand_desc(base), 0);
      wgmma_tf32(acc, operand_desc(fa_a + 256), operand_desc(base + 256), 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      // the accumulators as written here: no read of them moves above the
      // wait
#pragma unroll
      for (int e = 0; e < 64; ++e) asm volatile("" : "+f"(acc[e])::"memory");
      // each row's 32 columns of the step, as a tree of mins
      float l[16], h[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        l[j] = fminf(acc[4 * j], acc[4 * j + 1]);
        h[j] = fminf(acc[4 * j + 2], acc[4 * j + 3]);
      }
      min_tree16(l);
      min_tree16(h);
      lo = fminf(lo, l[0]);
      hi = fminf(hi, h[0]);
    }
    // this warp has left slot s; when all have, the producer refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_a + 8 * s);
  }

  // the min across the 4 lanes (q) of a row; lane q == 0 writes it
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fminf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (q == 0) {
    float* out = t_out + static_cast<size_t>(b) * r + r_w + g;
    out[0] = lo;
    out[8] = hi;
  }
  if (threadIdx.x < kTfSpan) {
    write_feature_sum(feats, o_out, b, r, blockIdx.x * kTfSpan + threadIdx.x);
  }
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

// TF32 (mma.sync.m16n8k8, two k8 steps): a warp takes 16 rows of the
// output for kTdRays consecutive rays; a block's kTdWarps warps take
// consecutive runs of rays of the same rows.  A lane loads its fragments
// of a and b at once, rounds each value once, and runs its n8 tiles' two
// k8 steps each; a store writes 8 rows x 32 bytes, whole sectors.  The
// 2 MB of output bound it at 0.7 us, but at the probe's size the kernel is
// held by each warp's chain of latencies (loads, two dependent mma, stores)
// and by the launch: the times of other shapes are in PERF.md.  Short
// chains on many warps won: 16 x 16 a warp, 16 warps a block (128
// blocks of 512 threads), against 16 x 32 on 4 warps (the first design),
// 8 or 32 rays a warp, 4 to 32 warps a block, and a block over 128 rows
// whose slices of a and b are rounded once into shared memory, its output
// written back as float4s or by bulk copies (one wave of 128 blocks, each
// warp's chain 4 times as long).
constexpr int kTdRays = 16;  // rays of a warp: kTdRays / 8 n8 tiles
constexpr int kTdWarps = 16;
constexpr int kTdNt = kTdRays / 8;

__global__ void __launch_bounds__(32 * kTdWarps)
dot_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int tt, int r) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int r_w = (blockIdx.x * kTdWarps + warp) * kTdRays;
  const int m0 = blockIdx.y * 16;
  if (r_w >= r) return;  // r is a multiple of 128 only
  const auto load = [&](int k, int m) {
    return to_tf32(__ldg(a + k * tt + m));
  };
  uint32_t a0[4], a1[4], bf[kTdNt][4];
  a_fragment(a0, load, 0, m0, g, q);
  a_fragment(a1, load, 1, m0, g, q);
#pragma unroll
  for (int nt = 0; nt < kTdNt; ++nt) {
    const float* bc = b + r_w + nt * 8 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // k = q, q + 4, 8 + q, 12 + q
      bf[nt][j] = to_tf32(__ldg(bc + static_cast<size_t>(4 * j + q) * r));
    }
  }
#pragma unroll
  for (int nt = 0; nt < kTdNt; ++nt) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(d, a0, bf[nt][0], bf[nt][1]);
    mma_tf32(d, a1, bf[nt][2], bf[nt][3]);
    float* o = out + static_cast<size_t>(m0 + g) * r + r_w + nt * 8 + 2 * q;
    *reinterpret_cast<float2*>(o) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(o + static_cast<size_t>(8) * r) =
        make_float2(d[2], d[3]);
  }
}

// ------------------------------------------------------------------ relayout
constexpr int kRelayoutThreads = 256;
constexpr int kRelayoutVecs = 2;          // float4s a thread holds at once
constexpr int kRelayoutBlocksPerSm = 4;
constexpr int kSms = 132;

// out[i] = x[i] + 1.0f, n_iter times, for i < n.  Thread g of the grid's
// T threads takes the float4s g, g + T, ..., kRelayoutVecs at a time;
// thread 0 also takes the n % 4 floats past the last float4.
__global__ void __launch_bounds__(kRelayoutThreads)
relayout_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                int n_iter) {
  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x);
  float4* __restrict__ out4 = reinterpret_cast<float4*>(out);
  const int n4 = n >> 2;
  const int stride = gridDim.x * kRelayoutThreads;
  const int g = blockIdx.x * kRelayoutThreads + threadIdx.x;
  for (int i0 = g; i0 < n4; i0 += kRelayoutVecs * stride) {
    float4 v[kRelayoutVecs];
#pragma unroll
    for (int j = 0; j < kRelayoutVecs; ++j) {
      const int i = i0 + j * stride;
      v[j] = i < n4 ? __ldg(x4 + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll 4
    for (int it = 0; it < n_iter; ++it) {
#pragma unroll
      for (int j = 0; j < kRelayoutVecs; ++j) {
        v[j].x = v[j].x + 1.0f;
        v[j].y = v[j].y + 1.0f;
        v[j].z = v[j].z + 1.0f;
        v[j].w = v[j].w + 1.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kRelayoutVecs; ++j) {
      const int i = i0 + j * stride;
      if (i < n4) out4[i] = v[j];
    }
  }
  if (g == 0) {
    for (int i = n4 * 4; i < n; ++i) {
      float v = x[i];
      for (int it = 0; it < n_iter; ++it) v = v + 1.0f;
      out[i] = v;
    }
  }
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
  if (tf32) {
    constexpr int span = kTdRays * kTdWarps;
    return {dim3((r + span - 1) / span, tt / 16), 32 * kTdWarps};
  }
  return {dim3(r / kSpan, (tt + kDotBlockRows - 1) / kDotBlockRows),
          32 * kDotWarps};
}

// One block for every kRelayoutVecs float4s a thread, one wave at most.
Shape relayout_shape(int n) {
  constexpr int span = kRelayoutThreads * kRelayoutVecs;
  const int blocks = ((n >> 2) + span - 1) / span;
  const int most = kRelayoutBlocksPerSm * kSms;
  return {dim3(blocks < 1 ? 1 : (blocks > most ? most : blocks)),
          kRelayoutThreads};
}

__global__ void empty_kernel() {}

// Ring slots of `tile` bytes: as many as fit beside `fixed` bytes in half
// of an SM's shared memory, so that two blocks stay resident, at most
// `most`, at least the `least` a kernel cannot do without (a launch that
// does not fit even those is refused by the card).
long long ring_slots(long long tile, int fixed, int least, int most) {
  const long long n = (kRingBudget - fixed) / tile;
  return n < least ? least : (n > most ? most : n);
}

// Launch `kernel` over the ring's slots and `fixed` bytes of shared memory
// with the arguments that follow, then `stages`.
template <typename... Params, typename... Args>
int launch_ring(void (*kernel)(Params...), dim3 grid, int block,
                long long stages, long long tile, int fixed,
                cudaStream_t stream, Args... args) {
  const long long smem = stages * tile + fixed;
  if (smem > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  return launch(kernel, grid, block, static_cast<int>(smem), stream, args...,
                static_cast<int>(stages));
}

// The min visit in tile mode kMode (the static tile is brought in once and
// needs one slot).
template <int kMode>
int launch_min(int blocks, cudaStream_t stream, const float* tab,
               const float* feats, float* t, float* o, int r, int tt,
               int n_tiles, int n_visits) {
  const long long tile = static_cast<long long>(kK) * tt * 4;
  const long long stages =
      kMode == kStatic ? 1 : ring_slots(tile, kMinFixed, 1, kMaxStages);
  return launch_ring(visit_min_kernel<kMode>, dim3(r / kMinSpan, blocks),
                     kMinThreads, stages, tile, kMinFixed, stream, tab, feats,
                     t, o, r, tt, n_tiles, n_visits);
}

}  // namespace

// The visit kernel of variant `variant` (ops/visit.py, VARIANTS order) over
// tab (n_tiles * 16, tt) and feats (blocks * 16, r); writes t (blocks, 8, r)
// for reduce "first8", else (blocks, 1, r), and o (blocks, 1, r).  The
// caller guarantees r % 128 == 0, tt % 32 == 0 (tt == 128 for the lane
// layout), n_tiles >= 8 for the batched variant and a 16-byte aligned tab
// and feats.  The TF32 visit (variant 1) needs a packed copy of the table:
// visit_tf32.  Launches on `stream` and returns the CUDA error (0 =
// launched).
extern "C" int visit_run(int variant, const float* tab, const float* feats,
                         float* t, float* o, int blocks, int r, int tt,
                         int n_tiles, int n_visits, cudaStream_t stream) {
  if (blocks <= 0 || r <= 0) return 0;
  const long long tile = static_cast<long long>(kK) * tt * 4;
  switch (variant) {
    case 0:
      return launch_min<kDynamic>(blocks, stream, tab, feats, t, o, r, tt,
                                  n_tiles, n_visits);
    case 2:
      return launch_ring(visit_mt_kernel, dim3(r / kMtSpan, blocks),
                         kMtThreads,
                         ring_slots(tile, kMtFixed, 1, kMaxStages), tile,
                         kMtFixed, stream, tab, feats, t, o, r, tt, n_tiles,
                         n_visits);
    case 3:
      return launch_min<kStatic>(blocks, stream, tab, feats, t, o, r, tt,
                                 n_tiles, n_visits);
    case 4:
      return launch(visit_first8_kernel, dim3(r / kF8Span, blocks),
                    kF8Threads, kF8Smem, stream, tab, feats, t, o, r, tt,
                    n_tiles, n_visits);
    case 5:
      return launch_ring(visit_lane_kernel, dim3(r / kLaneSpan, blocks),
                         kLaneThreads,
                         ring_slots(kLaneTile, kLaneFixed, 1, kMaxStages),
                         kLaneTile, kLaneFixed, stream, tab, feats, t, o, r,
                         n_tiles, n_visits);
    case 6:
      return launch_min<kBatched8>(blocks, stream, tab, feats, t, o, r, tt,
                                   n_tiles, n_visits);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The TF32 visit (variant 1 of visit_run, the same contract) through
// `packed`, the wrapper's scratch of n_packed * 16 * tf32_width(tt) floats:
// its tile p is made here, from tab, for visits p, p + n_packed, ...
// (n_packed: the number of distinct tiles the visits read in order, n_tiles
// / gcd(7, n_tiles), at most n_visits).  Two launches on `stream`; returns
// the CUDA error of the first that failed (0 = launched).
extern "C" int visit_tf32(const float* tab, float* packed, const float* feats,
                          float* t, float* o, int blocks, int r, int tt,
                          int n_tiles, int n_visits, int n_packed,
                          cudaStream_t stream) {
  if (blocks <= 0 || r <= 0) return 0;
  if (n_packed > 0) {
    const int e = launch(pack_tf32_kernel, dim3(n_packed), 256, 0, stream,
                         tab, packed, tt, n_tiles);
    if (e != 0) return e;
  }
  const long long tile = static_cast<long long>(kK) * tf32_width(tt) * 4;
  return launch_ring(visit_tf32_kernel, dim3(r / kTfSpan, blocks),
                     kTfThreads, ring_slots(tile, kTfFixed, 1, kTfStages),
                     tile, kTfFixed, stream, static_cast<const float*>(packed),
                     feats, t, o, r, tt, n_packed, n_visits);
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

// out = x + 1.0 added n_iter times, element by element, over n floats;
// 16-byte aligned pointers.
extern "C" int visit_relayout(const float* x, float* out, int n, int n_iter,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const Shape sh = relayout_shape(n);
  return launch(relayout_kernel, sh.grid, sh.block, 0, stream, x, out, n,
                n_iter);
}

// An empty kernel with the grid and block of the dot's launch (kind 0:
// fp32, 1: TF32; n0 = tt, n1 = r), the relayout's (kind 2; n0 = n) or
// first8's (kind 3; n0 = r, n1 = blocks): what the card takes for any launch
// of that size, the floor under those kernels' times.
extern "C" int visit_floor(int kind, int n0, int n1, cudaStream_t stream) {
  if (kind < 0 || kind > 3 || n0 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape sh = kind == 3   ? Shape{dim3(n0 / kF8Span, n1), kF8Threads}
                   : kind == 2 ? relayout_shape(n0)
                               : dot_shape(kind, n0, n1);
  return launch(empty_kernel, sh.grid, sh.block, 0, stream);
}
