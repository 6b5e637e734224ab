// Brute-force Moller-Trumbore ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingrenderer_tpu/ops/mt_kernel.py::_kernel
// (Pallas, launched by intersect_pallas): every ray against every triangle,
// with a per-ray search radius t_init.  Closest-hit passes BIG_T, any-hit
// passes the segment length; a miss keeps t = t_init, tri = -1, u = v = 0.
// Ties go to the lowest triangle index (strict t < t_best, triangles walked
// in index order), as in the TPU kernel's fori_loop and closest_hit_brute's
// argmin.  Any-hit does not stop at its first hit: tri is the closest's
// under the radius, as the TPU kernel's is.
//
// Bound.  FP32 arithmetic: 53 operations (one of them an IEEE division,
// which is a dozen instructions and a branch) per (ray, triangle) pair on
// operands in registers or shared memory, and 44 bytes of device memory a
// ray: 0.030 ms of operations for 2^20 rays x 36 triangles on an H100.  Every
// product and sum is rounded (--fmad=false, for the bit-for-bit check), so
// the floor is the issue rate, one instruction a cycle and scheduler: twice
// that, 0.060 ms.  The first design issued 9 scalar shared-memory loads for
// those 53 operations, staged its tiles between two barriers of the whole
// block and ran the whole test for every pair: 0.118 ms on random rays, 1.41
// ms over the 12 launches of a cornell sample pass, 1.17 ms over the 6 of a
// spheres pass's proxy pre-pass (128 triangles).  This design takes 0.116,
// 1.16 and 0.79 ms.  What it does:
//   - Rows are padded to kRowFloats = 12 floats by the wrapper (once a
//     triangle set): a row is three 16-byte loads, broadcasts from shared
//     memory, and a tile of rows is contiguous, so one thread brings it in
//     with one cp.async.bulk, completion counted on an mbarrier, into a ring
//     of kStages tiles of kTile rows (24 KB of static shared memory for any
//     triangle count; the wrapper still refuses more than 4096 triangles,
//     the TPU kernel's cap).  36 or 128 triangles are one tile, loaded once;
//     4096 stream through the ring with no barrier of the whole block.
//   - The tail after u (qvec, v, t: about half of the operations) is skipped
//     where a vote over the warp's 32 consecutive rays finds none that can
//     still hit: a ray can only hit with |det| >= eps, 0 <= u <= 1 and a
//     positive radius.  u <= 1 is implied by the hit test, not added to it:
//     with v >= 0, u + v >= u exactly, rounding is monotone, so
//     fl(u + v) >= u, and u > 1 fails u + v <= 1.  u itself is computed as
//     before, division included (the sign of u = X / det cannot be read off
//     X and det: the product can round to -0, which passes u >= 0).  The
//     skipped rays' results would have been discarded, so every output is
//     unchanged.  It pays where a warp's rays are coherent (the primary and
//     the coherence-sorted rays of a render) and costs a vote and a branch a
//     triangle where they are not (random rays: 0.116 ms with it, 0.105
//     without).
//   - One ray a thread.  4 or 2 rays a thread over one row's loads measured
//     no faster without the vote (0.106, 0.105 ms: the loads are 3 for 53
//     operations already) and slower with it (0.122, 0.115 ms at 4 and 2; a
//     branch a ray cuts the rays' arithmetic into regions the compiler cannot
//     interleave; one vote over a thread's 2 rays 0.115, and 0.82 ms against
//     0.79 over the pre-pass).  Built with FMA allowed it takes 10% less and
//     changes some output of half the rays.
// The arithmetic follows the TPU kernel (mt_kernel.py:73-92) operation by
// operation: pvec, det, 1 / det, tvec, u, qvec, v, t, then the tests.
//
// Build with --fmad=false: contracting a*b+c into an FMA would round
// differently from the plain torch version and flip hits on edge-grazing
// rays.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRowFloats = 12;  // [p0 e1 e2 0 0 0]
constexpr int kTile = 256;      // rows of a ring slot
constexpr int kStages = 2;
constexpr int kTileFloats = kTile * kRowFloats;
constexpr float kDetEps = 1e-12f;

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

__global__ void __launch_bounds__(kThreads)
mt_intersect_kernel(const float* __restrict__ rows, int n_tri,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t_init,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    int n) {
  __shared__ __align__(128) float ring[kStages * kTileFloats];
  __shared__ __align__(8) unsigned long long bars[2 * kStages];
  constexpr int kWarps = kThreads / 32;
  const uint32_t ring_a = smem_addr(ring);
  const uint32_t full_a = smem_addr(bars);
  const uint32_t empty_a = full_a + 8 * kStages;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x == 0;
  const int n_tiles = (n_tri + kTile - 1) / kTile;

  const auto load_tile = [&](int i) {  // rows [i kTile, (i + 1) kTile)
    const int s = i % kStages;
    const int count = min(kTile, n_tri - i * kTile);
    bulk_load(ring_a + s * (kTileFloats * 4),
              rows + static_cast<size_t>(i) * kTileFloats,
              static_cast<uint32_t>(count) * (kRowFloats * 4),
              full_a + 8 * s);
  };
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (producer) {
    for (int i = 0; i < kStages && i < n_tiles; ++i) load_tile(i);
  }

  // the thread's ray, while the first tiles arrive
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  float rox = 0.f, roy = 0.f, roz = 0.f, rdx = 0.f, rdy = 1.f, rdz = 0.f;
  float t_b = -1.f;  // threads past the end never hit
  if (ray < n) {
    rox = ox[ray]; roy = oy[ray]; roz = oz[ray];
    rdx = dx[ray]; rdy = dy[ray]; rdz = dz[ray];
    t_b = t_init[ray];
  }
  const bool open = t_b > 0.f;  // a positive radius: the ray can hit at all
  int tri_b = -1;
  float u_b = 0.f, v_b = 0.f;

  int s = 0;            // tile i's slot, i % kStages, and
  uint32_t parity = 0;  // the parity of its use of it, (i / kStages) & 1
  for (int i = 0; i < n_tiles; ++i) {
    const int count = min(kTile, n_tri - i * kTile);
    mbar_wait(full_a + 8 * s, parity);
    const float* tile = ring + s * kTileFloats;
    for (int k = 0; k < count; ++k) {
      const float4* r = reinterpret_cast<const float4*>(tile + k * kRowFloats);
      const float4 r0 = r[0], r1 = r[1], r2 = r[2];
      const float p0x = r0.x, p0y = r0.y, p0z = r0.z;
      const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
      const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
      // pvec = d x e2
      const float pvx = rdy * e2z - rdz * e2y;
      const float pvy = rdz * e2x - rdx * e2z;
      const float pvz = rdx * e2y - rdy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool ok = fabsf(det) >= kDetEps;
      const float inv_det = ok ? 1.0f / det : 0.0f;
      const float tvx = rox - p0x;
      const float tvy = roy - p0y;
      const float tvz = roz - p0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      // none of the warp's 32 rays can hit this triangle: skip the tail
      if (!__any_sync(0xffffffffu, ok && open && u >= 0.f && u <= 1.f)) {
        continue;
      }
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      if (ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f && t < t_b) {
        t_b = t;
        tri_b = i * kTile + k;
        u_b = u;
        v_b = v;
      }
    }
    // this warp has left slot s; when all have, the producer refills it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_a + 8 * s);
    if (producer && i + kStages < n_tiles) {
      mbar_wait(empty_a + 8 * s, parity);
      // the warps' reads of the slot before the copy engine's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      load_tile(i + kStages);
    }
    if (++s == kStages) {
      s = 0;
      parity ^= 1;
    }
  }

  if (ray < n) {
    t_out[ray] = t_b;
    tri_out[ray] = tri_b;
    u_out[ray] = u_b;
    v_out[ray] = v_b;
  }
}

}  // namespace

// rows: (n_tri, 12) f32 [p0 e1 e2 0 0 0], 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mt_intersect(const float* rows, int n_tri, const float* ox,
                            const float* oy, const float* oz, const float* dx,
                            const float* dy, const float* dz,
                            const float* t_init, float* t, int* tri, float* u,
                            float* v, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n > INT_MAX - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n - 1) / kThreads + 1;
  mt_intersect_kernel<<<grid, kThreads, 0, stream>>>(
      rows, n_tri, ox, oy, oz, dx, dy, dz, t_init, t, tri, u, v, n);
  return static_cast<int>(cudaGetLastError());
}
