// Ordered BVH traversal, binary and 4-wide, closest-hit and any-hit, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels raytracingrenderer_tpu/ops/bvh_kernel.py:65
// `_kernel` (binary) and :498 `_kernel_wide` (4-wide), both Pallas, launched
// by traverse_packet (:814).  They compute what those kernels compute, over
// the same packed tables (ops/bvh_kernel.py):
//   nodes  (I, 16) f32: [llo lhi rlo rhi] lcode rcode axisbits 0, the codes
//          f32 integers (internal child = its row, leaf child = -(row+1));
//   wide   (W, 32) f32: lanes 6k..6k+5 child k's [lo hi], children sorted
//          ascending along the row's axis (lane 28), codes in lanes 24..27;
//          an empty slot is a point at +3e38, which the slab test misses;
//   leaves raw (L, 128) f32: 14 x [p0 e1 e2], start (lane 126) and count
//          (lane 127), for closest-hit and for the wide walk, or
//          constant-form (2L, 128) f32 row pairs of 14 x [N e1 e2 P1 P2 c0]
//          with start and count at lanes 120, 121 of the odd row, for binary
//          any-hit.  Slots at and above the count are zeros.
// Per ray: the walk starts at the root's children with t_entry = 0; every
// visit re-tests `t_entry < t_best`, so a subtree popped from the stack is
// pruned by the ray's current best hit; a binary visit slab-tests both
// children, follows the near one and pushes the far one when both are hit;
// a wide visit slab-tests up to 4 children, takes them far to near, pushes
// every live one but the last and follows the last (the nearest); a leaf
// tests its triangles in slot order with a strict `t < t_best`; any-hit
// stops at the first hit.  A stack of 64 entries (>= tree depth for the
// binary walk, >= 3 * ceil(depth / 2) + 1 for the wide one, which the
// wrapper checks) and a cap of 4 * binary nodes + 64 visits bound the walk.
// A miss keeps the seed; the wrapper maps it back to the caller's t_init.
//
// What bounds the binary walk (bvh_traverse_kernel).  Not arithmetic: 2^20
// incoherent rays make some 16 M node visits and 2 M leaf visits, about
// 1.7 GFLOP, 25 us at the FP32 peak.  Each visit is a dependent load (the
// next row's address comes out of this row's slab tests), so a lane waits a
// cache round trip a visit; the lanes of a warp sit on different rows and at
// different kinds of entry (divergence); and the rows read, visits x row
// bytes (64 a node, up to 512 a raw leaf, up to 1024 a constant-form one:
// some 1.5 GB), come through L2, which holds the tables as long as they
// stay under its 50 MB.  A warp lives as long as its slowest ray.  What the
// design does about each (PERF.md has the time of every element alone and
// of the ones that were tried and dropped: the stack in shared memory, a
// quorum that ends the node walk early, the top of the tree in shared
// memory):
//   - leaves after nodes: a lane walks internal nodes until it holds a leaf
//     or is done and waits there; the warp then runs the leaf code once for
//     many lanes instead of once a visit for a few (the loop of Aila and
//     Laine, HPG 2009).  A lane holds at most one leaf aside and does not
//     walk on before it is tested: its result moves t_best, which prunes
//     every later pop.
//   - 16-byte loads: a node row is four float4 through the read-only path, a
//     constant-form triangle four, raw leaves nine for four triangles: a
//     fifth to a quarter of the load instructions, and all of a row's loads
//     in flight at once.
//   - the leaf's count: only the slots the row holds are loaded and tested;
//     the others are zeros that fail |det| >= eps.
//   - persistent warps: as many blocks as the card holds at once
//     (kMinBlocks = 6 an SM asked of the compiler, which caps the registers
//     at 80); a warp with fewer than kRefillBelow = 16 rays in flight gives
//     its idle lanes the next rays of a global counter.  With the loop above
//     this is the largest single gain: one long ray no longer holds a warp
//     of idle lanes.  The counter is scratch the wrapper keeps per stream;
//     the launcher zeroes it on the stream before the kernel.  (A kernel
//     that zeroes it again itself, its last block or warp to finish, needs
//     code behind the loop and ran 1.5-1.7 times as long.)
//   - the stack stays in local memory, whose top entries live in L1: the
//     walk hides latency with resident warps, and a shared-memory stack
//     takes them away.
// No element changes a ray's sequence of visits or the arithmetic of a test:
// the visit order depends only on the ray's own stack, and a skipped slot is
// all zeros.  Arithmetic follows the TPU kernels (bvh_kernel.py:78-217,
// 515-587) operation by operation, including 1/where(|d| < 1e-20, 1e-20, d).
// Build with --fmad=false, so that it rounds as the plain torch version
// does: the kernels equal `traverse_plain` bit for bit.
//
// The 4-wide walk (bvh_traverse_wide_kernel) keeps the first design: one ray
// per thread for the whole launch, node rows read four bytes a load; it
// shares the leaf test above.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStack = 64;
constexpr float kInf = 3.0e38f;
constexpr float kDetEps = 1e-12f;
constexpr int kLane16Start = 120;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMinBlocks = 6;     // blocks an SM asked of the compiler
constexpr int kRefillBelow = 16;  // a warp with fewer live rays takes more

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oix, oiy, oiz;
  float gx, gy, gz;  // o x d, for the constant-form leaf test
};

struct Best {
  float t;
  int tri;
  float u, v;
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox,
                                        const float* __restrict__ oy,
                                        const float* __restrict__ oz,
                                        const float* __restrict__ dx,
                                        const float* __restrict__ dy,
                                        const float* __restrict__ dz, int i) {
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  r.oix = r.ox * r.ix; r.oiy = r.oy * r.iy; r.oiz = r.oz * r.iz;
  r.gx = r.oy * r.dz - r.oz * r.dy;
  r.gy = r.oz * r.dx - r.ox * r.dz;
  r.gz = r.ox * r.dy - r.oy * r.dx;
  return r;
}

// Entry distance of the box [lo, hi], kInf if missed or beyond the current
// best.
__device__ __forceinline__ float slab_box(float lox, float loy, float loz,
                                          float hix, float hiy, float hiz,
                                          const Ray& r, float t_b) {
  const float t0x = lox * r.ix - r.oix;
  const float t1x = hix * r.ix - r.oix;
  const float t0y = loy * r.iy - r.oiy;
  const float t1y = hiy * r.iy - r.oiy;
  const float t0z = loz * r.iz - r.oiz;
  const float t1z = hiz * r.iz - r.oiz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
  const float te = fmaxf(tmin, 0.0f);
  return (tmax >= te && te < t_b) ? te : kInf;
}

// The same for one child box stored as [lo hi] at `c`, four bytes a load.
__device__ __forceinline__ float slab(const float* __restrict__ c,
                                      const Ray& r, float t_b) {
  return slab_box(__ldg(c + 0), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3),
                  __ldg(c + 4), __ldg(c + 5), r, t_b);
}

// Raw-form Moller-Trumbore of one triangle [p0 e1 e2] at f[0..8]
// (bvh_kernel.py:176-217); records a hit nearer than b.t under the id `tri`.
// -> true when an any-hit ray is now occluded.
template <bool kAnyHit>
__device__ __forceinline__ bool test_raw(const float* f, const Ray& r,
                                         Best& b, int tri) {
  const float p0x = f[0], p0y = f[1], p0z = f[2];
  const float e1x = f[3], e1y = f[4], e1z = f[5];
  const float e2x = f[6], e2y = f[7], e2z = f[8];
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float inv_det = fabsf(det) < kDetEps ? 0.0f : 1.0f / det;
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if (fabsf(det) >= kDetEps && uu >= 0.0f && vv >= 0.0f &&
      uu + vv <= 1.0f && tt > 0.0f && tt < b.t) {
    b.tri = tri;
    if (kAnyHit) {
      b.t = -1.0f;  // occluded: every later test fails
      return true;
    }
    b.t = tt;
    b.u = uu;
    b.v = vv;
  }
  return false;
}

// Constant-form Moller-Trumbore of one triangle [N e1 e2 P1 P2 c0] at
// f[0..15] (bvh_kernel.py:121-174); as test_raw.
template <bool kAnyHit>
__device__ __forceinline__ bool test_const(const float* f, const Ray& r,
                                           Best& b, int tri) {
  const float nx = f[0], ny = f[1], nz = f[2];
  const float e1x = f[3], e1y = f[4], e1z = f[5];
  const float e2x = f[6], e2y = f[7], e2z = f[8];
  const float p1x = f[9], p1y = f[10], p1z = f[11];
  const float p2x = f[12], p2y = f[13], p2z = f[14];
  const float c0 = f[15];
  const float det = -(r.dx * nx + r.dy * ny + r.dz * nz);
  const float tp = r.ox * nx + r.oy * ny + r.oz * nz - c0;
  const float up = r.gx * e2x + r.gy * e2y + r.gz * e2z + r.dx * p2x +
                   r.dy * p2y + r.dz * p2z;
  const float vp = -(r.gx * e1x + r.gy * e1y + r.gz * e1z + r.dx * p1x +
                     r.dy * p1y + r.dz * p1z);
  const float sgn = det < 0.0f ? -1.0f : 1.0f;
  const float ad = det * sgn;
  const float su = up * sgn;
  const float sv = vp * sgn;
  const float st = tp * sgn;
  if (ad >= kDetEps && su >= 0.0f && sv >= 0.0f && su + sv <= ad &&
      st > 0.0f && st < b.t * ad) {
    b.tri = tri;
    if (kAnyHit) {
      b.t = -1.0f;
      return true;
    }
    const float rcp = 1.0f / ad;
    b.t = st * rcp;
    b.u = su * rcp;
    b.v = sv * rcp;
  }
  return false;
}

// `kCount` float4 of the 16-byte aligned `src`, through the read-only path,
// into f[0 .. 4 * kCount).
template <int kCount>
__device__ __forceinline__ void load_vec(float* f,
                                         const float4* __restrict__ src) {
#pragma unroll
  for (int j = 0; j < kCount; ++j) {
    const float4 q = __ldg(src + j);
    f[4 * j + 0] = q.x;
    f[4 * j + 1] = q.y;
    f[4 * j + 2] = q.z;
    f[4 * j + 3] = q.w;
  }
}

// One raw leaf row (128 floats, 512-byte aligned): the triangles it holds,
// in slot order.  Four triangles are 36 floats, nine float4; slots 12 and 13
// end in the row's last float4 beside the start and the count.
template <bool kAnyHit>
__device__ __forceinline__ void leaf_raw(const float* __restrict__ row,
                                         const Ray& r, Best& b) {
  const float4* q = reinterpret_cast<const float4*>(row);
  const float4 tail = __ldg(q + 31);
  const int base = static_cast<int>(tail.z);
  const int cnt = static_cast<int>(tail.w);
#pragma unroll 1
  for (int g = 0; g < 3 && 4 * g < cnt; ++g) {
    float f[36];
    load_vec<9>(f, q + 9 * g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * g + k < cnt &&
          test_raw<kAnyHit>(f + 9 * k, r, b, base + 4 * g + k)) {
        return;
      }
    }
  }
  if (12 < cnt) {
    float f[18];
    load_vec<4>(f, q + 27);
    f[16] = tail.x;
    f[17] = tail.y;
    if (test_raw<kAnyHit>(f, r, b, base + 12)) return;
    if (13 < cnt) test_raw<kAnyHit>(f + 9, r, b, base + 13);
  }
}

// One constant-form leaf row pair (256 floats): slot k's 16 constants lie at
// float 16 * k (slots 0-7 in the even row, 8-13 in the odd one), start and
// count at floats 248, 249.
template <bool kAnyHit>
__device__ __forceinline__ void leaf_const(const float* __restrict__ rows,
                                           const Ray& r, Best& b) {
  const float4 tail =
      __ldg(reinterpret_cast<const float4*>(rows + 128 + kLane16Start));
  const int base = static_cast<int>(tail.x);
  const int cnt = static_cast<int>(tail.y);
#pragma unroll 2
  for (int k = 0; k < cnt; ++k) {
    float f[16];
    load_vec<4>(f, reinterpret_cast<const float4*>(rows) + 4 * k);
    if (test_const<kAnyHit>(f, r, b, base + k)) return;
  }
}

// The binary walk.  `counter`, zero when the kernel starts, is the next ray
// a warp takes.
template <bool kAnyHit, bool kLeaf16>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
bvh_traverse_kernel(const float* __restrict__ nodes,
                    const float* __restrict__ leaves,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t0, float* __restrict__ t_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int n, int init_code,
                    int max_iters, int* __restrict__ counter) {
  const unsigned lane = threadIdx.x & 31u;
  int2 stack[kMaxStack];  // (code, t_entry) words, in local memory

  Ray r{};
  Best b{0.0f, -1, 0.0f, 0.0f};
  int idx = 0, code = 0, sp = 0, it = 0;
  float te = 0.0f;
  bool alive = false;      // this lane holds a ray that is not finished
  bool have = false;       // (code, te) is an entry not yet visited
  bool exhausted = false;  // no ray is left to take (the same in a warp)
  for (;;) {
    // ---- rays: a warp with too few in flight hands its idle lanes the next
    unsigned live = __ballot_sync(kFull, alive);
    if (!exhausted && __popc(live) < kRefillBelow) {
      const unsigned idle = ~live;
      const int want = __popc(idle);
      int first = 0;
      if (lane == 0) first = atomicAdd(counter, want);
      first = __shfl_sync(kFull, first, 0);
      exhausted = first + want >= n;
      const int i = first + __popc(idle & ((1u << lane) - 1u));
      if (!alive && i < n) {
        idx = i;
        r = load_ray(ox, oy, oz, dx, dy, dz, i);
        b = Best{t0[i], -1, 0.0f, 0.0f};
        code = init_code;
        te = 0.0f;  // the root's children are tested from t = 0
        sp = 0;
        it = 0;
        have = true;
        alive = true;
      }
      live = __ballot_sync(kFull, alive);
    }
    if (live == 0) break;
    const bool was_alive = alive;

    // ---- internal nodes, until this lane holds a leaf or is done
    bool leaf = false;
    while (alive) {
      if (!have) {  // refill from the stack
        if (sp == 0) {
          alive = false;
          break;
        }
        --sp;
        code = stack[sp].x;
        te = __int_as_float(stack[sp].y);
        have = true;
      }
      if (it >= max_iters) {
        alive = false;
        break;
      }
      ++it;
      if (!(te < b.t)) {  // pruned by the best hit so far
        have = false;
        continue;
      }
      if (code < 0) {
        leaf = true;
        break;
      }
      float f[16];
      load_vec<4>(f, reinterpret_cast<const float4*>(
                         nodes + static_cast<size_t>(code) * 16));
      const float tel = slab_box(f[0], f[1], f[2], f[3], f[4], f[5], r, b.t);
      const float ter = slab_box(f[6], f[7], f[8], f[9], f[10], f[11], r, b.t);
      const int lcode = static_cast<int>(f[12]);
      const int rcode = static_cast<int>(f[13]);
      const int ab = static_cast<int>(f[14]);
      // near child: this ray's direction sign on the split axis (bit 0-1)
      // against which child lies lower on it (bit 2)
      const int axis = ab & 3;
      const bool l_low = (ab & 4) != 0;
      const float dsel = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
      const bool left_near = (dsel > 0.0f) == l_low;
      const int code_f = left_near ? lcode : rcode;
      const int code_s = left_near ? rcode : lcode;
      const float te_f = left_near ? tel : ter;
      const float te_s = left_near ? ter : tel;
      const bool any_f = te_f < kInf;
      const bool any_s = te_s < kInf;
      if (any_f && any_s && sp < kMaxStack) {  // fork: push the far child
        stack[sp] = make_int2(code_s, __float_as_int(te_s));
        ++sp;
      }
      have = any_f || any_s;
      code = any_f ? code_f : code_s;
      te = any_f ? te_f : te_s;
    }
    __syncwarp();

    // ---- the leaf held aside, for every lane of the warp that has one
    if (leaf) {
      const size_t row = static_cast<size_t>(-code - 1);
      if (kLeaf16) {
        leaf_const<kAnyHit>(leaves + row * 256, r, b);
      } else {
        leaf_raw<kAnyHit>(leaves + row * 128, r, b);
      }
      have = false;
      if (kAnyHit && b.t < 0.0f) alive = false;  // occluded: done
    }
    if (was_alive && !alive) {
      t_out[idx] = b.t;
      tri_out[idx] = b.tri;
      u_out[idx] = b.u;
      v_out[idx] = b.v;
    }
  }
}

// 4-wide walk over raw leaves (the TPU's _kernel_wide, bvh_kernel.py:589-660).
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
bvh_traverse_wide_kernel(const float* __restrict__ nodes,
                         const float* __restrict__ leaves,
                         const float* __restrict__ ox,
                         const float* __restrict__ oy,
                         const float* __restrict__ oz,
                         const float* __restrict__ dx,
                         const float* __restrict__ dy,
                         const float* __restrict__ dz,
                         const float* __restrict__ t0,
                         float* __restrict__ t_out,
                         int* __restrict__ tri_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int n, int init_code,
                         int max_iters) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  Best b{t0[i], -1, 0.0f, 0.0f};

  int nstack[kMaxStack];
  float tstack[kMaxStack];
  int sp = 0;
  bool have = true;
  int code = init_code;
  float te = 0.0f;
  for (int it = 0; (have || sp > 0) && it < max_iters; ++it) {
    if (!have) {  // refill from the stack
      --sp;
      code = nstack[sp];
      te = tstack[sp];
    }
    const bool m = te < b.t;
    float tes[4] = {kInf, kInf, kInf, kInf};
    int cds[4] = {0, 0, 0, 0};
    int axis = 0;
    if (code < 0) {
      if (m) {
        leaf_raw<kAnyHit>(leaves + static_cast<size_t>(-code - 1) * 128, r,
                          b);
      }
    } else if (m) {
      const float* nd = nodes + static_cast<size_t>(code) * 32;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        tes[k] = slab(nd + 6 * k, r, b.t);
        cds[k] = static_cast<int>(__ldg(nd + 24 + k));
      }
      axis = static_cast<int>(__ldg(nd + 28));
    }
    // children are stored ascending along `axis`: a ray going up the axis
    // meets child 0 first, so it takes 3, 2, 1, 0 and follows the last
    const float dsel = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
    const bool d_pos = dsel > 0.0f;
    have = false;
    int code_n = 0;
    float te_n = kInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float te_k = d_pos ? tes[3 - j] : tes[j];
      const int code_k = d_pos ? cds[3 - j] : cds[j];
      if (te_k < kInf) {
        if (have && sp < kMaxStack) {  // a nearer live child follows
          nstack[sp] = code_n;
          tstack[sp] = te_n;
          ++sp;
        }
        code_n = code_k;
        te_n = te_k;
        have = true;
      }
    }
    code = code_n;
    te = te_n;
    if (kAnyHit && b.t < 0.0f) {  // occluded: done
      have = false;
      sp = 0;
    }
  }
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

// Zero the counter on the stream, then launch the binary walk on no more
// blocks than the card holds at once.
// -> the CUDA error, 0 if launched; a refused launch leaves no error behind
// for later calls.
template <bool kAnyHit, bool kLeaf16>
int launch(const float* nodes, const float* leaves, const float* ox,
           const float* oy, const float* oz, const float* dx, const float* dy,
           const float* dz, const float* t0, float* t, int* tri, float* u,
           float* v, int n, int init_code, int max_iters, int* counter,
           cudaStream_t stream) {
  const auto kernel = bvh_traverse_kernel<kAnyHit, kLeaf16>;
  // the resident blocks are asked once a device and kept (per
  // instantiation): a launch then costs the host one cudaGetDevice
  static int ready_dev = -1, resident = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != ready_dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, 0);
    }
    if (e == cudaSuccess && per_sm < 1) e = cudaErrorLaunchOutOfResources;
    if (e == cudaSuccess) {
      resident = sms * per_sm;
      ready_dev = dev;
    }
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  int grid = (n + kBlock - 1) / kBlock;
  if (grid > resident) grid = resident;
  kernel<<<grid, kBlock, 0, stream>>>(nodes, leaves, ox, oy, oz, dx, dy, dz,
                                      t0, t, tri, u, v, n, init_code,
                                      max_iters, counter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The binary walk over n rays.  `counter` is one int of scratch (the next
// ray a persistent warp takes), zeroed here on `stream` before the kernel;
// launches that may run at the same time need one each.  Launches on
// `stream` and returns the CUDA error (0 = launched).
extern "C" int bvh_traverse(const float* nodes, const float* leaves,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* t0, float* t, int* tri, float* u,
                            float* v, int n, int init_code, int max_iters,
                            int any_hit, int leaf16, int* counter,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  const auto fn = any_hit ? (leaf16 ? launch<true, true> : launch<true, false>)
                          : (leaf16 ? launch<false, true>
                                    : launch<false, false>);
  return fn(nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u, v, n,
            init_code, max_iters, counter, stream);
}

// 4-wide walk over raw leaves; launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int bvh_traverse_wide(const float* nodes, const float* leaves,
                                 const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* t0, float* t, int* tri,
                                 float* u, float* v, int n, int init_code,
                                 int max_iters, int any_hit,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  if (any_hit) {
    bvh_traverse_wide_kernel<true><<<grid, kBlock, 0, stream>>>(
        nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u, v, n, init_code,
        max_iters);
  } else {
    bvh_traverse_wide_kernel<false><<<grid, kBlock, 0, stream>>>(
        nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u, v, n, init_code,
        max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}
