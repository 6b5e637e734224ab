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
// The 4-wide walk is the same kernel (kWide) with a wide row's visit in
// place of a binary one: leaves after nodes, persistent warps, the int2
// stack in local memory, raw leaves through leaf_raw; a 128-byte row comes
// as eight float4.  Its first design (one ray a thread for the whole
// launch, node and leaf visits in one loop, a row as 29 scalar loads) ran
// 1.9 times as long; at 6 blocks an SM it is 4.5% faster than at 4, where
// it needs no spill (PERF.md, PR 8).  A visit takes the live children far
// to near by the row's axis and the ray's direction sign, pushes all but
// the nearest and follows that one; every entry, pruned or leaf, counts
// against max_iters: each ray's sequence of visits is the one of
// `_walk_wide`, and the kernel equals it bit for bit.

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

// The rays a warp with the lanes `live` in flight takes from `counter`, one
// for each idle lane -> the ray this lane takes (n or more: none); sets
// `exhausted` (the same in the warp) once the counter has passed n.
__device__ __forceinline__ int next_ray(unsigned live, unsigned lane,
                                        int* __restrict__ counter, int n,
                                        bool& exhausted) {
  const unsigned idle = ~live;
  const int want = __popc(idle);
  int first = 0;
  if (lane == 0) first = atomicAdd(counter, want);
  first = __shfl_sync(kFull, first, 0);
  exhausted = first + want >= n;
  return first + __popc(idle & ((1u << lane) - 1u));
}

// One binary row (internal node `code`): both children slab-tested, the
// near one followed, the far one pushed when both are hit; `have` is false
// when neither is.
__device__ __forceinline__ void visit_binary(const float* __restrict__ nodes,
                                             const Ray& r, float t_b,
                                             int& code, float& te, bool& have,
                                             int2* stack, int& sp) {
  float f[16];
  load_vec<4>(f, reinterpret_cast<const float4*>(
                     nodes + static_cast<size_t>(code) * 16));
  const float tel = slab_box(f[0], f[1], f[2], f[3], f[4], f[5], r, t_b);
  const float ter = slab_box(f[6], f[7], f[8], f[9], f[10], f[11], r, t_b);
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

// One 4-wide row (the TPU's _kernel_wide, bvh_kernel.py:589-660): its
// children, stored ascending along the row's axis, are taken far to near
// (a ray going up the axis meets child 0 first, so it takes 3, 2, 1, 0);
// every live one but the last is pushed and the last, the nearest, is
// followed.  Its 128 bytes come as eight float4: six for the four boxes,
// one for the codes, one for the axis.
__device__ __forceinline__ void visit_wide(const float* __restrict__ nodes,
                                           const Ray& r, float t_b, int& code,
                                           float& te, bool& have, int2* stack,
                                           int& sp) {
  float f[32];
  load_vec<8>(f, reinterpret_cast<const float4*>(
                     nodes + static_cast<size_t>(code) * 32));
  const int axis = static_cast<int>(f[28]);
  const float dsel = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  const bool d_pos = dsel > 0.0f;
  float tes[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* c = f + 6 * k;
    tes[k] = slab_box(c[0], c[1], c[2], c[3], c[4], c[5], r, t_b);
  }
  have = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float te_k = d_pos ? tes[3 - j] : tes[j];
    if (te_k < kInf) {
      if (have && sp < kMaxStack) {  // a nearer live child follows
        stack[sp] = make_int2(code, __float_as_int(te));
        ++sp;
      }
      code = static_cast<int>(d_pos ? f[27 - j] : f[24 + j]);
      te = te_k;
      have = true;
    }
  }
}

// The walk, binary or 4-wide (kWide: over raw leaves).  `counter`, zero
// when the kernel starts, is the next ray a warp takes.
template <bool kAnyHit, bool kLeaf16, bool kWide>
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
      const int i = next_ray(live, lane, counter, n, exhausted);
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

    // ---- internal rows, until this lane holds a leaf or is done
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
      if (kWide) {
        visit_wide(nodes, r, b.t, code, te, have, stack, sp);
      } else {
        visit_binary(nodes, r, b.t, code, te, have, stack, sp);
      }
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

// Zero the counter on the stream, then launch the walk `kKernel` on no more
// blocks than the card holds at once.
// -> the CUDA error, 0 if launched; a refused launch leaves no error behind
// for later calls.
template <auto kKernel>
int launch(const float* nodes, const float* leaves, const float* ox,
           const float* oy, const float* oz, const float* dx, const float* dy,
           const float* dz, const float* t0, float* t, int* tri, float* u,
           float* v, int n, int init_code, int max_iters, int* counter,
           cudaStream_t stream) {
  // the resident blocks are asked once a device and kept (per kernel): a
  // launch then costs the host one cudaGetDevice
  static int ready_dev = -1, resident = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != ready_dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel,
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
  kKernel<<<grid, kBlock, 0, stream>>>(nodes, leaves, ox, oy, oz, dx, dy, dz,
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
  const auto fn =
      any_hit ? (leaf16 ? launch<bvh_traverse_kernel<true, true, false>>
                        : launch<bvh_traverse_kernel<true, false, false>>)
              : (leaf16 ? launch<bvh_traverse_kernel<false, true, false>>
                        : launch<bvh_traverse_kernel<false, false, false>>);
  return fn(nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u, v, n,
            init_code, max_iters, counter, stream);
}

// The 4-wide walk over raw leaves, with `counter` as for bvh_traverse;
// launches on `stream` and returns the CUDA error (0 = launched).
extern "C" int bvh_traverse_wide(const float* nodes, const float* leaves,
                                 const float* ox, const float* oy,
                                 const float* oz, const float* dx,
                                 const float* dy, const float* dz,
                                 const float* t0, float* t, int* tri,
                                 float* u, float* v, int n, int init_code,
                                 int max_iters, int any_hit, int* counter,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  const auto fn = any_hit ? launch<bvh_traverse_kernel<true, false, true>>
                          : launch<bvh_traverse_kernel<false, false, true>>;
  return fn(nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u, v, n,
            init_code, max_iters, counter, stream);
}
