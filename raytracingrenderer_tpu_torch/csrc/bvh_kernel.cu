// Ordered BVH traversal, binary and 4-wide, closest-hit and any-hit, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels raytracingrenderer_tpu/ops/bvh_kernel.py::_kernel
// (binary) and ::_kernel_wide (4-wide), both Pallas, launched by
// traverse_packet.  They compute what those kernels compute, over the same
// packed tables (ops/bvh_kernel.py):
//   nodes  (I, 16) f32: [llo lhi rlo rhi] lcode rcode axisbits 0, the codes
//          f32 integers (internal child = its row, leaf child = -(row+1));
//   wide   (W, 32) f32: lanes 6k..6k+5 child k's [lo hi], children sorted
//          ascending along the row's axis (lane 28), codes in lanes 24..27;
//          an empty slot is a point at +3e38, which the slab test misses;
//   leaves raw (L, 128) f32: 14 x [p0 e1 e2] + start (lane 126) for
//          closest-hit and for the wide walk, or constant-form (2L, 128)
//          f32 row pairs of 14 x [N e1 e2 P1 P2 c0] + start (lane 120 of
//          the odd row) for binary any-hit.
// Per ray: the walk starts at the root's children with t_entry = 0; every
// visit re-tests `t_entry < t_best`, so a subtree popped from the stack is
// pruned by the ray's current best hit; a binary visit slab-tests both
// children, follows the near one and pushes the far one when both are hit;
// a wide visit slab-tests up to 4 children, takes them far to near, pushes
// every live one but the last and follows the last (the nearest); a leaf
// tests its (up to) 14 triangles in slot order with a strict
// `t < t_best`; any-hit stops at the first hit.  A stack of 64 entries
// (>= tree depth for the binary walk, >= 3 * ceil(depth / 2) + 1 for the
// wide one, which the wrapper checks) and an iteration cap of
// 4 * binary nodes + 64 bound the walk.  A miss keeps the seed; the
// wrapper maps it back to the caller's t_init.
//
// Design.  One ray per thread, 128 threads a block: the TPU kernels walk the
// tree once per block of rays only because the vector unit has no per-lane
// gather.  Here each thread keeps its own (code, t_entry) stack in local
// memory and orders children by its own direction sign on the node's axis
// (the TPU kernels use the block's summed direction; order only decides
// ties between equal t in different leaves).  Node and leaf rows are read
// straight from global memory through the read-only path (__ldg).
//
// Bound.  Incoherent rays diverge at once: threads of a warp visit different
// nodes, so every visit is a divergent, latency-bound gather of a 64-byte
// (binary) or 128-byte (wide) node row or a 504-byte leaf row, with little
// arithmetic to hide it.  The wide walk makes half as many visits, each
// reading twice the bytes.  Making it fast (a shared-memory top of the tree,
// compressed nodes, ray sorting into warps) is later work; this version is
// the simple correct one.
//
// Arithmetic follows the TPU kernels (bvh_kernel.py:78-217, 515-587)
// operation by operation, including 1/where(|d| < 1e-20, 1e-20, d).  Build
// with --fmad=false, so that it rounds as the plain torch version does.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStack = 64;
constexpr int kSlots = 14;
constexpr float kInf = 3.0e38f;
constexpr float kDetEps = 1e-12f;
constexpr int kLaneStart = 126;
constexpr int kLane16Start = 120;

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

// Entry distance of one child box ([lo hi] at `c`), kInf if missed or
// beyond the current best.
__device__ __forceinline__ float slab(const float* __restrict__ c,
                                      const Ray& r, float t_b) {
  const float t0x = __ldg(c + 0) * r.ix - r.oix;
  const float t1x = __ldg(c + 3) * r.ix - r.oix;
  const float t0y = __ldg(c + 1) * r.iy - r.oiy;
  const float t1y = __ldg(c + 4) * r.iy - r.oiy;
  const float t0z = __ldg(c + 2) * r.iz - r.oiz;
  const float t1z = __ldg(c + 5) * r.iz - r.oiz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
  const float te = fmaxf(tmin, 0.0f);
  return (tmax >= te && te < t_b) ? te : kInf;
}

// Raw-form Moller-Trumbore over one leaf row (bvh_kernel.py:176-217).
template <bool kAnyHit>
__device__ __forceinline__ void leaf_raw(const float* __restrict__ row,
                                         const Ray& r, Best& b) {
  const int base = static_cast<int>(__ldg(row + kLaneStart));
#pragma unroll 2
  for (int k = 0; k < kSlots; ++k) {
    const float* s = row + 9 * k;
    const float p0x = __ldg(s + 0), p0y = __ldg(s + 1), p0z = __ldg(s + 2);
    const float e1x = __ldg(s + 3), e1y = __ldg(s + 4), e1z = __ldg(s + 5);
    const float e2x = __ldg(s + 6), e2y = __ldg(s + 7), e2z = __ldg(s + 8);
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
      b.tri = base + k;
      if (kAnyHit) {
        b.t = -1.0f;  // occluded: every later test fails
        return;
      }
      b.t = tt;
      b.u = uu;
      b.v = vv;
    }
  }
}

// Constant-form Moller-Trumbore over one leaf row pair
// (bvh_kernel.py:121-174): slots 0-7 in the even row, 8-13 in the odd one.
template <bool kAnyHit>
__device__ __forceinline__ void leaf_const(const float* __restrict__ rows,
                                           const Ray& r, Best& b) {
  const int base = static_cast<int>(__ldg(rows + 128 + kLane16Start));
#pragma unroll 2
  for (int k = 0; k < kSlots; ++k) {
    const float* s = rows + (k < 8 ? 16 * k : 128 + 16 * (k - 8));
    const float nx = __ldg(s + 0), ny = __ldg(s + 1), nz = __ldg(s + 2);
    const float e1x = __ldg(s + 3), e1y = __ldg(s + 4), e1z = __ldg(s + 5);
    const float e2x = __ldg(s + 6), e2y = __ldg(s + 7), e2z = __ldg(s + 8);
    const float p1x = __ldg(s + 9), p1y = __ldg(s + 10), p1z = __ldg(s + 11);
    const float p2x = __ldg(s + 12), p2y = __ldg(s + 13), p2z = __ldg(s + 14);
    const float c0 = __ldg(s + 15);
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
      b.tri = base + k;
      if (kAnyHit) {
        b.t = -1.0f;
        return;
      }
      const float rcp = 1.0f / ad;
      b.t = st * rcp;
      b.u = su * rcp;
      b.v = sv * rcp;
    }
  }
}

template <bool kAnyHit, bool kLeaf16>
__global__ void __launch_bounds__(kBlock)
bvh_traverse_kernel(const float* __restrict__ nodes,
                    const float* __restrict__ leaves,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t0, float* __restrict__ t_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int n, int init_code,
                    int max_iters) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  r.oix = r.ox * r.ix; r.oiy = r.oy * r.iy; r.oiz = r.oz * r.iz;
  r.gx = r.oy * r.dz - r.oz * r.dy;
  r.gy = r.oz * r.dx - r.ox * r.dz;
  r.gz = r.ox * r.dy - r.oy * r.dx;
  Best b{t0[i], -1, 0.0f, 0.0f};

  int nstack[kMaxStack];
  float tstack[kMaxStack];
  int sp = 0;
  bool have = true;
  int code = init_code;
  float te = 0.0f;  // the root's children are tested from t = 0
  for (int it = 0; (have || sp > 0) && it < max_iters; ++it) {
    if (!have) {  // refill from the stack
      --sp;
      code = nstack[sp];
      te = tstack[sp];
    }
    const bool m = te < b.t;
    float tel = kInf, ter = kInf;
    int lcode = 0, rcode = 0, ab = 0;
    if (code < 0) {
      if (m) {
        const int row = -code - 1;
        if (kLeaf16) {
          leaf_const<kAnyHit>(leaves + static_cast<size_t>(row) * 256, r, b);
        } else {
          leaf_raw<kAnyHit>(leaves + static_cast<size_t>(row) * 128, r, b);
        }
      }
    } else if (m) {
      const float* nd = nodes + static_cast<size_t>(code) * 16;
      tel = slab(nd + 0, r, b.t);
      ter = slab(nd + 6, r, b.t);
      lcode = static_cast<int>(__ldg(nd + 12));
      rcode = static_cast<int>(__ldg(nd + 13));
      ab = static_cast<int>(__ldg(nd + 14));
    }
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
      nstack[sp] = code_s;
      tstack[sp] = te_s;
      ++sp;
    }
    have = any_f || any_s;
    code = any_f ? code_f : code_s;
    te = any_f ? te_f : te_s;
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
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = inv_dir(r.dx); r.iy = inv_dir(r.dy); r.iz = inv_dir(r.dz);
  r.oix = r.ox * r.ix; r.oiy = r.oy * r.iy; r.oiz = r.oz * r.iz;
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

template <bool kAnyHit, bool kLeaf16>
void launch(const float* nodes, const float* leaves, const float* ox,
            const float* oy, const float* oz, const float* dx, const float* dy,
            const float* dz, const float* t0, float* t, int* tri, float* u,
            float* v, int n, int init_code, int max_iters,
            cudaStream_t stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  bvh_traverse_kernel<kAnyHit, kLeaf16><<<grid, kBlock, 0, stream>>>(
      nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u, v, n, init_code,
      max_iters);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int bvh_traverse(const float* nodes, const float* leaves,
                            const float* ox, const float* oy, const float* oz,
                            const float* dx, const float* dy, const float* dz,
                            const float* t0, float* t, int* tri, float* u,
                            float* v, int n, int init_code, int max_iters,
                            int any_hit, int leaf16, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (any_hit) {
    if (leaf16) {
      launch<true, true>(nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u,
                         v, n, init_code, max_iters, stream);
    } else {
      launch<true, false>(nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri,
                          u, v, n, init_code, max_iters, stream);
    }
  } else if (leaf16) {
    launch<false, true>(nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u,
                        v, n, init_code, max_iters, stream);
  } else {
    launch<false, false>(nodes, leaves, ox, oy, oz, dx, dy, dz, t0, t, tri, u,
                         v, n, init_code, max_iters, stream);
  }
  return static_cast<int>(cudaGetLastError());
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
