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
// Design.  One thread per pair, 128 threads a block.  The TPU kernel runs
// the four 16-deep contractions of a 1024-pair tile on its matrix unit at
// precision=HIGHEST and loops over the distinct treelet ids of the tile.
// Hopper's fp32 matrix path is TF32 (10-bit mantissa), which would lose the
// exactness of the hit decisions, so this kernel stays in IEEE fp32 on the
// CUDA cores, summing only the nonzero terms of each contraction, left to
// right in constant-row order.  Because the pairs are sorted by treelet,
// the threads of a warp nearly always read the same 16x128 constants tile
// (8 KB): at each column every thread loads the same address, a broadcast
// through the read-only cache (__ldg), and the tile stays in L1.
//
// Bound.  Per pair 128 columns x (16 loads + ~45 flops): issue-bound on the
// loads and the fp32 pipes; the feature row (64 B) is read once.  Staging a
// treelet-pure block's tile in shared memory and several pairs per thread
// are later work.
//
// Build with --fmad=false and IEEE division (the default), so that it
// rounds as pair_test_plain does, operation for operation.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kLeaf = 128;
constexpr float kInf = 3.0e38f;
constexpr float kDetEps = 1e-12f;

__global__ void __launch_bounds__(kBlock)
pair_test_kernel(const float* __restrict__ consts,
                 const float* __restrict__ feats, const int* __restrict__ tid,
                 float* __restrict__ t_out, int* __restrict__ col_out, int n,
                 int n_treelets) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const int k = tid[i];
  if (k < 0 || k >= n_treelets) {
    t_out[i] = kInf;
    col_out[i] = -1;
    return;
  }
  const float4* f4 = reinterpret_cast<const float4*>(feats) +
                     static_cast<size_t>(i) * 4;
  const float4 a = __ldg(f4 + 0);  // dx dy dz ox
  const float4 b = __ldg(f4 + 1);  // oy oz gx gy
  const float4 c = __ldg(f4 + 2);  // gz 1 maxt 0
  const float dx = a.x, dy = a.y, dz = a.z, ox = a.w;
  const float oy = b.x, oz = b.y, gx = b.z, gy = b.w;
  const float gz = c.x, maxt = c.z;
  const float ndx = -dx, ndy = -dy, ndz = -dz;
  const float ngx = -gx, ngy = -gy, ngz = -gz;
  const float* tile = consts + static_cast<size_t>(k) * 16 * kLeaf;

  float tmin = kInf;
  int col = -1;
#pragma unroll 4
  for (int j = 0; j < kLeaf; ++j) {
    const float* cj = tile + j;
    const float nx = __ldg(cj + 0 * kLeaf), ny = __ldg(cj + 1 * kLeaf);
    const float nz = __ldg(cj + 2 * kLeaf);
    const float e1x = __ldg(cj + 3 * kLeaf), e1y = __ldg(cj + 4 * kLeaf);
    const float e1z = __ldg(cj + 5 * kLeaf);
    const float e2x = __ldg(cj + 6 * kLeaf), e2y = __ldg(cj + 7 * kLeaf);
    const float e2z = __ldg(cj + 8 * kLeaf);
    const float p1x = __ldg(cj + 9 * kLeaf), p1y = __ldg(cj + 10 * kLeaf);
    const float p1z = __ldg(cj + 11 * kLeaf);
    const float p2x = __ldg(cj + 12 * kLeaf), p2y = __ldg(cj + 13 * kLeaf);
    const float p2z = __ldg(cj + 14 * kLeaf);
    const float c0 = __ldg(cj + 15 * kLeaf);
    const float det = ndx * nx + ndy * ny + ndz * nz;
    const float tdt = ox * nx + oy * ny + oz * nz - c0;
    const float udt =
        gx * e2x + gy * e2y + gz * e2z + dx * p2x + dy * p2y + dz * p2z;
    const float vdt =
        ngx * e1x + ngy * e1y + ngz * e1z + ndx * p1x + ndy * p1y + ndz * p1z;
    const float sgn = det < 0.0f ? -1.0f : 1.0f;
    const float ad = det * sgn;
    const float su = udt * sgn;
    const float sv = vdt * sgn;
    const float st = tdt * sgn;
    if (ad >= kDetEps && su >= 0.0f && sv >= 0.0f && su + sv <= ad &&
        st > 0.0f && st < maxt * ad) {
      const float t = st / ad;
      if (t < tmin) {  // strict: the first column among equal t
        tmin = t;
        col = j;
      }
    }
  }
  t_out[i] = tmin;
  col_out[i] = tmin < kInf ? col : -1;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int treelet_pair_test(const float* consts, const float* feats,
                                 const int* tid, float* t, int* col, int n,
                                 int n_treelets, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  pair_test_kernel<<<grid, kBlock, 0, stream>>>(consts, feats, tid, t, col,
                                                n, n_treelets);
  return static_cast<int>(cudaGetLastError());
}
