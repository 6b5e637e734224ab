// Brute-force Moller-Trumbore ray/triangle intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingrenderer_tpu/ops/mt_kernel.py::_kernel
// (Pallas, launched by intersect_pallas): every ray against every triangle,
// with a per-ray search radius t_init.  Closest-hit passes BIG_T, any-hit
// passes the segment length; a miss keeps t = t_init, tri = -1, u = v = 0.
// Ties go to the lowest triangle index (strict t < t_best, triangles walked
// in index order), as in the TPU kernel's fori_loop and closest_hit_brute's
// argmin.
//
// Design.  One thread per ray, 256 threads a block.  Triangle rows
// [p0 e1 e2] (9 floats) stream through shared memory in tiles of 512 rows
// (18 KB), loaded by the whole block between two __syncthreads(); every
// thread then reads the same row at the same time (a broadcast, no bank
// conflicts).  Tiling keeps the kernel under the 48 KB static shared-memory
// limit for any triangle count; the wrapper still refuses more than 4096
// triangles, the TPU kernel's cap.  The TPU kernel's (16, 128) VMEM ray
// blocks have no counterpart: a ray's state lives in registers.
//
// Bound.  FP32 arithmetic: about 30 flops and one IEEE division per (ray,
// triangle) pair, with every operand in registers or shared memory and
// 36 bytes of device memory traffic per ray.  Making it fast (early-out
// tests, precomputed triangle constants, several rays per thread) is later
// work; this version is the simple correct one.
//
// Arithmetic follows the TPU kernel (mt_kernel.py:73-92) operation by
// operation.  Build with --fmad=false: contracting a*b+c into an FMA would
// round differently from the plain torch version and flip hits on
// edge-grazing rays.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 512;
constexpr float kDetEps = 1e-12f;

__global__ void __launch_bounds__(kBlock)
mt_intersect_kernel(const float* __restrict__ rows, int n_tri,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t_init,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    int n) {
  __shared__ float tile[kTile * 9];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float rox = 0.f, roy = 0.f, roz = 0.f, rdx = 0.f, rdy = 1.f, rdz = 0.f;
  float t_b = -1.f;  // threads past the end never hit
  if (live) {
    rox = ox[i]; roy = oy[i]; roz = oz[i];
    rdx = dx[i]; rdy = dy[i]; rdz = dz[i];
    t_b = t_init[i];
  }
  int tri_b = -1;
  float u_b = 0.f, v_b = 0.f;

  for (int base = 0; base < n_tri; base += kTile) {
    const int count = min(kTile, n_tri - base);
    __syncthreads();  // the previous tile is consumed by every thread
    for (int j = threadIdx.x; j < count * 9; j += kBlock) {
      tile[j] = rows[base * 9 + j];
    }
    __syncthreads();
    for (int k = 0; k < count; ++k) {
      const float* r = tile + k * 9;
      const float p0x = r[0], p0y = r[1], p0z = r[2];
      const float e1x = r[3], e1y = r[4], e1z = r[5];
      const float e2x = r[6], e2y = r[7], e2z = r[8];
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
      // qvec = tvec x e1
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      if (ok && u >= 0.f && v >= 0.f && u + v <= 1.f && t > 0.f &&
          t < t_b) {
        t_b = t;
        tri_b = base + k;
        u_b = u;
        v_b = v;
      }
    }
  }
  if (live) {
    t_out[i] = t_b;
    tri_out[i] = tri_b;
    u_out[i] = u_b;
    v_out[i] = v_b;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mt_intersect(const float* rows, int n_tri, const float* ox,
                            const float* oy, const float* oz, const float* dx,
                            const float* dy, const float* dz,
                            const float* t_init, float* t, int* tri, float* u,
                            float* v, int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  mt_intersect_kernel<<<grid, kBlock, 0, stream>>>(
      rows, n_tri, ox, oy, oz, dx, dy, dz, t_init, t, tri, u, v, n);
  return static_cast<int>(cudaGetLastError());
}
