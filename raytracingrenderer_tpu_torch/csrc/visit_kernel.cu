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
// Design of the visit kernels.  The TPU grid ran one program per block of
// rays, in order on one core.  Here a thread block covers a span of 128
// rays of one block (grid R/128 x blocks: 256 thread blocks for the
// probes' 8 x 4096 rays, about two per SM) and walks every visit.  The
// visited tile (16 x TT f32: 8 KB at TT = 128, 32 KB at 512, 64 KB for
// the 8 tiles of a batched step) is staged in dynamic shared memory by
// the whole block, float4 by float4, between two barriers; the static
// variant stages it once.
//   ray layout (fp32, the counterpart of k_full): one thread per ray, its
//     16 features in registers.  A row of 4 columns of the tile is one
//     float4 that every thread of the warp reads at the same address (a
//     broadcast), so 4 columns cost 16 shared loads and 124 FP32
//     operations in 4 independent chains; the running min stays in a
//     register.
//   lane layout (fp32, the counterpart of k_rays_major): a warp takes 32
//     rays; lane l holds columns l, l+32, l+64, l+96 of the tile in
//     registers (64 values), reads each ray's features from shared memory
//     (a broadcast), and the min over the 128 columns is a 5-step butterfly
//     of warp shuffles per ray and visit: a reduction across lanes, as the
//     TPU variant's is.
//   TF32 (precision "default"): mma.sync.m16n8k8 with TF32 operands, two
//     k-steps for K = 16; what XLA does on a GPU for an f32 dot at DEFAULT
//     precision.  A warp takes 32 rays (4 n-tiles of 8).  The features
//     are rounded (cvt.rna.tf32.f32) into B fragments once; the tile is
//     rounded as it is staged, its rows padded to TT + 8 floats so that
//     the A-fragment loads of a warp fall in 32 distinct banks; per
//     16-triangle m-tile each lane folds its accumulator rows into a
//     running min, and the min across the 8 lanes of a fragment column is
//     taken once, after the last visit (a min is exact in any order).
// The fp32 kernels sum K left to right, every product and sum rounded,
// and min is exact, so they equal the plain version bit for bit in any
// layout.  The TF32 kernel differs from its plain version only in the
// tensor core's accumulation order and rounding (ops/visit.py,
// TF32_KERNEL_BOUND).
//
// Bound.  Every visit variant is bound by operations: per ray and visit
// 16 x TT multiply-adds on operands that stay on chip, while the device
// memory traffic (the features, the visited tiles, two rows of output) is
// under 3 MB at the probes' sizes.  Built with --fmad=false (as every
// source is, ops/build.py), a multiply-add is two FP32 instructions, so
// the fp32 variants can reach at most half of the 67 TFLOP/s FP32 peak;
// they keep that exactness for the bit-for-bit check.  The TF32 variant
// runs its multiply-adds on the tensor cores (495 TFLOP/s dense, through
// wgmma; mma.sync reaches less) and its min on the FP32 pipes.  wgmma,
// TMA and several rays a thread are later work.
//
// The dot kernel (P1b) writes the whole (TT, R) product, 2 MB for 17
// MFLOP, so bytes bound it: one thread per ray and 16 rows a block
// (fp32), or one warp per 16 x 32 tile of the output (TF32).
//
// The relayout kernel (P1c).  No relayout exists here: a torch tensor's
// shape is its strides, and a reshape of a contiguous (32, 128) block to
// (1, 4096) moves no data, where the TPU moves values between its (8, 128)
// register tiles.  What is left is n_iter additions of 1.0 per element,
// kept in a register, and its 2 MB of reads and writes bound it.  It is a
// trivial elementwise pass; it stays CUDA to keep one build per source.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kK = 16;        // feature rows: the contraction depth
constexpr int kSpan = 128;    // rays (and threads) of a thread block
constexpr int kRows = 8;      // rows of reduce "first8"
constexpr float kBig = 3.0e38f;
constexpr float kDetEps = 1e-12f;

enum TileMode { kDynamic, kStatic, kBatched8 };
enum Reduce { kMin, kFirst8, kMt };

// The first tile that visit (or batched step) i reads.
template <int kMode>
__device__ __forceinline__ int first_tile(int i, int n_tiles) {
  if (kMode == kStatic) return 0;
  if (kMode == kBatched8) return 8 * ((i * 7) % (n_tiles / 8));
  return (i * 7) % n_tiles;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Stage n_t consecutive tiles from `first` into s as one 16 x (n_t * tt)
// row-major matrix (tiles side by side) with a row stride of `stride`
// floats; with kRound, rounded to TF32.  Consecutive threads read
// consecutive float4s of the table and write consecutive float4s.
template <bool kRound>
__device__ __forceinline__ void stage(float* s, const float* __restrict__ tab,
                                      int first, int n_t, int tt,
                                      int stride) {
  const int q4 = tt / 4;
  const int total = n_t * kK * q4;
  const float4* src = reinterpret_cast<const float4*>(tab) +
                      static_cast<size_t>(first) * kK * q4;
  for (int e = threadIdx.x; e < total; e += kSpan) {
    const int t = e / (kK * q4);
    const int rem = e - t * kK * q4;
    const int row = rem / q4;
    const int j4 = rem - row * q4;
    float4 v = __ldg(src + e);
    if (kRound) {
      v.x = __uint_as_float(to_tf32(v.x));
      v.y = __uint_as_float(to_tf32(v.y));
      v.z = __uint_as_float(to_tf32(v.z));
      v.w = __uint_as_float(to_tf32(v.w));
    }
    *reinterpret_cast<float4*>(s + row * stride + t * tt + 4 * j4) = v;
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

// ---------------------------------------------------------------- ray layout
template <int kMode, int kReduce>
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
  constexpr int kNt = kMode == kBatched8 ? 8 : 1;
  constexpr int kAcc = kReduce == kFirst8 ? kRows : 1;
  const int width = kNt * tt;  // columns of one step
  const int steps = kMode == kBatched8 ? n_visits / 8 : n_visits;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = kBig;
  if (kMode == kStatic) {
    stage<false>(s, tab, 0, 1, tt, width);
    __syncthreads();
  }

  for (int i = 0; i < steps; ++i) {
    if (kMode != kStatic) {
      __syncthreads();  // every thread is done with the previous tile
      stage<false>(s, tab, first_tile<kMode>(i, n_tiles), kNt, tt, width);
      __syncthreads();
    }
    if (kReduce == kMin) {
      float m = acc[0];
      for (int c = 0; c < width; c += 4) {
        float4 a = ld4(s + c);
        float s0 = a.x * f[0], s1 = a.y * f[0], s2 = a.z * f[0],
              s3 = a.w * f[0];
#pragma unroll
        for (int k = 1; k < kK; ++k) {
          a = ld4(s + k * width + c);
          s0 = s0 + a.x * f[k];
          s1 = s1 + a.y * f[k];
          s2 = s2 + a.z * f[k];
          s3 = s3 + a.w * f[k];
        }
        m = fminf(m, fminf(fminf(s0, s1), fminf(s2, s3)));
      }
      acc[0] = m;
    } else if (kReduce == kFirst8) {
      // rows 0..7 of the product: the tile's first 8 columns
      float sum[kRows];
      float4 a = ld4(s), a2 = ld4(s + 4);
      sum[0] = a.x * f[0]; sum[1] = a.y * f[0]; sum[2] = a.z * f[0];
      sum[3] = a.w * f[0]; sum[4] = a2.x * f[0]; sum[5] = a2.y * f[0];
      sum[6] = a2.z * f[0]; sum[7] = a2.w * f[0];
#pragma unroll
      for (int k = 1; k < kK; ++k) {
        a = ld4(s + k * width);
        a2 = ld4(s + k * width + 4);
        sum[0] = sum[0] + a.x * f[k]; sum[1] = sum[1] + a.y * f[k];
        sum[2] = sum[2] + a.z * f[k]; sum[3] = sum[3] + a.w * f[k];
        sum[4] = sum[4] + a2.x * f[k]; sum[5] = sum[5] + a2.y * f[k];
        sum[6] = sum[6] + a2.z * f[k]; sum[7] = sum[7] + a2.w * f[k];
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = fminf(acc[j], sum[j]);
    } else {
      // the constant-form MT epilogue: columns [det | tdet | udet | vdet]
      // of q = width / 4 triangles, every one held to the ray's best t as
      // it stood before this visit
      const int q = width / 4;
      const float tb = acc[0];
      float m = acc[0];
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
            const float4 a = ld4(s + k * width + h * q + c);
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
constexpr int kLaneCols = kLaneTT / 32;

__global__ void __launch_bounds__(kSpan)
visit_lane_kernel(const float* __restrict__ tab,
                  const float* __restrict__ feats, float* __restrict__ t_out,
                  float* __restrict__ o_out, int r, int n_tiles,
                  int n_visits) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);       // the tile, 16 x 128
  __shared__ float4 sf[kSpan * kK / 4];             // features, ray-major
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kSpan;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  {
    float* sff = reinterpret_cast<float*>(sf);
    const float* fb = feats + static_cast<size_t>(b) * kK * r + r0;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      sff[threadIdx.x * kK + k] = fb[static_cast<size_t>(k) * r + threadIdx.x];
    }
  }
  float acc = kBig;  // of ray r0 + warp * 32 + lane
  for (int i = 0; i < n_visits; ++i) {
    __syncthreads();
    stage<false>(s, tab, (i * 7) % n_tiles, 1, kLaneTT, kLaneTT);
    __syncthreads();
    float a[kLaneCols][kK];
#pragma unroll
    for (int c = 0; c < kLaneCols; ++c) {
#pragma unroll
      for (int k = 0; k < kK; ++k) a[c][k] = s[k * kLaneTT + lane + 32 * c];
    }
    for (int j = 0; j < 32; ++j) {
      const float4* fr = sf + (warp * 32 + j) * (kK / 4);
      float f[kK];
#pragma unroll
      for (int k4 = 0; k4 < kK / 4; ++k4) {
        const float4 v = fr[k4];
        f[4 * k4] = v.x; f[4 * k4 + 1] = v.y;
        f[4 * k4 + 2] = v.z; f[4 * k4 + 3] = v.w;
      }
      float m = kBig;
#pragma unroll
      for (int c = 0; c < kLaneCols; ++c) {
        float sum = a[c][0] * f[0];
#pragma unroll
        for (int k = 1; k < kK; ++k) sum = sum + a[c][k] * f[k];
        m = fminf(m, sum);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (lane == j) acc = fminf(acc, m);
    }
  }
  const int ray = r0 + warp * 32 + lane;
  t_out[static_cast<size_t>(b) * r + ray] = acc;
  write_feature_sum(feats, o_out, b, r, ray);
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
    stage<true>(s, tab, (i * 7) % n_tiles, 1, tt, stride);
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
// fp32: one thread per ray (column of b), 16 rows of the output a block.
__global__ void __launch_bounds__(kSpan)
dot_fp32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int tt, int r) {
  const int ray = blockIdx.x * kSpan + threadIdx.x;
  const int m0 = blockIdx.y * 16;
  float f[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) f[k] = b[static_cast<size_t>(k) * r + ray];
#pragma unroll 4
  for (int j = 0; j < 16; ++j) {
    float sum = __ldg(a + m0 + j) * f[0];
#pragma unroll
    for (int k = 1; k < kK; ++k) sum = sum + __ldg(a + k * tt + m0 + j) * f[k];
    out[static_cast<size_t>(m0 + j) * r + ray] = sum;
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

}  // namespace

// The visit kernel of variant `variant` (ops/visit.py, VARIANTS order) over
// tab (n_tiles * 16, tt) and feats (blocks * 16, r); writes t (blocks, 8, r)
// for reduce "first8", else (blocks, 1, r), and o (blocks, 1, r).  The
// caller guarantees r % 128 == 0, tt % 32 == 0 (tt == 128 for the lane
// layout) and n_tiles >= 8 for the batched variant.  Launches on `stream`
// and returns the CUDA error (0 = launched).
extern "C" int visit_run(int variant, const float* tab, const float* feats,
                         float* t, float* o, int blocks, int r, int tt,
                         int n_tiles, int n_visits, cudaStream_t stream) {
  if (blocks <= 0 || r <= 0) return 0;
  const dim3 grid(r / kSpan, blocks);
  const int tile = kK * tt * 4;
  switch (variant) {
    case 0:
      return launch(visit_ray_kernel<kDynamic, kMin>, grid, kSpan, tile,
                    stream, tab, feats, t, o, r, tt, n_tiles, n_visits);
    case 1:
      return launch(visit_tf32_kernel, grid, kSpan, kK * (tt + 8) * 4, stream,
                    tab, feats, t, o, r, tt, n_tiles, n_visits);
    case 2:
      return launch(visit_ray_kernel<kDynamic, kMt>, grid, kSpan, tile,
                    stream, tab, feats, t, o, r, tt, n_tiles, n_visits);
    case 3:
      return launch(visit_ray_kernel<kStatic, kMin>, grid, kSpan, tile,
                    stream, tab, feats, t, o, r, tt, n_tiles, n_visits);
    case 4:
      return launch(visit_ray_kernel<kDynamic, kFirst8>, grid, kSpan, tile,
                    stream, tab, feats, t, o, r, tt, n_tiles, n_visits);
    case 5:
      return launch(visit_lane_kernel, grid, kSpan, tile, stream, tab, feats,
                    t, o, r, n_tiles, n_visits);
    case 6:
      return launch(visit_ray_kernel<kBatched8, kMin>, grid, kSpan, 8 * tile,
                    stream, tab, feats, t, o, r, tt, n_tiles, n_visits);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out (tt, r) = a^T b for a (16, tt), b (16, r), in fp32 (tf32 = 0) or
// TF32 (tf32 = 1); tt % 16 == 0, r % 128 == 0.
extern "C" int visit_dot(int tf32, const float* a, const float* b, float* out,
                         int tt, int r, cudaStream_t stream) {
  if (tt <= 0 || r <= 0) return 0;
  const dim3 grid(r / kSpan, tt / 16);
  return launch(tf32 ? dot_tf32_kernel : dot_fp32_kernel, grid, kSpan, 0,
                stream, a, b, out, tt, r);
}

// out = x + 1.0 added n_iter times, element by element, over n floats.
extern "C" int visit_relayout(const float* x, float* out, int n, int n_iter,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = (n + kRelayoutBlock - 1) / kRelayoutBlock;
  return launch(relayout_kernel, dim3(grid), kRelayoutBlock, 0, stream, x,
                out, n, n_iter);
}
