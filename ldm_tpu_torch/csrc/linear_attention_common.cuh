// Shared device helpers of the fused linear-attention kernels
// (linear_attention_fwd.cu, linear_attention_bwd.cu): the block shape, the
// CTA reduction in a fixed order and the register-tiled row-tile matmul.
#pragma once

#include "numeric.cuh"

namespace {

constexpr int NT = 256;       // threads per CTA
constexpr int TILE_R = 64;    // rows per tile
constexpr int CPT = 4;        // columns per thread in a tile matmul
constexpr int HIDDEN = 128;   // heads * dim_head
constexpr int DH = 32;        // dim_head
constexpr int QKV = 3 * HIDDEN;

// Sum of one value per thread over the CTA, in a fixed order; every thread
// gets the same result.  `red` holds NT/32 floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) s += red[i];
  return s;
}

// Four consecutive values of a row of B, rounded to T (16 or 8 bytes,
// aligned: the wrapper checks every pointer, row strides are multiples of 4).
template <typename T>
__device__ __forceinline__ void load4(const float* p, float (&v)[CPT]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = rnd<T>(t.x); v[1] = rnd<T>(t.y); v[2] = rnd<T>(t.z); v[3] = rnd<T>(t.w);
}
template <typename T>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[CPT]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// out[r][j] = sum_k A[r][k] * T(B[k][j]) for the rows < rows_valid of one
// tile; A is fp32 in shared memory (row stride lda; K and lda multiples of
// 4), B is row-major in global memory (row stride ldb; ncols a multiple of
// 4).  Each work item is an RPT x CPT block of the output, held in
// registers: per 4 steps of k it loads 4 rows of 4 values of B and RPT
// float4s of A (one address per warp, a broadcast) for 16*RPT FMAs.
// epi(r, j, acc) consumes each fp32 sum; k runs in order, so every sum is
// taken in the same order on every run.
template <int RPT, typename T, typename TB, typename Epi>
__device__ __forceinline__ void tile_matmul(const float* A, int lda, int K,
                                            const TB* __restrict__ B, int ldb,
                                            int ncols, int rows_valid, Epi epi) {
  const int col_groups = ncols / CPT;
  const int n_items = (TILE_R / RPT) * col_groups;
  for (int w = threadIdx.x; w < n_items; w += NT) {
    const int j0 = (w % col_groups) * CPT;
    const int r0 = (w / col_groups) * RPT;
    if (r0 >= rows_valid) continue;
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float b[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u) load4<T>(B + (size_t)(k + u) * ldb + j0, b[u]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc[i][c] = fmaf(a.x, b[0][c], acc[i][c]);
          acc[i][c] = fmaf(a.y, b[1][c], acc[i][c]);
          acc[i][c] = fmaf(a.z, b[2][c], acc[i][c]);
          acc[i][c] = fmaf(a.w, b[3][c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (r0 + i < rows_valid)
#pragma unroll
        for (int c = 0; c < CPT; ++c) epi(r0 + i, j0 + c, acc[i][c]);
  }
}

}  // namespace
