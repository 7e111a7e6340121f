// Shared device helpers of the fused linear-attention kernels
// (linear_attention_fwd.cuh, linear_attention_bwd.cu): the block shape, the
// reductions in a fixed order inside a CTA and across a thread-block cluster
// (through distributed shared memory), and the tile products.
//
// The products.  For T = __nv_bfloat16 they run on the tensor cores,
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators; for T = float
// they are exact fp32 FMAs on the CUDA cores (TF32 would break the fp32
// tolerance), in the same structure.  Two forms cover every product:
//   * product_nt: D[r][j] = sum_k A[r][k] * Bt[j][k] over a 64-row tile of A.
//     Both operands are stored with k contiguous, so an mma fragment is a
//     plain 32-bit load; shared-memory rows carry 16 bytes of padding, which
//     spreads the eight rows of a fragment over all banks.  The weights come
//     in T from the host side in both orientations, so no product needs a
//     transposed read of a weight.
//   * tn_accumulate: acc += Sa^T Sb over the rows of a tile (the products
//     whose sum runs over an item's rows: ctx = k^T v, dcw = qn^T do,
//     dWqkv = h^T d[qkv]); both operands are stored with the summed index as
//     the row, and ldmatrix.trans turns them into fragments.
// Every sum runs in an order fixed by the shape, so reruns are bit-identical.
// The mma and ldmatrix instructions themselves are in mma.cuh, shared with
// the ResNet-block kernels.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "numeric.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;       // threads per CTA
constexpr int TILE_R = 64;    // rows per tile
constexpr int HIDDEN = 128;   // heads * dim_head
constexpr int DH = 32;        // dim_head
constexpr int QKV = 3 * HIDDEN;
constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA can take
constexpr float NEG_INF = -3.402823466e38f;

// Padding of a shared-memory row, in elements of T: 16 bytes.
template <typename T> constexpr int PAD = 16 / (int)sizeof(T);
template <typename T> constexpr bool IS_BF16 = std::is_same<T, __nv_bfloat16>::value;

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

// Barrier over the cluster (or the CTA when the cluster is one CTA); orders
// shared-memory writes before the peers' reads.
__device__ __forceinline__ void cluster_barrier(int cs) {
  if (cs > 1) cg::this_cluster().sync();
  else __syncthreads();
}

// Sum of one value per thread over the whole cluster: the CTA's sum goes to
// `slot` (a float at the same shared-memory offset in every CTA, used by one
// call only), and every CTA adds the slots in rank order.  The peers' values
// are loaded together, then added: a remote load is slow, eight in a row
// slower.
__device__ float cluster_sum(float v, float* red, float* slot, int cs) {
  const float s = block_sum(v, red);
  if (cs == 1) return s;
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) *slot = s;
  cl.sync();
  float part[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) part[r] = r < cs ? *cl.map_shared_rank(slot, r) : 0.f;
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    if (r < cs) t += part[r];
  return t;
}

// dst[i] = the sum (or max) over the cluster's CTAs, in rank order, of
// part[i], i < n.  `part` sits at the same offset in every CTA and must stay
// untouched until the next cluster barrier; dst is local.
template <bool MAX>
__device__ void cluster_reduce(float* part, float* dst, int n, int cs) {
  cluster_barrier(cs);
  if (cs == 1) {
    for (int i = threadIdx.x; i < n; i += NT) dst[i] = part[i];
  } else {
    cg::cluster_group cl = cg::this_cluster();
    for (int i = threadIdx.x; i < n; i += NT) {
      float v[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        v[r] = r < cs ? cl.map_shared_rank(part, r)[i] : (MAX ? NEG_INF : 0.f);
      float a = v[0];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r)
        if (r < cs) a = MAX ? fmaxf(a, v[r]) : a + v[r];
      dst[i] = a;
    }
  }
  __syncthreads();
}

// The sum over the cluster's CTAs, in rank order, of 4 floats at part + i
// (16-byte aligned; `part` at the same offset in every CTA).
__device__ __forceinline__ float4 cluster_sum4(float* part, int i, int cs) {
  if (cs == 1) return *reinterpret_cast<const float4*>(part + i);
  cg::cluster_group cl = cg::this_cluster();
  float4 v[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    v[r] = r < cs ? *reinterpret_cast<const float4*>(cl.map_shared_rank(part, r) + i)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 t = v[0];
#pragma unroll
  for (int r = 1; r < MAX_CLUSTER; ++r)
    if (r < cs) {
      t.x += v[r].x; t.y += v[r].y; t.z += v[r].z; t.w += v[r].w;
    }
  return t;
}

// ---- 2- and 4-element accesses in T (4 / 8 bytes in bf16, 8 / 16 in fp32);
// the addresses are aligned to the access by the callers' strides.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a = t.x; b = t.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = t.x; b = t.y;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Copy `rows` rows of `cols` elements from src (row stride lds) to dst (row
// stride ldd), 16 bytes a thread: cols and both strides are multiples of
// 16 bytes, both bases 16-byte aligned.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ldd, const T* src, int lds, int rows,
                                          int cols) {
  constexpr int E = 16 / (int)sizeof(T);
  const int cq = cols / E;
  for (int i = threadIdx.x; i < rows * cq; i += NT) {
    const int r = i / cq, c = (i % cq) * E;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + c);
  }
}

// One head's 32 lanes of a row, as fp32, and back.
template <typename T>
__device__ __forceinline__ void load_head(const T* p, float (&v)[DH / 4][4]) {
#pragma unroll
  for (int u = 0; u < DH / 4; ++u) load4(p + 4 * u, v[u]);
}
template <typename T>
__device__ __forceinline__ void store_head(T* p, const float (&v)[DH / 4][4]) {
#pragma unroll
  for (int u = 0; u < DH / 4; ++u) store4(p + 4 * u, v[u]);
}

// q softmax of the rows n0 .. n0 + rv (rv <= TILE_R) of q (row stride ldq),
// per head over its 32 lanes, shifted by the row max over all 128 lanes,
// times `scale`, written to dst (row stride ldd; may be q itself).  Thread t
// owns row t / 4 and head t % 4 whole, so the only exchange is the row max
// among four neighbouring lanes; sums run over the lanes in order.
template <typename T>
__device__ __forceinline__ void q_softmax_rows(const T* q, int ldq, int n0, int rv, T* dst,
                                               int ldd, float scale) {
  static_assert(NT == TILE_R * 4, "one thread a (row, head) of a tile");
  const int r = threadIdx.x >> 2, hh = threadIdx.x & 3;
  float v[DH / 4][4];
  float m = NEG_INF;
  if (r < rv) {
    load_head(q + (size_t)(n0 + r) * ldq + hh * DH, v);
#pragma unroll
    for (int u = 0; u < DH / 4; ++u)
      m = fmaxf(m, fmaxf(fmaxf(v[u][0], v[u][1]), fmaxf(v[u][2], v[u][3])));
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  if (r < rv) {
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < DH / 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[u][i] = rnd<T>(expf(rnd<T>(v[u][i] - m)));
        sum += v[u][i];
      }
#pragma unroll
    for (int u = 0; u < DH / 4; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[u][i] = v[u][i] / sum * scale;
    store_head(dst + (size_t)r * ldd + hh * DH, v);
  }
}

// The bf16 form of product_nt (below).  A warp owns the column tiles w,
// w + 8 (of 8 columns) of each group of 16 and walks the tile's four 16-row
// blocks, so a B fragment is loaded once per CTA and feeds four mma.  No
// branch inside the k loop: all four 16-row blocks are multiplied whatever
// rows_valid is (rows past the valid ones hold stale values and their sums
// are dropped), and a missing second column tile repeats the first.  So the
// loads of one step go out together and the next step's B is on its way
// meanwhile.  AS / BS: the operand lies in shared memory (16-byte aligned
// rows) and is read with ldmatrix, one instruction for a whole 16x16 block of
// A or for both column tiles' B; else with one 32-bit load a register, from
// shared or global memory alike.  A is read as a 64-row tile (a tile in
// shared memory has its 64 rows); without AS and with HEAD the rows past the
// last valid one read that one instead, so A may then be a global matrix of
// rows_valid rows.  MB: the 16-row blocks multiplied (4, a whole tile; fewer
// where the caller knows rows_valid <= 16 MB).  `warp`: the warp's index
// among the 8 that share the product.
template <bool HEAD, bool AS, bool BS, int MB, typename Epi>
__device__ __forceinline__ void product_nt_mma(int warp, const __nv_bfloat16* A, int lda,
                                               const __nv_bfloat16* Bt, int ldb, int K,
                                               int ncols, int rows_valid, Epi epi) {
  using T = __nv_bfloat16;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q = lane >> 3, rr = lane & 7;  // ldmatrix: matrix and row of this lane's address
  const int ntiles = ncols >> 3;
  constexpr int NA = HEAD ? 2 : 1;  // with HEAD each column tile has its own lanes of A
  for (int nt0 = warp; nt0 < ntiles; nt0 += 16) {
    const bool two = nt0 + 8 < ntiles;
    const int n0 = nt0 * 8, n1 = two ? n0 + 64 : n0;
    float acc[MB][2][4];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][h][i] = 0.f;
    int ak[NA];
    ak[0] = HEAD ? (n0 / DH) * DH : 0;
    if constexpr (HEAD) ak[1] = (n1 / DH) * DH;
    // B: with ldmatrix one address a lane (matrix q: column tile q / 2, k half
    // q % 2); else two row pointers
    const T* bm = Bt + (size_t)((q >> 1 ? n1 : n0) + rr) * ldb + (q & 1) * 8;
    const T* b0p = Bt + (size_t)(n0 + g) * ldb + 2 * tig;
    const T* b1p = Bt + (size_t)(n1 + g) * ldb + 2 * tig;
    auto load_b = [&](int k0, uint32_t (&b)[4]) {
      if constexpr (BS) {
        ldmatrix_x4(b, bm + k0);
      } else {
        b[0] = ld32(b0p + k0);
        b[1] = ld32(b0p + k0 + 8);
        b[2] = ld32(b1p + k0);
        b[3] = ld32(b1p + k0 + 8);
      }
    };
    // A: with ldmatrix matrix q is rows (q % 2) * 8 .., k half q / 2
    const T* am = A + (size_t)((q & 1) * 8 + rr) * lda + (q >> 1) * 8;
    int ra[MB], rb[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      ra[m] = HEAD ? min(m * 16 + g, rows_valid - 1) : m * 16 + g;
      rb[m] = HEAD ? min(m * 16 + g + 8, rows_valid - 1) : m * 16 + g + 8;
    }
    uint32_t b[4];
    load_b(0, b);
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t bn[4];
      load_b(k0 + 16 < K ? k0 + 16 : k0, bn);  // the last step reloads its own
      uint32_t a[NA][MB][4];
#pragma unroll
      for (int s = 0; s < NA; ++s)
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          if constexpr (AS) {
            ldmatrix_x4(a[s][m], am + (size_t)(m * 16) * lda + k0 + ak[s]);
          } else {
            const T* ar0 = A + (size_t)ra[m] * lda + k0 + ak[s] + 2 * tig;
            const T* ar1 = A + (size_t)rb[m] * lda + k0 + ak[s] + 2 * tig;
            a[s][m][0] = ld32(ar0);
            a[s][m][1] = ld32(ar1);
            a[s][m][2] = ld32(ar0 + 8);
            a[s][m][3] = ld32(ar1 + 8);
          }
        }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        mma_bf16(acc[m][0], a[0][m], b[0], b[1]);
        mma_bf16(acc[m][1], a[NA - 1][m], b[2], b[3]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) b[i] = bn[i];
    }
#pragma unroll
    for (int m = 0; m < MB; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 0 || two) {
          const int j = (nt0 + 8 * h) * 8 + 2 * tig;
          const int r = m * 16 + g;
          if (r < rows_valid) epi(r, j, acc[m][h][0], acc[m][h][1]);
          if (r + 8 < rows_valid) epi(r + 8, j, acc[m][h][2], acc[m][h][3]);
        }
      }
    }
  }
}

// D[r][j] = sum_{k < K} A[r][ak + k] * Bt[j][k] for the rows r < rows_valid
// (at most TILE_R) of one tile and the columns j < ncols; ak = 0, or with
// HEAD the first lane of column j's head, (j / DH) * DH (the block-diagonal
// products: K = DH and each head's columns meet only its own 32 lanes of A).
// A and Bt hold T with k contiguous (row strides lda, ldb; 16-byte aligned
// rows where they lie in shared memory); K is a multiple of 16, ncols of 8.
// epi(r, j, v0, v1) takes the fp32 sums of columns j and j + 1 (j even).  No
// barrier inside: the caller brackets it.
//
// bf16: product_nt_mma, by where the operands lie (the same pointer may be a
// shared-memory buffer or global scratch, as the launch plan has it).  fp32:
// a thread owns 4 rows x 2 columns and reads both operands as float4.
template <typename T, bool HEAD, typename Epi>
__device__ __forceinline__ void product_nt(const T* A, int lda, const T* Bt, int ldb, int K,
                                           int ncols, int rows_valid, Epi epi) {
  if constexpr (IS_BF16<T>) {
    const int warp = threadIdx.x >> 5;
    const bool as = __isShared(A), bs = __isShared(Bt);
    if (as && bs)
      product_nt_mma<HEAD, true, true, 4>(warp, A, lda, Bt, ldb, K, ncols, rows_valid, epi);
    else if (as)
      product_nt_mma<HEAD, true, false, 4>(warp, A, lda, Bt, ldb, K, ncols, rows_valid, epi);
    else
      product_nt_mma<HEAD, false, false, 4>(warp, A, lda, Bt, ldb, K, ncols, rows_valid, epi);
  } else {
    const int cp = ncols >> 1;
    for (int w = threadIdx.x; w < (TILE_R / 4) * cp; w += NT) {
      const int j = (w % cp) * 2, r0 = (w / cp) * 4;
      if (r0 >= rows_valid) break;  // r0 grows with w
      const int ak = HEAD ? (j / DH) * DH : 0;
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
      const T* b0p = Bt + (size_t)j * ldb;
      const T* b1p = b0p + ldb;
      const T* ap = A + (size_t)r0 * lda + ak;
      for (int k = 0; k < K; k += 4) {
        const float4 p = *reinterpret_cast<const float4*>(b0p + k);
        const float4 q = *reinterpret_cast<const float4*>(b1p + k);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(ap + (size_t)i * lda + k);
          acc[i][0] = fmaf(a.x, p.x, acc[i][0]);
          acc[i][0] = fmaf(a.y, p.y, acc[i][0]);
          acc[i][0] = fmaf(a.z, p.z, acc[i][0]);
          acc[i][0] = fmaf(a.w, p.w, acc[i][0]);
          acc[i][1] = fmaf(a.x, q.x, acc[i][1]);
          acc[i][1] = fmaf(a.y, q.y, acc[i][1]);
          acc[i][1] = fmaf(a.z, q.z, acc[i][1]);
          acc[i][1] = fmaf(a.w, q.w, acc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < rows_valid) epi(r0 + i, j, acc[i][0], acc[i][1]);
    }
  }
}

// acc[ni] += sum_{k < krows} Sa[k][m0 + ..16] * Sb[k][n0 + 8 ni + ..8], bf16
// in shared memory with the summed index k as the row (strides lda, ldb;
// rows 16-byte aligned), krows a multiple of 16 (the caller zeroes the rows
// past the valid ones).  NI is even.  acc[ni][0..3] are the mma's fp32
// outputs: rows m0 + g and m0 + g + 8, columns n0 + 8 ni + 2 tig, + 1, with
// g = lane / 4 and tig = lane % 4.
template <int NI>
__device__ __forceinline__ void tn_accumulate(float (&acc)[NI][4], const __nv_bfloat16* Sa,
                                              int lda, int m0, const __nv_bfloat16* Sb, int ldb,
                                              int n0, int krows) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3, rr = lane & 7;
  for (int k0 = 0; k0 < krows; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4_trans(a, Sa + (size_t)(k0 + (q >> 1) * 8 + rr) * lda + m0 + (q & 1) * 8);
#pragma unroll
    for (int ni = 0; ni < NI; ni += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Sb + (size_t)(k0 + (q & 1) * 8 + rr) * ldb + n0 + ni * 8 + (q >> 1) * 8);
      mma_bf16(acc[ni], a, b[0], b[1]);
      mma_bf16(acc[ni + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace
