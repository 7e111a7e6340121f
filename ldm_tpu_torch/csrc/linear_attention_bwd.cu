// Fused linear-attention block backward for Hopper (sm_90a), CUDA C++.
//
// Replaces the two TPU backward kernels of ldm_tpu/ops/linear_attention.py:
//   * _fused_kernel_bwd         (the unpacked form, C != 64 sites), and
//   * _fused_kernel_packed_bwd  (the pixel-pair packed form, C == 64 sites;
//     the packing and its wrapper's fold only dodged the TPU's (8, 128) tile
//     padding, so one kernel serves every C).
// It computes what linear_attention_block_bwd_torch computes: per item b, the
// forward recomputed from x (GN1 -> q, k, v -> q softmax per head, k softmax
// over N -> ctx = kn^T v on the four diagonal 32x32 blocks -> cw = ctx Wout
// -> o = qn cw + bout -> GN2), then the chain back to dx and the 7 parameter
// grads.  T (float or bf16) is the compute type and the type of x, dy, dx and
// the weights handed in (cast once per weight version on the host side, in
// both orientations); every value the plain version rounds to T is rounded
// to T at the same point, sums are fp32, norm vectors and the bias fp32.
//
// What bounds it: bytes (x and dy in, dx out; about three times the
// forward's operations, still far below the tensor cores' rate for those
// bytes).  What stands in the way is the serial chain: nine reductions over
// all N rows of an item (GN1 statistics, k's max and sum, ctx, GN2
// statistics, GN2's two backward means, dcw, the k-softmax column sums of
// kn*dkn, GN1's two backward means) sit between the products.  The design:
//   * the TPU kernel added the weight grads of all items in place across its
//     grid, race-free only because a TPU grid runs in order.  Here CTAs run
//     at once, and no atomics are used, so the sums keep a fixed order and
//     two runs give bit-identical grads.  Three launches:
//       1. lin_attn_bwd_item_kernel, a thread-block cluster an item (`cs`
//          CTAs of N / cs rows, cs from (N, C) alone), writes dx, the
//          item's dWout (128 x C), five partial C-vectors a CTA (dbout,
//          dg1s, dg1b, dg2s, dg2b), and d[q k v] (N, 384) in T;
//       2. lin_attn_bwd_wqkv_kernel computes dWqkv = h^T d[q k v] over all
//          B*N rows: each CTA owns a 64 x 64 tile of the (C, 384) output and
//          one of S fixed row ranges (split-K, S from the shape alone), h
//          recomputed from x and the item's GN1 stats;
//       3. lin_attn_bwd_finalize_kernel sums the S dWqkv partials, the B
//          dWout and the B * cs vector partials, each in index order (so
//          across a cluster in rank order, then across items).
//   * the cluster's reductions go through distributed shared memory: a
//     CTA's partial in its own shared memory, a cluster barrier, every CTA
//     adds the partials in rank order.  The one large partial, dcw
//     (128 x C fp32), goes through a global scratch instead, under the same
//     barrier.
//   * kept on chip (`keep`): the CTA's rows of qn, kn, v ((rows, 384) in T;
//     96 KB for 128 rows in bf16), which six of the passes read, and
//     (`keep_cw`) cw, its transpose and dcw.  Not kept, because 227 KB do
//     not hold them beside that: do (rows x C in T) and o / dh (rows x C
//     fp32) go through global scratch, written and read back by the same
//     CTA (L2 hits at these sizes); d[q k v] goes to device memory in any
//     case, launch 2 reads it.  dkn (32 multiply-adds an entry) is
//     recomputed in the two passes that need it rather than stored.  Where
//     qn, kn, v do not fit (N = 4096; fp32 at N = 1024) they too go through
//     global scratch: the same code, other addresses.
//   * the products run on the tensor cores in bf16
//     (linear_attention_common.cuh): the recompute's h @ Wqkv, kn^T v,
//     ctx @ Wout and qn @ cw, then do @ cw^T, qn^T do, dcw @ Wout^T,
//     v @ dctx^T, kn @ dctx, d[qkv] @ Wqkv^T and, in launch 2, h^T d[qkv].
//     The item's dWout = ctx^T dcw (32 multiply-adds an entry, once an item)
//     stays on the CUDA cores, split over the cluster's CTAs by rows.
//   * as in the forward, one CTA of 8 warps has an SM to itself, so its time
//     is the sum of its latencies: the per-channel sums load eight rows of
//     dy and o (L2 round trips) before they use one; the q softmax and dq
//     give a thread a whole (row, head); remote partials are loaded
//     together, then added.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "linear_attention_common.cuh"

namespace {

constexpr int MAX_C = 512;             // widest C: the 64 x C tile beside the fp32 dqn tile
constexpr int KC = MAX_C / NT;         // channels per thread when C > NT
constexpr int MAX_DEVICES = 64;
constexpr int WT = 64;                 // dWqkv output tile: WT x WT
constexpr int WT_R = 64;               // rows per step of the dWqkv walk
constexpr int TARGET_CTAS = 264;       // dWqkv CTAs to aim for: 2 per SM
constexpr int MIN_SPLIT_ROWS = 256;    // fewest rows one dWqkv CTA walks
constexpr int LDQN = HIDDEN + 4;       // row stride of the fp32 dqn tile
constexpr float SCALE = 0.17677669529663688f;  // dim_head ** -0.5

// Where the item kernel's buffers are; made by the host side (plan_bwd in
// ops/linear_attention.py), byte offsets into dynamic shared memory.
struct BwdPlan {
  int cs;         // CTAs in the cluster of one item
  int rows;       // rows of the item a CTA owns: N / cs
  int keep;       // qn | kn | v of the CTA's rows in shared memory (else global)
  int keep_cw;    // cw, cw^T (and dcw over cw) in shared memory (else global)
  int off_tile;   // 64-row tiles; also the partial ctx blocks
  int off_ctxn;   // ctx, (128, 32 + pad) in T
  int off_dctx;   // dctx, likewise
  int off_dctxt;  // dctx with each head block transposed
  int off_vec;    // kmax_p | kmax | ksum_p | ksum | inner_p | inner | sred | red | slots
  int off_cw;     // cw (128, C + pad), later dcw
  int off_cwt;    // cw^T (C, 128 + pad)
  int off_qkv;    // qn | kn | v, (rows, 384 + pad)
};

// h = GN1(x) in T, as the forward's pass 2 computes it.
template <typename T>
__device__ __forceinline__ float gn1_h(float xv, float mean, float rstd, float s, float b) {
  return rnd<T>((xv - mean) * rstd * s + b);
}

// Per-channel sums over the CTA's R rows, in a fixed order.  Element (n, c)
// is read from pa (in T) and pb (fp32), both (R, C) row-major in global
// memory; f(a, b, c, acc) adds its NQ terms into acc[0..NQ); out[q * C + c]
// receives the sums.  Channels go to threads (row groups of C threads when
// C <= NT, summed in group order through `sred`, NT floats).  f may also
// add to per-thread sums of its own: every element is visited once, in row
// order.  Eight rows are loaded before any is used: a load here is an L2
// round trip, and one a row in turn was most of the time.
template <int NQ, typename T, typename F>
__device__ void column_sums(int R, int C, float* sred, float* __restrict__ out,
                            const T* __restrict__ pa, const float* __restrict__ pb, F f) {
  constexpr int U = 8;
  const int tid = threadIdx.x;
  const int rg = C <= NT ? NT / C : 1;
  const int active = C <= NT ? rg * C : NT;
  float acc[KC][NQ];
#pragma unroll
  for (int k = 0; k < KC; ++k)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[k][q] = 0.f;
  if (tid < active) {
    const int g = C <= NT ? tid / C : 0;
    const int c0 = C <= NT ? tid % C : tid;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = c0 + k * NT;
      if (c < C) {
        int n = g;
        for (; n + (U - 1) * rg < R; n += U * rg) {
          float av[U], bv[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const size_t i = (size_t)(n + u * rg) * C + c;
            av[u] = to_f(pa[i]);
            bv[u] = pb[i];
          }
#pragma unroll
          for (int u = 0; u < U; ++u) f(av[u], bv[u], c, acc[k]);
        }
        for (; n < R; n += rg) {
          const size_t i = (size_t)n * C + c;
          f(to_f(pa[i]), pb[i], c, acc[k]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if (C <= NT) {
      __syncthreads();  // sred may still be read by the previous q
      if (tid < active) sred[tid] = acc[0][q];
      __syncthreads();
      if (tid < C) {
        float s = 0.f;
        for (int g = 0; g < rg; ++g) s += sred[g * C + tid];
        out[q * C + tid] = s;
      }
    } else {
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (tid + k * NT < C) out[q * C + tid + k * NT] = acc[k][q];
    }
  }
}

// Rows e_begin .. e_begin + e_count of the item's dWout = ctx^T @ dcw on the
// head blocks, fp32: pw[e][c] = sum_i ctx[d0 + i][e % 32] * dcw[d0 + i][c]
// over the 32 rows of e's head.  A work item is a column c and E rows e of
// one head: each entry of dcw (read coalesced over c; global where cw is
// not kept) meets E entries of ctx out of shared memory, so dcw is read
// 32 / E times in all.  E = 16 where that still gives every thread an item,
// else 4.
template <typename T, int E>
__device__ __forceinline__ void dwout_rows(const T* ctxn, int lc, const T* dcw, int ldc,
                                           float* __restrict__ pw, int C, int e_begin,
                                           int e_count) {
  for (int w = threadIdx.x; w < (e_count / E) * C; w += NT) {
    const int c = w % C, e0 = e_begin + (w / C) * E;
    const int d0 = (e0 / DH) * DH, el = e0 % DH;
    float acc[E];
#pragma unroll
    for (int u = 0; u < E; ++u) acc[u] = 0.f;
#pragma unroll 8
    for (int i = 0; i < DH; ++i) {
      const float d = to_f(dcw[(size_t)(d0 + i) * ldc + c]);
      float cx[E / 4][4];
#pragma unroll
      for (int u = 0; u < E / 4; ++u) load4(ctxn + (d0 + i) * lc + el + 4 * u, cx[u]);
#pragma unroll
      for (int u = 0; u < E; ++u) acc[u] = fmaf(cx[u / 4][u % 4], d, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < E; ++u) pw[(size_t)(e0 + u) * C + c] = acc[u];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
lin_attn_bwd_item_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const T* __restrict__ wqkv, const T* __restrict__ wqkv_t,
                         const T* __restrict__ wout, const T* __restrict__ wout_t,
                         const float* __restrict__ bout, const float* __restrict__ g1s,
                         const float* __restrict__ g1b, const float* __restrict__ g2s,
                         T* __restrict__ dx, T* __restrict__ qkv_s, T* __restrict__ dqkv_s,
                         float* __restrict__ o_s, T* __restrict__ do_s, T* __restrict__ cw_s,
                         T* __restrict__ cwt_s, float* __restrict__ stats,
                         float* __restrict__ pvec, float* __restrict__ pwout,
                         float* __restrict__ pdcw, int N, int C, int Ct, float eps,
                         BwdPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = PAD<T>;
  constexpr int LT = HIDDEN + P;   // row stride of a 128-wide tile
  constexpr int LC = DH + P;       // row stride of ctx, dctx
  constexpr int LQ = QKV + P;      // row stride of a 384-wide tile
  T* tile = reinterpret_cast<T*>(smem_raw + p.off_tile);
  float* ctx_p = reinterpret_cast<float*>(smem_raw + p.off_tile);  // 128 x 32 partial ctx
  T* ctxn = reinterpret_cast<T*>(smem_raw + p.off_ctxn);
  T* dctx = reinterpret_cast<T*>(smem_raw + p.off_dctx);
  T* dctxt = reinterpret_cast<T*>(smem_raw + p.off_dctxt);
  float* vec = reinterpret_cast<float*>(smem_raw + p.off_vec);
  float* kmax_p = vec;
  float* kmax = vec + HIDDEN;
  float* ksum_p = vec + 2 * HIDDEN;
  float* ksum = vec + 3 * HIDDEN;
  float* inner_p = vec + 4 * HIDDEN;
  float* inner = vec + 5 * HIDDEN;
  float* sred = vec + 6 * HIDDEN;       // NT
  float* red = sred + NT;               // NT / 32
  float* slots = red + NT / 32;         // one float a cluster_sum call

  const int cs = p.cs, R = p.rows;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)b * N + (size_t)rank * R;  // the CTA's first row
  const T* xg = x + row0 * C;
  const T* dyg = dy + row0 * C;
  T* dxg = dx + row0 * C;
  const int ldq = p.keep ? LQ : QKV;
  T* qkv = p.keep ? reinterpret_cast<T*>(smem_raw + p.off_qkv) : qkv_s + row0 * QKV;
  T* dqkv = dqkv_s + row0 * QKV;
  float* ob = o_s + row0 * C;
  T* dob = do_s + row0 * C;
  const int ldc = p.keep_cw ? C + P : C;
  T* cw = p.keep_cw ? reinterpret_cast<T*>(smem_raw + p.off_cw)
                    : cw_s + (size_t)blockIdx.x * HIDDEN * C;
  const int ldct = p.keep_cw ? LT : HIDDEN;
  T* cwt = p.keep_cw ? reinterpret_cast<T*>(smem_raw + p.off_cwt)
                     : cwt_s + (size_t)blockIdx.x * C * HIDDEN;
  float* pv = pvec + (size_t)blockIdx.x * 5 * C;  // dbout | dg1s | dg1b | dg2s | dg2b
  float* pw = pwout + (size_t)b * HIDDEN * C;
  const int cq = C >> 2;
  const int rq = R * cq;
  // C is the width of the buffers, Ct <= C the block's true width: the
  // columns from Ct on are zero padding in x, dy, the weights and the
  // vectors.  Products and per-channel sums pass over them unchanged; the
  // two GroupNorms' statistics and their backward means count and walk Ct
  // columns, and do and dx, which subtract those means, are written as zero
  // there, so every padded column of every output is zero.
  const float fnc = (float)N * (float)Ct;
  const bool padded = Ct != C;

  // ---- GN1 statistics of x, fp32: the mean, then the variance about it
  float s = 0.f;
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    float v[4];
    load4(xg + (size_t)i * 4, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mean1 = cluster_sum(s, red, slots + 0, cs) / fnc;
  s = 0.f;
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    float v[4];
    if (padded && (i % cq) * 4 >= Ct) continue;  // Ct is a multiple of 4
    load4(xg + (size_t)i * 4, v);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = v[u] - mean1;
      s = fmaf(d, d, s);
    }
  }
  const float rstd1 = rsqrtf(cluster_sum(s, red, slots + 1, cs) / fnc + eps);
  if (tid == 0 && rank == 0) {
    stats[2 * b] = mean1;
    stats[2 * b + 1] = rstd1;
  }

  // ---- forward recompute: q, k, v = GN1(x) @ Wqkv
  for (int n0 = 0; n0 < R; n0 += TILE_R) {
    const int rv = min(TILE_R, R - n0);
    __syncthreads();
    for (int i = tid; i < rv * cq; i += NT) {
      const int r = i / cq, c = (i % cq) * 4;
      float v[4], sc[4], bi[4];
      load4(xg + (size_t)(n0 + r) * C + c, v);
      load4(g1s + c, sc);
      load4(g1b + c, bi);
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = gn1_h<T>(v[u], mean1, rstd1, sc[u], bi[u]);
      store4(tile + r * (C + P) + c, v);
    }
    __syncthreads();
    product_nt<T, false>(tile, C + P, wqkv_t, C, C, QKV, rv, [&](int r, int j, float v0, float v1) {
      store2(qkv + (size_t)(n0 + r) * ldq + j, v0, v1);
    });
  }
  __syncthreads();

  // k's column max, then the column sums of exp(k - max): the CTA's rows in
  // two row-parity halves added in a fixed order, then the cluster's partials
  {
    const int j = tid % HIDDEN, half = tid / HIDDEN;
    float m = NEG_INF;
#pragma unroll 8
    for (int n = half; n < R; n += NT / HIDDEN)
      m = fmaxf(m, to_f(qkv[(size_t)n * ldq + HIDDEN + j]));
    if (half == 1) kmax_p[j] = m;
    __syncthreads();
    if (half == 0) kmax_p[j] = fmaxf(m, kmax_p[j]);
    cluster_reduce<true>(kmax_p, kmax, HIDDEN, cs);
    float e = 0.f;
#pragma unroll 8
    for (int n = half; n < R; n += NT / HIDDEN)
      e += rnd<T>(expf(rnd<T>(to_f(qkv[(size_t)n * ldq + HIDDEN + j]) - kmax[j])));
    if (half == 1) ksum_p[j] = e;
    __syncthreads();
    if (half == 0) ksum_p[j] = e + ksum_p[j];
    cluster_reduce<false>(ksum_p, ksum, HIDDEN, cs);
  }

  // ---- qn over q, kn over k, and ctx = kn^T v (four 32x32 head blocks).
  // bf16: warp w owns head w / 2 and rows (w % 2) * 16 .. + 16 of its block,
  // as mma accumulators; fp32: thread t owns head t / 64, ctx row
  // (t % 64) / 2 of it and 16 columns.
  const int ch = tid / 64, cd_ = (tid % 64) / 2, ce0 = (tid % 2) * 16;
  T* kn_t = tile;                  // TILE_R x 128
  T* v_t = tile + TILE_R * LT;     // TILE_R x 128
  {
    float cacc[16];     // the fp32 form's sums
    float macc[4][4];   // the bf16 form's: four 16x8 mma outputs
#pragma unroll
    for (int i = 0; i < 16; ++i) cacc[i] = macc[i / 4][i % 4] = 0.f;
    for (int n0 = 0; n0 < R; n0 += TILE_R) {
      const int rv = min(TILE_R, R - n0);
      __syncthreads();  // the previous tile's readers done
      for (int i = tid; i < TILE_R * (HIDDEN / 2); i += NT) {
        const int r = i / (HIDDEN / 2), j = (i % (HIDDEN / 2)) * 2;
        float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;  // rows past the last add nothing
        if (r < rv) {
          T* row = qkv + (size_t)(n0 + r) * ldq;
          load2(row + HIDDEN + j, k0, k1);
          load2(row + 2 * HIDDEN + j, v0, v1);
          k0 = rnd<T>(rnd<T>(expf(rnd<T>(k0 - kmax[j]))) / ksum[j]);
          k1 = rnd<T>(rnd<T>(expf(rnd<T>(k1 - kmax[j + 1]))) / ksum[j + 1]);
          store2(row + HIDDEN + j, k0, k1);
        }
        store2(kn_t + r * LT + j, k0, k1);
        store2(v_t + r * LT + j, v0, v1);
      }
      // q softmax per head over its 32 lanes, shifted by the row max; qn
      // written over q
      q_softmax_rows<T>(qkv + (size_t)n0 * ldq, ldq, 0, rv, qkv + (size_t)n0 * ldq, ldq, SCALE);
      __syncthreads();
      if constexpr (IS_BF16<T>) {
        const int head = warp >> 1;
        tn_accumulate<4>(macc, kn_t, LT, head * DH + (warp & 1) * 16, v_t, LT, head * DH,
                         (rv + 15) & ~15);
      } else {
        const int kcol = ch * DH + cd_;
        for (int r = 0; r < rv; ++r) {
          const float kv = kn_t[r * LT + kcol];
          const float4* vr = reinterpret_cast<const float4*>(v_t + r * LT + ch * DH + ce0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v4 = vr[i];
            cacc[4 * i] = fmaf(kv, v4.x, cacc[4 * i]);
            cacc[4 * i + 1] = fmaf(kv, v4.y, cacc[4 * i + 1]);
            cacc[4 * i + 2] = fmaf(kv, v4.z, cacc[4 * i + 2]);
            cacc[4 * i + 3] = fmaf(kv, v4.w, cacc[4 * i + 3]);
          }
        }
      }
    }
    __syncthreads();  // the tile is free: the partial ctx blocks go there
    if constexpr (IS_BF16<T>) {
      const int g = lane >> 2, tig = lane & 3;
      const int d = (warp >> 1) * DH + (warp & 1) * 16 + g;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int e = ni * 8 + 2 * tig;
        ctx_p[d * DH + e] = macc[ni][0];
        ctx_p[d * DH + e + 1] = macc[ni][1];
        ctx_p[(d + 8) * DH + e] = macc[ni][2];
        ctx_p[(d + 8) * DH + e + 1] = macc[ni][3];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) ctx_p[(ch * DH + cd_) * DH + ce0 + i] = cacc[i];
    }
  }
  cluster_barrier(cs);
  {
    // the cluster's partials in rank order: each CTA adds up its 1 / cs of
    // the entries and writes them into every CTA's ctx
    const int share = HIDDEN * DH / cs;
    for (int i = rank * share + tid * 4; i < (rank + 1) * share; i += NT * 4) {
      const float4 t = cluster_sum4(ctx_p, i, cs);
      const float c4[4] = {t.x, t.y, t.z, t.w};
      T* at = ctxn + (i / DH) * LC + i % DH;
      if (cs == 1) {
        store4(at, c4);
      } else {
        cg::cluster_group cl = cg::this_cluster();
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < cs) store4(cl.map_shared_rank(at, r), c4);
      }
    }
  }
  cluster_barrier(cs);  // ctxn written; the peers are done with this tile

  // ---- cw = ctx @ Wout (128, C) and its transpose (C, 128), in T
  for (int c0 = 0; c0 < C; c0 += TILE_R)
    product_nt<T, true>(wout_t + (size_t)c0 * HIDDEN, HIDDEN, ctxn, LC, DH, HIDDEN,
                        min(TILE_R, C - c0), [&](int r, int d, float v0, float v1) {
                          store2(cwt + (size_t)(c0 + r) * ldct + d, v0, v1);
                          cw[(size_t)d * ldc + c0 + r] = from_f<T>(v0);
                          cw[(size_t)(d + 1) * ldc + c0 + r] = from_f<T>(v1);
                        });

  // ---- o = qn @ cw + bout, fp32, into the o scratch; GN2 statistics
  s = 0.f;
  for (int n0 = 0; n0 < R; n0 += TILE_R) {
    const int rv = min(TILE_R, R - n0);
    __syncthreads();  // cw written; the previous tile's readers done
    copy_rows<T>(tile, LT, qkv + (size_t)n0 * ldq, ldq, rv, HIDDEN);
    __syncthreads();
    product_nt<T, false>(tile, LT, cwt, ldct, HIDDEN, C, rv, [&](int r, int c, float v0, float v1) {
      const float o0 = v0 + bout[c], o1 = v1 + bout[c + 1];
      store2(ob + (size_t)(n0 + r) * C + c, o0, o1);
      s += o0 + o1;
    });
  }
  const float mean2 = cluster_sum(s, red, slots + 2, cs) / fnc;  // its barrier orders the o writes
  s = 0.f;
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    float o[4];
    if (padded && (i % cq) * 4 >= Ct) continue;
    load4(ob + (size_t)i * 4, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = o[u] - mean2;
      s = fmaf(d, d, s);
    }
  }
  const float rstd2 = rsqrtf(cluster_sum(s, red, slots + 3, cs) / fnc + eps);

  // ---- GN2 backward: dg2s, dg2b per channel; the item's means of dy*g2s
  // and dy*g2s*ohat
  float sa = 0.f, sb = 0.f;
  column_sums<2>(R, C, sred, pv + 3 * C, dyg, ob, [&](float dv, float o, int c, float* a) {
    const float oh = (o - mean2) * rstd2;
    a[0] = fmaf(dv, oh, a[0]);
    a[1] += dv;
    const float d = dv * g2s[c];
    sa += d;
    sb = fmaf(d, oh, sb);
  });
  const float m1 = cluster_sum(sa, red, slots + 4, cs) / fnc;
  const float m2 = cluster_sum(sb, red, slots + 5, cs) / fnc;
  auto do_of = [&](float dv, float o, float g2) {  // do from dy, o and g2s of the channel
    return (dv * g2 - m1 - (o - mean2) * rstd2 * m2) * rstd2;
  };
  column_sums<1>(R, C, sred, pv, dyg, ob, [&](float dv, float o, int c, float* a) {
    if (!padded || c < Ct) a[0] += do_of(dv, o, g2s[c]);
  });

  // ---- do in T (tile and scratch), dqn = do @ cw^T, then
  // dq = qn * (dqn - ((qn*dqn) @ seg) / scale) into d[q k v]
  {
    float* dqn_t = reinterpret_cast<float*>(tile + TILE_R * (C + P));  // TILE_R x 128 fp32
    for (int n0 = 0; n0 < R; n0 += TILE_R) {
      const int rv = min(TILE_R, R - n0);
      __syncthreads();
      for (int i = tid; i < rv * cq; i += NT) {
        const int r = i / cq, c = (i % cq) * 4;
        const size_t gi = (size_t)(n0 + r) * C + c;
        float v[4], o[4], g2[4];
        load4(dyg + gi, v);
        load4(ob + gi, o);
        load4(g2s + c, g2);
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = padded && c >= Ct ? 0.f : do_of(v[u], o[u], g2[u]);
        store4(tile + r * (C + P) + c, v);
        store4(dob + gi, v);
      }
      __syncthreads();
      product_nt<T, false>(tile, C + P, cw, ldc, C, HIDDEN, rv, [&](int r, int d, float v0, float v1) {
        store2(dqn_t + r * LDQN + d, v0, v1);
      });
      __syncthreads();
      {  // thread t: row t / 4, head t % 4, its 32 lanes in order
        const int r = tid >> 2, hh = tid & 3;
        if (r < rv) {
          float qv[DH / 4][4], g[DH / 4][4];
          load_head(qkv + (size_t)(n0 + r) * ldq + hh * DH, qv);
          load_head(dqn_t + r * LDQN + hh * DH, g);
          float rowdot = 0.f;
#pragma unroll
          for (int u = 0; u < DH / 4; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) rowdot += rnd<T>(qv[u][i] * g[u][i]);
#pragma unroll
          for (int u = 0; u < DH / 4; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) g[u][i] = qv[u][i] * (g[u][i] - rowdot / SCALE);
          store_head(dqkv + (size_t)(n0 + r) * QKV + hh * DH, g);
        }
      }
    }
  }
  __syncthreads();

  // ---- dcw = qn^T @ do over all N rows, rounded to T, over cw (no longer
  // needed).  The CTA's rows give a partial; a cluster's partials meet in
  // the global scratch pdcw and are added in rank order.
  {
    float* part = pdcw + (size_t)blockIdx.x * HIDDEN * C;
    if constexpr (IS_BF16<T>) {
      // warp w owns rows w*16 .. +16 of a 128 x 64 block of dcw
      const int g = lane >> 2, tig = lane & 3;
      T* qn_t = tile;                   // TILE_R x 128
      T* do_t = tile + TILE_R * LT;     // TILE_R x 64
      constexpr int LD = WT + P;
      for (int cb = 0; cb < C; cb += WT) {
        const int cv = min(WT, C - cb);
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
        for (int n0 = 0; n0 < R; n0 += TILE_R) {
          const int rv = min(TILE_R, R - n0);
          __syncthreads();
          for (int i = tid; i < TILE_R * (HIDDEN / 2); i += NT) {
            const int r = i / (HIDDEN / 2), j = (i % (HIDDEN / 2)) * 2;
            float q0 = 0.f, q1 = 0.f;
            if (r < rv) load2(qkv + (size_t)(n0 + r) * ldq + j, q0, q1);
            store2(qn_t + r * LT + j, q0, q1);
          }
          for (int i = tid; i < TILE_R * (WT / 2); i += NT) {
            const int r = i / (WT / 2), j = (i % (WT / 2)) * 2;
            float d0 = 0.f, d1 = 0.f;
            if (r < rv && j < cv) load2(dob + (size_t)(n0 + r) * C + cb + j, d0, d1);
            store2(do_t + r * LD + j, d0, d1);
          }
          __syncthreads();
          tn_accumulate<8>(acc, qn_t, LT, warp * 16, do_t, LD, 0, (rv + 15) & ~15);
        }
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
          const int c = cb + ni * 8 + 2 * tig;
          const int d = warp * 16 + g;
          if (c < C) {  // C is even, so c + 1 < C too
            if (cs == 1) {
              store2(cw + (size_t)d * ldc + c, acc[ni][0], acc[ni][1]);
              store2(cw + (size_t)(d + 8) * ldc + c, acc[ni][2], acc[ni][3]);
            } else {
              store2(part + (size_t)d * C + c, acc[ni][0], acc[ni][1]);
              store2(part + (size_t)(d + 8) * C + c, acc[ni][2], acc[ni][3]);
            }
          }
        }
      }
    } else {
      // each work item is an 8 x 4 block of the (128, C) output
      for (int w = tid; w < (HIDDEN / 8) * cq; w += NT) {
        const int d0 = (w / cq) * 8, c0 = (w % cq) * 4;
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < R; ++n) {
          float a[2][4], bv[4];
          load4(qkv + (size_t)n * ldq + d0, a[0]);
          load4(qkv + (size_t)n * ldq + d0 + 4, a[1]);
          load4(dob + (size_t)n * C + c0, bv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i / 4][i % 4], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (cs == 1) store4(cw + (size_t)(d0 + i) * ldc + c0, acc[i]);
          else store4(part + (size_t)(d0 + i) * C + c0, acc[i]);
        }
      }
    }
    if (cs > 1) {
      cluster_barrier(cs);  // orders the partials' global writes before the peers' reads
      const float* first = pdcw + (size_t)b * cs * HIDDEN * C;
      for (int i = tid; i < HIDDEN * cq; i += NT) {
        const int d = i / cq, c = (i % cq) * 4;
        float v[MAX_CLUSTER][4];  // loaded together, then added in rank order
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < cs) load4(first + ((size_t)r * HIDDEN + d) * C + c, v[r]);
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < cs)
#pragma unroll
            for (int u = 0; u < 4; ++u) t[u] += v[r][u];
        store4(cw + (size_t)d * ldc + c, t);
      }
    }
  }
  __syncthreads();

  // ---- dctx = (dcw @ Wout^T) on the head blocks, rounded to T, and with
  // each block transposed (the dv product's operand)
  for (int m0 = 0; m0 < HIDDEN; m0 += TILE_R)
    product_nt<T, false>(cw + (size_t)m0 * ldc, ldc, wout, C, C, HIDDEN, TILE_R,
                         [&](int r, int e, float v0, float v1) {
                           const int d = m0 + r;
                           if (d / DH == e / DH) {
                             const T t0 = from_f<T>(v0), t1 = from_f<T>(v1);
                             dctx[d * LC + e % DH] = t0;
                             dctx[d * LC + e % DH + 1] = t1;
                             dctxt[e * LC + d % DH] = t0;
                             dctxt[(e + 1) * LC + d % DH] = t1;
                           }
                         });

  // ---- the item's dWout = ctx^T @ dcw on the head blocks, fp32: the
  // cluster's CTAs take 128 / cs rows each
  {
    const int er = HIDDEN / cs;  // a multiple of 16
    if ((er / 16) * C >= NT) dwout_rows<T, 16>(ctxn, LC, cw, ldc, pw, C, rank * er, er);
    else dwout_rows<T, 4>(ctxn, LC, cw, ldc, pw, C, rank * er, er);
  }
  __syncthreads();

  // ---- k side: dkn = v @ dctx^T (row d of dctx), dv = kn @ dctx (column e).
  // Pass 0 sums inner = colsum_N(kn * dkn) and writes dv, pass 1 writes
  // dk = kn * (dkn - inner).  A thread meets the same columns in every tile
  // (bf16: those of its warp's two column tiles; fp32: one pair), so their
  // sums stay in registers across the tiles.
  for (int pass = 0; pass < 2; ++pass) {
    float in0[2] = {0.f, 0.f}, in1[2] = {0.f, 0.f};  // [column tile][column of the pair]
    for (int n0 = 0; n0 < R; n0 += TILE_R) {
      const int rv = min(TILE_R, R - n0);
      __syncthreads();
      copy_rows<T>(kn_t, LT, qkv + (size_t)n0 * ldq + HIDDEN, ldq, rv, HIDDEN);
      copy_rows<T>(v_t, LT, qkv + (size_t)n0 * ldq + 2 * HIDDEN, ldq, rv, HIDDEN);
      __syncthreads();
      if (pass == 0) {
        product_nt<T, true>(v_t, LT, dctx, LC, DH, HIDDEN, rv, [&](int r, int j, float v0, float v1) {
          float k0, k1;
          load2(kn_t + r * LT + j, k0, k1);
          if (IS_BF16<T> && (j >> 3) - warp >= 8) {
            in1[0] = fmaf(k0, v0, in1[0]);
            in1[1] = fmaf(k1, v1, in1[1]);
          } else {
            in0[0] = fmaf(k0, v0, in0[0]);
            in0[1] = fmaf(k1, v1, in0[1]);
          }
        });
        product_nt<T, true>(kn_t, LT, dctxt, LC, DH, HIDDEN, rv, [&](int r, int j, float v0, float v1) {
          store2(dqkv + (size_t)(n0 + r) * QKV + 2 * HIDDEN + j, v0, v1);
        });
      } else {
        product_nt<T, true>(v_t, LT, dctx, LC, DH, HIDDEN, rv, [&](int r, int j, float v0, float v1) {
          float k0, k1;
          load2(kn_t + r * LT + j, k0, k1);
          store2(dqkv + (size_t)(n0 + r) * QKV + HIDDEN + j, k0 * (v0 - inner[j]),
                 k1 * (v1 - inner[j + 1]));
        });
      }
    }
    if (pass == 0) {
      if constexpr (IS_BF16<T>) {
        // the 8 lanes of a column pair hold its rows' sums: add them in a
        // fixed order; lanes 0-3 end with the tile's columns
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          in0[0] += __shfl_xor_sync(0xffffffffu, in0[0], o);
          in0[1] += __shfl_xor_sync(0xffffffffu, in0[1], o);
          in1[0] += __shfl_xor_sync(0xffffffffu, in1[0], o);
          in1[1] += __shfl_xor_sync(0xffffffffu, in1[1], o);
        }
        if (lane < 4) {
          inner_p[warp * 8 + 2 * lane] = in0[0];
          inner_p[warp * 8 + 2 * lane + 1] = in0[1];
          inner_p[(warp + 8) * 8 + 2 * lane] = in1[0];
          inner_p[(warp + 8) * 8 + 2 * lane + 1] = in1[1];
        }
      } else {
        // threads t, t + 64, t + 128, t + 192 share the column pair 2 (t % 64)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          __syncthreads();
          sred[tid] = in0[u];
          __syncthreads();
          if (tid < HIDDEN / 2)
            inner_p[2 * tid + u] = ((sred[tid] + sred[tid + 64]) + sred[tid + 128]) + sred[tid + 192];
        }
      }
      cluster_reduce<false>(inner_p, inner, HIDDEN, cs);
    }
  }
  __syncthreads();

  // ---- dh = d[q k v] @ Wqkv^T, fp32, over the o scratch
  for (int n0 = 0; n0 < R; n0 += TILE_R) {
    const int rv = min(TILE_R, R - n0);
    __syncthreads();
    copy_rows<T>(tile, LQ, dqkv + (size_t)n0 * QKV, QKV, rv, QKV);
    __syncthreads();
    product_nt<T, false>(tile, LQ, wqkv, QKV, QKV, C, rv, [&](int r, int c, float v0, float v1) {
      store2(ob + (size_t)(n0 + r) * C + c, v0, v1);
    });
  }
  __syncthreads();

  // ---- GN1 backward: dg1s, dg1b per channel; the item's means; dx
  sa = sb = 0.f;
  column_sums<2>(R, C, sred, pv + C, xg, ob, [&](float xv, float dh, int c, float* a) {
    const float xh = (xv - mean1) * rstd1;
    a[0] = fmaf(dh, xh, a[0]);
    a[1] += dh;
    const float d = dh * g1s[c];
    sa += d;
    sb = fmaf(d, xh, sb);
  });
  const float n1 = cluster_sum(sa, red, slots + 6, cs) / fnc;
  const float n2 = cluster_sum(sb, red, slots + 7, cs) / fnc;
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    const int c = (i % cq) * 4;
    float xv[4], dv[4], dh[4], sc[4];
    load4(xg + (size_t)i * 4, xv);
    load4(dyg + (size_t)i * 4, dv);
    load4(ob + (size_t)i * 4, dh);
    load4(g1s + c, sc);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float xh = (xv[u] - mean1) * rstd1;
      if (!padded || c < Ct) dv[u] += (dh[u] * sc[u] - n1 - xh * n2) * rstd1;
    }
    store4(dxg + (size_t)i * 4, dv);
  }
  // the peers read this CTA's shared memory until they pass this barrier
  if (cs > 1) cg::this_cluster().sync();
}

// dWqkv partials: CTA (ct, jt, sp) sums h[R, c] * d[q k v][R, j] over rows
// R of range sp, for c in tile ct and j in tile jt (64 x 64), walking WT_R
// rows at a time in order.  bf16: on the tensor cores, warp w owning rows
// (w % 4) * 16 .. + 16 and columns (w / 4) * 32 .. + 32 of the tile; fp32: a
// thread owns 4 x 4.
template <typename T>
__global__ void __launch_bounds__(NT)
lin_attn_bwd_wqkv_kernel(const T* __restrict__ x, const float* __restrict__ g1s,
                         const float* __restrict__ g1b, const float* __restrict__ stats,
                         const T* __restrict__ dqkv, float* __restrict__ pwqkv,
                         int rows, int N, int C, int rows_per_split) {
  constexpr int LD = WT + PAD<T>;
  __shared__ __align__(16) T hs[WT_R * LD];
  __shared__ __align__(16) T ds[WT_R * LD];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cb = blockIdx.x * WT, jb = blockIdx.y * WT, sp = blockIdx.z;
  const int c0 = (tid % 16) * 4, j0 = (tid / 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int r_begin = sp * rows_per_split;
  const int r_end = min(r_begin + rows_per_split, rows);
  for (int r0 = r_begin; r0 < r_end; r0 += WT_R) {
    const int rv = min(WT_R, r_end - r0);
    __syncthreads();
    for (int i = tid; i < WT_R * (WT / 2); i += NT) {
      const int r = i / (WT / 2), cc = (i % (WT / 2)) * 2;
      const int c = cb + cc;
      float h0 = 0.f, h1 = 0.f, d0 = 0.f, d1 = 0.f;  // rows past the last add nothing
      if (r < rv) {
        const size_t R = (size_t)(r0 + r);
        if (c < C) {  // C is even
          const int item = (int)(R / N);
          load2(x + R * C + c, h0, h1);
          h0 = gn1_h<T>(h0, stats[2 * item], stats[2 * item + 1], g1s[c], g1b[c]);
          h1 = gn1_h<T>(h1, stats[2 * item], stats[2 * item + 1], g1s[c + 1], g1b[c + 1]);
        }
        load2(dqkv + R * QKV + jb + cc, d0, d1);
      }
      store2(hs + r * LD + cc, h0, h1);
      store2(ds + r * LD + cc, d0, d1);
    }
    __syncthreads();
    if constexpr (IS_BF16<T>) {
      tn_accumulate<4>(acc, hs, LD, (warp & 3) * 16, ds, LD, (warp >> 2) * 32, (rv + 15) & ~15);
    } else {
      for (int r = 0; r < rv; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(hs + r * LD + c0);
        const float4 d = *reinterpret_cast<const float4*>(ds + r * LD + j0);
        const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
      }
    }
  }
  float* out = pwqkv + (size_t)sp * C * QKV;
  if constexpr (IS_BF16<T>) {
    const int g = lane >> 2, tig = lane & 3;
    const int c = cb + (warp & 3) * 16 + g;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int j = jb + (warp >> 2) * 32 + ni * 8 + 2 * tig;
      if (c < C) store2(out + (size_t)c * QKV + j, acc[ni][0], acc[ni][1]);
      if (c + 8 < C) store2(out + (size_t)(c + 8) * QKV + j, acc[ni][2], acc[ni][3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (cb + c0 + i < C)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[(size_t)(cb + c0 + i) * QKV + jb + j0 + j] = acc[i][j];
  }
}

// The grads: dWqkv = the sum of the split partials, dWout the sum of the
// items', the five vectors the sums of the CTAs' partials, each in index
// order.
__global__ void __launch_bounds__(NT)
lin_attn_bwd_finalize_kernel(const float* __restrict__ pwqkv, int splits,
                             const float* __restrict__ pwout,
                             const float* __restrict__ pvec, int B, int ctas, int C,
                             float* __restrict__ dwqkv, float* __restrict__ dwout,
                             float* __restrict__ dvec) {
  const int n1 = C * QKV, n2 = HIDDEN * C, n3 = 5 * C;
  const int i = blockIdx.x * NT + threadIdx.x;
  float s = 0.f;
  if (i < n1) {
    for (int p = 0; p < splits; ++p) s += pwqkv[(size_t)p * n1 + i];
    dwqkv[i] = s;
  } else if (i < n1 + n2) {
    const int k = i - n1;
    for (int b = 0; b < B; ++b) s += pwout[(size_t)b * n2 + k];
    dwout[k] = s;
  } else if (i < n1 + n2 + n3) {
    const int k = i - n1 - n2;
    for (int b = 0; b < ctas; ++b) s += pvec[(size_t)b * n3 + k];
    dvec[k] = s;
  }
}

// Rows of one dWqkv split: the fewest splits that put about TARGET_CTAS CTAs
// on the card, each walking at least MIN_SPLIT_ROWS rows, rounded to WT_R.
// A function of the shape alone, so the order of every sum is fixed.
int rows_per_split(int B, int N, int C) {
  const long rows = (long)B * N;
  const long tiles = (long)((C + WT - 1) / WT) * (QKV / WT);
  long splits = (TARGET_CTAS + tiles - 1) / tiles;
  const long max_splits = (rows + MIN_SPLIT_ROWS - 1) / MIN_SPLIT_ROWS;
  if (splits > max_splits) splits = max_splits;
  if (splits < 1) splits = 1;
  long per = (rows + splits - 1) / splits;
  per = (per + WT_R - 1) / WT_R * WT_R;
  return (int)per;
}

int n_splits(int B, int N, int C) {
  const long rows = (long)B * N;
  const long per = rows_per_split(B, N, C);
  return (int)((rows + per - 1) / per);
}

constexpr int N_PLAN = 12;  // ints of a BwdPlan

template <typename T> cudaError_t raise_smem_limit() {
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(lin_attn_bwd_item_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

template <typename T>
int launch(const void* x, const void* dy, const void* wqkv, const void* wqkv_t,
           const void* wout, const void* wout_t, const float* bout, const float* g1s,
           const float* g1b, const float* g2s, void* dx, float* dwqkv, float* dwout,
           float* dvec, void* qkv, void* dqkv, float* o, void* do_, void* cw, void* cwt,
           float* stats, float* pvec, float* pwout, float* pdcw, float* pwqkv, int B, int N,
           int C, int Ct, int splits, float eps, const int* plan, int smem_bytes,
           cudaStream_t stream) {
  BwdPlan p;
  static_assert(sizeof(BwdPlan) == N_PLAN * sizeof(int), "BwdPlan is N_PLAN ints");
  int* pi = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PLAN; ++i) pi[i] = plan[i];
  if (B < 1 || N < 1 || C < 16 || C > MAX_C || C % 16 || Ct < 8 || Ct % 8 || Ct > C ||
      C - Ct >= 16 || splits != n_splits(B, N, C) ||
      p.cs < 1 || p.cs > MAX_CLUSTER || HIDDEN % p.cs || p.rows * p.cs != N ||
      smem_bytes < 0 || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit<T>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * p.cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, lin_attn_bwd_item_kernel<T>, static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(wqkv), static_cast<const T*>(wqkv_t), static_cast<const T*>(wout),
      static_cast<const T*>(wout_t), bout, g1s, g1b, g2s, static_cast<T*>(dx),
      static_cast<T*>(qkv), static_cast<T*>(dqkv), o, static_cast<T*>(do_),
      static_cast<T*>(cw), static_cast<T*>(cwt), stats, pvec, pwout, pdcw, N, C, Ct, eps,
      p);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + WT - 1) / WT, QKV / WT, splits);
  lin_attn_bwd_wqkv_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), g1s, g1b, stats, static_cast<const T*>(dqkv), pwqkv,
      B * N, N, C, rows_per_split(B, N, C));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = C * QKV + HIDDEN * C + 5 * C;
  lin_attn_bwd_finalize_kernel<<<(total + NT - 1) / NT, NT, 0, stream>>>(
      pwqkv, splits, pwout, pvec, B, B * p.cs, C, dwqkv, dwout, dvec);
  return (int)cudaGetLastError();
}

}  // namespace

// How many dWqkv row splits (the first dimension of the pwqkv scratch) the
// backward takes at this shape.
extern "C" int ldm_lin_attn_bwd_splits(int B, int N, int C) { return n_splits(B, N, C); }

// dtype: 0 = float32, 1 = bfloat16: the type of x, dy, dx, the four weights
// and the T scratch.  x, dy, dx: (B, N, C), C a multiple of 16 and at most
// 512; wqkv: (C, 384) and wqkv_t: (384, C); wout: (128, C) and wout_t:
// (C, 128); vectors (C,) fp32.  Outputs fp32: dwqkv (C, 384), dwout (128, C),
// dvec (5, C) = dbout, dg1s, dg1b, dg2s, dg2b.  plan: the 12 ints of a
// BwdPlan (host memory), smem_bytes the dynamic shared memory it takes.
// Scratch: qkv (read only when plan.keep is 0), dqkv (B, N, 384) and do
// (B, N, C), cw (B * cs, 128, C), cwt (B * cs, C, 128) (read only when
// plan.keep_cw is 0) in T; o (B, N, C), stats (B, 2), pvec (B * cs, 5, C),
// pwout (B, 128, C), pdcw (B * cs, 128, C) and pwqkv (splits, C, 384) fp32.
// Every pointer 16-byte aligned.  C_true: the block's true width, a multiple
// of 8 with C - 16 < C_true <= C; the columns (of wqkv: the rows) from C_true
// on are zero in x, dy, the weights and the vectors, and come out zero in dx
// and the grads.
extern "C" int ldm_lin_attn_bwd(int dtype, const void* x, const void* dy, const void* wqkv,
                                const void* wqkv_t, const void* wout, const void* wout_t,
                                const float* bout, const float* g1s, const float* g1b,
                                const float* g2s, void* dx, float* dwqkv, float* dwout,
                                float* dvec, void* qkv, void* dqkv, float* o, void* do_,
                                void* cw, void* cwt, float* stats, float* pvec, float* pwout,
                                float* pdcw, float* pwqkv, int B, int N, int C, int C_true,
                                int splits, float eps, const int* plan, int smem_bytes,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dy, wqkv, wqkv_t, wout, wout_t, bout, g1s, g1b, g2s, dx, dwqkv,
                         dwout, dvec, qkv, dqkv, o, do_, cw, cwt, stats, pvec, pwout, pdcw,
                         pwqkv, B, N, C, C_true, splits, eps, plan, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, wqkv, wqkv_t, wout, wout_t, bout, g1s, g1b, g2s, dx,
                                 dwqkv, dwout, dvec, qkv, dqkv, o, do_, cw, cwt, stats, pvec,
                                 pwout, pdcw, pwqkv, B, N, C, C_true, splits, eps, plan,
                                 smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
