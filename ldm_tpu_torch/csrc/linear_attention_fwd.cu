// Fused linear-attention block forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the two TPU forward kernels of ldm_tpu/ops/linear_attention.py:
//   * _fused_kernel         (the unpacked form, C != 64 sites), and
//   * _fused_kernel_packed  (the pixel-pair packed form, C == 64 sites).
// The packing only dodged the TPU's (8, 128) tile padding; Hopper has no such
// tile, so one kernel serves every (N, C).  It computes what
// linear_attention_block_xla computes, per item b:
//
//   h    = GroupNorm1(x)                       fp32 stats, output in T
//   q,k,v = h @ Wqkv[:, 0:128 | 128:256 | 256:384]
//   q    = softmax over each head's 32 lanes (shifted by the row max over all
//          128 lanes) * 32^-0.5
//   k    = softmax over the N rows, per column (its normalisation commutes out
//          of the context product, so only exp(k - max) is formed)
//   ctx  = k_e^T v, only the four diagonal 32x32 head blocks, / k_sum
//   out  = q @ (ctx @ Wout) + bout
//   y    = x + GroupNorm2(out)                 fp32 stats, output in T
//
// T is the compute type, fp32 or bf16, and the type of x, y and the weights
// handed in (the host side casts them once per weight version).  Matmul
// inputs are values of T, sums are fp32; every intermediate the plain version
// rounds to T (q, k, v, exp(.), ctx, ctx@Wout, out) is rounded to T at the
// same point here.  Norm vectors and the bias stay fp32.
//
// What bounds it: bytes.  The least the card must move is x in and y out;
// the block's 2 N C 384 + 2 N 128 C + ... operations an item are far below
// the tensor cores' rate for those bytes.  What stands between the kernel
// and that bound is the chain of four reductions over all N rows of an item
// (GN1 statistics, k's column max, k_sum with the ctx blocks, GN2 statistics)
// that sit between the products: nothing after a reduction can start before
// every row has passed it.  The design:
//   * a thread-block cluster an item, `cs` CTAs (1, 2, 4 or 8, chosen by the
//     host from (N, C) alone), each owning N / cs rows.  Each reduction: a
//     CTA's partial in its own shared memory, a cluster barrier, then every
//     CTA adds the partials in rank order out of its peers' shared memory
//     (distributed shared memory).  No atomics; reruns are bit-identical.
//     GN statistics are the mean first, then the variance about it.
//   * the item kept on chip (`keep`): where the CTA's rows of q, k, v
//     ((rows, 384) in T), of out and the (C, 128) ctx@Wout fit in shared
//     memory, they never go to device memory.  x is re-read from global
//     memory in every pass (the CTA's own rows, 16 KB at C = 64: an L2 hit
//     after the first; a copy in shared memory was built and gained 2.4-2.9%
//     at the C = 64 sites, too little to carry a second layout of x).  Wqkv
//     is staged whole in shared memory where it fits (`stage_w`; its room is
//     taken over by ctx@Wout and out afterwards): 4.0-5.3% at the C = 64
//     sites with 128 rows a CTA, 8.5% on the tiled path at (4096, 64),
//     2% at (64, 128) (perf/plan_sweep.py, PERF.md).  Where it does not
//     fit (C >= 256, and C = 128 beside 128 kept rows) the product reads it
//     from global memory, an L2 hit after the first CTA, one step ahead of
//     its use; staging in K-chunks was not built.
//     Shapes whose rows do not fit (N = 4096, 16384; C = 512) take the tiled
//     path: the same code with those buffers in global scratch.  The kernel
//     reads buffers through pointers that point either way, so the two paths
//     differ in addresses only.
//   * the rows are walked in tiles of 64; the products (h @ Wqkv,
//     k_e^T v, ctx @ Wout, q @ ctx_w) run on the tensor cores in bf16
//     (linear_attention_common.cuh); accesses to x, y and the buffers move
//     8 or 16 bytes a thread.
//   * with one CTA of 8 warps on an SM (the kept item takes most of its
//     shared memory), a CTA's time is the sum of its latencies, so the
//     design keeps dependent steps few: the q softmax gives a thread a whole
//     (row, head), 32 lanes in registers, instead of a warp a row with 25
//     shuffles in a chain; k_sum's terms add up in the threads that stage
//     exp(k - max); a cluster reduction loads its peers' values together
//     before adding them, and the 128 x 32 ctx is added up 1 / cs by each
//     CTA and written into every CTA's copy; the tile product has no branch
//     in its k loop.
//
// STAGE (1-6, compile time) also builds the stage ablation that replaces
// the TPU probe kernel `_kernel` of perf/probe7.py:30 (launched at :128): the
// kernel cut after stage 1 GN1, 2 + qkv, 3 + q softmax, 4 + k path (k's max,
// exp and sum; the ctx products are skipped), 5 + ctx / ctx@Wout / out, and
// 6 the whole block (+ GN2 and the residual).  Stages 1-5 write
// y = x + (what the stage has made), so each depends on every stage it
// keeps; STAGE = 6 is the production kernel, and the `if constexpr` cuts
// leave its code as it was.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "linear_attention_common.cuh"

namespace {

constexpr float SCALE = 0.17677669529663688f;  // dim_head ** -0.5, correctly rounded

// Where the kernel's buffers are; made by the host side (plan_fwd in
// ops/linear_attention.py), byte offsets into dynamic shared memory.
struct FwdPlan {
  int cs;        // CTAs in the cluster of one item
  int rows;      // rows of the item a CTA owns: N / cs
  int keep;      // q/k/v, out and ctx@Wout^T in shared memory (else global)
  int stage_w;   // Wqkv^T staged in shared memory
  int off_tile;  // 64-row tile(s); also the partial ctx blocks
  int off_ctxn;  // ctx, (128, 32 + pad) in T
  int off_vec;   // kmax_p | kmax | ksum_p | ksum | red | slots, fp32
  int off_u;     // Wqkv^T (384, C + pad), later ctx@Wout^T (C, 128 + pad)
  int off_out;   // out, (rows, C + pad)
  int off_qkv;   // q | k | v, (rows, 384 + pad)
};

// Stages 3 and 4 of the ablation: y = x + qn + k + v, lane c % 128 of each,
// with k replaced by kn = exp(k - kmax) / ksum when KN (stage 4).
template <typename T, bool KN>
__device__ void q_softmax_out(const T* xg, const T* qkv, int ldq, const float* kmax,
                              const float* ksum, T* yg, T* tile, int lt, int R, int C) {
  for (int n0 = 0; n0 < R; n0 += TILE_R) {
    const int rv = min(TILE_R, R - n0);
    __syncthreads();
    q_softmax_rows<T>(qkv, ldq, n0, rv, tile, lt, SCALE);
    __syncthreads();
    for (int i = threadIdx.x; i < rv * C; i += NT) {
      const int r = i / C, c = i % C, j = c % HIDDEN;
      const T* row = qkv + (size_t)(n0 + r) * ldq;
      float kv = to_f(row[HIDDEN + j]);
      if constexpr (KN) kv = rnd<T>(rnd<T>(expf(rnd<T>(kv - kmax[j]))) / ksum[j]);
      yg[(size_t)(n0 + r) * C + c] =
          from_f<T>(to_f(xg[(size_t)(n0 + r) * C + c]) + to_f(tile[r * lt + j]) + kv +
                    to_f(row[2 * HIDDEN + j]));
    }
  }
}

template <typename T, int STAGE>
__global__ void __launch_bounds__(NT)
lin_attn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqkv_t,
                    const T* __restrict__ wout_t, const float* __restrict__ bout,
                    const float* __restrict__ g1s, const float* __restrict__ g1b,
                    const float* __restrict__ g2s, const float* __restrict__ g2b,
                    T* __restrict__ y, T* __restrict__ qkv_scratch,
                    T* __restrict__ cw_scratch, int N, int C, int Ct, float eps, FwdPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = PAD<T>;
  constexpr int LT = HIDDEN + P;   // row stride of a 128-wide tile
  constexpr int LC = DH + P;       // row stride of ctx
  T* tile = reinterpret_cast<T*>(smem_raw + p.off_tile);
  float* ctx_p = reinterpret_cast<float*>(smem_raw + p.off_tile);  // 128 x 32 partial ctx
  T* ctxn = reinterpret_cast<T*>(smem_raw + p.off_ctxn);
  float* vec = reinterpret_cast<float*>(smem_raw + p.off_vec);
  float* kmax_p = vec;
  float* kmax = vec + HIDDEN;
  float* ksum_p = vec + 2 * HIDDEN;
  float* ksum = vec + 3 * HIDDEN;
  float* red = vec + 4 * HIDDEN;        // NT / 32
  float* slots = red + NT / 32;         // one float a cluster_sum call

  const int cs = p.cs, R = p.rows;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)b * N + (size_t)rank * R;  // the CTA's first row
  const T* xg = x + row0 * C;
  T* yg = y + row0 * C;
  const int ldq = p.keep ? QKV + P : QKV;
  T* qkv = p.keep ? reinterpret_cast<T*>(smem_raw + p.off_qkv) : qkv_scratch + row0 * QKV;
  const int ldo = p.keep ? C + P : C;
  T* outb = p.keep ? reinterpret_cast<T*>(smem_raw + p.off_out) : yg;
  const int ldcw = p.keep ? HIDDEN + P : HIDDEN;
  T* cwt = p.keep ? reinterpret_cast<T*>(smem_raw + p.off_u)
                  : cw_scratch + (size_t)blockIdx.x * C * HIDDEN;
  const int ldw = p.stage_w ? C + P : C;
  T* wst = reinterpret_cast<T*>(smem_raw + p.off_u);
  const T* wq = p.stage_w ? wst : wqkv_t;
  const int cq = C >> 2;               // 4-element groups a row
  const int rq = R * cq;               // and in the CTA's rows
  // C is the width of the buffers, Ct <= C the block's true width: the
  // columns from Ct on are zero padding (x, the weights and the vectors
  // alike), which every product and sum passes over unchanged, but not a
  // variance about a mean: GroupNorm's statistics count and walk Ct columns
  const float fnc = (float)N * (float)Ct;
  const bool padded = Ct != C;
  // the peers read this CTA's shared memory until they pass the last barrier
  auto finish = [&]() { if (cs > 1) cg::this_cluster().sync(); };

  // ---- pass 1: GroupNorm(1) statistics of x, fp32: the mean, then the
  // variance about it; Wqkv^T staged on the way (pass 2's barriers order it
  // before its first use)
  if (p.stage_w) copy_rows<T>(wst, ldw, wqkv_t, C, QKV, C);
  float s = 0.f;
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    float v[4];
    load4(xg + (size_t)(i / cq) * C + (i % cq) * 4, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  const float mean1 = cluster_sum(s, red, slots + 0, cs) / fnc;
  s = 0.f;
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    float v[4];
    if (padded && (i % cq) * 4 >= Ct) continue;  // Ct is a multiple of 4
    load4(xg + (size_t)(i / cq) * C + (i % cq) * 4, v);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = v[u] - mean1;
      s = fmaf(d, d, s);
    }
  }
  const float rstd1 = rsqrtf(cluster_sum(s, red, slots + 1, cs) / fnc + eps);
  // h = GN1(x) for 4 values of row r from column c on
  auto gn1_4 = [&](int r, int c, float (&h)[4]) {
    float v[4], sc[4], bi[4];
    load4(xg + (size_t)r * C + c, v);
    load4(g1s + c, sc);
    load4(g1b + c, bi);
#pragma unroll
    for (int u = 0; u < 4; ++u) h[u] = rnd<T>((v[u] - mean1) * rstd1 * sc[u] + bi[u]);
  };
  if constexpr (STAGE == 1) {  // y = x + GN1(x)
  #pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
      const int r = i / cq, c = (i % cq) * 4;
      float v[4], h[4];
      load4(xg + (size_t)r * C + c, v);
      gn1_4(r, c, h);
#pragma unroll
      for (int u = 0; u < 4; ++u) h[u] += v[u];
      store4(yg + (size_t)r * C + c, h);
    }
    finish();
    return;
  }

  // ---- pass 2: h = GN1(x) tile by tile, q | k | v = h @ Wqkv
  for (int n0 = 0; n0 < R; n0 += TILE_R) {
    const int rv = min(TILE_R, R - n0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < rv * cq; i += NT) {
      const int r = i / cq, c = (i % cq) * 4;
      float h[4];
      gn1_4(n0 + r, c, h);
      store4(tile + r * (C + P) + c, h);
    }
    __syncthreads();
    product_nt<T, false>(tile, C + P, wq, ldw, C, QKV, rv, [&](int r, int j, float v0, float v1) {
      store2(qkv + (size_t)(n0 + r) * ldq + j, v0, v1);
    });
  }
  __syncthreads();  // q, k, v visible to the whole CTA
  if constexpr (STAGE == 2) {  // y = x + q + k + v (lane c % 128 of each)
    for (int i = tid; i < R * C; i += NT) {
      const int r = i / C, c = i % C, j = c % HIDDEN;
      const T* row = qkv + (size_t)r * ldq;
      yg[i] = from_f<T>(to_f(xg[(size_t)r * C + c]) + to_f(row[j]) + to_f(row[HIDDEN + j]) +
                        to_f(row[2 * HIDDEN + j]));
    }
    finish();
    return;
  }
  if constexpr (STAGE == 3) {  // y = x + qn + k + v
    q_softmax_out<T, false>(xg, qkv, ldq, nullptr, nullptr, yg, tile, LT, R, C);
    finish();
    return;
  }

  // k's per-column max over the item's N rows: the CTA's rows in two
  // row-parity halves, then the cluster's partials
  {
    const int j = tid % HIDDEN, half = tid / HIDDEN;
    float m = NEG_INF;
#pragma unroll 8
    for (int n = half; n < R; n += NT / HIDDEN)
      m = fmaxf(m, to_f(qkv[(size_t)n * ldq + HIDDEN + j]));
    if (half == 1) kmax_p[j] = m;
    __syncthreads();
    if (half == 0) kmax_p[j] = fmaxf(m, kmax_p[j]);
  }
  cluster_reduce<true>(kmax_p, kmax, HIDDEN, cs);

  // ---- pass 3: k_e = exp(k - max), k_sum and the four 32x32 ctx blocks.
  // bf16: warp w owns head w / 2, rows (w % 2) * 16 .. + 16 of its ctx block
  // and all 32 columns, as mma accumulators.  fp32: thread t owns head
  // t / 64, ctx row (t % 64) / 2 of that head and 16 of its 32 columns.
  // Threads t < 128 also own k_sum[t].
  const int warp = tid >> 5, lane = tid & 31;
  const int ch = tid / 64, cd_ = (tid % 64) / 2, ce0 = (tid % 2) * 16;
  float cacc[16];     // the fp32 form's sums
  float macc[4][4];   // the bf16 form's: four 16x8 mma outputs
#pragma unroll
  for (int i = 0; i < 16; ++i) cacc[i] = macc[i / 4][i % 4] = 0.f;
  // thread t meets the column pair 2 (t % 64) in every row it stages, so
  // k_sum's terms add up in registers
  float ks0 = 0.f, ks1 = 0.f;
  T* ke_t = tile;                  // TILE_R x 128
  T* v_t = tile + TILE_R * LT;     // TILE_R x 128
  for (int n0 = 0; n0 < R; n0 += TILE_R) {
    const int rv = min(TILE_R, R - n0);
    __syncthreads();
    for (int i = tid; i < TILE_R * (HIDDEN / 2); i += NT) {
      const int r = i / (HIDDEN / 2), j = (i % (HIDDEN / 2)) * 2;
      float e0 = 0.f, e1 = 0.f, v0 = 0.f, v1 = 0.f;  // rows past the last add nothing
      if (r < rv) {
        const T* row = qkv + (size_t)(n0 + r) * ldq;
        load2(row + HIDDEN + j, e0, e1);
        load2(row + 2 * HIDDEN + j, v0, v1);
        e0 = rnd<T>(expf(rnd<T>(e0 - kmax[j])));
        e1 = rnd<T>(expf(rnd<T>(e1 - kmax[j + 1])));
        ks0 += e0;
        ks1 += e1;
      }
      store2(ke_t + r * LT + j, e0, e1);
      store2(v_t + r * LT + j, v0, v1);
    }
    __syncthreads();
    if constexpr (STAGE >= 5) {  // the ctx products: stage 5 on
      if constexpr (IS_BF16<T>) {
        const int head = warp >> 1;
        tn_accumulate<4>(macc, ke_t, LT, head * DH + (warp & 1) * 16, v_t, LT, head * DH,
                         (rv + 15) & ~15);
      } else {
        const int kcol = ch * DH + cd_;
        for (int r = 0; r < rv; ++r) {
          const float kv = ke_t[r * LT + kcol];
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
  }
  __syncthreads();  // the tile is free: the partial ctx blocks go there
  {
    // threads t, t + 64, t + 128, t + 192 share a column pair: added in that
    // order through the free tile (behind the 16 KB of partial ctx blocks)
    float* kred = ctx_p + HIDDEN * DH;
    kred[2 * tid] = ks0;
    kred[2 * tid + 1] = ks1;
    __syncthreads();
    if (tid < HIDDEN) {
      const int pr = tid >> 1, u = tid & 1;
      ksum_p[tid] = ((kred[2 * pr + u] + kred[2 * (pr + 64) + u]) + kred[2 * (pr + 128) + u]) +
                    kred[2 * (pr + 192) + u];
    }
  }
  if constexpr (STAGE >= 5) {
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
  cluster_reduce<false>(ksum_p, ksum, HIDDEN, cs);  // its barrier covers ctx_p too
  if constexpr (STAGE == 4) {  // y = x + qn + kn + v
    q_softmax_out<T, true>(xg, qkv, ldq, kmax, ksum, yg, tile, LT, R, C);
    finish();
    return;
  }
  // the item's ctx: the cluster's partials in rank order, rounded to T, times
  // 1/k_sum of its row, rounded to T again.  Each CTA adds up its 1 / cs of
  // the entries and writes them into every CTA's ctx.
  {
    const int share = HIDDEN * DH / cs;
    for (int i = rank * share + tid * 4; i < (rank + 1) * share; i += NT * 4) {
      const float4 t = cluster_sum4(ctx_p, i, cs);
      const int d = i / DH;
      const float inv = 1.f / ksum[d];
      const float c4[4] = {rnd<T>(t.x) * inv, rnd<T>(t.y) * inv, rnd<T>(t.z) * inv,
                           rnd<T>(t.w) * inv};
      if (cs == 1) {
        store4(ctxn + d * LC + i % DH, c4);
      } else {
        cg::cluster_group cl = cg::this_cluster();
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < cs) store4(cl.map_shared_rank(ctxn, r) + d * LC + i % DH, c4);
      }
    }
  }
  cluster_barrier(cs);  // ctxn written; the peers are done with this tile

  // ctx_w^T = (ctx @ Wout)^T, (C, 128): column d of head h meets Wout rows
  // h*32 .. h*32+31
  for (int c0 = 0; c0 < C; c0 += TILE_R)
    product_nt<T, true>(wout_t + (size_t)c0 * HIDDEN, HIDDEN, ctxn, LC, DH, HIDDEN,
                        min(TILE_R, C - c0), [&](int r, int d, float v0, float v1) {
                          store2(cwt + (size_t)(c0 + r) * ldcw + d, v0, v1);
                        });

  // ---- pass 4: q softmax per head, out = q @ ctx_w + bout
  float s2 = 0.f;
  for (int n0 = 0; n0 < R; n0 += TILE_R) {
    const int rv = min(TILE_R, R - n0);
    __syncthreads();  // ctx_w^T written; the previous tile's readers are done
    q_softmax_rows<T>(qkv, ldq, n0, rv, tile, LT, SCALE);
    __syncthreads();
    product_nt<T, false>(tile, LT, cwt, ldcw, HIDDEN, C, rv, [&](int r, int c, float v0, float v1) {
      const float o0 = rnd<T>(rnd<T>(v0) + rnd<T>(bout[c]));
      const float o1 = rnd<T>(rnd<T>(v1) + rnd<T>(bout[c + 1]));
      store2(outb + (size_t)(n0 + r) * ldo + c, o0, o1);
      s2 += o0 + o1;
    });
  }
  // block_sum's leading barrier also orders pass 4's writes of out before
  // the reads below
  const float mean2 = cluster_sum(s2, red, slots + 2, cs) / fnc;
  if constexpr (STAGE == 5) {  // y = x + out
  #pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
      const int r = i / cq, c = (i % cq) * 4;
      float v[4], o[4];
      load4(xg + (size_t)r * C + c, v);
      load4(outb + (size_t)r * ldo + c, o);
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] += v[u];
      store4(yg + (size_t)r * C + c, o);
    }
    finish();
    return;
  }

  // ---- pass 5: GN2 variance, then y = x + GN2(out)
  s = 0.f;
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    float o[4];
    if (padded && (i % cq) * 4 >= Ct) continue;
    load4(outb + (size_t)(i / cq) * ldo + (i % cq) * 4, o);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = o[u] - mean2;
      s = fmaf(d, d, s);
    }
  }
  const float rstd2 = rsqrtf(cluster_sum(s, red, slots + 3, cs) / fnc + eps);
#pragma unroll 4
  for (int i = tid; i < rq; i += NT) {
    const int r = i / cq, c = (i % cq) * 4;
    float v[4], o[4], sc[4], bi[4];
    load4(xg + (size_t)r * C + c, v);
    load4(outb + (size_t)r * ldo + c, o);
    load4(g2s + c, sc);
    load4(g2b + c, bi);
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = v[u] + ((o[u] - mean2) * rstd2 * sc[u] + bi[u]);
    store4(yg + (size_t)r * C + c, o);
  }
  finish();
}

constexpr int MAX_DEVICES = 64;
constexpr int N_PLAN = 10;  // ints of a FwdPlan

// Raise the kernel's dynamic shared-memory limit to the card's, once per
// device (the attribute belongs to the device's context), not per launch.
template <typename T, int STAGE> cudaError_t raise_smem_limit() {
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(lin_attn_fwd_kernel<T, STAGE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

template <typename T, int STAGE>
int launch(const void* x, const void* wqkv_t, const void* wout_t, const float* bout,
           const float* g1s, const float* g1b, const float* g2s, const float* g2b, void* y,
           void* qkv_scratch, void* cw_scratch, int B, int N, int C, int Ct, float eps,
           const int* plan, int smem_bytes, cudaStream_t stream) {
  FwdPlan p;
  static_assert(sizeof(FwdPlan) == N_PLAN * sizeof(int), "FwdPlan is N_PLAN ints");
  int* pi = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PLAN; ++i) pi[i] = plan[i];
  if (B < 1 || N < 1 || C < 16 || C % 16 || Ct < 8 || Ct % 8 || Ct > C || C - Ct >= 16 ||
      p.cs < 1 || p.cs > MAX_CLUSTER ||
      p.rows * p.cs != N || smem_bytes < 0 || smem_bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_smem_limit<T, STAGE>();
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
  const cudaError_t lerr = cudaLaunchKernelEx(
      &cfg, lin_attn_fwd_kernel<T, STAGE>, static_cast<const T*>(x),
      static_cast<const T*>(wqkv_t), static_cast<const T*>(wout_t), bout, g1s, g1b, g2s, g2b,
      static_cast<T*>(y), static_cast<T*>(qkv_scratch), static_cast<T*>(cw_scratch), N, C, Ct,
      eps, p);
  if (lerr != cudaSuccess) return (int)lerr;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stage(int stage, const void* x, const void* wqkv_t, const void* wout_t,
                 const float* bout, const float* g1s, const float* g1b, const float* g2s,
                 const float* g2b, void* y, void* qkv, void* cw, int B, int N, int C, int Ct,
                 float eps, const int* plan, int smem_bytes, cudaStream_t s) {
#define LA_ARGS x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, qkv, cw, B, N, C, Ct, eps, \
                plan, smem_bytes, s
  switch (stage) {
    case 1: return launch<T, 1>(LA_ARGS);
    case 2: return launch<T, 2>(LA_ARGS);
    case 3: return launch<T, 3>(LA_ARGS);
    case 4: return launch<T, 4>(LA_ARGS);
    case 5: return launch<T, 5>(LA_ARGS);
    case 6: return launch<T, 6>(LA_ARGS);
  }
#undef LA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The stage ablation (perf/probe7.py's stages 1-6); stage 6 is the production
// kernel.  dtype: 0 = float32, 1 = bfloat16: the type of x, y, the scratch and
// the two weights.  x, y: (B, N, C), C a multiple of 16; wqkv_t: (384, C),
// the transpose of Wqkv; wout_t: (C, 128), the transpose of Wout; vectors
// (C,) fp32.  C_true: the block's true width, a multiple of 8 with
// C - 16 < C_true <= C; the columns from C_true on are zero in x, the
// weights and the vectors, and come out zero in y.  plan: the 10 ints of a FwdPlan (host memory), smem_bytes the
// dynamic shared memory it takes.  qkv_scratch (B, N, 384) and cw_scratch
// (B * cs, C, 128) in the compute type are read only when plan.keep is 0.
// Every pointer 16-byte aligned.
extern "C" int ldm_lin_attn_fwd_stage(int stage, int dtype, const void* x, const void* wqkv_t,
                                      const void* wout_t, const float* bout, const float* g1s,
                                      const float* g1b, const float* g2s, const float* g2b,
                                      void* y, void* qkv_scratch, void* cw_scratch, int B,
                                      int N, int C, int C_true, float eps, const int* plan,
                                      int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_stage<float>(stage, x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y,
                               qkv_scratch, cw_scratch, B, N, C, C_true, eps, plan, smem_bytes,
                               s);
  if (dtype == 1)
    return launch_stage<__nv_bfloat16>(stage, x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y,
                                       qkv_scratch, cw_scratch, B, N, C, C_true, eps, plan,
                                       smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

// The production forward: stage 6 of the above.
extern "C" int ldm_lin_attn_fwd(int dtype, const void* x, const void* wqkv_t,
                                const void* wout_t, const float* bout, const float* g1s,
                                const float* g1b, const float* g2s, const float* g2b, void* y,
                                void* qkv_scratch, void* cw_scratch, int B, int N, int C,
                                int C_true, float eps, const int* plan, int smem_bytes,
                                void* stream) {
  return ldm_lin_attn_fwd_stage(6, dtype, x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y,
                                qkv_scratch, cw_scratch, B, N, C, C_true, eps, plan, smem_bytes,
                                stream);
}
