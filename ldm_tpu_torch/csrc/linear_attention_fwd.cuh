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
// What bounds it.  By the roofline, bytes: the least the card must move is x
// in and y out, and the block's 2 N C 384 + 2 N 128 C + ... operations an
// item are far below the tensor cores' rate for those bytes.  In fact,
// latency: an item's rows pass a chain of reductions over all of them (GN1's
// mean and variance, k's column max, k_sum with the ctx blocks, GN2's mean
// and variance) with the barriers between, and nothing after a reduction can
// start before every row has passed it.  A 64-row slice of an item is about
// 2 us of products on one SM's tensor cores, and some tens of microseconds
// of barriers, reductions and loads in a row.  Two schedules run the same
// arithmetic:
//
//   * The persistent schedule (bf16; the shapes whose two units fit in
//     shared memory, up to N = 1024 at 64 and 128 px, but for those where
//     the cluster schedule timed faster on the card: plan_fwd).  One block of two teams of 8 warps on each
//     SM for the whole launch (grid <= the SMs), each team walking its own
//     list of work units, so two units are in flight on an SM and one's
//     barriers and reductions hide behind the other's products and loads.
//     A unit comes from the shape and the batch (plan_persistent in
//     ops/linear_attention.py): for N >= 128 one item's slice over a cluster
//     of cs CTAs (up to 16, a non-portable size), 128 rows where two such
//     units fit, else 64 (and 64 where the batch has fewer 128-row slices
//     than the card has SMs): a unit's time is mostly its chain of barriers
//     and reductions whatever its rows, so the larger slice goes faster; for
//     N < 128 one whole item, its rows padded to the mma's 16 and not to a
//     64-row tile (16 at N = 16).  A reduction across the cluster must
//     not stall the other team: each team has its own named barrier and,
//     across the cluster, two mbarriers that each CTA's team arrives on
//     remotely (Team::cluster_sync), with the partials read out of the
//     peers' shared memory in rank order, all peers' loads in flight
//     together.  Wqkv^T is staged into shared memory once per block where it
//     fits beside the two units (C = 64), not once per CTA; Wout^T is
//     copied, once per unit, into the columns of k and v that the ctx sums
//     have consumed (C <= 128).  The team's next unit's x is on its way into
//     L2 (one bulk prefetch) while the current one computes.  What must
//     stay in shared memory is k | v: a 128-row slice keeps q in a slot of
//     global scratch (written by the qkv product, brought back one 64-row
//     tile at a time into k | v's rows 64-127 for pass 4), and its partial
//     ctx and ctx in those same rows once the ctx sums are done with them; a
//     64-row slice keeps q | k | v.  exp(k - max) and the q softmax replace
//     k and q in place; (ctx @ Wout)^T and out stay in shared memory where
//     they fit.  A thread of a team has 128 registers, and a spill would go
//     to L2 (the units leave L1 little room), so the unit's buffer addresses
//     are made afresh where they are used, the layout choices that change
//     the register need are template parameters, and the products outside
//     pass 2 run in 32-row chunks.
//   * The cluster schedule (fp32, the shapes whose units do not fit: N =
//     4096 and 16384, C = 512 beside N >= 64, and the few where it timed
//     faster, such as (64, 256)): one short-lived CTA of
//     8 warps an item slice, one CTA on an SM.  A thread-block cluster an
//     item, `cs` CTAs (1, 2, 4 or 8, from N alone), each owning N / cs rows;
//     each reduction a CTA's partial in its own shared memory, a cluster
//     barrier, then every CTA adds the partials in rank order out of its
//     peers' shared memory (distributed shared memory).  The item kept on
//     chip (`keep`): where the CTA's rows of q, k, v ((rows, 384) in T), of
//     out and the (C, 128) ctx@Wout fit in shared memory, they never go to
//     device memory.  x is re-read from global memory in every pass.  Wqkv is
//     staged whole in shared memory where it fits (`stage_w`; its room is
//     taken over by ctx@Wout and out afterwards), else read from global
//     memory, an L2 hit, one step ahead of its use.  Shapes whose rows do
//     not fit take the tiled path: the same code with those buffers in global
//     scratch, read through pointers that point either way.  The q softmax
//     gives a thread a whole (row, head) in registers; k_sum's terms add up
//     in the threads that stage exp(k - max).
//
// Both: GN statistics are the mean first, then the variance about it; no
// atomics, every sum in an order fixed by the shape, so reruns are
// bit-identical.  The rows are walked in tiles of 64; the products (h @ Wqkv,
// k_e^T v, ctx @ Wout, q @ ctx_w) run on the tensor cores in bf16
// (linear_attention_common.cuh), fp32 FMAs in fp32; accesses to x, y and the
// buffers move 8 or 16 bytes a thread.
//
// STAGE (1-6, compile time) also builds the stage ablation that replaces
// the TPU probe kernel `_kernel` of perf/probe7.py:30 (launched at :128): the
// kernel cut after stage 1 GN1, 2 + qkv, 3 + q softmax, 4 + k path (k's max,
// exp and sum; the ctx products are skipped), 5 + ctx / ctx@Wout / out, and
// 6 the whole block (+ GN2 and the residual).  Stages 1-5 write
// y = x + (what the stage has made), so each depends on every stage it
// keeps; STAGE = 6 is the production kernel, and the `if constexpr` cuts
// leave its code as it was.  Both schedules carry the cuts (the persistent
// one in the instantiation probe 7's shape takes).
//
// This header holds the kernels and their launchers; two sources include it:
// linear_attention_fwd.cu, the production entry points (STAGE 6 only), and
// linear_attention_fwd_probe.cu, probe 7's stage builds.

#pragma once

#include <algorithm>
#include <mutex>

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

// ===================================================================
// The persistent schedule (bf16): see the note at the head of the file.
constexpr int TEAMS_MAX = 2;   // units in flight on an SM
constexpr int MAX_CS = 16;     // CTAs an item (the non-portable cluster size)

// The host side's plan (plan_persistent in ops/linear_attention.py); byte
// offsets into dynamic shared memory, u_* within a team's unit buffers.
struct PersistPlan {
  int cs;          // CTAs an item (a thread-block cluster)
  int rows;        // rows of an item a CTA owns: N / cs
  int qrows;       // rows of the unit's q | k | v: rows up to a multiple of 16
  int teams;       // units in flight: teams of NT threads a block
  int keep_q;      // q in shared memory beside k | v (else in the team's slot of global
                   // scratch, a 64-row tile copied back into k | v's rows for pass 4)
  int stage_w;     // Wqkv^T in shared memory, once per block
  int keep_cw;     // (ctx @ Wout)^T in shared memory (else the team's slot of scratch)
  int keep_out;    // out in shared memory (else in y, read back by GroupNorm 2)
  int off_w;       // Wqkv^T, (384, C + pad)
  int off_bar;     // two mbarriers a team
  int off_unit;    // team t's unit buffers at off_unit + t * unit_bytes
  int unit_bytes;
  int u_qkv;       // q | k | v (or k | v), (qrows, 384 (256) + pad); exp(k - max) replaces k
  int u_a;         // the h tile; the partial ctx (fp32, cs > 1); (ctx @ Wout)^T
  int u_b;         // ctx, (128, 32 + pad); then out, (qrows, C + pad), which outlives it
  int u_vec;       // fp32 vectors
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Make this thread's memory operations, and those it has seen, visible to
// the cluster, then arrive on the mbarrier at shared address `bar` of the
// cluster's CTA `rank`.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, int rank) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "fence.acq_rel.cluster;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n\t}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
// Wait, acquiring at cluster scope, until the phase of parity `parity` of
// this CTA's mbarrier at `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra LAB_WAIT;\n\t}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Bring `bytes` (a multiple of 16) from p (16-byte aligned) into L2: one
// bulk (TMA) request.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

// A team: NT threads of the block on one unit at a time.
struct Team {
  int id;        // 0 .. teams - 1
  int tid;       // the thread's index in the team
  int cs;        // CTAs an item
  uint32_t bar;  // shared address of the team's two mbarriers
  uint32_t n;    // cluster syncs so far
  __device__ __forceinline__ void sync() const { named_sync(1 + id, NT); }
  // Every team of the cluster with this id (one a CTA) has reached this
  // point, and each one's shared-memory writes before it are visible to all:
  // the team's barrier, then thread r arrives on CTA r's mbarrier (the
  // fences and arrivals of the cs threads go out together).  Successive
  // syncs take the two mbarriers in turn, so a peer that arrives for the
  // next sync cannot complete this one's phase early.
  __device__ void cluster_sync() {
    sync();
    if (cs == 1) return;
    const uint32_t b = bar + 8 * (n & 1);
    if (tid < cs) mbar_arrive_remote(b, tid);
    mbar_wait(b, (n >> 1) & 1);
    ++n;
  }
};

// The team's sum of v, in a fixed order, in every thread; `red` holds 8
// floats.
__device__ float team_sum(float v, float* red, const Team& t) {
  v = warp_sum(v);
  t.sync();  // red may still be read by a previous call
  if ((t.tid & 31) == 0) red[t.tid >> 5] = v;
  t.sync();
  float a = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) a += red[w];
  return a;
}

// v (the same in every thread of the team) summed over the cluster's CTAs in
// rank order, through `slot` (at the same offset in every CTA, one call's);
// the peers' values are loaded together, then added.
__device__ float cluster_total(float v, float* slot, Team& t) {
  if (t.cs == 1) return v;
  if (t.tid == 0) *slot = v;
  t.cluster_sync();
  cg::cluster_group cl = cg::this_cluster();
  float part[MAX_CS];
#pragma unroll
  for (int r = 0; r < MAX_CS; ++r) part[r] = r < t.cs ? *cl.map_shared_rank(slot, r) : 0.f;
  float a = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_CS; ++r)
    if (r < t.cs) a += part[r];
  return a;
}

// dst[i] = the max (or sum) over the cluster's CTAs, in rank order, of
// part[i], i < HIDDEN; `part` at the same offset in every CTA.
template <bool MAX>
__device__ void cluster_combine(float* part, float* dst, Team& t) {
  t.cluster_sync();
  if (t.tid < HIDDEN) {
    cg::cluster_group cl = cg::this_cluster();
    float v[MAX_CS];
#pragma unroll
    for (int r = 0; r < MAX_CS; ++r) v[r] = r < t.cs ? cl.map_shared_rank(part, r)[t.tid] : 0.f;
    float a = MAX ? NEG_INF : 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CS; ++r)
      if (r < t.cs) a = MAX ? fmaxf(a, v[r]) : a + v[r];
    dst[t.tid] = a;
  }
  t.sync();
}

// The q softmax of rows [0, rv) of q (row stride ldq, in place), as
// q_softmax_rows (thread t a (row, head), the shift the row max over all 128
// lanes, times `scale`), with the same values rounded at the same points;
// the head's 32 lanes are read again from shared memory in each of its
// three steps instead of held in registers.
__device__ __forceinline__ void team_q_softmax(int t, __nv_bfloat16* q, int ldq, int rv,
                                               float scale) {
  using T = __nv_bfloat16;
  static_assert(NT == TILE_R * 4, "one thread a (row, head) of a tile");
  const int r = t >> 2, hh = t & 3;
  T* h = q + (size_t)r * ldq + hh * DH;
  float m = NEG_INF;
  if (r < rv) {
#pragma unroll
    for (int u = 0; u < DH; u += 4) {
      float v[4];
      load4(h + u, v);
      m = fmaxf(m, fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  if (r < rv) {
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < DH; u += 4) {  // exp, stored as T: the value the sum takes
      float v[4];
      load4(h + u, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = rnd<T>(expf(rnd<T>(v[i] - m)));
        sum += v[i];
      }
      store4(h + u, v);
    }
#pragma unroll
    for (int u = 0; u < DH; u += 4) {
      float v[4];
      load4(h + u, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = v[i] / sum * scale;
      store4(h + u, v);
    }
  }
}

// D = A Bt^T over `rows` (<= TILE_R) rows of A, as product_nt_mma, in
// chunks of CHUNK (32 or 64) rows over the 16-row blocks that hold them: a
// 32-row chunk's sums and fragments fit beside the unit's state in the 128
// registers a thread of a team has wherever the unit's state is large (a
// spill would go to L2: the units leave L1 little room), a 64-row one halves
// the B loads where it fits (the qkv product); a small item's tile skips the
// empty blocks, and A is never read past its rows rounded up to 16.
template <bool HEAD, int CHUNK, typename Epi>
__device__ __forceinline__ void team_product(int warp, const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* Bt, int ldb, int K, int ncols,
                                             int rows, Epi epi) {
  static_assert(CHUNK == 32 || CHUNK == TILE_R, "chunks of 32 or 64 rows");
  const bool as = __isShared(A), bs = __isShared(Bt);
  for (int r0 = 0; r0 < rows; r0 += CHUNK) {
    const int rv = min(CHUNK, rows - r0);
    const __nv_bfloat16* Ah = A + (size_t)r0 * lda;
    auto eh = [&](int r, int j, float v0, float v1) { epi(r0 + r, j, v0, v1); };
#define TP_CALL(MB)                                                                         \
  do {                                                                                      \
    if (as && bs)                                                                           \
      product_nt_mma<HEAD, true, true, MB>(warp, Ah, lda, Bt, ldb, K, ncols, rv, eh);      \
    else if (as)                                                                            \
      product_nt_mma<HEAD, true, false, MB>(warp, Ah, lda, Bt, ldb, K, ncols, rv, eh);     \
    else                                                                                    \
      product_nt_mma<HEAD, false, false, MB>(warp, Ah, lda, Bt, ldb, K, ncols, rv, eh);    \
  } while (0)
    if (rv <= 16) TP_CALL(1);
    else if (CHUNK == 32 || rv <= 32) TP_CALL(2);
    else if (rv <= 48) TP_CALL(3);
    else TP_CALL(4);
#undef TP_CALL
  }
}

// WIDE: the qkv product in whole 64-row tiles, which halves its loads of
// Wqkv^T: where the weight is read from L2 (stage_w 0); where it is staged,
// in 32-row chunks, whose smaller register need keeps the rest of the unit
// out of local memory.  KEEPQ: plan.keep_q, at compile time for the same
// reason.  TEAMS: the most teams a block the build takes; one team alone
// (a launch with no more units than SMs) has all 255 registers a thread.
template <typename T, int STAGE, bool WIDE, bool KEEPQ, int TEAMS>
__global__ void __launch_bounds__(TEAMS * NT, 1)
lin_attn_fwd_persistent_kernel(const T* __restrict__ x, const T* __restrict__ wqkv_t,
                               const T* __restrict__ wout_t, const float* __restrict__ bout,
                               const float* __restrict__ g1s, const float* __restrict__ g1b,
                               const float* __restrict__ g2s, const float* __restrict__ g2b,
                               T* __restrict__ y, T* __restrict__ cw_scratch,
                               T* __restrict__ q_scratch, int B, int N, int C, int Ct, float eps,
                               PersistPlan p) {
  static_assert(IS_BF16<T>, "the persistent schedule is the bf16 forward's");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = PAD<T>;
  constexpr int LC = DH + P;    // row stride of ctx
  const int cs = p.cs;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + p.off_bar);
  if (cs > 1 && (int)threadIdx.x < 2 * p.teams) {
    mbar_init(bars + threadIdx.x, (unsigned)cs);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Wqkv^T, once for every unit the block will take: every copy in flight
  // at once
  if (p.stage_w) {
    T* wst = reinterpret_cast<T*>(smem_raw + p.off_w);
    const int c8 = C / 8;
    for (int i = threadIdx.x; i < QKV * c8; i += blockDim.x) {
      const int r = i / c8, c = (i % c8) * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(wst + (size_t)r * (C + P) + c)),
                   "l"(wqkv_t + (size_t)r * C + c)
                   : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (cs > 1) cg::this_cluster().sync();  // every CTA's mbarriers are set up
  else __syncthreads();

  Team tm{(int)threadIdx.x / NT, (int)threadIdx.x % NT, cs,
          smem_addr(bars + 2 * ((int)threadIdx.x / NT)), 0u};
  const int tid = tm.tid, warp = tid >> 5;
  // The team's buffer at byte offset `off` of its unit's, the address made
  // afresh where it is used (the offset hidden from the compiler), so that
  // no buffer's address holds a register across the unit.
  const int unit0 = p.off_unit + tm.id * p.unit_bytes;
  auto at = [&](int off) -> unsigned char* {
    int o = unit0 + off;
    asm volatile("" : "+r"(o));
    return smem_raw + o;
  };
  auto vec = [&](int off) { return reinterpret_cast<float*>(at(p.u_vec)) + off; };
  // the partial ctx (cs > 1, fp32) and ctx: with q out of shared memory in
  // k | v's rows 64-95 and 96-127, which the ctx sums have consumed (pass 4
  // brings q's tiles there after them); else in their own buffers
  auto ctx_p_at = [&]() -> float* {
    constexpr int KV_ROW = (2 * HIDDEN + P) * (int)sizeof(T);  // a k | v row's bytes
    return reinterpret_cast<float*>(KEEPQ ? at(p.u_a) : at(p.u_qkv) + TILE_R * KV_ROW);
  };
  auto ctxn_at = [&]() -> T* {
    constexpr int KV_ROW = (2 * HIDDEN + P) * (int)sizeof(T);
    return reinterpret_cast<T*>(KEEPQ ? at(p.u_b) : at(p.u_qkv) + (TILE_R + 32) * KV_ROW);
  };
  // the vectors: kmax_p, kmax, ksum_p, ksum, the odd rows' column maxima and
  // sums (128 each; kmax and ksum are the partials' when cs == 1), then red
  // (8 warps), stat (mean1, rstd1) and slots (one float a cluster_total)
  const int V_KMAX = cs > 1 ? HIDDEN : 0, V_KSUM_P = 2 * HIDDEN;
  const int V_KSUM = cs > 1 ? 3 * HIDDEN : V_KSUM_P, V_HALF = 4 * HIDDEN;
  const int V_RED = 5 * HIDDEN, V_STAT = V_RED + 8, V_SLOTS = V_STAT + 2;
  const int R = p.rows, cq = C >> 2;
  // q | k | v in shared memory, or k | v with q in global scratch: the row
  // stride, k's column (v's is HIDDEN on), and where q's row r is
  constexpr bool keep_q = KEEPQ;
  constexpr int LQ = keep_q ? QKV + P : 2 * HIDDEN + P, KC = keep_q ? HIDDEN : 0;
  constexpr int ldqq = keep_q ? LQ : HIDDEN;
  auto q_row = [&](int r) -> T* {
    return keep_q ? reinterpret_cast<T*>(at(p.u_qkv)) + (size_t)r * LQ
                  : q_scratch + ((size_t)blockIdx.x * p.teams + tm.id) * p.qrows * HIDDEN +
                        (size_t)r * HIDDEN;
  };
  const float fnc = (float)N * (float)Ct;
  const bool padded = Ct != C;
  // the units in turn: the first team of every cluster (or block) first,
  // so that a batch of fewer units than clusters spreads over the SMs
  const int groups = gridDim.x / cs;            // clusters (or blocks) of the launch
  const int units = B;                          // a unit an item slice
  const int stride = p.teams * groups;

  const int first = tm.id * groups + (int)blockIdx.x / cs;
  for (int u = first; u < units; u += stride) {
    const int rt = R;                           // the unit's rows in this CTA
    const size_t row0 = (size_t)u * N + (size_t)rank * R;
    if (tm.tid == 0 && u + stride < units)      // the team's next unit's x, into L2
      prefetch_l2(x + ((size_t)(u + stride) * N + (size_t)rank * R) * C,
                  (uint32_t)(R * C * (int)sizeof(T)));
    // out: in shared memory (over ctx, which it outlives), or in y (read
    // back by GroupNorm 2)
    auto out_at = [&]() -> T* {
      return p.keep_out ? reinterpret_cast<T*>(at(p.u_b)) : y + row0 * C;
    };
    const int ldo = p.keep_out ? C + P : C;

    // ---- pass 1: GroupNorm(1) statistics: the mean, then the variance
    // about it, into stat
    {
      const T* xj = x + row0 * C;
      float sum = 0.f;
#pragma unroll 4
      for (int i = tid; i < R * cq; i += NT) {
        float v[4];
        load4(xj + (size_t)(i / cq) * C + (i % cq) * 4, v);
        sum += (v[0] + v[1]) + (v[2] + v[3]);
      }
      const float mean = cluster_total(team_sum(sum, vec(V_RED), tm), vec(V_SLOTS), tm) / fnc;
      sum = 0.f;
#pragma unroll 4
      for (int i = tid; i < R * cq; i += NT) {
        float v[4];
        if (padded && (i % cq) * 4 >= Ct) continue;  // Ct is a multiple of 4
        load4(xj + (size_t)(i / cq) * C + (i % cq) * 4, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = v[e] - mean;
          sum = fmaf(d, d, sum);
        }
      }
      const float var = cluster_total(team_sum(sum, vec(V_RED), tm), vec(V_SLOTS + 1), tm);
      if (tid == 0) {
        float* st = vec(V_STAT);
        st[0] = mean;
        st[1] = rsqrtf(var / fnc + eps);
      }
    }
    tm.sync();  // stat written
    // h = GN1(x) for 4 values of row r from column c on
    auto gn1_4 = [&](int r, int c, float (&h)[4]) {
      const float* st = vec(V_STAT);
      float v[4], sc[4], bi[4];
      load4(x + (row0 + r) * C + c, v);
      load4(g1s + c, sc);
      load4(g1b + c, bi);
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = rnd<T>((v[e] - st[0]) * st[1] * sc[e] + bi[e]);
    };
    if constexpr (STAGE == 1) {  // y = x + GN1(x)
      for (int i = tid; i < rt * cq; i += NT) {
        const int r = i / cq, c = (i % cq) * 4;
        float v[4], h[4];
        load4(x + (row0 + r) * C + c, v);
        gn1_4(r, c, h);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] += v[e];
        store4(y + (row0 + r) * C + c, h);
      }
      continue;
    }

    // ---- pass 2: h = GN1(x) tile by tile, q | k | v = h @ Wqkv
    for (int n0 = 0; n0 < rt; n0 += TILE_R) {
      const int rv = min(TILE_R, rt - n0);
      if (n0 > 0) tm.sync();  // the previous tile's readers are done
      T* tile = reinterpret_cast<T*>(at(p.u_a));
      for (int i = tid; i < rv * cq; i += NT) {
        const int r = i / cq, c = (i % cq) * 4;
        float h[4];
        gn1_4(n0 + r, c, h);
        store4(tile + r * (C + P) + c, h);
      }
      tm.sync();
      T* qrow = reinterpret_cast<T*>(at(p.u_qkv)) + (size_t)n0 * LQ;
      T* qg = q_row(n0);
      const T* wq = p.stage_w ? reinterpret_cast<const T*>(smem_raw + p.off_w) : wqkv_t;
      team_product<false, WIDE ? TILE_R : 32>(warp, tile, C + P, wq, p.stage_w ? C + P : C, C,
                                              QKV, rv,
                          [&](int r, int j, float v0, float v1) {
                            if (keep_q) store2(qrow + (size_t)r * LQ + j, v0, v1);
                            else if (j < HIDDEN) store2(qg + (size_t)r * HIDDEN + j, v0, v1);
                            else store2(qrow + (size_t)r * LQ + j - HIDDEN, v0, v1);
                          });
    }
    {
      // the rows past the unit's own, up to a multiple of 16: zero k and v,
      // which the ctx product sums over
      T* qkv = reinterpret_cast<T*>(at(p.u_qkv));
      for (int i = tid; i < (p.qrows - rt) * (2 * HIDDEN / 8); i += NT) {
        const int r = rt + i / (2 * HIDDEN / 8), c = KC + (i % (2 * HIDDEN / 8)) * 8;
        *reinterpret_cast<uint4*>(qkv + (size_t)r * LQ + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    tm.sync();  // q, k, v visible to the whole team
    // the stage cuts: y = x + f(q | k | v row, lane c % 128)
    auto stage_out = [&](auto f) {
      const T* kv = reinterpret_cast<const T*>(at(p.u_qkv)) + KC;
      for (int i = tid; i < rt * C; i += NT) {
        const int r = i / C, c = i % C;
        y[row0 * C + i] = from_f<T>(to_f(x[row0 * C + i]) +
                                    f(r, q_row(r), kv + (size_t)r * LQ, c % HIDDEN));
      }
    };
    auto qkv_lanes = [&](int, const T* q, const T* kv, int j) {
      return to_f(q[j]) + to_f(kv[j]) + to_f(kv[HIDDEN + j]);
    };
    if constexpr (STAGE == 2) {  // y = x + q + k + v
      stage_out(qkv_lanes);
      continue;
    }

    // q softmax per head, in place: here where q is in shared memory (or for
    // the stage cuts); else on each tile's copy in pass 4
    if (keep_q || STAGE == 3 || STAGE == 4) {
      for (int n0 = 0; n0 < rt; n0 += TILE_R)
        team_q_softmax(tid, q_row(n0), ldqq, min(TILE_R, rt - n0), SCALE);
    }
    if constexpr (STAGE == 3) {  // y = x + qn + k + v
      tm.sync();
      stage_out(qkv_lanes);
      continue;
    }

    // k's per-column max over the item's rows: the even rows', the odd
    // rows', then the two; across the cluster, its CTAs' in rank order.
    // Then k_sum the same way, of exp(k - max), which replaces k.
    const int col = tid % HIDDEN, odd = tid / HIDDEN;
    {
      const T* kc = reinterpret_cast<const T*>(at(p.u_qkv)) + KC + col;
      float m = NEG_INF;
#pragma unroll 8
      for (int n = odd; n < R; n += 2) m = fmaxf(m, to_f(kc[(size_t)n * LQ]));
      vec(odd ? V_HALF : 0)[col] = m;
    }
    tm.sync();
    if (!odd) {
      float* km = vec(0) + col;
      *km = fmaxf(*km, vec(V_HALF)[col]);
    }
    if (cs > 1) cluster_combine<true>(vec(0), vec(V_KMAX), tm);
    else tm.sync();

    // ---- pass 3: exp(k - max) in place
    {
      T* qkv = reinterpret_cast<T*>(at(p.u_qkv));
      const float* kmax = vec(V_KMAX);
      for (int i = tid; i < rt * (HIDDEN / 2); i += NT) {
        const int r = i / (HIDDEN / 2), j = (i % (HIDDEN / 2)) * 2;
        T* kp = qkv + (size_t)r * LQ + KC + j;
        float e0, e1;
        load2(kp, e0, e1);
        e0 = rnd<T>(expf(rnd<T>(e0 - kmax[j])));
        e1 = rnd<T>(expf(rnd<T>(e1 - kmax[j + 1])));
        store2(kp, e0, e1);
      }
    }
    tm.sync();
    {
      const T* kc = reinterpret_cast<const T*>(at(p.u_qkv)) + KC + col;
      float ks = 0.f;
#pragma unroll 8
      for (int n = odd; n < R; n += 2) ks += to_f(kc[(size_t)n * LQ]);
      vec(odd ? V_HALF : V_KSUM_P)[col] = ks;
    }
    tm.sync();
    if (!odd) {
      float* kp = vec(V_KSUM_P) + col;
      *kp = *kp + vec(V_HALF)[col];
    }
    // ctx, the four diagonal 32x32 head blocks of exp(k - max)^T v, as mma
    // accumulators: warp w owns head w / 2, rows (w % 2) * 16 .. + 16 of its
    // block and all 32 columns; (dr, dr + 8) are this thread's ctx rows
    const int lane = tid & 31, head = warp >> 1, tig = lane & 3;
    const int dr = head * DH + (warp & 1) * 16 + (lane >> 2);
    auto ctx_sums = [&](int first, int rows, float (&acc)[4][4]) {
      const T* base = reinterpret_cast<const T*>(at(p.u_qkv)) + (size_t)first * LQ;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i / 4][i % 4] = 0.f;
      tn_accumulate<4>(acc, base + KC, LQ, head * DH + (warp & 1) * 16, base + KC + HIDDEN, LQ,
                       head * DH, rows);
    };
    if (cs > 1) {  // one item: the CTAs' partial blocks go through ctx_p
      if constexpr (STAGE >= 5) {  // (the stage-4 cut still reads k, where ctx_p may lie)
        float macc[4][4];
        ctx_sums(0, p.qrows, macc);
        if (!keep_q) tm.sync();  // every warp's sums are done with k | v's rows
        float* ctx_p = ctx_p_at();
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int e = ni * 8 + 2 * tig;
          ctx_p[dr * DH + e] = macc[ni][0];
          ctx_p[dr * DH + e + 1] = macc[ni][1];
          ctx_p[(dr + 8) * DH + e] = macc[ni][2];
          ctx_p[(dr + 8) * DH + e + 1] = macc[ni][3];
        }
      }
      cluster_combine<false>(vec(V_KSUM_P), vec(V_KSUM), tm);  // its sync covers ctx_p too
    } else {
      tm.sync();
    }
    // ctx_w's operand Wout^T, (C, 128): where C <= 128, copied into k | v's
    // columns, which the ctx sums have consumed (Wout^T row c at row c % 64,
    // k's columns for c < 64, v's after), so that its product reads shared
    // memory and not L2 a step at a time
    const bool wo_smem = C <= 2 * TILE_R && min(C, TILE_R) <= p.qrows;
    auto stage_wout = [&]() {
      T* qkv = reinterpret_cast<T*>(at(p.u_qkv));
      for (int i = tid; i < C * (HIDDEN / 8); i += NT) {
        const int c = i / (HIDDEN / 8), k8 = (i % (HIDDEN / 8)) * 8;
        *reinterpret_cast<uint4*>(qkv + (size_t)(c % TILE_R) * LQ + KC + HIDDEN * (c / TILE_R) +
                                  k8) = *reinterpret_cast<const uint4*>(wout_t + (size_t)c * HIDDEN + k8);
      }
    };
    if constexpr (STAGE == 4) {  // y = x + qn + kn + v
      stage_out([&](int r, const T* q, const T* kv, int j) {
        const float kn = rnd<T>(to_f(kv[j]) / vec(V_KSUM)[j]);
        return to_f(q[j]) + kn + to_f(kv[HIDDEN + j]);
      });
      continue;
    }
    if (cs > 1 && wo_smem) stage_wout();  // the ctx exchange's sync orders it

    const int ldcw = p.keep_cw ? HIDDEN + P : HIDDEN;
    {
      // the item's ctx: the sums rounded to T, times 1/k_sum of their row,
      // rounded to T again
      if (cs > 1) {
        // the cluster's partials in rank order: each CTA adds up its 1 / cs
        // of the entries, a thread an entry and the peers' loads together,
        // and writes them into every CTA's ctx
        const int share = HIDDEN * DH / cs;
        cg::cluster_group cl = cg::this_cluster();
        for (int i = rank * share + tid; i < (rank + 1) * share; i += NT) {
          const float* ctx_p = ctx_p_at();
          float v[MAX_CS];
#pragma unroll
          for (int r = 0; r < MAX_CS; ++r)
            v[r] = r < cs ? cl.map_shared_rank(ctx_p, r)[i] : 0.f;
          float t = 0.f;
#pragma unroll
          for (int r = 0; r < MAX_CS; ++r)
            if (r < cs) t += v[r];
          const int d = i / DH;
          const T c = from_f<T>(rnd<T>(t) * (1.f / vec(V_KSUM)[d]));
          T* ctxn = ctxn_at() + d * LC + i % DH;
          for (int r = 0; r < cs; ++r) *cl.map_shared_rank(ctxn, r) = c;
        }
        tm.cluster_sync();  // ctx written everywhere; the peers are done with ctx_p
      } else {
        float macc[4][4];
        ctx_sums(0, p.qrows, macc);
        if (!keep_q) tm.sync();  // every warp's sums are done with k | v's rows
        const float* ks = vec(V_KSUM);
        const float inv0 = 1.f / ks[dr], inv1 = 1.f / ks[dr + 8];
        T* ctxn = ctxn_at();
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int e = ni * 8 + 2 * tig;
          store2(ctxn + dr * LC + e, rnd<T>(macc[ni][0]) * inv0, rnd<T>(macc[ni][1]) * inv0);
          store2(ctxn + (dr + 8) * LC + e, rnd<T>(macc[ni][2]) * inv1,
                 rnd<T>(macc[ni][3]) * inv1);
        }
        tm.sync();  // ctx written
        if (wo_smem) {  // every warp's ctx sums are done with k and v
          stage_wout();
          tm.sync();
        }
      }
      // ctx_w^T = (ctx @ Wout)^T, (C, 128): column d of head h meets Wout
      // rows h*32 .. h*32+31
      auto cwt_at = [&]() -> T* {
        return p.keep_cw ? reinterpret_cast<T*>(at(p.u_a))
                         : cw_scratch + ((size_t)blockIdx.x * p.teams + tm.id) * C * HIDDEN;
      };
      for (int c0 = 0; c0 < C; c0 += TILE_R) {
        T* crow = cwt_at() + (size_t)c0 * ldcw;
        const T* wo = wo_smem ? reinterpret_cast<const T*>(at(p.u_qkv)) + KC + HIDDEN * (c0 / TILE_R)
                              : wout_t + (size_t)c0 * HIDDEN;
        team_product<true, 32>(warp, wo, wo_smem ? LQ : HIDDEN,
                               ctxn_at(), LC, DH, HIDDEN,
                               min(TILE_R, C - c0), [&](int r, int d, float v0, float v1) {
                                 store2(crow + (size_t)r * ldcw + d, v0, v1);
                               });
      }
      tm.sync();
      // ---- pass 4: out = qn @ ctx_w + bout over the unit's rows
      for (int n0 = 0; n0 < R; n0 += TILE_R) {
        const int rv = min(TILE_R, R - n0);
        const T* qa = reinterpret_cast<const T*>(at(p.u_qkv)) + (size_t)n0 * LQ;
        if (!keep_q) {
          // the tile's q, from global scratch into k | v's rows 64 on (the
          // ctx sums are done with them; Wout^T lies in rows 0-63), then its
          // softmax
          T* qt = reinterpret_cast<T*>(at(p.u_qkv)) + (size_t)TILE_R * LQ;
          const T* qg = q_row(n0);
          if (n0 > 0) tm.sync();  // the previous tile's product is done with qt
          for (int i = tid; i < rv * (HIDDEN / 8); i += NT) {
            const int r = i / (HIDDEN / 8), k8 = (i % (HIDDEN / 8)) * 8;
            *reinterpret_cast<uint4*>(qt + (size_t)r * LQ + k8) =
                *reinterpret_cast<const uint4*>(qg + (size_t)r * HIDDEN + k8);
          }
          tm.sync();
          team_q_softmax(tid, qt, LQ, rv, SCALE);
          tm.sync();
          qa = qt;
        }
        T* orow = out_at() + (size_t)n0 * ldo;
        team_product<false, 32>(warp, qa, LQ, cwt_at(), ldcw, HIDDEN, C, rv,
                            [&](int r, int c, float v0, float v1) {
                              const float o0 = rnd<T>(rnd<T>(v0) + rnd<T>(bout[c]));
                              const float o1 = rnd<T>(rnd<T>(v1) + rnd<T>(bout[c + 1]));
                              store2(orow + (size_t)r * ldo + c, o0, o1);
                            });
      }
    }
    tm.sync();  // out visible to the whole team
    if constexpr (STAGE == 5) {  // y = x + out
      const T* outb = out_at();
      for (int i = tid; i < rt * cq; i += NT) {
        const int r = i / cq, c = (i % cq) * 4;
        float v[4], o[4];
        load4(x + (row0 + r) * C + c, v);
        load4(outb + (size_t)r * ldo + c, o);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] += v[e];
        store4(y + (row0 + r) * C + c, o);
      }
      continue;
    }

    // ---- pass 5: GroupNorm(2) of out: the mean, the variance about it,
    // then y = x + GN2(out)
    {
      const T* oj = out_at();
      float sum = 0.f;
#pragma unroll 4
      for (int i = tid; i < R * cq; i += NT) {
        float o[4];
        load4(oj + (size_t)(i / cq) * ldo + (i % cq) * 4, o);
        sum += (o[0] + o[1]) + (o[2] + o[3]);
      }
      const float mean =
          cluster_total(team_sum(sum, vec(V_RED), tm), vec(V_SLOTS + 2), tm) / fnc;
      sum = 0.f;
      oj = out_at();
#pragma unroll 4
      for (int i = tid; i < R * cq; i += NT) {
        float o[4];
        if (padded && (i % cq) * 4 >= Ct) continue;
        load4(oj + (size_t)(i / cq) * ldo + (i % cq) * 4, o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = o[e] - mean;
          sum = fmaf(d, d, sum);
        }
      }
      const float rstd =
          rsqrtf(cluster_total(team_sum(sum, vec(V_RED), tm), vec(V_SLOTS + 3), tm) / fnc + eps);
      oj = out_at();
      const size_t xrow = row0;
#pragma unroll 4
      for (int i = tid; i < R * cq; i += NT) {
        const int r = i / cq, c = (i % cq) * 4;
        float v[4], o[4], sc[4], bi[4];
        load4(x + (xrow + r) * C + c, v);
        load4(oj + (size_t)r * ldo + c, o);
        load4(g2s + c, sc);
        load4(g2b + c, bi);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = v[e] + ((o[e] - mean) * rstd * sc[e] + bi[e]);
        store4(y + (xrow + r) * C + c, o);
      }
    }
  }
  if (cs > 1) cg::this_cluster().sync();  // the peers read this CTA's buffers until here
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

constexpr int N_PPLAN = 16;  // ints of a PersistPlan

// What a device can run of a persistent launch shape, asked once: the SMs,
// and the clusters of cs blocks (teams x NT threads, smem bytes) that fit at
// once.  Guarded: the launchers are called from several host threads.
struct Resident {
  int dev, cs, teams, smem, clusters;
};

template <int STAGE, bool WIDE, bool KEEPQ, int TEAMS>
cudaError_t resident_clusters(int dev, int cs, int teams, int smem, int* clusters) {
  using T = __nv_bfloat16;
  static std::mutex mu;
  static Resident seen[256];
  static int n_seen = 0;
  static bool raised[MAX_DEVICES] = {};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].dev == dev && seen[i].cs == cs && seen[i].teams == teams &&
        seen[i].smem == smem) {
      *clusters = seen[i].clusters;
      return cudaSuccess;
    }
  auto kernel = lin_attn_fwd_persistent_kernel<T, STAGE, WIDE, KEEPQ, TEAMS>;
  cudaError_t err = cudaSuccess;
  if (dev >= MAX_DEVICES || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) raised[dev] = true;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int n = sms;  // blocks of one CTA: one a SM
  if (cs > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cs);
    cfg.blockDim = dim3((unsigned)(teams * NT));
    cfg.dynamicSmemBytes = (size_t)smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    n = std::min(n, sms / cs);  // at most one block a SM
  }
  if (n_seen < 256) seen[n_seen++] = {dev, cs, teams, smem, n};
  *clusters = n;
  return cudaSuccess;
}

template <int STAGE, bool WIDE, bool KEEPQ, int TEAMS>
int launch_persistent(const void* x, const void* wqkv_t, const void* wout_t, const float* bout,
                      const float* g1s, const float* g1b, const float* g2s, const float* g2b,
                      void* y, void* cw_scratch, void* q_scratch, int scratch_slots, int B, int N,
                      int C, int Ct, float eps, const int* plan, int smem_bytes,
                      cudaStream_t stream) {
  using T = __nv_bfloat16;
  PersistPlan p;
  static_assert(sizeof(PersistPlan) == N_PPLAN * sizeof(int), "PersistPlan is N_PPLAN ints");
  int* pi = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PPLAN; ++i) pi[i] = plan[i];
  const bool cs_ok = p.cs == 1 || p.cs == 2 || p.cs == 4 || p.cs == 8 || p.cs == 16;
  if (B < 1 || N < 1 || C < 16 || C % 16 || Ct < 8 || Ct % 8 || Ct > C || C - Ct >= 16 ||
      !cs_ok || p.rows * p.cs != N || p.qrows != (p.rows + 15) / 16 * 16 ||
      p.teams < 1 || p.teams > TEAMS || smem_bytes < 0 || smem_bytes > SMEM_LIMIT ||
      (!p.keep_cw && cw_scratch == nullptr) ||
      p.keep_q != (int)KEEPQ || p.stage_w == (int)WIDE ||
      (!p.keep_q && (q_scratch == nullptr || p.qrows < 2 * TILE_R)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = resident_clusters<STAGE, WIDE, KEEPQ, TEAMS>(dev, p.cs, p.teams, smem_bytes, &clusters);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  // as many clusters as there are units (items), up to what the card holds at once
  const int groups = std::min(clusters, B);
  if ((!p.keep_cw || !p.keep_q) && groups * p.cs * p.teams > scratch_slots)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * p.cs));
  cfg.blockDim = dim3((unsigned)(p.teams * NT));
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
      &cfg, lin_attn_fwd_persistent_kernel<T, STAGE, WIDE, KEEPQ, TEAMS>, static_cast<const T*>(x),
      static_cast<const T*>(wqkv_t), static_cast<const T*>(wout_t), bout, g1s, g1b, g2s, g2b,
      static_cast<T*>(y), static_cast<T*>(cw_scratch), static_cast<T*>(q_scratch), B, N, C, Ct,
      eps, p);
  if (lerr != cudaSuccess) return (int)lerr;
  return (int)cudaGetLastError();
}

}  // namespace
