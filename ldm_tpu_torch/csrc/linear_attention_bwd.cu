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
// grads.  T (float or bf16) is the compute type and the type of x, dy and dx;
// every value the plain version rounds to T is rounded to T at the same
// point, sums are fp32, weights and norm vectors fp32.
//
// What bounds it: like the forward, every intermediate is an (N, 128) or
// (N, C) slab per item, and five reductions over all N rows of an item sit
// between the products (GN1 stats, k's max and sum, GN2 stats, GN2's and
// GN1's backward means, the k-softmax column sums of kn*dkn), so it is bound
// by memory traffic and by the serial chain of passes, not by arithmetic.
// The design:
//   * the TPU kernel added the weight grads of all items in place across its
//     grid, race-free only because a TPU grid runs in order.  Here CTAs run
//     at once, and no atomics are used, so the sums keep a fixed order and
//     two runs give bit-identical grads.  Three launches:
//       1. lin_attn_bwd_item_kernel, one CTA per item (so each per-item
//          reduction stays in one CTA, a fixed-order tree), writes dx, the
//          item's partial dWout (128 x C) and five partial C-vectors (dbout,
//          dg1s, dg1b, dg2s, dg2b), and d[q k v] (N, 384) in T;
//       2. lin_attn_bwd_wqkv_kernel computes dWqkv = h^T d[q k v] over all
//          B*N rows: each CTA owns a 64 x 64 tile of the (C, 384) output and
//          one of S fixed row ranges (split-K, S from the shape alone), h
//          recomputed from x and the item's GN1 stats;
//       3. lin_attn_bwd_finalize_kernel sums the S dWqkv partials and the B
//          per-item partials, each in index order.
//     The split-K buffer is S x C x 384 fp32, about 4.5 MB at every site,
//     instead of B x C x 384 (50 MB at C=512, B=64).
//   * one item does not fit in shared memory (x alone is 128 KiB in bf16 at
//     (1024, 64)), so the item kernel walks 64-row tiles in passes over
//     global scratch the wrapper allocates.  Recompute or keep: q, k, v are
//     recomputed once (the forward's pass) and kept as qn, kn, v in a
//     (B, N, 384) scratch in T (768 B a row in bf16); o, then dh, in a
//     (B, N, C) fp32 scratch (4C B a row); do in (B, N, C) in T, for
//     dcw = qn^T do; d[q k v] in a second (B, N, 384) scratch in T, read by
//     launch 2.  dkn (32 FMAs an entry) is recomputed in the two passes that
//     need it rather than stored.  At (1024, 64), B=64 in bf16 that is
//     50 + 17 + 8 + 50 MB of scratch.
//   * the products keep an 8x4 or 4x4 block of outputs per thread in
//     registers and read shared memory as float4 broadcasts (the forward's
//     tile_matmul), CUDA cores and fp32 FMAs only; wgmma, TMA and several
//     CTAs per item are later work.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "linear_attention_common.cuh"

namespace {

constexpr int MAX_C = 512;             // widest C: the 64 x (C + 128) fp32 tile
constexpr int KC = MAX_C / NT;         // channels per thread when C > NT
constexpr int MAX_DEVICES = 64;
constexpr int WT = 64;                 // dWqkv output tile: WT x WT
constexpr int WT_R = 32;               // rows per step of the dWqkv walk
constexpr int TARGET_CTAS = 264;       // dWqkv CTAs to aim for: 2 per SM
constexpr int MIN_SPLIT_ROWS = 256;    // fewest rows one dWqkv CTA walks
constexpr float SCALE = 0.17677669529663688f;  // dim_head ** -0.5

// h = GN1(x) in T, as the forward's pass 2 computes it.
template <typename T>
__device__ __forceinline__ float gn1_h(float xv, float mean, float rstd, float s, float b) {
  return rnd<T>((xv - mean) * rstd * s + b);
}

// Per-channel sums over an item's N rows, in a fixed order.  f(n, c, acc)
// adds its NQ terms for element (n, c) into acc[0..NQ); out[q * C + c]
// receives the sums.  Channels go to threads (row groups of C threads when
// C <= NT, summed in group order through `sred`, NT floats).  f may also
// add to per-thread sums of its own: every element is visited once.
template <int NQ, typename F>
__device__ void column_sums(int N, int C, float* sred, float* __restrict__ out, F f) {
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
      if (c < C)
        for (int n = g; n < N; n += rg) f(n, c, acc[k]);
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

template <typename T>
__global__ void __launch_bounds__(NT)
lin_attn_bwd_item_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ wqkv, const float* __restrict__ wout,
                         const float* __restrict__ bout, const float* __restrict__ g1s,
                         const float* __restrict__ g1b, const float* __restrict__ g2s,
                         const float* __restrict__ g2b, const float* __restrict__ wqkv_t,
                         T* __restrict__ dx, T* __restrict__ qkv_s, T* __restrict__ dqkv_s,
                         float* __restrict__ o_s, T* __restrict__ do_s, T* __restrict__ cw_s,
                         T* __restrict__ cwt_s, float* __restrict__ stats,
                         float* __restrict__ pvec, float* __restrict__ pwout,
                         int N, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  // shared layout: tile | ctx | dctx | kmax | ksum | inner | sred | red
  const int tile_floats = TILE_R * (C + HIDDEN > QKV ? C + HIDDEN : QKV);
  float* tile = smem;
  float* ctxn = tile + tile_floats;      // HIDDEN x DH: the 4 head blocks of ctx
  float* dctx = ctxn + HIDDEN * DH;      // HIDDEN x DH
  float* kmax = dctx + HIDDEN * DH;      // HIDDEN
  float* ksum = kmax + HIDDEN;           // HIDDEN
  float* inner = ksum + HIDDEN;          // HIDDEN
  float* sred = inner + HIDDEN;          // NT
  float* red = sred + NT;                // NT / 32

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t nc = (size_t)N * C;
  const T* xb = x + (size_t)b * nc;
  const T* dyb = dy + (size_t)b * nc;
  T* dxb = dx + (size_t)b * nc;
  T* qkv = qkv_s + (size_t)b * N * QKV;
  T* dqkv = dqkv_s + (size_t)b * N * QKV;
  float* ob = o_s + (size_t)b * nc;
  T* dob = do_s + (size_t)b * nc;
  T* cw = cw_s + (size_t)b * HIDDEN * C;
  T* cwt = cwt_s + (size_t)b * C * HIDDEN;
  float* pv = pvec + (size_t)b * 5 * C;  // dbout | dg1s | dg1b | dg2s | dg2b
  float* pw = pwout + (size_t)b * HIDDEN * C;
  const float fnc = (float)nc;

  // ---- GN1 statistics of x, fp32, two passes
  float s = 0.f;
  for (size_t i = tid; i < nc; i += NT) s += to_f(xb[i]);
  const float mean1 = block_sum(s, red) / fnc;
  s = 0.f;
  for (size_t i = tid; i < nc; i += NT) {
    const float d = to_f(xb[i]) - mean1;
    s = fmaf(d, d, s);
  }
  const float rstd1 = rsqrtf(block_sum(s, red) / fnc + eps);
  if (tid == 0) {
    stats[2 * b] = mean1;
    stats[2 * b + 1] = rstd1;
  }

  // ---- forward recompute: q, k, v = GN1(x) @ Wqkv into the scratch
  for (int n0 = 0; n0 < N; n0 += TILE_R) {
    const int rv = min(TILE_R, N - n0);
    __syncthreads();
    for (int i = tid; i < rv * C; i += NT) {
      const int c = i % C;
      tile[i] = gn1_h<T>(to_f(xb[(size_t)n0 * C + i]), mean1, rstd1, g1s[c], g1b[c]);
    }
    __syncthreads();
    tile_matmul<8, T>(tile, C, C, wqkv, QKV, QKV, rv, [&](int r, int j, float acc) {
      qkv[(size_t)(n0 + r) * QKV + j] = from_f<T>(acc);
    });
  }
  __syncthreads();

  // k's column max, then the column sums of exp(k - max), in two row-parity
  // halves added in a fixed order
  {
    const int j = tid % HIDDEN, half = tid / HIDDEN;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int n = half; n < N; n += NT / HIDDEN)
      m = fmaxf(m, to_f(qkv[(size_t)n * QKV + HIDDEN + j]));
    if (half == 1) kmax[j] = m;
    __syncthreads();
    if (half == 0) kmax[j] = fmaxf(m, kmax[j]);
    __syncthreads();
    float e = 0.f;
    for (int n = half; n < N; n += NT / HIDDEN)
      e += rnd<T>(expf(rnd<T>(to_f(qkv[(size_t)n * QKV + HIDDEN + j]) - kmax[j])));
    if (half == 1) ksum[j] = e;
    __syncthreads();
    if (half == 0) ksum[j] = e + ksum[j];
  }

  // ---- qn over q, kn over k, and ctx = kn^T v (four 32x32 head blocks).
  // Thread t owns head t / 64, ctx row (t % 64) / 2 of it and 16 columns.
  const int ch = tid / 64, cd_ = (tid % 64) / 2, ce0 = (tid % 2) * 16;
  {
    float cacc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) cacc[i] = 0.f;
    float* kn_t = tile;                    // TILE_R x 128
    float* v_t = tile + TILE_R * HIDDEN;   // TILE_R x 128
    for (int n0 = 0; n0 < N; n0 += TILE_R) {
      const int rv = min(TILE_R, N - n0);
      __syncthreads();  // ksum written; the previous tile's readers done
      for (int i = tid; i < rv * HIDDEN; i += NT) {
        const int r = i / HIDDEN, j = i % HIDDEN;
        T* row = qkv + (size_t)(n0 + r) * QKV;
        const float e = rnd<T>(expf(rnd<T>(to_f(row[HIDDEN + j]) - kmax[j])));
        const float kn = rnd<T>(e / ksum[j]);
        kn_t[i] = kn;
        row[HIDDEN + j] = from_f<T>(kn);
        v_t[i] = to_f(row[2 * HIDDEN + j]);
      }
      // q softmax per head over its 32 lanes, shifted by the row max: a warp
      // per row, lane l holds lane l of each head; qn written over q
      for (int r = warp; r < rv; r += NT / 32) {
        T* row = qkv + (size_t)(n0 + r) * QKV;
        float qv[4];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) qv[hh] = to_f(row[hh * DH + lane]);
        const float m = warp_max(fmaxf(fmaxf(qv[0], qv[1]), fmaxf(qv[2], qv[3])));
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          const float e = rnd<T>(expf(rnd<T>(qv[hh] - m)));
          const float sum = warp_sum(e);
          row[hh * DH + lane] = from_f<T>(e / sum * SCALE);
        }
      }
      __syncthreads();
      const int kcol = ch * DH + cd_;
      for (int r = 0; r < rv; ++r) {
        const float kv = kn_t[r * HIDDEN + kcol];
        const float4* vr = reinterpret_cast<const float4*>(v_t + r * HIDDEN + ch * DH + ce0);
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
#pragma unroll
    for (int i = 0; i < 16; ++i) ctxn[(ch * DH + cd_) * DH + ce0 + i] = rnd<T>(cacc[i]);
  }
  __syncthreads();

  // ---- cw = ctx @ Wout (128, C) and its transpose (C, 128), in T
  for (int w = tid; w < HIDDEN * C; w += NT) {
    const int d = w / C, c = w % C;
    const float* cr = ctxn + d * DH;
    const float* wc = wout + (size_t)(d / DH) * DH * C + c;
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < DH; ++e) acc = fmaf(cr[e], rnd<T>(wc[(size_t)e * C]), acc);
    const T v = from_f<T>(acc);
    cw[w] = v;
    cwt[(size_t)c * HIDDEN + d] = v;
  }
  __syncthreads();

  // ---- o = qn @ cw + bout, fp32, into the o scratch; GN2 statistics
  s = 0.f;
  for (int n0 = 0; n0 < N; n0 += TILE_R) {
    const int rv = min(TILE_R, N - n0);
    __syncthreads();
    for (int i = tid; i < rv * HIDDEN; i += NT)
      tile[i] = to_f(qkv[(size_t)(n0 + i / HIDDEN) * QKV + i % HIDDEN]);
    __syncthreads();
    tile_matmul<4, T>(tile, HIDDEN, HIDDEN, cw, C, C, rv, [&](int r, int c, float acc) {
      const float o = acc + bout[c];
      ob[(size_t)(n0 + r) * C + c] = o;
      s += o;
    });
  }
  const float mean2 = block_sum(s, red) / fnc;  // its barrier orders the o writes
  s = 0.f;
  for (size_t i = tid; i < nc; i += NT) {
    const float d = ob[i] - mean2;
    s = fmaf(d, d, s);
  }
  const float rstd2 = rsqrtf(block_sum(s, red) / fnc + eps);

  // ---- GN2 backward: dg2s, dg2b per channel; the item's means of dy*g2s
  // and dy*g2s*ohat
  float sa = 0.f, sb = 0.f;
  column_sums<2>(N, C, sred, pv + 3 * C, [&](int n, int c, float* a) {
    const size_t i = (size_t)n * C + c;
    const float dv = to_f(dyb[i]);
    const float oh = (ob[i] - mean2) * rstd2;
    a[0] = fmaf(dv, oh, a[0]);
    a[1] += dv;
    const float d = dv * g2s[c];
    sa += d;
    sb = fmaf(d, oh, sb);
  });
  const float m1 = block_sum(sa, red) / fnc;
  const float m2 = block_sum(sb, red) / fnc;
  auto do_at = [&](size_t i, int c) {
    return (to_f(dyb[i]) * g2s[c] - m1 - (ob[i] - mean2) * rstd2 * m2) * rstd2;
  };
  column_sums<1>(N, C, sred, pv, [&](int n, int c, float* a) {
    a[0] += do_at((size_t)n * C + c, c);
  });

  // ---- do in T (tile and scratch), dqn = do @ cw^T, then
  // dq = qn * (dqn - ((qn*dqn) @ seg) / scale) into d[q k v]
  {
    float* dqn_t = tile + TILE_R * C;  // TILE_R x 128
    for (int n0 = 0; n0 < N; n0 += TILE_R) {
      const int rv = min(TILE_R, N - n0);
      __syncthreads();
      for (int i = tid; i < rv * C; i += NT) {
        const size_t gi = (size_t)n0 * C + i;
        const float v = rnd<T>(do_at(gi, i % C));
        tile[i] = v;
        dob[gi] = from_f<T>(v);
      }
      __syncthreads();
      tile_matmul<4, T>(tile, C, C, cwt, HIDDEN, HIDDEN, rv, [&](int r, int d, float acc) {
        dqn_t[r * HIDDEN + d] = acc;
      });
      __syncthreads();
      for (int r = warp; r < rv; r += NT / 32) {
        const T* qrow = qkv + (size_t)(n0 + r) * QKV;
        T* drow = dqkv + (size_t)(n0 + r) * QKV;
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) {
          const float qv = to_f(qrow[hh * DH + lane]);
          const float g = dqn_t[r * HIDDEN + hh * DH + lane];
          const float rowdot = warp_sum(rnd<T>(qv * g));
          drow[hh * DH + lane] = from_f<T>(qv * (g - rowdot / SCALE));
        }
      }
    }
  }
  __syncthreads();

  // ---- dcw = qn^T @ do over all N rows, rounded to T, over cw (no longer
  // needed).  Each work item is an 8 x 4 block of the (128, C) output.
  {
    const int cg = C / CPT;
    for (int w = tid; w < (HIDDEN / 8) * cg; w += NT) {
      const int d0 = (w / cg) * 8, c0 = (w % cg) * CPT;
      float acc[8][CPT];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[2][CPT], bv[CPT];
        load4<T>(qkv + (size_t)n * QKV + d0, a[0]);
        load4<T>(qkv + (size_t)n * QKV + d0 + 4, a[1]);
        load4<T>(dob + (size_t)n * C + c0, bv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i / 4][i % 4], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) cw[(size_t)(d0 + i) * C + c0 + j] = from_f<T>(acc[i][j]);
    }
  }
  __syncthreads();

  // ---- dctx = (dcw @ Wout^T) on the head blocks, rounded to T; 32-column
  // chunks of dcw and Wout staged in shared memory (rows padded to 33)
  {
    float* dc_s = tile;                  // HIDDEN x 33
    float* wo_s = tile + HIDDEN * 33;    // HIDDEN x 33
    float acc[HIDDEN * DH / NT];
#pragma unroll
    for (int k = 0; k < HIDDEN * DH / NT; ++k) acc[k] = 0.f;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int cv = min(32, C - c0);
      __syncthreads();
      for (int i = tid; i < HIDDEN * 32; i += NT) {
        const int r = i / 32, cc = i % 32;
        const bool ok = cc < cv;
        dc_s[r * 33 + cc] = ok ? to_f(cw[(size_t)r * C + c0 + cc]) : 0.f;
        wo_s[r * 33 + cc] = ok ? rnd<T>(wout[(size_t)r * C + c0 + cc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < HIDDEN * DH / NT; ++k) {
        const int w = tid + k * NT;
        const int d = w / DH, e = (d / DH) * DH + w % DH;
        for (int cc = 0; cc < cv; ++cc)
          acc[k] = fmaf(dc_s[d * 33 + cc], wo_s[e * 33 + cc], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < HIDDEN * DH / NT; ++k) dctx[tid + k * NT] = rnd<T>(acc[k]);
  }

  // ---- the item's dWout = ctx^T @ dcw on the head blocks, fp32
  for (int w = tid; w < HIDDEN * C; w += NT) {
    const int e = w / C, c = w % C;
    const int d0 = (e / DH) * DH;
    float acc = 0.f;
    for (int i = 0; i < DH; ++i)
      acc = fmaf(ctxn[(d0 + i) * DH + e % DH], to_f(cw[(size_t)(d0 + i) * C + c]), acc);
    pw[w] = acc;
  }
  __syncthreads();

  // ---- k side: dkn = v @ dctx^T (row d of dctx), dv = kn @ dctx (column e).
  // Thread t owns column t % 128 and the rows of parity t / 128; pass 0 sums
  // inner = colsum_N(kn * dkn) and writes dv, pass 1 writes
  // dk = kn * (dkn - inner).
  {
    const int d = tid % HIDDEN, half = tid / HIDDEN, h0 = (d / DH) * DH;
    float da[DH], db[DH];
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      da[i] = dctx[d * DH + i];
      db[i] = dctx[(h0 + i) * DH + d % DH];
    }
    float* kn_t = tile;                    // TILE_R x 128
    float* v_t = tile + TILE_R * HIDDEN;   // TILE_R x 128
    for (int pass = 0; pass < 2; ++pass) {
      float in_acc = 0.f;
      for (int n0 = 0; n0 < N; n0 += TILE_R) {
        const int rv = min(TILE_R, N - n0);
        __syncthreads();
        for (int i = tid; i < rv * HIDDEN; i += NT) {
          const T* row = qkv + (size_t)(n0 + i / HIDDEN) * QKV;
          kn_t[i] = to_f(row[HIDDEN + i % HIDDEN]);
          v_t[i] = to_f(row[2 * HIDDEN + i % HIDDEN]);
        }
        __syncthreads();
        for (int r = half; r < rv; r += NT / HIDDEN) {
          const float4* vr = reinterpret_cast<const float4*>(v_t + r * HIDDEN + h0);
          float dkn = 0.f;
#pragma unroll
          for (int i = 0; i < DH / 4; ++i) {
            const float4 v4 = vr[i];
            dkn = fmaf(v4.x, da[4 * i], dkn);
            dkn = fmaf(v4.y, da[4 * i + 1], dkn);
            dkn = fmaf(v4.z, da[4 * i + 2], dkn);
            dkn = fmaf(v4.w, da[4 * i + 3], dkn);
          }
          const float kn = kn_t[r * HIDDEN + d];
          T* drow = dqkv + (size_t)(n0 + r) * QKV;
          if (pass == 0) {
            in_acc = fmaf(kn, dkn, in_acc);
            const float4* kr = reinterpret_cast<const float4*>(kn_t + r * HIDDEN + h0);
            float dv = 0.f;
#pragma unroll
            for (int i = 0; i < DH / 4; ++i) {
              const float4 k4 = kr[i];
              dv = fmaf(k4.x, db[4 * i], dv);
              dv = fmaf(k4.y, db[4 * i + 1], dv);
              dv = fmaf(k4.z, db[4 * i + 2], dv);
              dv = fmaf(k4.w, db[4 * i + 3], dv);
            }
            drow[2 * HIDDEN + d] = from_f<T>(dv);
          } else {
            drow[HIDDEN + d] = from_f<T>(kn * (dkn - inner[d]));
          }
        }
      }
      if (pass == 0) {
        __syncthreads();
        if (half == 1) inner[d] = in_acc;
        __syncthreads();
        if (half == 0) inner[d] = in_acc + inner[d];
      }
    }
  }
  __syncthreads();

  // ---- dh = d[q k v] @ Wqkv^T, fp32, over the o scratch
  for (int n0 = 0; n0 < N; n0 += TILE_R) {
    const int rv = min(TILE_R, N - n0);
    __syncthreads();
    for (int i = tid; i < rv * QKV; i += NT)
      tile[i] = to_f(dqkv[(size_t)n0 * QKV + i]);
    __syncthreads();
    tile_matmul<4, T>(tile, QKV, QKV, wqkv_t, C, C, rv, [&](int r, int c, float acc) {
      ob[(size_t)(n0 + r) * C + c] = acc;
    });
  }
  __syncthreads();

  // ---- GN1 backward: dg1s, dg1b per channel; the item's means; dx
  sa = sb = 0.f;
  column_sums<2>(N, C, sred, pv + C, [&](int n, int c, float* a) {
    const size_t i = (size_t)n * C + c;
    const float dh = ob[i];
    const float xh = (to_f(xb[i]) - mean1) * rstd1;
    a[0] = fmaf(dh, xh, a[0]);
    a[1] += dh;
    const float d = dh * g1s[c];
    sa += d;
    sb = fmaf(d, xh, sb);
  });
  const float n1 = block_sum(sa, red) / fnc;
  const float n2 = block_sum(sb, red) / fnc;
  for (size_t i = tid; i < nc; i += NT) {
    const int c = (int)(i % C);
    const float xh = (to_f(xb[i]) - mean1) * rstd1;
    dxb[i] = from_f<T>(to_f(dyb[i]) + (ob[i] * g1s[c] - n1 - xh * n2) * rstd1);
  }
}

// dWqkv partials: CTA (ct, jt, sp) sums h[R, c] * d[q k v][R, j] over rows
// R of range sp, for c in tile ct and j in tile jt (64 x 64; a thread owns
// 4 x 4), walking WT_R rows at a time in order.
template <typename T>
__global__ void __launch_bounds__(NT)
lin_attn_bwd_wqkv_kernel(const T* __restrict__ x, const float* __restrict__ g1s,
                         const float* __restrict__ g1b, const float* __restrict__ stats,
                         const T* __restrict__ dqkv, float* __restrict__ pwqkv,
                         int rows, int N, int C, int rows_per_split) {
  __shared__ __align__(16) float hs[WT_R][WT + 4];
  __shared__ __align__(16) float ds[WT_R][WT + 4];
  const int tid = threadIdx.x;
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
    for (int i = tid; i < WT_R * WT; i += NT) {
      const int r = i / WT, cc = i % WT;
      const int c = cb + cc;
      float hv = 0.f, dv = 0.f;
      if (r < rv) {
        const size_t R = (size_t)(r0 + r);
        if (c < C) {
          const int item = (int)(R / N);
          hv = gn1_h<T>(to_f(x[R * C + c]), stats[2 * item], stats[2 * item + 1],
                        g1s[c], g1b[c]);
        }
        dv = to_f(dqkv[R * QKV + jb + cc]);
      }
      hs[r][cc] = hv;
      ds[r][cc] = dv;
    }
    __syncthreads();
    for (int r = 0; r < rv; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[r][c0]);
      const float4 d = *reinterpret_cast<const float4*>(&ds[r][j0]);
      const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
    }
  }
  float* out = pwqkv + (size_t)sp * C * QKV;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (cb + c0 + i < C)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[(size_t)(cb + c0 + i) * QKV + jb + j0 + j] = acc[i][j];
}

// The grads: dWqkv = the sum of the split partials, dWout and the five
// vectors the sums of the per-item partials, each in index order.
__global__ void __launch_bounds__(NT)
lin_attn_bwd_finalize_kernel(const float* __restrict__ pwqkv, int splits,
                             const float* __restrict__ pwout,
                             const float* __restrict__ pvec, int B, int C,
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
    for (int b = 0; b < B; ++b) s += pvec[(size_t)b * n3 + k];
    dvec[k] = s;
  }
}

constexpr size_t item_smem_bytes(int C) {
  return sizeof(float) * (TILE_R * (C + HIDDEN > QKV ? C + HIDDEN : QKV) +
                          2 * HIDDEN * DH + 3 * HIDDEN + NT + NT / 32);
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

template <typename T> cudaError_t raise_smem_limit() {
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(lin_attn_bwd_item_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)item_smem_bytes(MAX_C));
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

template <typename T>
int launch(const void* x, const void* dy, const float* wqkv, const float* wout,
           const float* bout, const float* g1s, const float* g1b, const float* g2s,
           const float* g2b, const float* wqkv_t, void* dx, float* dwqkv, float* dwout,
           float* dvec, void* qkv, void* dqkv, float* o, void* do_, void* cw, void* cwt,
           float* stats, float* pvec, float* pwout, float* pwqkv, int B, int N, int C,
           int splits, float eps, cudaStream_t stream) {
  if (B < 1 || N < 1 || C < 4 || C > MAX_C || C % 4 || splits != n_splits(B, N, C))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit<T>();
  if (err != cudaSuccess) return (int)err;
  lin_attn_bwd_item_kernel<T><<<B, NT, item_smem_bytes(C), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), wqkv, wout, bout, g1s, g1b,
      g2s, g2b, wqkv_t, static_cast<T*>(dx), static_cast<T*>(qkv), static_cast<T*>(dqkv),
      o, static_cast<T*>(do_), static_cast<T*>(cw), static_cast<T*>(cwt), stats, pvec,
      pwout, N, C, eps);
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
      pwqkv, splits, pwout, pvec, B, C, dwqkv, dwout, dvec);
  return (int)cudaGetLastError();
}

}  // namespace

// How many dWqkv row splits (the first dimension of the pwqkv scratch) the
// backward takes at this shape.
extern "C" int ldm_lin_attn_bwd_splits(int B, int N, int C) { return n_splits(B, N, C); }

// dtype: 0 = float32, 1 = bfloat16 (x, dy, dx and the T scratch alike).
// x, dy, dx: (B, N, C), C a multiple of 4 and at most 512; wqkv: (C, 384);
// wout: (128, C); wqkv_t: (384, C); vectors (C,); weights fp32.  Outputs
// fp32: dwqkv (C, 384), dwout (128, C), dvec (5, C) = dbout, dg1s, dg1b,
// dg2s, dg2b.  Scratch: qkv, dqkv (B, N, 384) and do (B, N, C), cw (B, 128,
// C), cwt (B, C, 128) in T; o (B, N, C), stats (B, 2), pvec (B, 5, C),
// pwout (B, 128, C) and pwqkv (splits, C, 384) fp32.  Every pointer 16-byte
// aligned.
extern "C" int ldm_lin_attn_bwd(int dtype, const void* x, const void* dy, const float* wqkv,
                                const float* wout, const float* bout, const float* g1s,
                                const float* g1b, const float* g2s, const float* g2b,
                                const float* wqkv_t, void* dx, float* dwqkv, float* dwout,
                                float* dvec, void* qkv, void* dqkv, float* o, void* do_,
                                void* cw, void* cwt, float* stats, float* pvec,
                                float* pwout, float* pwqkv, int B, int N, int C, int splits,
                                float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dy, wqkv, wout, bout, g1s, g1b, g2s, g2b, wqkv_t, dx, dwqkv,
                         dwout, dvec, qkv, dqkv, o, do_, cw, cwt, stats, pvec, pwout, pwqkv,
                         B, N, C, splits, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, wqkv, wout, bout, g1s, g1b, g2s, g2b, wqkv_t, dx,
                                 dwqkv, dwout, dvec, qkv, dqkv, o, do_, cw, cwt, stats,
                                 pvec, pwout, pwqkv, B, N, C, splits, eps, s);
  return (int)cudaErrorInvalidValue;
}
