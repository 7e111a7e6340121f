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
// T is the compute type, fp32 or bf16, and also the type of x and y.  Matmul
// inputs are rounded to T and accumulated in fp32; every intermediate the
// plain version rounds to T (q, k, v, exp(.), ctx, ctx@Wout, out) is rounded
// to T at the same point here.  Weights and norm vectors stay fp32.
//
// What bounds it: every intermediate is a (B, N, 128) tensor and the three
// reductions over all N rows of an item (GN1 stats, k's column max and sum,
// GN2 stats) sit between the matmuls, so the block is bound by memory
// traffic, not by arithmetic.  This first design keeps it simple and
// deterministic:
//   * one CTA per item, so every per-item reduction stays inside one CTA: a
//     fixed-order tree, no atomics, bit-identical from run to run;
//   * the item is walked in row tiles of TILE_R = 64 rows (one item's x does
//     not fit in shared memory at N=1024), in five passes:
//       1. GN1 mean, then GN1 variance (two passes over x, as jnp.var);
//       2. h -> q, k, v for each tile, written to a global scratch in T,
//          then k's column max;
//       3. exp(k - max), k_sum and the four per-head 32x32 ctx blocks
//          (4x fewer FLOPs than the masked 128x128 square the TPU formed),
//          then ctx @ Wout into a second global scratch (B, 128, C) in T:
//          at C=512 it is 128 KiB even in bf16, too large to keep beside the
//          tiles in shared memory;
//       4. q softmax and out = q @ (ctx@Wout) + bout for each tile, written
//          into y, and GN2's sum;
//       5. GN2 variance, then y = x + GN2(out) in place.
//     At (1024, 64) in bf16 one item's x, q/k/v scratch and y come to about
//     1 MB, re-read pass after pass; how much of that the 50 MB L2 serves
//     at 2B=128 is not measured.
//   * the two tile matmuls (h @ Wqkv and q @ ctx_w) keep an 8x4 or 4x4
//     block of outputs per thread in registers and read shared memory as
//     float4 broadcasts, so a load feeds several FMAs;
//   * CUDA cores only, fp32 FMAs: wgmma, TMA and several CTAs per item (for
//     small batches, where one CTA per item leaves most SMs idle) are
//     later work.
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

// q softmax of rows n0 .. n0 + rv of the qkv scratch, per head over its 32
// lanes (shifted by the row max over all 128), times SCALE, into `tile`
// (rv x 128, fp32 values of T): one warp a row.
template <typename T>
__device__ __forceinline__ void q_softmax_tile(const T* __restrict__ qkv, int n0, int rv,
                                               float* tile) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rv; r += NT / 32) {
    const T* row = qkv + (size_t)(n0 + r) * QKV;
    float qv[4];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) qv[hh] = to_f(row[hh * DH + lane]);
    const float m = warp_max(fmaxf(fmaxf(qv[0], qv[1]), fmaxf(qv[2], qv[3])));
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const float e = rnd<T>(expf(rnd<T>(qv[hh] - m)));
      const float sum = warp_sum(e);
      tile[r * HIDDEN + hh * DH + lane] = rnd<T>(e / sum * SCALE);
    }
  }
}

// Stages 3 and 4 of the ablation: y = x + qn + k + v, lane c % 128 of each,
// with k replaced by kn = exp(k - kmax) / ksum when KN (stage 4).
template <typename T, bool KN>
__device__ void q_softmax_out(const T* __restrict__ xb, const T* __restrict__ qkv,
                              const float* kmax, const float* ksum, T* __restrict__ yb,
                              float* tile, int N, int C) {
  for (int n0 = 0; n0 < N; n0 += TILE_R) {
    const int rv = min(TILE_R, N - n0);
    __syncthreads();
    q_softmax_tile<T>(qkv, n0, rv, tile);
    __syncthreads();
    for (int i = threadIdx.x; i < rv * C; i += NT) {
      const int r = i / C, j = (i % C) % HIDDEN;
      const T* row = qkv + (size_t)(n0 + r) * QKV;
      float kv = to_f(row[HIDDEN + j]);
      if constexpr (KN) kv = rnd<T>(rnd<T>(expf(rnd<T>(kv - kmax[j]))) / ksum[j]);
      const size_t e = (size_t)n0 * C + i;
      yb[e] = from_f<T>(to_f(xb[e]) + tile[r * HIDDEN + j] + kv + to_f(row[2 * HIDDEN + j]));
    }
  }
}

template <typename T, int STAGE>
__global__ void __launch_bounds__(NT)
lin_attn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wqkv,
                    const float* __restrict__ wout, const float* __restrict__ bout,
                    const float* __restrict__ g1s, const float* __restrict__ g1b,
                    const float* __restrict__ g2s, const float* __restrict__ g2b,
                    T* __restrict__ y, T* __restrict__ qkv_scratch,
                    T* __restrict__ cw_scratch, int N, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  // shared layout: tile | ctx blocks | kmax | ksum | reduction
  const int tile_floats = TILE_R * (C > 2 * HIDDEN ? C : 2 * HIDDEN);
  float* tile = smem;                       // TILE_R x max(C, 256)
  float* ctxn = tile + tile_floats;         // HIDDEN x DH
  float* kmax = ctxn + HIDDEN * DH;         // HIDDEN
  float* ksum = kmax + HIDDEN;              // HIDDEN
  float* red = ksum + HIDDEN;               // NT / 32

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t nc = (size_t)N * C;
  const T* xb = x + (size_t)b * nc;
  T* yb = y + (size_t)b * nc;
  T* qkv = qkv_scratch + (size_t)b * N * QKV;
  T* cw = cw_scratch + (size_t)b * HIDDEN * C;
  const float fnc = (float)nc;

  // ---- pass 1: GroupNorm(1) statistics of x, fp32, two passes
  float s = 0.f;
  for (size_t i = tid; i < nc; i += NT) s += to_f(xb[i]);
  const float mean1 = block_sum(s, red) / fnc;
  s = 0.f;
  for (size_t i = tid; i < nc; i += NT) {
    const float d = to_f(xb[i]) - mean1;
    s = fmaf(d, d, s);
  }
  const float rstd1 = rsqrtf(block_sum(s, red) / fnc + eps);
  if constexpr (STAGE == 1) {  // y = x + GN1(x)
    for (size_t i = tid; i < nc; i += NT) {
      const int c = (int)(i % C);
      const float xv = to_f(xb[i]);
      yb[i] = from_f<T>(xv + rnd<T>((xv - mean1) * rstd1 * g1s[c] + g1b[c]));
    }
    return;
  }

  // ---- pass 2: h = GN1(x) tile by tile, qkv = h @ Wqkv into the scratch
  for (int n0 = 0; n0 < N; n0 += TILE_R) {
    const int rv = min(TILE_R, N - n0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < rv * C; i += NT) {
      const int c = i % C;
      const float xv = to_f(xb[(size_t)n0 * C + i]);
      tile[i] = rnd<T>((xv - mean1) * rstd1 * g1s[c] + g1b[c]);
    }
    __syncthreads();
    tile_matmul<8, T>(tile, C, C, wqkv, QKV, QKV, rv, [&](int r, int j, float acc) {
      qkv[(size_t)(n0 + r) * QKV + j] = from_f<T>(acc);
    });
  }
  __syncthreads();  // scratch writes visible to the whole CTA
  if constexpr (STAGE == 2) {  // y = x + q + k + v (lane c % 128 of each)
    for (size_t i = tid; i < nc; i += NT) {
      const int j = (int)(i % C) % HIDDEN;
      const T* row = qkv + (i / C) * QKV;
      yb[i] = from_f<T>(to_f(xb[i]) + to_f(row[j]) + to_f(row[HIDDEN + j]) +
                        to_f(row[2 * HIDDEN + j]));
    }
    return;
  }
  if constexpr (STAGE == 3) {  // y = x + qn + k + v
    q_softmax_out<T, false>(xb, qkv, nullptr, nullptr, yb, tile, N, C);
    return;
  }

  // k's per-column max over the item's N rows: two row-parity halves
  {
    const int j = tid % HIDDEN, half = tid / HIDDEN;
    float m = -__int_as_float(0x7f800000);  // -inf
    for (int n = half; n < N; n += NT / HIDDEN)
      m = fmaxf(m, to_f(qkv[(size_t)n * QKV + HIDDEN + j]));
    if (half == 1) kmax[j] = m;
    __syncthreads();
    if (half == 0) kmax[j] = fmaxf(m, kmax[j]);
  }

  // ---- pass 3: k_e = exp(k - max), k_sum and the four 32x32 ctx blocks.
  // Thread t owns head h = t / 64, ctx row d = (t % 64) / 2 of that head and
  // 16 of its 32 columns; threads t < 128 also own k_sum[t].
  const int ch = tid / 64, cd_ = (tid % 64) / 2, ce0 = (tid % 2) * 16;
  float cacc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) cacc[i] = 0.f;
  float ks = 0.f;
  float* ke_t = tile;                    // TILE_R x 128
  float* v_t = tile + TILE_R * HIDDEN;   // TILE_R x 128
  for (int n0 = 0; n0 < N; n0 += TILE_R) {
    const int rv = min(TILE_R, N - n0);
    __syncthreads();
    for (int i = tid; i < rv * HIDDEN; i += NT) {
      const int r = i / HIDDEN, j = i % HIDDEN;
      const T* row = qkv + (size_t)(n0 + r) * QKV;
      ke_t[i] = rnd<T>(expf(rnd<T>(to_f(row[HIDDEN + j]) - kmax[j])));
      v_t[i] = to_f(row[2 * HIDDEN + j]);
    }
    __syncthreads();
    const int kcol = ch * DH + cd_;
    if constexpr (STAGE >= 5) {  // the ctx products: stage 5 on
      for (int r = 0; r < rv; ++r) {
        const float kv = ke_t[r * HIDDEN + kcol];
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
    if (tid < HIDDEN)
      for (int r = 0; r < rv; ++r) ks += ke_t[r * HIDDEN + tid];
  }
  if (tid < HIDDEN) ksum[tid] = ks;
  __syncthreads();
  if constexpr (STAGE == 4) {  // y = x + qn + kn + v
    q_softmax_out<T, true>(xb, qkv, kmax, ksum, yb, tile, N, C);
    return;
  }
  {
    // ctx rounded to T, times 1/k_sum of its row, rounded to T again
    const float inv = 1.f / ksum[ch * DH + cd_];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      ctxn[(ch * DH + cd_) * DH + ce0 + i] = rnd<T>(rnd<T>(cacc[i]) * inv);
  }
  __syncthreads();

  // ctx_w = ctx @ Wout, (128, C): row d of head h uses Wout rows h*32 .. h*32+31
  for (int w = tid; w < HIDDEN * C; w += NT) {
    const int d = w / C, c = w % C;
    const float* cr = ctxn + d * DH;
    const float* wc = wout + (size_t)(d / DH) * DH * C + c;
    float acc = 0.f;
#pragma unroll 8
    for (int e = 0; e < DH; ++e) acc = fmaf(cr[e], rnd<T>(wc[(size_t)e * C]), acc);
    cw[w] = from_f<T>(acc);
  }
  __syncthreads();

  // ---- pass 4: q softmax per head, out = q @ ctx_w + bout into y
  float s2 = 0.f;
  for (int n0 = 0; n0 < N; n0 += TILE_R) {
    const int rv = min(TILE_R, N - n0);
    __syncthreads();
    q_softmax_tile<T>(qkv, n0, rv, tile);
    __syncthreads();
    tile_matmul<4, T>(tile, HIDDEN, HIDDEN, cw, C, C, rv, [&](int r, int c, float acc) {
      const float o = rnd<T>(rnd<T>(acc) + rnd<T>(bout[c]));
      yb[(size_t)(n0 + r) * C + c] = from_f<T>(o);
      s2 += o;
    });
  }
  // block_sum's leading barrier also orders pass 4's writes of y before the
  // reads below
  const float mean2 = block_sum(s2, red) / fnc;
  if constexpr (STAGE == 5) {  // y = x + out
    for (size_t i = tid; i < nc; i += NT) yb[i] = from_f<T>(to_f(xb[i]) + to_f(yb[i]));
    return;
  }

  // ---- pass 5: GN2 variance, then y = x + GN2(out), in place
  s = 0.f;
  for (size_t i = tid; i < nc; i += NT) {
    const float d = to_f(yb[i]) - mean2;
    s = fmaf(d, d, s);
  }
  const float rstd2 = rsqrtf(block_sum(s, red) / fnc + eps);
  for (size_t i = tid; i < nc; i += NT) {
    const int c = (int)(i % C);
    const float o = (to_f(yb[i]) - mean2) * rstd2 * g2s[c] + g2b[c];
    yb[i] = from_f<T>(to_f(xb[i]) + o);
  }
}

constexpr int MAX_C = 768;  // the widest C whose fp32 tile fits in shared memory
constexpr int MAX_DEVICES = 64;

constexpr size_t smem_bytes(int C) {
  return sizeof(float) *
         (TILE_R * (C > 2 * HIDDEN ? C : 2 * HIDDEN) + HIDDEN * DH + 2 * HIDDEN + NT / 32);
}

// Raise the kernel's dynamic shared-memory limit to what MAX_C takes, once
// per device (the attribute belongs to the device's context), not per launch.
template <typename T, int STAGE> cudaError_t raise_smem_limit() {
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(lin_attn_fwd_kernel<T, STAGE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(MAX_C));
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

template <typename T, int STAGE>
int launch(const void* x, const float* wqkv, const float* wout, const float* bout,
           const float* g1s, const float* g1b, const float* g2s, const float* g2b,
           void* y, void* qkv_scratch, void* cw_scratch, int B, int N, int C,
           float eps, cudaStream_t stream) {
  if (C > MAX_C) return (int)cudaErrorInvalidValue;
  const cudaError_t err = raise_smem_limit<T, STAGE>();
  if (err != cudaSuccess) return (int)err;
  lin_attn_fwd_kernel<T, STAGE><<<B, NT, smem_bytes(C), stream>>>(
      static_cast<const T*>(x), wqkv, wout, bout, g1s, g1b, g2s, g2b,
      static_cast<T*>(y), static_cast<T*>(qkv_scratch), static_cast<T*>(cw_scratch),
      N, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, y, scratch and compute type alike).
// x, y: (B, N, C), C a multiple of 4 and at most 768 (a 64-row fp32 tile of
// C values must fit in shared memory); wqkv: (C, 384); wout: (128, C);
// vectors: (C,); weights and vectors fp32; qkv_scratch: (B, N, 384) and
// cw_scratch: (B, 128, C) in the compute type; every pointer 16-byte aligned.
extern "C" int ldm_lin_attn_fwd(int dtype, const void* x, const float* wqkv,
                                const float* wout, const float* bout,
                                const float* g1s, const float* g1b,
                                const float* g2s, const float* g2b, void* y,
                                void* qkv_scratch, void* cw_scratch, int B, int N,
                                int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 6>(x, wqkv, wout, bout, g1s, g1b, g2s, g2b, y, qkv_scratch,
                            cw_scratch, B, N, C, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, 6>(x, wqkv, wout, bout, g1s, g1b, g2s, g2b, y,
                                    qkv_scratch, cw_scratch, B, N, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

template <typename T>
int launch_stage(int stage, const void* x, const float* wqkv, const float* wout,
                 const float* bout, const float* g1s, const float* g1b, const float* g2s,
                 const float* g2b, void* y, void* qkv, void* cw, int B, int N, int C,
                 float eps, cudaStream_t s) {
#define LA_ARGS x, wqkv, wout, bout, g1s, g1b, g2s, g2b, y, qkv, cw, B, N, C, eps, s
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

// The stage ablation (perf/probe7.py's stages 1-6): stage 6 is
// ldm_lin_attn_fwd itself; the other arguments as ldm_lin_attn_fwd's.
extern "C" int ldm_lin_attn_fwd_stage(int stage, int dtype, const void* x, const float* wqkv,
                                      const float* wout, const float* bout,
                                      const float* g1s, const float* g1b,
                                      const float* g2s, const float* g2b, void* y,
                                      void* qkv_scratch, void* cw_scratch, int B, int N,
                                      int C, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_stage<float>(stage, x, wqkv, wout, bout, g1s, g1b, g2s, g2b, y,
                               qkv_scratch, cw_scratch, B, N, C, eps, s);
  if (dtype == 1)
    return launch_stage<__nv_bfloat16>(stage, x, wqkv, wout, bout, g1s, g1b, g2s, g2b, y,
                                       qkv_scratch, cw_scratch, B, N, C, eps, s);
  return (int)cudaErrorInvalidValue;
}
