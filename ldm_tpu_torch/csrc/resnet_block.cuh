// Fused UNet ResNet block for Hopper (sm_90a): the kernels, templated on a
// compile-time MODE so that resnet_block_fwd.cu (the production block,
// MODE_FULL) and resnet_block_probe.cu (the stage ablation of
// perf/probe13b.py) build them from one body.
//
// The block, per item (x NHWC, H x W pixels):
//   h1 = conv3x3(SiLU(GN8(x)), W1) + b1 + temb      (GN1 + conv1)
//   y  = conv3x3(SiLU(GN8(h1)), W2) + b2 + shortcut  (GN2 + conv2)
// with the cast points of the TPU kernel _resnet_kernel
// (ldm_tpu/ops/resnet_block.py:133): GN statistics and affine in fp32, SiLU
// in fp32 then rounded to T; conv1's fp32 sum rounded to T before its bias
// (added in T), then + temb in T; conv2's sum, its bias and the shortcut in
// fp32, rounded once at the store.  The 1x1 shortcut's product adds into
// conv2's accumulator (both are fp32 sums of products of T values).
//
// Modes (each output depends on every stage the mode keeps, so nvcc deletes
// none of them):
//   MODE_NOOP    y = x: one read and one write, the launch and memory floor;
//   MODE_GNONLY  both GN + SiLU passes, no products: each "conv" is its
//                normalised input's centre pixel (C_in == C_out);
//   MODE_CENTER  each conv is its centre tap only (one K = C product);
//   MODE_FULL    the block.
#pragma once

#include "numeric.cuh"

namespace {

constexpr int MODE_NOOP = 0, MODE_GNONLY = 1, MODE_CENTER = 2, MODE_FULL = 3;

constexpr int RB_NT = 256;            // threads per CTA
constexpr int RB_TM = 128;            // output pixels per conv CTA
constexpr int RB_TN = 64;             // output channels per conv CTA
constexpr int RB_CK = 16;             // input channels per K step
constexpr int RB_RPT = 8;             // output pixels per thread
constexpr int RB_CPT = 4;             // output channels per thread
constexpr int RB_LDA = RB_TM + 4;     // row stride of the A tile (16-byte rows)
constexpr int RB_MAX_C = 768;         // widest C the statistics kernel holds
static_assert((RB_TM / RB_RPT) * (RB_TN / RB_CPT) == RB_NT, "one output block per thread");

// GroupNorm statistics of one item per CTA: mean and 1/sqrt(var + eps) for
// each of G groups, var = E[v^2] - mean^2 (floored at 0) as the TPU kernel
// and the plain version take it.  Channels go to threads (row groups of C
// threads when C <= RB_NT); the per-thread sums, the row groups and the
// group's channels are added in a fixed order: no atomics, so reruns are
// bit-identical.
template <typename T>
__global__ void __launch_bounds__(RB_NT)
group_stats_kernel(const T* __restrict__ src, float* __restrict__ stats, int N, int C, int G,
                   float eps) {
  __shared__ float red1[RB_NT], red2[RB_NT];
  __shared__ float ch1[RB_MAX_C], ch2[RB_MAX_C];
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* s = src + (size_t)b * N * C;
  if (C <= RB_NT) {
    const int rg = RB_NT / C, g = tid / C, c = tid % C;
    float a1 = 0.f, a2 = 0.f;
    if (g < rg)
      for (int n = g; n < N; n += rg) {
        const float v = to_f(s[(size_t)n * C + c]);
        a1 += v;
        a2 = fmaf(v, v, a2);
      }
    red1[tid] = a1;
    red2[tid] = a2;
    __syncthreads();
    if (tid < C) {
      float s1 = 0.f, s2 = 0.f;
      for (int k = 0; k < rg; ++k) {
        s1 += red1[k * C + tid];
        s2 += red2[k * C + tid];
      }
      ch1[tid] = s1;
      ch2[tid] = s2;
    }
  } else {
    for (int c = tid; c < C; c += RB_NT) {
      float a1 = 0.f, a2 = 0.f;
      for (int n = 0; n < N; ++n) {
        const float v = to_f(s[(size_t)n * C + c]);
        a1 += v;
        a2 = fmaf(v, v, a2);
      }
      ch1[c] = a1;
      ch2[c] = a2;
    }
  }
  __syncthreads();
  if (tid < G) {
    const int per = C / G;
    float s1 = 0.f, s2 = 0.f;
    for (int c = tid * per; c < (tid + 1) * per; ++c) {
      s1 += ch1[c];
      s2 += ch2[c];
    }
    const float cnt = (float)N * (float)per;
    const float mu = s1 / cnt;
    const float var = fmaxf(s2 / cnt - mu * mu, 0.f);
    stats[(size_t)(b * G + tid) * 2] = mu;
    stats[(size_t)(b * G + tid) * 2 + 1] = rsqrtf(var + eps);
  }
}

// SiLU(GN(v)) of channel c of item b, in fp32, rounded to T.
template <typename T>
__device__ __forceinline__ float gn_silu(float v, const float* __restrict__ stats,
                                         const float* __restrict__ gs,
                                         const float* __restrict__ gb, int b, int c, int G,
                                         int per) {
  const int g = b * G + c / per;
  const float mu = stats[2 * g], inv = stats[2 * g + 1];
  const float a = inv * gs[c];
  const float y = v * a + (gb[c] - mu * a);
  return rnd<T>(y / (1.f + expf(-y)));
}

// One CTA computes a RB_TM x RB_TN tile of a 3x3 convolution's output over
// the B*H*W pixels (rows) and C_out channels (columns), as an implicit GEMM:
// for each tap and each RB_CK channels of the source, an A tile of source
// pixels shifted by the tap (GN + SiLU applied on load, zero outside the
// image: the pixel's own h and w decide, so a tap never reads another item)
// and a B tile of the (9 C_in, C_out) HWIO weight rows, rounded to T.  Each
// thread keeps an RB_RPT x RB_CPT block of fp32 sums in registers; K runs in
// a fixed order.
//
// SECOND = false (conv1): out = h1 = T(T(T(sum) + T(b1)) + T(temb)).
// SECOND = true (conv2): out = y = T(sum + b2 + shortcut); a 1x1 shortcut
// (ws != nullptr) adds x @ ws into the same sum and bs at the end, else the
// shortcut is x itself.
template <typename T, int MODE, bool SECOND>
__global__ void __launch_bounds__(RB_NT)
resnet_conv_kernel(const T* __restrict__ src, const float* __restrict__ stats,
                   const float* __restrict__ gs, const float* __restrict__ gb,
                   const float* __restrict__ w, const float* __restrict__ bias,
                   const float* __restrict__ temb, const T* __restrict__ x,
                   const float* __restrict__ ws, const float* __restrict__ bs, int Cx,
                   T* __restrict__ out, int M, int H, int W, int Cs, int Co, int G) {
  __shared__ __align__(16) float As[RB_CK][RB_LDA];
  __shared__ __align__(16) float Bs[RB_CK][RB_TN];
  __shared__ int rb[RB_TM], rh[RB_TM], rw[RB_TM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * RB_TM, n0 = blockIdx.y * RB_TN;
  const int N = H * W, per = Cs / G;
  for (int r = tid; r < RB_TM; r += RB_NT) {
    const int p = m0 + r;
    const int b = p / N, q = p - b * N;
    rb[r] = p < M ? b : -1;
    rh[r] = q / W;
    rw[r] = q - (q / W) * W;
  }

  const int cg = tid % (RB_TN / RB_CPT), rg = tid / (RB_TN / RB_CPT);
  const int r0 = rg * RB_RPT, j0 = cg * RB_CPT;
  float acc[RB_RPT][RB_CPT];
#pragma unroll
  for (int i = 0; i < RB_RPT; ++i)
#pragma unroll
    for (int j = 0; j < RB_CPT; ++j) acc[i][j] = 0.f;

  // acc += A (RB_CK x RB_TM, in As) ^T B (RB_CK x RB_TN, in Bs)
  auto mma_tile = [&]() {
#pragma unroll
    for (int k = 0; k < RB_CK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][r0]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][r0 + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][j0]);
      const float av[RB_RPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[RB_CPT] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < RB_RPT; ++i)
#pragma unroll
        for (int j = 0; j < RB_CPT; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  };
  // B tile: RB_CK weight rows from row k0 of a (K, Co) matrix, rounded to T
  auto load_b = [&](const float* __restrict__ wm, int k0, int kmax) {
    for (int i = tid; i < RB_CK * RB_TN; i += RB_NT) {
      const int k = i / RB_TN, n = i % RB_TN;
      const int col = n0 + n;
      Bs[k][n] = (k0 + k < kmax && col < Co) ? rnd<T>(wm[(size_t)(k0 + k) * Co + col]) : 0.f;
    }
  };

  if constexpr (MODE == MODE_FULL || MODE == MODE_CENTER) {
    constexpr int TAP0 = MODE == MODE_FULL ? 0 : 4, TAP1 = MODE == MODE_FULL ? 9 : 5;
    for (int tap = TAP0; tap < TAP1; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      for (int c0 = 0; c0 < Cs; c0 += RB_CK) {
        __syncthreads();  // the previous step's readers are done (and the row info written)
        for (int i = tid; i < RB_CK * RB_TM; i += RB_NT) {
          const int k = i % RB_CK, r = i / RB_CK;
          const int c = c0 + k, b = rb[r];
          const int hh = rh[r] + dy, ww = rw[r] + dx;
          float v = 0.f;
          if (b >= 0 && c < Cs && hh >= 0 && hh < H && ww >= 0 && ww < W) {
            const size_t pix = (size_t)b * N + hh * W + ww;
            v = gn_silu<T>(to_f(src[pix * Cs + c]), stats, gs, gb, b, c, G, per);
          }
          As[k][r] = v;
        }
        load_b(w, tap * Cs + c0, (tap + 1) * Cs);
        __syncthreads();
        mma_tile();
      }
    }
  }
  if constexpr (SECOND && MODE != MODE_NOOP) {
    if (ws != nullptr) {
      for (int c0 = 0; c0 < Cx; c0 += RB_CK) {
        __syncthreads();
        for (int i = tid; i < RB_CK * RB_TM; i += RB_NT) {
          const int k = i % RB_CK, r = i / RB_CK;
          const int c = c0 + k;
          As[k][r] = (rb[r] >= 0 && c < Cx) ? to_f(x[(size_t)(m0 + r) * Cx + c]) : 0.f;
        }
        load_b(ws, c0, Cx);
        __syncthreads();
        mma_tile();
      }
    }
  }
  __syncthreads();  // the row info is complete before the epilogue reads it

#pragma unroll
  for (int i = 0; i < RB_RPT; ++i) {
    const int r = r0 + i;
    const int b = rb[r];
    if (b < 0) continue;
    const size_t p = (size_t)(m0 + r);
#pragma unroll
    for (int j = 0; j < RB_CPT; ++j) {
      const int col = n0 + j0 + j;
      if (col >= Co) continue;
      float v = acc[i][j];
      if constexpr (MODE == MODE_GNONLY) {
        // no product: the normalised input's own pixel and channel
        v = gn_silu<T>(to_f(src[p * Cs + col]), stats, gs, gb, b, col, G, per);
        if constexpr (SECOND)
          if (ws != nullptr) v += acc[i][j];
      }
      if constexpr (!SECOND) {
        v = rnd<T>(rnd<T>(v) + rnd<T>(bias[col]));
        v = v + rnd<T>(temb[(size_t)b * Co + col]);
      } else {
        const float sc = ws != nullptr ? bs[col] : to_f(x[p * Co + col]);
        v = v + bias[col] + sc;
      }
      out[p * Co + col] = from_f<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(RB_NT) copy_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                     size_t n) {
  for (size_t i = (size_t)blockIdx.x * RB_NT + threadIdx.x; i < n;
       i += (size_t)gridDim.x * RB_NT)
    y[i] = x[i];
}

// The block: GN1 statistics of x, conv1 into the h1 scratch (B, H, W, Co) in
// T, GN2 statistics of h1, conv2 into y.  Four launches on `stream`; returns
// the first launch error.  ws == nullptr selects the identity shortcut
// (C_in == C_out).
template <typename T, int MODE>
int launch_block(const T* x, const float* temb, const float* n1s, const float* n1b,
                 const float* w1, const float* b1, const float* n2s, const float* n2b,
                 const float* w2, const float* b2, const float* ws, const float* bs, T* y,
                 T* h1, float* stats1, float* stats2, int B, int H, int W, int Cin, int Cout,
                 int G, float eps, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cin > RB_MAX_C || Cout > RB_MAX_C ||
      G < 1 || G > RB_NT || Cin % G || Cout % G || (ws == nullptr && Cin != Cout) ||
      (MODE == MODE_GNONLY && Cin != Cout))
    return (int)cudaErrorInvalidValue;
  const int N = H * W, M = B * N;
  if constexpr (MODE == MODE_NOOP) {
    const size_t n = (size_t)M * Cin;
    const size_t want = (n + RB_NT - 1) / RB_NT;
    const int blocks = (int)(want < 4096 ? want : 4096);
    copy_kernel<T><<<blocks, RB_NT, 0, stream>>>(x, y, n);
    return (int)cudaGetLastError();
  } else {
    const dim3 grid((M + RB_TM - 1) / RB_TM, (Cout + RB_TN - 1) / RB_TN);
    group_stats_kernel<T><<<B, RB_NT, 0, stream>>>(x, stats1, N, Cin, G, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    resnet_conv_kernel<T, MODE, false><<<grid, RB_NT, 0, stream>>>(
        x, stats1, n1s, n1b, w1, b1, temb, nullptr, nullptr, nullptr, 0, h1, M, H, W, Cin,
        Cout, G);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    group_stats_kernel<T><<<B, RB_NT, 0, stream>>>(h1, stats2, N, Cout, G, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    resnet_conv_kernel<T, MODE, true><<<grid, RB_NT, 0, stream>>>(
        h1, stats2, n2s, n2b, w2, b2, nullptr, x, ws, bs, Cin, y, M, H, W, Cout, Cout, G);
    return (int)cudaGetLastError();
  }
}

}  // namespace
