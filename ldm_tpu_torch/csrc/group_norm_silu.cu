// GroupNorm, and the SiLU after it where one follows, as one pass over a
// bf16 channels_last activation, for Hopper (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm and SiLU to
// XLA, which fuses them into the neighbouring ops.  PyTorch runs the model
// layer's chain, F.group_norm(x.float()).to(bf16, channels_last) then
// F.silu, as six kernels (the upcast, a strided copy to NCHW, the moments,
// the affine, the cast back to channels_last, the SiLU) that move about 36
// bytes an element; this pass computes the same per item b of (H*W, C):
//
//   mean_g = sum(x over the group's C/G channels and H*W pixels) / n      fp32
//   var_g  = sum((x - mean_g)^2) / n, rstd_g = rsqrt(var_g + eps)         fp32
//   a_c = rstd_g * gamma_c, b_c = beta_c - a_c * mean_g                   fp32
//   y   = bf16(a_c * x + b_c);  with silu: y = bf16(y / (1 + exp(-y)))
//
// (the rounding points of the plain chain: the affine in fp32, rounded to
// bf16, and the SiLU in fp32 on that bf16 value, as F.silu on a bf16 tensor).
//
// What bounds it: bytes.  Read x once and write y once, 4 bytes an element in
// bf16, against some ten operations an element.  The design:
//   * the item stays on chip between the statistics and the output.  Each
//     thread holds 16 bytes (8 channels of one pixel) of each of its k
//     chunks in registers (KR of them; the plan picks KR >= k where k <= 16,
//     so x is read from device memory once; a chunk beyond KR is read again
//     in each of the three passes), and the item's CTAs share their partial
//     sums, not x;
//   * an item larger than a CTA's 256 threads x 8 chunks spreads over a
//     thread-block cluster of `cs` CTAs (2, 4 or 8), chosen from (H*W, C)
//     alone.  Each reduction: a thread's 8 channel sums over its chunks into
//     shared memory, the CTA's rows added in order per channel, the partials
//     of the cluster's CTAs added in rank order out of their shared memory
//     (distributed shared memory), then the channels of a group in order.
//     No atomics, and nothing depends on the batch size or the item's place
//     in it: reruns are bit-identical and so is an item at another slot;
//   * small items (the 2x2 and 4x4 sites) share a CTA, `items` of them, so
//     that a CTA has at least 128 threads;
//   * one launch a site; the statistics take two passes over registers (the
//     mean, then the variance about it), never over device memory.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA can take
constexpr int MAX_DEVICES = 64;
constexpr int N_PLAN = 7;           // ints of a GnPlan

// The launch's shape, made by the host side (plan_group_norm in
// ops/group_norm.py) from (H*W, C, G) alone.
struct GnPlan {
  int cs;       // CTAs in the cluster of one item (1, 2, 4 or 8)
  int items;    // items a CTA (1 where cs > 1)
  int pi;       // rows of an item in a CTA; a row is C / 8 threads, one pixel
  int k;        // 16-byte chunks a thread: pixels slot + j * cs * pi, j < k
  int kr;       // of which held in registers: the kernel's KR
  int threads;  // items * pi * C / 8
  int smem;     // dynamic shared-memory bytes (layout().total)
};

// Byte offsets into dynamic shared memory; plan_group_norm repeats the
// arithmetic, and the launcher refuses a plan whose size differs.
struct Layout {
  int aff;    // (a, b) a channel, items x C float2
  int red;    // a thread's 8 channel sums, rows x C fp32
  int chan;   // an item's channel sums, items x C fp32
  int xch;    // the CTA's partials of pass 1 | pass 2, 2 x C fp32 (cs > 1)
  int stat;   // mean | rstd, 2 x items x G fp32
  int total;
};

__host__ __device__ inline Layout layout(int C, int G, const GnPlan& p) {
  Layout l;
  l.aff = 0;
  l.red = l.aff + 8 * p.items * C;
  l.chan = l.red + 4 * p.items * p.pi * C;
  l.xch = l.chan + 4 * p.items * C;
  l.stat = l.xch + (p.cs > 1 ? 8 * C : 0);
  l.total = l.stat + 8 * p.items * G;
  return l;
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(h[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return v;
}

// A thread's 8 sums into its row of `red`, then each item's channel sums:
// the item's rows of the CTA in order, then (cs > 1) the cluster's partials
// in rank order, read out of the peers' shared memory.  `xch` is at the same
// offset in every CTA and is read by the peers until the next cluster barrier.
__device__ void channel_sums(const float (&acc)[8], float* red, float* chan, float* xch,
                             int C, int row, int cv, const GnPlan& p) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float4* dst = reinterpret_cast<float4*>(red + (size_t)row * C + cv * 8);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  for (int t = tid; t < p.items * C; t += nt) {
    const int il = t / C, c = t - il * C;
    const float* col = red + (size_t)il * p.pi * C + c;
    float s = 0.f;
    for (int r = 0; r < p.pi; ++r) s += col[(size_t)r * C];
    if (p.cs > 1) xch[c] = s;
    else chan[t] = s;
  }
  if (p.cs > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    for (int c = tid; c < C; c += nt) {
      float v[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r) v[r] = r < p.cs ? cl.map_shared_rank(xch, r)[c] : 0.f;
      float s = v[0];
#pragma unroll
      for (int r = 1; r < MAX_CLUSTER; ++r)
        if (r < p.cs) s += v[r];
      chan[c] = s;
    }
  }
  __syncthreads();
}

// Each item's group sums over its C / G channels in order, divided by n:
// the means (RSTD false) or rsqrt(variance + eps).
template <bool RSTD>
__device__ void group_stats(const float* chan, float* out, int C, int G, float n, float eps,
                            int items) {
  const int cpg = C / G;
  for (int t = threadIdx.x; t < items * G; t += blockDim.x) {
    const int il = t / G, g = t - il * G;
    const float* c = chan + il * C + g * cpg;
    float s = 0.f;
    for (int j = 0; j < cpg; ++j) s += c[j];
    out[t] = RSTD ? rsqrtf(s / n + eps) : s / n;
  }
  __syncthreads();
}

template <int KR>
__global__ void __launch_bounds__(MAX_THREADS)
group_norm_silu_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, __nv_bfloat16* __restrict__ y, int B,
                       int HW, int C, int G, float eps, int silu, GnPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout l = layout(C, G, p);
  float2* aff = reinterpret_cast<float2*>(smem_raw + l.aff);
  float* red = reinterpret_cast<float*>(smem_raw + l.red);
  float* chan = reinterpret_cast<float*>(smem_raw + l.chan);
  float* xch = reinterpret_cast<float*>(smem_raw + l.xch);
  float* mean = reinterpret_cast<float*>(smem_raw + l.stat);
  float* rstd = mean + p.items * G;

  const int nv = C >> 3;  // 16-byte chunks a pixel
  const int cv = threadIdx.x % nv, row = threadIdx.x / nv;
  const int il = row / p.pi, pr = row - il * p.pi;
  const int rank = p.cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long item =
      p.cs > 1 ? (long long)(blockIdx.x / p.cs) : (long long)blockIdx.x * p.items + il;
  const bool live = item < B;
  const int slot = rank * p.pi + pr, stride = p.cs * p.pi;
  const int cpg = C / G;
  const float n = (float)cpg * (float)HW;
  const size_t base = ((size_t)item * HW + slot) * C + cv * 8;
  auto offset = [&](int j) { return base + (size_t)j * stride * C; };
  auto in_item = [&](int j) { return live && j < p.k && slot + j * stride < HW; };
  auto load = [&](int j) { return __ldg(reinterpret_cast<const uint4*>(x + offset(j))); };

  // ---- pass 1: every chunk loaded before the first sum; the mean
  uint4 v[KR];
#pragma unroll
  for (int j = 0; j < KR; ++j) v[j] = in_item(j) ? load(j) : make_uint4(0u, 0u, 0u, 0u);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float f[8];
#pragma unroll
  for (int j = 0; j < KR; ++j) {  // a chunk outside the item is zero and adds nothing
    unpack(v[j], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += f[e];
  }
  for (int j = KR; j < p.k; ++j) {
    if (!in_item(j)) continue;
    unpack(load(j), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += f[e];
  }
  channel_sums(acc, red, chan, xch, C, row, cv, p);
  group_stats<false>(chan, mean, C, G, n, eps, p.items);

  // ---- pass 2: the variance about the mean
  float m[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = mean[il * G + (cv * 8 + e) / cpg];
    acc[e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    if (!in_item(j)) continue;
    unpack(v[j], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = f[e] - m[e];
      acc[e] = fmaf(d, d, acc[e]);
    }
  }
  for (int j = KR; j < p.k; ++j) {
    if (!in_item(j)) continue;
    unpack(load(j), f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = f[e] - m[e];
      acc[e] = fmaf(d, d, acc[e]);
    }
  }
  channel_sums(acc, red, chan, xch + C, C, row, cv, p);
  // this CTA has read its peers' partials for the last time: arrive now, wait
  // before leaving (a peer's shared memory must outlive every read of it)
  if (p.cs > 1) asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  group_stats<true>(chan, rstd, C, G, n, eps, p.items);

  // ---- the affine a channel, then the output
  for (int t = threadIdx.x; t < p.items * C; t += blockDim.x) {
    const int i = t / C, c = t - i * C, g = i * G + c / cpg;
    const float a = rstd[g] * gamma[c];
    aff[t] = make_float2(a, fmaf(-a, mean[g], beta[c]));
  }
  __syncthreads();
  float2 ab[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) ab[e] = aff[il * C + cv * 8 + e];
  auto finish = [&](uint4 raw, int j) {
    unpack(raw, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      f[e] = __bfloat162float(__float2bfloat16_rn(fmaf(ab[e].x, f[e], ab[e].y)));
      if (silu) f[e] = f[e] / (1.f + expf(-f[e]));
    }
    *reinterpret_cast<uint4*>(y + offset(j)) = pack(f);
  };
#pragma unroll
  for (int j = 0; j < KR; ++j)
    if (in_item(j)) finish(v[j], j);
  for (int j = KR; j < p.k; ++j)
    if (in_item(j)) finish(load(j), j);
  if (p.cs > 1) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Raise the kernel's dynamic shared-memory limit to the card's, once per
// device (the attribute belongs to the device's context), not per launch.
template <int KR> cudaError_t raise_smem_limit() {
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(group_norm_silu_kernel<KR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess && dev < MAX_DEVICES) raised[dev] = true;
  return err;
}

template <int KR>
int launch(const void* x, const float* gamma, const float* beta, void* y, int B, int HW, int C,
           int G, float eps, int silu, const GnPlan& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = raise_smem_limit<KR>();
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs > 1 ? (unsigned)B * (unsigned)p.cs
                              : (unsigned)((B + p.items - 1) / p.items));
  cfg.blockDim = dim3((unsigned)p.threads);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cs > 1 ? 1 : 0;
  const cudaError_t lerr = cudaLaunchKernelEx(
      &cfg, group_norm_silu_kernel<KR>, static_cast<const __nv_bfloat16*>(x), gamma, beta,
      static_cast<__nv_bfloat16*>(y), B, HW, C, G, eps, silu, p);
  if (lerr != cudaSuccess) return (int)lerr;
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, H, W, C) bf16, channels_last memory (NHWC), 16-byte aligned;
// gamma, beta: (C,) fp32.  C a multiple of 8, G a divisor of C.  silu: 0 or
// 1.  plan: the 7 ints of a GnPlan (host memory).  Refuses (returns
// cudaErrorInvalidValue) a plan that does not cover the item or whose shared
// memory differs from the layout's.
extern "C" int ldm_group_norm_silu(const void* x, const float* gamma, const float* beta,
                                   void* y, int B, int HW, int C, int G, float eps, int silu,
                                   const int* plan, void* stream) {
  GnPlan p;
  static_assert(sizeof(GnPlan) == N_PLAN * sizeof(int), "GnPlan is N_PLAN ints");
  int* pi = reinterpret_cast<int*>(&p);
  for (int i = 0; i < N_PLAN; ++i) pi[i] = plan[i];
  const bool cs_ok = p.cs == 1 || p.cs == 2 || p.cs == 4 || p.cs == 8;
  if (B < 1 || HW < 1 || C < 8 || C % 8 || G < 1 || C % G || !cs_ok || p.items < 1 ||
      (p.cs > 1 && p.items != 1) || p.pi < 1 || p.k < 1 ||
      (long long)p.k * p.cs * p.pi < HW || p.threads != p.items * p.pi * (C / 8) ||
      p.threads > MAX_THREADS || p.smem != layout(C, G, p).total || p.smem > SMEM_LIMIT ||
      (silu != 0 && silu != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.kr) {
    case 1: return launch<1>(x, gamma, beta, y, B, HW, C, G, eps, silu, p, s);
    case 2: return launch<2>(x, gamma, beta, y, B, HW, C, G, eps, silu, p, s);
    case 4: return launch<4>(x, gamma, beta, y, B, HW, C, G, eps, silu, p, s);
    case 8: return launch<8>(x, gamma, beta, y, B, HW, C, G, eps, silu, p, s);
    case 16: return launch<16>(x, gamma, beta, y, B, HW, C, G, eps, silu, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
