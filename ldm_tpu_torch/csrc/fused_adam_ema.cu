// Adam and the EMA of every parameter leaf in one pass, for Hopper (sm_90a),
// CUDA C++.
//
// Replaces no Pallas kernel: it is the port of fused_apply_gradients
// (ldm_tpu/training/state.py:78), which states the optimizer's whole update
// as one explicit pass a leaf with optax's association,
//
//     m2 = b1 m + (1 - b1) g
//     v2 = b2 v + ((1 - b2) g) g
//     p2 = p - lr ((m2 / c1) / (sqrt(v2 / c2) + eps))
//     e2 = d e + (1 - d) p2
//
// with c1 = 1 - b1^(count + 1), c2 = 1 - b2^(count + 1) in fp32 (count is
// Adam's step of the leaf before this update) and d the EMA weight.  Every
// operation is written as its correctly rounded intrinsic (__fmul_rn, ...),
// so nothing is contracted into an FMA: the kernel rounds where the plain
// version (ops/fused_adam_ema.py) and the JAX function round.
//
// What bounds it: bytes.  Each element reads p, g, m, v and e and writes p,
// m, v and e, 36 bytes in fp32 (28 without the EMA), against about 15
// floating-point operations: at the flagship's 20,350,915 parameters 732.6 MB,
// 0.219 ms at 3.35 TB/s.
//
// What the design does about it:
//   * One launch for every leaf (the flagship has 200, the smallest of 3
//     elements): a table of the leaves' pointers and sizes passed by value
//     in the kernel's parameters, rebuilt by the host at every call (the
//     gradients are new tensors each eager step).  Up to LDM_ADAM_LEAVES
//     leaves a launch; a longer table is launched in groups.
//   * Each CTA takes one fixed chunk of one leaf (4,096 elements), found by
//     a binary search over the table's first-chunk offsets, the same for
//     every thread of the CTA.  16-byte loads and stores where all of the
//     leaf's streams are 16-byte aligned; a scalar tail where its size is no
//     multiple of 4, scalar accesses where a stream is not aligned.
//   * No atomics, no shared memory, no order between CTAs: each element is
//     read and written by one thread, so reruns are bit-identical.
//   * The step counts and the EMA weight are read from the device, so a
//     replayed CUDA graph sees the current step.  The kernel does not move
//     the counts: the caller increments them after the launch (a launch that
//     read and wrote them would race across CTAs).
//   * A leaf without a gradient keeps its parameter and moments (torch's
//     Adam skips it) and only its EMA moves; a leaf without an EMA (the
//     classifier's and the VAE's states have none) moves 28 bytes an element.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                                // floats in a 16-byte access
constexpr int ITEMS = 4;                              // 16-byte accesses a thread
constexpr long long CHUNK = (long long)THREADS * VEC * ITEMS;  // elements a CTA

// Kernel parameters may take 32,764 bytes from CUDA 12.1 on (4,096 before).
static_assert(CUDART_VERSION >= 12010, "the leaf table needs CUDA 12.1's large kernel parameters");
constexpr int LDM_ADAM_LEAVES = 448;

struct LeafTable {
  float* p[LDM_ADAM_LEAVES];
  const float* g[LDM_ADAM_LEAVES];     // null: no gradient (the EMA alone)
  float* m[LDM_ADAM_LEAVES];
  float* v[LDM_ADAM_LEAVES];
  float* e[LDM_ADAM_LEAVES];           // null: no EMA
  const float* step[LDM_ADAM_LEAVES];  // Adam's step of the leaf, before this update
  long long numel[LDM_ADAM_LEAVES];
  int first_chunk[LDM_ADAM_LEAVES + 1];
  int n;
};
static_assert(sizeof(LeafTable) + 64 <= 32764, "the leaf table does not fit in the kernel's parameters");

struct Hyper {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps;
};

struct Coef {
  float lr, b1, b2, ob1, ob2, c1, c2, eps, d, od;
};

__device__ __forceinline__ void adam(const Coef& k, float& p, float g, float& m, float& v) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.ob1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.ob2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.c2)), k.eps);
  p = __fsub_rn(p, __fmul_rn(k.lr, __fdiv_rn(__fdiv_rn(m, k.c1), den)));
}

__device__ __forceinline__ void ema(const Coef& k, float p, float& e) {
  e = __fadd_rn(__fmul_rn(k.d, e), __fmul_rn(k.od, p));
}

template <bool ADAM, bool EMA>
__device__ __forceinline__ void element(const Coef& k, float* p, const float* g, float* m,
                                        float* v, float* e, long long i) {
  float pi = p[i];
  if (ADAM) {
    float mi = m[i], vi = v[i];
    adam(k, pi, g[i], mi, vi);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
  if (EMA) {
    float ei = e[i];
    ema(k, pi, ei);
    e[i] = ei;
  }
}

template <bool ADAM, bool EMA>
__device__ __forceinline__ void chunk(const Coef& k, float* p, const float* g, float* m,
                                      float* v, float* e, long long start, long long end) {
  uintptr_t bits = reinterpret_cast<uintptr_t>(p);
  if (ADAM) bits |= reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(m) |
                    reinterpret_cast<uintptr_t>(v);
  if (EMA) bits |= reinterpret_cast<uintptr_t>(e);
  long long vec_end = start;  // [start, vec_end) in 16-byte accesses
  if ((bits & 15) == 0) {
    vec_end = start + (end - start) / VEC * VEC;
    float4 P[ITEMS], G[ITEMS], M[ITEMS], V[ITEMS], E[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = start + ((long long)j * THREADS + threadIdx.x) * VEC;
      if (i < vec_end) {
        P[j] = *reinterpret_cast<const float4*>(p + i);
        if (ADAM) {
          G[j] = *reinterpret_cast<const float4*>(g + i);
          M[j] = *reinterpret_cast<const float4*>(m + i);
          V[j] = *reinterpret_cast<const float4*>(v + i);
        }
        if (EMA) E[j] = *reinterpret_cast<const float4*>(e + i);
      }
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const long long i = start + ((long long)j * THREADS + threadIdx.x) * VEC;
      if (i < vec_end) {
        if (ADAM) {
          adam(k, P[j].x, G[j].x, M[j].x, V[j].x);
          adam(k, P[j].y, G[j].y, M[j].y, V[j].y);
          adam(k, P[j].z, G[j].z, M[j].z, V[j].z);
          adam(k, P[j].w, G[j].w, M[j].w, V[j].w);
          *reinterpret_cast<float4*>(p + i) = P[j];
          *reinterpret_cast<float4*>(m + i) = M[j];
          *reinterpret_cast<float4*>(v + i) = V[j];
        }
        if (EMA) {
          ema(k, P[j].x, E[j].x);
          ema(k, P[j].y, E[j].y);
          ema(k, P[j].z, E[j].z);
          ema(k, P[j].w, E[j].w);
          *reinterpret_cast<float4*>(e + i) = E[j];
        }
      }
    }
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += THREADS)
    element<ADAM, EMA>(k, p, g, m, v, e, i);
}

__global__ void __launch_bounds__(THREADS)
ldm_fused_adam_ema_kernel(const __grid_constant__ LeafTable t, const __grid_constant__ Hyper h,
                          const float* __restrict__ d_ptr) {
  // the leaf of this CTA: the last whose first chunk is at or before it
  const int b = blockIdx.x;
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= b) lo = mid; else hi = mid - 1;
  }
  float* p = t.p[lo];
  const float* g = t.g[lo];
  float* e = t.e[lo];
  const long long start = (long long)(b - t.first_chunk[lo]) * CHUNK;
  const long long end = min(start + CHUNK, t.numel[lo]);

  Coef k;
  k.lr = h.lr; k.b1 = h.b1; k.b2 = h.b2; k.ob1 = h.one_minus_b1; k.ob2 = h.one_minus_b2;
  k.eps = h.eps; k.c1 = 1.f; k.c2 = 1.f; k.d = 0.f; k.od = 1.f;
  if (g != nullptr) {
    const float count = __fadd_rn(*t.step[lo], 1.f);
    k.c1 = __fsub_rn(1.f, powf(h.b1, count));
    k.c2 = __fsub_rn(1.f, powf(h.b2, count));
  }
  if (e != nullptr) {
    k.d = *d_ptr;
    k.od = __fsub_rn(1.f, k.d);
  }
  if (g != nullptr && e != nullptr)
    chunk<true, true>(k, p, g, t.m[lo], t.v[lo], e, start, end);
  else if (g != nullptr)
    chunk<true, false>(k, p, g, t.m[lo], t.v[lo], e, start, end);
  else
    chunk<false, true>(k, p, g, t.m[lo], t.v[lo], e, start, end);
}

}  // namespace

extern "C" {

// The leaves most one launch takes (a longer table goes in groups).
int ldm_fused_adam_ema_leaves() { return LDM_ADAM_LEAVES; }

// n leaves; table: 7 rows of n 64-bit words, in order the addresses of p, g,
// m, v, e and Adam's step (fp32, 0-d) and the element counts.  A g of 0 marks
// a leaf without a gradient (its EMA alone moves: e must be given), an e of 0
// a leaf without an EMA.  d: the EMA weight (fp32, 0-d, on the device; may be
// 0 when no leaf has an EMA).  *launches: the kernel launches made.
int ldm_fused_adam_ema(int n, const long long* table, const float* d, float lr, float b1,
                       float b2, float one_minus_b1, float one_minus_b2, float eps,
                       cudaStream_t stream, int* launches) {
  *launches = 0;
  const Hyper h = {lr, b1, b2, one_minus_b1, one_minus_b2, eps};
  LeafTable t;
  int leaf = 0;
  while (leaf < n) {
    t.n = 0;
    long long chunks = 0;
    for (; leaf < n && t.n < LDM_ADAM_LEAVES; ++leaf) {
      const long long numel = table[6 * n + leaf];
      float* p = reinterpret_cast<float*>(table[leaf]);
      const float* g = reinterpret_cast<const float*>(table[n + leaf]);
      float* m = reinterpret_cast<float*>(table[2 * n + leaf]);
      float* v = reinterpret_cast<float*>(table[3 * n + leaf]);
      float* e = reinterpret_cast<float*>(table[4 * n + leaf]);
      const float* step = reinterpret_cast<const float*>(table[5 * n + leaf]);
      if (numel <= 0 || p == nullptr || (g == nullptr && e == nullptr) ||
          (g != nullptr && (m == nullptr || v == nullptr || step == nullptr)) ||
          (e != nullptr && d == nullptr))
        return cudaErrorInvalidValue;
      const int i = t.n++;
      t.p[i] = p; t.g[i] = g; t.m[i] = m; t.v[i] = v; t.e[i] = e; t.step[i] = step;
      t.numel[i] = numel;
      t.first_chunk[i] = (int)chunks;
      chunks += (numel + CHUNK - 1) / CHUNK;
      if (chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
    }
    t.first_chunk[t.n] = (int)chunks;
    ldm_fused_adam_ema_kernel<<<(unsigned)chunks, THREADS, 0, stream>>>(t, h, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launches;
  }
  return cudaSuccess;
}

}  // extern "C"
