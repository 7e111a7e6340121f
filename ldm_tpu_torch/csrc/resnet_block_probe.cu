// Stage ablation of the fused ResNet block forward for Hopper (sm_90a).
//
// Replaces the TPU probe kernel `kernel` of perf/probe13b.py:40 (launched at
// :108): the block's kernel with stages switched off at compile time, to
// show where its time goes.  The modes are resnet_block.cuh's MODE_NOOP,
// MODE_GNONLY, MODE_CENTER and MODE_FULL (MODE_FULL is the production
// kernel of resnet_block_fwd.cu, built from the same body).  The TPU probe's
// `accum` mode (9 accumulating matmuls instead of one lane-concatenated
// patch matmul) has no counterpart: this kernel builds no patch matrix, it
// accumulates tap by tap already, so `accum` is `full`.  Every mode but
// `noop` keeps the block's three launches (the statistics' partial sums, the
// weights rounded once, the epilogues); `gnonly` also loads and normalises
// every chunk's halo tile, `center` multiplies one tap of the nine.
//
// What bounds each mode, and the design: as resnet_block_fwd.cu.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "resnet_block.cuh"

namespace {

template <typename T>
int launch_mode(int mode, const void* x, const float* temb, const float* n1s,
                const float* n1b, const float* w1, const float* b1, const float* n2s,
                const float* n2b, const float* w2, const float* b2, const float* ws,
                const float* bs, void* y, void* h1, void* wt, float* part, int B, int H, int W,
                int Cin, int Cout, int G, float eps, const int* plan, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  T* ht = static_cast<T*>(h1);
  T* wtt = static_cast<T*>(wt);
#define RB_ARGS xt, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs, yt, ht, wtt, part, B, H, \
                W, Cin, Cout, G, eps, plan, s
  switch (mode) {
    case MODE_NOOP: return launch_block<T, MODE_NOOP>(RB_ARGS);
    case MODE_GNONLY: return launch_block<T, MODE_GNONLY>(RB_ARGS);
    case MODE_CENTER: return launch_block<T, MODE_CENTER>(RB_ARGS);
    case MODE_FULL: return launch_block<T, MODE_FULL>(RB_ARGS);
  }
#undef RB_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 noop, 1 gnonly, 2 center, 3 full; the other arguments as
// ldm_resnet_block_fwd's.
extern "C" int ldm_resnet_block_probe(int mode, int dtype, const void* x, const float* temb,
                                      const float* n1s, const float* n1b, const float* w1,
                                      const float* b1, const float* n2s, const float* n2b,
                                      const float* w2, const float* b2, const float* ws,
                                      const float* bs, void* y, void* h1, void* wt, float* part,
                                      int B, int H, int W, int Cin, int Cout, int G, float eps,
                                      const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_mode<float>(mode, x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs, y,
                              h1, wt, part, B, H, W, Cin, Cout, G, eps, plan, s);
  if (dtype == 1)
    return launch_mode<__nv_bfloat16>(mode, x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws,
                                      bs, y, h1, wt, part, B, H, W, Cin, Cout, G, eps, plan,
                                      s);
  return (int)cudaErrorInvalidValue;
}
