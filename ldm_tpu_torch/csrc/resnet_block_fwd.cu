// Fused UNet ResNet block forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel _resnet_kernel of ldm_tpu/ops/resnet_block.py:133
// (launched by resnet_block_pallas, :272): GroupNorm(8) + SiLU -> 3x3 conv +
// bias + time row -> GroupNorm(8) + SiLU -> 3x3 conv + bias -> + identity or
// 1x1 shortcut, with that kernel's cast points (resnet_block.cuh has the
// kernels and the cast points).
//
// What bounds it: the two 3x3 convolutions, 2 * 9 * (C_in + C_out) * C_out
// FLOPs a pixel (at (1024, 64 -> 64), 2B=256: about 39 GFLOP), against one
// read of x, one write and one read of h1 and one write of y: arithmetic at
// the large images; at the 2x2 and 4x4 sites the fp32 weights (19-28 MB a
// block) against a few thousand pixels: bytes.
//
// What the TPU kernel avoided by holding G whole items in VMEM, and what the
// design does about it:
//   * GroupNorm(8) needs statistics over a whole item before any normalised
//     value exists, twice (the second time over conv1's output).  Partial
//     sums per 128-pixel tile (of x in the prep launch, of h1 in conv1's
//     epilogue, so h1 is not read a third time), finished in a fixed order by
//     the conv that uses them: no launch of their own, no atomics.
//   * One item does not fit in a CTA ((1024, 128) bf16 is 256 KiB) and the
//     widest weights (9*768 x 256, 9*512 x 512) do not either: the convs are
//     implicit GEMMs over (B*H*W) x C_out output tiles of 128 x 64 on the
//     tensor cores in bf16 (wgmma.m64n64k16, fp32 sums), K = 9 taps x C_in
//     walked a 128-byte chunk of channels at a time: the chunk's pixels and
//     halo are loaded and normalised once and all nine taps read shifted rows
//     of that tile; the weights, rounded to bf16 once a launch, come through
//     a cp.async ring; two CTAs fit an SM.
//   * At the small images (2x2, 4x4) there are few output tiles and a long
//     K: up to 8 CTAs of a thread-block cluster share a tile, each a range
//     of K, and their partial tiles are added in rank order through
//     distributed shared memory.
//   * conv1's output h1 goes through a (B, H, W, C_out) scratch in T.
//   Three launches: prep (GN1 partials, weights to T), conv1 (+ b1 + temb,
//   GN2 partials) into h1, conv2 (+ b2 + shortcut) into y.  TMA, more than
//   two CTAs' worth of warps an SM and keeping h1 on chip are later work.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "resnet_block.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, y, h1, wt and the compute type alike).
// x: (B, H, W, Cin); y, h1: (B, H, W, Cout); temb: (B, Cout) fp32; n1s, n1b:
// (Cin,); w1: (3, 3, Cin, Cout) HWIO; b1, n2s, n2b, b2: (Cout,); w2: (3, 3,
// Cout, Cout); ws: (Cin, Cout) and bs: (Cout,), or ws = NULL for the identity
// shortcut (Cin == Cout); weights and vectors fp32.  Scratch: h1; wt, the
// padded weights in the compute type (plan[4] elements); part, the
// statistics' partial sums (plan[5] floats).  plan: the 6 ints of an RbPlan
// (host memory), from ops/resnet_block.py::plan_resnet.  Cin, Cout <= 768,
// multiples of G.
extern "C" int ldm_resnet_block_fwd(int dtype, const void* x, const float* temb,
                                    const float* n1s, const float* n1b, const float* w1,
                                    const float* b1, const float* n2s, const float* n2b,
                                    const float* w2, const float* b2, const float* ws,
                                    const float* bs, void* y, void* h1, void* wt, float* part,
                                    int B, int H, int W, int Cin, int Cout, int G, float eps,
                                    const int* plan, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_block<float, MODE_FULL>(
        static_cast<const float*>(x), temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs,
        static_cast<float*>(y), static_cast<float*>(h1), static_cast<float*>(wt), part, B, H,
        W, Cin, Cout, G, eps, plan, s);
  if (dtype == 1)
    return launch_block<__nv_bfloat16, MODE_FULL>(
        static_cast<const __nv_bfloat16*>(x), temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws,
        bs, static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(h1),
        static_cast<__nv_bfloat16*>(wt), part, B, H, W, Cin, Cout, G, eps, plan, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef RB_CLOCKS
// out: 16 clock64() stamps, conv1's 7 at 0, conv2's at 8 (perf/resnet_clocks.py).
extern "C" int ldm_resnet_block_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, rb_clk, sizeof(rb_clk));
}
#endif
