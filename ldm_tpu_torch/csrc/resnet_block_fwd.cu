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
// read of x, one write and one read of h1 and one write of y.  So it is
// bound by arithmetic, and on the CUDA cores in fp32 FMAs that this first
// design uses, far from the tensor cores' rate (the plain version's convs
// run on cuDNN's tensor-core kernels).
//
// What the TPU kernel avoided by holding G whole items in VMEM, and what the
// design does about it:
//   * GroupNorm(8) needs statistics over a whole item before any normalised
//     value exists, twice (the second time over conv1's output).  Here each
//     is its own launch, one CTA an item, a fixed-order sum (no atomics:
//     reruns are bit-identical); the convs apply GN + SiLU as they load.
//   * One item does not fit in a CTA ((1024, 128) bf16 is 256 KiB) and the
//     widest weights (9*768 x 256, 9*512 x 512) do not either: the convs are
//     implicit GEMMs over (B*H*W) x C_out output tiles of 128 x 64, walking
//     K = 9 taps x C_in in steps of 16 channels; the tap's zero padding is
//     decided by each pixel's own h and w, as the TPU kernel's edge masks.
//   * conv1's output h1 goes through a (B, H, W, C_out) scratch in T.
//   Four launches: GN1 statistics, conv1 (+ b1 + temb) into h1, GN2
//   statistics, conv2 (+ b2 + shortcut) into y.  wgmma / TMA, mma.sync, a
//   split of K for the small-M sites, and keeping h1 on chip are later work.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "resnet_block.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, y, h1 and the compute type alike).
// x: (B, H, W, Cin); y, h1: (B, H, W, Cout); temb: (B, Cout) fp32; n1s, n1b:
// (Cin,); w1: (3, 3, Cin, Cout) HWIO; b1, n2s, n2b, b2: (Cout,); w2: (3, 3,
// Cout, Cout); ws: (Cin, Cout) and bs: (Cout,), or ws = NULL for the identity
// shortcut (Cin == Cout); weights and vectors fp32; stats1: (B, G, 2), stats2:
// (B, G, 2) fp32 scratch.  Cin, Cout <= 768, multiples of G.
extern "C" int ldm_resnet_block_fwd(int dtype, const void* x, const float* temb,
                                    const float* n1s, const float* n1b, const float* w1,
                                    const float* b1, const float* n2s, const float* n2b,
                                    const float* w2, const float* b2, const float* ws,
                                    const float* bs, void* y, void* h1, float* stats1,
                                    float* stats2, int B, int H, int W, int Cin, int Cout,
                                    int G, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_block<float, MODE_FULL>(
        static_cast<const float*>(x), temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs,
        static_cast<float*>(y), static_cast<float*>(h1), stats1, stats2, B, H, W, Cin, Cout,
        G, eps, s);
  if (dtype == 1)
    return launch_block<__nv_bfloat16, MODE_FULL>(
        static_cast<const __nv_bfloat16*>(x), temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws,
        bs, static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(h1), stats1, stats2,
        B, H, W, Cin, Cout, G, eps, s);
  return (int)cudaErrorInvalidValue;
}
