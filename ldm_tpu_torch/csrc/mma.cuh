// Tensor-core pieces shared by the linear-attention and the ResNet-block
// kernels: mma.sync.m16n8k16 on bf16 operands with fp32 accumulators, and the
// ldmatrix loads that turn 8x8 blocks of shared memory into its fragments.
#pragma once

#include <cstdint>

#include "numeric.cuh"

namespace {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, each transposed on the way:
// lane i gives the address of row i % 8 of matrix i / 8 (16 bytes, aligned).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 b16 matrices from shared memory as they lie: lane i gives the
// address of row i % 8 of matrix i / 8 (16 bytes, aligned); lane t receives
// elements 2 (t % 4), + 1 of row t / 4 of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- warpgroup products (wgmma): 64 rows of A from registers (each of the
// four warps its 16 rows, the fragments mma.sync takes) times a 16 x 64 B
// tile read from shared memory through a descriptor, fp32 sums in registers.

// A shared-memory matrix descriptor: the start address, the leading and the
// stride byte offsets (all in units of 16 bytes) and the 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t smem_addr, uint32_t lbo16,
                                                     uint32_t sbo16) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)lbo16 << 16) |
         ((uint64_t)sbo16 << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Writes to shared memory by this thread (st.shared, cp.async) become visible
// to wgmma's reads through descriptors.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x 64, this thread's 32 sums: d[j][0..3] the m16n8 outputs of the
// 8-column tile j) += a (64 x 16, row) * B (16 x 64 behind desc, its 64
// columns contiguous in shared memory: trans-b).
__device__ __forceinline__ void wgmma_m64n64k16_bf16_tb(float (&d)[8][4], const uint32_t (&a)[4],
                                                        uint64_t desc) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
        "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
        "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

}  // namespace
