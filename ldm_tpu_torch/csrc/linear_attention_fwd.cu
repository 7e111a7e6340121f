// Fused linear-attention block forward for Hopper (sm_90a), CUDA C++: the
// production entry points, each schedule at STAGE 6.  The kernels, their
// two schedules and what bounds them: linear_attention_fwd.cuh.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "linear_attention_fwd.cuh"

// The cluster / tiled schedule.  dtype: 0 = float32, 1 = bfloat16: the type
// of x, y, the scratch and the two weights.  x, y: (B, N, C), C a multiple
// of 16; wqkv_t: (384, C), the transpose of Wqkv; wout_t: (C, 128), the
// transpose of Wout; vectors (C,) fp32.  C_true: the block's true width, a
// multiple of 8 with C - 16 < C_true <= C; the columns from C_true on are
// zero in x, the weights and the vectors, and come out zero in y.  plan: the
// 10 ints of a FwdPlan (host memory), smem_bytes the dynamic shared memory
// it takes.  qkv_scratch (B, N, 384) and cw_scratch (B * cs, C, 128) in the
// compute type are read only when plan.keep is 0.  Every pointer 16-byte
// aligned.
extern "C" int ldm_lin_attn_fwd(int dtype, const void* x, const void* wqkv_t,
                                const void* wout_t, const float* bout, const float* g1s,
                                const float* g1b, const float* g2s, const float* g2b, void* y,
                                void* qkv_scratch, void* cw_scratch, int B, int N, int C,
                                int C_true, float eps, const int* plan, int smem_bytes,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LA_ARGS x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, qkv_scratch, cw_scratch, B, N, \
                C, C_true, eps, plan, smem_bytes, s
  if (dtype == 0) return launch<float, 6>(LA_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16, 6>(LA_ARGS);
#undef LA_ARGS
  return (int)cudaErrorInvalidValue;
}

// The persistent schedule (bf16 only), arguments as above but for these.
// Scratch, `scratch_slots` slots of each, one a team of the launch:
// cw_scratch (C, 128) bf16, read only when plan.keep_cw is 0; q_scratch
// (plan.qrows, 128) bf16, read only when plan.keep_q is 0.  plan: the 16 ints
// of a PersistPlan.
extern "C" int ldm_lin_attn_fwd_persistent(const void* x, const void* wqkv_t, const void* wout_t,
                                           const float* bout, const float* g1s, const float* g1b,
                                           const float* g2s, const float* g2b, void* y,
                                           void* cw_scratch, void* q_scratch, int scratch_slots,
                                           int B, int N, int C, int C_true, float eps,
                                           const int* plan, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LP_ARGS x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, cw_scratch, q_scratch, \
                scratch_slots, B, N, C, C_true, eps, plan, smem_bytes, s
  // the instantiation: Wqkv^T read from L2 (stage_w 0), q kept in shared
  // memory, and one team alone
  const int variant = (plan[5] == 0) * 2 + (plan[4] != 0);
#define LP_VARIANTS(TEAMS)                                                            \
  switch (variant) {                                                                  \
    case 0: return launch_persistent<6, false, false, TEAMS>(LP_ARGS);                \
    case 1: return launch_persistent<6, false, true, TEAMS>(LP_ARGS);                 \
    case 2: return launch_persistent<6, true, false, TEAMS>(LP_ARGS);                 \
    default: return launch_persistent<6, true, true, TEAMS>(LP_ARGS);                 \
  }
  if (plan[3] == 1) LP_VARIANTS(1)
  LP_VARIANTS(TEAMS_MAX)
#undef LP_VARIANTS
#undef LP_ARGS
  return (int)cudaErrorInvalidValue;
}
