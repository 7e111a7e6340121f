// Stage ablation of the fused linear-attention block forward for Hopper
// (sm_90a): probe 7's library (perf/probe7.py), built only when the probe
// asks for it.
//
// Replaces the TPU probe kernel `_kernel` of perf/probe7.py:30 (launched at
// :128): both schedules of linear_attention_fwd.cuh built with STAGE 1-6,
// cut after stage 1 GN1, 2 + qkv, 3 + q softmax, 4 + k path, 5 + ctx /
// ctx@Wout / out, and 6 the whole block.  Stage 6 is the production kernel's
// template instantiation, built here again; the probe holds it bit for bit
// against linear_attention_fwd.cu's.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include "linear_attention_fwd.cuh"

// The cluster / tiled schedule by stage (1-6); the other arguments as
// ldm_lin_attn_fwd's.
extern "C" int ldm_lin_attn_fwd_stage(int stage, int dtype, const void* x, const void* wqkv_t,
                                      const void* wout_t, const float* bout, const float* g1s,
                                      const float* g1b, const float* g2s, const float* g2b,
                                      void* y, void* qkv_scratch, void* cw_scratch, int B,
                                      int N, int C, int C_true, float eps, const int* plan,
                                      int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LA_ARGS x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, qkv_scratch, cw_scratch, B, N, \
                C, C_true, eps, plan, smem_bytes, s
#define LA_STAGES(T)                           \
  switch (stage) {                             \
    case 1: return launch<T, 1>(LA_ARGS);      \
    case 2: return launch<T, 2>(LA_ARGS);      \
    case 3: return launch<T, 3>(LA_ARGS);      \
    case 4: return launch<T, 4>(LA_ARGS);      \
    case 5: return launch<T, 5>(LA_ARGS);      \
    case 6: return launch<T, 6>(LA_ARGS);      \
  }
  if (dtype == 0) LA_STAGES(float)
  if (dtype == 1) LA_STAGES(__nv_bfloat16)
#undef LA_STAGES
#undef LA_ARGS
  return (int)cudaErrorInvalidValue;
}

// The persistent schedule by stage (1-6), in the one instantiation probe
// 7's shape, (128, 1024, 64), takes: Wqkv^T staged, q out of shared memory,
// two teams (the build's time); the launcher refuses another plan.  The
// other arguments as ldm_lin_attn_fwd_persistent's.
extern "C" int ldm_lin_attn_fwd_persistent_stage(
    int stage, const void* x, const void* wqkv_t, const void* wout_t, const float* bout,
    const float* g1s, const float* g1b, const float* g2s, const float* g2b, void* y,
    void* cw_scratch, void* q_scratch, int scratch_slots, int B, int N, int C, int C_true,
    float eps, const int* plan, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LP_ARGS x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, cw_scratch, q_scratch, \
                scratch_slots, B, N, C, C_true, eps, plan, smem_bytes, s
  switch (stage) {
    case 1: return launch_persistent<1, false, false, TEAMS_MAX>(LP_ARGS);
    case 2: return launch_persistent<2, false, false, TEAMS_MAX>(LP_ARGS);
    case 3: return launch_persistent<3, false, false, TEAMS_MAX>(LP_ARGS);
    case 4: return launch_persistent<4, false, false, TEAMS_MAX>(LP_ARGS);
    case 5: return launch_persistent<5, false, false, TEAMS_MAX>(LP_ARGS);
    case 6: return launch_persistent<6, false, false, TEAMS_MAX>(LP_ARGS);
  }
#undef LP_ARGS
  return (int)cudaErrorInvalidValue;
}
