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
// Three launches a block:
//   1. prep: per 128-pixel tile of x, the sums of v and v^2 per (item,
//      group), the partials of GN1's statistics; and the three weights
//      rounded to T once, into a zero-padded copy whose rows are whole
//      K chunks and whose columns are whole column tiles, so that no weight
//      load needs a mask.
//   2. conv1 (+ b1 + temb) into the h1 scratch, and in its epilogue the same
//      partial sums of h1 for GN2.
//   3. conv2 (+ b2 + shortcut) into y.
// A statistic is finished where it is used: a conv's prologue adds the
// partials of the items its tile touches in a fixed order.
//
// A conv is an implicit GEMM over the B*H*W pixels (rows, tiles of 128) and
// the C_out channels (columns, tiles of 64); K runs over the units (channel
// chunk, tap), a chunk being 128 bytes of channels (64 in bf16, 32 in fp32),
// and for conv2's 1x1 shortcut over the chunks of x once more.
//   * The A operand: for one chunk the tile's pixels and their halo (the
//     W + 1 pixels before and after in linear order) are read once, 16 bytes
//     a thread along C, normalised once, rounded to T and kept in shared
//     memory; the nine taps read shifted rows of it.  Zero padding is decided
//     by each output pixel's own (h, w): a tile may span many items (32 at
//     2x2), and a tap that would leave its pixel's image reads a row of
//     zeros instead of the neighbouring item's pixel.
//   * The B operand: the unit's 64 (32) weight rows by 64 columns, copied
//     with cp.async through a ring of three tiles (bf16: rows of 128 bytes
//     under the 128-byte swizzle, as wgmma reads them); the next chunk's A
//     tile is filled between the products of this chunk's units (its loads go
//     out before a unit's products, its arithmetic comes after), so one
//     __syncthreads() a unit is all that orders loads and products.
//   * The products: bf16 on the tensor cores as wgmma.m64n64k16, fp32
//     accumulators: a warpgroup owns 64 of the tile's rows and all 64
//     columns; A comes from registers (each warp's 16 x 16 fragments by
//     ldmatrix from the halo tile, whose rows a lane picks one by one, which
//     no descriptor could), B from shared memory through a descriptor.
//     mma.sync.m16n8k16 with B by ldmatrix.trans was 4-6% slower at every
//     site.  fp32 as exact FMAs on the CUDA cores (TF32 would break the fp32
//     tolerance), a thread owning 8 x 4.
//   * Where the grid of tiles would not fill the card, `split` CTAs of a
//     thread-block cluster share a tile, each taking a contiguous range of the
//     units; each then adds the ranks' fp32 partial tiles, in rank order and
//     through distributed shared memory, for its share of the tile's rows and
//     writes those rows out.  No atomics anywhere: reruns are bit-identical.
//
// Modes (each output depends on every stage the mode keeps, so nvcc deletes
// none of them):
//   MODE_NOOP    y = x: one read and one write, the launch and memory floor;
//   MODE_GNONLY  both GN + SiLU passes (the statistics and every chunk's
//                normalised tile), no products: each "conv" is its normalised
//                input's centre pixel (C_in == C_out);
//   MODE_CENTER  each conv is its centre tap only (one K = C product);
//   MODE_FULL    the block.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>

#include "mma.cuh"
#include "numeric.cuh"

namespace cg = cooperative_groups;

// With -DRB_CLOCKS (perf/resnet_clocks.py builds a copy so) thread 0 of the
// middle CTA of each conv stamps clock64() at the ends of its phases.
#ifdef RB_CLOCKS
__device__ long long rb_clk[16];
#define RB_CLK(i)                                                                       \
  if (threadIdx.x == 0 && blockIdx.x == gridDim.x / 2 && blockIdx.y == 0 && blockIdx.z == 0) \
    rb_clk[(SECOND ? 8 : 0) + (i)] = clock64();
#else
#define RB_CLK(i)
#endif

namespace {

constexpr int MODE_NOOP = 0, MODE_GNONLY = 1, MODE_CENTER = 2, MODE_FULL = 3;

constexpr int RB_NT = 256;          // threads per CTA
constexpr int RB_TM = 128;          // output pixels per tile
constexpr int RB_TN = 64;           // output channels per tile
constexpr int RB_ROWB = 144;        // bytes of an A-tile row: a 128-byte chunk + 16 of padding
constexpr int RB_STAGES = 3;        // B tiles in the cp.async ring
constexpr int RB_ASTG = 2;          // 16-byte loads of the next A tile held over a product
constexpr int RB_LDC = RB_TN + 4;   // row stride of the fp32 output tile
constexpr int RB_MAX_C = 768;       // widest C_in / C_out
constexpr int RB_MAX_SPLIT = 8;     // the portable cluster size
constexpr int RB_SMEM_LIMIT = 232448;
constexpr int RB_N_PLAN = 6;        // ints of an RbPlan

template <typename T> constexpr bool RB_BF16 = std::is_same<T, __nv_bfloat16>::value;
template <typename T> constexpr int RB_E = 16 / (int)sizeof(T);    // elements in 16 bytes
template <typename T> constexpr int RB_CK = 128 / (int)sizeof(T);  // channels per chunk
template <typename T> constexpr int RB_LDA = RB_ROWB / (int)sizeof(T);
// row stride of a B tile: fp32 padded by 16 bytes; bf16 128 bytes, swizzled
template <typename T> constexpr int RB_LDB = RB_BF16<T> ? RB_TN : RB_TN + RB_E<T>;
// the bf16 B ring starts on a multiple of 1024 bytes (the swizzle's period)
template <typename T> constexpr int RB_B_ALIGN = RB_BF16<T> ? 1024 : 16;

// The launch plan, made by ops/resnet_block.py::plan_resnet from the shapes
// alone and checked against this file's own arithmetic at every launch.
struct RbPlan {
  int split1, split2;  // CTAs sharing an output tile in conv1 / conv2
  int smem1, smem2;    // dynamic shared memory of conv1 / conv2
  int wt_elems;        // elements of T of the padded weight copy
  int part_floats;     // floats of the two statistics partial arrays
};

__host__ __device__ constexpr int rb_round_up(int v, int m) { return (v + m - 1) / m * m; }

// Items a run of `rows` consecutive pixels can touch, N pixels an item.
__host__ __device__ constexpr int rb_slots(int rows, int N) {
  const int s = (rows + N - 2) / N + 1;
  return s < rows ? s : rows;
}

// Shared memory of a conv CTA, in bytes from the start of the dynamic array.
// The fp32 output tile of the epilogue lies over the A tiles.
struct RbLayout {
  int hr;       // rows of the halo tile: RB_TM + 2 W + 2; row hr is the row of zeros
  int nsl;      // items the halo tile can touch
  int a_bytes;  // one A tile
  int off_b, off_gsb, off_stats, off_vmask, off_rslot, total;
};

template <typename T>
__host__ __device__ inline RbLayout rb_layout(int N, int W, int Csp, int G) {
  RbLayout L;
  L.hr = RB_TM + 2 * W + 2;
  L.nsl = rb_slots(L.hr, N);
  L.a_bytes = (L.hr + 1) * RB_ROWB;
  L.off_b = rb_round_up(2 * L.a_bytes, RB_B_ALIGN<T>);
  // the ring, and room to align it whatever the dynamic array's own address
  L.off_gsb = L.off_b + RB_STAGES * RB_CK<T> * RB_LDB<T> * (int)sizeof(T) +
              (RB_BF16<T> ? RB_B_ALIGN<T> : 0);
  L.off_stats = L.off_gsb + 2 * Csp * 4;
  L.off_vmask = L.off_stats + L.nsl * G * 2 * 4;
  L.off_rslot = L.off_vmask + RB_TM * 4;
  L.total = L.off_rslot + L.hr * 4;
  return L;  // 2 * a_bytes >= RB_TM * RB_LDC * 4 for every W >= 1
}

// ---- 16 bytes of T <-> fp32 (4 floats, or 8 bf16)
__device__ __forceinline__ void unpack16(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float (&v)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Elements c .. c + E of a row of C elements of T: one 16-byte load where
// the rows are 16-byte aligned (vec), else element by element, zeros past C.
template <typename T>
__device__ __forceinline__ uint4 load_unit(const T* __restrict__ row, int c, int C, bool vec) {
  if (c >= C) return make_uint4(0u, 0u, 0u, 0u);  // a chunk's padding past the last channel
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + c));
  float v[RB_E<T>];
#pragma unroll
  for (int e = 0; e < RB_E<T>; ++e) v[e] = c + e < C ? to_f(row[c + e]) : 0.f;
  return pack16(v);
}

// The first n (<= E) of E values to a row of T, rounded: 16 bytes where vec.
template <typename T>
__device__ __forceinline__ void store_unit(T* __restrict__ dst, const float (&v)[RB_E<T>], int n,
                                           bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = pack16(v);
  } else {
#pragma unroll
    for (int e = 0; e < RB_E<T>; ++e)
      if (e < n) dst[e] = from_f<T>(v[e]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src_global) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src_global)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// SiLU of an fp32 value, y / (1 + 2^(-y log2 e)), with the approximate
// exponential and reciprocal (denormals flushed): a relative error of a few
// 1e-7, far inside the fp32 tolerance, in five instructions.
__device__ __forceinline__ float silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

// The partial sums of GroupNorm's statistics over the rows [row_lo, row_hi)
// of the tile of pixels from m0 and the columns [col0, col1) of a matrix of C
// channels: for every item slot s < sl (item m0 / N + s) and every group
// g < G the sums of v and v^2 over the slot's rows and the group's columns
// inside that window, written to part[(s * G + g) * 2]; zeros where the
// window holds none.  A team of lanes a (slot, group) that the window holds
// (8 lanes where it has at most 256 values there, else the warp), the lanes
// striding the values, a shuffle sum: an order fixed by the shapes.
// val(r, c) is the value at tile row r and channel c.
template <typename Val>
__device__ __forceinline__ void tile_group_sums(Val val, float* __restrict__ part, int m0,
                                                int row_lo, int row_hi, int col0, int col1,
                                                int N, int G, int per, int sl) {
  const int b0 = m0 / N;
  const bool any = row_hi > row_lo && col1 > col0;
  const int s_lo = any ? (m0 + row_lo) / N - b0 : 0;
  const int ns = any ? (m0 + row_hi - 1) / N - b0 - s_lo + 1 : 0;  // slots with rows in it
  const int g_lo = col0 / per, ng = any ? (col1 - 1) / per - g_lo + 1 : 0;  // groups likewise
  for (int i = threadIdx.x; i < sl * G; i += RB_NT) {
    const int s = i / G, g = i - s * G;
    if (s < s_lo || s >= s_lo + ns || g < g_lo || g >= g_lo + ng)
      part[2 * i] = part[2 * i + 1] = 0.f;
  }
  const int tl = min(N, row_hi - row_lo) * min(per, col1 - col0) <= 256 ? 8 : 32;  // lanes a team
  const int team = threadIdx.x / tl, lane = threadIdx.x % tl;
  for (int pair = team; pair < rb_round_up(ns * ng, RB_NT / tl); pair += RB_NT / tl) {
    const bool live = pair < ns * ng;  // every lane of a warp takes part in its shuffles
    const int s = s_lo + (live ? pair / ng : 0), g = g_lo + (live ? pair % ng : 0);
    const int ra = max((b0 + s) * N - m0, row_lo), rb = min((b0 + s + 1) * N - m0, row_hi);
    const int ca = max(g * per, col0), cb = min((g + 1) * per, col1);
    const int nc = max(cb - ca, 1), tot = live ? (rb - ra) * nc : 0;
    // lane's element i is (row i / nc, column i % nc); a step of tl elements
    const int dr = tl / nc, dc = tl - dr * nc;
    int r = ra + lane / nc, c = ca + lane % nc;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int i = lane; i < tot; i += tl) {
      const float v = val(r, c);
      s1 += v;
      s2 = fmaf(v, v, s2);
      r += dr;
      c += dc;
      if (c >= cb) {
        c -= nc;
        ++r;
      }
    }
    for (int o = tl >> 1; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (live && lane == 0) {
      part[(size_t)(s * G + g) * 2] = s1;
      part[(size_t)(s * G + g) * 2 + 1] = s2;
    }
  }
}

// Launch 1.  CTAs [0, m_tiles * nt_in): the partials of GN1's statistics of
// x, one pixel tile and one tile of RB_TN channels each, into part1
// (m_tiles, nt_in, sl, G, 2); vec_x: the rows of x are 16-byte aligned.  The
// other CTAs: w1 (9, Cin, Cout), w2
// (9, Cout, Cout) and ws (Cin, Cout) rounded to T into wt = w1 as
// (9, Cip, Cop) | w2 as (9, Cmp, Cop) | ws as (Cip, Cop), the rows padded to
// whole chunks and the columns to whole tiles with zeros; 16-byte loads
// where the rows of the fp32 weights are 16-byte aligned (vec_w).
template <typename T>
__global__ void __launch_bounds__(RB_NT)
resnet_prep_kernel(const T* __restrict__ x, float* __restrict__ part1,
                   const float* __restrict__ w1, const float* __restrict__ w2,
                   const float* __restrict__ ws, T* __restrict__ wt, int M, int N, int Cin,
                   int Cout, int G, int m_tiles, int nt_in, int vec_x, int vec_w) {
  constexpr int E = RB_E<T>, CK = RB_CK<T>;
  const int stat_ctas = m_tiles * nt_in;
  if ((int)blockIdx.x < stat_ctas) {
    // the tile through shared memory: 16-byte loads along C, all in flight
    __shared__ float tile[RB_TM * (RB_TN + 1)];
    const int mt = blockIdx.x / nt_in, nt = blockIdx.x - mt * nt_in;
    const int m0 = mt * RB_TM, c0 = nt * RB_TN, sl = rb_slots(RB_TM, N);
    const int rows = min(RB_TM, M - m0);
    constexpr int UPT = RB_TN / E;  // 16-byte units a row of the tile
#pragma unroll
    for (int i = 0; i < RB_TM * UPT / RB_NT; ++i) {
      const int u = i * RB_NT + threadIdx.x, r = u / UPT, c = (u - r * UPT) * E;
      if (r >= rows) continue;
      float v[E];
      unpack16(load_unit<T>(x + (size_t)(m0 + r) * Cin, c0 + c, Cin, vec_x), v);
#pragma unroll
      for (int e = 0; e < E; ++e) tile[r * (RB_TN + 1) + c + e] = v[e];
    }
    __syncthreads();
    tile_group_sums([&](int r, int c) { return tile[r * (RB_TN + 1) + c - c0]; },
                    part1 + (size_t)blockIdx.x * sl * G * 2, m0, 0, rows, c0,
                    min(c0 + RB_TN, Cin), N, G, Cin / G, sl);
    return;
  }
  const int Cip = rb_round_up(Cin, CK), Cmp = rb_round_up(Cout, CK);
  const int Cop = rb_round_up(Cout, RB_TN), upr = Cop / E;
  const long long n1 = 9LL * Cip * upr, n2 = 9LL * Cmp * upr;
  const long long n3 = ws != nullptr ? (long long)Cip * upr : 0;
  const long long stride = (long long)(gridDim.x - stat_ctas) * RB_NT;
  for (long long u = (long long)(blockIdx.x - stat_ctas) * RB_NT + threadIdx.x;
       u < n1 + n2 + n3; u += stride) {
    // which matrix, its padded and true rows per tap, the unit inside it
    const bool second = u >= n1 && u < n1 + n2;
    const float* src = u < n1 ? w1 : (second ? w2 : ws);
    const long long v = u < n1 ? u : (second ? u - n1 : u - n1 - n2);
    const int rp = second ? Cmp : Cip, rt = second ? Cout : Cin;
    const int col = (int)(v % upr) * E;
    const long long row = v / upr;
    const int tap = (int)(row / rp), k = (int)(row - (long long)tap * rp);
    const float* srow = src + ((size_t)tap * rt + k) * Cout;
    float o[E];
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      if (vec_w && k < rt && col + e + 3 < Cout) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(srow + col + e));
        o[e] = t.x; o[e + 1] = t.y; o[e + 2] = t.z; o[e + 3] = t.w;
      } else {
#pragma unroll
        for (int q = e; q < e + 4; ++q) o[q] = (k < rt && col + q < Cout) ? srow[col + q] : 0.f;
      }
    }
    *reinterpret_cast<uint4*>(wt + (size_t)u * E) = pack16(o);
  }
}

// What a conv launch reads and writes.
template <typename T> struct RbConv {
  const T* src;          // conv1: x; conv2: h1; (M, Cs)
  const float* part;     // the partials of src's statistics,
                         // (m_tiles, part_nt, part_split, sl, G, 2)
  const float* gs;       // GroupNorm scale and bias of src, (Cs,)
  const float* gb;
  const T* w;            // the padded (9, Csp, Cop) weights in T
  const float* bias;     // (Co,)
  const float* temb;     // conv1: (B, Co)
  const T* x;            // conv2: the block's input, (M, Cx)
  const T* ws;           // conv2: the padded (Cxp, Cop) shortcut weights, or nullptr
  const float* bs;       // conv2: (Co,)
  T* out;                // (M, Co)
  float* part_out;       // conv1: the partials of h1's statistics
  int M, H, W, Cs, Co, Cx, G;
  int part_nt;           // column tiles that wrote `part`
  int part_split;        // ranks a (pixel tile, column tile) that wrote `part`
  int split;             // CTAs of the cluster sharing this tile
  int vec_src, vec_x, vec_out;  // rows of src / x / out (and h1) are 16-byte aligned
  int vec_t;             // conv1: and the rows of temb
  float eps;
};

// Launches 2 and 3: one CTA (with split > 1: one cluster) an output tile.
// SECOND = false (conv1): out = h1 = T(T(T(sum) + T(b1)) + T(temb)), and the
// partials of h1's statistics.  SECOND = true (conv2): out = y = T(sum + b2 +
// shortcut); a 1x1 shortcut (ws != nullptr) adds x @ ws into the same sum and
// bs at the end, else the shortcut is x itself.
template <typename T, int MODE, bool SECOND>
__global__ void __launch_bounds__(RB_NT, RB_BF16<T> ? 2 : 1) resnet_conv_kernel(const RbConv<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  RB_CLK(0)
  constexpr int E = RB_E<T>, CK = RB_CK<T>, LDA = RB_LDA<T>, LDB = RB_LDB<T>;
  constexpr int UPR = CK / E;  // 16-byte units in a chunk's row
  constexpr int TAPS = MODE == MODE_FULL ? 9 : 1, TAP0 = MODE == MODE_FULL ? 0 : 4;
  constexpr bool PRODUCT = MODE == MODE_FULL || MODE == MODE_CENTER;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.W, N = a.H * a.W, M = a.M, G = a.G, per = a.Cs / a.G;
  const int m0 = blockIdx.x * RB_TM, n0 = blockIdx.y * RB_TN, rank = blockIdx.z;
  const int Csp = rb_round_up(a.Cs, CK), Cop = gridDim.y * RB_TN;
  const RbLayout L = rb_layout<T>(N, W, Csp, G);
  T* const A0 = reinterpret_cast<T*>(smem);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  T* const Bs = reinterpret_cast<T*>(
      smem + L.off_b + (RB_B_ALIGN<T> - (smem_addr + L.off_b) % RB_B_ALIGN<T>) % RB_B_ALIGN<T>);
  float* const gsm = reinterpret_cast<float*>(smem + L.off_gsb);
  float* const gbm = gsm + Csp;
  float* const stats = reinterpret_cast<float*>(smem + L.off_stats);
  int* const vmask = reinterpret_cast<int*>(smem + L.off_vmask);
  int* const rslot = reinterpret_cast<int*>(smem + L.off_rslot);
  float* const Ct = reinterpret_cast<float*>(smem);
  const size_t a_elems = (size_t)L.a_bytes / sizeof(T);
  const int zero_row = L.hr;

  // this CTA's units: conv units (chunk-major, TAPS a chunk), then the 1x1
  // shortcut's chunks of x; a contiguous range of them a rank
  const int nchunk = Csp / CK, nconv = nchunk * TAPS;
  const int nshort = (SECOND && a.ws != nullptr) ? rb_round_up(a.Cx, CK) / CK : 0;
  const int U = nconv + nshort;
  const int u0 = (int)((long long)U * rank / a.split);
  const int u1 = (int)((long long)U * (rank + 1) / a.split);
  // the A tile a unit reads: a chunk of src (< nchunk), or of x
  auto tile_of = [&](int u) { return u < nconv ? u / TAPS : nchunk + (u - nconv); };
  auto tile_end = [&](int u) { return u < nconv ? (u / TAPS + 1) * TAPS : u + 1; };

  // ---- B ring: unit u's CK x RB_TN weight tile into ring stage st
  auto load_b = [&](int u, int st) {
    if (u < nconv && !PRODUCT) return;
    const T* wsrc;
    if (u < nconv) {
      const int chunk = u / TAPS, tap = TAP0 + u - chunk * TAPS;
      wsrc = a.w + ((size_t)tap * Csp + (size_t)chunk * CK) * Cop + n0;
    } else {
      wsrc = a.ws + (size_t)(u - nconv) * CK * Cop + n0;
    }
    T* dst = Bs + (size_t)st * CK * LDB;
    constexpr int CPR = RB_TN / E;  // 16-byte copies a row
    for (int i = tid; i < CK * CPR; i += RB_NT) {
      const int r = i / CPR, q = (i - r * CPR) * E;
      // bf16: the 16-byte piece q of row r at piece q ^ (r % 8), the 128-byte swizzle
      const int qs = RB_BF16<T> ? ((q / E) ^ (r & 7)) * E : q;
      cp_async16(dst + r * LDB + qs, wsrc + (size_t)r * Cop + q);
    }
  };
  for (int i = 0; i < RB_STAGES - 1; ++i) {  // so many tiles ahead of the products
    if (u0 + i < u1) load_b(u0 + i, i);
    cp_async_commit();
  }

  // ---- the A tile of one chunk, filled in passes of RPP rows: in a pass
  // thread t takes the 16-byte unit t % UPR of row t / UPR.  A chunk of src:
  // the halo rows, GN + SiLU, rounded to T.  A chunk of x (the shortcut): the
  // tile's own rows as they are.  Rows whose pixel does not exist stay
  // unwritten: no valid tap reads them.
  constexpr int RPP = RB_NT / UPR;
  const int f_row = tid / UPR, f_c = (tid % UPR) * E;
  auto a_passes = [&](int tile) { return ((tile >= nchunk ? RB_TM : L.hr) + RPP - 1) / RPP; };
  auto a_row = [&](int tile, int k) {  // this thread's halo row in pass k, -1: nothing to do
    const bool sc = tile >= nchunk;
    const int r = k * RPP + f_row;
    if (r >= (sc ? RB_TM : L.hr)) return -1;
    const int hrow = (sc ? W + 1 : 0) + r, p = m0 - (W + 1) + hrow;
    return p >= 0 && p < M ? hrow : -1;
  };
  auto a_load = [&](int tile, int hrow) {
    const size_t p = (size_t)(m0 - (W + 1) + hrow);
    if (tile >= nchunk)
      return load_unit<T>(a.x + p * a.Cx, (tile - nchunk) * CK + f_c, a.Cx, a.vec_x);
    return load_unit<T>(a.src + p * a.Cs, tile * CK + f_c, a.Cs, a.vec_src);
  };
  // ---- prologue: the rows of zeros, scale and bias, the tap masks, the
  // statistics of the items the halo tile touches
  for (int i = tid; i < 2 * UPR; i += RB_NT)
    *reinterpret_cast<uint4*>(A0 + (size_t)(i / UPR) * a_elems + (size_t)zero_row * LDA +
                              (i % UPR) * E) = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < Csp; c += RB_NT) {
    gsm[c] = c < a.Cs ? a.gs[c] : 0.f;
    gbm[c] = c < a.Cs ? a.gb[c] : 0.f;
  }
  for (int r = tid; r < RB_TM; r += RB_NT) {
    const int p = m0 + r;
    int mask = 0;
    if (p < M) {
      const int q = p % N, h = q / W, w = q - h * W;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int hh = h + t / 3 - 1, ww = w + t % 3 - 1;
        if (hh >= 0 && hh < a.H && ww >= 0 && ww < W) mask |= 1 << t;
      }
    }
    vmask[r] = mask;
  }
  const int p_first = max(m0 - (W + 1), 0);  // first pixel of the halo tile that exists
  const int b_first = p_first / N;
  for (int hrow = tid; hrow < L.hr; hrow += RB_NT) {  // a halo row's item slot; -1: no pixel
    const int p = m0 - (W + 1) + hrow;
    rslot[hrow] = p >= 0 && p < M ? p / N - b_first : -1;
  }
  {
    const int sl = rb_slots(RB_TM, N), m_tiles = gridDim.x;
    const int b_last = (min(m0 + RB_TM + W + 1, M) - 1) / N;
    const float cnt = (float)N * (float)per;
    for (int i = tid; i < (b_last - b_first + 1) * G; i += RB_NT) {
      const int s = i / G, g = i - s * G, b = b_first + s;
      const int mt0 = (int)(((long long)b * N) / RB_TM);
      const int mt1 = min((int)(((long long)(b + 1) * N - 1) / RB_TM), m_tiles - 1);
      // the partials of the (pixel tile, column tile, rank of the producer)s
      // that hold rows of the item, eight loads in flight, added in their
      // order; a rank holds RB_TM / part_split rows of a tile, and an item's
      // rows in a tile lie in at most nk ranks from the one of its first row
      const int rpr = RB_TM / a.part_split;
      const int nk = min(a.part_split, (min(N, RB_TM) - 1) / rpr + 2);
      const int per_mt = nk * a.part_nt, cnt_j = (mt1 - mt0 + 1) * per_mt;
      float s1 = 0.f, s2 = 0.f;
      for (int j0 = 0; j0 < cnt_j; j0 += 8) {
        float2 pv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + q;
          pv[q] = make_float2(0.f, 0.f);
          if (j < cnt_j) {
            const int mt = mt0 + j / per_mt, rem = j % per_mt;
            const int kk = rem / a.part_nt, nt = rem - kk * a.part_nt, t0 = mt * RB_TM;
            const int ra = max(b * N, t0) - t0;
            const int rb = min(min((b + 1) * N, t0 + RB_TM), M) - 1 - t0;
            const int k = ra / rpr + kk, slot = b - t0 / N;
            if (k <= rb / rpr)
              pv[q] = *reinterpret_cast<const float2*>(
                  a.part +
                  (((((size_t)mt * a.part_nt + nt) * a.part_split + k) * sl + slot) * G + g) * 2);
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          s1 += pv[q].x;
          s2 += pv[q].y;
        }
      }
      const float mu = s1 / cnt;
      const float var = fmaxf(s2 / cnt - mu * mu, 0.f);
      stats[2 * i] = mu;
      stats[2 * i + 1] = rsqrtf(var + a.eps);
    }
  }
  __syncthreads();
  RB_CLK(1)  // the prologue

  auto a_store = [&](int tile, T* A, int hrow, const uint4& raw) {
    uint4 o = raw;
    if (tile < nchunk) {
      const int c = tile * CK + f_c;
      const float* st = stats + (size_t)rslot[hrow] * G * 2;
      float v[E];
      unpack16(raw, v);
      if (c >= a.Cs) {  // a chunk's padding past the last channel
#pragma unroll
        for (int e = 0; e < E; ++e) v[e] = 0.f;
      } else if (per % E == 0) {  // the unit lies in one group
        const float2 mi = *reinterpret_cast<const float2*>(st + 2 * (c / per));
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 gs4 = *reinterpret_cast<const float4*>(gsm + c + e);
          const float4 gb4 = *reinterpret_cast<const float4*>(gbm + c + e);
          const float gsv[4] = {gs4.x, gs4.y, gs4.z, gs4.w}, gbv[4] = {gb4.x, gb4.y, gb4.z, gb4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float sc = mi.y * gsv[q];
            v[e + q] = silu(fmaf(v[e + q], sc, gbv[q] - mi.x * sc));
          }
        }
      } else {
        int g = c / per, left = per - (c - g * per);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float mu = st[2 * min(g, G - 1)], sc = st[2 * min(g, G - 1) + 1] * gsm[c + e];
          v[e] = c + e < a.Cs ? silu(fmaf(v[e], sc, gbm[c + e] - mu * sc)) : 0.f;
          if (--left == 0) {
            ++g;
            left = per;
          }
        }
      }
      o = pack16(v);
    }
    *reinterpret_cast<uint4*>(A + (size_t)hrow * LDA + f_c) = o;
  };
  auto a_fill = [&](int tile, T* A, int k0, int k1) {  // passes [k0, k1), four loads in flight
    for (int k = k0; k < k1; k += 4) {
      int hrow[4];
      uint4 raw[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hrow[q] = k + q < k1 ? a_row(tile, k + q) : -1;
        if (hrow[q] >= 0) raw[q] = a_load(tile, hrow[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (hrow[q] >= 0) a_store(tile, A, hrow[q], raw[q]);
    }
  };

  // ---- accumulators: bf16 acc[i][j] is output j (the m16n8 fragment's) of
  // the warp's 16 rows and the 8-column tile i; fp32 acc[i][j] is row r0 + i,
  // column j0 + j.
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;  // bf16: the warp's 16 rows (of its
                                                        // warpgroup's 64), all 64 columns
  const int gq = lane >> 2, tig = lane & 3;     // bf16: the fragment's row and column pair
  const int lq = lane >> 3, lr = lane & 7;      // bf16: ldmatrix matrix and row of this lane
  const int r0 = (tid >> 4) * 8, j0 = (tid & 15) * 4;  // fp32: the thread's 8 x 4 block
  auto acc_row = [&](int i, int j) { return RB_BF16<T> ? wrow + gq + (j >> 1) * 8 : r0 + i; };
  auto acc_col = [&](int i, int j) { return RB_BF16<T> ? i * 8 + 2 * tig + (j & 1) : j0 + j; };
  // the tap masks of the rows this thread addresses in the A tile
  int vm[RB_BF16<T> ? 1 : 8];
  if constexpr (RB_BF16<T>) {
    vm[0] = vmask[wrow + (lq & 1) * 8 + lr];
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) vm[i] = vmask[r0 + i];
  }

  // acc += (the tile's rows of A shifted by the tap, zeros where the tap
  // leaves the image) @ (the unit's B tile)
  auto product = [&](const T* A, const T* B, int tap) {
    const int shift = (W + 1) + (tap / 3 - 1) * W + (tap % 3 - 1);
    if constexpr (RB_BF16<T>) {
      // this lane's row of the warp's 16 x 16 A fragments, one a k step
      const int r = wrow + (lq & 1) * 8 + lr;
      const T* ap = A + (size_t)((vm[0] >> tap) & 1 ? r + shift : zero_row) * LDA + (lq >> 1) * 8;
      uint32_t af[CK / 16][4];
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks) ldmatrix_x4(af[ks], ap + ks * 16);
      // B: 64 rows (k) of 128 swizzled bytes (n); 8 rows are 1,024 bytes, a k
      // step of 16 rows 2,048 (the descriptor counts in 16 bytes); the leading
      // offset is not read for one 64-column atom
      const uint64_t desc =
          wgmma_desc_sw128(static_cast<uint32_t>(__cvta_generic_to_shared(B)), 1, 1024 / 16);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks)
        wgmma_m64n64k16_bf16_tb(acc, af[ks], desc + (uint64_t)(ks * (2048 / 16)));
      wgmma_commit();
      wgmma_wait0();
    } else {
      const T* ap[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        ap[i] = A + (size_t)((vm[i] >> tap) & 1 ? r0 + i + shift : zero_row) * LDA;
#pragma unroll 2
      for (int k = 0; k < CK; k += 4) {
        float4 bv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          bv[kk] = *reinterpret_cast<const float4*>(B + (size_t)(k + kk) * LDB + j0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(ap[i] + k);
          const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc[i][0] = fmaf(ak[kk], bv[kk].x, acc[i][0]);
            acc[i][1] = fmaf(ak[kk], bv[kk].y, acc[i][1]);
            acc[i][2] = fmaf(ak[kk], bv[kk].z, acc[i][2]);
            acc[i][3] = fmaf(ak[kk], bv[kk].w, acc[i][3]);
          }
        }
      }
    }
  };
  // MODE_GNONLY's "conv": the normalised chunk's own pixel and channel
  auto copy_centre = [&](const T* A, int chunk) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + acc_col(i, j) - chunk * CK;
        if (c >= 0 && c < CK && m0 + acc_row(i, j) < M)
          acc[i][j] += to_f(A[(size_t)(acc_row(i, j) + W + 1) * LDA + c]);
      }
  };

  // ---- the units
  int cur = 0;
  if (u0 < u1) a_fill(tile_of(u0), A0, 0, a_passes(tile_of(u0)));
  RB_CLK(2)  // the first tile's fill
  for (int u = u0; u < u1; ++u) {
    cp_async_wait<RB_STAGES - 2>();  // this thread's copies of unit u's B tile have landed
    if constexpr (RB_BF16<T>) fence_proxy_async();  // and wgmma may read them
    __syncthreads();  // everyone's have, and the A tile's stores; the unit before is read out
    if (u + RB_STAGES - 1 < u1) load_b(u + RB_STAGES - 1, (u + RB_STAGES - 1 - u0) % RB_STAGES);
    cp_async_commit();

    // another tile follows: its passes are shared out among this tile's
    // units; the first RB_ASTG of a unit's passes are loaded before its
    // products and normalised after them
    const int tile = tile_of(u);
    const int t_begin = max(u0, u < nconv ? tile * TAPS : u), t_end = min(u1, tile_end(u));
    const bool more = t_end < u1;
    const int nxt = more ? tile_of(t_end) : 0, np = more ? a_passes(nxt) : 0;
    const int k0 = np * (u - t_begin) / (t_end - t_begin);
    const int k1 = np * (u - t_begin + 1) / (t_end - t_begin);
    T* const An = A0 + (size_t)(cur ^ 1) * a_elems;
    int hrow[RB_ASTG];
    uint4 raw[RB_ASTG];
#pragma unroll
    for (int j = 0; j < RB_ASTG; ++j) {
      hrow[j] = k0 + j < k1 ? a_row(nxt, k0 + j) : -1;
      if (hrow[j] >= 0) raw[j] = a_load(nxt, hrow[j]);
    }
    const T* A = A0 + (size_t)cur * a_elems;
    if (SECOND && u >= nconv) {
      product(A, Bs + (size_t)((u - u0) % RB_STAGES) * CK * LDB, 4);
    } else if constexpr (PRODUCT) {
      product(A, Bs + (size_t)((u - u0) % RB_STAGES) * CK * LDB, TAP0 + u - tile * TAPS);
    } else {
      copy_centre(A, tile);
    }
#pragma unroll
    for (int j = 0; j < RB_ASTG; ++j)
      if (hrow[j] >= 0) a_store(nxt, An, hrow[j], raw[j]);
    a_fill(nxt, An, k0 + RB_ASTG, k1);
    if (more && u + 1 == t_end) cur ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every product has read its tiles: the output tile may lie over them
  RB_CLK(3)  // the units

  // ---- the partial tile to shared memory; rank r then takes the rows
  // [r, r + 1) * RB_TM / split of the tile: adds the ranks' partials of them in
  // rank order and writes them out
  if constexpr (RB_BF16<T>) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; j += 2)
        *reinterpret_cast<float2*>(Ct + acc_row(i, j) * RB_LDC + acc_col(i, j)) =
            make_float2(acc[i][j], acc[i][j + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(Ct + (r0 + i) * RB_LDC + j0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  if (a.split > 1) cg::this_cluster().sync();
  else __syncthreads();
  RB_CLK(4)  // the partial tile in shared memory, the ranks met

  const int rows = min(RB_TM, M - m0), cols = min(RB_TN, a.Co - n0);
  const int row_lo = min(RB_TM * rank / a.split, rows);
  const int row_hi = min(RB_TM * (rank + 1) / a.split, rows);
  constexpr int UC = RB_TN / E;  // units of E columns a row; a thread's columns are fixed
  static_assert(RB_NT % UC == 0, "a thread keeps its columns over the epilogue's rows");
  const int cq = (tid % UC) * E, col = n0 + cq, nv = min(E, cols - cq);
  float bias[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    bias[e] = e < nv ? (SECOND ? a.bias[col + e] : rnd<T>(a.bias[col + e])) : 0.f;
  for (int r = row_lo + tid / UC; r < row_hi; r += RB_NT / UC) {
    if (nv <= 0) break;
    float v[E];
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      float4 t;
      if (a.split > 1) {
        cg::cluster_group cl = cg::this_cluster();
        float4 pv[RB_MAX_SPLIT];
#pragma unroll
        for (int k = 0; k < RB_MAX_SPLIT; ++k)
          if (k < a.split)
            pv[k] = *reinterpret_cast<const float4*>(cl.map_shared_rank(Ct, k) + r * RB_LDC +
                                                     cq + e);
        t = pv[0];
#pragma unroll
        for (int k = 1; k < RB_MAX_SPLIT; ++k)
          if (k < a.split) {
            t.x += pv[k].x; t.y += pv[k].y; t.z += pv[k].z; t.w += pv[k].w;
          }
      } else {
        t = *reinterpret_cast<const float4*>(Ct + r * RB_LDC + cq + e);
      }
      v[e] = t.x; v[e + 1] = t.y; v[e + 2] = t.z; v[e + 3] = t.w;
    }
    const size_t p = (size_t)(m0 + r);
    if constexpr (!SECOND) {
      const float* trow = a.temb + (size_t)(p / N) * a.Co + col;
      float tv[E];
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        if (a.vec_t) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(trow + e));
          tv[e] = t.x; tv[e + 1] = t.y; tv[e + 2] = t.z; tv[e + 3] = t.w;
        } else {
#pragma unroll
          for (int q = e; q < e + 4; ++q) tv[q] = q < nv ? trow[q] : 0.f;
        }
      }
      if constexpr (RB_BF16<T>) {  // two values an instruction: a bf16 add rounds as T(a + b)
#pragma unroll
        for (int e = 0; e < E; e += 2) {
          __nv_bfloat162 h = __floats2bfloat162_rn(v[e], v[e + 1]);
          h = __hadd2(h, __floats2bfloat162_rn(bias[e], bias[e + 1]));
          h = __hadd2(h, __floats2bfloat162_rn(tv[e], tv[e + 1]));
          const float2 f = __bfloat1622float2(h);
          v[e] = e < nv ? f.x : 0.f;
          v[e + 1] = e + 1 < nv ? f.y : 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e)
          v[e] = e < nv ? rnd<T>(rnd<T>(rnd<T>(v[e]) + bias[e]) + rnd<T>(tv[e])) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < E; ++e) Ct[r * RB_LDC + cq + e] = v[e];  // h1 as stored: its statistics
    } else {
      float sc[E];
      if (a.ws == nullptr) unpack16(load_unit<T>(a.x + p * a.Cx, col, a.Cx, a.vec_x), sc);
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < nv) v[e] = v[e] + bias[e] + (a.ws != nullptr ? a.bs[col + e] : sc[e]);
    }
    store_unit<T>(a.out + p * a.Co + col, v, nv, a.vec_out);
  }
  RB_CLK(5)  // this rank's rows added and written
  if constexpr (!SECOND) {
    __syncthreads();
    const int sl = rb_slots(RB_TM, N);
    const size_t block = ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * a.split + rank;
    tile_group_sums([&](int r, int c) { return Ct[r * RB_LDC + c - n0]; },
                    a.part_out + block * sl * G * 2, m0, row_lo, row_hi, n0, n0 + cols, N, G,
                    a.Co / G, sl);
  }
  RB_CLK(6)  // conv1: the statistics' partials
  if (a.split > 1) cg::this_cluster().sync();  // a CTA's tile outlives its peers' reads
}

template <typename T>
__global__ void __launch_bounds__(RB_NT) copy_kernel(const T* __restrict__ x, T* __restrict__ y,
                                                     size_t n) {
  for (size_t i = (size_t)blockIdx.x * RB_NT + threadIdx.x; i < n;
       i += (size_t)gridDim.x * RB_NT)
    y[i] = x[i];
}

constexpr int RB_MAX_DEVICES = 64;

// Raise a conv kernel's dynamic shared-memory limit to the card's, once per
// device.
template <typename T, int MODE, bool SECOND> cudaError_t rb_raise_smem_limit() {
  static bool raised[RB_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < RB_MAX_DEVICES && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(resnet_conv_kernel<T, MODE, SECOND>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, RB_SMEM_LIMIT);
  if (err == cudaSuccess && dev < RB_MAX_DEVICES) raised[dev] = true;
  return err;
}

template <typename T, int MODE, bool SECOND>
cudaError_t launch_conv(const RbConv<T>& a, int m_tiles, int n_tiles, int smem,
                        cudaStream_t stream) {
  cudaError_t err = rb_raise_smem_limit<T, MODE, SECOND>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)a.split);
  cfg.blockDim = dim3(RB_NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)a.split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, resnet_conv_kernel<T, MODE, SECOND>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

inline bool rb_aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The block: three launches on `stream` (MODE_NOOP: one copy); returns the
// first launch error.  ws == nullptr selects the identity shortcut (C_in ==
// C_out).  h1: (B, H, W, Cout) scratch in T; wt: plan.wt_elems elements of T;
// part: plan.part_floats floats; all 16-byte aligned.
template <typename T, int MODE>
int launch_block(const T* x, const float* temb, const float* n1s, const float* n1b,
                 const float* w1, const float* b1, const float* n2s, const float* n2b,
                 const float* w2, const float* b2, const float* ws, const float* bs, T* y,
                 T* h1, T* wt, float* part, int B, int H, int W, int Cin, int Cout, int G,
                 float eps, const int* plan, cudaStream_t stream) {
  RbPlan p;
  static_assert(sizeof(RbPlan) == RB_N_PLAN * sizeof(int), "RbPlan is RB_N_PLAN ints");
  for (int i = 0; i < RB_N_PLAN; ++i) reinterpret_cast<int*>(&p)[i] = plan[i];
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || Cin > RB_MAX_C || Cout > RB_MAX_C ||
      G < 1 || Cin % G || Cout % G || (ws == nullptr && Cin != Cout) ||
      (MODE == MODE_GNONLY && Cin != Cout) || (long long)B * H * W > 0x7fffffffLL - RB_TM)
    return (int)cudaErrorInvalidValue;
  const int N = H * W, M = B * N;
  if constexpr (MODE == MODE_NOOP) {
    const size_t n = (size_t)M * Cin;
    const size_t want = (n + RB_NT - 1) / RB_NT;
    const int blocks = (int)(want < 4096 ? want : 4096);
    copy_kernel<T><<<blocks, RB_NT, 0, stream>>>(x, y, n);
    return (int)cudaGetLastError();
  } else {
    constexpr int CK = RB_CK<T>, E = RB_E<T>;
    const int m_tiles = (M + RB_TM - 1) / RB_TM, n_tiles = (Cout + RB_TN - 1) / RB_TN;
    const int Cip = rb_round_up(Cin, CK), Cmp = rb_round_up(Cout, CK), Cop = n_tiles * RB_TN;
    const int sl = rb_slots(RB_TM, N);
    const long long wt1 = 9LL * Cip * Cop, wt2 = 9LL * Cmp * Cop;
    const long long wt3 = ws != nullptr ? (long long)Cip * Cop : 0;
    const int nt_in = (Cin + RB_TN - 1) / RB_TN;
    const long long part_t = (long long)m_tiles * sl * G * 2;  // one column tile's partials
    const long long part1 = part_t * nt_in, part2 = part_t * n_tiles * p.split1;
    if (p.split1 < 1 || p.split1 > RB_MAX_SPLIT || p.split2 < 1 || p.split2 > RB_MAX_SPLIT ||
        RB_TM % p.split1 || RB_TM % p.split2)
      return (int)cudaErrorInvalidValue;
    const int smem1 = rb_layout<T>(N, W, Cip, G).total, smem2 = rb_layout<T>(N, W, Cmp, G).total;
    if (p.smem1 != smem1 || p.smem2 != smem2 || smem1 > RB_SMEM_LIMIT ||
        smem2 > RB_SMEM_LIMIT || (long long)p.wt_elems != wt1 + wt2 + wt3 ||
        (long long)p.part_floats != part1 + part2 || !rb_aligned16(wt) || !rb_aligned16(part))
      return (int)cudaErrorInvalidValue;
    const int vec_x = Cin % E == 0 && rb_aligned16(x);
    const int vec_o = Cout % E == 0 && rb_aligned16(h1) && rb_aligned16(y);

    const long long units = (wt1 + wt2 + wt3) / E;
    const long long wb = (units + 4 * RB_NT - 1) / (4 * RB_NT);
    const int w_blocks = (int)(wb < 2048 ? wb : 2048);
    const int vec_w = Cout % 4 == 0 && rb_aligned16(w1) && rb_aligned16(w2) && rb_aligned16(ws);
    resnet_prep_kernel<T><<<m_tiles * nt_in + w_blocks, RB_NT, 0, stream>>>(
        x, part, w1, w2, ws, wt, M, N, Cin, Cout, G, m_tiles, nt_in, vec_x, vec_w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    RbConv<T> c1 = {};
    c1.src = x; c1.part = part; c1.gs = n1s; c1.gb = n1b; c1.w = wt; c1.bias = b1;
    c1.temb = temb; c1.out = h1; c1.part_out = part + part1;
    c1.M = M; c1.H = H; c1.W = W; c1.Cs = Cin; c1.Co = Cout; c1.Cx = Cin; c1.G = G;
    c1.part_nt = nt_in; c1.part_split = 1; c1.split = p.split1;
    c1.vec_src = vec_x; c1.vec_x = vec_x;
    c1.vec_out = vec_o; c1.vec_t = vec_o && rb_aligned16(temb); c1.eps = eps;
    err = launch_conv<T, MODE, false>(c1, m_tiles, n_tiles, smem1, stream);
    if (err != cudaSuccess) return (int)err;

    RbConv<T> c2 = {};
    c2.src = h1; c2.part = part + part1; c2.gs = n2s; c2.gb = n2b; c2.w = wt + wt1;
    c2.bias = b2; c2.x = x; c2.ws = ws != nullptr ? wt + wt1 + wt2 : nullptr; c2.bs = bs;
    c2.out = y;
    c2.M = M; c2.H = H; c2.W = W; c2.Cs = Cout; c2.Co = Cout; c2.Cx = Cin; c2.G = G;
    c2.part_nt = n_tiles; c2.part_split = p.split1; c2.split = p.split2;
    c2.vec_src = vec_o; c2.vec_x = vec_x;
    c2.vec_out = vec_o; c2.eps = eps;
    return (int)launch_conv<T, MODE, true>(c2, m_tiles, n_tiles, smem2, stream);
  }
}

}  // namespace
