// qkv projection + window attention in one launch for Hopper (sm_90a): the
// AMP route of three TPU kernels' attention --
//   K2 fused_window_attention (audio_residual_tpu/ops/pallas/
//      window_attention.py::_kernel, standard path), through
//      run_window_attention (blocks.cuh);
//   K4 fused_swin_block's attention half (ops/pallas/swin_block.py::
//      _kernel), the same run_window_attention;
//   K5 _wide_attention's launch (A) (ops/pallas/window_attention.py::
//      _wide_kernel), which takes the same entry (C >= 1024).
// x [windows, n, C] bf16 -> att [windows * n, C] bf16: per head,
// softmax(q k^T * hd^-1/2 + relative bias + SW-MSA mask) v, with q|k|v never
// in device memory. The proj GEMM (gemm_sm90.cuh) follows as a second launch.
//
// What bounds it on the H100: at HTSAT-tiny layer 3 (B=32: 32 windows of 64
// tokens, C = 768, 32 heads of 24) operations, 7.25 GFLOP of qkv product and
// 0.40 of scores and P v a launch, 8 us at the 989 TFLOP/s bf16 rate,
// against ~10 MB of bytes (x, wqkv, att in bf16); at the narrow K4 layers
// (C = 96 ... 512, 512-2048 windows) bytes: x in and att out, 50 MB at
// HTSAT-tiny layer 0 (15 us at 3.35 TB/s) against 10 GFLOP. The
// sequence it replaces (qkv GEMM -> attention_core_kernel) wrote q|k|v
// [R, 3C] to device memory, read it back, and ran q k^T and P v as scalar
// FMAs, one block per (window, head).
//
// Design (K5's first wgmma launch (A), made general in head dim and width):
//   * A work unit is a window pair (one 64-row window per consumer
//     warpgroup) and a head group of HEADS heads: two at hd 16, 24 and 32,
//     one at hd 64, so NQ = HEADS hd q columns (32, 48, 64, 64) and
//     N = 3 NQ q|k|v columns (96, 144, 192, 192), one wgmma m64nNk16 shape.
//   * Persistent grid: one block an SM walks the units, head groups
//     fastest, so the blocks at work at one time share a pair's x in L2. At
//     the narrow widths a unit's K loop is 2-8 steps of 64, and a block that
//     ran one unit would spend as long on its prologue and on the ring's
//     first fill as on its products; walking units, the producer already
//     loads the next unit while the consumers run this one's attention.
//   * A producer warp keeps TMA loads of 64-wide K steps in flight through
//     an mbarrier ring (as many stages as shared memory holds: 5 at N = 144,
//     4 at N = 192). x is a 3-D map {C, n, windows} with a {64, 64, 2} box:
//     rows past n, the missing second window of an odd count and, at
//     C = 96, the second K step's columns 96-127 arrive zero-filled, so one
//     code path takes every shipped shape. The group's wqkv rows are three
//     strided slices of [3C, C] (its q, k and v rows), one box of NQ rows
//     each, stacked into one K-major [N, 64] tile (NQ x 128 bytes is a
//     multiple of the swizzle's 1 KB atom); out-of-range K columns of wqkv
//     arrive zero too.
//   * Each consumer warpgroup runs wgmma m64nNk16 into N/2 f32 registers a
//     thread; its epilogue adds bqkv, scales q by hd^-1/2, rounds to bf16
//     and writes q|k|v [64, N] to shared memory.
//   * The attention core of each head runs on the tensor cores
//     (attention_tc.cuh), each warp 16 query rows: S, f32 bias and mask,
//     exact softmax in registers, bf16 P as the A operand of P v. The output
//     replaces the head's q columns in shared memory and leaves in 16-byte
//     stores, NQ columns a row; rows past n and a missing window are not
//     stored.
//   * Every mbarrier wait traps after ~10 s, so a lost arrival fails the
//     launch instead of hanging the card.
// The launch plan (heads and windows a unit, stages, shared bytes, blocks)
// comes from the wrapper (ops/cuda/window_attention.py::amp_plan), which
// also keeps the TMA map of the bf16 wqkv per weight version; the launcher
// refuses a plan that is not this build's.
#pragma once

#include <string.h>

#include "attention_tc.cuh"
#include "gemm_sm90.cuh"

namespace arpu {

// The wrapper's launch plan and the TMA map of the bf16 wqkv [3C, C] in
// boxes of [NQ, 64] (arpu_weight_map, gemm.cu).
struct AttentionPlan {
  const void* w_map;
  int heads_per_block;
  int windows_per_block;
  int stages;
  int smem;
  int blocks;
};

namespace watc {

using namespace sm90;  // BK = 64, THREADS = 384, SMEM_LIMIT, the ring's helpers

constexpr int WINDOWS = 2;                // windows a unit: one per consumer warpgroup
constexpr int TOKENS = attn_tc::TOKENS;   // rows of a window tile
constexpr int X_BYTES = WINDOWS * TOKENS * BK * 2;

template <int HD>
struct Group {
  static constexpr int HEADS = HD == 64 ? 1 : 2;
  static constexpr int NQ = HEADS * HD;  // q (and k, v) columns of a head group
  static constexpr int N = 3 * NQ;       // q|k|v columns of the product
  static constexpr int W_BYTES = N * BK * 2;
  static constexpr int LDQ = N + 8;  // q|k|v tile row stride: an odd multiple of 16 bytes
  static constexpr int QKV_BYTES = WINDOWS * TOKENS * LDQ * 2;
  static constexpr int FIXED = 1024 + QKV_BYTES;  // alignment slack, the q|k|v tile
  static constexpr int STAGE = X_BYTES + W_BYTES + 16;  // a ring stage and its two barriers
  static constexpr int STAGES = (SMEM_LIMIT - FIXED) / STAGE;
  static constexpr int SMEM = FIXED + STAGES * STAGE;
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(NQ * BK * 2 % 1024 == 0, "weight boxes keep the 128-byte swizzle's 1 KB atoms");
  static_assert((LDQ * 2 / 16) % 2 == 1, "row stride: an odd multiple of 16 bytes");
};

// Persistent grid over units (window pair, head group), head groups fastest.
// tm_x: bf16 x as {C, n, windows}, box {64, 64, 2}; tm_w: bf16 wqkv [3C, C],
// box {64, NQ}. bias [nh, 64, 64] and mask [nW, 64, 64] f32, padded
// (attention_tc.cuh); att [windows * n, C] bf16.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    window_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                                  const __grid_constant__ CUtensorMap tm_w,
                                  const float* __restrict__ bqkv, const float* __restrict__ bias,
                                  const float* __restrict__ mask,
                                  __nv_bfloat16* __restrict__ att, int n, int C, int windows,
                                  int nW, float scale) {
  using G = Group<HD>;
  constexpr int NQ = G::NQ, N = G::N, LDQ = G::LDQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_ring = smem;
  unsigned char* w_ring = smem + G::STAGES * X_BYTES;
  __nv_bfloat16* qkv_s = reinterpret_cast<__nv_bfloat16*>(w_ring + G::STAGES * G::W_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(qkv_s + WINDOWS * TOKENS * LDQ);
  uint64_t* empty = full + G::STAGES;
  const int groups = C / NQ, k_tiles = (C + BK - 1) / BK;
  const int units = (windows + WINDOWS - 1) / WINDOWS * groups;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: x of the pair, the group's q, k, v weight rows
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int pair = u / groups, group = u % groups;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait_or_trap(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], X_BYTES + G::W_BYTES);
        tma_load_3d(x_ring + stage * X_BYTES, &tm_x, &full[stage], kt * BK, 0, pair * WINDOWS);
#pragma unroll
        for (int seg = 0; seg < 3; ++seg) {
          tma_load(w_ring + stage * G::W_BYTES + seg * NQ * BK * 2, &tm_w, &full[stage],
                   kt * BK, seg * C + group * NQ);
        }
        if (++stage == G::STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg takes window 2 pair + wg - 1 of each unit
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool signals = lane == 0;  // lane 0 releases a stage for its warp
  const int x_off = (wg - 1) * TOKENS * BK * 2;
  __nv_bfloat16* qs = qkv_s + (wg - 1) * TOKENS * LDQ;
  const int r = 16 * warp + lane / 4;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int pair = u / groups, group = u % groups;
    int reading = -1;  // the stage the wgmma group in flight reads
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait_or_trap(&full[stage], phase);
      const uint64_t da = smem_desc(x_ring + stage * X_BYTES + x_off);
      const uint64_t dw = smem_desc(w_ring + stage * G::W_BYTES);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) Wgmma<N>::mma(acc, da + 2 * k, dw + 2 * k, (kt | k) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (reading >= 0 && signals) mbar_arrive(&empty[reading]);
      reading = stage;
      if (++stage == G::STAGES) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (signals) mbar_arrive(&empty[reading]);

    // epilogue: + bqkv, q * hd^-1/2, bf16 q|k|v [64, N] to shared memory,
    // once the warpgroup is done with the previous unit's tile. Fragment:
    // acc[4j + 2h + e] is row 16 warp + lane/4 + 8h, column 8j + 2(lane%4) + e;
    // column c is segment c / NQ (q, k, v) of the group.
    warpgroup_sync(wg);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4), seg = col / NQ;
      const float2 b = *reinterpret_cast<const float2*>(bqkv + seg * C + group * NQ + col % NQ);
      const float sc = seg == 0 ? scale : 1.0f;
      *reinterpret_cast<uint32_t*>(qs + r * LDQ + col) =
          attn_tc::pack_bf16((acc[4 * j] + b.x) * sc, (acc[4 * j + 1] + b.y) * sc);
      *reinterpret_cast<uint32_t*>(qs + (r + 8) * LDQ + col) =
          attn_tc::pack_bf16((acc[4 * j + 2] + b.x) * sc, (acc[4 * j + 3] + b.y) * sc);
    }
    warpgroup_sync(wg);  // k and v of all 64 rows are in shared memory

    const int window = pair * WINDOWS + wg - 1;
    const float* mask_w = mask ? mask + (size_t)(window % nW) * TOKENS * TOKENS : nullptr;
#pragma unroll
    for (int hh = 0; hh < G::HEADS; ++hh) {
      const int h = group * G::HEADS + hh;
      attn_tc::head_rows16<HD>(qs + hh * HD, qs + NQ + hh * HD, qs + 2 * NQ + hh * HD, LDQ,
                               bias + (size_t)h * TOKENS * TOKENS, mask_w, qs + hh * HD, LDQ,
                               16 * warp);
    }
    __syncwarp();
    if (window >= windows) continue;
    // the warp's 16 rows of the group's NQ output columns, 16 bytes a store
#pragma unroll
    for (int i = lane; i < 16 * NQ / 8; i += 32) {
      const int row = 16 * warp + i / (NQ / 8), chunk = i % (NQ / 8);
      if (row < n) {
        *reinterpret_cast<uint4*>(att + ((size_t)window * n + row) * C + group * NQ + 8 * chunk) =
            *reinterpret_cast<const uint4*>(qs + row * LDQ + 8 * chunk);
      }
    }
  }
}

template <int HD>
static cudaError_t launch_hd(const CUtensorMap& tm_x, const CUtensorMap& tm_w, const float* bqkv,
                             const float* bias, const float* mask, __nv_bfloat16* att, int n,
                             int C, int windows, int nW, const AttentionPlan& p, int dev,
                             cudaStream_t s) {
  using G = Group<HD>;
  const int units = (windows + WINDOWS - 1) / WINDOWS * (C / G::NQ);
  if (C % G::NQ || p.heads_per_block != G::HEADS || p.windows_per_block != WINDOWS ||
      p.stages != G::STAGES || p.smem != G::SMEM || p.blocks < 1 || p.blocks > units) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = window_attention_wgmma_kernel<HD>;
  static std::atomic<bool> smem_set[MAX_DEVICES];  // per instantiation
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_relaxed);
  }
  // hd**-0.5 rounded once from double, as the plain version's scalar is
  const float scale = (float)pow((double)HD, -0.5);
  kernel<<<p.blocks, THREADS, G::SMEM, s>>>(tm_x, tm_w, bqkv, bias, mask, att, n, C, windows, nW,
                                             scale);
  return cudaGetLastError();
}

}  // namespace watc

// att [windows * n, C] bf16 = attention(qkv(x)) for x [windows, n, C] bf16,
// n <= 64, hd = C / nh in {16, 24, 32, 64}; bqkv f32 [3C]; bias [nh, 64, 64]
// and mask [nW, 64, 64] (or null) f32, padded. Enqueues on `s`.
static inline cudaError_t launch_window_attention_tc(const void* x, const float* bqkv,
                                                     const float* bias, const float* mask,
                                                     __nv_bfloat16* att, int windows, int n,
                                                     int C, int nh, int nW,
                                                     const AttentionPlan& plan, cudaStream_t s) {
  using namespace watc;
  if (windows <= 0 || n <= 0 || n > TOKENS || C <= 0 || C % 8 || nh <= 0 || C % nh || nW <= 0 ||
      !plan.w_map) {
    return cudaErrorInvalidValue;
  }
  const void* pointers[5] = {x, bqkv, bias, mask, att};
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorInvalidValue;
  CUtensorMap tm_x, tm_w;
  memcpy(&tm_w, plan.w_map, sizeof(tm_w));  // the wrapper's buffer need not be 64-byte aligned
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)n, (cuuint64_t)windows};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)n * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)TOKENS, (cuuint32_t)WINDOWS};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= MAX_DEVICES)) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return err;
  switch (C / nh) {
    case 16:
      return launch_hd<16>(tm_x, tm_w, bqkv, bias, mask, att, n, C, windows, nW, plan, dev, s);
    case 24:
      return launch_hd<24>(tm_x, tm_w, bqkv, bias, mask, att, n, C, windows, nW, plan, dev, s);
    case 32:
      return launch_hd<32>(tm_x, tm_w, bqkv, bias, mask, att, n, C, windows, nW, plan, dev, s);
    case 64:
      return launch_hd<64>(tm_x, tm_w, bqkv, bias, mask, att, n, C, windows, nW, plan, dev, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace arpu
