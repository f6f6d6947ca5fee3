// Hopper port of the TPU kernel `_wide_attention`
// (audio_residual_tpu/ops/pallas/window_attention.py::_wide_kernel): the
// W-MSA of fused_window_attention for wide layers (C >= 1024: HTSAT-base
// layer 3, HTSAT-large layers 2-3) -- qkv projection, per-head
// q k^T * hd^-1/2 + relative position bias + SW-MSA mask, exact f32
// softmax, @V, output projection. Two launches a call:
//   (A) qkv + attention, with q|k|v kept on chip; it writes the attention
//       output [R, C] (the TPU kernel's a_scr), the only intermediate in
//       device memory: bf16 under AMP, where its only reader is the proj
//       GEMM, f32 in the golden route;
//   (B) the proj GEMM over that buffer with the bias in the epilogue, stored
//       in the output dtype: the TMA + wgmma bf16 GEMM (gemm_sm90.cuh) under
//       AMP, the f32 GEMM in the golden route.
//
// (A) under AMP: wide_attention_wgmma_kernel.
//   What bounds it on the H100: operations. At HTSAT-base layer 3 and B=32
//   (32 windows of 64 tokens, C=1024, 32 heads of 32) a launch is 13.4 GFLOP
//   (12.9 of qkv product, 0.5 of scores and @V), 14 us at the 989 TFLOP/s
//   bf16 rate, against 14.7 MB of bytes (x and wqkv in bf16, the bf16
//   attention output: 4 us at 3.35 TB/s).
//   The first version of this kernel, one block per (window, head) with
//   element-wise staging and wmma, re-read the head's wqkv rows for every
//   window and the window's x for every head (~200 MB of bf16 weights and
//   ~270 MB of f32 x from L2 a launch) and ran at 3% of the bf16 rate.
//   Design:
//   * A block takes a pair of windows (128 rows, one 64-row window per
//     consumer warpgroup) and a head group whose q|k|v columns are
//     N = 3 x 64 = 192: two heads at hd = 32, one at hd = 64. Each weight
//     slice is read once per window pair, and x once per head group.
//   * A producer warp keeps TMA loads of 64-wide K steps in flight through a
//     ring of 4 stages (x 16 KB + weights 24 KB each). x is a 3-D map
//     {C, n, windows} with a {64, 64, 2} box: rows past n and the missing
//     second window of an odd count arrive zero-filled, so n <= 64 and any
//     window count take one code path. The head group's wqkv rows are three
//     strided slices of [3C, C] (its q, k and v rows), one box each,
//     stacked into one K-major [192, 64] tile. At base layer 3 the L2 reads
//     fall from ~470 MB a launch to ~167 MB: 67 MB of bf16 x and 100 MB of
//     weights. Blocks run alone: clusters of 2 sharing each weight box by
//     TMA multicast cut the L2 reads further (~117 MB) and measured slower
//     at every shipped wide layer (PERF.md), as the L2 reads do not set the
//     pace and the pairing makes each block wait for the slower one.
//   * Each consumer warpgroup runs wgmma m64n192k16 into 96 f32 registers a
//     thread; its epilogue adds bqkv, scales q by hd^-1/2, rounds to bf16
//     and writes q|k|v [64, 192] to shared memory.
//   * The attention core of each head runs on the tensor cores
//     (attention_tc.cuh), each warp 16 query rows: S, f32 bias and mask,
//     exact softmax in registers, bf16 P as the A operand of P v. The output
//     replaces the head's q columns in shared memory and leaves in 16-byte
//     stores, 64 columns a row.
//   The wrapper casts x to bf16 once before the launch; that changes no
//   value, as the products take x in bf16 anyway (the TPU kernel's AMP
//   contract).
//
// (A) in the golden route: wide_qkv_attention_kernel, f32 on the CUDA cores,
//   one block per (window, head): it streams the window's rows of x and the
//   head's three hd-row slices of wqkv through shared memory in K-chunks of
//   32, accumulates q|k|v [64, 3*hd] with f32 FMAs, then computes the
//   scores, bias, mask, softmax and @V in shared memory. 17.7 GFLOP a launch
//   at the f32 rate is 0.26 ms: operations.
#include <atomic>

#include "attention_tc.cuh"
#include "common.cuh"

namespace arpu {

// ---- golden route: f32 on the CUDA cores -------------------------------
constexpr int WA_THREADS = 256;
constexpr int WA_ROWS = 64;  // rows of a window tile: n <= 64, zero-padded
constexpr int WA_BK = 32;    // K-chunk

template <int HD>
struct WideTile {
  static constexpr int NQ = 3 * HD;     // q|k|v columns of one head
  static constexpr int LDR = NQ + 4;    // qkv tile row stride
  static constexpr int F_LDA = WA_ROWS + 1, F_LDW = NQ + 1;  // staging, [BK][rows]
  static constexpr int LDS = WA_ROWS + 1;                    // score tile row stride
  static constexpr size_t qkv_bytes = sizeof(float) * WA_ROWS * LDR;
  static constexpr size_t stage_bytes = sizeof(float) * WA_BK * (F_LDA + F_LDW);
  static constexpr size_t score_bytes = sizeof(float) * WA_ROWS * LDS;
  static constexpr size_t smem_bytes =
      qkv_bytes + (stage_bytes > score_bytes ? stage_bytes : score_bytes);
};

// row of wqkv ([3C, C]) that feeds column c of head h's q|k|v tile
template <int HD>
__device__ __forceinline__ size_t wqkv_row(int c, int h, int C) {
  return (size_t)(c / HD) * C + h * HD + c % HD;
}

// qkv_s [WA_ROWS][LDR] <- x_w [n, C] @ W_h^T, f32 FMA: 16x16 threads, each
// 4 rows x NQ/16 columns.
template <int HD>
__device__ void qkv_tile_f32(const void* x, int x_bf16, const float* wqkv, float* qkv_s,
                             float* stage, size_t row0, int n, int h, int C) {
  using T = WideTile<HD>;
  constexpr int NC = T::NQ / 16;
  float* As = stage;                   // [BK][F_LDA]
  float* Ws = stage + WA_BK * T::F_LDA;  // [BK][F_LDW]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < C; k0 += WA_BK) {
    for (int e = tid; e < WA_ROWS * WA_BK; e += WA_THREADS) {
      const int r = e / WA_BK, kk = e % WA_BK;
      As[kk * T::F_LDA + r] = r < n ? ld(x, (row0 + r) * C + k0 + kk, x_bf16) : 0.0f;
    }
    for (int e = tid; e < T::NQ * WA_BK; e += WA_THREADS) {
      const int r = e / WA_BK, kk = e % WA_BK;
      Ws[kk * T::F_LDW + r] = wqkv[wqkv_row<HD>(r, h, C) * C + k0 + kk];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < WA_BK; ++kk) {
      float a[4], b[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk * T::F_LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) b[j] = Ws[kk * T::F_LDW + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) qkv_s[(ty + 16 * i) * T::LDR + tx + 16 * j] = acc[i][j];
}

// grid (windows, nh). x [R, C] (f32 or bf16); wqkv and att [R, C] f32.
// bias [nh, n, n]; mask [nW, n, n] or null (window w takes mask[w % nW]).
template <int HD>
__global__ void __launch_bounds__(WA_THREADS) wide_qkv_attention_kernel(
    const void* x, int x_bf16, const float* wqkv, const float* bqkv, const float* bias,
    const float* mask, float* att, int n, int C, int nW, float scale) {
  using T = WideTile<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qkv_s = reinterpret_cast<float*>(smem);                     // [WA_ROWS][LDR]
  float* scratch = reinterpret_cast<float*>(smem + T::qkv_bytes);   // staging, then scores
  const int w = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row0 = (size_t)w * n;

  qkv_tile_f32<HD>(x, x_bf16, wqkv, qkv_s, scratch, row0, n, h, C);
  __syncthreads();

  // + bias, q * hd^-1/2
  for (int e = tid; e < n * T::NQ; e += WA_THREADS) {
    const int r = e / T::NQ, c = e % T::NQ;
    float v = qkv_s[r * T::LDR + c] + bqkv[wqkv_row<HD>(c, h, C)];
    if (c < HD) v *= scale;
    qkv_s[r * T::LDR + c] = v;
  }
  __syncthreads();

  const float* q = qkv_s;
  const float* k = qkv_s + HD;
  const float* v = qkv_s + 2 * HD;
  float* s = scratch;  // [WA_ROWS][LDS]
  const float* bh = bias + (size_t)h * n * n;
  const float* mw = mask ? mask + (size_t)(w % nW) * n * n : nullptr;
  for (int e = tid; e < n * n; e += WA_THREADS) {
    const int i = e / n, j = e % n;
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) acc = fmaf(q[i * T::LDR + d], k[j * T::LDR + d], acc);
    acc += bh[e];
    if (mw) acc += mw[e];
    s[i * T::LDS + j] = acc;
  }
  __syncthreads();

  for (int i = warp; i < n; i += WA_THREADS / 32) {
    float* row = s + i * T::LDS;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float ex = expf(row[j] - mx);
      row[j] = ex;
      sum += ex;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] /= sum;
  }
  __syncthreads();

  for (int e = tid; e < n * HD; e += WA_THREADS) {
    const int i = e / HD, d = e % HD;
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = fmaf(s[i * T::LDS + j], v[j * T::LDR + d], acc);
    att[(row0 + i) * C + h * HD + d] = acc;
  }
}

template <int HD>
static cudaError_t launch_wide_qkv_attention(const void* x, int x_bf16, const float* wqkv,
                                             const float* bqkv, const float* bias,
                                             const float* mask, float* att, int windows, int n,
                                             int C, int nh, int nW, cudaStream_t s) {
  constexpr size_t smem = WideTile<HD>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(wide_qkv_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // hd**-0.5 rounded once from double, as the plain version's scalar is
  const float scale = (float)pow((double)HD, -0.5);
  wide_qkv_attention_kernel<HD><<<dim3(windows, nh), WA_THREADS, smem, s>>>(
      x, x_bf16, wqkv, bqkv, bias, mask, att, n, C, nW, scale);
  return cudaGetLastError();
}

// ---- AMP route: TMA + wgmma over window pairs, attention on the tensor cores
namespace wtc {

using namespace sm90;  // BK = 64, THREADS = 384, SMEM_LIMIT, the ring's helpers

constexpr int STAGES = 4;    // ring stages of one 64-wide K step
constexpr int WINDOWS = 2;   // windows a block: one per consumer warpgroup
constexpr int TOKENS = attn_tc::TOKENS;  // rows of a window tile
constexpr int GROUP = 64;    // q (and k, v) columns of a block's head group
constexpr int N = 3 * GROUP;            // q|k|v columns of the product
constexpr int X_BYTES = WINDOWS * TOKENS * BK * 2;
constexpr int W_BYTES = N * BK * 2;
constexpr int LDQ = N + 8;  // q|k|v tile row stride: 400 bytes, ldmatrix without conflicts
constexpr int QKV_BYTES = WINDOWS * TOKENS * LDQ * 2;
constexpr int SMEM = 1024 + STAGES * (X_BYTES + W_BYTES) + QKV_BYTES + 2 * STAGES * 8;
static_assert(SMEM <= SMEM_LIMIT, "shared memory");
static_assert(X_BYTES % 1024 == 0 && W_BYTES % 1024 == 0 && GROUP * BK * 2 % 1024 == 0,
              "tiles keep the 128-byte swizzle's 1 KB atoms aligned");

// grid (window pairs, C / 64 head groups). tm_x: bf16 x as {C, n, windows},
// box {64, 64, 2}; tm_w: bf16 wqkv [3C, C], box {64, 64}. bias [nh, 64, 64]
// and mask [nW, 64, 64] f32, padded (attention_tc.cuh); att [R, C] bf16.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    wide_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                                const __grid_constant__ CUtensorMap tm_w,
                                const float* __restrict__ bqkv, const float* __restrict__ bias,
                                const float* __restrict__ mask, __nv_bfloat16* __restrict__ att,
                                int n, int C, int windows, int nW, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_ring = smem;
  unsigned char* w_ring = smem + STAGES * X_BYTES;
  __nv_bfloat16* qkv_s = reinterpret_cast<__nv_bfloat16*>(w_ring + STAGES * W_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(qkv_s + WINDOWS * TOKENS * LDQ);
  uint64_t* empty = full + STAGES;
  const int pair = blockIdx.x, group = blockIdx.y, k_tiles = C / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_expect_tx(&full[stage], X_BYTES + W_BYTES);
      tma_load_3d(x_ring + stage * X_BYTES, &tm_x, &full[stage], kt * BK, 0, pair * WINDOWS);
#pragma unroll
      for (int seg = 0; seg < 3; ++seg) {
        tma_load(w_ring + stage * W_BYTES + seg * GROUP * BK * 2, &tm_w, &full[stage], kt * BK,
                 seg * C + group * GROUP);
      }
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    return;
  }

  // consumers: warpgroup wg takes window pair * 2 + wg - 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool signals = lane == 0;  // lane 0 releases a stage for its warp
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  const int x_off = (wg - 1) * TOKENS * BK * 2;
  int stage = 0, reading = -1;  // reading: the stage the wgmma group in flight reads
  uint32_t phase = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    mbar_wait(&full[stage], phase);
    const uint64_t da = smem_desc(x_ring + stage * X_BYTES + x_off);
    const uint64_t dw = smem_desc(w_ring + stage * W_BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k) Wgmma<N>::mma(acc, da + 2 * k, dw + 2 * k, (kt | k) != 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    if (reading >= 0 && signals) mbar_arrive(&empty[reading]);
    reading = stage;
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (signals) mbar_arrive(&empty[reading]);

  // epilogue: + bqkv, q * hd^-1/2, bf16 q|k|v [64, 192] to shared memory.
  // Fragment: d[4j + 2h + e] is row 16 warp + lane/4 + 8h, column
  // 8j + 2(lane%4) + e; column c is segment c / 64 (q, k, v) of the group.
  __nv_bfloat16* qs = qkv_s + (wg - 1) * TOKENS * LDQ;
  const int r = 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4), seg = col / GROUP;
    const float2 b =
        *reinterpret_cast<const float2*>(bqkv + seg * C + group * GROUP + col % GROUP);
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
  for (int hh = 0; hh < GROUP / HD; ++hh) {
    const int h = group * (GROUP / HD) + hh;
    attn_tc::head_rows16<HD>(qs + hh * HD, qs + GROUP + hh * HD, qs + 2 * GROUP + hh * HD, LDQ,
                             bias + (size_t)h * TOKENS * TOKENS, mask_w, qs + hh * HD, LDQ,
                             16 * warp);
  }
  __syncwarp();
  if (window >= windows) return;
  // the warp's 16 rows of the group's 64 output columns, 16 bytes a store
#pragma unroll
  for (int i = lane; i < 16 * GROUP / 8; i += 32) {
    const int row = 16 * warp + i / (GROUP / 8), chunk = i % (GROUP / 8);
    if (row < n) {
      *reinterpret_cast<uint4*>(att + ((size_t)window * n + row) * C + group * GROUP +
                                8 * chunk) =
          *reinterpret_cast<const uint4*>(qs + row * LDQ + 8 * chunk);
    }
  }
}

template <int HD>
static cudaError_t launch_amp(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                              const float* bqkv, const float* bias, const float* mask,
                              __nv_bfloat16* att, int n, int C, int windows, int nW, int grid_x,
                              int dev, cudaStream_t s) {
  const auto kernel = wide_attention_wgmma_kernel<HD>;
  static std::atomic<bool> smem_set[MAX_DEVICES];  // per instantiation
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_relaxed);
  }
  // hd**-0.5 rounded once from double, as the plain version's scalar is
  const float scale = (float)pow((double)HD, -0.5);
  kernel<<<dim3(grid_x, C / GROUP), THREADS, SMEM, s>>>(tm_x, tm_w, bqkv, bias, mask, att, n, C,
                                                        windows, nW, scale);
  return cudaGetLastError();
}

}  // namespace wtc
}  // namespace arpu

// bytes of scratch: the attention output [R, C], bf16 under AMP
extern "C" size_t arpu_wide_attention_workspace(int R, int C, int bf16) {
  return (size_t)R * C * (bf16 ? 2 : 4);
}

// Golden route. x [R, C] f32 or bf16, out [R, C] f32 or bf16, R = windows *
// n, n <= 64; hd = C / nh is 32 or 64. Weights f32 in nn.Linear layout:
// wqkv [3C, C], wproj [C, C]. bias [nh, n, n]; mask [nW, n, n] or null.
// ws: arpu_wide_attention_workspace(R, C, 0) bytes. Returns the first CUDA
// error of the two launches.
extern "C" int arpu_wide_attention(const void* x, int x_bf16, void* out, int out_bf16, int R,
                                   int n, int C, int nh, int nW, const float* wqkv,
                                   const float* bqkv, const float* wproj, const float* bproj,
                                   const float* bias, const float* mask, void* ws,
                                   void* stream) {
  using namespace arpu;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = C / nh, windows = R / n;
  float* att = static_cast<float*>(ws);
  if (n > WA_ROWS || (hd != 32 && hd != 64) || C % WA_BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      hd == 32 ? launch_wide_qkv_attention<32>(x, x_bf16, wqkv, bqkv, bias, mask, att, windows,
                                               n, C, nh, nW, s)
               : launch_wide_qkv_attention<64>(x, x_bf16, wqkv, bqkv, bias, mask, att, windows,
                                               n, C, nh, nW, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_gemm_f32(gemm_args(att, 0, wproj, out, out_bf16, R, C, C, bproj), s));
}

// AMP route. x [windows, n, C] bf16, out [R, C] f32 or bf16; weights bf16
// in nn.Linear layout, biases f32. bias [nh, 64, 64] and mask [nW, 64, 64]
// (or null) f32, padded to the 64-token tile (attention_tc.cuh). The launch
// plan (heads and windows a block, ring stages, shared bytes, grid columns)
// comes from the wrapper and must be this build's. ws:
// arpu_wide_attention_workspace(R, C, 1) bytes. Returns the first CUDA error
// of the two launches.
extern "C" int arpu_wide_attention_amp(const void* x, void* out, int out_bf16, int windows, int n,
                                       int C, int nh, int nW, const void* wqkv, const float* bqkv,
                                       const void* wproj, const float* bproj, const float* bias,
                                       const float* mask, int heads_per_block,
                                       int windows_per_block, int stages, int smem, int grid_x,
                                       void* ws, void* stream) {
  using namespace arpu::wtc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = C / nh;
  if (windows <= 0 || n <= 0 || n > TOKENS || C % GROUP || C % nh || (hd != 32 && hd != 64) ||
      heads_per_block != GROUP / hd || windows_per_block != WINDOWS || stages != STAGES ||
      smem != SMEM || grid_x != (windows + WINDOWS - 1) / WINDOWS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* pointers[8] = {x, out, wqkv, bqkv, wproj, bproj, bias, ws};
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (reinterpret_cast<uintptr_t>(mask) % 16) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_w;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)n, (cuuint64_t)windows};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)n * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)TOKENS, (cuuint32_t)WINDOWS};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  if (encode(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      !encode_map(&tm_w, wqkv, 3 * C, C, GROUP, BK, 1, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= MAX_DEVICES)) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* att = static_cast<__nv_bfloat16*>(ws);
  err = (hd == 32 ? launch_amp<32> : launch_amp<64>)(tm_x, tm_w, bqkv, bias, mask, att, n, C, windows, nW, grid_x, dev, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(arpu::gemm_bf16(att, static_cast<const __nv_bfloat16*>(wproj), out,
                                          out_bf16, windows * n, C, C,
                                          arpu::Epilogue{bproj, nullptr, 0, nullptr, nullptr}, 0,
                                          0, s));
}
