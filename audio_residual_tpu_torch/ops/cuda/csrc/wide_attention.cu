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
// (A) under AMP: window_attention_wgmma_kernel (window_attention_tc.cuh),
//   the kernel K2 and K4 take too, reached through K2's C entry
//   (window_attention.cu): the wrapper sends the AMP route there. The design
//   was first written here for C >= 1024 (a window pair x 64-column head
//   group a block, a 4-stage TMA ring, wgmma m64n192k16, the core on the
//   tensor cores); the shared kernel is that design in general form (head
//   dims 16-64, narrow widths, a persistent grid). Clusters of 2 sharing each weight box by TMA
//   multicast were measured slower at every shipped wide layer (PERF.md):
//   the L2 reads do not set the pace, and the pairing makes each block wait
//   for the slower one.
//
// (A) in the golden route: wide_qkv_attention_kernel, f32 on the CUDA cores,
//   one block per (window, head): it streams the window's rows of x and the
//   head's three hd-row slices of wqkv through shared memory in K-chunks of
//   32, accumulates q|k|v [64, 3*hd] with f32 FMAs, then computes the
//   scores, bias, mask, softmax and @V in shared memory. 17.7 GFLOP a launch
//   at the f32 rate is 0.26 ms: operations.
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

}  // namespace arpu

// bytes of scratch: the attention output [R, C], f32
extern "C" size_t arpu_wide_attention_workspace(int R, int C) { return (size_t)R * C * 4; }

// Golden route. x [R, C] f32 or bf16, out [R, C] f32 or bf16, R = windows *
// n, n <= 64; hd = C / nh is 32 or 64. Weights f32 in nn.Linear layout:
// wqkv [3C, C], wproj [C, C]. bias [nh, n, n]; mask [nW, n, n] or null.
// ws: arpu_wide_attention_workspace(R, C) bytes. Returns the first CUDA
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
