// Hopper port of the TPU kernel `_wide_attention`
// (audio_residual_tpu/ops/pallas/window_attention.py::_wide_kernel): the
// W-MSA of fused_window_attention for wide layers (C >= 1024: HTSAT-base
// layer 3, HTSAT-large layers 2-3) -- qkv projection, per-head
// q k^T * hd^-1/2 + relative position bias + SW-MSA mask, exact f32
// softmax, @V, output projection.
//
// What bounds it on the H100: operations. At HTSAT-base layer 3 and B=32
// (2048 rows, C=1024, 32 heads of 32) one launch is 17.7 GFLOP of products
// (12.9 qkv, 4.3 proj, 0.5 scores and @V) against 34 MB of f32 traffic
// (the 16.8 MB of f32 qkv/proj weights, x, the attention output and out):
// 0.26 ms at the f32 rate, 18 us at the bf16 tensor-core rate, 10 us of
// bytes.
//
// Design. The TPU kernel streams weight column chunks through VMEM and keeps
// qkv in an f32 scratch, so qkv never reaches HBM. Here the cut is at head
// boundaries, so qkv stays on chip as well:
//   (A) wide_qkv_attention_kernel, one block per (window, head). It streams
//       the window's rows of x and the head's three hd-row slices of wqkv
//       through shared memory in K-chunks of 32, accumulates q|k|v
//       [64, 3*hd] on chip (f32 FMA, or bf16 wmma 16x16x16 with f32
//       accumulate under AMP, from the bf16 wqkv the wrapper keeps per
//       weight version), adds the bias and hd^-1/2, then computes the scores, bias,
//       mask, softmax and @V in shared memory, and writes the head's [n, hd]
//       columns of the attention output [R, C] (the TPU kernel's a_scr;
//       bf16 under AMP, where its only reader is the proj GEMM) -- the only
//       intermediate in device memory.
//   (B) the proj GEMM over that buffer with the bias in the epilogue,
//       stored in the output dtype: the f32 GEMM, or under AMP the TMA +
//       wgmma bf16 GEMM (gemm_sm90.cuh).
// Cost of (A): every window re-reads its heads' wqkv slices, so wqkv
// (12.6 MB f32, 6.3 MB bf16 at C=1024) is read once per window, B*nW times
// a launch, from the 50 MB L2 rather than HBM. Making it fast (TMA, wgmma,
// several windows a block or cluster multicast of the weight slice) is
// later work.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace arpu {

constexpr int WA_THREADS = 256;
constexpr int WA_ROWS = 64;  // rows of a window tile: n <= 64, zero-padded
constexpr int WA_BK = 32;    // K-chunk

template <int HD>
struct WideTile {
  static constexpr int NQ = 3 * HD;     // q|k|v columns of one head
  static constexpr int LDR = NQ + 4;    // qkv tile row stride (wmma: a multiple of 4)
  static constexpr int F_LDA = WA_ROWS + 1, F_LDW = NQ + 1;  // f32 staging, [BK][rows]
  static constexpr int B_LD = WA_BK + 8;                     // bf16 staging, [rows][BK]
  static constexpr int LDS = WA_ROWS + 1;                    // score tile row stride
  static constexpr size_t qkv_bytes = sizeof(float) * WA_ROWS * LDR;
  static constexpr size_t f32_stage = sizeof(float) * WA_BK * (F_LDA + F_LDW);
  static constexpr size_t bf16_stage = sizeof(__nv_bfloat16) * (WA_ROWS + NQ) * B_LD;
  static constexpr size_t score_bytes = sizeof(float) * WA_ROWS * LDS;
  static constexpr size_t scratch_bytes =
      f32_stage > bf16_stage ? (f32_stage > score_bytes ? f32_stage : score_bytes)
                             : (bf16_stage > score_bytes ? bf16_stage : score_bytes);
  static constexpr size_t smem_bytes = qkv_bytes + scratch_bytes;
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

// The same product with bf16 operands on the tensor cores (f32 accumulate):
// 8 warps, warp w takes row tile w % 4 and half of the NQ/16 column tiles.
template <int HD>
__device__ void qkv_tile_bf16(const void* x, int x_bf16, const __nv_bfloat16* wqkv, float* qkv_s,
                              float* stage, size_t row0, int n, int h, int C) {
  using namespace nvcuda;
  using T = WideTile<HD>;
  constexpr int NT = T::NQ / 32;
  __nv_bfloat16* Ab = reinterpret_cast<__nv_bfloat16*>(stage);  // [WA_ROWS][B_LD]
  __nv_bfloat16* Wb = Ab + WA_ROWS * T::B_LD;                    // [NQ][B_LD]
  const int tid = threadIdx.x, warp = tid / 32;
  const int rt = warp % 4, ct0 = (warp / 4) * NT;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) wmma::fill_fragment(acc[t], 0.0f);

  for (int k0 = 0; k0 < C; k0 += WA_BK) {
    for (int e = tid; e < WA_ROWS * WA_BK; e += WA_THREADS) {
      const int r = e / WA_BK, kk = e % WA_BK;
      Ab[r * T::B_LD + kk] =
          __float2bfloat16(r < n ? ld(x, (row0 + r) * C + k0 + kk, x_bf16) : 0.0f);
    }
    for (int e = tid; e < T::NQ * WA_BK; e += WA_THREADS) {
      const int r = e / WA_BK, kk = e % WA_BK;
      Wb[r * T::B_LD + kk] = wqkv[wqkv_row<HD>(r, h, C) * C + k0 + kk];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WA_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Ab + rt * 16 * T::B_LD + kk, T::B_LD);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Wb + (ct0 + t) * 16 * T::B_LD + kk, T::B_LD);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
    wmma::store_matrix_sync(qkv_s + rt * 16 * T::LDR + (ct0 + t) * 16, acc[t], T::LDR,
                            wmma::mem_row_major);
}

// (A): grid (windows, nh). x [R, C] (f32 or bf16); wqkv and att [R, C] f32,
// or bf16 under AMP (BF16 = 1). bias [nh, n, n]; mask [nW, n, n] or null
// (window w takes mask[w % nW]).
template <int HD, int BF16>
__global__ void __launch_bounds__(WA_THREADS) wide_qkv_attention_kernel(
    const void* x, int x_bf16, const void* wqkv, const float* bqkv, const float* bias,
    const float* mask, void* att, int n, int C, int nW, float scale) {
  using AttT = typename std::conditional<BF16 != 0, __nv_bfloat16, float>::type;
  using T = WideTile<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qkv_s = reinterpret_cast<float*>(smem);                     // [WA_ROWS][LDR]
  float* scratch = reinterpret_cast<float*>(smem + T::qkv_bytes);   // staging, then scores
  const int w = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row0 = (size_t)w * n;

  if constexpr (BF16 != 0) {
    qkv_tile_bf16<HD>(x, x_bf16, static_cast<const __nv_bfloat16*>(wqkv), qkv_s, scratch, row0,
                      n, h, C);
  } else {
    qkv_tile_f32<HD>(x, x_bf16, static_cast<const float*>(wqkv), qkv_s, scratch, row0, n, h, C);
  }
  __syncthreads();

  // + bias, q * hd^-1/2; under AMP q, k, v are rounded to bf16 for their products
  for (int e = tid; e < n * T::NQ; e += WA_THREADS) {
    const int r = e / T::NQ, c = e % T::NQ;
    float v = qkv_s[r * T::LDR + c] + bqkv[wqkv_row<HD>(c, h, C)];
    if (c < HD) v *= scale;
    qkv_s[r * T::LDR + c] = BF16 ? round_bf16(v) : v;
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
    for (int j = lane; j < n; j += 32) {
      const float p = row[j] / sum;
      row[j] = BF16 ? round_bf16(p) : p;
    }
  }
  __syncthreads();

  for (int e = tid; e < n * HD; e += WA_THREADS) {
    const int i = e / HD, d = e % HD;
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = fmaf(s[i * T::LDS + j], v[j * T::LDR + d], acc);
    store_as(static_cast<AttT*>(att) + (row0 + i) * C + h * HD + d, acc);
  }
}

template <int HD, int BF16>
static cudaError_t launch_wide_qkv_attention(const void* x, int x_bf16, const void* wqkv,
                                             const float* bqkv, const float* bias,
                                             const float* mask, void* att, int windows, int n,
                                             int C, int nh, int nW, cudaStream_t s) {
  constexpr size_t smem = WideTile<HD>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(wide_qkv_attention_kernel<HD, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // hd**-0.5 rounded once from double, as the plain version's scalar is
  const float scale = (float)pow((double)HD, -0.5);
  wide_qkv_attention_kernel<HD, BF16><<<dim3(windows, nh), WA_THREADS, smem, s>>>(
      x, x_bf16, wqkv, bqkv, bias, mask, att, n, C, nW, scale);
  return cudaGetLastError();
}

}  // namespace arpu

// bytes of scratch: the attention output [R, C], bf16 under AMP
extern "C" size_t arpu_wide_attention_workspace(int R, int C, int bf16) {
  return (size_t)R * C * (bf16 ? 2 : 4);
}

static cudaError_t wide_attention(const void* x, int x_bf16, void* out, int out_bf16, int R, int n,
                                  int C, int nh, int nW, const void* wqkv, const float* bqkv,
                                  const void* wproj, const float* bproj, const float* bias,
                                  const float* mask, int bf16, void* ws, cudaStream_t s) {
  const int hd = C / nh, windows = R / n;
  if (n > arpu::WA_ROWS || (hd != 32 && hd != 64) || C % arpu::WA_BK) {
    return cudaErrorInvalidValue;
  }
  if (hd == 32) {
    ARPU_TRY(bf16 ? arpu::launch_wide_qkv_attention<32, 1>(x, x_bf16, wqkv, bqkv, bias, mask, ws,
                                                           windows, n, C, nh, nW, s)
                  : arpu::launch_wide_qkv_attention<32, 0>(x, x_bf16, wqkv, bqkv, bias, mask, ws,
                                                           windows, n, C, nh, nW, s));
  } else {
    ARPU_TRY(bf16 ? arpu::launch_wide_qkv_attention<64, 1>(x, x_bf16, wqkv, bqkv, bias, mask, ws,
                                                           windows, n, C, nh, nW, s)
                  : arpu::launch_wide_qkv_attention<64, 0>(x, x_bf16, wqkv, bqkv, bias, mask, ws,
                                                           windows, n, C, nh, nW, s));
  }
  if (bf16) {
    return arpu::gemm_bf16(static_cast<const __nv_bfloat16*>(ws),
                           static_cast<const __nv_bfloat16*>(wproj), out, out_bf16, R, C, C,
                           arpu::Epilogue{bproj, nullptr, 0, nullptr, nullptr}, 0, 0, s);
  }
  return arpu::launch_gemm_f32(arpu::gemm_args(ws, 0, static_cast<const float*>(wproj), out,
                                               out_bf16, R, C, C, bproj),
                               s);
}

// x, out [R, C] with R = windows * n, n <= 64; hd = C / nh is 32 or 64.
// Weights in nn.Linear layout, f32 (bf16 = 0) or bf16 (AMP): wqkv [3C, C],
// wproj [C, C]. bias [nh, n, n]; mask [nW, n, n] or null. Returns the first
// CUDA error of the two launches.
extern "C" int arpu_wide_attention(const void* x, int x_bf16, void* out, int out_bf16, int R,
                                   int n, int C, int nh, int nW, const void* wqkv,
                                   const float* bqkv, const void* wproj, const float* bproj,
                                   const float* bias, const float* mask, int bf16, void* ws,
                                   void* stream) {
  return static_cast<int>(wide_attention(x, x_bf16, out, out_bf16, R, n, C, nh, nW, wqkv, bqkv,
                                         wproj, bproj, bias, mask, bf16, ws,
                                         static_cast<cudaStream_t>(stream)));
}
