// Device building blocks shared by the Hopper ports of the Swin-block
// TPU kernels (window_attention.cu, ln_mlp.cu, swin_block.cu,
// wide_attention.cu):
//
//   * gemm_bf16, gemm_tf32x3 (gemm_sm90.cuh) the tensor-core GEMM, TMA +
//                       wgmma, f32 accumulate: bf16 operands under AMP; f32
//                       operands in 3xTF32 for every golden product and the
//                       ResiDual GEMMs of both modes
//   * add_layernorm_kernel  h = x (+ r); y = LN(h), f32 statistics
//   * attention_core_kernel one block per (window, head): scores, relative
//                       bias, SW-MSA mask, exact f32 softmax, @V (golden;
//                       the AMP attention is window_attention_tc.cuh)
//
// Layouts: A [M, K] row-major, W [N, K] row-major (nn.Linear layout), C and
// the residual operands [M, N] row-major, all contiguous. Activations and
// residuals are f32 or bf16 (a runtime flag per pointer) where a kernel
// reads them on the CUDA cores; a GEMM's A is bf16 under AMP and f32 in
// 3xTF32. Under AMP every intermediate that only a GEMM reads is stored in
// bf16, the rounding its reader applies anyway, so the launch sequences move
// about half the bytes.
//
// GEMM epilogue, in this order: v = acc; v += bias[n]; v *= col_scale[n];
// v = gelu(v); v += r1[m, n]; v += r2[m, n]. The 3xTF32 GEMM's prologue may
// subtract a_sub[k] from A's columns (the ResiDual centring). Each step is
// optional.
//
// Host-side helpers (launch_*) enqueue on the caller's stream and never
// synchronise; the exported C functions return the first CUDA error.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm_sm90.cuh"

// variadic: a template call's commas stay inside the argument
#define ARPU_TRY(...)                                 \
  do {                                                \
    const cudaError_t arpu_err_ = (__VA_ARGS__);      \
    if (arpu_err_ != cudaSuccess) return arpu_err_;   \
  } while (0)

namespace arpu {

__device__ __forceinline__ float ld(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, size_t i, float v, int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- row LayerNorm, one warp a row, f32 statistics ---------------------
__global__ void __launch_bounds__(256) add_layernorm_kernel(
    const void* x, int x_bf16, const void* r, int r_bf16, float* h_out, void* y, int y_bf16,
    const float* gamma, const float* beta, int rows, int C, float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = (size_t)row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) {
    float v = ld(x, base + c, x_bf16);
    if (r) v += ld(r, base + c, r_bf16);
    if (h_out) h_out[base + c] = v;
    s += v;
  }
  const float mu = warp_sum(s) / C;
  float q = 0.0f;
  for (int c = lane; c < C; c += 32) {
    float v = ld(x, base + c, x_bf16);
    if (r) v += ld(r, base + c, r_bf16);
    q += (v - mu) * (v - mu);
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  for (int c = lane; c < C; c += 32) {
    float v = ld(x, base + c, x_bf16);
    if (r) v += ld(r, base + c, r_bf16);
    st(y, base + c, (v - mu) * rstd * gamma[c] + beta[c], y_bf16);
  }
}

static inline cudaError_t launch_add_layernorm(const void* x, int x_bf16, const void* r,
                                               int r_bf16, float* h_out, void* y, int y_bf16,
                                               const float* gamma, const float* beta, int rows,
                                               int C, cudaStream_t s) {
  add_layernorm_kernel<<<(rows + 7) / 8, 256, 0, s>>>(x, x_bf16, r, r_bf16, h_out, y, y_bf16,
                                                      gamma, beta, rows, C, 1e-5f);
  return cudaGetLastError();
}

// ---- window attention core: one block per (window, head) ----------------
// The golden route's: qkv [W*n, 3C] -> out [W*n, C] (this head's hd columns),
// f32; q is scaled by hd^-1/2 here. bias [nh, n, n]; mask [nW, n, n] or null
// (window w takes mask[w % nW]).
constexpr int ATT_THREADS = 256;

__global__ void __launch_bounds__(ATT_THREADS) attention_core_kernel(
    const float* qkv, float* out, const float* bias, const float* mask, int n, int nh, int C,
    int nW, float scale) {
  extern __shared__ float sm[];
  const int hd = C / nh;
  float* q = sm;                 // [n][hd]
  float* k = q + n * hd;         // [n][hd + 1]
  float* v = k + n * (hd + 1);   // [n][hd]
  float* s = v + n * hd;         // [n][n + 1]
  const int w = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t row0 = (size_t)w * n;

  for (int e = tid; e < n * hd; e += ATT_THREADS) {
    const int t = e / hd, d = e % hd;
    const float* src = qkv + (row0 + t) * 3 * C + h * hd + d;
    q[t * hd + d] = src[0] * scale;
    k[t * (hd + 1) + d] = src[C];
    v[t * hd + d] = src[2 * C];
  }
  __syncthreads();

  const float* bh = bias + (size_t)h * n * n;
  const float* mw = mask ? mask + (size_t)(w % nW) * n * n : nullptr;
  for (int e = tid; e < n * n; e += ATT_THREADS) {
    const int i = e / n, j = e % n;
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(q[i * hd + d], k[j * (hd + 1) + d], acc);
    acc += bh[e];
    if (mw) acc += mw[e];
    s[i * (n + 1) + j] = acc;
  }
  __syncthreads();

  for (int i = warp; i < n; i += ATT_THREADS / 32) {
    float* row = s + i * (n + 1);
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
    for (int j = lane; j < n; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int e = tid; e < n * hd; e += ATT_THREADS) {
    const int i = e / hd, d = e % hd;
    float acc = 0.0f;
    for (int j = 0; j < n; ++j) acc = fmaf(s[i * (n + 1) + j], v[j * hd + d], acc);
    out[(row0 + i) * C + h * hd + d] = acc;
  }
}

static inline size_t attention_smem_bytes(int n, int hd) {
  return sizeof(float) * ((size_t)n * hd * 2 + (size_t)n * (hd + 1) + (size_t)n * (n + 1));
}

static inline cudaError_t launch_attention_core(const float* qkv, float* out,
                                                const float* bias, const float* mask, int windows,
                                                int n, int nh, int C, int nW, cudaStream_t s) {
  const int hd = C / nh;
  const size_t smem = attention_smem_bytes(n, hd);
  if (smem > 48 * 1024) {
    ARPU_TRY(cudaFuncSetAttribute(attention_core_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  }
  // hd**-0.5 rounded once from double, as the plain version's scalar is
  const float scale = (float)pow((double)hd, -0.5);
  attention_core_kernel<<<dim3(windows, nh), ATT_THREADS, smem, s>>>(qkv, out, bias, mask, n, nh,
                                                                     C, nW, scale);
  return cudaGetLastError();
}

}  // namespace arpu

extern "C" const char* arpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
