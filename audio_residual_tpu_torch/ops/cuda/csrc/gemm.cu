// C entry points of the TMA + wgmma GEMM (gemm_sm90.cuh) in its two modes,
// bf16 and 3xTF32, for their own wrappers (ops/cuda/gemm.py) and tests: the
// Swin-block kernels call the same functions from their launch sequences.
// Also the TMA map encoder of the bf16 weights that the AMP kernels of
// K2-K5 read by TMA.
#include <string.h>

#include "common.cuh"

// The TMA map of a bf16 weight [rows, cols] in boxes of [box_rows, 64]
// (128-byte swizzle), for the AMP kernels that take a map from their
// wrapper, which makes it once per weight version. Returns 0 or a CUDA
// error.
extern "C" int arpu_weight_map(const void* w, int rows, int cols, int box_rows, void* map) {
  if (reinterpret_cast<uintptr_t>(w) % 16 || cols % 8 || box_rows < 1 || box_rows > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap m;  // 64-byte aligned here; the caller's buffer need not be
  if (!arpu::sm90::encode_map(&m, w, rows, cols, box_rows, arpu::sm90::BK, 1,
                              CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  memcpy(map, &m, sizeof(m));
  return 0;
}

// C [M, N] (bf16 if c_bf16, else f32) = epi(A [M, K] @ W [N, K]^T), A and W
// bf16; bias, col_scale [N] f32 or null; r1, r2 [M, N] or null, bf16 if
// their flag is set, else f32.
extern "C" int arpu_gemm(const void* A, const void* W, void* C, int c_bf16, int M, int N, int K,
                         const float* bias, const float* col_scale, int gelu, const void* r1,
                         int r1_bf16, const void* r2, int r2_bf16, void* stream) {
  return static_cast<int>(arpu::gemm_bf16(
      static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(W), C, c_bf16, M, N,
      K, arpu::Epilogue{bias, col_scale, gelu, r1, r2}, r1_bf16, r2_bf16,
      static_cast<cudaStream_t>(stream)));
}

// C [M, N] f32 = epi(A [M, K] f32 @ W [N, K]^T) in 3xTF32: W as w_hi (W
// rounded to TF32) and w_lo (W - w_hi), f32; the plan (N tile bn, ring
// stages) from ops/cuda/tf32x3.py::gemm_plan. bias, col_scale [N] f32 or
// null; r1 [M, N] f32 or null; r2 [M, N] or null, bf16 if r2_bf16; a_sub
// [K] f32 or null, subtracted from A's columns before the split.
extern "C" int arpu_gemm_tf32x3(const float* A, const float* w_hi, const float* w_lo, float* C,
                                int M, int N, int K, int bn, int stages, const float* bias,
                                const float* col_scale, int gelu, const float* r1, const void* r2,
                                int r2_bf16, const float* a_sub, void* stream) {
  return static_cast<int>(arpu::gemm_tf32x3(A, arpu::Tf32x3Weight{w_hi, w_lo, bn, stages}, C, M,
                                            N, K, arpu::Epilogue{bias, col_scale, gelu, r1, r2},
                                            r2_bf16, static_cast<cudaStream_t>(stream), a_sub));
}
