// C entry point of the bf16 TMA + wgmma GEMM (gemm_sm90.cuh), for its own
// wrapper (ops/cuda/gemm.py) and tests: the Swin-block kernels call the
// same function from their launch sequences.
#include "common.cuh"

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
