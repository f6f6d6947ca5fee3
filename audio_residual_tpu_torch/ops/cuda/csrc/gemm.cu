// C entry points of the TMA + wgmma GEMM (gemm_sm90.cuh) in its two modes,
// bf16 and 3xTF32, for their own wrappers (ops/cuda/gemm.py) and tests: the
// Swin-block kernels call the same functions from their launch sequences.
// Also the TMA map encoder of the bf16 weights that the AMP kernels of
// K2-K5 read by TMA, and for the 3xTF32 linear (ops/cuda/linear.py) the
// TF32 split of an operand, transposed as it is written.
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
// [K] f32 or null, subtracted from A's columns before the split. a_t: A
// arrives transposed, [K, M]; splits > 1: K in splits, C [splits, M, N]
// (gemm_sm90.cuh::gemm_tf32x3).
extern "C" int arpu_gemm_tf32x3(const float* A, const float* w_hi, const float* w_lo, float* C,
                                int M, int N, int K, int bn, int stages, const float* bias,
                                const float* col_scale, int gelu, const float* r1, const void* r2,
                                int r2_bf16, const float* a_sub, int a_t, int splits,
                                void* stream) {
  return static_cast<int>(arpu::gemm_tf32x3(A, arpu::Tf32x3Weight{w_hi, w_lo, bn, stages}, C, M,
                                            N, K, arpu::Epilogue{bias, col_scale, gelu, r1, r2},
                                            r2_bf16, static_cast<cudaStream_t>(stream), a_sub, a_t,
                                            splits));
}

namespace {

// x = hi + lo exactly: hi is x rounded to TF32, to nearest with ties away
// (half a TF32 step added to the magnitude bits, the low 13 bits cleared),
// lo the remainder; an infinity or NaN keeps its bits in hi with lo = 0.
// The same bits as ops/cuda/tf32x3.py::split_tf32.
__device__ __forceinline__ void split_exact(float x, float& hi, float& lo) {
  if (isfinite(x)) {
    hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
    lo = __fsub_rn(x, hi);
  } else {
    hi = x;
    lo = 0.0f;
  }
}

__device__ __forceinline__ void split_store(float* hi, float* lo, size_t at, float4 v) {
  float4 h, l;
  split_exact(v.x, h.x, l.x);
  split_exact(v.y, h.y, l.y);
  split_exact(v.z, h.z, l.z);
  split_exact(v.w, h.w, l.w);
  *reinterpret_cast<float4*>(hi + at) = h;
  *reinterpret_cast<float4*>(lo + at) = l;
}

// a block: [64, 64] of x, 256 threads, 4 consecutive elements a thread
constexpr int SPLIT_TILE = 64, SPLIT_THREADS = 256, SPLIT_LANES = SPLIT_TILE / 4;

// x [rows, cols] f32 -> hi, lo [rows, cols] (if hi) and hi_t, lo_t [cols,
// ld_t] (if hi_t): x^T split, its columns rows .. ld_t - 1 zero. One read of
// x through a shared-memory tile; every load and store 16 bytes, a warp's
// contiguous (cols and ld_t multiples of 4).
__global__ void __launch_bounds__(SPLIT_THREADS)
    split_tf32_kernel(const float* __restrict__ x, int rows, int cols, float* __restrict__ hi,
                      float* __restrict__ lo, float* __restrict__ hi_t,
                      float* __restrict__ lo_t, int ld_t) {
  __shared__ float tile[SPLIT_TILE][SPLIT_TILE + 1];
  const int c0 = blockIdx.x * SPLIT_TILE, r0 = blockIdx.y * SPLIT_TILE;
  const int tx = threadIdx.x % SPLIT_LANES, ty = threadIdx.x / SPLIT_LANES;
  constexpr int STEP = SPLIT_THREADS / SPLIT_LANES;
  for (int i = ty; i < SPLIT_TILE; i += STEP) {
    const int r = r0 + i, c = c0 + 4 * tx;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows && c < cols) {
      const size_t at = (size_t)r * cols + c;
      v = *reinterpret_cast<const float4*>(x + at);
      if (hi) split_store(hi, lo, at, v);
    }
    tile[i][4 * tx] = v.x;
    tile[i][4 * tx + 1] = v.y;
    tile[i][4 * tx + 2] = v.z;
    tile[i][4 * tx + 3] = v.w;
  }
  if (!hi_t) return;
  __syncthreads();
  for (int i = ty; i < SPLIT_TILE; i += STEP) {
    const int c = c0 + i, r = r0 + 4 * tx;  // elements (c, r .. r + 3) of x^T
    if (c < cols && r < ld_t) {
      const float4 v = make_float4(tile[4 * tx][i], tile[4 * tx + 1][i], tile[4 * tx + 2][i],
                                   tile[4 * tx + 3][i]);
      split_store(hi_t, lo_t, (size_t)c * ld_t + r, v);
    }
  }
}

}  // namespace

// The TF32 split of x [rows, cols] f32: hi, lo [rows, cols] (both or
// neither null) and hi_t, lo_t = the split of x^T, [cols, ld_t] with ld_t >=
// rows, columns from rows on zero (both or neither null); cols and ld_t
// multiples of 4, the pointers 16-byte aligned. Returns 0 or a CUDA error.
extern "C" int arpu_split_tf32(const float* x, int rows, int cols, float* hi, float* lo,
                               float* hi_t, float* lo_t, int ld_t, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 4 || !hi != !lo || !hi_t != !lo_t || (!hi && !hi_t) ||
      (hi_t && (ld_t < rows || ld_t % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* pointers[5] = {x, hi, lo, hi_t, lo_t};
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int span = hi_t ? ld_t : rows;
  const dim3 grid((cols + SPLIT_TILE - 1) / SPLIT_TILE, (span + SPLIT_TILE - 1) / SPLIT_TILE);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  split_tf32_kernel<<<grid, SPLIT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, rows, cols, hi, lo, hi_t, lo_t, ld_t);
  return static_cast<int>(cudaGetLastError());
}
