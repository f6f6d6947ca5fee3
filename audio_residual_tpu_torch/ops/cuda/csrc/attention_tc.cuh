// Window attention core on the tensor cores (sm_80+ mma.sync), written for
// one 64-token window tile in shared memory: for one head,
//   S = q k^T (q pre-scaled by hd^-1/2) + relative bias + SW-MSA mask,
//   P = softmax(S) exact, in f32 (exp, then times the row sum's
//       reciprocal), rounded to bf16,
//   O = P v, f32 accumulate, stored bf16,
// the AMP contract of the TPU kernels (bf16 operands, f32 scores, softmax
// and sums). Used by the AMP qkv + attention kernel of K2, K4 and K5
// (window_attention_tc.cuh).
//
// One warp computes 16 query rows against all 64 keys; a warpgroup's four
// warps cover the window. mma.sync m16n8k16 rather than wgmma, because:
//   * S's accumulator fragment is, element for element, the A fragment P
//     needs for P v (the FlashAttention-2 register reuse), so P never goes
//     through shared memory;
//   * v is read K-major for P v with ldmatrix.trans from the same row-major
//     tile, where a wgmma B operand would need v written again in a
//     transposed or core-matrix layout;
//   * the core is a few percent of the kernel's products (0.5 of 13.4 GFLOP
//     a launch at HTSAT-base layer 3), so its rate matters less than its
//     traffic.
//
// Head dims: any multiple of 8 up to 64. HTSAT-tiny's 24 (every layer) is
// no multiple of 16, the depth of m16n8k16: its q k^T takes one m16n8k16
// step over d 0-15 and one m16n8k8 step over d 16-23, and its P v a third
// n8 tile through ldmatrix.x2.trans. Chosen over zero-padding each head to
// 32 columns in the shared tile, which would cost a third more core
// products, a third more shared memory for q|k|v, and an epilogue that
// writes padded columns.
//
// Layout: q, k, v are bf16 tiles [64 rows][ld] (row = token, the head's hd
// columns contiguous), rows 16-byte aligned with ld * 2 bytes an odd
// multiple of 16 so that ldmatrix is free of bank conflicts. bias and mask
// are f32 [64][64]; the caller pads them: key columns past the window's
// tokens hold -inf in bias (they drop out of the softmax), padded query rows
// hold 0. Rows past the window's tokens are computed and not stored by the
// caller.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace arpu {
namespace attn_tc {

constexpr int TOKENS = 64;  // keys (and query rows) of a window tile

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(shared_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(shared_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(shared_u32(p)));
}

// d += a b: m16n8k16, bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: m16n8k8, bf16 operands, f32 accumulate (a head dim's last 8
// columns when it is no multiple of 16)
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// two values rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Query rows r0 .. r0 + 15 of one head, by one warp. q, k, v point at the
// head's first column of row 0; o (bf16, row stride ldo) receives the same
// rows, HD columns. o may alias q: each warp reads only its own q rows, and
// before it writes them. Fragments (m16n8k16): lane l holds rows g = l / 4
// and g + 8, columns 2 (l % 4) + {0, 1} of each 8-column tile.
template <int HD>
__device__ __forceinline__ void head_rows16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, int ld,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ mask, __nv_bfloat16* o,
                                            int ldo, int r0) {
  static_assert(HD % 8 == 0 && HD <= 64, "head dim: a multiple of 8, at most 64");
  constexpr int K16 = HD / 16;        // full 16-deep steps over d
  constexpr bool TAIL = HD % 16 != 0;  // then d 16 K16 .. + 7 in one 8-deep step
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int ra = r0 + lane / 4, rb = ra + 8;

  // S [16, 64]: eight 8-key tiles
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    uint32_t a[4];  // q rows r0.., columns 16 kk ..: lanes 0-15 rows, 16-31 the upper 8 columns
    ldsm_x4(a, q + (r0 + lane % 16) * ld + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // k rows (keys) 16 np .. + 15 as two B fragments: matrices (keys +0,
      // d +0), (keys +0, d +8), (keys +8, d +0), (keys +8, d +8)
      uint32_t b[4];
      ldsm_x4(b, k + (16 * np + lane % 8 + 8 * (lane / 16)) * ld + 16 * kk + 8 * ((lane / 8) % 2));
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
  if constexpr (TAIL) {
    // d 16 K16 .. + 7: A is q rows r0 .. + 7 and r0 + 8 .. + 15 (lanes 0-15
    // address them); each B fragment is 8 keys, four of them an ldmatrix.x4
    uint32_t a[2];
    ldsm_x2(a, q + (r0 + lane % 16) * ld + 16 * K16);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, k + (32 * np + lane) * ld + 16 * K16);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16_k8(s[4 * np + j], a, b[j]);
    }
  }

  // + bias (+ mask), in that order, as the plain version adds them
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 ba = *reinterpret_cast<const float2*>(bias + ra * TOKENS + c);
    const float2 bb = *reinterpret_cast<const float2*>(bias + rb * TOKENS + c);
    s[j][0] += ba.x, s[j][1] += ba.y, s[j][2] += bb.x, s[j][3] += bb.y;
    if (mask) {
      const float2 ma = *reinterpret_cast<const float2*>(mask + ra * TOKENS + c);
      const float2 mb = *reinterpret_cast<const float2*>(mask + rb * TOKENS + c);
      s[j][0] += ma.x, s[j][1] += ma.y, s[j][2] += mb.x, s[j][3] += mb.y;
    }
  }

  // exact softmax of rows ra and rb: each row's 64 values lie in one lane quad
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mxa = fmaxf(mxa, fmaxf(s[j][0], s[j][1]));
    mxb = fmaxf(mxb, fmaxf(s[j][2], s[j][3]));
  }
  mxa = quad_max(mxa);
  mxb = quad_max(mxb);
  float suma = 0.0f, sumb = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = expf(s[j][0] - mxa), s[j][1] = expf(s[j][1] - mxa);
    s[j][2] = expf(s[j][2] - mxb), s[j][3] = expf(s[j][3] - mxb);
    suma += s[j][0] + s[j][1];
    sumb += s[j][2] + s[j][3];
  }
  suma = quad_sum(suma);
  sumb = quad_sum(sumb);
  // one reciprocal a row, not 32 IEEE divisions a lane: the divisions cost
  // more than the products, most of all under the SW-MSA mask, whose
  // exponentials are near zero (HTSAT-tiny layer 0: 0.27 -> 0.11 ms a
  // launch, PERF.md)
  const float ia = 1.0f / suma, ib = 1.0f / sumb;

  // P in bf16 as the A fragments of the four 16-key steps: tiles 2 kk and
  // 2 kk + 1 of S are its columns 0-7 and 8-15
  uint32_t p[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16(s[2 * kk][0] * ia, s[2 * kk][1] * ia);
    p[kk][1] = pack_bf16(s[2 * kk][2] * ib, s[2 * kk][3] * ib);
    p[kk][2] = pack_bf16(s[2 * kk + 1][0] * ia, s[2 * kk + 1][1] * ia);
    p[kk][3] = pack_bf16(s[2 * kk + 1][2] * ib, s[2 * kk + 1][3] * ib);
  }

  // O [16, HD] = P v; v [keys][d] row-major is the K-major B operand
  // through ldmatrix.trans: matrices (keys +0, d +0), (keys +8, d +0),
  // (keys +0, d +8), (keys +8, d +8)
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < K16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, v + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * ld + 16 * dp +
                           8 * (lane / 16));
      mma_bf16(acc[2 * dp], p[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], p[kk], b[2], b[3]);
    }
    if constexpr (TAIL) {  // the last 8 columns: matrices (keys +0, d), (keys +8, d)
      uint32_t b[2];
      ldsm_x2_trans(b, v + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * ld + 16 * K16);
      mma_bf16(acc[2 * K16], p[kk], b[0], b[1]);
    }
  }

  __syncwarp();  // o may alias this warp's q rows
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(o + ra * ldo + c) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(o + rb * ldo + c) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

}  // namespace attn_tc
}  // namespace arpu
