// Launch sequences of the Swin-block kernels, built from common.cuh.
//
// The TPU kernels keep a whole block (or half of one) resident in VMEM. On
// Hopper a 64-token window's f32 qkv at C=384 alone is 288 KB, above the
// 227 KB of shared memory a block may use, so each TPU kernel becomes a
// fixed sequence of launches with f32 intermediates in device memory:
//   window attention = qkv GEMM -> attention core -> proj GEMM
//   residual FFN     = [ResiDual GEMMs] -> add+LN2 -> fc1+GELU -> fc2 + h1
//                      [-> double-FFN second pass]
// Fusing a block into one kernel is later work (ROADMAP, Queue 2). Wide
// layers (C >= 1024) do not come here for their attention: K5
// (wide_attention.cu) cuts the work at head boundaries and keeps qkv on chip.
#pragma once

#include "common.cuh"

namespace arpu {

// floats of run_window_attention scratch: qkv [R, 3C] + att [R, C]
static inline size_t window_attention_ws(long R, long C) { return (size_t)R * 4 * C; }

// y [R, C] -> out [R, C] = proj(attention(qkv(y))) (+ r1 in the proj
// epilogue when r1 is given).
static inline void run_window_attention(const void* y, int y_bf16, void* out, int out_bf16,
                                        const void* r1, int r1_bf16, int R, int n, int C, int nh,
                                        int nW, const float* wqkv, const float* bqkv,
                                        const float* wproj, const float* bproj, const float* bias,
                                        const float* mask, int bf16, float* ws, cudaStream_t s) {
  float* qkv = ws;
  float* att = ws + (size_t)R * 3 * C;
  launch_gemm(gemm_args(y, y_bf16, wqkv, qkv, 0, R, 3 * C, C, bqkv), bf16, s);
  launch_attention_core(qkv, att, bias, mask, R / n, n, nh, C, nW, bf16, s);
  GemmArgs g = gemm_args(att, 0, wproj, out, out_bf16, R, C, C, bproj);
  g.r1 = r1;
  g.r1_bf16 = r1_bf16;
  launch_gemm(g, bf16, s);
}

// ResiDual epilogue and the first residual add, always f32 (the method's
// precision-sensitive core): h1 = x + ((a - mean) @ basis^T * lam) @ basis.
// basis [kr, C]; basis_t [C, kr]; proj scratch [R, kr].
static inline void run_residual_epilogue(const void* a, int a_bf16, const void* x, int x_bf16,
                                         float* h1, int R, int C, int kr, const float* basis,
                                         const float* basis_t, const float* mean,
                                         const float* lam, float* proj, cudaStream_t s) {
  GemmArgs p = gemm_args(a, a_bf16, basis, proj, 0, R, kr, C, nullptr);
  p.a_sub = mean;
  p.col_scale = lam;
  launch_gemm(p, 0, s);
  GemmArgs q = gemm_args(proj, 0, basis_t, h1, 0, R, C, kr, nullptr);
  q.r1 = x;
  q.r1_bf16 = x_bf16;
  launch_gemm(q, 0, s);
}

// floats of run_ffn scratch: z [R, C] + hid [R, hidden] + y2 [R, C]
static inline size_t ffn_ws(long R, long C, long hidden) { return (size_t)R * (2 * C + hidden); }

// h1 [R, C] f32 -> out = h1 + fc2(GELU(fc1(LN2(h1)))). With double_ffn
// (the reference's patched-forward quirk): y2 = x + that, out = y2 + FFN(y2).
// z_ready: LN2(h1) is already in the z slot of ws.
static inline void run_ffn(const void* x, int x_bf16, const float* h1, void* out, int out_bf16,
                           int R, int C, int hidden, const float* n2s, const float* n2b,
                           const float* wfc1, const float* bfc1, const float* wfc2,
                           const float* bfc2, int double_ffn, int bf16, int z_ready, float* ws,
                           cudaStream_t s) {
  float* z = ws;
  float* hid = z + (size_t)R * C;
  float* y2 = hid + (size_t)R * hidden;
  if (!z_ready) launch_add_layernorm(h1, 0, nullptr, 0, nullptr, z, 0, n2s, n2b, R, C, s);
  GemmArgs fc1 = gemm_args(z, 0, wfc1, hid, 0, R, hidden, C, bfc1);
  fc1.gelu = 1;
  launch_gemm(fc1, bf16, s);
  GemmArgs fc2 = gemm_args(hid, 0, wfc2, out, out_bf16, R, C, hidden, bfc2);
  fc2.r1 = h1;
  if (!double_ffn) {
    launch_gemm(fc2, bf16, s);
    return;
  }
  fc2.C = y2;  // y2 = ((fc2 + b) + h1) + x
  fc2.c_bf16 = 0;
  fc2.r2 = x;
  fc2.r2_bf16 = x_bf16;
  launch_gemm(fc2, bf16, s);
  launch_add_layernorm(y2, 0, nullptr, 0, nullptr, z, 0, n2s, n2b, R, C, s);
  launch_gemm(fc1, bf16, s);
  GemmArgs last = gemm_args(hid, 0, wfc2, out, out_bf16, R, C, hidden, bfc2);
  last.r1 = y2;
  launch_gemm(last, bf16, s);
}

}  // namespace arpu
