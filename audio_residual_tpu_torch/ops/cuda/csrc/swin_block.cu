// Hopper port of the TPU kernel `fused_swin_block`
// (audio_residual_tpu/ops/pallas/swin_block.py::_kernel): one whole Swin
// block in window space -- LN1, W-MSA, output projection, the optional
// ResiDual epilogue ((a - mean) B^T * lam) B in f32, + x, LN2, fc1, exact
// GELU, fc2, + h, and the double-FFN quirk when ResiDual is on.
//
// What bounds it on the H100: bytes. The TPU kernel keeps the block in
// VMEM; a 64-token window's f32 qkv at C=384 alone (288 KB) exceeds Hopper's
// 227 KB of shared memory, so this is LN1 -> window attention -> residual
// FFN in window space as a sequence of launches (blocks.cuh), the plan the
// JAX package declares equivalent (swin_block.py::_split_block), and such a
// sequence is bound by the bytes of its intermediates: at HTSAT-tiny layer 0
// and B=32 (R = 131072 rows, C = 96, ResiDual and the double FFN) about
// 2.2 GB a launch with f32 intermediates against 46 GFLOP of products.
//
// Design: under AMP the attention half is K2's qkv + attention kernel
// (window_attention_tc.cuh: q|k|v never in device memory) and the proj
// GEMM; every other intermediate that only a GEMM reads is stored in bf16
// (blocks.cuh), and every other bf16 product runs on the TMA + wgmma GEMM
// (gemm_sm90.cuh) with bf16 weights the wrapper keeps per weight version.
// The attention output a stays f32 between the halves, as in the monolithic
// kernel; with no ResiDual the first residual add rides the proj GEMM's
// epilogue. The golden route's FFN half is K3's: fc1 and fc2 in 3xTF32 on
// the tensor cores (gemm_sm90.cuh::gemm_tf32x3, weights split by the
// wrapper); its qkv, proj and ResiDual products stay on the f32 GEMM.
#include "blocks.cuh"

static size_t swin_block_ws(int R, int C, int hidden, int kr, int bf16) {
  const size_t rc = (size_t)R * C;
  return arpu::span(rc * arpu::elem_bytes(bf16)) + 2 * arpu::span(rc * 4) +
         arpu::window_attention_ws(R, C, bf16) + arpu::ffn_ws(R, C, hidden, bf16) +
         arpu::span((size_t)R * kr * 4);
}

// bytes of scratch
extern "C" size_t arpu_swin_block_workspace(int R, int C, int hidden, int kr, int bf16) {
  return swin_block_ws(R, C, hidden, kr, bf16);
}

static cudaError_t swin_block(const void* x, int x_bf16, void* out, int out_bf16, int R, int n,
                              int C, int nh, int nW, int hidden, const float* n1s,
                              const float* n1b, const void* wqkv, const float* bqkv,
                              const void* wproj, const float* bproj, const float* n2s,
                              const float* n2b, const arpu::FfnWeights& ffn,
                              const float* bfc1, const float* bfc2, const float* bias,
                              const float* mask, const arpu::AttentionPlan& plan,
                              const float* rbasis, const float* rbasis_t, const float* rmean,
                              const float* rlam, int kr, int double_ffn, int bf16, void* ws,
                              cudaStream_t s) {
  const size_t rc = (size_t)R * C;
  arpu::Arena ar{static_cast<unsigned char*>(ws)};
  void* y = ar.take<unsigned char>(rc * arpu::elem_bytes(bf16));  // LN1(x), bf16 under AMP
  float* a = ar.take<float>(rc);
  float* h1 = ar.take<float>(rc);
  const arpu::Arena attn_scratch = ar;
  ar.p += arpu::window_attention_ws(R, C, bf16);
  const arpu::FfnScratch ffn_scratch = arpu::take_ffn(ar, R, C, hidden, bf16);
  float* proj = ar.take<float>((size_t)R * kr);

  ARPU_TRY(arpu::launch_add_layernorm(x, x_bf16, nullptr, 0, nullptr, y, bf16, n1s, n1b, R, C, s));
  if (rbasis) {
    ARPU_TRY(arpu::run_window_attention(y, bf16, a, 0, nullptr, 0, R, n, C, nh, nW, wqkv, bqkv,
                                        wproj, bproj, bias, mask, bf16, plan, attn_scratch, s));
    ARPU_TRY(arpu::run_residual_epilogue(a, 0, x, x_bf16, h1, R, C, kr, rbasis, rbasis_t, rmean,
                                         rlam, proj, s));
  } else {
    // h1 = x + proj(attention): the residual add rides the proj epilogue
    ARPU_TRY(arpu::run_window_attention(y, bf16, h1, 0, x, x_bf16, R, n, C, nh, nW, wqkv, bqkv,
                                        wproj, bproj, bias, mask, bf16, plan, attn_scratch, s));
  }
  return arpu::run_ffn(x, x_bf16, h1, out, out_bf16, R, C, hidden, n2s, n2b, ffn, bfc1, bfc2,
                       double_ffn, bf16, 0, ffn_scratch, s);
}

// x, out [R, C] windows (already rolled and partitioned), R = windows * n.
// Weights in nn.Linear layout [out, in], f32 (bf16 = 0) or bf16 (AMP);
// rbasis / rbasis_t null without ResiDual. bias, mask and the attention
// plan (w_map ... blocks) as arpu_window_attention takes them. fc1 and fc2
// come as arpu_residual_ffn takes them: in the golden route split for
// 3xTF32, wfc1 and wfc2 their hi parts and wfc1_lo and wfc2_lo their lo
// parts, with each GEMM's plan (N tile, ring stages; tf32x3.py::gemm_plan);
// under AMP wfc1 and wfc2 bf16, the lo parts null and the plans 0.
extern "C" int arpu_swin_block(const void* x, int x_bf16, void* out, int out_bf16, int R, int n,
                               int C, int nh, int nW, int hidden, const float* n1s,
                               const float* n1b, const void* wqkv, const float* bqkv,
                               const void* wproj, const float* bproj, const float* n2s,
                               const float* n2b, const void* wfc1, const float* wfc1_lo,
                               int fc1_bn, int fc1_stages, const float* bfc1, const void* wfc2,
                               const float* wfc2_lo, int fc2_bn, int fc2_stages,
                               const float* bfc2, const float* bias, const float* mask,
                               const void* w_map, int heads_per_block, int windows_per_block,
                               int stages, int smem, int blocks, const float* rbasis,
                               const float* rbasis_t, const float* rmean, const float* rlam,
                               int kr, int double_ffn, int bf16, void* ws, void* stream) {
  const arpu::AttentionPlan plan{w_map, heads_per_block, windows_per_block, stages, smem, blocks};
  arpu::FfnWeights ffn{};
  if (bf16) {
    ffn.w1 = static_cast<const arpu::bf16_t*>(wfc1);
    ffn.w2 = static_cast<const arpu::bf16_t*>(wfc2);
  } else {
    ffn.x1 = {static_cast<const float*>(wfc1), wfc1_lo, fc1_bn, fc1_stages};
    ffn.x2 = {static_cast<const float*>(wfc2), wfc2_lo, fc2_bn, fc2_stages};
  }
  return static_cast<int>(swin_block(x, x_bf16, out, out_bf16, R, n, C, nh, nW, hidden, n1s, n1b,
                                     wqkv, bqkv, wproj, bproj, n2s, n2b, ffn, bfc1, bfc2, bias,
                                     mask, plan, rbasis, rbasis_t, rmean, rlam, kr, double_ffn,
                                     bf16, ws, static_cast<cudaStream_t>(stream)));
}
