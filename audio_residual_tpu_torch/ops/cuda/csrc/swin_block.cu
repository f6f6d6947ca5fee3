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
// epilogue. The golden route runs every product -- qkv, proj, the
// ResiDual's two, fc1 and fc2 -- in 3xTF32 on the tensor cores
// (gemm_sm90.cuh::gemm_tf32x3, weights split by the wrapper), with the f32
// attention core between qkv and proj; the ResiDual runs there under AMP
// too (it is f32 in both modes).
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
                              const float* n1b, const arpu::AttentionWeights& att,
                              const float* bqkv, const float* bproj, const float* n2s,
                              const float* n2b, const arpu::FfnWeights& ffn,
                              const float* bfc1, const float* bfc2, const float* bias,
                              const float* mask, const arpu::AttentionPlan& plan,
                              const arpu::ResidualWeights* res, int double_ffn, int bf16,
                              void* ws, cudaStream_t s) {
  const size_t rc = (size_t)R * C;
  arpu::Arena ar{static_cast<unsigned char*>(ws)};
  void* y = ar.take<unsigned char>(rc * arpu::elem_bytes(bf16));  // LN1(x), bf16 under AMP
  float* a = ar.take<float>(rc);
  float* h1 = ar.take<float>(rc);
  const arpu::Arena attn_scratch = ar;
  ar.p += arpu::window_attention_ws(R, C, bf16);
  const arpu::FfnScratch ffn_scratch = arpu::take_ffn(ar, R, C, hidden, bf16);
  float* proj = res ? ar.take<float>((size_t)R * res->kr) : nullptr;

  ARPU_TRY(arpu::launch_add_layernorm(x, x_bf16, nullptr, 0, nullptr, y, bf16, n1s, n1b, R, C, s));
  if (res) {
    ARPU_TRY(arpu::run_window_attention(y, bf16, a, 0, nullptr, 0, R, n, C, nh, nW, att, bqkv,
                                        bproj, bias, mask, bf16, plan, attn_scratch, s));
    ARPU_TRY(arpu::run_residual_epilogue(a, x, x_bf16, h1, R, C, *res, proj, s));
  } else {
    // h1 = x + proj(attention): the residual add rides the proj epilogue
    ARPU_TRY(arpu::run_window_attention(y, bf16, h1, 0, x, x_bf16, R, n, C, nh, nW, att, bqkv,
                                        bproj, bias, mask, bf16, plan, attn_scratch, s));
  }
  return arpu::run_ffn(x, x_bf16, h1, out, out_bf16, R, C, hidden, n2s, n2b, ffn, bfc1, bfc2,
                       double_ffn, bf16, 0, ffn_scratch, s);
}

// x, out [R, C] windows (already rolled and partitioned), R = windows * n.
// Weights in nn.Linear layout [out, in]. Each weight matrix comes as its
// product takes it, the pattern of arpu_residual_ffn: in the golden route
// split for 3xTF32, the matrix argument its hi part and the *_lo argument
// its lo part, with the GEMM's plan (N tile, ring stages;
// tf32x3.py::gemm_plan); under AMP wproj, wfc1 and wfc2 bf16 (wqkv is read
// through w_map), the lo parts null and the plans 0. bias, mask and the
// attention plan (w_map ... blocks) as arpu_window_attention takes them.
// The ResiDual (rbasis null without it) as arpu_residual_ffn takes it, in
// both modes. The output is f32 in the golden route.
extern "C" int arpu_swin_block(const void* x, int x_bf16, void* out, int out_bf16, int R, int n,
                               int C, int nh, int nW, int hidden, const float* n1s,
                               const float* n1b, const void* wqkv, const float* wqkv_lo,
                               int qkv_bn, int qkv_stages, const float* bqkv, const void* wproj,
                               const float* wproj_lo, int proj_bn, int proj_stages,
                               const float* bproj, const float* n2s, const float* n2b,
                               const void* wfc1, const float* wfc1_lo, int fc1_bn, int fc1_stages,
                               const float* bfc1, const void* wfc2, const float* wfc2_lo,
                               int fc2_bn, int fc2_stages, const float* bfc2, const float* bias,
                               const float* mask, const void* w_map, int heads_per_block,
                               int windows_per_block, int stages, int smem, int blocks,
                               const float* rbasis, const float* rbasis_lo, int rb_bn,
                               int rb_stages, const float* rbasis_t, const float* rbasis_t_lo,
                               int rbt_bn, int rbt_stages, const float* rmean, const float* rlam,
                               int kr, int double_ffn, int bf16, void* ws, void* stream) {
  const arpu::AttentionPlan plan{w_map, heads_per_block, windows_per_block, stages, smem, blocks};
  const arpu::AttentionWeights att{
      static_cast<const arpu::bf16_t*>(wproj),
      {static_cast<const float*>(wqkv), wqkv_lo, qkv_bn, qkv_stages},
      {static_cast<const float*>(wproj), wproj_lo, proj_bn, proj_stages}};
  arpu::FfnWeights ffn{};
  if (bf16) {
    ffn.w1 = static_cast<const arpu::bf16_t*>(wfc1);
    ffn.w2 = static_cast<const arpu::bf16_t*>(wfc2);
  } else {
    ffn.x1 = {static_cast<const float*>(wfc1), wfc1_lo, fc1_bn, fc1_stages};
    ffn.x2 = {static_cast<const float*>(wfc2), wfc2_lo, fc2_bn, fc2_stages};
  }
  const arpu::ResidualWeights res{{rbasis, rbasis_lo, rb_bn, rb_stages},
                                  {rbasis_t, rbasis_t_lo, rbt_bn, rbt_stages}, rmean, rlam, kr};
  return static_cast<int>(swin_block(x, x_bf16, out, out_bf16, R, n, C, nh, nW, hidden, n1s, n1b,
                                     att, bqkv, bproj, n2s, n2b, ffn, bfc1, bfc2, bias, mask,
                                     plan, rbasis ? &res : nullptr, double_ffn, bf16, ws,
                                     static_cast<cudaStream_t>(stream)));
}
