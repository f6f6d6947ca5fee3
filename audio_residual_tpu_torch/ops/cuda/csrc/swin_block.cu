// Hopper port of the TPU kernel `fused_swin_block`
// (audio_residual_tpu/ops/pallas/swin_block.py::_kernel): one whole Swin
// block in window space -- LN1, W-MSA, output projection, the optional
// ResiDual epilogue ((a - mean) B^T * lam) B in f32, + x, LN2, fc1, exact
// GELU, fc2, + h, and the double-FFN quirk when ResiDual is on.
//
// What bounds it on the H100: operations. At HTSAT-tiny layers 0-2 and
// B=32 one launch is 30-56 GFLOP (layer 0 with ResiDual and the double FFN
// is the most) against 25-100 MB of activations in and out: operations
// dominate at both the f32 rate and the bf16 tensor-core rate.
//
// Design: the TPU kernel keeps the block in VMEM; a 64-token window's f32
// qkv at C=384 alone (288 KB) exceeds Hopper's 227 KB of shared memory, so
// this is LN1 -> window attention -> residual FFN in window space, the same
// plan the JAX package declares equivalent (swin_block.py::_split_block),
// with a kept in f32 between the halves as in the monolithic kernel. With no
// ResiDual the first residual add rides the proj GEMM's epilogue.
#include "blocks.cuh"

extern "C" size_t arpu_swin_block_workspace(int R, int C, int hidden, int kr) {
  return (size_t)R * C * 3 + arpu::window_attention_ws(R, C) + arpu::ffn_ws(R, C, hidden) +
         (size_t)R * kr;
}

// x, out [R, C] windows (already rolled and partitioned), R = windows * n.
// Weights in nn.Linear layout [out, in]; rbasis / rbasis_t null without ResiDual.
extern "C" int arpu_swin_block(const void* x, int x_bf16, void* out, int out_bf16, int R, int n,
                               int C, int nh, int nW, int hidden, const float* n1s,
                               const float* n1b, const float* wqkv, const float* bqkv,
                               const float* wproj, const float* bproj, const float* n2s,
                               const float* n2b, const float* wfc1, const float* bfc1,
                               const float* wfc2, const float* bfc2, const float* bias,
                               const float* mask, const float* rbasis, const float* rbasis_t,
                               const float* rmean, const float* rlam, int kr, int double_ffn,
                               int bf16, float* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rc = (size_t)R * C;
  float* y = ws;
  float* a = y + rc;
  float* h1 = a + rc;
  float* attn_scratch = h1 + rc;
  float* ffn_scratch = attn_scratch + arpu::window_attention_ws(R, C);
  float* proj = ffn_scratch + arpu::ffn_ws(R, C, hidden);

  arpu::launch_add_layernorm(x, x_bf16, nullptr, 0, nullptr, y, 0, n1s, n1b, R, C, s);
  if (rbasis) {
    arpu::run_window_attention(y, 0, a, 0, nullptr, 0, R, n, C, nh, nW, wqkv, bqkv, wproj, bproj,
                               bias, mask, bf16, attn_scratch, s);
    arpu::run_residual_epilogue(a, 0, x, x_bf16, h1, R, C, kr, rbasis, rbasis_t, rmean, rlam,
                                proj, s);
  } else {
    // h1 = x + proj(attention): the residual add rides the proj epilogue
    arpu::run_window_attention(y, 0, h1, 0, x, x_bf16, R, n, C, nh, nW, wqkv, bqkv, wproj, bproj,
                               bias, mask, bf16, attn_scratch, s);
  }
  arpu::run_ffn(x, x_bf16, h1, out, out_bf16, R, C, hidden, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
                double_ffn, bf16, 0, ffn_scratch, s);
  return static_cast<int>(cudaGetLastError());
}
