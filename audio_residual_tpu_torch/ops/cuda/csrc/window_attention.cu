// Hopper port of the TPU kernel `fused_window_attention` (standard path,
// audio_residual_tpu/ops/pallas/window_attention.py::_kernel): Swin W-MSA on
// windows of at most 64 tokens -- qkv projection, per-head q k^T * hd^-1/2 +
// relative position bias + SW-MSA mask, exact softmax, @V, output
// projection. Two routes (blocks.cuh::run_window_attention):
//   AMP: window_attention_wgmma_kernel (window_attention_tc.cuh), qkv and
//        attention in one launch with q|k|v kept on chip, then the TMA +
//        wgmma proj GEMM (gemm_sm90.cuh) over the bf16 attention output.
//        K5's wrapper takes this entry for its AMP route too (C >= 1024).
//   golden (f32): the qkv GEMM in 3xTF32 on the tensor cores
//        (gemm_sm90.cuh::gemm_tf32x3), attention_core_kernel (one block per
//        (window, head), scores never in device memory, f32 on the CUDA
//        cores), the proj GEMM in 3xTF32. K5's golden entry
//        (wide_attention.cu) runs the same sequence.
//
// What bounds it on the H100: operations, narrowly. At HTSAT-tiny layer 3
// and B=32 one call is ~10 GFLOP of products (qkv, proj, scores, @V),
// 10 us at the bf16 tensor-core rate, against ~13 MB of bf16 weights and
// activations, 4 us at 3.35 TB/s.
#include "blocks.cuh"

// bytes of scratch
extern "C" size_t arpu_window_attention_workspace(int R, int C, int bf16) {
  return arpu::window_attention_ws(R, C, bf16);
}

// x, out [R, C] with R = windows * n. Golden (bf16 = 0): x and out f32;
// wqkv [3C, C] and wproj [C, C] split for 3xTF32, wqkv and wproj their hi
// parts, wqkv_lo and wproj_lo their lo parts (ops/cuda/tf32x3.py::
// split_tf32), each with its GEMM plan (N tile, ring stages:
// tf32x3.py::gemm_plan, checked against this build); bias [nh, n, n], mask
// [nW, n, n] or null; the attention plan's arguments are not read. AMP
// (bf16 = 1): x bf16, wproj bf16, the lo parts null and the GEMM plans 0,
// bias [nh, 64, 64] and mask [nW, 64, 64] (or null) padded, w_map from
// arpu_weight_map (gemm.cu) and the wrapper's launch plan, which must be
// this build's (wqkv is not read: its map holds it).
extern "C" int arpu_window_attention(const void* x, int x_bf16, void* out, int out_bf16, int R,
                                     int n, int C, int nh, int nW, const void* wqkv,
                                     const float* wqkv_lo, int qkv_bn, int qkv_stages,
                                     const float* bqkv, const void* wproj, const float* wproj_lo,
                                     int proj_bn, int proj_stages, const float* bproj,
                                     const float* bias, const float* mask, int bf16,
                                     const void* w_map, int heads_per_block,
                                     int windows_per_block, int stages, int smem, int blocks,
                                     void* ws, void* stream) {
  const arpu::AttentionPlan plan{w_map, heads_per_block, windows_per_block, stages, smem, blocks};
  const arpu::AttentionWeights w{
      static_cast<const arpu::bf16_t*>(wproj),
      {static_cast<const float*>(wqkv), wqkv_lo, qkv_bn, qkv_stages},
      {static_cast<const float*>(wproj), wproj_lo, proj_bn, proj_stages}};
  return static_cast<int>(arpu::run_window_attention(
      x, x_bf16, out, out_bf16, nullptr, 0, R, n, C, nh, nW, w, bqkv, bproj, bias, mask, bf16,
      plan, arpu::Arena{static_cast<unsigned char*>(ws)}, static_cast<cudaStream_t>(stream)));
}
