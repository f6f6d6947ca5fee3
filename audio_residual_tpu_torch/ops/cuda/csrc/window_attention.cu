// Hopper port of the TPU kernel `fused_window_attention` (standard path,
// audio_residual_tpu/ops/pallas/window_attention.py::_kernel): Swin W-MSA on
// 64-token windows -- qkv projection, per-head q k^T * hd^-1/2 + relative
// position bias + SW-MSA mask, exact softmax, @V, output projection.
//
// What bounds it on the H100: operations, narrowly. At HTSAT-tiny layer 3
// and B=32 one launch is ~10 GFLOP of products (qkv, proj, scores, @V),
// 10 us at the bf16 tensor-core rate, against 22 MB of f32 weights and
// activations, 7 us of bytes; qkv and the attention output also go through
// device memory between its three launches.
//
// Design: the GEMMs are the shared f32 GEMM (golden) or the TMA + wgmma
// bf16 GEMM on bf16 weights (AMP, gemm_sm90.cuh); the attention core runs
// one block per (window, head) with q, k, v and the [64, 64] score tile
// resident in shared memory, so scores and probabilities never reach device
// memory. Under AMP qkv (q pre-scaled) and the attention output are stored
// in bf16 (blocks.cuh).
#include "blocks.cuh"

// bytes of scratch
extern "C" size_t arpu_window_attention_workspace(int R, int C, int bf16) {
  return arpu::window_attention_ws(R, C, bf16);
}

// x, out [R, C] with R = windows * n (x bf16 under AMP). bias [nh, n, n];
// mask [nW, n, n] or null; q_scale [3C] (AMP only).
extern "C" int arpu_window_attention(const void* x, int x_bf16, void* out, int out_bf16, int R,
                                     int n, int C, int nh, int nW, const void* wqkv,
                                     const float* bqkv, const void* wproj, const float* bproj,
                                     const float* bias, const float* mask, const float* q_scale,
                                     int bf16, void* ws, void* stream) {
  return static_cast<int>(arpu::run_window_attention(
      x, x_bf16, out, out_bf16, nullptr, 0, R, n, C, nh, nW, wqkv, bqkv, wproj, bproj, bias, mask,
      q_scale, bf16, arpu::Arena{static_cast<unsigned char*>(ws)},
      static_cast<cudaStream_t>(stream)));
}
