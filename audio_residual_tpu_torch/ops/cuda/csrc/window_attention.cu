// Hopper port of the TPU kernel `fused_window_attention` (standard path,
// audio_residual_tpu/ops/pallas/window_attention.py::_kernel): Swin W-MSA on
// 64-token windows -- qkv projection, per-head q k^T * hd^-1/2 + relative
// position bias + SW-MSA mask, exact softmax, @V, output projection.
//
// What bounds it on the H100: operations. At HTSAT-tiny layer 3 and B=32
// one launch is ~10 GFLOP of products (qkv, proj, scores, @V) against 22 MB
// of traffic (the 9.4 MB of f32 qkv/proj weights and the activations):
// 0.15 ms at the f32 rate, 10 us at the bf16 tensor-core rate, 7 us of
// bytes. This first version also writes qkv and the attention output to
// device memory between its three launches.
//
// Design: GEMMs are tiled through shared memory (f32 FMA, or bf16 wmma with
// f32 accumulate); the attention core runs one block per (window, head)
// with q, k, v and the [64, 64] score tile resident in shared memory, so
// scores and probabilities never reach device memory.
#include "blocks.cuh"

extern "C" size_t arpu_window_attention_workspace(int R, int C) {
  return arpu::window_attention_ws(R, C);
}

// x, out [R, C] with R = windows * n. bias [nh, n, n]; mask [nW, n, n] or null.
extern "C" int arpu_window_attention(const void* x, int x_bf16, void* out, int out_bf16, int R,
                                     int n, int C, int nh, int nW, const float* wqkv,
                                     const float* bqkv, const float* wproj, const float* bproj,
                                     const float* bias, const float* mask, int bf16, float* ws,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  arpu::run_window_attention(x, x_bf16, out, out_bf16, nullptr, 0, R, n, C, nh, nW, wqkv, bqkv,
                             wproj, bproj, bias, mask, bf16, ws, s);
  return static_cast<int>(cudaGetLastError());
}
