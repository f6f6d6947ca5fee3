// Hopper port of the TPU kernel `_wide_attention`
// (audio_residual_tpu/ops/pallas/window_attention.py::_wide_kernel): the
// W-MSA of fused_window_attention for wide layers (C >= 1024: HTSAT-base
// layer 3, HTSAT-large layers 2-3) -- qkv projection, per-head
// q k^T * hd^-1/2 + relative position bias + SW-MSA mask, exact f32
// softmax, @V, output projection.
//
// The TPU kernel streams the weights through VMEM in column chunks because a
// wide layer's wqkv alone (12.6 MB at C = 1024) does not fit beside the
// activations. On Hopper no kernel holds a weight: each product streams its
// tiles from L2 by TMA, so a wide layer runs K2's two routes at its width:
//   AMP: window_attention_wgmma_kernel (window_attention_tc.cuh), qkv and
//     attention in one launch over window pairs, q|k|v kept on chip, then
//     the TMA + wgmma bf16 proj GEMM. The wrapper reaches it through K2's C
//     entry (window_attention.cu). Clusters of 2 sharing each weight box by
//     TMA multicast were measured slower at every shipped wide layer
//     (PERF.md): the L2 reads do not set the pace, and the pairing makes each
//     block wait for the slower one.
//   golden (f32), this entry: blocks.cuh::run_window_attention with bf16 = 0
//     -- the qkv GEMM in 3xTF32 on the tensor cores (gemm_sm90.cuh::
//     gemm_tf32x3), attention_core_kernel (one block per (window, head), f32
//     on the CUDA cores) on the f32 q|k|v [R, 3C], the proj GEMM in 3xTF32.
//     At HTSAT-base layer 3 and B=32 (2048 rows) q|k|v is 25 MB written and
//     read back, ~15 us at 3.35 TB/s, against 17.7 GFLOP of products, 0.11 ms
//     at 3 passes of the TF32 rate: operations.
#include "blocks.cuh"

// bytes of scratch: q|k|v [R, 3C] and the attention output [R, C], f32
extern "C" size_t arpu_wide_attention_workspace(int R, int C) {
  return arpu::window_attention_ws(R, C, 0);
}

// Golden route. x, out [R, C] f32, R = windows * n, n <= 64; hd = C / nh is
// 32 or 64. wqkv [3C, C] and wproj [C, C] split for 3xTF32 as
// arpu_window_attention takes them (hi, lo, each GEMM's plan). bias [nh, n,
// n]; mask [nW, n, n] or null. ws: arpu_wide_attention_workspace(R, C)
// bytes. Returns the first CUDA error of the launches.
extern "C" int arpu_wide_attention(const float* x, float* out, int R, int n, int C, int nh,
                                   int nW, const float* wqkv, const float* wqkv_lo, int qkv_bn,
                                   int qkv_stages, const float* bqkv, const float* wproj,
                                   const float* wproj_lo, int proj_bn, int proj_stages,
                                   const float* bproj, const float* bias, const float* mask,
                                   void* ws, void* stream) {
  using namespace arpu;
  const int hd = C / nh;
  if (n > 64 || C % nh || (hd != 32 && hd != 64)) return static_cast<int>(cudaErrorInvalidValue);
  const AttentionWeights w{nullptr, {wqkv, wqkv_lo, qkv_bn, qkv_stages},
                           {wproj, wproj_lo, proj_bn, proj_stages}};
  const AttentionPlan no_plan{};
  return static_cast<int>(run_window_attention(
      x, 0, out, 0, nullptr, 0, R, n, C, nh, nW, w, bqkv, bproj, bias, mask, 0, no_plan,
      Arena{static_cast<unsigned char*>(ws)}, static_cast<cudaStream_t>(stream)));
}
