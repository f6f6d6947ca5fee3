// Hopper port of the TPU kernel `fused_residual_ffn`
// (audio_residual_tpu/ops/pallas/ln_mlp.py::_kernel): on flattened rows,
// the optional ResiDual epilogue on the attention output a, h = x + a, then
// y = h + fc2(GELU(fc1(LN2(h)))), with the reference's double-FFN quirk as a
// second pass from x + y.
//
// What bounds it on the H100: operations. At HTSAT-tiny layer 3 and B=32
// (2048 rows, 768 -> 3072 -> 768) one launch is 19.3 GFLOP of products
// against 38 MB of traffic (18.9 MB of f32 fc1/fc2 weights, x, a and the
// output): 0.29 ms at the f32 rate, 20 us at the bf16 tensor-core rate,
// 11 us of bytes. The [R, 3072] hidden activation goes through device
// memory in this first version.
//
// Design: the TPU kernel streams weight chunks through VMEM and keeps the
// row block resident; here each step is one launch over all rows, with the
// bias, GELU and residual adds fused into the GEMM epilogues and the LN
// fused with the first residual add, so the [R, C] stream is read and
// written once per step.
#include "blocks.cuh"

extern "C" size_t arpu_residual_ffn_workspace(int R, int C, int hidden, int kr) {
  return (size_t)R * C + arpu::ffn_ws(R, C, hidden) + (size_t)R * kr;
}

// x, a, out [R, C]. rbasis [kr, C] and rbasis_t [C, kr] null without ResiDual.
extern "C" int arpu_residual_ffn(const void* x, int x_bf16, const void* a, int a_bf16, void* out,
                                 int out_bf16, int R, int C, int hidden, const float* n2s,
                                 const float* n2b, const float* wfc1, const float* bfc1,
                                 const float* wfc2, const float* bfc2, const float* rbasis,
                                 const float* rbasis_t, const float* rmean, const float* rlam,
                                 int kr, int double_ffn, int bf16, float* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h1 = ws;
  float* ffn_scratch = h1 + (size_t)R * C;
  float* proj = ffn_scratch + arpu::ffn_ws(R, C, hidden);
  int z_ready = 0;
  if (rbasis) {
    arpu::run_residual_epilogue(a, a_bf16, x, x_bf16, h1, R, C, kr, rbasis, rbasis_t, rmean, rlam,
                                proj, s);
  } else {
    // h1 = x + a and z = LN2(h1) in one pass
    arpu::launch_add_layernorm(x, x_bf16, a, a_bf16, h1, ffn_scratch, 0, n2s, n2b, R, C, s);
    z_ready = 1;
  }
  arpu::run_ffn(x, x_bf16, h1, out, out_bf16, R, C, hidden, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
                double_ffn, bf16, z_ready, ffn_scratch, s);
  return static_cast<int>(cudaGetLastError());
}
