// Hopper port of the TPU kernel `fused_residual_ffn`
// (audio_residual_tpu/ops/pallas/ln_mlp.py::_kernel): on flattened rows,
// the optional ResiDual epilogue on the attention output a, h = x + a, then
// y = h + fc2(GELU(fc1(LN2(h)))), with the reference's double-FFN quirk as a
// second pass from x + y.
//
// What bounds it on the H100: bytes, as for K4 (blocks.cuh): at HTSAT-tiny
// layer 3 and B=32 (2048 rows, 768 -> 3072 -> 768) one launch is 19.3
// GFLOP of products, 20 us at the bf16 tensor-core rate, while the launch
// sequence writes and reads back the [R, 3072] hidden activation and the
// [R, C] intermediates.
//
// Design: the TPU kernel streams weight chunks through VMEM and keeps the
// row block resident; here each step is one launch over all rows, with the
// bias, GELU and residual adds fused into the GEMM epilogues and the LN
// fused with the first residual add, so the [R, C] stream is read and
// written once per step. Under AMP z and hid are stored in bf16 and the
// products run on the TMA + wgmma GEMM (gemm_sm90.cuh) with bf16 weights;
// h1, y2 and the ResiDual stay f32.
#include "blocks.cuh"

static size_t residual_ffn_ws(int R, int C, int hidden, int kr, int bf16) {
  return arpu::span((size_t)R * C * 4) + arpu::ffn_ws(R, C, hidden, bf16) +
         arpu::span((size_t)R * kr * 4);
}

// bytes of scratch
extern "C" size_t arpu_residual_ffn_workspace(int R, int C, int hidden, int kr, int bf16) {
  return residual_ffn_ws(R, C, hidden, kr, bf16);
}

static cudaError_t residual_ffn(const void* x, int x_bf16, const void* a, int a_bf16, void* out,
                                int out_bf16, int R, int C, int hidden, const float* n2s,
                                const float* n2b, const void* wfc1, const float* bfc1,
                                const void* wfc2, const float* bfc2, const float* rbasis,
                                const float* rbasis_t, const float* rmean, const float* rlam,
                                int kr, int double_ffn, int bf16, void* ws, cudaStream_t s) {
  arpu::Arena ar{static_cast<unsigned char*>(ws)};
  float* h1 = ar.take<float>((size_t)R * C);
  const arpu::FfnScratch ffn_scratch = arpu::take_ffn(ar, R, C, hidden, bf16);
  float* proj = ar.take<float>((size_t)R * kr);
  int z_ready = 0;
  if (rbasis) {
    ARPU_TRY(arpu::run_residual_epilogue(a, a_bf16, x, x_bf16, h1, R, C, kr, rbasis, rbasis_t,
                                         rmean, rlam, proj, s));
  } else {
    // h1 = x + a and z = LN2(h1) in one pass
    ARPU_TRY(arpu::launch_add_layernorm(x, x_bf16, a, a_bf16, h1, ffn_scratch.z, bf16, n2s, n2b,
                                        R, C, s));
    z_ready = 1;
  }
  return arpu::run_ffn(x, x_bf16, h1, out, out_bf16, R, C, hidden, n2s, n2b, wfc1, bfc1, wfc2,
                       bfc2, double_ffn, bf16, z_ready, ffn_scratch, s);
}

// x, a, out [R, C]. Weights f32 (bf16 = 0) or bf16 (AMP). rbasis [kr, C]
// and rbasis_t [C, kr] null without ResiDual.
extern "C" int arpu_residual_ffn(const void* x, int x_bf16, const void* a, int a_bf16, void* out,
                                 int out_bf16, int R, int C, int hidden, const float* n2s,
                                 const float* n2b, const void* wfc1, const float* bfc1,
                                 const void* wfc2, const float* bfc2, const float* rbasis,
                                 const float* rbasis_t, const float* rmean, const float* rlam,
                                 int kr, int double_ffn, int bf16, void* ws, void* stream) {
  return static_cast<int>(residual_ffn(x, x_bf16, a, a_bf16, out, out_bf16, R, C, hidden, n2s,
                                       n2b, wfc1, bfc1, wfc2, bfc2, rbasis, rbasis_t, rmean, rlam,
                                       kr, double_ffn, bf16, ws,
                                       static_cast<cudaStream_t>(stream)));
}
