// Launch sequences of the Swin-block kernels, built from common.cuh and
// window_attention_tc.cuh.
//
// The TPU kernels keep a whole block (or half of one) resident in VMEM. On
// Hopper a 64-token window's f32 qkv at C=384 alone is 288 KB, above the
// 227 KB of shared memory a block may use, so each TPU kernel becomes a
// fixed sequence of launches with intermediates in device memory:
//   window attention = qkv + attention -> proj GEMM (AMP);
//                      qkv GEMM -> attention core -> proj GEMM (golden)
//   residual FFN     = [ResiDual GEMMs] -> add+LN2 -> fc1+GELU -> fc2 + h1
//                      [-> double-FFN second pass]
//
// What bounds such a sequence on the H100 is the bytes of its intermediates,
// not its operations: at HTSAT-tiny layer 0 (R = 131072 rows, C = 96) a
// block writes and reads back hid [R, 4C] and several [R, C] tensors, for
// ~72 operations a byte of its GEMMs against the bf16 ridge of ~295. So
// under AMP (bf16 = 1) every intermediate whose only reader is a GEMM is
// stored in bf16 -- y = LN1(x), the attention output, z = LN2(h) and hid --
// the rounding its reader applied anyway, so the function is unchanged; q|k|v
// never leave the qkv + attention kernel (window_attention_tc.cuh), and the
// other products run on the TMA + wgmma GEMM (gemm_sm90.cuh) with bf16
// weights cast once per weight version. What stays f32 (the AMP contract):
// the proj output a that the ResiDual reads, h1, y2, the ResiDual scratch,
// LN statistics and softmax. The ResiDual GEMMs are f32 in both modes and
// run in 3xTF32 on the tensor cores (gemm_tf32x3, f32 accuracy). The golden
// path (bf16 = 0) keeps f32 everywhere: every product (qkv, proj, fc1, fc2,
// the ResiDual's) runs on gemm_tf32x3, with the f32 attention core between
// qkv and proj. Fusing a block into one kernel is later work (ROADMAP, Queue
// 2). Wide layers (C >= 1024) come here for their attention through K5's
// entry (wide_attention.cu), golden, or K2's, AMP.
//
// Weights come as AttentionWeights, ResidualWeights and FfnWeights: bf16
// copies under AMP, in the golden mode (and the ResiDual's always) split for
// 3xTF32 with each product's plan.
#pragma once

#include "common.cuh"
#include "window_attention_tc.cuh"

namespace arpu {

using bf16_t = __nv_bfloat16;

// Scratch is carved from one byte buffer, every piece 256-byte aligned.
static inline size_t span(size_t bytes) { return (bytes + 255) & ~(size_t)255; }

struct Arena {
  unsigned char* p;
  template <typename T>
  T* take(size_t count) {
    T* r = reinterpret_cast<T*>(p);
    p += span(count * sizeof(T));
    return r;
  }
};

static inline size_t elem_bytes(int bf16) { return bf16 ? 2 : 4; }

// bytes of run_window_attention scratch: golden qkv [R, 3C] and att [R, C]
// f32; AMP att [R, C] bf16
static inline size_t window_attention_ws(long R, long C, int bf16) {
  if (bf16) return span((size_t)R * C * 2);
  return span((size_t)R * 3 * C * 4) + span((size_t)R * C * 4);
}

// The window attention's weight matrices as the route takes them: under
// AMP the bf16 wproj (wqkv is read through the plan's TMA map); in the
// golden mode wqkv [3C, C] and wproj [C, C] split for 3xTF32, with each
// product's plan.
struct AttentionWeights {
  const bf16_t* wproj;  // AMP
  Tf32x3Weight qkv;     // golden
  Tf32x3Weight proj;
};

// y [R, C] -> out [R, C] = proj(attention(qkv(y))) (+ r1 in the proj
// epilogue when r1 is given). Golden: y and out f32 (r1 f32 or bf16), qkv
// and proj on the 3xTF32 GEMM around the f32 attention core; bias [nh, n,
// n], mask [nW, n, n]. AMP: y must be bf16; bias [nh, 64, 64] and mask [nW,
// 64, 64] padded, and `plan` the wrapper's launch plan of the qkv +
// attention kernel, whose TMA map holds wqkv.
static inline cudaError_t run_window_attention(const void* y, int y_bf16, void* out, int out_bf16,
                                               const void* r1, int r1_bf16, int R, int n, int C,
                                               int nh, int nW, const AttentionWeights& w,
                                               const float* bqkv, const float* bproj,
                                               const float* bias, const float* mask, int bf16,
                                               const AttentionPlan& plan, Arena ws,
                                               cudaStream_t s) {
  if (!bf16) {
    if (y_bf16 || out_bf16) return cudaErrorInvalidValue;
    float* qkv = ws.take<float>((size_t)R * 3 * C);
    float* att = ws.take<float>((size_t)R * C);
    ARPU_TRY(gemm_tf32x3(static_cast<const float*>(y), w.qkv, qkv, R, 3 * C, C,
                         Epilogue{bqkv, nullptr, 0, nullptr, nullptr}, 0, s));
    ARPU_TRY(launch_attention_core(qkv, att, bias, mask, R / n, n, nh, C, nW, s));
    // the residual in the r2 slot, which takes f32 or bf16
    return gemm_tf32x3(att, w.proj, static_cast<float*>(out), R, C, C,
                       Epilogue{bproj, nullptr, 0, nullptr, r1}, r1_bf16, s);
  }
  if (!y_bf16) return cudaErrorInvalidValue;
  bf16_t* att = ws.take<bf16_t>((size_t)R * C);
  ARPU_TRY(launch_window_attention_tc(y, bqkv, bias, mask, att, R / n, n, C, nh, nW, plan, s));
  return gemm_bf16(att, w.wproj, out, out_bf16, R, C, C, Epilogue{bproj, nullptr, 0, r1, nullptr},
                   r1_bf16, 0, s);
}

// A ResiDual as its two products take it: basis [kr, C] and basis_t [C, kr]
// split for 3xTF32 with each product's plan, mean [C] and lam [kr]. The
// wrapper pads kr to a multiple of 8 with zero rows of basis, zero columns
// of basis_t and zeros of lam, which leaves both products' values as they
// were (ops/cuda/tf32x3.py::residual_weights).
struct ResidualWeights {
  Tf32x3Weight basis;
  Tf32x3Weight basis_t;
  const float* mean;
  const float* lam;
  int kr;
};

// ResiDual epilogue and the first residual add, f32 in both modes (the
// method's precision-sensitive core), on the 3xTF32 GEMM:
// h1 = x + ((a - mean) @ basis^T * lam) @ basis. a [R, C] f32, x f32 or bf16;
// proj scratch [R, kr]. The centring is the first GEMM's prologue, before
// the split, so the products round |a - mean|.
static inline cudaError_t run_residual_epilogue(const float* a, const void* x, int x_bf16,
                                                float* h1, int R, int C,
                                                const ResidualWeights& r, float* proj,
                                                cudaStream_t s) {
  ARPU_TRY(gemm_tf32x3(a, r.basis, proj, R, r.kr, C, Epilogue{nullptr, r.lam, 0, nullptr, nullptr},
                       0, s, r.mean));
  return gemm_tf32x3(proj, r.basis_t, h1, R, C, r.kr,
                     Epilogue{nullptr, nullptr, 0, nullptr, x}, x_bf16, s);
}

// run_ffn scratch: z [R, C] and hid [R, hidden] (bf16 under AMP), y2 [R, C] f32
struct FfnScratch {
  void* z;
  void* hid;
  float* y2;
};

static inline size_t ffn_ws(long R, long C, long hidden, int bf16) {
  return span((size_t)R * C * elem_bytes(bf16)) + span((size_t)R * hidden * elem_bytes(bf16)) +
         span((size_t)R * C * 4);
}

static inline FfnScratch take_ffn(Arena& ws, long R, long C, long hidden, int bf16) {
  FfnScratch f;
  f.z = ws.take<unsigned char>((size_t)R * C * elem_bytes(bf16));
  f.hid = ws.take<unsigned char>((size_t)R * hidden * elem_bytes(bf16));
  f.y2 = ws.take<float>((size_t)R * C);
  return f;
}

// The FFN's weight matrices as the route takes them: bf16 copies under AMP;
// in the golden mode split for 3xTF32, with each product's plan.
struct FfnWeights {
  const bf16_t* w1;  // AMP: fc1 [hidden, C], fc2 [C, hidden]
  const bf16_t* w2;
  Tf32x3Weight x1;   // golden
  Tf32x3Weight x2;
};

// h1 [R, C] f32 -> out = h1 + fc2(GELU(fc1(LN2(h1)))). With double_ffn
// (the reference's patched-forward quirk): y2 = x + that, out = y2 + FFN(y2).
// z_ready: LN2(h1) is already in f.z. The golden products run in 3xTF32
// (gemm_tf32x3) and write f32, so a golden out must be f32.
static inline cudaError_t run_ffn(const void* x, int x_bf16, const float* h1, void* out,
                                  int out_bf16, int R, int C, int hidden, const float* n2s,
                                  const float* n2b, const FfnWeights& w, const float* bfc1,
                                  const float* bfc2, int double_ffn, int bf16, int z_ready,
                                  const FfnScratch& f, cudaStream_t s) {
  // hid = GELU(z @ wfc1^T + bfc1)
  auto fc1 = [&]() -> cudaError_t {
    const Epilogue e{bfc1, nullptr, 1, nullptr, nullptr};
    if (!bf16) {
      return gemm_tf32x3(static_cast<const float*>(f.z), w.x1, static_cast<float*>(f.hid), R,
                         hidden, C, e, 0, s);
    }
    return gemm_bf16(static_cast<const bf16_t*>(f.z), w.w1, f.hid, 1, R, hidden, C, e, 0, 0, s);
  };
  // dst = ((hid @ wfc2^T + bfc2) + res) [+ x2]
  auto fc2 = [&](void* dst, int dst_bf16, const float* res, const void* x2) -> cudaError_t {
    const Epilogue e{bfc2, nullptr, 0, res, x2};
    if (!bf16) {
      if (dst_bf16) return cudaErrorInvalidValue;
      return gemm_tf32x3(static_cast<const float*>(f.hid), w.x2, static_cast<float*>(dst), R, C,
                         hidden, e, x_bf16, s);
    }
    return gemm_bf16(static_cast<const bf16_t*>(f.hid), w.w2, dst, dst_bf16, R, C, hidden, e, 0,
                     x_bf16, s);
  };
  if (!z_ready) {
    ARPU_TRY(launch_add_layernorm(h1, 0, nullptr, 0, nullptr, f.z, bf16, n2s, n2b, R, C, s));
  }
  ARPU_TRY(fc1());
  if (!double_ffn) return fc2(out, out_bf16, h1, nullptr);
  ARPU_TRY(fc2(f.y2, 0, h1, x));  // y2 = ((fc2 + b) + h1) + x
  ARPU_TRY(launch_add_layernorm(f.y2, 0, nullptr, 0, nullptr, f.z, bf16, n2s, n2b, R, C, s));
  ARPU_TRY(fc1());
  return fc2(out, out_bf16, f.y2, nullptr);
}

}  // namespace arpu
