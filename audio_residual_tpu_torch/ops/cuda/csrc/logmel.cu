// Hopper port of the TPU kernel `fused_logmel`
// (audio_residual_tpu/ops/pallas/frontend.py::_rows_kernel): framing,
// hann-windowed DFT against cos|sin restricted to the mel-active bins,
// power, mel projection and 10 log10(max(mel, amin)) - db_offset, without
// writing frames or the power spectrogram to device memory.
//
// What bounds it on the H100: operations. HTSAT-tiny at B=32 reads 61 MB of
// waveform (18 us at 3.35 TB/s) but does 39 GFLOP of DFT products (0.58 ms
// at the 67 TFLOP/s f32 rate), so the DFT GEMM is the cost.
//
// Design: one block per (64-frame tile, clip). Frames are read straight
// from the reflect-padded signal (frame f, sample k at f*hop + k), so the
// 2.1x-larger frames tensor never exists. The bins are walked in chunks of
// 32: a [64 frames x 64 cols] DFT tile (32 cos | 32 sin columns) is
// accumulated over n_fft through shared memory, squared into a power chunk
// in shared memory, and folded at once into the [64 frames x 64 mels] mel
// accumulator held in registers, so the power spectrogram never leaves the
// SM. In bf16 mode the frames and the basis are rounded to bf16 as they are
// staged (f32 accumulate), and the mel product stays f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int LF = 64;  // frames a block
constexpr int LB = 32;  // bins a chunk (64 DFT columns)
constexpr int LK = 16;  // samples a K step
constexpr int LM = 64;  // most mel bands

__device__ __forceinline__ float maybe_round(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__global__ void __launch_bounds__(256) logmel_kernel(const float* xp, float* out, int t_pad,
                                                     int nf, int n_fft, int hop,
                                                     const float* basis, int nbins,
                                                     const float* melw, int n_mels, float amin,
                                                     float db_offset, int bf16) {
  __shared__ float Fs[LK][LF + 4];      // frame samples, k-major
  __shared__ float Bs[LK][2 * LB + 4];  // basis: cols [0, 32) cos, [32, 64) sin
  __shared__ float Ps[LF][LB + 1];      // power chunk
  __shared__ float Ms[LB][LM + 4];      // mel weights chunk
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, f0 = blockIdx.x * LF;
  const float* x = xp + (size_t)b * t_pad;

  float mel[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mel[i][j] = 0.0f;

  for (int j0 = 0; j0 < nbins; j0 += LB) {
    float d[4][4];  // frames ty + 16i; cols tx + 16j (j 0,1 cos; 2,3 sin)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[i][j] = 0.0f;

    for (int k0 = 0; k0 < n_fft; k0 += LK) {
      for (int e = tid; e < LF * LK; e += 256) {
        const int fr = e / LK, kk = e % LK, f = f0 + fr, k = k0 + kk;
        const float v = (f < nf && k < n_fft) ? x[(size_t)f * hop + k] : 0.0f;
        Fs[kk][fr] = maybe_round(v, bf16);
      }
      for (int e = tid; e < LK * 2 * LB; e += 256) {
        const int kk = e / (2 * LB), c = e % (2 * LB), k = k0 + kk;
        const int bin = j0 + (c % LB);
        const int col = c < LB ? bin : nbins + bin;
        const float v = (bin < nbins && k < n_fft) ? basis[(size_t)k * 2 * nbins + col] : 0.0f;
        Bs[kk][c] = maybe_round(v, bf16);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < LK; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Fs[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] = fmaf(a[i], w[j], d[i][j]);
      }
      __syncthreads();
    }

    // power: re of bin tx+16j' sits in col j', im in col j'+2
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      Ps[ty + 16 * i][tx] = d[i][0] * d[i][0] + d[i][2] * d[i][2];
      Ps[ty + 16 * i][tx + 16] = d[i][1] * d[i][1] + d[i][3] * d[i][3];
    }
    for (int e = tid; e < LB * LM; e += 256) {
      const int r = e / LM, c = e % LM, bin = j0 + r;
      Ms[r][c] = (bin < nbins && c < n_mels) ? melw[(size_t)bin * n_mels + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < LB; ++r) {
      float p[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[ty + 16 * i][r];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ms[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mel[i][j] = fmaf(p[i], w[j], mel[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = f0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = tx + 16 * j;
      if (f < nf && m < n_mels) {
        out[((size_t)b * nf + f) * n_mels + m] = 10.0f * log10f(fmaxf(mel[i][j], amin)) - db_offset;
      }
    }
  }
}

}  // namespace

extern "C" const char* arpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xp [B, t_pad] reflect-padded f32 -> out [B, nf, n_mels] f32.
// basis [n_fft, 2*nbins] (cos | sin of the active bins); melw [nbins, n_mels].
extern "C" int arpu_fused_logmel(const float* xp, float* out, int B, int t_pad, int nf, int n_fft,
                                 int hop, const float* basis, int nbins, const float* melw,
                                 int n_mels, float amin, float db_offset, int bf16, void* stream) {
  if (n_mels > LM) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((nf + LF - 1) / LF, B);
  logmel_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      xp, out, t_pad, nf, n_fft, hop, basis, nbins, melw, n_mels, amin, db_offset, bf16);
  return static_cast<int>(cudaGetLastError());
}
