// Hopper port of the TPU kernel `fused_logmel`
// (audio_residual_tpu/ops/pallas/frontend.py::_rows_kernel): framing,
// hann-windowed DFT against cos|sin restricted to the mel-active bins,
// power, mel projection and 10 log10(max(mel, amin)) - db_offset, without
// writing frames or the power spectrogram to device memory.
//
// One design, two operand modes (one kernel each): the DFT on wgmma from a
// TMA ring, the power and the f32 mel fold on chip.
//   * logmel_wgmma_kernel, the AMP route (dft_mode "bf16"): frames and basis
//     in bf16, wgmma m64n128k16, f32 accumulate.
//   * logmel_tf32x3_kernel, the golden route (dft_mode "f32"): frames and
//     basis f32, each product in 3xTF32 (gemm_sm90.cuh::tf32x3_k_loop, the
//     product of the golden FFN GEMM): the basis arrives split into hi +
//     lo (ops/cuda/frontend.py::tf32x3_constants, once per config and
//     device), the frames are split as the consumers read them; about f32
//     accuracy, as the TPU's Precision.HIGHEST DFT (frontend.py:35-36).
// What bounds it on the H100: operations. HTSAT-tiny at B=32 is a
// [32032, 1024] x [1024, 594] DFT product, 39 GFLOP: 0.04 ms at the
// 989 TFLOP/s bf16 rate, 0.24 ms as three passes at the 495 TFLOP/s TF32
// rate (0.58 ms at the 67 TFLOP/s of f32 on the CUDA cores), against 31 MB
// of bf16 (61 MB of f32) signal.
// Design, after gemm_sm90.cuh: one block an SM (persistent grid, measured
// no slower than one block per tile) walks the (128-frame tile, clip) pairs;
// a producer warpgroup keeps TMA loads in flight through a ring of stages;
// two consumer warpgroups, 64 frames each, run the shared K loop
// (gemm_sm90.cuh::consume_k_loop) of a 128-column tile. Every block reads
// the whole basis and each frame tile once per N tile: about 670 MB from L2
// a launch at HTSAT-tiny's B=32 in bf16, 2.5x that in 3xTF32 (f32 frames, a
// two-part basis), so L2 bandwidth rather than the tensor cores sets its
// pace (PERF.md). The blocks resident at one time walk the N tiles in step,
// so they read the same basis tile from L2.
//   * The A operand is the frames, never materialised: frame f starts at
//     sample f*hop of the padded signal, so the [128 frames, KB samples]
//     tile of K step kt (KB = 64 bf16 or 32 f32, one 128-byte row) is a 3-D
//     TMA box of a map {KB samples, nf frames, B clips} with strides {hop,
//     row} whose base is the signal + KB kt (one map a K step, each of them
//     a plain strided view; 48 maps at n_fft = 1536 in f32, 6 KB of kernel
//     parameters, which CUDA >= 12.1 takes). Frames >= nf arrive
//     zero-filled.
//   * The B operand is the basis [n_pad, n_fft], K-major, cos and sin of
//     each active bin interleaved (column 2j cos, 2j+1 sin) and zero beyond
//     2 nbins. In the wgmma f32 fragment a thread holds columns
//     8j + 2(l%4) + {0, 1}: re and im of one bin in one register pair, so
//     re^2 + im^2 needs no shuffle.
//   * The block walks the N tiles (64 bins each): the whole of n_fft is
//     accumulated, the power chunk is staged in shared memory [bins, frames]
//     and folded into a [64 frames, 64 mels] f32 accumulator held in
//     registers (4 frames x 8 mels a thread) on the CUDA cores. Only the
//     log-mel reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <initializer_list>

#include "gemm_sm90.cuh"

namespace {

using namespace arpu::sm90;  // BM = 128 frames, ROW_BYTES, 384 threads, the ring

constexpr int BN = 128;        // DFT columns a tile: 64 bins, cos|sin interleaved
constexpr int BINS = BN / 2;
constexpr int MELS = 64;       // width of the mel accumulator and of the padded melw
constexpr int MAX_FFT = 1536;
constexpr int LDP = BINS + 8;  // power staging [bins, frames]: rows 8 floats apart in banks
constexpr int POWER_FLOATS = 64 * LDP;       // per consumer warpgroup
constexpr int MELW_FLOATS = BINS * MELS;     // per consumer warpgroup
constexpr int STAGING_BYTES = 2 * (POWER_FLOATS + MELW_FLOATS) * 4;

// X3: 3xTF32 on f32 frames and a split basis; else bf16
template <bool X3>
struct Dft {
  static constexpr int KB = X3 ? BK_TF32 : BK;  // samples a K step: one 128-byte row
  static constexpr int MAX_KT = MAX_FFT / KB;
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int W_BYTES = (X3 ? 2 : 1) * BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  static constexpr int FREE = SMEM_LIMIT - 1024 - STAGING_BYTES - 256;
  static constexpr int STAGES = FREE / STAGE_BYTES > 6 ? 6 : FREE / STAGE_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + STAGING_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

// one map a K step: {KB samples, nf frames, B clips} from sample KB kt
template <bool X3>
struct FrameMaps {
  CUtensorMap kt[Dft<X3>::MAX_KT];
};

template <bool X3>
__device__ __forceinline__ void logmel_body(const FrameMaps<X3>& frames, const CUtensorMap& basis,
                                            const CUtensorMap* basis_lo,
                                            const float* __restrict__ melw,
                                            float* __restrict__ out, int nf, int m_tiles,
                                            int tiles, int k_tiles, int n_tiles, int n_mels,
                                            float amin, float db_offset) {
  using D = Dft<X3>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = smem;
  unsigned char* w_ring = smem + D::STAGES * D::A_BYTES;
  float* power = reinterpret_cast<float*>(w_ring + D::STAGES * D::W_BYTES);
  float* melw_s = power + 2 * POWER_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(melw_s + 2 * MELW_FLOATS);
  uint64_t* empty = full + D::STAGES;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < D::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: frames and basis tiles of every (N tile, K step)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int f0 = (tile % m_tiles) * BM, clip = tile / m_tiles;
      for (int n = 0; n < n_tiles; ++n) {
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], D::STAGE_BYTES);
          unsigned char* w = w_ring + stage * D::W_BYTES;
          tma_load_3d(a_ring + stage * D::A_BYTES, &frames.kt[kt], &full[stage], 0, f0, clip);
          tma_load(w, &basis, &full[stage], kt * D::KB, n * BN);
          if constexpr (X3) {
            tma_load(w + BN * ROW_BYTES, basis_lo, &full[stage], kt * D::KB, n * BN);
          }
          if (++stage == D::STAGES) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes frames f0 + 64 (wg - 1) ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int t = threadIdx.x % 128, lane = t % 32, warp = t / 32;
  const int rg = t / 8, mg = t % 8;  // fold: frames 4 rg + i; mels 4 mg + c, 32 + 4 mg + c
  float acc[BN / 2];
  float mel[4][8];
  const int a_off = (wg - 1) * 64 * ROW_BYTES;
  float* pw = power + (wg - 1) * POWER_FLOATS;
  float* mw = melw_s + (wg - 1) * MELW_FLOATS;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int f0 = (tile % m_tiles) * BM, clip = tile / m_tiles;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) mel[i][c] = 0.0f;
    for (int n = 0; n < n_tiles; ++n) {
      consume_k_loop<X3, BN, D::STAGES, D::W_BYTES>(acc, a_ring, w_ring, a_off, full, empty,
                                                    k_tiles, stage, phase);

      // power of the tile's 64 bins: bin 4j + l%4 of frame r (+8) is the
      // register pair acc[4j + 2h], acc[4j + 2h + 1] (re, im)
      const int r = 16 * warp + lane / 4, q = lane % 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float re = acc[4 * j + 2 * h], im = acc[4 * j + 2 * h + 1];
          pw[(4 * j + q) * LDP + r + 8 * h] = re * re + im * im;
        }
      const float4* src = reinterpret_cast<const float4*>(melw + (size_t)n * MELW_FLOATS);
      for (int i = t; i < MELW_FLOATS / 4; i += 128) reinterpret_cast<float4*>(mw)[i] = src[i];
      warpgroup_sync(wg);
#pragma unroll 4
      for (int bin = 0; bin < BINS; ++bin) {
        const float4 p = *reinterpret_cast<const float4*>(pw + bin * LDP + 4 * rg);
        const float4 w0 = *reinterpret_cast<const float4*>(mw + bin * MELS + 4 * mg);
        const float4 w1 = *reinterpret_cast<const float4*>(mw + bin * MELS + 32 + 4 * mg);
        const float pv[4] = {p.x, p.y, p.z, p.w};
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) mel[i][c] = fmaf(pv[i], wv[c], mel[i][c]);
      }
      warpgroup_sync(wg);  // the staging buffers are free for the next tile
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = f0 + 64 * (wg - 1) + 4 * rg + i;
      if (f >= nf) continue;
      float v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) v[c] = 10.0f * log10f(fmaxf(mel[i][c], amin)) - db_offset;
      float* o = out + ((size_t)clip * nf + f) * n_mels;
      if (n_mels == MELS) {
        *reinterpret_cast<float4*>(o + 4 * mg) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(o + 32 + 4 * mg) = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int m = (c < 4 ? 0 : 28) + 4 * mg + c;
          if (m < n_mels) o[m] = v[c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    logmel_wgmma_kernel(const __grid_constant__ FrameMaps<false> frames,
                        const __grid_constant__ CUtensorMap basis, const float* __restrict__ melw,
                        float* __restrict__ out, int nf, int m_tiles, int tiles, int k_tiles,
                        int n_tiles, int n_mels, float amin, float db_offset) {
  logmel_body<false>(frames, basis, nullptr, melw, out, nf, m_tiles, tiles, k_tiles, n_tiles,
                     n_mels, amin, db_offset);
}

__global__ void __launch_bounds__(THREADS, 1)
    logmel_tf32x3_kernel(const __grid_constant__ FrameMaps<true> frames,
                         const __grid_constant__ CUtensorMap basis_hi,
                         const __grid_constant__ CUtensorMap basis_lo,
                         const float* __restrict__ melw, float* __restrict__ out, int nf,
                         int m_tiles, int tiles, int k_tiles, int n_tiles, int n_mels, float amin,
                         float db_offset) {
  logmel_body<true>(frames, basis_hi, &basis_lo, melw, out, nf, m_tiles, tiles, k_tiles, n_tiles,
                    n_mels, amin, db_offset);
}

// The checks both entries share: xp [B, row] of the padded signal with
// elements of `elem` bytes, K steps of kb samples; 0 or a CUDA error.
cudaError_t check_args(int B, int row, int nf, int n_fft, int hop, int n_pad, int n_mels, int kb,
                       int elem, std::initializer_list<const void*> pointers) {
  const int align = 16 / elem;  // samples of a 16-byte TMA stride
  if (B <= 0 || nf <= 0 || n_fft % kb || n_fft > MAX_FFT || hop % align || row % align ||
      n_pad % BN || n_mels > MELS || (size_t)(nf - 1) * hop + n_fft > (size_t)row) {
    return cudaErrorInvalidValue;
  }
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  return cudaSuccess;
}

// The frame maps of K steps of kb samples over xp [B, row] (elements of
// `elem` bytes): map kt starts at sample kb kt.
template <bool X3>
cudaError_t encode_frames(FrameMaps<X3>* maps, const void* xp, int B, int row, int nf, int n_fft,
                          int hop) {
  constexpr int KB = Dft<X3>::KB, ELEM = X3 ? 4 : 2;
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)KB, (cuuint64_t)nf, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)hop * ELEM, (cuuint64_t)row * ELEM};
  const cuuint32_t box[3] = {(cuuint32_t)KB, (cuuint32_t)BM, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  for (int kt = 0; kt < n_fft / KB; ++kt) {
    void* base = const_cast<char*>(static_cast<const char*>(xp)) + (size_t)kt * ROW_BYTES;
    if (encode(&maps->kt[kt],
               X3 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base,
               dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  return cudaSuccess;
}

// the card's SM count, and the kernel's shared memory set for launches
cudaError_t prepare(const void* kernel, int smem, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, sms);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return err;
}

}  // namespace

extern "C" const char* arpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Golden route. xp [B, row] f32, the reflect-padded signal, rows
// zero-padded to a multiple of 4 samples -> out [B, nf, n_mels] f32.
// basis_hi, basis_lo [n_pad, n_fft] f32: the basis as the AMP route lays it
// out, split for 3xTF32 (hi + lo = basis); melw [n_pad / 2, 64] f32. Needs
// hop and row multiples of 4 samples, n_fft a multiple of 32 and at most
// 1536, n_pad a multiple of 128, n_mels <= 64.
extern "C" int arpu_fused_logmel(const float* xp, float* out, int B, int row, int nf, int n_fft,
                                 int hop, const float* basis_hi, const float* basis_lo,
                                 int n_pad, const float* melw, int n_mels, float amin,
                                 float db_offset, void* stream) {
  using D = Dft<true>;
  cudaError_t err = check_args(B, row, nf, n_fft, hop, n_pad, n_mels, D::KB, 4,
                               {xp, out, basis_hi, basis_lo, melw});
  FrameMaps<true> maps;
  if (err == cudaSuccess) err = encode_frames<true>(&maps, xp, B, row, nf, n_fft, hop);
  CUtensorMap hi_map, lo_map;
  if (err == cudaSuccess &&
      (!encode_map(&hi_map, basis_hi, n_pad, n_fft, BN, D::KB, 0, CU_TENSOR_MAP_SWIZZLE_128B) ||
       !encode_map(&lo_map, basis_lo, n_pad, n_fft, BN, D::KB, 0, CU_TENSOR_MAP_SWIZZLE_128B))) {
    err = cudaErrorInvalidValue;
  }
  int sms = 0;
  if (err == cudaSuccess) {
    err = prepare(reinterpret_cast<const void*>(logmel_tf32x3_kernel), D::SMEM, &sms);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (nf + BM - 1) / BM, tiles = m_tiles * B;
  logmel_tf32x3_kernel<<<tiles < sms ? tiles : sms, THREADS, D::SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      maps, hi_map, lo_map, melw, out, nf, m_tiles, tiles, n_fft / D::KB, n_pad / BN, n_mels,
      amin, db_offset);
  return static_cast<int>(cudaGetLastError());
}

// AMP route. xp [B, row] bf16, the signal cast to bf16 then reflect-padded,
// rows zero-padded to a multiple of 8 samples -> out [B, nf, n_mels] f32.
// basis [n_pad, n_fft] bf16 (row 2j cos, 2j+1 sin of active bin j, zero
// beyond); melw [n_pad / 2, 64] f32 (zero beyond the active bins and
// n_mels). Needs hop and row multiples of 8 samples, n_fft a multiple of 64
// and at most 1536, n_pad a multiple of 128, n_mels <= 64.
extern "C" int arpu_fused_logmel_bf16(const void* xp, float* out, int B, int row, int nf,
                                      int n_fft, int hop, const void* basis, int n_pad,
                                      const float* melw, int n_mels, float amin, float db_offset,
                                      void* stream) {
  using D = Dft<false>;
  cudaError_t err =
      check_args(B, row, nf, n_fft, hop, n_pad, n_mels, D::KB, 2, {xp, out, basis, melw});
  FrameMaps<false> maps;
  if (err == cudaSuccess) err = encode_frames<false>(&maps, xp, B, row, nf, n_fft, hop);
  CUtensorMap basis_map;
  if (err == cudaSuccess &&
      !encode_map(&basis_map, basis, n_pad, n_fft, BN, D::KB, 1, CU_TENSOR_MAP_SWIZZLE_128B)) {
    err = cudaErrorInvalidValue;
  }
  int sms = 0;
  if (err == cudaSuccess) {
    err = prepare(reinterpret_cast<const void*>(logmel_wgmma_kernel), D::SMEM, &sms);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (nf + BM - 1) / BM, tiles = m_tiles * B;
  logmel_wgmma_kernel<<<tiles < sms ? tiles : sms, THREADS, D::SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      maps, basis_map, melw, out, nf, m_tiles, tiles, n_fft / D::KB, n_pad / BN, n_mels, amin,
      db_offset);
  return static_cast<int>(cudaGetLastError());
}
