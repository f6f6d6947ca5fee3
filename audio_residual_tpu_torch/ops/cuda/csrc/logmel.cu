// Hopper port of the TPU kernel `fused_logmel`
// (audio_residual_tpu/ops/pallas/frontend.py::_rows_kernel): framing,
// hann-windowed DFT against cos|sin restricted to the mel-active bins,
// power, mel projection and 10 log10(max(mel, amin)) - db_offset, without
// writing frames or the power spectrogram to device memory. Two kernels, one
// per route:
//
// logmel_wgmma_kernel, the AMP route (dft_mode "bf16"): frames and basis in
// bf16, f32 accumulate, f32 power and mel product.
//   What bounds it on the H100: operations. HTSAT-tiny at B=32 is a
//   [32032, 1024] x [1024, 594] DFT product, 39 GFLOP (0.04 ms at the
//   989 TFLOP/s bf16 rate), against 31 MB of bf16 signal (9 us at 3.35 TB/s).
//   Design, after gemm_sm90.cuh: one block an SM (persistent grid, measured
//   no slower than one block per tile) walks the (128-frame tile, clip)
//   pairs; a producer warpgroup keeps TMA loads in flight
//   through a ring of stages; two consumer warpgroups, 64 frames each, run
//   wgmma m64n128k16. Every block reads the whole basis and each frame tile
//   once per N tile, about 670 MB from L2 a launch at HTSAT-tiny's B=32,
//   so L2 bandwidth rather than the tensor cores sets its pace (PERF.md).
//   * The A operand is the frames, never materialised: frame f starts at
//     sample f*hop of the bf16 padded signal, so the [128 frames, 64 samples]
//     tile of K step kt is a 3-D TMA box of a map {64 samples, nf frames,
//     B clips} with strides {hop, row} whose base is the signal + 64 kt (one
//     map a K step, each of them a plain strided view). Frames >= nf arrive
//     zero-filled.
//   * The B operand is the basis [n_pad, n_fft] bf16, K-major, cos and sin
//     of each active bin interleaved (column 2j cos, 2j+1 sin) and zero
//     beyond 2 nbins. In the wgmma f32 fragment a thread holds columns
//     8j + 2(l%4) + {0, 1}: re and im of one bin in one register pair, so
//     re^2 + im^2 needs no shuffle.
//   * The block walks the N tiles (64 bins each): the whole of n_fft is
//     accumulated, the power chunk is staged in shared memory [bins, frames]
//     and folded into a [64 frames, 64 mels] f32 accumulator held in
//     registers (4 frames x 8 mels a thread) on the CUDA cores. Only the
//     log-mel reaches device memory.
//
// logmel_kernel, the golden route (dft_mode "f32"): f32 on the CUDA cores.
// 39 GFLOP at the 67 TFLOP/s f32 rate is 0.58 ms, so it is bound by
// operations. One block per (64-frame tile, clip), frames read straight from
// the reflect-padded signal; the bins are walked in chunks of 32: a
// [64 frames x 64 cols] DFT tile (32 cos | 32 sin columns) is accumulated
// over n_fft through shared memory, squared into a power chunk in shared
// memory and folded into the [64 frames x 64 mels] mel accumulator held in
// registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "gemm_sm90.cuh"

namespace {

// ---- golden route: f32 on the CUDA cores ---------------------------------
constexpr int LF = 64;  // frames a block
constexpr int LB = 32;  // bins a chunk (64 DFT columns)
constexpr int LK = 16;  // samples a K step
constexpr int LM = 64;  // most mel bands

__global__ void __launch_bounds__(256) logmel_kernel(const float* xp, float* out, int t_pad,
                                                     int nf, int n_fft, int hop,
                                                     const float* basis, int nbins,
                                                     const float* melw, int n_mels, float amin,
                                                     float db_offset) {
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
        Fs[kk][fr] = (f < nf && k < n_fft) ? x[(size_t)f * hop + k] : 0.0f;
      }
      for (int e = tid; e < LK * 2 * LB; e += 256) {
        const int kk = e / (2 * LB), c = e % (2 * LB), k = k0 + kk;
        const int bin = j0 + (c % LB);
        const int col = c < LB ? bin : nbins + bin;
        Bs[kk][c] = (bin < nbins && k < n_fft) ? basis[(size_t)k * 2 * nbins + col] : 0.0f;
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

// ---- AMP route: bf16 DFT on wgmma, f32 power and mel fold -----------------
namespace tc {

using namespace arpu::sm90;  // BM = 128 frames, BK = 64 samples, 384 threads

constexpr int BN = 128;        // DFT columns a tile: 64 bins, cos|sin interleaved
constexpr int BINS = BN / 2;
constexpr int MELS = 64;       // width of the mel accumulator and of the padded melw
constexpr int MAX_KT = 24;     // K steps of 64 samples: n_fft <= 1536
constexpr int LDP = BINS + 8;  // power staging [bins, frames]: rows 8 floats apart in banks
constexpr int A_BYTES = BM * BK * 2;
constexpr int W_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
constexpr int POWER_FLOATS = 64 * LDP;       // per consumer warpgroup
constexpr int MELW_FLOATS = BINS * MELS;     // per consumer warpgroup
constexpr int STAGING_BYTES = 2 * (POWER_FLOATS + MELW_FLOATS) * 4;
constexpr int FREE = SMEM_LIMIT - 1024 - STAGING_BYTES - 256;
constexpr int STAGES = FREE / STAGE_BYTES > 6 ? 6 : FREE / STAGE_BYTES;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + STAGING_BYTES + 2 * STAGES * 8;
static_assert(STAGES >= 2, "the ring needs two stages");

// one map a K step: {64 samples, nf frames, B clips} from sample 64 kt
struct FrameMaps {
  CUtensorMap kt[MAX_KT];
};

__global__ void __launch_bounds__(THREADS, 1)
    logmel_wgmma_kernel(const __grid_constant__ FrameMaps frames,
                        const __grid_constant__ CUtensorMap basis, const float* __restrict__ melw,
                        float* __restrict__ out, int nf, int m_tiles, int tiles, int k_tiles,
                        int n_tiles, int n_mels, float amin, float db_offset) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = smem;
  unsigned char* w_ring = smem + STAGES * A_BYTES;
  float* power = reinterpret_cast<float*>(w_ring + STAGES * W_BYTES);
  float* melw_s = power + 2 * POWER_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(melw_s + 2 * MELW_FLOATS);
  uint64_t* empty = full + STAGES;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          tma_load_3d(a_ring + stage * A_BYTES, &frames.kt[kt], &full[stage], 0, f0, clip);
          tma_load(w_ring + stage * W_BYTES, &basis, &full[stage], kt * BK, n * BN);
          if (++stage == STAGES) stage = 0, phase ^= 1;
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
  const int a_off = (wg - 1) * 64 * BK * 2;
  const bool signals = lane == 0;  // lane 0 releases a stage for its warp
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
      int reading = -1;  // the stage the wgmma group in flight reads
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = smem_desc(a_ring + stage * A_BYTES + a_off);
        const uint64_t dw = smem_desc(w_ring + stage * W_BYTES);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          Wgmma<BN>::mma(acc, da + 2 * k, dw + 2 * k, (kt | k) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (reading >= 0 && signals) mbar_arrive(&empty[reading]);
        reading = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (signals) mbar_arrive(&empty[reading]);

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

}  // namespace tc
}  // namespace

extern "C" const char* arpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Golden route. xp [B, t_pad] reflect-padded f32 -> out [B, nf, n_mels] f32.
// basis [n_fft, 2*nbins] (cos | sin of the active bins); melw [nbins, n_mels].
extern "C" int arpu_fused_logmel(const float* xp, float* out, int B, int t_pad, int nf, int n_fft,
                                 int hop, const float* basis, int nbins, const float* melw,
                                 int n_mels, float amin, float db_offset, void* stream) {
  if (n_mels > LM) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((nf + LF - 1) / LF, B);
  logmel_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      xp, out, t_pad, nf, n_fft, hop, basis, nbins, melw, n_mels, amin, db_offset);
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
  using namespace tc;
  if (B <= 0 || nf <= 0 || n_fft % BK || n_fft / BK > MAX_KT || hop % 8 || row % 8 ||
      n_pad % BN || n_mels > MELS || (size_t)(nf - 1) * hop + n_fft > (size_t)row) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* pointers[4] = {xp, out, basis, melw};
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const arpu::sm90::TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return static_cast<int>(cudaErrorInvalidValue);
  FrameMaps maps;
  const cuuint64_t dims[3] = {(cuuint64_t)BK, (cuuint64_t)nf, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)hop * 2, (cuuint64_t)row * 2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)BM, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  for (int kt = 0; kt < n_fft / BK; ++kt) {
    void* base = const_cast<char*>(static_cast<const char*>(xp)) + (size_t)kt * BK * 2;
    if (encode(&maps.kt[kt], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
               elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  CUtensorMap basis_map;
  if (!encode_map(&basis_map, basis, n_pad, n_fft, BN, BK, 1, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(logmel_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m_tiles = (nf + BM - 1) / BM, tiles = m_tiles * B;
  const int grid = tiles < sms ? tiles : sms;
  logmel_wgmma_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      maps, basis_map, melw, out, nf, m_tiles, tiles, n_fft / BK, n_pad / BN, n_mels, amin,
      db_offset);
  return static_cast<int>(cudaGetLastError());
}
