// Hopper port of the TPU kernel `fused_residual_ffn`
// (audio_residual_tpu/ops/pallas/ln_mlp.py::_kernel): on flattened rows,
// the optional ResiDual epilogue on the attention output a, h = x + a, then
// y = h + fc2(GELU(fc1(LN2(h)))), with the reference's double-FFN quirk as a
// second pass from x + y.
//
// Two routes.
//
// Golden (f32): a launch sequence (blocks.cuh) -- [ResiDual GEMMs] ->
// add+LN2 -> fc1+GELU -> fc2 + h1 [-> second pass], every product on the
// 3xTF32 TMA + wgmma GEMM (gemm_sm90.cuh::gemm_tf32x3).
//   What bounds it on the H100: operations. At HTSAT-tiny layer 3 and B=32
//   (2048 rows, 768 -> 3072 -> 768) fc1 and fc2 are 19.3 GFLOP, 0.29 ms at
//   the 67 TFLOP/s of f32 on the CUDA cores.
//   3xTF32 runs them as three TF32 passes, 58 GFLOP at 495 TFLOP/s
//   (0.12 ms), with about f32's accuracy: the wrapper splits the weights
//   into hi + lo once per weight version (ops/cuda/tf32x3.py), the kernel
//   splits z and hid as it reads them.
//
// AMP (bf16 operands, f32 accumulate): ffn_cluster_kernel, one launch per
// FFN pass.
//   What bounds it on the H100: operations. At HTSAT-tiny layer 3 and B=32
//   (2048 rows, 768 -> 3072 -> 768) a pass is 19.3 GFLOP, 19.5 us at the
//   989 TFLOP/s bf16 rate, against ~20 MB of inputs and outputs (6 us at
//   3.35 TB/s). The launch sequence it replaces (add+LN2, fc1, fc2) wrote
//   and read back z, h1 and the [R, 4C] hidden activation (12.6 MB at tiny)
//   and ran fc2 as a single wave.
//   Design: the TPU kernel's (row block, hidden chunk) grid, with the
//   hidden axis split across a thread-block cluster. One block cannot hold
//   fc2's f32 accumulator [128, C] (384 KB at C = 768), so a cluster of CS
//   blocks (the wrapper's plan: 6 at C = 768, 8 at C = 1024 and 2048) owns
//   a 128-row tile, and block j owns output columns [j C/CS, (j+1) C/CS) --
//   a [128, C/CS] f32 accumulator, 48-128 registers a consumer thread.
//   * Prologue: each block forms h = x (+ a) for 128/CS rows of the tile,
//     LN2 with f32 statistics, and writes z in bf16 to a scratch buffer that
//     stays in L2; a cluster barrier makes it visible to TMA.
//   * Loop over hidden chunks of 64 CS columns. fc1: block j computes its
//     64 columns, GELU(z @ W1[part j]^T + b1), into a [128, 64] fragment
//     (wgmma m64n64k16), z's and W1's [.., 64] K-tiles by TMA. (TMA
//     multicast of z to the cluster, one L2 read for CS blocks, measured
//     slower: 0.211 against 0.167 ms at HTSAT-tiny layer 3, PERF.md. A
//     stage it writes is free only once all CS blocks released it, which
//     couples every block's ring to the slowest.)
//   * Exchange: the block rounds the fragment to bf16 (where the old route
//     stored hid) into slot j of its [128, 64 CS] hid-chunk buffer, in the
//     128-byte-swizzled K-major layout wgmma reads, and copies the slot to
//     the same slot of every peer with cp.async.bulk over distributed shared
//     memory, completion counted on the peer's mbarrier. hid never reaches
//     device memory.
//   * fc2: acc[128, C/CS] += hid chunk @ W2[own columns, chunk]^T, K-step s
//     reading slot s, W2's [C/CS, 64] tiles by TMA. Every peer then signals
//     that its buffer is free for the next chunk.
//   * Epilogue: out = acc + b2 + h (+ r2) from the fragment, rows past R
//     masked. Sums run in a fixed order, so two calls give equal bits.
//   A producer warpgroup issues the TMA loads through one ring whose stages
//   hold a fc1 step (z + W1 tile) or a fc2 step (W2 tile), in the order the
//   consumers take them; two consumer warpgroups take 64 rows each.
//   Measured on the H100 (PERF.md, tools/probe_residual_ffn.py): only 15
//   clusters of 8 such blocks are resident at once (17 of 6), so R = 2048
//   (16 tiles) runs in two waves at C = 1024; and a chunk's exchange (each
//   block sends and receives (CS-1)/CS of a [128, 64 CS] bf16 chunk, ~112 KB
//   at CS = 8) runs at distributed shared memory's bandwidth, 4-6 us a
//   chunk. The kernel is slower than the launch sequence it replaced.
//   ResiDual: its two 3xTF32 GEMMs make h1 in f32 as in the golden route,
//   and the kernel runs on x = h1. Double FFN: pass 1 writes y2 = h1 + FFN(h1) + x in f32,
//   pass 2 computes y2 + FFN(y2).
#include <string.h>

#include <atomic>

#include "blocks.cuh"

namespace arpu {

// ---- golden route ------------------------------------------------------
static size_t residual_ffn_ws(int R, int C, int hidden, int kr) {
  return span((size_t)R * C * 4) + ffn_ws(R, C, hidden, 0) + span((size_t)R * kr * 4);
}

// a must be f32 with a ResiDual (the first product's A operand)
static cudaError_t residual_ffn_f32(const void* x, int x_bf16, const void* a, int a_bf16,
                                    void* out, int out_bf16, int R, int C, int hidden,
                                    const float* n2s, const float* n2b, const FfnWeights& w,
                                    const float* bfc1, const float* bfc2,
                                    const ResidualWeights* res, int double_ffn, void* ws,
                                    cudaStream_t s) {
  Arena ar{static_cast<unsigned char*>(ws)};
  float* h1 = ar.take<float>((size_t)R * C);
  const FfnScratch ffn_scratch = take_ffn(ar, R, C, hidden, 0);
  int z_ready = 0;
  if (res) {
    if (a_bf16) return cudaErrorInvalidValue;
    float* proj = ar.take<float>((size_t)R * res->kr);
    ARPU_TRY(run_residual_epilogue(static_cast<const float*>(a), x, x_bf16, h1, R, C, *res, proj,
                                   s));
  } else {
    // h1 = x + a and z = LN2(h1) in one pass
    ARPU_TRY(launch_add_layernorm(x, x_bf16, a, a_bf16, h1, ffn_scratch.z, 0, n2s, n2b, R, C, s));
    z_ready = 1;
  }
  return run_ffn(x, x_bf16, h1, out, out_bf16, R, C, hidden, n2s, n2b, w, bfc1, bfc2, double_ffn,
                 0, z_ready, ffn_scratch, s);
}

// ---- AMP route: one clustered launch per FFN pass ------------------------
namespace ffn {

using namespace sm90;  // BM = 128, BK = 64, THREADS = 384, SMEM_LIMIT, the ring's helpers

constexpr int HP = 64;                      // hidden columns a block computes per chunk
constexpr int Z_BYTES = BM * BK * 2;        // z K-tile [128, 64]
constexpr int W1_BYTES = HP * BK * 2;       // W1 K-tile [64, 64]
constexpr int SLOT_BYTES = BM * HP * 2;     // one block's part of a hid chunk [128, 64]
constexpr int HALF_SLOT = SLOT_BYTES / 2;   // a consumer warpgroup's 64 rows of it
constexpr int MAX_CS = 8;

__host__ __device__ constexpr int stage_bytes(int n_out) {
  return Z_BYTES + W1_BYTES > n_out * BK * 2 ? Z_BYTES + W1_BYTES : n_out * BK * 2;
}

// the launch's dynamic shared memory: alignment slack, hid chunk, ring,
// barriers (full and empty per stage, hid_full, hid_empty)
static inline int smem_bytes(int cs, int n_out, int stages) {
  return 1024 + cs * SLOT_BYTES + stages * stage_bytes(n_out) + (2 * stages + 2) * 8;
}

struct FfnArgs {
  const void* x;   // [R, C] f32 or bf16
  const void* a;   // [R, C] or null: h = x (+ a)
  const void* r2;  // [R, C] or null: added last
  void* out;       // [R, C] f32 or bf16
  const float* n2s;
  const float* n2b;
  const float* b1;  // [hidden]
  const float* b2;  // [C]
  __nv_bfloat16* z;  // scratch [R, C]: LN2(h) in bf16
  int x_bf16, a_bf16, r2_bf16, out_bf16;
  int R, C, hidden, cs, stages;
};

__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// arrive on the mbarrier at the same offset in cluster block `rank`. The
// default semantics (release at CTA scope) are enough: what a peer's arrival
// orders is its wgmma reads of a stage (done at wgmma.wait) and its
// bulk copies, whose completion the barriers count themselves.
__device__ __forceinline__ void arrive_peer(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(peer_addr(bar, rank))
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

// `bytes` at `src` to the same offset in cluster block `rank`, counted on
// that block's `bar`
__device__ __forceinline__ void copy_to_peer(const void* src, int bytes, int rank,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(peer_addr(src, rank)),
      "r"(smem_u32(src)), "r"(bytes), "r"(peer_addr(bar, rank))
      : "memory");
}

// 8 consecutive values of h = x (+ a) at flat index i
__device__ __forceinline__ void load_h8(const FfnArgs& p, size_t i, float (&v)[8]) {
  if (p.x_bf16) {
    load8(static_cast<const __nv_bfloat16*>(p.x) + i, v);
  } else {
    load8(static_cast<const float*>(p.x) + i, v);
  }
  if (p.a) {
    if (p.a_bf16) {
      add8<__nv_bfloat16>(p.a, i, v);
    } else {
      add8<float>(p.a, i, v);
    }
  }
}

constexpr int MAX_C = 2048;  // LN2 keeps a row in registers: 8 chunks of 8 a lane

// z[row] = LN2(h[row]) in bf16, one warp, f32 statistics (mean, then the
// centred variance, as add_layernorm_kernel takes them), the row read once
__device__ void ln2_row(const FfnArgs& p, int row, int lane) {
  constexpr int CHUNKS = MAX_C / 256;
  const size_t base = (size_t)row * p.C;
  float v[CHUNKS][8];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = 8 * lane + 256 * i;
    if (c < p.C) {
      load_h8(p, base + c, v[i]);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[i][k];
    }
  }
  const float mu = warp_sum(s) / p.C;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if (8 * lane + 256 * i < p.C) {
#pragma unroll
      for (int k = 0; k < 8; ++k) q += (v[i][k] - mu) * (v[i][k] - mu);
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / p.C + 1e-5f);
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = 8 * lane + 256 * i;
    if (c < p.C) {
      float g[8], b[8];
      load8(p.n2s + c, g);
      load8(p.n2b + c, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[i][k] = (v[i][k] - mu) * rstd * g[k] + b[k];
      store8(p.z + base + c, v[i]);
    }
  }
}

__device__ __forceinline__ float2 ld2(const void* p, size_t i, int bf16) {
  if (bf16) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p) + i));
  }
  return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + i);
}

__device__ __forceinline__ void st2(void* p, size_t i, float a, float b, int bf16) {
  if (bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i) =
        __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(a, b);
  }
}

// grid: (R / 128 row tiles) x CS blocks, clusters of CS along x. tm_z: z
// [R, C], box {64, 128}; tm_w1: W1 [hidden, C], box {64, 64}; tm_w2:
// W2 [C, hidden], box {64, NO}; NO = C / CS output columns a block.
template <int NO>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_cluster_kernel(const __grid_constant__ CUtensorMap tm_z,
                       const __grid_constant__ CUtensorMap tm_w1,
                       const __grid_constant__ CUtensorMap tm_w2, const FfnArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // the same offset in every block: peer copies and arrivals address it so
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int cs = p.cs, stages = p.stages, sb = stage_bytes(NO);
  unsigned char* hid = smem;                        // [CS slots][128 rows][64] bf16, swizzled
  unsigned char* ring = smem + cs * SLOT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * sb);
  uint64_t* empty = full + stages;
  uint64_t* hid_full = empty + stages;   // the peers' slots of this chunk have landed
  uint64_t* hid_empty = hid_full + 1;    // every block finished fc2 on this chunk
  const int rank = blockIdx.x % cs, m0 = (blockIdx.x / cs) * BM, rpb = (BM + cs - 1) / cs;
  const int chunks = p.hidden / (HP * cs), k_tiles = (p.C + BK - 1) / BK;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(hid_full, 2);        // each consumer warpgroup's expect_tx
    mbar_init(hid_empty, 2 * cs);  // each consumer warpgroup of each block
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // prologue: LN2 of this block's 128 / CS rows of the tile into z
  for (int i = warp; i < rpb; i += THREADS / 32) {
    const int row = m0 + rank * rpb + i;
    if (rank * rpb + i < BM && row < p.R) ln2_row(p, row, lane);
  }
  asm volatile("fence.proxy.async.global;" ::: "memory");  // z's stores, before TMA reads them
  cluster_sync();  // z and every block's barriers are ready

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < chunks; ++t) {
        const int h0 = t * HP * cs;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait_or_trap(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * sb;
          mbar_expect_tx(&full[stage], Z_BYTES + W1_BYTES);
          tma_load(st, &tm_z, &full[stage], kt * BK, m0);
          tma_load(st + Z_BYTES, &tm_w1, &full[stage], kt * BK, h0 + rank * HP);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
        for (int s = 0; s < cs; ++s) {
          mbar_wait_or_trap(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], NO * BK * 2);
          tma_load(ring + stage * sb, &tm_w2, &full[stage], h0 + s * HP, rank * NO);
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
    cluster_sync();  // no block leaves while a peer may still address it
    return;
  }

  // consumers: warpgroup cw takes rows 64 cw .. of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, wq = warp % 4;
  const int r = 16 * wq + lane / 4;  // fragment rows r and r + 8 of the warpgroup's 64
  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  // the stage is read: lane 0 releases it for its warp
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  for (int t = 0; t < chunks; ++t) {
    const int h0 = t * HP * cs;
    // fc1: h = z @ W1[part]^T, [64, 64] a warpgroup
    float h[HP / 2];
    int reading = -1;  // the stage the wgmma group in flight reads
    for (int kt = 0; kt < k_tiles; ++kt) {
      mbar_wait_or_trap(&full[stage], phase);
      const uint64_t dz = smem_desc(ring + stage * sb + cw * 64 * BK * 2);
      const uint64_t dw = smem_desc(ring + stage * sb + Z_BYTES);
      fence_regs(h);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) Wgmma<HP>::mma(h, dz + 2 * k, dw + 2 * k, (kt | k) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(h);
      if (reading >= 0) release(reading);
      reading = stage;
      if (++stage == stages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(h);
    release(reading);
    reading = -1;

    // exchange: bf16(GELU(h + b1)) into this block's slot, then to every peer's.
    // The slot is free once every block finished the last chunk's fc2: that
    // also means the peers received its copies.
    if (t > 0) mbar_wait_or_trap(hid_empty, (t - 1) & 1);
    unsigned char* slot = hid + rank * SLOT_BYTES + cw * HALF_SLOT;
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 b = *reinterpret_cast<const float2*>(p.b1 + h0 + rank * HP + col);
      // 128-byte swizzle: 16-byte chunk j of row r sits at chunk j ^ (r % 8)
      const int off = ((j ^ (r & 7)) << 4) + 4 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(slot + r * 128 + off) =
          __floats2bfloat162_rn(gelu_erf(h[4 * j] + b.x), gelu_erf(h[4 * j + 1] + b.y));
      *reinterpret_cast<__nv_bfloat162*>(slot + (r + 8) * 128 + off) =
          __floats2bfloat162_rn(gelu_erf(h[4 * j + 2] + b.x), gelu_erf(h[4 * j + 3] + b.y));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma and the copies
    warpgroup_sync(wg);
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(hid_full, (cs - 1) * HALF_SLOT);
      for (int q = 0; q < cs; ++q) {
        if (q != rank) copy_to_peer(slot, HALF_SLOT, q, hid_full);
      }
    }
    mbar_wait_or_trap(hid_full, t & 1);

    // fc2: acc += hid chunk @ W2[own columns, chunk]^T, K-step s on slot s
    for (int s = 0; s < cs; ++s) {
      mbar_wait_or_trap(&full[stage], phase);
      const uint64_t da = smem_desc(hid + s * SLOT_BYTES + cw * HALF_SLOT);
      const uint64_t dw = smem_desc(ring + stage * sb);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) Wgmma<NO>::mma(acc, da + 2 * k, dw + 2 * k, 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (reading >= 0) release(reading);
      reading = stage;
      if (++stage == stages) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(reading);
    if (t + 1 < chunks) {  // this warpgroup is done with the chunk: tell every block
      warpgroup_sync(wg);
      if (wq == 0 && lane < cs) arrive_peer(hid_empty, lane);
    }
  }

  // epilogue: out = acc + b2 + h (+ r2), the fragment's column pairs
  const int n_base = rank * NO + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < NO / 8; ++j) {
    const int n = n_base + 8 * j;
    const float2 b = *reinterpret_cast<const float2*>(p.b2 + n);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + 64 * cw + r + 8 * hh;
      if (m >= p.R) continue;
      const size_t at = (size_t)m * p.C + n;
      float2 hv = ld2(p.x, at, p.x_bf16);
      if (p.a) {
        const float2 av = ld2(p.a, at, p.a_bf16);
        hv.x += av.x, hv.y += av.y;
      }
      float v0 = acc[4 * j + 2 * hh] + b.x + hv.x, v1 = acc[4 * j + 2 * hh + 1] + b.y + hv.y;
      if (p.r2) {
        const float2 rv = ld2(p.r2, at, p.r2_bf16);
        v0 += rv.x, v1 += rv.y;
      }
      st2(p.out, at, v0, v1, p.out_bf16);
    }
  }
  cluster_sync();
}

static bool plan_ok(int C, int hidden, int cs, int stages, int smem) {
  if (cs < 1 || cs > MAX_CS || C % 8 || C > MAX_C || C % cs ||
      hidden % (HP * cs)) {
    return false;
  }
  const int n_out = C / cs;
  if (n_out != 64 && n_out != 96 && n_out != 128 && n_out != 256) return false;
  return stages >= 2 && smem == smem_bytes(cs, n_out, stages) && smem <= SMEM_LIMIT;
}

template <int NO>
static cudaError_t launch_pass(const CUtensorMap& tz, const CUtensorMap& t1, const CUtensorMap& t2,
                               const FfnArgs& p, int smem, int dev, cudaStream_t s) {
  const auto kernel = ffn_cluster_kernel<NO>;
  static std::atomic<bool> smem_set[MAX_DEVICES];  // per instantiation
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_relaxed);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.R + BM - 1) / BM) * p.cs);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tz, t1, t2, p);
}

static cudaError_t run_pass(const CUtensorMap& tz, const CUtensorMap& t1, const CUtensorMap& t2,
                            const FfnArgs& p, int smem, int dev, cudaStream_t s) {
  switch (p.C / p.cs) {
    case 64:
      return launch_pass<64>(tz, t1, t2, p, smem, dev, s);
    case 96:
      return launch_pass<96>(tz, t1, t2, p, smem, dev, s);
    case 128:
      return launch_pass<128>(tz, t1, t2, p, smem, dev, s);
    default:
      return launch_pass<256>(tz, t1, t2, p, smem, dev, s);
  }
}

}  // namespace ffn
}  // namespace arpu

// bytes of scratch of the golden route
extern "C" size_t arpu_residual_ffn_workspace(int R, int C, int hidden, int kr) {
  return arpu::residual_ffn_ws(R, C, hidden, kr);
}

// Golden route. x, a, out [R, C] (out f32; a f32 with a ResiDual); fc1
// [hidden, C] and fc2 [C, hidden] split for 3xTF32, hi and lo f32 in
// nn.Linear layout (ops/cuda/tf32x3.py::split_tf32), each with its GEMM plan
// (N tile bn, ring stages: tf32x3.py::gemm_plan, checked against this
// build). The ResiDual the same way: rbasis [kr, C] and rbasis_t [C, kr]
// (hi, lo, plan), null without ResiDual; rmean [C], rlam [kr]; kr a multiple
// of 8 (the wrapper pads it with zeros, tf32x3.py::residual_weights). ws:
// arpu_residual_ffn_workspace bytes.
extern "C" int arpu_residual_ffn(const void* x, int x_bf16, const void* a, int a_bf16, void* out,
                                 int out_bf16, int R, int C, int hidden, const float* n2s,
                                 const float* n2b, const float* w1_hi, const float* w1_lo,
                                 int fc1_bn, int fc1_stages, const float* bfc1,
                                 const float* w2_hi, const float* w2_lo, int fc2_bn,
                                 int fc2_stages, const float* bfc2, const float* rbasis,
                                 const float* rbasis_lo, int rb_bn, int rb_stages,
                                 const float* rbasis_t, const float* rbasis_t_lo, int rbt_bn,
                                 int rbt_stages, const float* rmean, const float* rlam, int kr,
                                 int double_ffn, void* ws, void* stream) {
  const arpu::FfnWeights w{nullptr, nullptr, {w1_hi, w1_lo, fc1_bn, fc1_stages},
                           {w2_hi, w2_lo, fc2_bn, fc2_stages}};
  const arpu::ResidualWeights res{{rbasis, rbasis_lo, rb_bn, rb_stages},
                                  {rbasis_t, rbasis_t_lo, rbt_bn, rbt_stages}, rmean, rlam, kr};
  return static_cast<int>(arpu::residual_ffn_f32(
      x, x_bf16, a, a_bf16, out, out_bf16, R, C, hidden, n2s, n2b, w, bfc1, bfc2,
      rbasis ? &res : nullptr, double_ffn, ws, static_cast<cudaStream_t>(stream)));
}

// AMP route. x, a, out [R, C] (f32 or bf16 each; a f32 with a ResiDual); the
// TMA maps of the bf16 weights W1 [hidden, C] (box rows 64) and W2 [C,
// hidden] (box rows C / cs) from arpu_weight_map (gemm.cu); biases and LN2
// f32. ResiDual as in the golden route, on the 3xTF32 GEMM. The plan
// (cluster size cs, ring stages, shared bytes) comes from the wrapper and
// must be this build's. ws: z [R, C] bf16, then with
// ResiDual h1 [R, C] and proj [R, kr] f32, then with double_ffn y2 [R, C]
// f32, each 256-byte aligned. Returns the first CUDA error of the launches.
extern "C" int arpu_residual_ffn_amp(const void* x, int x_bf16, const void* a, int a_bf16,
                                     void* out, int out_bf16, int R, int C, int hidden,
                                     const float* n2s, const float* n2b, const void* w1_map,
                                     const float* bfc1, const void* w2_map, const float* bfc2,
                                     const float* rbasis, const float* rbasis_lo, int rb_bn,
                                     int rb_stages, const float* rbasis_t,
                                     const float* rbasis_t_lo, int rbt_bn, int rbt_stages,
                                     const float* rmean, const float* rlam, int kr,
                                     int double_ffn, int cs, int stages, int smem, void* ws,
                                     void* stream) {
  using namespace arpu;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || !ffn::plan_ok(C, hidden, cs, stages, smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* pointers[8] = {x, a, out, n2s, n2b, bfc1, bfc2, ws};
  for (const void* q : pointers) {
    if (reinterpret_cast<uintptr_t>(q) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= sm90::MAX_DEVICES)) err = cudaErrorInvalidDevice;
  if (err != cudaSuccess) return static_cast<int>(err);

  Arena ar{static_cast<unsigned char*>(ws)};
  auto* z = ar.take<__nv_bfloat16>((size_t)R * C);
  CUtensorMap tz;
  if (!sm90::encode_map(&tz, z, R, C, sm90::BM, sm90::BK, 1, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap t1, t2;
  memcpy(&t1, w1_map, sizeof(t1));
  memcpy(&t2, w2_map, sizeof(t2));

  ffn::FfnArgs p = {};
  p.x = x, p.x_bf16 = x_bf16, p.a = a, p.a_bf16 = a_bf16;
  p.n2s = n2s, p.n2b = n2b, p.b1 = bfc1, p.b2 = bfc2, p.z = z;
  p.R = R, p.C = C, p.hidden = hidden, p.cs = cs, p.stages = stages;
  if (rbasis) {  // h1 = x + ResiDual(a), f32; the passes run on it
    if (a_bf16) return static_cast<int>(cudaErrorInvalidValue);
    const ResidualWeights res{{rbasis, rbasis_lo, rb_bn, rb_stages},
                              {rbasis_t, rbasis_t_lo, rbt_bn, rbt_stages}, rmean, rlam, kr};
    float* h1 = ar.take<float>((size_t)R * C);
    float* proj = ar.take<float>((size_t)R * kr);
    ARPU_TRY(run_residual_epilogue(static_cast<const float*>(a), x, x_bf16, h1, R, C, res, proj,
                                   s));
    p.x = h1, p.x_bf16 = 0, p.a = nullptr;
  }
  if (double_ffn) {  // pass 1: y2 = h + FFN(h) + x, f32
    float* y2 = ar.take<float>((size_t)R * C);
    ffn::FfnArgs p1 = p;
    p1.r2 = x, p1.r2_bf16 = x_bf16, p1.out = y2, p1.out_bf16 = 0;
    ARPU_TRY(ffn::run_pass(tz, t1, t2, p1, smem, dev, s));
    p.x = y2, p.x_bf16 = 0, p.a = nullptr;
  }
  p.out = out, p.out_bf16 = out_bf16;
  return static_cast<int>(ffn::run_pass(tz, t1, t2, p, smem, dev, s));
}
