// Tensor-core GEMM for Hopper (sm_90a): C = epi(A @ W^T), in two operand
// modes that share one ring, one mainloop and one epilogue.
//   * bf16 (gemm_bf16): the AMP GEMM of the Swin-block kernels (K2-K5). A
//     [M, K] bf16 row-major, W [N, K] bf16 (nn.Linear layout, K-major as
//     wgmma wants it).
//   * 3xTF32 (gemm_tf32x3): every f32 product of the golden routes of K2-K5
//     (qkv, proj, fc1, fc2) and the ResiDual GEMMs of both modes
//     (blocks.cuh). A [M, K] f32, optionally centred as it is read (a_sub,
//     below); W as two f32 matrices hi and lo with hi + lo = W, hi
//     rounded to TF32 (ops/cuda/tf32x3.py::split_tf32, once per weight
//     version). Each K step multiplies lo_A hi_W + hi_A lo_W + hi_A hi_W on
//     wgmma m64nNk8 .tf32 into an f32 partial sum of its 32 columns of K (the
//     two small terms first, lo_A lo_W dropped), which the CUDA cores add to
//     the tile's accumulator: A is split inside the kernel, hi_A =
//     cvt.rna.tf32(x) and lo_A = cvt.rna.tf32(x - hi_A), each with its low 13
//     bits cleared, so the tensor core, which reads the top 19 bits of an
//     operand, is never handed a raw f32 value as hi. Each product keeps
//     about f32's accuracy (a relative error near 2^-21 against f32's 2^-24;
//     the sums stay f32) at 3 passes of the 495 TFLOP/s TF32 rate, 2.5x the
//     67 TFLOP/s of f32 on the CUDA cores. It is the Hopper form of the TPU's
//     Precision.HIGHEST (a split into bf16 passes on the MXU; the JAX package
//     spells out a 3-pass split dot in ops/pallas/frontend.py::_split_dot).
// f32 accumulate, C [M, N] f32 or bf16. Epilogue, in this order:
// v += bias[n]; v *= col_scale[n]; v = gelu(v); v += r1[m, n]; v += r2[m, n]
// (r1, r2 f32 or bf16), each step optional. 3xTF32 prologue, optional: A's
// column k less a_sub[k] (the ResiDual centring a - mean), subtracted as the
// consumer reads A, before the split, so the split rounds |a - mean|, not |a|.
//
// What bounds it on the H100. bf16: bytes, at most shapes of the main paths.
// The K4 GEMMs at HTSAT-tiny/base layers 0-2 have K = C or 4C with C <= 512:
// the qkv product at C=96 is ~72 operations a byte against the card's bf16
// ridge of ~295, so the work is to stream A in and C out. 3xTF32: operations
// at K3's layer-3 shapes (HTSAT-tiny fc1: 2048 x 3072 x 768, three passes,
// 29 GFLOP), bytes at K4's narrow layers (the f32 hid [R, 4C] out and in).
//
// Design:
//   * one block an SM (persistent grid) walks (M tile, N tile) pairs, N
//     fastest, so the blocks working at one time share their A tile in L2;
//   * warpgroup 0 is the producer: one thread keeps TMA loads of A [128, BK]
//     and W [BN, BK] tiles (BK: 64 bf16 or 32 f32, one 128-byte swizzle row;
//     3xTF32 loads W's hi and lo tiles) in flight through a ring of stages,
//     completion counted by mbarriers; the ragged M, N and K edges arrive
//     zero-filled;
//   * warpgroups 1-2 are consumers, 64 rows of the tile each. bf16: wgmma
//     m64nBNk16 from shared memory into f32 registers, one group in flight
//     while the next k-tile is issued. 3xTF32: the warpgroup loads its A
//     fragment of a k-tile from the swizzled tile into registers (bank
//     conflict free), splits it there and issues the 12 wgmmas of the
//     k-tile with A from registers and W from shared memory; the group
//     finishes before the registers are reused, while the other consumer
//     warpgroup keeps the tensor cores busy. Then the epilogue, while the
//     producer already loads the next tile: the accumulator fragment goes
//     to a per-warpgroup staging buffer in shared memory and comes back 8
//     consecutive columns a thread, consecutive threads along a row, so
//     bias, residuals and the output move in coalesced 16-byte vectors;
//   * bf16: BN (96, 128 or 192) is picked per launch to divide N and fill
//     the card; the output and residual types are template parameters.
//     BN = 192 pays at HTSAT-tiny's qkv and fc1 shapes with N = 576 ...
//     3072: 3-12% less device time than the 96 or 128 they take without it;
//     at HTSAT-base's (N = 384, 768, 1536) it ties (PERF.md). 3xTF32: BN
//     (32, 64, 96 or 128; a stage holds A and both W tiles, so 128 leaves
//     three stages beside the staging buffer) comes from the caller's plan
//     (ops/cuda/tf32x3.py::gemm_plan), which the entry checks against this
//     build.
// Weights arrive in bf16 or split, made by the wrappers once per weight
// version, never per tile.
//
// Tried on the H100 while the bf16 design was made and not kept, for none
// was faster at HTSAT-tiny's layer-0 shapes: stores straight from the
// fragment, a TMA store of the finished tile, the per-column steps in the
// fragment pass, ping-pong consumers (each warpgroup its own 64-row tiles,
// product loops taking turns) and contiguous tile runs per block. At those
// shapes it takes 1.6-2.6x the device time of torch.matmul on the same
// operands, furthest where the epilogue does most (GELU, bf16 output;
// PERF.md).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace arpu {

// exact (erf) GELU, torch nn.GELU() semantics
__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

struct Epilogue {
  const float* bias;       // [N] or null
  const float* col_scale;  // [N] or null
  int gelu;
  const void* r1;  // [M, N] or null
  const void* r2;  // [M, N] or null
};

namespace sm90 {

constexpr int BM = 128;       // two consumer warpgroups of 64 rows
constexpr int BK = 64;        // 64 bf16 = 128 bytes: one row of the 128-byte swizzle
constexpr int BK_TF32 = 32;   // 32 f32: the same 128-byte row
constexpr int ROW_BYTES = 128;
constexpr int THREADS = 384;
constexpr int SMEM_LIMIT = 232448;  // what a block may use on the H100

// W_PARTS: 1 (bf16 W) or 2 (3xTF32: W's hi tile, then its lo tile)
template <int BN, int W_PARTS = 1>
struct Tiles {
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int W_BYTES = W_PARTS * BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  // epilogue staging, per consumer warpgroup: [64, BN] f32, rows padded by 8
  // floats so that the fragment's float2 stores take two wavefronts
  static constexpr int LDS = BN + 8;
  static constexpr int STAGING_BYTES = 2 * 64 * LDS * 4;
  // the ring takes what is left after 1 KB of alignment slack, the staging
  // and the barriers
  static constexpr int FREE = SMEM_LIMIT - 1024 - STAGING_BYTES - 256;
  static constexpr int STAGES = FREE / STAGE_BYTES > 8 ? 8 : FREE / STAGE_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + STAGING_BYTES + 2 * STAGES * 8;
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Spin until the phase of parity `parity` has completed. A wait that never
// ends -- a lost arrival -- traps, which fails the launch, instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (!start) {
      start = now;
    } else if (now - start > (1LL << 34)) {
      __trap();
    }
  }
}

// TMA: box {BK columns from c0, rows from c1} of `map` into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// TMA: 3-D box at coordinates {c0, c1, c2} of `map` into shared memory
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4)          // start address
         | (uint64_t(1) << 16)            // leading byte offset (unused when swizzled)
         | (uint64_t(1024 >> 4) << 32)    // stride byte offset: one 8-row atom
         | (uint64_t(1) << 62);           // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// barrier of one warpgroup (named barrier `id`, 128 threads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// keeps the compiler from moving accumulator reads across the wgmma wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, both operands K-major in
// shared memory. acc = 0 overwrites d (the first product of a tile).
template <int N>
struct Wgmma;

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc));
  }
};

// m64n144k16 serves the window-attention kernel's head group of two heads at
// head dim 24 (window_attention_tc.cuh): q|k|v columns 3 x 48.
template <>
struct Wgmma<144> {
  static __device__ __forceinline__ void mma(float (&d)[72], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71"
      "}, "
      "%72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(acc));
  }
};

// m64n64k16 and m64n256k16 serve K3's clustered FFN (ln_mlp.cu): fc1's
// 64-column hidden part, and fc2's 256 output columns at C = 2048.
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
  }
};

// ---- 3xTF32 -------------------------------------------------------------
// x rounded to TF32, to nearest with ties away (cvt.rna), low 13 bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo + (what lo's rounding drops, at most 2^-22 |x|): the two TF32
// operands of x in a 3xTF32 product, lo formed from the rounded hi
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// One wgmma.mma_async m64nNk8, tf32 x tf32 -> f32: A from registers (the
// fragment of m64nNk8: lane l of warp w holds rows 16w + l/4 (+8), columns
// l%4 (+4) as a[0] (row), a[1] (row + 8), a[2] (column + 4), a[3] (both)),
// B K-major in shared memory. acc = 0 overwrites d.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgmmaTf32<96> {
  static __device__ __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};


// One K step of 32 f32 of a 3xTF32 product on a consumer warpgroup:
// part[64, BN] = A[64, 32] @ W[BN, 32]^T as lo_A hi_W + hi_A lo_W + hi_A hi_W
// per k8 step, the small terms first. a_tile: the warpgroup's 64 rows of A,
// 128-byte rows written by TMA with the 128-byte swizzle (16-byte chunk c
// of row r at c ^ (r % 8): the 32 lanes of a load hit 32 banks); dhi, dlo:
// descriptors of W's hi and lo tiles. Commits one wgmma group, which reads
// the fragment registers until it completes: the caller waits for it before
// the registers are reused.
// CENTRE: a_sub [K] is subtracted from A's columns before the split; the
// k-tile's columns k0 .. k0 + 31, those from K on read as 0 (A's ragged K
// edge arrives zero-filled, but a_sub past its end may hold a NaN). A
// compile-time switch: the fragment registers that wgmma reads stay
// straight-line code.
template <int BN, bool CENTRE>
__device__ __forceinline__ void tf32x3_ktile(float (&part)[BN / 2], const unsigned char* a_tile,
                                             uint64_t dhi, uint64_t dlo, const float* a_sub,
                                             int k0, int K) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4, q = lane % 4, sw = lane / 4;  // sw = r % 8
  // the thread's 8 columns of the k-tile: chunk c holds columns 4c .. 4c + 3
  float sub[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int k = k0 + 4 * c + q;
    sub[c] = CENTRE && k < K ? __ldg(a_sub + k) : 0.0f;
  }
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 8 * (i & 1), chunk = 2 * s + (i >> 1);
      float x = *reinterpret_cast<const float*>(a_tile + row * ROW_BYTES +
                                                ((chunk ^ sw) << 4) + 4 * q);
      if constexpr (CENTRE) x -= sub[chunk];
      split_tf32(x, hi[s][i], lo[s][i]);
    }
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // +32 bytes along K per k8 step (the descriptor counts 16-byte units);
    // the k-tile's first product overwrites part
    WgmmaTf32<BN>::mma(part, lo[s], dhi + 2 * s, s != 0);
    WgmmaTf32<BN>::mma(part, hi[s], dlo + 2 * s, 1);
    WgmmaTf32<BN>::mma(part, hi[s], dhi + 2 * s, 1);
  }
  wgmma_commit();
}

// The consumer side of one output tile's K loop over the ring, shared by
// the GEMM and K1's DFT (logmel.cu): acc[64, BN] = A @ W^T for the
// warpgroup's 64 rows (a_off bytes into each A tile). Stage s holds A at
// a_ring + s A_BYTES and W at w_ring + s W_BYTES (3xTF32: hi, then lo
// BN rows later). Lane 0 of each warp releases a stage once its products
// are done; `stage` and `phase` carry over to the next tile. 3xTF32 with
// CENTRE: a_sub [K] is subtracted from A's columns (tf32x3_ktile).
template <bool X3, int BN, int STAGES, int W_BYTES, bool CENTRE = false>
__device__ __forceinline__ void consume_k_loop(float (&acc)[BN / 2], unsigned char* a_ring,
                                               unsigned char* w_ring, int a_off, uint64_t* full,
                                               uint64_t* empty, int k_tiles, int& stage,
                                               uint32_t& phase, const float* a_sub = nullptr,
                                               int K = 0) {
  constexpr int A_BYTES = BM * ROW_BYTES;
  const bool signals = threadIdx.x % 32 == 0;
  int reading = -1;  // bf16: the stage the wgmma group in flight reads
  for (int kt = 0; kt < k_tiles; ++kt) {
    mbar_wait(&full[stage], phase);
    unsigned char* w = w_ring + stage * W_BYTES;
    if constexpr (X3) {
      // each k-tile into its own partial sum, added to acc on the CUDA cores
      // (round to nearest): the tensor core's own adds, which do not round
      // to nearest, then run 12 times on a sum of 32 products, not 3 K / 8
      // times on the whole; this keeps the error against float64 near an
      // f32 GEMM's
      float part[BN / 2];
      tf32x3_ktile<BN, CENTRE>(part, a_ring + stage * A_BYTES + a_off, smem_desc(w),
                       smem_desc(w + BN * ROW_BYTES), a_sub, kt * BK_TF32, K);
      wgmma_wait<0>();  // the fragment registers are free, the stage is read
      fence_regs(part);
      if (signals) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = kt ? acc[i] + part[i] : part[i];
    } else {
      const uint64_t da = smem_desc(a_ring + stage * A_BYTES + a_off);
      const uint64_t dw = smem_desc(w);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k) {
        // +32 bytes along K per k16 step (the descriptor counts 16-byte units);
        // the tile's first product overwrites the accumulator
        Wgmma<BN>::mma(acc, da + 2 * k, dw + 2 * k, (kt | k) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's products are done: release its stage
      fence_regs(acc);
      if (reading >= 0 && signals) mbar_arrive(&empty[reading]);
      reading = stage;
    }
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
  if constexpr (!X3) {
    wgmma_wait<0>();
    fence_regs(acc);
    if (signals) mbar_arrive(&empty[reading]);
  }
}

// ---- epilogue: 8 consecutive columns of one row, in 16-byte vectors -----
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void add8(const void* base, size_t i, float (&v)[8]) {
  float r[8];
  load8(reinterpret_cast<const T*>(base) + i, r);
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c] += r[c];
}

// The consumer warpgroup's [64, BN] accumulator to C, through its staging
// buffer in shared memory. Fragment layout of wgmma m64nN (f32): lane l
// of warp w holds d[4j + 2h + e] at row 16w + l/4 + 8h, column
// 8j + 2(l%4) + e. Written as is, then read back 8 consecutive columns a
// thread, consecutive threads along a row, so bias, residuals and the
// output move in coalesced 16-byte vectors.
template <int BN, typename OutT, typename R1T, typename R2T>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], float* stage, OutT* C,
                                           int M, int N, int m0, int n0, const Epilogue& e,
                                           int barrier) {
  constexpr int LDS = Tiles<BN>::LDS, CHUNKS = BN / 8;
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = 16 * (t / 32) + lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(stage + r * LDS + 8 * j + c) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (r + 8) * LDS + 8 * j + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  warpgroup_sync(barrier);
#pragma unroll 4
  for (int i = t; i < 64 * CHUNKS; i += 128) {
    const int row = i / CHUNKS, col = 8 * (i % CHUNKS);
    const int m = m0 + row, n = n0 + col;
    if (m >= M || n >= N) continue;  // N % 8 == 0: a chunk lies wholly inside or outside
    float v[8];
    load8(stage + row * LDS + col, v);
    if (e.bias) {
      float b[8];
      load8(e.bias + n, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] += b[k];
    }
    if (e.col_scale) {
      float sc[8];
      load8(e.col_scale + n, sc);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] *= sc[k];
    }
    if (e.gelu) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = gelu_erf(v[k]);
    }
    const size_t at = (size_t)m * N + n;
    if (e.r1) add8<R1T>(e.r1, at, v);
    if (e.r2) add8<R2T>(e.r2, at, v);
    store8(C + at, v);
  }
  warpgroup_sync(barrier);  // the buffer is free for the next tile
}

// The GEMM on one block: X3 selects 3xTF32 (f32 A, less a_sub with CENTRE;
// W's hi map tma_w and lo map *tma_w_lo) over bf16 (A and W bf16; tma_w_lo
// and a_sub unused).
template <bool X3, int BN, typename OutT, typename R1T, typename R2T, bool CENTRE = false>
__device__ __forceinline__ void gemm_body(const CUtensorMap& tma_a, const CUtensorMap& tma_w,
                                          const CUtensorMap* tma_w_lo, OutT* C, int M, int N,
                                          int K, const Epilogue& e, const float* a_sub) {
  using T = Tiles<BN, X3 ? 2 : 1>;
  constexpr int KB = X3 ? BK_TF32 : BK;  // elements a K step
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* a_ring = smem;
  unsigned char* w_ring = smem + T::STAGES * T::A_BYTES;
  float* staging = reinterpret_cast<float*>(w_ring + T::STAGES * T::W_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * 64 * T::LDS);
  uint64_t* empty = full + T::STAGES;

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles, k_tiles = (K + KB - 1) / KB;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], T::STAGE_BYTES);
        unsigned char* w = w_ring + stage * T::W_BYTES;
        tma_load(a_ring + stage * T::A_BYTES, &tma_a, &full[stage], kt * KB, m0);
        tma_load(w, &tma_w, &full[stage], kt * KB, n0);
        if constexpr (X3) tma_load(w + BN * ROW_BYTES, tma_w_lo, &full[stage], kt * KB, n0);
        if (++stage == T::STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows 64 (wg - 1) .. of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  const int a_off = (wg - 1) * 64 * ROW_BYTES;
  float* stage_out = staging + (wg - 1) * 64 * T::LDS;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_tiles) * BM, n0 = (t % n_tiles) * BN;
    consume_k_loop<X3, BN, T::STAGES, T::W_BYTES, CENTRE>(acc, a_ring, w_ring, a_off, full,
                                                          empty, k_tiles, stage, phase, a_sub, K);
    store_tile<BN, OutT, R1T, R2T>(acc, stage_out, C, M, N, m0 + 64 * (wg - 1), n0, e, wg);
  }
}

template <int BN, typename OutT, typename R1T, typename R2T>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_w, OutT* __restrict__ C, int M, int N,
                int K, Epilogue e) {
  gemm_body<false, BN, OutT, R1T, R2T>(tma_a, tma_w, nullptr, C, M, N, K, e, nullptr);
}

template <int BN, typename OutT, typename R1T, typename R2T, bool CENTRE>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap tma_a,
                       const __grid_constant__ CUtensorMap tma_hi,
                       const __grid_constant__ CUtensorMap tma_lo, OutT* __restrict__ C, int M,
                       int N, int K, Epilogue e, const float* __restrict__ a_sub) {
  gemm_body<true, BN, OutT, R1T, R2T, CENTRE>(tma_a, tma_hi, &tma_lo, C, M, N, K, e, a_sub);
}

// ---- host side -----------------------------------------------------------
typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave,
                                         CUtensorMapSwizzle, CUtensorMapL2promotion,
                                         CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process has loaded (no -lcuda)
static inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<TensorMapEncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// [rows, cols] row-major, boxes of [box_rows, box_cols]; out-of-bounds
// elements read as zero and are not written
static inline bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                              int box_cols, int bf16, CUtensorMapSwizzle swizzle) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (bf16 ? 2 : 4)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The largest BN that divides N and still gives every SM a tile; else the
// dividing one with the most tiles; 128 (masked edge) when none divides.
static inline int pick_bn(int M, int N, int sms) {
  int best = 0, best_tiles = 0;
  const int candidates[3] = {192, 128, 96};
  for (int bn : candidates) {
    if (N % bn) continue;
    const int tiles = ((M + BM - 1) / BM) * (N / bn);
    if (tiles >= sms) return bn;
    if (tiles > best_tiles) best = bn, best_tiles = tiles;
  }
  return best ? best : 128;
}

// Per-device facts asked of the runtime once, not at every launch: a launch
// of the Swin-block sequence is a few tens of microseconds of device time.
constexpr int MAX_DEVICES = 64;

static inline cudaError_t sm_count(int dev, int* sms) {
  static std::atomic<int> counts[MAX_DEVICES];
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    counts[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

// X3: the 3xTF32 kernel, W's hi map tw and lo map *tl, A less a_sub with
// CENTRE; else bf16 (tl and a_sub null)
template <bool X3, int BN, typename OutT, typename R1T, typename R2T, bool CENTRE = false>
static cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap* tl,
                          void* C, int M, int N, int K, const Epilogue& e, int dev, int sms,
                          cudaStream_t s, const float* a_sub = nullptr) {
  constexpr int smem = Tiles<BN, X3 ? 2 : 1>::SMEM;
  const void* kernel;
  if constexpr (X3) {
    kernel = reinterpret_cast<const void*>(gemm_tf32x3_kernel<BN, OutT, R1T, R2T, CENTRE>);
  } else {
    kernel = reinterpret_cast<const void*>(gemm_kernel<BN, OutT, R1T, R2T>);
  }
  static std::atomic<bool> smem_set[MAX_DEVICES];  // per instantiation
  if (!smem_set[dev].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev].store(true, std::memory_order_relaxed);
  }
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sms ? tiles : sms;
  if constexpr (X3) {
    gemm_tf32x3_kernel<BN, OutT, R1T, R2T, CENTRE><<<grid, THREADS, smem, s>>>(
        ta, tw, *tl, static_cast<OutT*>(C), M, N, K, e, a_sub);
  } else {
    gemm_kernel<BN, OutT, R1T, R2T><<<grid, THREADS, smem, s>>>(ta, tw, static_cast<OutT*>(C), M,
                                                                N, K, e);
  }
  return cudaGetLastError();
}

template <int BN, typename OutT>
static cudaError_t launch_typed(const CUtensorMap& ta, const CUtensorMap& tw, void* C, int M,
                                int N, int K, const Epilogue& e, int r1_bf16, int r2_bf16,
                                int dev, int sms, cudaStream_t s) {
  using B = __nv_bfloat16;
  if (r1_bf16) {
    return r2_bf16 ? launch<false, BN, OutT, B, B>(ta, tw, nullptr, C, M, N, K, e, dev, sms, s)
                   : launch<false, BN, OutT, B, float>(ta, tw, nullptr, C, M, N, K, e, dev, sms,
                                                       s);
  }
  return r2_bf16 ? launch<false, BN, OutT, float, B>(ta, tw, nullptr, C, M, N, K, e, dev, sms, s)
                 : launch<false, BN, OutT, float, float>(ta, tw, nullptr, C, M, N, K, e, dev,
                                                         sms, s);
}

template <int BN>
static cudaError_t launch_bn(const CUtensorMap& ta, const CUtensorMap& tw, void* C, int c_bf16,
                             int M, int N, int K, const Epilogue& e, int r1_bf16, int r2_bf16,
                             int dev, int sms, cudaStream_t s) {
  return c_bf16 ? launch_typed<BN, __nv_bfloat16>(ta, tw, C, M, N, K, e, r1_bf16, r2_bf16, dev,
                                                  sms, s)
                : launch_typed<BN, float>(ta, tw, C, M, N, K, e, r1_bf16, r2_bf16, dev, sms, s);
}

// the 3xTF32 GEMM writes f32 and adds an f32 r1; r2 may be bf16 (the
// block input x: the double FFN's, the golden proj's residual, the
// ResiDual's). With a_sub (the ResiDual's first product) both residuals
// are f32.
template <int BN>
static cudaError_t launch_tf32x3(const CUtensorMap& ta, const CUtensorMap& th,
                                 const CUtensorMap& tl, void* C, int M, int N, int K,
                                 const Epilogue& e, int r2_bf16, const float* a_sub, int dev,
                                 int sms, cudaStream_t s) {
  using B = __nv_bfloat16;
  if (a_sub) {
    if (r2_bf16) return cudaErrorInvalidValue;
    return launch<true, BN, float, float, float, true>(ta, th, &tl, C, M, N, K, e, dev, sms, s,
                                                       a_sub);
  }
  return r2_bf16 ? launch<true, BN, float, float, B>(ta, th, &tl, C, M, N, K, e, dev, sms, s)
                 : launch<true, BN, float, float, float>(ta, th, &tl, C, M, N, K, e, dev, sms, s);
}

// A 3xTF32 plan is this build's: BN 32, 64, 96 or 128, and the ring depth
// Tiles gives it (the wrapper computes both, ops/cuda/tf32x3.py::gemm_plan)
static inline bool tf32x3_plan_ok(int bn, int stages) {
  switch (bn) {
    case 32:
      return stages == Tiles<32, 2>::STAGES;
    case 64:
      return stages == Tiles<64, 2>::STAGES;
    case 96:
      return stages == Tiles<96, 2>::STAGES;
    case 128:
      return stages == Tiles<128, 2>::STAGES;
    default:
      return false;
  }
}

}  // namespace sm90

// C [M, N] (bf16 if c_bf16, else f32) = epi(A [M, K] @ W [N, K]^T), bf16
// operands. K and N multiples of 8, pointers 16-byte aligned. Enqueues on `s`.
static inline cudaError_t gemm_bf16(const __nv_bfloat16* A, const __nv_bfloat16* W, void* C,
                                    int c_bf16, int M, int N, int K, const Epilogue& e,
                                    int r1_bf16, int r2_bf16, cudaStream_t s) {
  using namespace sm90;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8) return cudaErrorInvalidValue;
  const void* pointers[7] = {A, W, C, e.bias, e.col_scale, e.r1, e.r2};
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  const int bn = pick_bn(M, N, sms);
  CUtensorMap ta, tw;
  if (!encode_map(&ta, A, M, K, BM, BK, 1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tw, W, N, K, bn, BK, 1, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  switch (bn) {
    case 96:
      return launch_bn<96>(ta, tw, C, c_bf16, M, N, K, e, r1_bf16, r2_bf16, dev, sms, s);
    case 192:
      return launch_bn<192>(ta, tw, C, c_bf16, M, N, K, e, r1_bf16, r2_bf16, dev, sms, s);
    default:
      return launch_bn<128>(ta, tw, C, c_bf16, M, N, K, e, r1_bf16, r2_bf16, dev, sms, s);
  }
}

// A weight W [N, K] f32 as the 3xTF32 GEMM takes it: hi = W rounded to
// TF32 and lo = W - hi, made once per weight version, and the plan of the
// product it takes part in (N tile bn, ring stages).
struct Tf32x3Weight {
  const float* hi;
  const float* lo;
  int bn;
  int stages;
};

// C [M, N] f32 = epi((A [M, K] f32 - a_sub) @ W^T) in 3xTF32, W split as `w`
// says; a_sub [K] or null. K a multiple of 4 (16-byte TMA rows), N of 8; r1
// f32, r2 f32 or bf16 (r2_bf16; f32 with a_sub); pointers but a_sub 16-byte
// aligned. Enqueues on `s`.
static inline cudaError_t gemm_tf32x3(const float* A, const Tf32x3Weight& w, float* C, int M,
                                      int N, int K, const Epilogue& e, int r2_bf16,
                                      cudaStream_t s, const float* a_sub = nullptr) {
  using namespace sm90;
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || N % 8 || !tf32x3_plan_ok(w.bn, w.stages)) {
    return cudaErrorInvalidValue;
  }
  const void* pointers[8] = {A, w.hi, w.lo, C, e.bias, e.col_scale, e.r1, e.r2};
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, th, tl;
  if (!encode_map(&ta, A, M, K, BM, BK_TF32, 0, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&th, w.hi, N, K, w.bn, BK_TF32, 0, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tl, w.lo, N, K, w.bn, BK_TF32, 0, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  switch (w.bn) {
    case 32:
      return launch_tf32x3<32>(ta, th, tl, C, M, N, K, e, r2_bf16, a_sub, dev, sms, s);
    case 64:
      return launch_tf32x3<64>(ta, th, tl, C, M, N, K, e, r2_bf16, a_sub, dev, sms, s);
    case 96:
      return launch_tf32x3<96>(ta, th, tl, C, M, N, K, e, r2_bf16, a_sub, dev, sms, s);
    default:
      return launch_tf32x3<128>(ta, th, tl, C, M, N, K, e, r2_bf16, a_sub, dev, sms, s);
  }
}

}  // namespace arpu
