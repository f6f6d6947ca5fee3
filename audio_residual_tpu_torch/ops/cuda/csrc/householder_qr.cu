// Householder QR panel of a batch of tall float64 blocks: the panel step of
// ops/cuda/qr.py::householder_qr, a blocked right-looking Householder QR in
// compact-WY form (the trailing updates and forming Q are batched float64
// products in the wrapper, cuBLAS on the float64 tensor cores).
//
// Replaces no TPU kernel. The JAX package orthonormalises the randomized PCA
// finalize's subspace block by a Gram matrix clamped at 1e-6 of its largest
// eigenvalue (audio_residual_tpu/ops/pca.py:161), which loses the
// directions under 1e-3 of the first eigenvalue; the port keeps Householder.
// The library's batched QR runs the unblocked geqr2 on these shapes, one
// pass over the whole trailing block in device memory a column.
//
// One launch factors the [rows, w] panel (w <= 32) of every batch entry: a
// cluster of `ctas` blocks (at most 8, a portable cluster) a panel, block q
// holding panel rows [q * rows_per_cta, (q + 1) * rows_per_cta). The kernel
// comes in widths W = 32, 16, ..., 1, the least power of two >= w (a
// narrower panel is zero-padded to W columns): a thread holds 64 entries in
// registers, 64 / W rows of W columns, from the load to the write-out, so a
// block holds 16384 / W rows (512 at W = 32) and a cluster 131072 / W; no
// column step touches device memory or moves the panel through shared
// memory. Block 0 holds the w diagonal rows (rows_per_cta >= w). A column
// step c, unrolled:
//   1. each thread: the dots of its rows below the diagonal, entry c times
//      every entry; a warp sums them by a butterfly that leaves column k's
//      sum on the lanes k mod W, the warps through shared memory; warp 0
//      pushes the block's sums, and block 0 row c, into every block of the
//      cluster (distributed shared memory);
//   2. one cluster barrier; warp 0 of each block sums the blocks' dots
//      (s_k = sum_{r > c} a_rc a_rk) in rank order, so every block computes
//      the same scalars: alpha = a_cc, ||x||^2 = s_c, beta, tau and
//      1 / (alpha - beta) as LAPACK's dlarfg, and for every other column
//      y_k = a_ck + s_k / (alpha - beta), which is v_c^T a_k for k > c (the
//      reflector's update, w_k = tau y_k) and v_k^T v_c for k < c (kept for
//      T);
//   3. each thread: entry c of its rows becomes v_c's (beta on the
//      diagonal), the entries right of c lose v_c w_k.
// Rows at and above the diagonal keep R, so the panel ends as LAPACK's geqrf
// leaves it. Written out through a per-warp staging tile (coalesced rows):
// V explicit (zero above the diagonal, one on it), R's upper triangle into
// the panel's top w rows, and the w x w upper triangular T (zero below the
// diagonal), its columns T[:c, c] = -tau_c T[:c, :c] y_c[:c] in block 0's
// first warp after the last step, a row a lane.
//
// Bound: latency. A column step is a chain of the dots (64 float64 FMAs a
// thread), the warp butterfly, the pushes and one cluster barrier, a square
// root and two divisions, and the update (up to 64 FMAs a thread); the
// panel's bytes cross device memory once each way.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace arpu {
namespace qr {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEntries = 64;                 // panel entries a thread holds
constexpr int kMaxW = 32;                    // the widest panel
constexpr int kMaxCtas = 8;                  // a portable cluster
constexpr unsigned kFull = 0xffffffffu;

struct Slot {                    // what a column step publishes, pushed into every block
  double part[kMaxCtas][kMaxW];  // block q's s_k
  double row[kMaxW];             // row c before the step (from block 0)
};

struct Shared {
  Slot slot[2];                  // by column parity: one barrier a step suffices
  double red[kWarps][kMaxW];
  double w[kMaxW];               // tau * y_k of this step
  double y[kMaxW][kMaxW];        // y of every step, for T after the last
  double tau[kMaxW];
  double scale, beta;
  double stage[kWarps][32][kMaxW + 1];  // a warp's 32 rows on their way in or out
};

// one stage of the warp's reduce-scatter: lanes with bit OFF keep the upper
// half of their 2*OFF sums, the others the lower half, each adding its
// partner's copy
template <int OFF, int N>
__device__ __forceinline__ void butterfly(double (&s)[N], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    s[k] = (up ? s[k + OFF] : s[k]) + __shfl_xor_sync(kFull, up ? s[k] : s[k + OFF], OFF);
  }
}

// the stages OFF, OFF / 2, ..., 1: column k's sum over each group of
// 2 * OFF lanes, on the lanes whose low bits are k's
template <int OFF, int N>
__device__ __forceinline__ void reduce_scatter(double (&s)[N], int lane) {
  if constexpr (OFF >= 1) {
    butterfly<OFF>(s, lane);
    reduce_scatter<OFF / 2>(s, lane);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 1) householder_panel_kernel(
    double* __restrict__ a, double* __restrict__ v, double* __restrict__ t, int batch_stride,
    int ld, int rows, int w, int rows_per_cta, int t_batch_stride, int t_ld) {
  constexpr int R = kEntries / W;            // rows a thread holds
  constexpr int N = W == 32 ? 16 : W;        // a lane's sums after the dots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared* sh = reinterpret_cast<Shared*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = rank * rows_per_cta;
  const int nrows = max(0, min(rows_per_cta, rows - row0));
  const size_t base = static_cast<size_t>(blockIdx.y) * batch_stride;
  double (*st)[kMaxW + 1] = sh->stage[warp];

  // this thread's rows: local j * 256 + warp * 32 + lane, j < R
  double p[R][W];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int first = j * kThreads + warp * 32;
    for (int e = lane; e < 32 * W; e += 32) {
      const int i = e / W, k = e % W, r = first + i;
      st[i][k] = r < nrows && k < w ? a[base + static_cast<size_t>(row0 + r) * ld + k] : 0.0;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < W; ++k) p[j][k] = st[lane][k];
    __syncwarp();
  }
  const int g0 = row0 + warp * 32 + lane;  // panel rows; g0 + 256 > every diagonal row
  cluster.sync();  // every block resident before a remote write

#pragma unroll
  for (int c = 0; c < W; ++c) {
    if (c >= w) break;
    // 1. the dots of rows below the diagonal; column k's warp sum on lanes k mod W
    double x[R];
#pragma unroll
    for (int j = 0; j < R; ++j) x[j] = j == 0 && g0 <= c ? 0.0 : p[j][c];
    double s[N];
    if constexpr (W == 32) {
      const bool up16 = lane & 16;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        double lo = 0.0, hi = 0.0;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          lo = fma(x[j], p[j][k], lo);
          hi = fma(x[j], p[j][k + 16], hi);
        }
        s[k] = (up16 ? hi : lo) + __shfl_xor_sync(kFull, up16 ? lo : hi, 16);
      }
      reduce_scatter<8>(s, lane);
    } else {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        double acc = 0.0;
#pragma unroll
        for (int j = 0; j < R; ++j) acc = fma(x[j], p[j][k], acc);
        s[k] = acc;
      }
      reduce_scatter<W / 2>(s, lane);
#pragma unroll
      for (int off = W; off < 32; off *= 2) s[0] += __shfl_xor_sync(kFull, s[0], off);
    }
    sh->red[warp][lane] = s[0];
    Slot& slot = sh->slot[c & 1];
    if (g0 == c) {
#pragma unroll
      for (int k = 0; k < W; ++k) slot.row[k] = p[0][k];
    }
    __syncthreads();
    if (warp == 0) {  // this block's sums, and block 0's row c, into every block
      double sum = 0.0;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) sum += sh->red[q][lane];
      const double row = lane < W ? slot.row[lane] : 0.0;
      for (int q = 0; q < ctas; ++q) {
        Slot* dst = cluster.map_shared_rank(&slot, q);
        dst->part[rank][lane] = sum;
        if (rank == 0) dst->row[lane] = row;
      }
    }
    cluster.sync();

    // 2. the step's scalars, the same in every block
    if (warp == 0) {
      double part[kMaxCtas];
#pragma unroll
      for (int q = 0; q < kMaxCtas; ++q) part[q] = q < ctas ? slot.part[q][lane] : 0.0;
      double sum = 0.0;
#pragma unroll
      for (int q = 0; q < kMaxCtas; ++q) sum += part[q];
      const double rho = slot.row[lane];
      const double alpha = __shfl_sync(kFull, rho, c);
      const double xnorm2 = __shfl_sync(kFull, sum, c);
      double beta = alpha, tau = 0.0, scale = 0.0;  // x = 0: H = I
      if (xnorm2 != 0.0) {
        beta = -copysign(sqrt(fma(alpha, alpha, xnorm2)), alpha);
        tau = (beta - alpha) / beta;
        scale = 1.0 / (alpha - beta);
      }
      const double y = fma(sum, scale, rho);
      sh->w[lane] = tau * y;
      sh->y[c][lane] = y;
      if (lane == 0) {
        sh->scale = scale;
        sh->beta = beta;
        sh->tau[c] = tau;
      }
    }
    __syncthreads();

    // 3. v_c into column c, the reflector applied to the columns right of it
    const double scale = sh->scale;
    double vc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) vc[j] = j == 0 && g0 == c ? 1.0 : x[j] * scale;
#pragma unroll
    for (int k = c + 1; k < W; ++k) {
      const double wk = sh->w[k];
#pragma unroll
      for (int j = 0; j < R; ++j) p[j][k] = fma(-vc[j], wk, p[j][k]);
    }
    if (g0 >= c) p[0][c] = g0 == c ? sh->beta : vc[0];
#pragma unroll
    for (int j = 1; j < R; ++j) p[j][c] = vc[j];
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int k = 0; k < W; ++k) st[lane][k] = p[j][k];
    __syncwarp();
    const int first = j * kThreads + warp * 32;
    for (int e = lane; e < 32 * W; e += 32) {
      const int i = e / W, k = e % W, r = first + i, g = row0 + r;
      if (r < nrows && k < w) {
        const size_t at = base + static_cast<size_t>(g) * ld + k;
        const double val = st[i][k];
        v[at] = g > k ? val : (g == k ? 1.0 : 0.0);
        if (g <= k) a[at] = val;
      }
    }
    __syncwarp();
  }
  if (rank == 0 && warp == 0) {
    // T, lane i its row i: T[:c, c] = -tau_c T[:c, :c] y_c[:c], y_c[l] = v_l^T v_c
    double trow[W];
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (c >= w) break;
      double even = 0.0, odd = 0.0;
#pragma unroll
      for (int l = 0; l + 1 < c; l += 2) {
        even = fma(trow[l], sh->y[c][l], even);
        odd = fma(trow[l + 1], sh->y[c][l + 1], odd);
      }
      if (c % 2) even = fma(trow[c - 1], sh->y[c][c - 1], even);
      const double tau = sh->tau[c];
      trow[c] = lane < c ? -tau * (even + odd) : (lane == c ? tau : 0.0);
    }
    if (lane < w) {
      const size_t tb = static_cast<size_t>(blockIdx.y) * t_batch_stride +
                        static_cast<size_t>(lane) * t_ld;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k < w) t[tb + k] = trow[k];
      }
    }
  }
  cluster.sync();  // no block leaves while another may write its slots
}

template <int W>
cudaError_t launch_panel(double* a, double* v, double* t, int batch, int batch_stride, int ld,
                         int rows, int w, int ctas, int rows_per_cta, int t_batch_stride,
                         int t_ld, cudaStream_t stream) {
  if (rows_per_cta > kThreads * kEntries / W) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(Shared));
  cudaError_t err = cudaFuncSetAttribute(householder_panel_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, householder_panel_kernel<W>, a, v, t, batch_stride, ld, rows,
                           w, rows_per_cta, t_batch_stride, t_ld);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace qr
}  // namespace arpu

extern "C" const char* arpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Factor the [rows, w] panel at `a` of each of `batch` entries (entry b at
// a + b * batch_stride, rows `ld` apart); V to the same places of `v`, T
// [w, w] of entry b to t + b * t_batch_stride, rows t_ld apart. The row
// split (ops/cuda/qr.py::panel_split): `ctas` blocks a cluster of
// rows_per_cta rows each, w <= rows_per_cta <= 16384 / W, W the least power
// of two >= w. Returns 0 or a CUDA error.
extern "C" int arpu_householder_panel(double* a, double* v, double* t, int batch,
                                      int batch_stride, int ld, int rows, int w, int ctas,
                                      int rows_per_cta, int t_batch_stride, int t_ld,
                                      void* stream) {
  using namespace arpu::qr;
  if (w < 1 || w > kMaxW || ctas < 1 || ctas > kMaxCtas || rows_per_cta < w ||
      static_cast<long long>(ctas) * rows_per_cta < rows || rows < w || ld < w || batch < 1 ||
      batch > 65535 || t_ld < w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w > 16) {
    err = launch_panel<32>(a, v, t, batch, batch_stride, ld, rows, w, ctas, rows_per_cta,
                           t_batch_stride, t_ld, s);
  } else if (w > 8) {
    err = launch_panel<16>(a, v, t, batch, batch_stride, ld, rows, w, ctas, rows_per_cta,
                           t_batch_stride, t_ld, s);
  } else if (w > 4) {
    err = launch_panel<8>(a, v, t, batch, batch_stride, ld, rows, w, ctas, rows_per_cta,
                          t_batch_stride, t_ld, s);
  } else if (w > 2) {
    err = launch_panel<4>(a, v, t, batch, batch_stride, ld, rows, w, ctas, rows_per_cta,
                          t_batch_stride, t_ld, s);
  } else if (w > 1) {
    err = launch_panel<2>(a, v, t, batch, batch_stride, ld, rows, w, ctas, rows_per_cta,
                          t_batch_stride, t_ld, s);
  } else {
    err = launch_panel<1>(a, v, t, batch, batch_stride, ld, rows, w, ctas, rows_per_cta,
                          t_batch_stride, t_ld, s);
  }
  return static_cast<int>(err);
}
