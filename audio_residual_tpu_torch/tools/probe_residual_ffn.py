"""Split K3's AMP kernel (``ffn_cluster_kernel``, ``csrc/ln_mlp.cu``) into its
phases on the card, at HTSAT-tiny and HTSAT-base layer 3 (B=32: 2048 rows,
C = 768 and 1024):

    python3 audio_residual_tpu_torch/tools/probe_residual_ffn.py [ROOT]

It copies the port under ROOT (default: this checkout) to
``build/probe_residual_ffn/`` (gitignored), adds device-side stamps to the
copy's kernel -- ``clock64`` at each phase boundary of consumer warpgroup 0
of every block, ``%globaltimer`` at its start and end -- builds and runs it,
and prints the medians over blocks: LN2 prologue, the cluster barrier after
it, per hidden chunk fc1, the exchange (slot written and pushed), the wait
for the peers' slots and fc2, and the epilogue. It also prints how many
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``) and how
many blocks started late, a second wave. Phase durations assume the SM clock
``nvidia-smi`` reports as its maximum. Exits non-zero when an anchor of the
instrumentation is no longer in the kernel source.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
STAMPS = 64  # stamp slots a block

HELPERS = '''__device__ unsigned long long g_stamps[2048 * 64];
__device__ __forceinline__ unsigned long long probe_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE(e) \\
  if (threadIdx.x == 128) g_stamps[blockIdx.x * 64 + (e)] = clock64();

'''
EXPORTS = '''
extern "C" int arpu_probe_stamps(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, arpu::ffn::g_stamps, (size_t)n * 8);
}

template <int NO>
static int max_clusters(int cs, int smem) {
  const auto k = arpu::ffn::ffn_cluster_kernel<NO>;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       arpu::sm90::SMEM_LIMIT);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16 * cs);
  cfg.blockDim = dim3(arpu::sm90::THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int arpu_probe_max_clusters(int cs, int smem, int n_out) {
  return n_out == 96 ? max_clusters<96>(cs, smem) : max_clusters<128>(cs, smem);
}
'''
# (anchor in ln_mlp.cu, text inserted before it, text inserted after it)
EDITS = [
    ("__device__ __forceinline__ void cluster_sync() {", HELPERS, ""),
    ("  // prologue: LN2 of this block's 128 / CS rows of the tile into z\n",
     "  if (threadIdx.x == 128) {\n    g_stamps[blockIdx.x * 64 + 62] = probe_gtime();\n"
     "    g_stamps[blockIdx.x * 64 + 60] = clock64();\n  }\n", ""),
    ("  cluster_sync();  // z and every block's barriers are ready\n", "PROBE(59)\n", "PROBE(1)\n"),
    ("    reading = -1;\n", "", "    PROBE(2 + 4 * t)\n"),
    ("    mbar_wait_or_trap(hid_full, t & 1);\n", "    PROBE(3 + 4 * t)\n", "    PROBE(4 + 4 * t)\n"),
    ("    if (t + 1 < chunks) {", "    PROBE(5 + 4 * t)\n", ""),
    ("  cluster_sync();\n}\n\nstatic bool plan_ok",
     "  PROBE(61)\n  if (threadIdx.x == 128) g_stamps[blockIdx.x * 64 + 63] = probe_gtime();\n", ""),
]


def instrumented_copy(root: Path) -> Path:
    dst = HERE.parents[2] / "build" / "probe_residual_ffn"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "audio_residual_tpu_torch", dst / "audio_residual_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dst / "audio_residual_tpu_torch" / "ops" / "cuda" / "csrc" / "ln_mlp.cu"
    text = src.read_text()
    for anchor, before, after in EDITS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in ln_mlp.cu: {anchor!r}")
        text = text.replace(anchor, before + anchor + after)
    src.write_text(text + EXPORTS)
    return dst


def run_one(root: str, mhz: float) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from audio_residual_tpu_torch.ops.cuda import build
    from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3

    rng = np.random.default_rng(0)

    def t(*shape, scale, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).cuda()

    for c in (768, 1024):
        rows = 2048
        plan = k3.amp_plan(rows, c, 4 * c)
        clusters = build.bind("ln_mlp", "arpu_probe_max_clusters", "iii")(
            plan.cs, plan.smem_bytes, plan.n_out)
        x, a = t(rows, c, scale=0.5), t(rows, c, scale=0.1)
        w = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(4 * c, c, scale=0.02),
             t(4 * c, scale=0.02), t(c, 4 * c, scale=0.02), t(c, scale=0.02))
        with torch.no_grad():
            for _ in range(3):
                k3.fused_residual_ffn(x, a, *w, mxu_dtype=torch.bfloat16)
            torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (plan.grid * STAMPS))()
        build.check("ln_mlp", build.bind("ln_mlp", "arpu_probe_stamps", "pi")(
            buf, plan.grid * STAMPS), "stamps")
        st = np.frombuffer(buf, dtype=np.uint64).reshape(plan.grid, STAMPS).astype(np.int64)
        start = (st[:, 62] - st[:, 62].min()) / 1e3
        end = (st[:, 63] - st[:, 62].min()) / 1e3
        us = 1.0 / mhz  # a clock64 tick in microseconds

        def med(col_a, col_b):
            return float(np.median((st[:, col_b] - st[:, col_a]) * us))

        chunks = 4 * c // plan.chunk
        print(f"C={c} {plan}: max active clusters {clusters}; block start 0-{start.max():.1f} us, "
              f"end {end.min():.1f}-{end.max():.1f} us; {int((start > 5).sum())} blocks started "
              f"> 5 us late", flush=True)
        last = 5 + 4 * (chunks - 1)
        print(f"  median us: LN2 {med(60, 59):.2f}, cluster barrier {med(59, 1):.2f}, "
              f"chunks {med(1, last):.2f}, epilogue {med(last, 61):.2f}, block {med(60, 61):.2f}")
        for tt in range(chunks):
            prev = 1 if tt == 0 else 5 + 4 * (tt - 1)
            e = 2 + 4 * tt
            print(f"  chunk {tt}: fc1 {med(prev, e):.2f}, exchange {med(e, e + 1):.2f}, "
                  f"wait for peers {med(e + 1, e + 2):.2f}, fc2 {med(e + 2, e + 3):.2f}")


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        run_one(argv[1], float(argv[2]))
        return 0
    root = Path(argv[0] if argv else HERE.parents[2]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    mhz = float(smi.stdout.strip().splitlines()[0].split(",")[-1])
    copy = instrumented_copy(root)
    return subprocess.run([sys.executable, str(HERE), "--one", str(copy), str(mhz)]).returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
