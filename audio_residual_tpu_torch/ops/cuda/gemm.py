"""The bf16 tensor-core GEMM of the Swin-block kernels (``csrc/gemm_sm90.cuh``).

``C = epi(A @ W^T)``: ``A [M, K]`` and ``W [N, K]`` (``nn.Linear`` layout)
in bf16, f32 accumulate, then in this order ``+ bias[n]``,
``* col_scale[n]``, exact GELU, ``+ r1[m, n]``, ``+ r2[m, n]`` (each
optional), stored as f32 or bf16. It is the AMP GEMM that K2-K5 run inside
their launch sequences (TMA loads into a ring of shared-memory stages,
``wgmma`` from shared memory, persistent grid); this wrapper calls it alone,
for its tests and ``chip_smoke.py``'s ``[gemm]`` phase. It replaces no TPU
kernel by itself: on the TPU the same products are the MXU dots inside the
Pallas block kernels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops.cuda import build, launch_counts

__all__ = ["gemm", "gemm_plain"]


def gemm_plain(a, w, bias=None, col_scale=None, gelu: bool = False, r1=None, r2=None,
               out_dtype=torch.float32) -> torch.Tensor:
    """Plain version: an f32 matmul of the bf16 operands, then the epilogue."""
    v = a.float() @ w.float().t()
    if bias is not None:
        v = v + bias
    if col_scale is not None:
        v = v * col_scale
    if gelu:
        v = F.gelu(v)
    if r1 is not None:
        v = v + r1.float()
    if r2 is not None:
        v = v + r2.float()
    return v.to(out_dtype)


def gemm(a, w, bias=None, col_scale=None, gelu: bool = False, r1=None, r2=None,
         out_dtype=torch.float32) -> torch.Tensor:
    """``a [M, K]``, ``w [N, K]`` bf16 -> ``[M, N]`` in ``out_dtype``. CPU
    tensors take :func:`gemm_plain`; on the card K and N must be multiples
    of 8."""
    if a.device.type == "cpu":
        return gemm_plain(a, w, bias, col_scale, gelu, r1, r2, out_dtype)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"gemm: a must be [M, K] and w [N, K], got {tuple(a.shape)}, "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"gemm: K={k} and N={n} must be multiples of 8 (16-byte TMA rows, "
                         "8-column epilogue vectors)")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"gemm: a and w must be bf16, got {a.dtype}, {w.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm: out_dtype must be float32 or bfloat16, got {out_dtype}")
    for name, t in (("bias", bias), ("col_scale", col_scale)):
        if t is not None and tuple(t.shape) != (n,):
            raise ValueError(f"gemm: {name} must be [{n}], got {tuple(t.shape)}")
    for name, t in (("r1", r1), ("r2", r2)):
        if t is not None and tuple(t.shape) != (m, n):
            raise ValueError(f"gemm: {name} must be [{m}, {n}], got {tuple(t.shape)}")
    build.check_cuda_inputs("gemm", {"a": a, "w": w, "bias": bias, "col_scale": col_scale,
                                     "r1": r1, "r2": r2}, float_only=("bias", "col_scale"))
    out = torch.empty(m, n, device=a.device, dtype=out_dtype)
    fn = build.bind("gemm", "arpu_gemm", "pppi" "iii" "ppi" "pipi" "p")
    rc = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16), m, n, k,
            build.ptr(bias), build.ptr(col_scale), int(bool(gelu)),
            build.ptr(r1), int(r1 is not None and r1.dtype == torch.bfloat16),
            build.ptr(r2), int(r2 is not None and r2.dtype == torch.bfloat16),
            build.stream_of(a))
    build.check("gemm", rc, "gemm")
    launch_counts["gemm"] += 1
    return out
