"""The tensor-core GEMM of the Swin-block kernels (``csrc/gemm_sm90.cuh``).

``C = epi(A @ W^T)``: ``A [M, K]`` and ``W [N, K]`` (``nn.Linear`` layout),
f32 accumulate, then in this order ``+ bias[n]``, ``* col_scale[n]``, exact
GELU, ``+ r1[m, n]``, ``+ r2[m, n]`` (each optional). Two operand modes:
:func:`gemm`, bf16 operands stored as f32 or bf16, the AMP GEMM that K2-K5
run inside their launch sequences; :func:`gemm_tf32x3`, f32 operands in
3xTF32 (:mod:`.tf32x3`), f32 out, every golden product of K2-K5 and the
ResiDual GEMMs of both modes, with an optional prologue ``a - a_sub[k]``
(the ResiDual centring). Both
are one kernel design (TMA loads into a ring of shared-memory stages,
``wgmma``, persistent grid); these wrappers call it alone, for its tests and
``chip_smoke.py``. It replaces no TPU kernel by itself: on the TPU the same
products are the MXU dots inside the Pallas block kernels. RoBERTa's AMP
dense products call :func:`gemm` directly; in training, where an input
requires grad, it takes :class:`.autograd.Recompute` on :func:`gemm_op` (the
kernel forward, the plain version's backward). RoBERTa's golden dense products on
the card run the 3xTF32 GEMM through :mod:`.linear`, forward and both
gradients (:func:`tf32x3_launch`; the weight gradient reads A transposed
and splits K).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops.cuda import build, launch_counts, tf32x3
from audio_residual_tpu_torch.ops.cuda.autograd import Op, route
from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = ["gemm", "gemm_plain", "gemm_op", "gemm_tf32x3", "gemm_tf32x3_plain"]


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
    """``a [M, K]``, ``w [N, K]`` bf16 -> ``[M, N]`` in ``out_dtype``, routed
    by :func:`.autograd.route`; on the card K and N must be multiples of 8."""
    return route("kernel.gemm", (a, w, bias, col_scale, r1, r2), gemm_plain, _kernel, gemm_op,
                 a, w, bias, col_scale, gelu, r1, r2, out_dtype)


def gemm_op(a, w, bias, col_scale, gelu, r1, r2, out_dtype) -> Op:
    """:func:`gemm`'s :class:`.autograd.Op` on ``(a, w, bias, col_scale, r1,
    r2)``."""
    return Op("recompute.gemm", lambda *t: _kernel(*t[:4], gelu, *t[4:], out_dtype),
              lambda *t: gemm_plain(*t[:4], gelu, *t[4:], out_dtype))


def _kernel(a, w, bias, col_scale, gelu, r1, r2, out_dtype) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, one call, its count."""
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


def gemm_tf32x3_plain(a, w, bias=None, col_scale=None, gelu: bool = False, r1=None, r2=None,
                      a_sub=None):
    """Plain version of :func:`gemm_tf32x3`: ``a - a_sub``, the f32 matmul,
    then the epilogue, in f32."""
    a = a.float() if a_sub is None else a.float() - a_sub
    return gemm_plain(a, w, bias, col_scale, gelu, r1, r2, torch.float32)


def gemm_tf32x3(a, w, bias=None, col_scale=None, gelu: bool = False, r1=None,
                r2=None, a_sub=None) -> torch.Tensor:
    """``(a [M, K] - a_sub [K]) @ w [N, K]^T``, f32, -> ``[M, N]`` f32 in
    3xTF32, ``w`` split once per weight version; ``r2`` f32 or bf16. CPU
    tensors take :func:`gemm_tf32x3_plain`; on the card K must be a
    multiple of 4 and N of 8 (:func:`.tf32x3.gemm_plan`)."""
    with annotate("kernel.gemm_tf32x3"):
        if a.device.type == "cpu":
            return gemm_tf32x3_plain(a, w, bias, col_scale, gelu, r1, r2, a_sub)
        return _tf32x3_kernel(a, w, bias, col_scale, gelu, r1, r2, a_sub)


def _tf32x3_kernel(a, w, bias, col_scale, gelu, r1, r2, a_sub) -> torch.Tensor:
    """The 3xTF32 kernel on CUDA tensors: checks, one call, its count."""
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"gemm_tf32x3: a must be [M, K] and w [N, K], got {tuple(a.shape)}, "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[0]
    plan = tf32x3.gemm_plan(m, n, k, build.sm_count(a.device))
    for name, t, shape in (("bias", bias, (n,)), ("col_scale", col_scale, (n,)),
                           ("r1", r1, (m, n)), ("r2", r2, (m, n)), ("a_sub", a_sub, (k,))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"gemm_tf32x3: {name} must be {list(shape)}, got {tuple(t.shape)}")
    build.check_cuda_inputs("gemm_tf32x3", {"a": a, "w": w, "bias": bias,
                                            "col_scale": col_scale, "r1": r1, "r2": r2,
                                            "a_sub": a_sub},
                            float_only=("a", "w", "bias", "col_scale", "r1", "a_sub"))
    (w_hi, w_lo), = tf32x3.split_weights(w)
    out = torch.empty(m, n, device=a.device, dtype=torch.float32)
    tf32x3_launch(a, w_hi, w_lo, out, plan.bn, plan.stages, bias=bias, col_scale=col_scale,
                  gelu=gelu, r1=r1, r2=r2, a_sub=a_sub)
    launch_counts["gemm_tf32x3"] += 1
    return out


def tf32x3_launch(a, hi, lo, out, bn: int, stages: int, *, bias=None, col_scale=None,
                  gelu: bool = False, r1=None, r2=None, a_sub=None, a_t: bool = False,
                  splits: int = 1) -> None:
    """One launch of ``arpu_gemm_tf32x3`` into ``out``, tensors checked by
    the caller: ``a [M, K] @ (hi + lo)^T`` with ``hi``/``lo`` ``[N, K]``, at
    the plan ``(bn, stages)``, then the epilogue; with ``a_t``, ``a`` is
    ``A^T``, ``[K, M]``; with ``splits`` > 1 ``out`` is ``[splits, M, N]``,
    one slab of K's k-tiles each, and there is no epilogue."""
    n, k = hi.shape
    m = a.shape[1] if a_t else a.shape[0]
    fn = build.bind("gemm", "arpu_gemm_tf32x3", "pppp" "iii" "ii" "ppi" "ppi" "p" "ii" "p")
    rc = fn(a.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(), m, n, k, bn, stages,
            build.ptr(bias), build.ptr(col_scale), int(bool(gelu)), build.ptr(r1),
            build.ptr(r2), int(r2 is not None and r2.dtype == torch.bfloat16),
            build.ptr(a_sub), int(a_t), splits, build.stream_of(a))
    build.check("gemm", rc, "gemm_tf32x3")
