"""K3 ``fused_residual_ffn``: the FFN half of a Swin block (``csrc/ln_mlp.cu``).

Replaces ``audio_residual_tpu/ops/pallas/ln_mlp.py::fused_residual_ffn``. On
flattened rows ``x, a [R, C]`` (block input and attention output): the
optional ResiDual epilogue on ``a`` (f32), ``h = x + a``,
``y = h + fc2(GELU(fc1(LN2(h))))``, and with ``double_ffn`` the reference's
patched-forward quirk, a second pass from ``x + y``. Weights in
``nn.Linear`` layout. Output in the store dtype (the caller's under AMP).

Two routes: the golden one (f32) is a launch sequence whose products run
``gemm_tf32x3_kernel``, f32 products in 3xTF32 on the tensor cores
(:mod:`.tf32x3`: the weights split once per weight version, each GEMM's
plan from :func:`.tf32x3.gemm_plan`); the AMP one
(``mxu_dtype=torch.bfloat16``) runs ``ffn_cluster_kernel``, one clustered
launch per FFN pass with the hidden activation exchanged through
distributed shared memory, on bf16 copies of the weights and the launch plan
of :func:`amp_plan`. The ResiDual is f32 in both routes: its two products
run ``gemm_tf32x3_kernel`` (:func:`.tf32x3.residual_operands`, any
component count, padded to a multiple of 8), on ``a`` widened to f32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops.common import layer_norm, linear
from audio_residual_tpu_torch.ops.cuda import build, launch_counts, tf32x3
from audio_residual_tpu_torch.ops.cuda.autograd import Op, route
from audio_residual_tpu_torch.ops.cuda.build import (
    SMEM_LIMIT,
    mxu_weights,
    sm_count,
    store_dtype,
    weight_map,
)
from audio_residual_tpu_torch.residual.module import residual_apply

__all__ = ["fused_residual_ffn", "residual_ffn_plain", "residual_ffn_op", "amp_plan",
           "FfnPlan", "residual_operands", "residual_inputs"]

# the AMP kernel's constants (csrc/ln_mlp.cu, namespace ffn)
ROWS = 128                  # rows of a cluster's tile: two consumer warpgroups of 64
PART = 64                   # hidden columns a block computes per chunk
BK = 64                     # K step: 64 bf16, one 128-byte swizzle row (C's
                            # ragged last step arrives zero-filled)
OUT_WIDTHS = (64, 96, 128, 256)  # output columns a block (its wgmma N)
# clusters of 6 first: on the H100 only 15 clusters of 8 such blocks are
# resident at once, so 16 row tiles (R = 2048) would run in two waves
CLUSTER_SIZES = (6, 8, 4, 2, 1)
MAX_STAGES = 6
MAX_C = 2048                # LN2's row in registers: 8 chunks of 8 a lane
_Z_W1_BYTES = ROWS * BK * 2 + PART * BK * 2


@dataclass(frozen=True)
class FfnPlan:
    """The AMP kernel's launch: clusters of ``cs`` blocks, one a 128-row
    tile; each block owns ``n_out`` output columns and ``PART`` of every
    ``chunk`` hidden columns; ``stages`` ring stages; ``grid`` blocks."""

    cs: int
    chunk: int
    n_out: int
    stages: int
    smem_bytes: int
    grid: int


@functools.lru_cache(maxsize=64)
def amp_plan(rows: int, c: int, hidden: int) -> FfnPlan:
    """The launch plan of the AMP kernel for ``rows`` rows of width ``c``
    and ``hidden`` hidden units: the first cluster size of
    ``CLUSTER_SIZES`` whose blocks' output width is one the kernel is built
    for and whose chunk divides ``hidden``, with as many ring stages as
    shared memory holds.
    ``ValueError`` for a shape the kernel does not take; the C entry refuses
    a plan that is not its build's."""
    if rows <= 0 or c <= 0 or hidden <= 0:
        raise ValueError(f"fused_residual_ffn: empty shape rows={rows} C={c} hidden={hidden}")
    if c % 8:
        raise ValueError(f"fused_residual_ffn: C={c} is no multiple of 8 (16-byte TMA rows)")
    if c > MAX_C:
        raise ValueError(f"fused_residual_ffn: C={c} is above {MAX_C}, the widest row the AMP "
                         "kernel's LN2 holds in registers")
    if hidden % PART:
        raise ValueError(f"fused_residual_ffn: hidden={hidden} is no multiple of {PART}, the "
                         "hidden columns a block computes per chunk")
    for cs in CLUSTER_SIZES:
        n_out = c // cs
        if c % cs or n_out not in OUT_WIDTHS or hidden % (PART * cs):
            continue
        stage = max(_Z_W1_BYTES, n_out * BK * 2)
        fixed = 1024 + cs * ROWS * PART * 2 + 2 * 8
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (stage + 16))
        if stages < 2:
            continue
        return FfnPlan(cs=cs, chunk=PART * cs, n_out=n_out, stages=stages,
                       smem_bytes=fixed + stages * (stage + 16), grid=-(-rows // ROWS) * cs)
    raise ValueError(f"fused_residual_ffn: no AMP plan for C={c} hidden={hidden}: a block's "
                     f"output width C/CS must be one of {OUT_WIDTHS} for a cluster size CS in "
                     f"{CLUSTER_SIZES} with hidden a multiple of {PART}*CS")


def _span(nbytes: int) -> int:
    """``arpu::span``: scratch pieces are 256-byte aligned."""
    return (nbytes + 255) & ~255


def amp_workspace_bytes(rows: int, c: int, kr: int, double_ffn: bool) -> int:
    """The AMP entry's scratch: z [R, C] bf16, with ResiDual h1 [R, C] and
    proj [R, kr] f32, with the double FFN y2 [R, C] f32."""
    n = _span(rows * c * 2)
    if kr:
        n += _span(rows * c * 4) + _span(rows * kr * 4)
    if double_ffn:
        n += _span(rows * c * 4)
    return n


def residual_ffn_f32(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams=None, *,
                     double_ffn=False, mxu_dtype=None) -> torch.Tensor:
    a = a.float()
    if rparams is not None:
        a = residual_apply(a, rparams["basis"], rparams["mean"], rparams["lam"])
    h1 = x.float() + a

    def ffn(t):
        z = F.gelu(linear(layer_norm(t, n2s, n2b), wfc1, bfc1, mxu_dtype))
        return linear(z, wfc2, bfc2, mxu_dtype)

    y = h1 + ffn(h1)
    if double_ffn:
        y2 = x.float() + y
        y = y2 + ffn(y2)
    return y


def residual_ffn_plain(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams=None,
                       double_ffn=False, mxu_dtype=None) -> torch.Tensor:
    """Plain version of the kernel (the formula of ``ln_mlp.py::_kernel``)."""
    store = store_dtype(x, mxu_dtype)
    return residual_ffn_f32(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams,
                            double_ffn=double_ffn, mxu_dtype=mxu_dtype).to(store)


def residual_inputs(rparams) -> dict:
    """The ResiDual's tensors by name (None without one), for the wrappers'
    input checks."""
    return dict(zip(("basis", "mean", "lam"), _residual_tensors(rparams)))


def residual_operands(rparams, c: int, rows: int, sms: int) -> tf32x3.Residual | None:
    """The ResiDual as its two 3xTF32 products on ``rows`` rows take it
    (:func:`.tf32x3.residual_operands`); None without ResiDual."""
    if rparams is None:
        return None
    basis = rparams["basis"]
    if basis.ndim != 2 or basis.shape[1] != c:
        raise ValueError(f"ResiDual basis must be [K, {c}], got {tuple(basis.shape)}")
    kr = basis.shape[0]
    if tuple(rparams["mean"].shape) != (c,) or tuple(rparams["lam"].shape) != (kr,):
        raise ValueError("ResiDual mean must be [C] and lam [K]")
    return tf32x3.residual_operands(basis, rparams["mean"], rparams["lam"], rows, sms)


def fused_residual_ffn(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams: dict | None = None, *,
                       double_ffn: bool = False, mxu_dtype=None) -> torch.Tensor:
    """``x, a [R, C]`` -> post-block rows ``[R, C]``, routed by
    :func:`.autograd.route` (grads for ``x``, ``a`` and the ResiDual
    params)."""
    return route("kernel.fused_residual_ffn",
                 (x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, *_residual_tensors(rparams)),
                 residual_ffn_plain, _kernel, residual_ffn_op, x, a, n2s, n2b, wfc1, bfc1, wfc2,
                 bfc2, rparams, double_ffn, mxu_dtype)


def _residual_tensors(rparams) -> tuple:
    if rparams is None:
        return None, None, None
    return rparams["basis"], rparams["mean"], rparams["lam"]


def _residual_dict(basis, mean, lam) -> dict | None:
    return None if basis is None else {"basis": basis, "mean": mean, "lam": lam}


def residual_ffn_op(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams=None, double_ffn=False,
                    mxu_dtype=None) -> Op:
    """K3's :class:`.autograd.Op` on its eight tensors and the ResiDual's
    three (None without one)."""
    def call(fn):
        return lambda *t: fn(*t[:8], _residual_dict(*t[8:]), double_ffn, mxu_dtype)

    return Op("recompute.fused_residual_ffn", call(_kernel), call(residual_ffn_plain))


def _kernel(x, a, n2s, n2b, wfc1, bfc1, wfc2, bfc2, rparams, double_ffn,
            mxu_dtype) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, one call, its count."""
    store = store_dtype(x, mxu_dtype)
    if x.ndim != 2 or a.shape != x.shape:
        raise ValueError(f"fused_residual_ffn: x and a must be [R, C], got {x.shape}, {a.shape}")
    r, c = x.shape
    hidden = wfc1.shape[0]
    if tuple(wfc1.shape) != (hidden, c) or tuple(wfc2.shape) != (c, hidden):
        raise ValueError("fused_residual_ffn: fc1 must be [hidden, C] and fc2 [C, hidden]")
    weights = {"n2s": n2s, "n2b": n2b, "wfc1": wfc1, "bfc1": bfc1, "wfc2": wfc2, "bfc2": bfc2,
               **residual_inputs(rparams)}
    build.check_cuda_inputs("fused_residual_ffn", {"x": x, "a": a, **weights},
                            float_only=tuple(weights))
    sms = sm_count(x.device)
    res = residual_operands(rparams, c, r, sms)
    if res is not None:
        a = a.float()  # the ResiDual product's A operand is f32: widening bf16 is exact
    kr = res.kr if res is not None else 0
    res_args = res.args() if res is not None else tf32x3.NO_RESIDUAL
    out = torch.empty(r, c, device=x.device, dtype=store)
    if mxu_dtype is None:
        ws_size = build.bind("ln_mlp", "arpu_residual_ffn_workspace", "iiii",
                             restype=ctypes.c_size_t)(r, c, hidden, kr)
        ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
        fc1, fc2 = tf32x3.operand(wfc1, r, sms), tf32x3.operand(wfc2, r, sms)
        fn = build.bind("ln_mlp", "arpu_residual_ffn",
                        "pipipi" "iii" "pp" "ppiip" "ppiip" "ppii" "ppii" "ppi" "i" "pp")
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), a.data_ptr(),
                int(a.dtype == torch.bfloat16), out.data_ptr(), int(store == torch.bfloat16),
                r, c, hidden, n2s.data_ptr(), n2b.data_ptr(), *fc1.args(), bfc1.data_ptr(),
                *fc2.args(), bfc2.data_ptr(), *res_args, int(bool(double_ffn)), ws.data_ptr(),
                build.stream_of(x))
    else:
        plan = amp_plan(r, c, hidden)
        wfc1, wfc2 = mxu_weights(mxu_dtype, wfc1, wfc2)
        w1_map, w2_map = weight_map(wfc1, PART), weight_map(wfc2, plan.n_out)
        ws = torch.empty(amp_workspace_bytes(r, c, kr, double_ffn), device=x.device,
                         dtype=torch.uint8)
        fn = build.bind("ln_mlp", "arpu_residual_ffn_amp",
                        "pipipi" "iii" "pppppp" "ppii" "ppii" "ppi" "i" "iii" "pp")
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), a.data_ptr(),
                int(a.dtype == torch.bfloat16), out.data_ptr(), int(store == torch.bfloat16),
                r, c, hidden, n2s.data_ptr(), n2b.data_ptr(), ctypes.addressof(w1_map),
                bfc1.data_ptr(), ctypes.addressof(w2_map), bfc2.data_ptr(), *res_args,
                int(bool(double_ffn)), plan.cs, plan.stages, plan.smem_bytes, ws.data_ptr(),
                build.stream_of(x))
    build.check("ln_mlp", rc, "fused_residual_ffn")
    launch_counts["fused_residual_ffn"] += 1
    return out
