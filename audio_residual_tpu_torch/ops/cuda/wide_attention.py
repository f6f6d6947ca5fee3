"""K5 ``wide_window_attention``: Swin W-MSA for wide layers (``csrc/wide_attention.cu``).

Replaces ``audio_residual_tpu/ops/pallas/window_attention.py::_wide_attention``
(the weight-streaming ``_wide_kernel``), which the JAX package takes where
the standard W-MSA kernel does not fit: every shipped HTSAT layer with
C >= 1024 (base layer 3, large layers 2-3). It computes the function of
:func:`~.window_attention.fused_window_attention` -- ``x [B*nW, n, C]`` ->
qkv projection, per-head scores + relative-position bias + SW-MSA mask,
exact f32 softmax, ``@V``, output projection -- for windows of at most 64
tokens and head dims 32 or 64. :func:`.window_attention.fused_window_attention`
and :func:`.swin_block.fused_swin_block` send every C >= ``WIDE_MIN_C``
call here.

Weights in ``nn.Linear`` layout. ``mxu_dtype=torch.bfloat16`` is the AMP
contract (bf16 GEMM and attention operands, f32 accumulate and softmax,
output in the caller's dtype); without it the output is f32. Both contracts
run K2's routes at the wide width: the golden one, through this kernel's C
entry (``csrc/wide_attention.cu``), is K2's golden sequence -- the qkv GEMM
in 3xTF32 on the tensor cores, the f32 attention core, the proj GEMM in
3xTF32, on weights split once per weight version and a bf16 ``x`` widened
to f32; the AMP one is K2's ``window_attention_wgmma_kernel``
(``csrc/window_attention_tc.cuh``), TMA + ``wgmma`` over window pairs with
the attention core on the tensor cores, which this wrapper reaches through
K2's C entry with the launch plan of :func:`amp_plan`.
"""

from __future__ import annotations

import ctypes

import torch

from audio_residual_tpu_torch.ops.cuda import build, launch_counts, tf32x3
from audio_residual_tpu_torch.ops.cuda import window_attention as k2
from audio_residual_tpu_torch.ops.cuda.autograd import Op, Recompute, needs_graph
from audio_residual_tpu_torch.ops.cuda.window_attention import (
    SMEM_LIMIT,
    AmpPlan,
    bias_and_mask,
    check_window_shapes,
    padded_bias_and_mask,
    sm_count,
    window_attention_call,
    window_attention_plain,
)
from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = ["wide_window_attention", "wide_attention_plain", "wide_attention_autograd",
           "amp_plan", "AmpPlan", "padded_bias_and_mask", "SMEM_LIMIT"]

HEAD_DIMS = (32, 64)  # K5's, those of every shipped wide layer; the AMP kernel takes others too


def amp_plan(windows: int, n: int, c: int, nh: int) -> AmpPlan:
    """The AMP kernel's launch plan (:func:`.window_attention.amp_plan`) for
    a wide layer, whose head dim must also be one the golden kernel takes;
    ``ValueError`` otherwise."""
    if c % nh or c // nh not in HEAD_DIMS:
        raise ValueError(f"wide_window_attention: C={c} / nh={nh}; K5 takes head dims "
                         f"{HEAD_DIMS}")
    return k2.amp_plan(windows, n, c, nh)


def wide_attention_plain(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                         num_windows_per_image, shift, resolution, mxu_dtype=None):
    """Plain version of the kernel: the JAX package has one twin for both
    attention paths (``window_attention.py::_xla_reference``), so this is K2's."""
    return window_attention_plain(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                                  num_windows_per_image, shift, resolution, mxu_dtype)


def wide_window_attention(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh: int, window: int,
                          num_windows_per_image: int, shift: int, resolution,
                          mxu_dtype=None) -> torch.Tensor:
    """``x [B*nW, n, C]`` -> attention output, same shape, in the store
    dtype. CPU tensors take :func:`wide_attention_plain`; CUDA tensors with
    an input that requires grad (in grad mode) take
    :func:`wide_attention_autograd`."""
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window, num_windows_per_image,
            shift, resolution, mxu_dtype)
    with annotate("kernel.wide_window_attention"):
        if x.device.type == "cpu":
            return wide_attention_plain(*args)
        if needs_graph(x, wqkv, bqkv, wproj, bproj, rel_bias_table):
            return wide_attention_autograd(*args)
        return _kernel(*args)


def wide_attention_autograd(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                            num_windows_per_image, shift, resolution, mxu_dtype=None):
    """K5 under autograd (:mod:`.autograd`): the kernel forward (the plain
    version for CPU tensors), the plain version's backward."""
    meta = (nh, window, num_windows_per_image, shift, resolution, mxu_dtype)
    kernel = wide_attention_plain if x.device.type == "cpu" else _kernel
    op = Op("recompute.wide_window_attention", lambda *t: kernel(*t, *meta),
            lambda *t: wide_attention_plain(*t, *meta))
    return Recompute.apply(op, x, wqkv, bqkv, wproj, bproj, rel_bias_table)


def _kernel(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window, num_windows_per_image,
            shift, resolution, mxu_dtype) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, one call, its count."""
    weights = {"wqkv": wqkv, "bqkv": bqkv, "wproj": wproj, "bproj": bproj,
               "rel_bias_table": rel_bias_table}
    build.check_cuda_inputs("wide_window_attention", {"x": x, **weights},
                            float_only=tuple(weights))
    check_window_shapes("wide_window_attention", x, nh, window, num_windows_per_image,
                        rel_bias_table)
    wn, n, c = x.shape
    if c // nh not in HEAD_DIMS:
        raise ValueError(f"wide_window_attention: head dim {c // nh}, the kernel takes "
                         f"{HEAD_DIMS}")
    if tuple(wqkv.shape) != (3 * c, c) or tuple(wproj.shape) != (c, c):
        raise ValueError("wide_window_attention: weights must be [3C, C] and [C, C]")
    if mxu_dtype is not None:
        out = window_attention_call(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                                    num_windows_per_image, shift, resolution, mxu_dtype,
                                    "wide_window_attention")
        launch_counts["wide_window_attention"] += 1
        return out
    r = wn * n
    x = x.float()  # the qkv product's A operand is f32: widening bf16 is exact
    out = torch.empty(wn, n, c, device=x.device, dtype=torch.float32)
    ws_size = build.bind("wide_attention", "arpu_wide_attention_workspace", "ii",
                         restype=ctypes.c_size_t)(r, c)
    ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
    bias, mask = bias_and_mask(rel_bias_table, window, shift, resolution)
    sms = sm_count(x.device)
    qkv, proj = tf32x3.operand(wqkv, r, sms), tf32x3.operand(wproj, r, sms)
    fn = build.bind("wide_attention", "arpu_wide_attention", "ppiiiii" "ppiip" "ppiip" "pp" "pp")
    rc = fn(x.data_ptr(), out.data_ptr(), r, n, c, nh, num_windows_per_image, *qkv.args(),
            bqkv.data_ptr(), *proj.args(), bproj.data_ptr(), bias.data_ptr(), build.ptr(mask),
            ws.data_ptr(), build.stream_of(x))
    build.check("wide_attention", rc, "wide_window_attention")
    launch_counts["wide_window_attention"] += 1
    return out
