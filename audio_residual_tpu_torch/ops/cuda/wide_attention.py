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
output in the caller's dtype); without it the output is f32. Under AMP the
kernel takes bf16 copies of the weights.
"""

from __future__ import annotations

import ctypes

import torch

from audio_residual_tpu_torch.ops.cuda import build, launch_counts
from audio_residual_tpu_torch.ops.cuda.window_attention import (
    bias_and_mask,
    check_window_shapes,
    mxu_weights,
    store_dtype,
    window_attention_plain,
)

__all__ = ["wide_window_attention", "wide_attention_plain"]

HEAD_DIMS = (32, 64)


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
    dtype. CPU tensors take :func:`wide_attention_plain`."""
    if x.device.type == "cpu":
        return wide_attention_plain(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                                    num_windows_per_image, shift, resolution, mxu_dtype)
    store = store_dtype(x, mxu_dtype)
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
    bias, mask = bias_and_mask(rel_bias_table, window, shift, resolution)
    amp = mxu_dtype is not None
    wqkv, wproj = mxu_weights(mxu_dtype, wqkv, wproj)
    r = wn * n
    out = torch.empty(wn, n, c, device=x.device, dtype=store)
    ws_size = build.bind("wide_attention", "arpu_wide_attention_workspace", "iii",
                         restype=ctypes.c_size_t)(r, c, int(amp))
    ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
    fn = build.bind("wide_attention", "arpu_wide_attention", "pipiiiiii" "pppppp" "ipp")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            int(store == torch.bfloat16), r, n, c, nh, num_windows_per_image,
            wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            bias.data_ptr(), build.ptr(mask), int(amp), ws.data_ptr(), build.stream_of(x))
    build.check("wide_attention", rc, "wide_window_attention")
    launch_counts["wide_window_attention"] += 1
    return out
