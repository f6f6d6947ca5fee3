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
output in the caller's dtype); without it the output is f32. The two
contracts run two kernels for the qkv product and the attention: the golden
one on the CUDA cores in f32, the AMP one (``wide_attention_wgmma_kernel``)
on TMA + ``wgmma`` over window pairs, with the attention core on the tensor
cores. Under AMP the wrapper hands that kernel bf16 copies of the weights
and of ``x`` (the rounding its products apply anyway), the relative bias
and mask padded to the 64-token tile, and the launch plan of
:func:`amp_plan`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops import windows as win_ops
from audio_residual_tpu_torch.ops.cuda import build, launch_counts
from audio_residual_tpu_torch.ops.cuda.window_attention import (
    _mask,
    bias_and_mask,
    check_window_shapes,
    derived,
    mxu_weights,
    store_dtype,
    window_attention_plain,
)

__all__ = ["wide_window_attention", "wide_attention_plain", "amp_plan", "AmpPlan",
           "padded_bias_and_mask"]

HEAD_DIMS = (32, 64)
# the AMP kernel's constants (csrc/wide_attention.cu, namespace wtc)
TC_TOKENS = 64    # rows of a window tile: n <= 64, zero-filled past n
TC_WINDOWS = 2    # windows a block, one per consumer warpgroup
TC_GROUP = 64     # q (and k, v) columns of a block's head group
TC_STAGES = 4     # ring stages of one 64-wide K step
TC_BK = 64        # K step: 64 bf16, one 128-byte swizzle row
SMEM_LIMIT = 232448  # shared memory a block may use on the H100


@dataclass(frozen=True)
class AmpPlan:
    """The AMP kernel's launch: ``grid`` is (window pairs, head groups of
    ``n_cols / 3`` q columns)."""

    heads_per_block: int
    windows_per_block: int
    stages: int
    smem_bytes: int
    grid: tuple[int, int]
    n_cols: int


@functools.lru_cache(maxsize=64)
def amp_plan(windows: int, n: int, c: int, nh: int) -> AmpPlan:
    """The launch plan of the AMP kernel for ``windows`` windows of ``n``
    tokens at width ``c`` with ``nh`` heads; ``ValueError`` for what the
    kernel does not take. The C entry refuses a plan that is not its
    build's."""
    if windows <= 0 or n <= 0 or n > TC_TOKENS:
        raise ValueError(f"wide_window_attention: {windows} windows of {n} tokens; the AMP "
                         f"kernel takes at least one window of at most {TC_TOKENS} tokens")
    if c % nh or c // nh not in HEAD_DIMS:
        raise ValueError(f"wide_window_attention: C={c} / nh={nh}; the AMP kernel takes head "
                         f"dims {HEAD_DIMS}")
    if c % TC_GROUP:
        raise ValueError(f"wide_window_attention: C={c} is no multiple of {TC_GROUP}, the "
                         "q columns of a block's head group (and of the TMA K step)")
    pairs = -(-windows // TC_WINDOWS)
    x_bytes = TC_WINDOWS * TC_TOKENS * TC_BK * 2
    w_bytes = 3 * TC_GROUP * TC_BK * 2
    qkv_bytes = TC_WINDOWS * TC_TOKENS * (3 * TC_GROUP + 8) * 2
    smem = 1024 + TC_STAGES * (x_bytes + w_bytes) + qkv_bytes + 2 * TC_STAGES * 8
    return AmpPlan(heads_per_block=TC_GROUP // (c // nh), windows_per_block=TC_WINDOWS,
                   stages=TC_STAGES, smem_bytes=smem, grid=(pairs, c // TC_GROUP),
                   n_cols=3 * TC_GROUP)


def _pad_tile(t: torch.Tensor, n: int, key_fill: float) -> torch.Tensor:
    """``[..., n, n]`` -> ``[..., 64, 64]``: key columns past ``n`` hold
    ``key_fill``, padded query rows 0 elsewhere."""
    out = F.pad(t, (0, TC_TOKENS - n, 0, TC_TOKENS - n))
    out[..., n:] = key_fill
    return out.contiguous()


@functools.lru_cache(maxsize=32)
def _mask64(h: int, w: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    return _pad_tile(_mask(h, w, window, shift, device), window * window, 0.0)


def padded_bias_and_mask(table: torch.Tensor, window: int, shift: int, resolution) -> tuple:
    """The AMP kernel's ``bias [nh, 64, 64]`` (-inf in the key columns past
    the window's tokens, so they drop out of the softmax) and ``mask [nW,
    64, 64]`` (None without a shift)."""
    n = window * window
    bias = derived(table, ("bias64", window), lambda t: _pad_tile(
        win_ops.gather_relative_bias(t.float(), window, window), n, float("-inf")))
    mask = _mask64(*resolution, window, shift, table.device) if shift > 0 else None
    return bias, mask


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
    amp = mxu_dtype is not None
    plan = amp_plan(wn, n, c, nh) if amp else None
    r = wn * n
    out = torch.empty(wn, n, c, device=x.device, dtype=store)
    ws_size = build.bind("wide_attention", "arpu_wide_attention_workspace", "iii",
                         restype=ctypes.c_size_t)(r, c, int(amp))
    ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
    if amp:
        bias, mask = padded_bias_and_mask(rel_bias_table, window, shift, resolution)
        wqkv, wproj = mxu_weights(mxu_dtype, wqkv, wproj)
        xb = x.to(mxu_dtype)  # the kernel's TMA reads bf16 rows; its products round x so anyway
        fn = build.bind("wide_attention", "arpu_wide_attention_amp",
                        "ppiiiiii" "pppppp" "iiiii" "pp")
        rc = fn(xb.data_ptr(), out.data_ptr(), int(store == torch.bfloat16), wn, n, c, nh,
                num_windows_per_image, wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
                bproj.data_ptr(), bias.data_ptr(), build.ptr(mask), plan.heads_per_block,
                plan.windows_per_block, plan.stages, plan.smem_bytes, plan.grid[0],
                ws.data_ptr(), build.stream_of(x))
    else:
        bias, mask = bias_and_mask(rel_bias_table, window, shift, resolution)
        fn = build.bind("wide_attention", "arpu_wide_attention", "pipiiiiii" "pppppp" "pp")
        rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
                int(store == torch.bfloat16), r, n, c, nh, num_windows_per_image,
                wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
                bias.data_ptr(), build.ptr(mask), ws.data_ptr(), build.stream_of(x))
    build.check("wide_attention", rc, "wide_window_attention")
    launch_counts["wide_window_attention"] += 1
    return out
