"""K2 ``fused_window_attention``: Swin W-MSA on windows (``csrc/window_attention.cu``).

Replaces ``audio_residual_tpu/ops/pallas/window_attention.py::
fused_window_attention``, standard path. As in the JAX package, the public
function dispatches: from C = ``WIDE_MIN_C`` on it runs K5
(:mod:`.wide_attention`, the port of the weight-streaming ``_wide_kernel``),
the plan the JAX package takes wherever its standard kernel does not fit.
``x [B*nW, n, C] -> [B*nW, n, C]``:
qkv projection, per-head ``q k^T hd^-1/2`` + relative-position bias +
SW-MSA mask, exact f32 softmax, ``@V``, output projection.

Weights are in ``nn.Linear`` layout (``[out, in]``). ``mxu_dtype=torch.bfloat16``
is the AMP contract: GEMM and attention operands rounded to bf16, f32
accumulate, f32 softmax; the output keeps the caller's dtype. Without it
the output is f32. Under AMP the wrapper hands the kernel bf16 copies of
the weights and of ``x`` (the rounding the kernel's GEMM applies anyway).
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from audio_residual_tpu_torch.ops import windows as win_ops
from audio_residual_tpu_torch.ops.common import attention_core, linear
from audio_residual_tpu_torch.ops.cuda import build, launch_counts

__all__ = ["fused_window_attention", "window_attention_plain", "WIDE_MIN_C", "mxu_weights",
           "q_scale"]

WIDE_MIN_C = 1024
"""From this width a window attention runs K5: the port's explicit rule for
where the JAX package's ``pick_group`` finds no plan (every shipped HTSAT
layer with C >= 1024)."""


def store_dtype(x: torch.Tensor, mxu_dtype) -> torch.dtype:
    if mxu_dtype not in (None, torch.bfloat16):
        raise ValueError(f"mxu_dtype must be None or torch.bfloat16, got {mxu_dtype}")
    return x.dtype if mxu_dtype is not None else torch.float32


# (id(tensor), what) -> (weakref to the tensor, its stamp, the derived value)
_derived: dict = {}


def _stamp(t: torch.Tensor) -> tuple:
    return (t._version, t.data_ptr(), t.device, t.dtype, tuple(t.shape), t.stride())


def derived(t: torch.Tensor, what, make):
    """``make(t)``, made once per state of ``t`` and kept while ``t`` lives:
    the kernels' bf16 weight copies and gathered relative-position biases,
    which would otherwise cost every call host time and launches.

    The state is ``t``'s version counter (an in-place update of ``t`` bumps
    it) with its storage address, device, dtype, shape and strides (a
    ``p.data = new`` swap or a move changes them). Not seen: an in-place
    write through ``p.data`` (``p.data.copy_(...)``), which bumps the
    counter of a separate view only. An inference tensor tracks no version,
    so its value is made at every call."""
    if t.is_inference():
        return make(t)
    key = (id(t), what)
    stamp = _stamp(t)
    hit = _derived.get(key)
    if hit is not None and hit[0]() is t and hit[1] == stamp:
        return hit[2]
    # the entry goes when the tensor does, so a reused id never finds it
    ref = weakref.ref(t, lambda _, key=key: _derived.pop(key, None))
    value = make(t)
    _derived[key] = (ref, stamp, value)
    return value


def mxu_weights(mxu_dtype, *weights) -> tuple:
    """The GEMM weights as the kernels take them: under AMP bf16 copies, made
    once per weight version, so no kernel converts a weight tile and no call
    casts again; otherwise the f32 tensors. (The JAX wrappers cast once per
    call, ``swin_block.py:264-266``.)"""
    if mxu_dtype is None:
        return weights
    return tuple(derived(w, mxu_dtype, lambda t: t.to(mxu_dtype)) for w in weights)


@functools.lru_cache(maxsize=32)
def q_scale(c: int, nh: int, device: torch.device) -> torch.Tensor:
    """``[3C]`` f32 column scale of the AMP qkv GEMM: ``hd**-0.5`` on q's
    columns, 1 on k's and v's, so the stored bf16 q is ``bf16(q * hd**-0.5)``,
    the operand the plain version's score product rounds."""
    s = torch.ones(3 * c)
    s[:c] = (c // nh) ** -0.5
    return s.to(device)


@functools.lru_cache(maxsize=32)
def _mask(h: int, w: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(win_ops.shift_window_mask(h, w, window, shift)).to(device)


def bias_and_mask(table: torch.Tensor, window: int, shift: int, resolution) -> tuple:
    """``bias [nh, n, n]`` and ``mask [nW, n, n]`` (None without a shift)."""
    bias = derived(table, ("bias", window),
                   lambda t: win_ops.gather_relative_bias(t.float(), window, window))
    mask = _mask(*resolution, window, shift, table.device) if shift > 0 else None
    return bias, mask


def attention_f32(y, wqkv, bqkv, wproj, bproj, bias, mask, nh, mxu_dtype=None) -> torch.Tensor:
    """``y [W, n, C]`` -> ``proj(attention(qkv(y)))`` in f32."""
    wn, n, c = y.shape
    qkv = linear(y.reshape(-1, c), wqkv, bqkv, mxu_dtype).reshape(wn, n, 3 * c)
    o = attention_core(qkv, bias, mask, nh=nh, mxu_dtype=mxu_dtype)
    return linear(o.reshape(-1, c), wproj, bproj, mxu_dtype).reshape(wn, n, c)


def window_attention_plain(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                           num_windows_per_image, shift, resolution, mxu_dtype=None):
    """Plain version of the kernel (``window_attention.py::_xla_reference``)."""
    store = store_dtype(x, mxu_dtype)
    bias, mask = bias_and_mask(rel_bias_table, window, shift, resolution)
    return attention_f32(x, wqkv, bqkv, wproj, bproj, bias, mask, nh, mxu_dtype).to(store)


def check_window_shapes(what, x, nh, window, num_windows_per_image, table) -> None:
    if x.ndim != 3 or x.shape[1] != window * window:
        raise ValueError(f"{what}: x must be [B*nW, {window * window}, C], got {tuple(x.shape)}")
    c = x.shape[2]
    if c % nh or x.shape[0] % num_windows_per_image:
        raise ValueError(f"{what}: C={c} / nh={nh} / windows={x.shape[0]} do not divide")
    if x.shape[1] > 64 or c // nh > 64:
        raise ValueError(f"{what}: the kernel takes windows of at most 64 tokens and hd <= 64")
    if tuple(table.shape) != ((2 * window - 1) ** 2, nh):
        raise ValueError(f"{what}: rel_bias_table has shape {tuple(table.shape)}")


def fused_window_attention(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh: int, window: int,
                           num_windows_per_image: int, shift: int, resolution,
                           mxu_dtype=None) -> torch.Tensor:
    """``x [B*nW, n, C]`` -> attention output, same shape, in the store dtype.
    C >= ``WIDE_MIN_C`` goes to K5; other CPU tensors take
    :func:`window_attention_plain`."""
    if x.shape[-1] >= WIDE_MIN_C:
        # imported here: wide_attention builds on this module's helpers
        from audio_residual_tpu_torch.ops.cuda.wide_attention import wide_window_attention

        return wide_window_attention(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                                     num_windows_per_image, shift, resolution, mxu_dtype)
    if x.device.type == "cpu":
        return window_attention_plain(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                                      num_windows_per_image, shift, resolution, mxu_dtype)
    store = store_dtype(x, mxu_dtype)
    weights = {"wqkv": wqkv, "bqkv": bqkv, "wproj": wproj, "bproj": bproj,
               "rel_bias_table": rel_bias_table}
    build.check_cuda_inputs("fused_window_attention", {"x": x, **weights},
                            float_only=tuple(weights))
    check_window_shapes("fused_window_attention", x, nh, window, num_windows_per_image,
                        rel_bias_table)
    wn, n, c = x.shape
    if tuple(wqkv.shape) != (3 * c, c) or tuple(wproj.shape) != (c, c):
        raise ValueError("fused_window_attention: weights must be [3C, C] and [C, C]")
    bias, mask = bias_and_mask(rel_bias_table, window, shift, resolution)
    amp = mxu_dtype is not None
    if amp:
        x = x.to(mxu_dtype)
    wqkv, wproj = mxu_weights(mxu_dtype, wqkv, wproj)
    qs = q_scale(c, nh, x.device) if amp else None
    r = wn * n
    out = torch.empty(wn, n, c, device=x.device, dtype=store)
    ws_size = build.bind("window_attention", "arpu_window_attention_workspace", "iii",
                         restype=ctypes.c_size_t)(r, c, int(amp))
    ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
    fn = build.bind("window_attention", "arpu_window_attention", "pipiiiiii" "ppppppp" "ipp")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            int(store == torch.bfloat16), r, n, c, nh, num_windows_per_image,
            wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(), bproj.data_ptr(),
            bias.data_ptr(), build.ptr(mask), build.ptr(qs),
            int(amp), ws.data_ptr(), build.stream_of(x))
    build.check("window_attention", rc, "fused_window_attention")
    launch_counts["fused_window_attention"] += 1
    return out
