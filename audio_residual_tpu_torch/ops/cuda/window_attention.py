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
the output is f32. The two contracts run two routes: the golden one a
sequence of the qkv GEMM, the f32 attention core and the proj GEMM, both
products in 3xTF32 on the tensor cores (:mod:`.tf32x3`: the weights split
once per weight version, each product's plan from
:func:`.tf32x3.gemm_plan`; a bf16 ``x`` widened to f32, exactly); the AMP one
``window_attention_wgmma_kernel`` (``csrc/window_attention_tc.cuh``: qkv
and attention in one launch over window pairs, q|k|v kept on chip), then
the bf16 proj GEMM. Under AMP the wrapper hands the kernel bf16 copies of
the weights and of ``x`` (the rounding its products apply anyway), the
relative bias and mask padded to the 64-token tile, the TMA map of the
bf16 wqkv (kept per weight version) and the launch plan of
:func:`amp_plan`. K4's attention half (:mod:`.swin_block`) and K5's AMP
route (:mod:`.wide_attention`) take the same kernel, plan and helpers.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops import windows as win_ops
from audio_residual_tpu_torch.ops.common import attention_core, linear
from audio_residual_tpu_torch.ops.cuda import build, launch_counts
from audio_residual_tpu_torch.ops.cuda.autograd import Op, Recompute, needs_graph
from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = ["fused_window_attention", "window_attention_plain", "window_attention_autograd",
           "WIDE_MIN_C", "mxu_weights", "q_scale", "amp_plan", "AmpPlan", "padded_bias_and_mask"]

WIDE_MIN_C = 1024
"""From this width a window attention runs K5: the port's explicit rule for
where the JAX package's ``pick_group`` finds no plan (every shipped HTSAT
layer with C >= 1024)."""


# the AMP kernel's constants (csrc/window_attention_tc.cuh, namespace watc)
AMP_HEAD_DIMS = (16, 24, 32, 64)  # two heads a group, one at 64
TC_TOKENS = 64    # rows of a window tile: n <= 64, zero-filled past n
TC_WINDOWS = 2    # windows a unit, one per consumer warpgroup
TC_BK = 64        # K step: 64 bf16, one 128-byte swizzle row
SMEM_LIMIT = 232448  # shared memory a block may use on the H100
H100_SMS = 132


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
    and a tensor that requires grad is a weight in training: for both the
    value is made at every call. (In grad mode such a value carries its
    graph; outside it, an optimizer may still update the weight without a
    version bump: ``torch.optim.AdamW(fused=True)`` bumps none, where the
    foreach update does.)"""
    if t.is_inference() or t.requires_grad:
        return make(t)
    key = (id(t), what)
    stamp = _stamp(t)
    hit = _derived.get(key)
    if hit is not None and hit[0]() is t and hit[1] == stamp:
        return hit[2]
    # the entry goes when the tensor does, so a reused id never finds it
    ref = weakref.ref(t, lambda _, key=key, cache=_derived: cache.pop(key, None))
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
    """``[3C]`` f32 column scale: ``hd**-0.5`` on q's columns, 1 on k's and
    v's. The AMP kernel's qkv epilogue applies it before rounding q|k|v to
    bf16, so its q is ``bf16(q * hd**-0.5)``, the operand the plain
    version's score product rounds; the CPU replays of that plan use it."""
    s = torch.ones(3 * c)
    s[:c] = (c // nh) ** -0.5
    return s.to(device)


@functools.lru_cache(maxsize=32)
def _mask(h: int, w: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(win_ops.shift_window_mask(h, w, window, shift)).to(device)


@dataclass(frozen=True)
class AmpPlan:
    """The AMP kernel's launch: work units are (window pair, head group of
    ``heads_per_block`` heads, ``n_cols / 3`` q columns), ``grid`` = (window
    pairs, head groups); ``blocks`` persistent blocks walk them."""

    heads_per_block: int
    windows_per_block: int
    stages: int
    smem_bytes: int
    grid: tuple[int, int]
    n_cols: int
    blocks: int


@functools.lru_cache(maxsize=256)
def amp_plan(windows: int, n: int, c: int, nh: int, sms: int = H100_SMS) -> AmpPlan:
    """The launch plan of the AMP qkv + attention kernel for ``windows``
    windows of ``n`` tokens at width ``c`` with ``nh`` heads on a card of
    ``sms`` SMs: two heads a unit (one at hd 64), as many ring stages as
    shared memory holds, one block an SM. ``ValueError`` for what the
    kernel does not take; the C entry refuses a plan that is not its
    build's."""
    if windows <= 0 or n <= 0 or n > TC_TOKENS:
        raise ValueError(f"window attention: {windows} windows of {n} tokens; the AMP kernel "
                         f"takes at least one window of at most {TC_TOKENS} tokens")
    if c <= 0 or c % 8:
        raise ValueError(f"window attention: C={c} is no multiple of 8 (16-byte TMA rows)")
    if nh <= 0 or c % nh or c // nh not in AMP_HEAD_DIMS:
        raise ValueError(f"window attention: C={c} / nh={nh}; the AMP kernel takes head dims "
                         f"{AMP_HEAD_DIMS}")
    hd = c // nh
    heads = 1 if hd == 64 else 2
    nq = heads * hd
    if c % nq:
        raise ValueError(f"window attention: C={c} is no multiple of {nq}, the q columns of a "
                         f"unit's head group of {heads}")
    n_cols = 3 * nq
    qkv_bytes = TC_WINDOWS * TC_TOKENS * (n_cols + 8) * 2
    stage = TC_WINDOWS * TC_TOKENS * TC_BK * 2 + n_cols * TC_BK * 2 + 16
    fixed = 1024 + qkv_bytes
    stages = (SMEM_LIMIT - fixed) // stage
    pairs = -(-windows // TC_WINDOWS)
    return AmpPlan(heads_per_block=heads, windows_per_block=TC_WINDOWS, stages=stages,
                   smem_bytes=fixed + stages * stage, grid=(pairs, c // nq), n_cols=n_cols,
                   blocks=min(pairs * (c // nq), sms))


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def weight_map(w: torch.Tensor, box_rows: int) -> ctypes.Array:
    """The TMA map of the bf16 weight ``w`` in boxes of ``[box_rows, 64]``,
    made once per state of ``w`` (kept beside it, as :func:`mxu_weights`
    keeps the copy): the AMP kernels of K2-K5 read their weights by TMA."""
    def make(t):
        m = ctypes.create_string_buffer(128)  # a CUtensorMap
        fn = build.bind("gemm", "arpu_weight_map", "piiip")
        build.check("gemm", fn(t.data_ptr(), t.shape[0], t.shape[1], box_rows, m),
                    "TMA weight map")
        return m

    return derived(w, ("tma_map", box_rows), make)


def amp_attention_args(x, wqkv, table, nh, window, shift, resolution) -> tuple:
    """``(bias, mask, plan arguments)`` of the AMP kernel for windows of
    ``x``'s shape ``[W, n, C]`` on its device and the bf16 ``wqkv``: the
    padded bias and mask, then the weight map's address, heads and windows
    a unit, stages, shared bytes and blocks, in the order the C entries
    take them."""
    wn, n, c = x.shape
    plan = amp_plan(wn, n, c, nh, sm_count(x.device))
    bias, mask = padded_bias_and_mask(table, window, shift, resolution)
    w_map = weight_map(wqkv, plan.n_cols // 3)
    return bias, mask, (ctypes.addressof(w_map), plan.heads_per_block, plan.windows_per_block,
                        plan.stages, plan.smem_bytes, plan.blocks)


NO_PLAN = (None, 0, 0, 0, 0, 0)  # the golden route reads no attention plan


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
    :func:`window_attention_plain`; CUDA tensors with an input that requires
    grad (in grad mode) take :func:`window_attention_autograd`."""
    if x.shape[-1] >= WIDE_MIN_C:
        # imported here: wide_attention builds on this module's helpers
        from audio_residual_tpu_torch.ops.cuda.wide_attention import wide_window_attention

        return wide_window_attention(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                                     num_windows_per_image, shift, resolution, mxu_dtype)
    args = (x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window, num_windows_per_image,
            shift, resolution, mxu_dtype)
    with annotate("kernel.fused_window_attention"):
        if x.device.type == "cpu":
            return window_attention_plain(*args)
        if needs_graph(x, wqkv, bqkv, wproj, bproj, rel_bias_table):
            return window_attention_autograd(*args)
        return _kernel(*args)


def window_attention_autograd(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                              num_windows_per_image, shift, resolution, mxu_dtype=None):
    """K2 under autograd (:mod:`.autograd`): the kernel forward (the plain
    version for CPU tensors), the plain version's backward."""
    meta = (nh, window, num_windows_per_image, shift, resolution, mxu_dtype)
    kernel = window_attention_plain if x.device.type == "cpu" else _kernel
    op = Op("recompute.fused_window_attention", lambda *t: kernel(*t, *meta),
            lambda *t: window_attention_plain(*t, *meta))
    return Recompute.apply(op, x, wqkv, bqkv, wproj, bproj, rel_bias_table)


def _kernel(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window, num_windows_per_image,
            shift, resolution, mxu_dtype) -> torch.Tensor:
    """The kernel on CUDA tensors: checks, one call, its count."""
    weights = {"wqkv": wqkv, "bqkv": bqkv, "wproj": wproj, "bproj": bproj,
               "rel_bias_table": rel_bias_table}
    build.check_cuda_inputs("fused_window_attention", {"x": x, **weights},
                            float_only=tuple(weights))
    check_window_shapes("fused_window_attention", x, nh, window, num_windows_per_image,
                        rel_bias_table)
    wn, n, c = x.shape
    if tuple(wqkv.shape) != (3 * c, c) or tuple(wproj.shape) != (c, c):
        raise ValueError("fused_window_attention: weights must be [3C, C] and [C, C]")
    out = window_attention_call(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                                num_windows_per_image, shift, resolution, mxu_dtype,
                                "fused_window_attention")
    launch_counts["fused_window_attention"] += 1
    return out


def window_attention_call(x, wqkv, bqkv, wproj, bproj, rel_bias_table, nh, window,
                          num_windows_per_image, shift, resolution, mxu_dtype, what):
    """One call of ``csrc/window_attention.cu`` on checked CUDA inputs: the
    golden sequence, or under AMP the qkv + attention kernel and the proj
    GEMM (K5's AMP route comes here too)."""
    store = store_dtype(x, mxu_dtype)
    wn, n, c = x.shape
    r = wn * n
    amp = mxu_dtype is not None
    if amp:
        wqkv, wproj = mxu_weights(mxu_dtype, wqkv, wproj)
        x = x.to(mxu_dtype)  # the kernel's TMA reads bf16 rows; its products round x so anyway
        bias, mask, plan = amp_attention_args(x, wqkv, rel_bias_table, nh, window, shift,
                                              resolution)
        weights = (wqkv.data_ptr(), None, 0, 0, bqkv.data_ptr(),
                   wproj.data_ptr(), None, 0, 0, bproj.data_ptr())
    else:
        from audio_residual_tpu_torch.ops.cuda import tf32x3  # it builds on this module

        x = x.float()  # the qkv product's A operand is f32: widening bf16 is exact
        bias, mask = bias_and_mask(rel_bias_table, window, shift, resolution)
        plan = NO_PLAN
        sms = sm_count(x.device)
        qkv, proj = tf32x3.operand(wqkv, r, sms), tf32x3.operand(wproj, r, sms)
        weights = (*qkv.args(), bqkv.data_ptr(), *proj.args(), bproj.data_ptr())
    out = torch.empty(wn, n, c, device=x.device, dtype=store)
    ws_size = build.bind("window_attention", "arpu_window_attention_workspace", "iii",
                         restype=ctypes.c_size_t)(r, c, int(amp))
    ws = torch.empty(ws_size, device=x.device, dtype=torch.uint8)
    fn = build.bind("window_attention", "arpu_window_attention",
                    "pipiiiiii" "ppiip" "ppiip" "pp" "i" "piiiii" "pp")
    rc = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), out.data_ptr(),
            int(store == torch.bfloat16), r, n, c, nh, num_windows_per_image, *weights,
            bias.data_ptr(), build.ptr(mask), int(amp), *plan, ws.data_ptr(),
            build.stream_of(x))
    build.check("window_attention", rc, what)
    return out
