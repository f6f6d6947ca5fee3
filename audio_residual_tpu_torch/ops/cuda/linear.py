"""The golden dense product ``[gelu](x @ W^T + b)`` on the 3xTF32 GEMM, with
its backward on the same GEMM: the text tower's golden linears on the card.

:func:`linear_tf32x3` is ``F.linear`` (and the exact GELU) for f32 CUDA
tensors, in 3xTF32 (:mod:`.tf32x3`: about f32's accuracy on the TF32
tensor cores; PyTorch's TF32 mode stays off). Under autograd it is one
:class:`torch.autograd.Function` whose three products all run the GEMM of
``csrc/gemm_sm90.cuh``:

* forward ``y = x W^T + b``: A = x, split as the kernel reads it; W split
  once per call (a weight that requires grad changes at every step) into
  ``hi``/``lo`` and, in the same pass, W^T's split for the backward, kept
  on the context;
* ``dx = dy W``: A = dy, the kernel's ``B = W^T [K, N]`` from the forward;
* ``dW = dy^T x``, reduced over the M rows of the batch: TF32 ``wgmma`` takes
  K-major operands only, and both ``dy [M, N]`` and ``x [M, K]`` run along
  M. The smaller of them is split and transposed in one pass
  (``arpu_split_tf32``: ``[M, C]`` read once, ``hi``/``lo`` of its
  transpose written, M padded to a multiple of 4 with zeros); the kernel
  reads the other transposed from its tiles (A_T: A^T's boxes by TMA, the
  fragment gathered across them). Its output is ``dW`` or ``dW^T`` (then
  transposed, a weight's size). With only ``N x K`` outputs and a long
  reduction, K is split (``splits``: each split a slab of the output, the
  slabs summed after), so that the card's SMs all work
  (:func:`weight_grad_plan`);
* ``db = dy.sum(0)``.

GELU: without a graph the forward applies it in the kernel's epilogue;
under autograd the kernel returns the pre-activation and ``F.gelu`` runs
under autograd after it, as on the plain route, so no product is
recomputed. The spans: ``kernel.linear_tf32x3`` around the forward's
products and splits, ``kernel.linear_tf32x3.backward`` around the
backward's. On the CPU the same function runs its plain version: each
product a ``torch`` matmul on ``hi + lo`` (exactly the operand), in the
kernel's decomposition (the split of K, the transposed operands, the
padding), which the CPU tests hold against ``F.linear``'s autograd.

It replaces no TPU kernel: on the TPU the JAX package's text tower runs its
dense products as ``x @ kernel`` outside any Pallas kernel.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from audio_residual_tpu_torch.ops.cuda import build, launch_counts, tf32x3
from audio_residual_tpu_torch.ops.cuda.autograd import needs_graph
from audio_residual_tpu_torch.ops.cuda.build import H100_SMS, derived, sm_count
from audio_residual_tpu_torch.ops.cuda.gemm import tf32x3_launch
from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = ["linear_tf32x3", "linear_plain", "takes", "WeightGradPlan", "weight_grad_plan",
           "split_t"]

# The weight gradient's plan, fitted to the GEMM's times at M = 7392 on the
# H100 (tools/time_linear.py --sweep): a k-step of a tile costs its N tile
# plus tf32x3.KTILE_FIXED_COLUMNS columns (as in tf32x3.gemm_plan), a tile
# TILE_FIXED_KTILES k-steps more (its pipeline's fill and epilogue), a
# 128 x 128 x 32 k-step KTILE_128_S, and the sum of the K splits moves
# REDUCE_BYTES_S.
TILE_FIXED_KTILES = 5
KTILE_128_S = 1.35e-6
REDUCE_BYTES_S = 1.5e12
MAX_SPLITS = 32


def linear_plain(x, weight, bias=None, gelu: bool = False) -> torch.Tensor:
    """The plain route: ``F.linear``, then the exact GELU."""
    y = F.linear(x, weight, bias)
    return F.gelu(y) if gelu else y


def takes(x: torch.Tensor, weight) -> bool:
    """Whether the 3xTF32 route takes the product: f32 CUDA tensors, a whole
    (not sharded) weight, both of its sizes multiples of 8 (the kernel's
    16-byte rows and 8-column epilogue vectors, in all three products)."""
    return (x.device.type == "cuda" and x.dtype == torch.float32
            and isinstance(weight, torch.Tensor) and not isinstance(weight, DTensor)
            and weight.dtype == torch.float32 and weight.ndim == 2
            and weight.shape[0] % 8 == 0 and weight.shape[1] % 8 == 0)


def linear_tf32x3(x, weight, bias=None, gelu: bool = False) -> torch.Tensor:
    """``[gelu](x [..., K] @ weight [N, K]^T + bias [N])`` -> ``[..., N]`` f32
    in 3xTF32, forward and (under autograd) backward on the GEMM kernel
    (module docstring). CPU tensors take the plain version of the same
    decomposition."""
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    with annotate("kernel.linear_tf32x3"):
        if not needs_graph(x, weight, bias):
            return _forward(x2.contiguous(), weight, bias, gelu).reshape(*lead, -1)
        y = _Linear.apply(x2, weight, bias)
    return (F.gelu(y) if gelu else y).reshape(*lead, -1)


def _forward(x2, weight, bias, gelu) -> torch.Tensor:
    """Without a graph: one product, GELU in the epilogue."""
    if x2.device.type == "cpu":
        y = x2 @ weight.t() + (0.0 if bias is None else bias)
        return F.gelu(y) if gelu else y
    _check(x2, weight, bias)
    hi, lo = _weight_operands(weight, False)[:2]
    return _product(x2, hi, lo, bias, gelu)


def _check(x2, weight, bias) -> None:
    """The caller's tensors, checked once a call (those the wrapper makes
    from them are not checked again)."""
    build.check_cuda_inputs("linear_tf32x3", {"x": x2, "weight": weight, "bias": bias},
                            float_only=("x", "weight", "bias"))


class _Linear(torch.autograd.Function):
    """``x2 [M, K] @ W^T + b`` in 3xTF32, the three products of its
    backward on the same kernel (module docstring)."""

    @staticmethod
    def forward(ctx, x2, weight, bias):
        x2 = x2.contiguous()
        if x2.device.type == "cuda":
            _check(x2, weight, bias)
        need_x, need_w = ctx.needs_input_grad[:2]
        hi, lo, hi_t, lo_t = _weight_operands(weight, need_x)
        ctx.save_for_backward(x2 if need_w else None, hi_t, lo_t)
        ctx.has_bias = bias is not None
        return _product(x2, hi, lo, bias, False)

    @staticmethod
    def backward(ctx, dy):
        x2, hi_t, lo_t = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = dw = db = None
        with annotate("kernel.linear_tf32x3.backward"):
            dy = dy.contiguous()
            if need_x:
                dx = _product(dy, hi_t, lo_t, None, False, "linear_tf32x3.dx")
            if need_w:
                dw = _weight_grad(dy, x2)
            if need_b and ctx.has_bias:
                db = dy.sum(0)
        return dx, dw, db


# -- the operands ---------------------------------------------------------------
def split_t(t: torch.Tensor, ld: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``t [R, C]`` f32 -> ``(hi, lo)`` of ``t^T``, ``[C, ld]``, its columns
    from R on zero: one pass of ``arpu_split_tf32`` on the card, bit for bit
    :func:`.tf32x3.split_tf32` of the padded transpose."""
    r, c = t.shape
    if t.device.type == "cpu":
        return tf32x3.split_tf32(F.pad(t, (0, 0, 0, ld - r)).t().contiguous())
    return _split_kernel(t, transposed=True, straight=False, ld=ld)


def _split_kernel(t, *, transposed: bool, straight: bool, ld: int = 0) -> tuple:
    """``arpu_split_tf32`` on ``t [R, C]`` (contiguous f32 on the card):
    ``(hi, lo)`` ``[R, C]`` if ``straight``, then ``(hi_t, lo_t)`` ``[C, ld]`` if
    ``transposed``; each pair the two halves of one allocation, so that the
    forward's pair is freed while the backward's lives on."""
    r, c = t.shape
    outs, ptrs = [], []
    for want, shape in ((straight, (r, c)), (transposed, (c, ld))):
        pair = (torch.empty(2, *shape, device=t.device, dtype=torch.float32).unbind(0)
                if want else (None, None))
        outs += [o for o in pair if o is not None]
        ptrs += [build.ptr(o) for o in pair]
    fn = build.bind("gemm", "arpu_split_tf32", "p" "ii" "pppp" "i" "p")
    rc = fn(t.data_ptr(), r, c, *ptrs, ld, build.stream_of(t))
    build.check("gemm", rc, "split_tf32")
    launch_counts["split_tf32"] += 1
    return tuple(outs)


def _weight_operands(weight, transposed: bool) -> tuple:
    """``(hi, lo, hi_t, lo_t)`` of ``W [N, K]`` (``hi_t``/``lo_t``: W^T's
    split, ``[K, N]``, None unless ``transposed``), made in one pass once
    per weight version (:func:`.build.derived`: at every call for
    a weight that requires grad)."""
    if weight.device.type == "cpu":
        w = weight.detach()
        hi, lo = tf32x3.split_tf32(w)
        return (hi, lo, *(tf32x3.split_tf32(w.t().contiguous()) if transposed
                          else (None, None)))

    def make(w):
        return _split_kernel(w, transposed=transposed, straight=True, ld=w.shape[0])

    ops = derived(weight, ("linear_tf32x3", transposed), make)
    return ops if transposed else (*ops, None, None)


# -- the products ----------------------------------------------------------------
def _product(a, hi, lo, bias, gelu, count: str = "linear_tf32x3") -> torch.Tensor:
    """``a [M, K] @ (hi + lo)^T [+ bias] [-> gelu]``, ``hi``/``lo`` ``[N, K]``."""
    if a.device.type == "cpu":
        y = a @ (hi + lo).t()
        y = y if bias is None else y + bias
        return F.gelu(y) if gelu else y
    m, k = a.shape
    n = hi.shape[0]
    plan = tf32x3.gemm_plan(m, n, k, sm_count(a.device))
    out = torch.empty(m, n, device=a.device, dtype=torch.float32)
    tf32x3_launch(a, hi, lo, out, plan.bn, plan.stages, bias=bias, gelu=gelu)
    launch_counts[count] += 1
    return out


@dataclass(frozen=True)
class WeightGradPlan:
    """``dW`` of a linear with ``x [m, k]`` and ``dy [m, n]``: ``b_is_x``,
    which of them is split and transposed (the kernel's B; the other is its
    A, read transposed), the output ``[rows, cols]`` (``dW`` if ``b_is_x``,
    else ``dW^T``), the reduction ``red`` (m padded to a multiple of 4), and
    the GEMM's N tile, ring depth and K splits."""

    b_is_x: bool
    rows: int
    cols: int
    red: int
    bn: int
    stages: int
    splits: int


@functools.lru_cache(maxsize=256)
def weight_grad_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> WeightGradPlan:
    """The smaller of ``x`` and ``dy`` is split (``x`` on a tie: the output
    is then ``dW`` itself); then the N tile and the K splits whose
    modelled time is least: the waves of (split, tile) pairs times the
    k-tiles of a split and :data:`TILE_FIXED_KTILES` times a k-tile's time
    (``bn`` plus ``tf32x3.KTILE_FIXED_COLUMNS`` columns), plus the summation of
    the splits' slabs at :data:`REDUCE_BYTES_S`."""
    b_is_x = k <= n
    rows, cols = (n, k) if b_is_x else (k, n)
    red = -(-m // 4) * 4
    k_tiles = math.ceil(red / tf32x3.K_STEP)
    best = None
    for bn in tf32x3.GEMM_BNS:
        tiles = math.ceil(rows / tf32x3.ROWS) * math.ceil(cols / bn)
        for splits in range(1, min(MAX_SPLITS, k_tiles) + 1):
            per = math.ceil(k_tiles / splits)
            if (splits - 1) * per >= k_tiles:
                continue  # a split without a k-tile
            waves = math.ceil(tiles * splits / sms)
            t = (waves * (per + TILE_FIXED_KTILES) * KTILE_128_S
                 * (bn + tf32x3.KTILE_FIXED_COLUMNS) / (128 + tf32x3.KTILE_FIXED_COLUMNS))
            if splits > 1:
                t += (splits + 1) * rows * cols * 4 / REDUCE_BYTES_S
            if best is None or t < best[0]:
                best = (t, bn, splits)
    _, bn, splits = best
    stages, _ = tf32x3.ring(bn)
    return WeightGradPlan(b_is_x, rows, cols, red, bn, stages, splits)


def _weight_grad(dy, x2) -> torch.Tensor:
    """``dW = dy^T x2`` ``[N, K]`` (:class:`WeightGradPlan`)."""
    m, n = dy.shape
    k = x2.shape[1]
    dev = dy.device
    plan = weight_grad_plan(m, n, k, H100_SMS if dev.type == "cpu" else sm_count(dev))
    a, b = (dy, x2) if plan.b_is_x else (x2, dy)
    if plan.red != m:
        a = F.pad(a, (0, 0, 0, plan.red - m))
    hi, lo = split_t(b, plan.red)
    parts = _parts(a, hi, lo, plan)
    g = parts.sum(0) if plan.splits > 1 else parts
    return g if plan.b_is_x else g.t().contiguous()


def _parts(a, hi, lo, plan: WeightGradPlan) -> torch.Tensor:
    """``[splits, rows, cols]`` (``[rows, cols]`` with one split): split s
    of ``a^T @ (hi + lo)^T``, ``a [red, rows]``, ``hi``/``lo`` ``[cols,
    red]``, K cut as the kernel cuts it."""
    if a.device.type == "cpu":
        b = hi + lo
        kt = math.ceil(plan.red / tf32x3.K_STEP)
        step = tf32x3.K_STEP * math.ceil(kt / plan.splits)
        parts = [a[s:s + step].t() @ b[:, s:s + step].t() for s in range(0, plan.red, step)]
        return parts[0] if len(parts) == 1 else torch.stack(parts)
    shape = (plan.rows, plan.cols) if plan.splits == 1 else (plan.splits, plan.rows, plan.cols)
    out = torch.empty(shape, device=a.device, dtype=torch.float32)
    tf32x3_launch(a, hi, lo, out, plan.bn, plan.stages, a_t=True, splits=plan.splits)
    launch_counts["linear_tf32x3.dw"] += 1
    return out
