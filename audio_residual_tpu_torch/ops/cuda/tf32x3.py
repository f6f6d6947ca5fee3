"""3xTF32: f32 products on the TF32 tensor cores, with about f32's accuracy.

An f32 value ``x`` splits into ``hi``, ``x`` rounded to TF32 (10 explicit
mantissa bits, to nearest with ties away from zero, the low 13 bits cleared,
as ``cvt.rna.tf32.f32`` rounds), and ``lo = x - hi``, exact in f32, with
``|lo| <= 2^-11 |x|`` for a normal ``x``. A product ``a w`` is then
``lo_a hi_w + hi_a lo_w + hi_a hi_w``, summed in f32 (``lo_a lo_w``, near
``2^-22`` of it, is dropped): the golden kernels of K1 (``csrc/logmel.cu``)
and of K3's and K4's FFN (``csrc/gemm_sm90.cuh::gemm_tf32x3``) run that on
``wgmma`` at three passes of the 495 TFLOP/s TF32 rate. It is the Hopper
form of the TPU's ``Precision.HIGHEST`` (a split into bf16 passes on the
MXU), not PyTorch's TF32 mode, which stays off. The kernels split the
activations as they read them; the weights and the DFT basis are split here,
once per weight version (:func:`split_weights`, kept beside the weight as
:func:`.window_attention.mxu_weights` keeps the bf16 copies).

:func:`gemm_plan` is the launch plan of the 3xTF32 GEMM: the N tile and the
ring depth, which the C entries check against their build.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from audio_residual_tpu_torch.ops.cuda.window_attention import H100_SMS, SMEM_LIMIT, derived

__all__ = ["split_tf32", "split_weights", "gemm_plan", "GemmPlan", "GEMM_BNS"]

_HALF_STEP = 1 << 12  # half a TF32 step, in units of the last f32 bit
_KEEP = -(1 << 13)    # 0xffffe000 as int32: clears the 13 f32 bits TF32 drops

# the GEMM's constants (csrc/gemm_sm90.cuh, Tiles<BN, 2>)
GEMM_BNS = (128, 96, 64, 32)  # N tiles the kernel is built for, the largest first
ROWS = 128                    # rows of a tile: two consumer warpgroups of 64
ROW_BYTES = 128               # a K step: 32 f32, one 128-byte swizzle row
MAX_STAGES = 8


def split_tf32(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``t`` f32 -> ``(hi, lo)`` f32 with ``hi + lo == t`` exactly: ``hi``
    is ``t`` rounded to TF32, to nearest with ties away from zero (half a
    TF32 step added to the magnitude bits, then the low 13 bits cleared: an
    f32 is sign and magnitude, so one integer add rounds either sign), and
    ``lo`` the remainder. Infinities and NaN keep their bits in ``hi`` with
    ``lo = 0``; a finite value within half a step of the largest f32 rounds
    to infinity."""
    if t.dtype != torch.float32:
        raise TypeError(f"split_tf32: expected float32, got {t.dtype}")
    t = t.contiguous()
    bits = t.view(torch.int32)
    finite = torch.isfinite(t)
    hi = torch.where(finite, (bits + _HALF_STEP) & _KEEP, bits).view(torch.float32)
    lo = torch.where(finite, t - hi, torch.zeros_like(t))
    return hi, lo


def split_weights(*weights) -> tuple:
    """``(hi, lo)`` of each f32 weight, made once per weight version."""
    return tuple(derived(w, "tf32x3", split_tf32) for w in weights)


@dataclass(frozen=True)
class GemmPlan:
    """The 3xTF32 GEMM's launch: N tiles of ``bn`` columns, ``stages`` ring
    stages (each A [128, 32] and W's hi and lo [bn, 32], f32), ``tiles``
    output tiles walked by ``grid`` persistent blocks."""

    bn: int
    stages: int
    smem_bytes: int
    tiles: int
    grid: int


def _ring(bn: int) -> tuple[int, int]:
    """``(stages, shared bytes)`` of the kernel at N tile ``bn``: the ring
    takes what shared memory leaves after 1 KB of alignment slack, the
    epilogue's staging ([64, bn] f32 a consumer warpgroup, rows padded by 8)
    and the barriers."""
    stage = ROWS * ROW_BYTES + 2 * bn * ROW_BYTES
    staging = 2 * 64 * (bn + 8) * 4
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - staging - 256) // stage)
    return stages, 1024 + stages * stage + staging + 2 * stages * 8


@functools.lru_cache(maxsize=256)
def gemm_plan(m: int, n: int, k: int, sms: int = H100_SMS) -> GemmPlan:
    """The plan of ``[m, k] @ [n, k]^T`` on a card of ``sms`` SMs: the N tile
    of ``GEMM_BNS`` whose waves of tiles (``ceil(tiles / sms)``) times its
    width is least -- the columns an SM computes, ragged waves counted --
    the larger on a tie; a tile that does not divide ``n`` is masked at the
    edge. ``ValueError`` for a shape the kernel does not take."""
    if m <= 0 or n <= 0 or k <= 0:
        raise ValueError(f"3xTF32 GEMM: empty shape M={m} N={n} K={k}")
    if k % 4:
        raise ValueError(f"3xTF32 GEMM: K={k} is no multiple of 4 (16-byte TMA rows of f32)")
    if n % 8:
        raise ValueError(f"3xTF32 GEMM: N={n} is no multiple of 8 (the epilogue's 8-column "
                         "vectors)")
    best = None
    for bn in GEMM_BNS:
        tiles = math.ceil(m / ROWS) * math.ceil(n / bn)
        cost = math.ceil(tiles / sms) * bn
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    stages, smem = _ring(bn)
    return GemmPlan(bn=bn, stages=stages, smem_bytes=smem, tiles=tiles, grid=min(tiles, sms))
