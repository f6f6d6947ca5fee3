"""3xTF32: f32 products on the TF32 tensor cores, with about f32's accuracy.

An f32 value ``x`` splits into ``hi``, ``x`` rounded to TF32 (10 explicit
mantissa bits, to nearest with ties away from zero, the low 13 bits cleared,
as ``cvt.rna.tf32.f32`` rounds), and ``lo = x - hi``, exact in f32, with
``|lo| <= 2^-11 |x|`` for a normal ``x``. A product ``a w`` is then
``lo_a hi_w + hi_a lo_w + hi_a hi_w``, summed in f32 (``lo_a lo_w``, near
``2^-22`` of it, is dropped): golden K1 (``csrc/logmel.cu``) and every
other golden product of the port -- the qkv, proj, fc1 and fc2 of K2-K5 --
and the ResiDual GEMMs of both modes (``csrc/gemm_sm90.cuh::gemm_tf32x3``)
run that on ``wgmma`` at three passes of the 495 TFLOP/s TF32 rate. It is the Hopper
form of the TPU's ``Precision.HIGHEST`` (a split into bf16 passes on the
MXU), not PyTorch's TF32 mode, which stays off. The kernels split the
activations as they read them; the weights and the DFT basis are split here,
once per weight version (:func:`split_weights`, kept beside the weight as
:func:`.build.mxu_weights` keeps the bf16 copies).

:func:`gemm_plan` is the launch plan of the 3xTF32 GEMM: the N tile and the
ring depth, which the C entries check against their build. :func:`operand`
gives a weight as one product takes it (split, plan), and
:func:`residual_operands` a ResiDual's two products, with its component
count padded to a multiple of 8.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops.cuda.build import H100_SMS, SMEM_LIMIT, derived

__all__ = ["split_tf32", "split_weights", "gemm_plan", "GemmPlan", "GEMM_BNS", "Operand",
           "operand", "Residual", "residual_operands", "padded_components",
           "NO_OPERAND", "NO_RESIDUAL"]

_HALF_STEP = 1 << 12  # half a TF32 step, in units of the last f32 bit
_KEEP = -(1 << 13)    # 0xffffe000 as int32: clears the 13 f32 bits TF32 drops

# the GEMM's constants (csrc/gemm_sm90.cuh, Tiles<BN, 2>)
GEMM_BNS = (128, 96, 64, 32)  # N tiles the kernel is built for, the largest first
ROWS = 128                    # rows of a tile: two consumer warpgroups of 64
ROW_BYTES = 128               # a K step: 32 f32, one 128-byte swizzle row
K_STEP = ROW_BYTES // 4       # f32 columns of K a step
MAX_STAGES = 8
# A k-step of a tile costs its N tile plus this many columns: the tensor
# core's three passes scale with the N tile, the A fragment's load and split
# does not (fitted to the GEMM's times at M = 7392 on the H100,
# tools/time_linear.py --sweep: at N = 768 and 3072 the 128-column tile is
# fastest, though the 32-column one has fewer ragged waves)
KTILE_FIXED_COLUMNS = 32


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


def ring(bn: int) -> tuple[int, int]:
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
    width plus :data:`KTILE_FIXED_COLUMNS` is least -- the columns an SM
    computes, ragged waves counted, and what each k-step of a tile costs
    whatever its width -- the larger on a tie; a tile that does not divide
    ``n`` is masked at the edge. ``ValueError`` for a shape the kernel does
    not take."""
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
        cost = math.ceil(tiles / sms) * (bn + KTILE_FIXED_COLUMNS)
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    stages, smem = ring(bn)
    return GemmPlan(bn=bn, stages=stages, smem_bytes=smem, tiles=tiles, grid=min(tiles, sms))


@dataclass(frozen=True)
class Operand:
    """A weight ``W [N, K]`` as one 3xTF32 product ``[rows, K] @ W^T`` takes
    it: ``hi`` and ``lo`` and the product's plan. The wrapper holds it until
    its launch is enqueued, so a split made for one call lives that long."""

    hi: torch.Tensor
    lo: torch.Tensor
    plan: GemmPlan

    def args(self) -> tuple:
        """``(hi, lo, N tile, ring stages)`` in the order the C entries take them."""
        return self.hi.data_ptr(), self.lo.data_ptr(), self.plan.bn, self.plan.stages


NO_OPERAND = (None, 0, 0)
"""What follows a bf16 (AMP) weight's pointer where a golden one's lo part
and plan go."""


def operand(w: torch.Tensor, rows: int, sms: int) -> Operand:
    """``w [N, K]`` f32 split once per weight version, with the plan of its
    product on ``rows`` rows."""
    ((hi, lo),) = split_weights(w)
    return Operand(hi, lo, gemm_plan(rows, w.shape[0], w.shape[1], sms))


def padded_components(kr: int) -> int:
    """A ResiDual's component count as its products take it: ``kr`` rounded
    up to a multiple of 8, the N of the first product (the epilogue's
    8-column vectors) and the K of the second (16-byte TMA rows)."""
    return -(-kr // 8) * 8


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    return F.pad(t, (0,) * (2 * t.ndim - 1) + (rows - t.shape[0],))


@dataclass(frozen=True)
class Residual:
    """A ResiDual ``((a - mean) @ basis^T * lam) @ basis`` as its two 3xTF32
    products take it, with ``kr`` padded to :func:`padded_components`:
    ``basis [kr, C]`` with zero rows, ``basis_t [C, kr]`` with zero columns,
    ``lam [kr]`` with zeros. A padded component's column of the first
    product is 0 * lam = 0, and its row of ``basis`` is 0, so both products
    give the unpadded values."""

    basis: Operand
    basis_t: Operand
    mean: torch.Tensor
    lam: torch.Tensor
    kr: int

    def args(self) -> tuple:
        """In the order the C entries take them: basis (hi, lo, plan),
        basis_t (hi, lo, plan), mean, lam, kr."""
        return (*self.basis.args(), *self.basis_t.args(), self.mean.data_ptr(),
                self.lam.data_ptr(), self.kr)


NO_RESIDUAL = (None, None, 0, 0, None, None, 0, 0, None, None, 0)
"""The C entries' ResiDual arguments without a ResiDual."""


def residual_operands(basis: torch.Tensor, mean: torch.Tensor, lam: torch.Tensor, rows: int,
                      sms: int) -> Residual:
    """``basis [kr, C]``, ``mean [C]``, ``lam [kr]`` (f32) as the ResiDual's
    products on ``rows`` rows take them: the padded basis and its transpose
    split once per basis version, ``lam`` padded at each call (it changes
    at every step of λ-training)."""
    kr, c = basis.shape
    k8 = padded_components(kr)

    def split(b):
        b8 = _pad_rows(b, k8)
        return (*split_tf32(b8), *split_tf32(b8.t().contiguous()))

    b_hi, b_lo, bt_hi, bt_lo = derived(basis, ("residual", k8), split)
    lam8 = lam if k8 == kr else _pad_rows(lam, k8)
    return Residual(Operand(b_hi, b_lo, gemm_plan(rows, k8, c, sms)),
                    Operand(bt_hi, bt_lo, gemm_plan(rows, c, k8, sms)), mean, lam8.contiguous(),
                    k8)
