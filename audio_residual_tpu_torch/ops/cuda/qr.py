"""Blocked Householder QR of a batch of tall float64 blocks (``csrc/householder_qr.cu``).

``householder_qr(a [..., D, m]) -> Q [..., D, m]``, float64, ``D >= m``: the
thin Q of ``a``, whose columns span ``a``'s and are orthonormal. It
orthonormalises the subspace block of the randomized PCA finalize
(:mod:`audio_residual_tpu_torch.ops.pca`) after each product by the
covariance. Column signs follow LAPACK's reflectors (``R``'s diagonal
``-sign(alpha) ||x||``), which may differ from the library's QR on the card.

It replaces no TPU kernel: the JAX package orthonormalises the block by a
Gram matrix clamped at 1e-6 of its largest eigenvalue
(``audio_residual_tpu/ops/pca.py:161``), which loses the directions under
1e-3 of the first eigenvalue; the port keeps Householder. The library's
batched QR on the card runs the unblocked ``geqr2`` on these shapes, one
pass over the whole trailing block in device memory a column (its call
took 244.7 ms for 32 blocks of ``[4096, 784]`` on an H100 SXM at 700 W,
7.6 ms a block).

Design: a right-looking blocked QR in compact-WY form, batched over the
leading axes. The hand-written kernel factors the ``[D - j, nb]`` panel of
every batch entry in one launch, the panel on chip for all its columns (a
cluster of up to 8 blocks a panel, the rows split over them, 64 entries of
them in each thread's registers, the column steps' reductions through
distributed shared memory), and writes the reflectors ``V`` (explicit),
``R``'s diagonal block and the ``nb x nb`` triangular ``T`` of
``I - V T Vᵀ``. The panel is 32 columns wide up to D = 4096 (512 rows a
block); past that it halves as D doubles, to one column at D = 131072, the
most rows a cluster holds, so every D whose ``[D, D]`` float64 covariance fits
in the card's 80 GiB (D < 103600) runs. Every other product is a batched
float64 ``torch.matmul`` (cuBLAS on the float64 tensor cores): inside a block
of ``plan.block`` columns the panels update the rest of the block and their
``T`` merge into the block's (``T12 = -T11 V1ᵀV2 T22``); the block then
updates the trailing columns once, ``A2 -= V Tᵀ (Vᵀ A2)``, a product of
depth ``plan.block``; Q is the blocks applied to ``[I_m; 0]`` in reverse,
each to the columns from its own on. The work is ``4 D m² - 4/3 m³`` a
factor with its Q, bound at 0.14 ms a ``[4096, 784]`` factor by the card's
67 TFLOP/s of float64.

The plain version is ``torch.linalg.qr(a).Q``, taken only for CPU tensors;
a CUDA tensor runs the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from audio_residual_tpu_torch.ops.cuda import build, launch_counts
from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = ["householder_qr", "householder_qr_plain", "qr_plan", "QRPlan", "panel_split",
           "kernel_width", "rows_per_block"]

PANEL_WIDTH = 32     # the kernel's widest panel
BLOCK_COLUMNS = 128  # columns a trailing update applies at once
THREADS = 256        # a kernel block's threads
ENTRIES = 64         # panel entries a thread holds in registers
MAX_CTAS = 8         # blocks a cluster (the portable maximum)
MAX_ROWS = MAX_CTAS * THREADS * ENTRIES  # 131072: one-column panels


class QRPlan(NamedTuple):
    nb: int      # panel width: columns a kernel launch factors
    block: int   # columns a trailing update applies at once
    ctas: int    # blocks a cluster (a panel's rows split over them)


def kernel_width(w: int) -> int:
    """The kernel's width for a panel of ``w`` columns: the least power of
    two >= w."""
    return 1 << (w - 1).bit_length()


def rows_per_block(w: int) -> int:
    """The most panel rows a kernel block holds at a panel of ``w`` columns:
    its threads' 64 entries each, ``64 / W`` rows of ``W`` columns."""
    return THREADS * ENTRIES // kernel_width(w)


def qr_plan(d: int, m: int) -> QRPlan:
    """The launch plan of a ``[D, m]`` factor: the widest panel (up to 32
    columns) whose rows a cluster of 8 blocks holds, blocks of 128 columns,
    the rows over as few blocks as hold them; D up to 131072."""
    if m < 1 or d < m:
        raise ValueError(f"householder_qr: needs D >= m >= 1, got D={d}, m={m}")
    if d > MAX_ROWS:
        raise ValueError(f"householder_qr: D={d} rows exceed a cluster's {MAX_ROWS} (one-column "
                         "panels)")
    nb = PANEL_WIDTH
    while MAX_CTAS * rows_per_block(nb) < d:
        nb //= 2
    nb = min(nb, m)
    return QRPlan(nb=nb, block=min(BLOCK_COLUMNS, m), ctas=-(-d // rows_per_block(nb)))


def panel_split(rows: int, w: int, ctas: int) -> tuple[int, int]:
    """``(ctas, rows_per_cta)`` of one panel launch of ``rows`` rows and
    ``w`` columns: at most the plan's blocks, and few enough that block 0
    holds the ``w`` diagonal rows."""
    ctas = max(1, min(ctas, rows // w))
    return ctas, -(-rows // ctas)


def householder_qr_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version: the library's QR, its thin Q."""
    return torch.linalg.qr(a).Q


def householder_qr(a: torch.Tensor) -> torch.Tensor:
    """``a [..., D, m]`` float64, contiguous, ``D >= m`` -> thin ``Q [..., D,
    m]`` float64. CPU tensors take :func:`householder_qr_plain`."""
    with annotate("kernel.householder_qr"):
        if a.dtype != torch.float64:
            raise TypeError(f"householder_qr: a has dtype {a.dtype}, expected torch.float64")
        if a.ndim < 2 or a.shape[-2] < a.shape[-1] or a.shape[-1] < 1:
            raise ValueError(f"householder_qr: a must be [..., D, m] with D >= m >= 1, got "
                             f"{tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError("householder_qr: a must be contiguous")
        if a.device.type == "cpu":
            return householder_qr_plain(a)
        return _kernel(a)


def _kernel(a: torch.Tensor) -> torch.Tensor:
    """The blocked QR on a CUDA tensor: checks, the factor, Q, its count."""
    build.check_cuda_inputs("householder_qr", {"a": a}, dtypes=(torch.float64,))
    d, m = a.shape[-2:]
    blocks = a.numel() // (d * m)
    if d * m >= 2 ** 31 or not 0 < blocks <= 65535:
        raise ValueError(f"householder_qr: needs 1 to 65535 blocks of under 2**31 elements, "
                         f"got {blocks} of [{d}, {m}]")
    plan = qr_plan(d, m)
    work = a.reshape(-1, d, m).clone()
    v, ts = _factor(work, plan, lambda pa, pv, pt: _panel(pa, pv, pt, plan.ctas))
    q = _form_q(v, ts)
    launch_counts["householder_qr"] += 1
    return q.reshape(a.shape)


def _panel(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor, ctas: int) -> None:
    """One kernel launch: the panel ``a [B, rows, w]`` (a view, rows ``D``
    apart) factored in place, its reflectors into ``v`` (a view of the same
    strides) and its ``T`` into ``t [B, w, w]`` (a view)."""
    bsz, rows, w = a.shape
    ctas, rows_per_cta = panel_split(rows, w, ctas)
    fn = build.bind("householder_qr", "arpu_householder_panel", "ppp" "iiiii" "ii" "ii" "p")
    rc = fn(a.data_ptr(), v.data_ptr(), t.data_ptr(), bsz, a.stride(0), a.stride(1), rows, w,
            ctas, rows_per_cta, t.stride(0), t.stride(1), build.stream_of(a))
    build.check("householder_qr", rc, "householder_qr panel")


def _factor(work: torch.Tensor, plan: QRPlan, panel) -> tuple[torch.Tensor, list]:
    """``work [B, D, m]`` factored in place (``R`` in its upper triangle);
    returns the reflectors ``v [B, D, m]`` (zero above the diagonal, one on
    it) and each block's ``T [B, wb, wb]``. ``panel(a, v, t)`` factors one
    panel of views, as the kernel does."""
    bsz, d, m = work.shape
    v = torch.zeros_like(work)
    ts = []
    for j0 in range(0, m, plan.block):
        wb = min(plan.block, m - j0)
        t = work.new_zeros(bsz, wb, wb)
        for p in range(0, wb, plan.nb):
            j, w = j0 + p, min(plan.nb, wb - p)
            vp, tp = v[:, j:, j:j + w], t[:, p:p + w, p:p + w]
            panel(work[:, j:, j:j + w], vp, tp)
            if p + w < wb:
                rest = work[:, j:, j + w:j0 + wb]
                rest.baddbmm_(vp, tp.mT @ (vp.mT @ rest), alpha=-1)
            if p:
                t[:, :p, p:p + w] = t[:, :p, :p] @ (v[:, j:, j0:j].mT @ vp) @ -tp
        if j0 + wb < m:
            vb, rest = v[:, j0:, j0:j0 + wb], work[:, j0:, j0 + wb:]
            rest.baddbmm_(vb, t.mT @ (vb.mT @ rest), alpha=-1)
        ts.append(t)
    return v, ts


def _form_q(v: torch.Tensor, ts: list) -> torch.Tensor:
    """``Q = (I - V1 T1 V1ᵀ) ... (I - Vn Tn Vnᵀ) [I_m; 0]``, the blocks in
    reverse, each on the rows and columns from its first on (the columns
    before are still ``[I; 0]`` there)."""
    bsz, d, m = v.shape
    q = torch.zeros_like(v)
    q[:, :m].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    j0 = m
    for t in reversed(ts):
        j0 -= t.shape[-1]
        vb, rest = v[:, j0:, j0:j0 + t.shape[-1]], q[:, j0:, j0:]
        rest.baddbmm_(vb, t @ (vb.mT @ rest), alpha=-1)
    return q
