"""The blocked Householder QR of the PCA finalize (``ops/cuda/qr.py``) on
the CPU: the wrapper's refusals, its CPU route (the library's QR), the
launch plan at the finalize's shapes, and the blocked algorithm around the
panel kernel -- the panels' in-block updates, the merged ``T`` of a block,
the trailing updates and forming Q -- driven by a replay of the kernel's
column steps in plain float64, against the library's QR.

Tolerances: the replay follows LAPACK's reflectors, so on a full-rank
block its Q and R are the library's to rounding (1e-12 of the entries,
which are at most 1 in Q); on a rank-deficient block the columns past the
rank are any orthonormal completion, so there only orthonormality and the
span are held (1e-12).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_residual_tpu_torch.ops.cuda import launch_counts
from audio_residual_tpu_torch.ops.cuda import qr

from .torch_threads import one_cpu_thread  # noqa: F401


def _replay_panel(a: torch.Tensor, v: torch.Tensor, t: torch.Tensor) -> None:
    """The kernel's column steps (``csrc/householder_qr.cu``) on one panel
    of views ``a, v [B, rows, w]``, ``t [B, w, w]``, with its scalars: the
    dots of column c with every column below the diagonal, ``y_k = a_ck +
    s_k / (alpha - beta)``, ``w_k = tau y_k``, T's column ``-tau T y``."""
    p = a.clone()
    bsz, rows, w = p.shape
    tt = torch.zeros(bsz, w, w, dtype=p.dtype)
    for c in range(w):
        x = p[:, c + 1:, c]
        s = torch.einsum("br,brk->bk", x, p[:, c + 1:, :])
        rho = p[:, c, :].clone()
        alpha, xnorm2 = rho[:, c], s[:, c]
        zero = xnorm2 == 0
        beta = torch.where(zero, alpha, -torch.copysign(torch.sqrt(alpha * alpha + xnorm2), alpha))
        tau = torch.where(zero, 0.0, (beta - alpha) / beta)
        scale = torch.where(zero, 0.0, 1.0 / (alpha - beta))
        y = rho + s * scale[:, None]
        tt[:, :c, c] = -tau[:, None] * (tt[:, :c, :c] @ y[:, :c, None])[..., 0]
        tt[:, c, c] = tau
        vc = torch.cat([torch.ones(bsz, 1, dtype=p.dtype), x * scale[:, None]], dim=1)
        p[:, c:, c + 1:] -= vc[:, :, None] * (tau[:, None] * y)[:, None, c + 1:]
        p[:, c + 1:, c] = x * scale[:, None]
        p[:, c, c] = beta
    below = torch.arange(rows)[:, None] > torch.arange(w)[None, :]
    diag = torch.arange(rows)[:, None] == torch.arange(w)[None, :]
    v.copy_(torch.where(below, p, diag.to(p.dtype)))
    a[:, :w].copy_(torch.where(below[:w], a[:, :w], p[:, :w]))
    t.copy_(tt)


def _blocked(a: torch.Tensor, plan: qr.QRPlan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Q, R)`` of ``a [B, D, m]`` by the wrapper's blocked algorithm with
    the replayed panel, at ``plan`` (by default the plan of its shape)."""
    work = a.clone()
    v, ts = qr._factor(work, plan or qr.qr_plan(*a.shape[-2:]), _replay_panel)
    m = a.shape[-1]
    return qr._form_q(v, ts), torch.triu(work[:, :m])


def _block(shape, rank=None, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    b, d, m = shape
    if rank is None:
        return torch.from_numpy(rng.standard_normal(shape))
    return torch.from_numpy(rng.standard_normal((b, d, rank)) @ rng.standard_normal((b, rank, m)))


@pytest.mark.parametrize("a,error", [
    (torch.zeros(64, 8, dtype=torch.float32), TypeError),
    (torch.zeros(2, 8, 16, dtype=torch.float64), ValueError),
    (torch.zeros(2, 16, 64, dtype=torch.float64).mT, ValueError),
], ids=["float32", "d_under_m", "non_contiguous"])
def test_wrapper_refuses_what_it_does_not_take(a, error):
    with pytest.raises(error, match="householder_qr"):
        qr.householder_qr(a)


def test_cpu_takes_the_plain_version_in_its_span():
    a = _block((3, 96, 20))
    launch_counts.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = qr.householder_qr(a)
    assert torch.equal(got, torch.linalg.qr(a).Q)
    assert launch_counts["householder_qr"] == 0
    assert [e.name for e in prof.events()].count("kernel.householder_qr") == 1


@pytest.mark.parametrize("d,m,plan", [
    (4096, 784, (32, 128, 8)),    # the analysis path: HTSAT windows of 8, k = 768
    (4096, 24, (24, 24, 8)),      # k = 8, the narrowest block "auto" gives
    (1024, 48, (32, 48, 2)),      # D = 1024, the least "auto" takes randomized at
    (8192, 784, (16, 128, 8)),    # past 4096 rows the panel halves as D doubles
    (10000, 784, (8, 128, 5)),    # windows of 10
    (20736, 784, (4, 128, 6)),    # windows of 12
    (131072, 24, (1, 24, 8)),     # the most rows a cluster holds: one-column panels
])
def test_plan_at_the_finalize_shapes(d, m, plan):
    got = qr.qr_plan(d, m)
    assert tuple(got) == plan
    for j in range(0, m, got.nb):
        rows, w = d - j, min(got.nb, m - j)
        ctas, per = qr.panel_split(rows, w, got.ctas)
        assert w <= per <= qr.rows_per_block(w) and ctas * per >= rows and (ctas - 1) * per < rows


@pytest.mark.parametrize("w,width,rows", [(32, 32, 512), (24, 32, 512), (16, 16, 1024),
                                          (9, 16, 1024), (5, 8, 2048), (3, 4, 4096),
                                          (2, 2, 8192), (1, 1, 16384)])
def test_kernel_width_holds_the_panel(w, width, rows):
    """A panel of w columns runs the kernel of the least power-of-two width
    W >= w, whose block holds 64 / W rows a thread of 256."""
    assert qr.kernel_width(w) == width and qr.rows_per_block(w) == rows


def test_plan_refuses_rows_beyond_a_cluster():
    with pytest.raises(ValueError, match="cluster"):
        qr.qr_plan(qr.MAX_ROWS + 1, 24)
    assert qr.panel_split(60, 32, 8) == (1, 60)
    assert qr.panel_split(4096, 32, 8) == (8, 512)


@pytest.mark.parametrize("shape,plan", [
    ((2, 300, 150), None), ((1, 64, 24), None), ((1, 96, 40), qr.QRPlan(nb=4, block=16, ctas=1)),
], ids=["blocks", "one_panel", "narrow_panels"])
def test_blocked_factor_gives_the_library_qr(shape, plan):
    """The narrow panels: the plan of a tall block (past 4096 rows), at a
    size the replay runs, with a last block and panel cut short."""
    a = _block(shape, seed=1)
    q, r = _blocked(a, plan)
    ref = torch.linalg.qr(a)
    torch.testing.assert_close(q, ref.Q, rtol=0, atol=1e-12)
    torch.testing.assert_close(r, ref.R, rtol=0, atol=1e-12 * float(a.abs().max()) * shape[1])


def test_blocked_factor_spans_a_rank_deficient_block():
    """Rank 60 of 150 columns: Q orthonormal, and Q Qᵀ A = A."""
    a = _block((2, 300, 150), rank=60, seed=2)
    q, _ = _blocked(a)
    eye = torch.eye(150, dtype=torch.float64)
    assert float((q.mT @ q - eye).abs().max()) <= 1e-12
    assert float(torch.linalg.norm(q @ (q.mT @ a) - a) / torch.linalg.norm(a)) <= 1e-12
