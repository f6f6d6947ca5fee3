"""Plain reference of the attention-PCA analysis: per (layer, head), the
covariance of the flattened window-attention maps and its leading
eigenvalues, with the exact total variance.

Written for the benchmark; it imports nothing of the program. The moments
accumulate in float64 (``"f32"``); the control rounds the rows to the
precision below (``"tf32"``) and accumulates in f32, as a lower-precision
program would. The top of the spectrum comes from a block subspace
iteration (Halko et al. 2011) in float64 with more iterations than the
program's finalize, then Rayleigh-Ritz; only the leading eigenvalues, which
that iteration resolves, are compared.
"""

from __future__ import annotations

import torch

from benchmark.reference.htsat import Precision

__all__ = ["Moments", "top_spectrum"]


class Moments:
    """Row count, row sum and ``Σ xᵀx`` for ``heads`` heads of ``dim``-wide
    rows."""

    def __init__(self, heads: int, dim: int, device, prec: Precision):
        self.prec = prec
        dt = torch.float64 if prec.name == "f32" else torch.float32
        self.n = 0
        self.sum = torch.zeros(heads, dim, dtype=dt, device=device)
        self.outer = torch.zeros(heads, dim, dim, dtype=dt, device=device)

    def update(self, probs: torch.Tensor) -> None:
        """``probs [W, heads, n, n]``: each (window, head) gives one row."""
        w, h, n, _ = probs.shape
        rows = self.prec.round(probs).permute(1, 0, 2, 3).reshape(h, w, n * n)
        rows = rows.to(self.outer.dtype)
        self.n += w
        self.sum += rows.sum(1)
        with self.prec.context():
            self.outer.baddbmm_(rows.transpose(1, 2), rows)


def top_spectrum(m: Moments, k: int, generator: torch.Generator, *, block: int = 64,
                 iters: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """``(eigenvalues [heads, k] descending, trace [heads])`` of the
    unbiased covariance, in float64."""
    f64 = torch.float64
    mean = m.sum.to(f64) / m.n
    cov = m.outer.to(f64) - m.n * mean[:, :, None] * mean[:, None, :]
    cov /= max(m.n - 1, 1)
    heads, d, _ = cov.shape
    q = torch.randn(heads, d, block, dtype=f64, device=cov.device, generator=generator)
    for _ in range(iters):
        q = torch.linalg.qr(cov @ q).Q
    b = q.transpose(1, 2) @ cov @ q
    w = torch.linalg.eigvalsh(0.5 * (b + b.transpose(1, 2))).flip(-1)
    return w[:, :k], torch.diagonal(cov, dim1=1, dim2=2).sum(-1)
