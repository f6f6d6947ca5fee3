"""Streaming PCA on the card.

Port of ``audio_residual_tpu/ops/pca.py``: exact second moments ``(n, Σx,
Σxxᵀ)`` accumulated on the device beside the forward (one rank-k product a
batch), then one eigendecomposition at the end. The finalized result is the
reference's PCA-pickle schema (``components``, ``mean``,
``explained_variance``, ``explained_variance_ratio``, ``total_variance``,
``n_components``, ``input_dim``, ``num_samples``; numpy), so a pickle written
by either package loads in the other's ``load_residual_params``.

The moments are f32 on the tapped tensors' device. Their updates are plain
f32 products (``torch.addmm`` / ``torch.baddbmm``) with TF32 off for the
call, as the JAX package's run at ``Precision.HIGHEST``.

Finalize: ``"dense"`` is the float64 eigh of the covariance on the host,
as in the JAX package. ``"randomized"`` runs the JAX package's subspace
iteration (Halko et al. 2011; Rayleigh-Ritz on the ``[m, m]`` projection)
on the moments' device, in float64 there: the H100 runs float64 products
at its f32 CUDA-core rate, and the covariance is formed once from the raw
moments in float64, so the mean term, far larger than the spread of
attention-probability rows, cancels without f32 rounding. Two departures
from the JAX package's TPU design: the block is orthonormalised by
Householder QR (``ops/cuda/qr.py``: blocked, its panels a hand-written
kernel on the card), not by gram whitening (``Q G^-1/2``, ``G`` clamped at 1e-6
of its largest eigenvalue), whose clamp shrinks every direction under 1e-3
of the first eigenvalue a little more each iteration, so the JAX package
reports such eigenvalues orders of magnitude too small; and the starting
block comes from a ``torch.Generator`` on the moments' device seeded by
``seed``, not ``jax.random.normal``. The two agree where the JAX
package's f32 iteration resolves the spectrum, not bit for bit.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import numpy as np
import torch

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.ops.common import golden_convs
from audio_residual_tpu_torch.ops.cuda.qr import householder_qr

__all__ = [
    "PCAState",
    "pca_init",
    "pca_update",
    "pca_finalize",
    "pca_save",
    "pca_load",
    "batched_pca_init",
    "batched_pca_update",
]


def _to_host(t, dtype) -> np.ndarray:
    """Every device -> host pull of this module, so a test can check that the
    randomized path never pulls the ``[*, D, D]`` moments."""
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, dtype)


class PCAState(NamedTuple):
    """Sufficient statistics for exact PCA. Leading batch axes are allowed
    (per head): ``n [...]``, ``sum [..., D]``, ``outer [..., D, D]``."""

    n: torch.Tensor
    sum: torch.Tensor
    outer: torch.Tensor


def pca_init(dim: int, dtype=torch.float32, device: str | torch.device | None = None) -> PCAState:
    """Zero moments of width ``dim`` on ``device`` (the card unless told)."""
    return batched_pca_init((), dim, dtype, device)


def batched_pca_init(batch_shape: tuple[int, ...], dim: int, dtype=torch.float32,
                     device: str | torch.device | None = None) -> PCAState:
    dev = resolve_device(device)
    return PCAState(
        n=torch.zeros(batch_shape, dtype=dtype, device=dev),
        sum=torch.zeros((*batch_shape, dim), dtype=dtype, device=dev),
        outer=torch.zeros((*batch_shape, dim, dim), dtype=dtype, device=dev),
    )


def pca_update(state: PCAState, x: torch.Tensor) -> PCAState:
    """Accumulate a batch ``x [..., D]`` (rows flattened). One ``xᵀx``."""
    x = x.reshape(-1, x.shape[-1]).to(state.outer)
    with golden_convs():  # Precision.HIGHEST
        outer = torch.addmm(state.outer, x.t(), x)
    return PCAState(n=state.n + x.shape[0], sum=state.sum + x.sum(dim=0), outer=outer)


def batched_pca_update(state: PCAState, x: torch.Tensor) -> PCAState:
    """``x [..., N, D]`` with leading axes matching the state's batch shape."""
    x = x.to(state.outer)
    d = x.shape[-1]
    flat = x.reshape(-1, x.shape[-2], d)
    with golden_convs():  # Precision.HIGHEST
        outer = torch.baddbmm(state.outer.reshape(-1, d, d), flat.transpose(1, 2), flat)
    return PCAState(n=state.n + x.shape[-2], sum=state.sum + x.sum(dim=-2),
                    outer=outer.reshape(state.outer.shape))


def _sign_flip(components: np.ndarray) -> np.ndarray:
    """Deterministic sign convention: the max-|.| element of each component
    is positive (sklearn's svd_flip convention on the V side)."""
    idx = np.argmax(np.abs(components), axis=-1, keepdims=True)
    signs = np.sign(np.take_along_axis(components, idx, axis=-1))
    signs = np.where(signs == 0, 1.0, signs)
    return components * signs


def _randomized_topk_eigh(n: torch.Tensor, s: torch.Tensor, outer: torch.Tensor,
                          generator: torch.Generator, *, k: int, iters: int = 6,
                          oversample: int = 16, with_components: bool = True) -> tuple:
    """Randomized top-k eigendecomposition of the moments' covariance on
    their device, in float64 (Halko et al. 2011 subspace iteration, as
    ``audio_residual_tpu/ops/pca.py::_randomized_topk_eigh``):
    ``iters + 1`` products by the covariance, each followed by a Householder
    QR of the block (:func:`.cuda.qr.householder_qr`: the blocked kernel on
    the card, the library's QR on the CPU), then Rayleigh-Ritz on ``QᵀCQ``;
    m = k + oversample.

    Returns ``(eigvals [..., k] descending, components [..., k, D] (or
    [..., 0, D] without them), mean [..., D], trace [...])``, float64 on the
    device: the only tensors that cross to the host."""
    f64 = torch.float64
    n = n.to(f64)
    mean = s.to(f64) / n[..., None]
    denom = torch.clamp(n - 1.0, min=1.0)
    cov = outer.to(f64)
    cov -= n[..., None, None] * mean[..., :, None] * mean[..., None, :]
    cov /= denom[..., None, None]
    d = cov.shape[-1]
    m = min(k + oversample, d)
    batch_shape = cov.shape[:-2]

    q = torch.randn((*batch_shape, d, m), generator=generator, dtype=f64, device=cov.device)
    for _ in range(iters + 1):
        q = householder_qr(cov @ q)
    b = q.transpose(-1, -2) @ (cov @ q)
    b = 0.5 * (b + b.transpose(-1, -2))
    w, u = torch.linalg.eigh(b)  # ascending, eigenvectors in columns
    w = w.flip(-1)[..., :k]
    u = u.flip(-1)[..., :k]
    if with_components:
        comps = (q @ u).transpose(-1, -2)
    else:
        comps = torch.zeros((*batch_shape, 0, d), dtype=f64, device=cov.device)
    trace = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)
    return w, comps, mean, trace


def pca_finalize(
    state: PCAState,
    n_components: int | None = None,
    *,
    method: str = "auto",
    return_components: bool = True,
    iters: int = 6,
    oversample: int = 16,
    seed: int = 0,
) -> dict:
    """Eigendecompose the accumulated covariance -> reference-schema dict of
    numpy arrays. Batched states too (leading axes broadcast through eigh).
    ``explained_variance`` uses the unbiased (n-1) normaliser like sklearn.

    ``method``:
      * ``"dense"`` -- exact full-spectrum eigh of the covariance on the host
        in float64. Right for small D (residual-stream PCA, D <= 768).
      * ``"randomized"`` -- :func:`_randomized_topk_eigh` on the moments'
        device, which sends only the top-k eigenpairs, the mean and the exact
        trace to the host; for large D (the per-head attention PCA's
        ``[60, 4096, 4096]`` moments). ``n_components`` defaults to
        min(768, D), as in the JAX package (it covers every 0.99-threshold
        crossing of the reference's shipped CSVs). Ratios divide by the
        exact trace, so they, the intrinsic dimension and the participation
        ratio match the dense path wherever the cumulative ratio crosses the
        threshold within k. On the card its QR takes D up to 131072
        (:func:`.cuda.qr.qr_plan`), past the largest ``[D, D]`` float64
        covariance the card's 80 GiB hold.
      * ``"auto"`` -- randomized iff D >= 1024.

    ``return_components=False`` skips the ``[k, D]`` eigenvector block (the
    attention analysis reads only the spectrum); ``"components"`` is then
    None."""
    d = state.outer.shape[-1]
    if method == "auto":
        method = "randomized" if d >= 1024 else "dense"

    if method == "randomized":
        k = min(n_components or 768, d)
        generator = torch.Generator(device=state.outer.device).manual_seed(seed)
        w, comps, mean, trace = _randomized_topk_eigh(
            state.n, state.sum, state.outer, generator, k=k, iters=iters,
            oversample=oversample, with_components=return_components)
        eigvals = np.maximum(_to_host(w, np.float64), 0.0)
        mean = _to_host(mean, np.float64)
        trace = np.maximum(_to_host(trace, np.float64), 0.0)
        ratio = eigvals / np.where(trace > 0, trace, 1.0)[..., None]
        components = (_sign_flip(_to_host(comps, np.float64)) if return_components else None)
        return {
            "components": components,
            "mean": mean,
            "explained_variance": eigvals,
            "explained_variance_ratio": ratio,
            "total_variance": trace,
            "n_components": k,
            "input_dim": d,
            "num_samples": _to_host(state.n, np.int64),
        }

    if method != "dense":
        raise ValueError(f"unknown pca_finalize method {method!r}")
    n = _to_host(state.n, np.float64)
    mean = _to_host(state.sum, np.float64) / n[..., None]
    outer = _to_host(state.outer, np.float64)
    cov = (outer - n[..., None, None] * mean[..., :, None] * mean[..., None, :]) / np.maximum(
        n[..., None, None] - 1.0, 1.0
    )
    eigvals, eigvecs = np.linalg.eigh(cov)  # ascending
    eigvals = eigvals[..., ::-1]
    components = np.swapaxes(eigvecs, -1, -2)[..., ::-1, :]  # rows are components
    components = _sign_flip(components)
    eigvals = np.maximum(eigvals, 0.0)
    total = eigvals.sum(axis=-1)
    ratio = eigvals / np.where(total > 0, total, 1.0)[..., None]
    k = n_components or d
    return {
        "components": components[..., :k, :] if return_components else None,
        "mean": mean,
        "explained_variance": eigvals[..., :k],
        "explained_variance_ratio": ratio[..., :k],
        "total_variance": total,
        "n_components": k,
        "input_dim": d,
        "num_samples": _to_host(state.n, np.int64),
    }


def pca_save(path: str, result: dict) -> None:
    """Pickle in the reference's format (`src/residual.py:153-157`)."""
    with open(path, "wb") as f:
        pickle.dump(result, f)


def pca_load(path: str) -> dict:
    """Unpickling runs code from the file: load only pickles this project
    wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)
