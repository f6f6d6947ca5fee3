"""Representation analysis: per-(layer, head) attention PCA and residual-stream
PCA, with intrinsic-dimensionality metrics and reference-compatible I/O.

Port of ``audio_residual_tpu/residual/analyze.py`` (the reference's
`src/analyze_attention.py` and `src/residual.py:103-159`). The moments
accumulate on the card beside the tapped forward
(:mod:`audio_residual_tpu_torch.ops.pca`); only the final spectra come back.
``encode_fn`` is a closure over the port's ``encode_audio(..., taps=...)``.

Metrics (`analyze_attention.py:87-88`):
  * intrinsic_dim = #components reaching 99% cumulative explained variance
    (``(cumsum < 0.99).sum() + 1``)
  * participation_ratio = (Σλ)² / Σλ²
The CSV schema matches `save_pca_results_on_file` exactly (pr/intrinsic_dim
only on each head's first row).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Callable, Iterable

import numpy as np
import torch

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.ops import pca as pca_ops

__all__ = [
    "intrinsic_dim",
    "participation_ratio",
    "AttentionPCA",
    "ResidualPCA",
    "save_pca_results_on_file",
    "load_pca_csv_results",
    "compute_pca_components",
    "run_pca",
]


def intrinsic_dim(explained_variance_ratio: np.ndarray, threshold: float = 0.99) -> int:
    """#components reaching ``threshold`` cumulative explained variance.

    `analyze_attention.py:87` uses 0.99; the reference's shipped
    `pca_results/*.csv` were made with 0.90 (pass ``threshold=0.90`` to
    reproduce them)."""
    cumsum = np.cumsum(np.asarray(explained_variance_ratio))
    return int((cumsum < threshold).sum() + 1)


def participation_ratio(explained_variance: np.ndarray) -> float:
    ev = np.asarray(explained_variance, np.float64)
    return float(ev.sum() ** 2 / np.sum(ev**2))


class AttentionPCA:
    """Streaming per-(layer, head) PCA over flattened window-attention maps.

    Feed it the ``layers_attention`` tap (per layer ``[B*nW, heads, N, N]``);
    each (window, head) contributes one N² row (`analyze_attention.py:39-44`).
    The moments live on ``device`` (the card unless told)."""

    def __init__(self, num_heads: Iterable[int], n: int = 64,
                 device: str | torch.device | None = None):
        self.num_heads = tuple(num_heads)
        self.dim = n * n
        self.device = resolve_device(device)
        self.states = [pca_ops.batched_pca_init((h,), self.dim, device=self.device)
                       for h in self.num_heads]

    def update(self, layers_attention: list[torch.Tensor]) -> None:
        for i, attn in enumerate(layers_attention):
            # [B*nW, H, N, N] -> [H, B*nW, N*N]
            bnw, h, n, _ = attn.shape
            rows = attn.permute(1, 0, 2, 3).reshape(h, bnw, n * n)
            self.states[i] = pca_ops.batched_pca_update(self.states[i], rows)

    def finalize(self, n_components: int | None = None, *,
                 return_components: bool = False) -> dict:
        """-> {(layer, head): reference-schema result dict}. Without
        components by default: the attention analysis's CSVs read only the
        spectrum."""
        out = {}
        for layer, state in enumerate(self.states):
            heads = self.num_heads[layer]
            res = pca_ops.pca_finalize(state, n_components, return_components=return_components)
            for head in range(heads):
                out[(layer, head)] = {
                    k: (v[head] if isinstance(v, np.ndarray) and v.ndim > 0
                        and v.shape[0] == heads else v)
                    for k, v in res.items()
                }
        return out


class ResidualPCA:
    """Streaming PCA over a layer's post-attention residual stream (the
    ``layers_residuals[target_layer]`` tap, ``[B, N_total, D]``): the
    reference's `compute_pca_components` (`src/residual.py:103-159`)."""

    def __init__(self, dim: int, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.state = pca_ops.pca_init(dim, device=self.device)

    def update(self, residuals: torch.Tensor) -> None:
        self.state = pca_ops.pca_update(self.state, residuals.reshape(-1, residuals.shape[-1]))

    def finalize(self, n_components: int | None = None) -> dict:
        return pca_ops.pca_finalize(self.state, n_components)


def compute_pca_components(
    encode_fn: Callable[[torch.Tensor], dict],
    batches: Iterable,
    target_layer: int,
    layer_dim: int,
    *,
    n_components: int | None = None,
    max_batches: int | None = None,
    save_path: str | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Stream ``batches`` (waveform arrays) through ``encode_fn`` (a closure
    returning the tap dict) and PCA the target layer's residual stream on
    ``device`` (the card unless told). Returns, and with ``save_path``
    pickles, the reference-format result."""
    rp = ResidualPCA(layer_dim, device)
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        with torch.no_grad():
            out = encode_fn(torch.as_tensor(batch, device=rp.device))
        rp.update(out["layers_residuals"][target_layer])
    result = rp.finalize(n_components)
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        pca_ops.pca_save(save_path, result)
    return result


def run_pca(
    encode_fn: Callable[[torch.Tensor], dict],
    batches: Iterable,
    num_layers: int,
    num_heads: Iterable[int],
    *,
    n_components: int | None = None,
    max_batches: int | None = None,
    window: int = 8,
    device: str | torch.device | None = None,
) -> dict:
    """Per-(layer, head) attention PCA over a dataset, on ``device`` (the
    card unless told): the reference's `run_PCA`
    (`analyze_attention.py:13-59`). ``num_layers`` is kept for the JAX
    package's signature; the layers are those of ``num_heads``."""
    # attention maps are [..., N, N] with N = window² tokens; PCA rows are N²
    ap = AttentionPCA(num_heads, n=window * window, device=device)
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        with torch.no_grad():
            out = encode_fn(torch.as_tensor(batch, device=ap.device))
        ap.update(out["layers_attention"])
    return ap.finalize(n_components)


def save_pca_results_on_file(save_dir: str, dataset_name: str, fold: int, results: dict) -> str:
    """Write the reference CSV schema (`analyze_attention.py:62-99`).

    ``results``: {(layer, head): result dict} from :class:`AttentionPCA`."""
    os.makedirs(save_dir, exist_ok=True)
    csv_path = os.path.join(save_dir, f"{dataset_name}-fold{fold}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["layer", "head", "component_index", "explained_variance",
                    "explained_variance_ratio", "participation_ratio", "intrinsic_dim"])
        for (layer, head), res in sorted(results.items()):
            ev = np.asarray(res["explained_variance"])
            ratio = np.asarray(res["explained_variance_ratio"])
            idim = intrinsic_dim(ratio)
            pr = participation_ratio(ev)
            for i, (e, r) in enumerate(zip(ev, ratio)):
                w.writerow([layer, head, i, e, r, pr if i == 0 else "", idim if i == 0 else ""])
    return csv_path


def load_pca_csv_results(path: str) -> dict:
    """Read either this project's CSVs or the reference's shipped
    `pca_results/*.csv` (`analyze_attention.py:102-130` semantics)."""
    results: dict = defaultdict(
        lambda: {
            "explained_variance": [],
            "explained_variance_ratio": [],
            "participation_ratio": None,
            "intrinsic_dim": None,
        }
    )
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            key = (int(row["layer"]), int(row["head"]))
            results[key]["explained_variance"].append(float(row["explained_variance"]))
            results[key]["explained_variance_ratio"].append(
                float(row["explained_variance_ratio"]))
            if row.get("participation_ratio") and results[key]["participation_ratio"] is None:
                results[key]["participation_ratio"] = float(row["participation_ratio"])
            if row.get("intrinsic_dim") and results[key]["intrinsic_dim"] is None:
                results[key]["intrinsic_dim"] = float(row["intrinsic_dim"])
    return dict(results)
