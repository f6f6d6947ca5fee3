"""ResiDual: learnable anisotropic rescaling in a fixed PCA basis.

Port of ``audio_residual_tpu/residual/module.py`` (arXiv:2411.00246):
``x_out = ((x - mean) @ basis.T * lam) @ basis`` with ``basis [K, D]`` and
``mean [D]`` frozen PCA statistics and ``lam [K]`` trainable (init ones).
Params are a plain dict of tensors, passed to the HTSAT forward as
``residual={layer: params}``; the fused block kernels run the epilogue.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from audio_residual_tpu_torch import resolve_device

__all__ = [
    "init_residual_params",
    "residual_apply",
    "load_residual_params",
    "save_residual_params",
]


def init_residual_params(basis, mean, n_components: int | None = None,
                         device: str | torch.device | None = None) -> dict:
    """ResiDual params from a PCA ``basis [D, D]`` / ``mean [D]``; keeps the
    leading ``n_components`` rows (default all); ``lam`` starts at ones.
    On the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    basis = torch.tensor(np.asarray(basis, dtype=np.float32), device=device)
    mean = torch.tensor(np.asarray(mean, dtype=np.float32), device=device)
    k = n_components or basis.shape[0]
    return {
        "basis": basis[:k].contiguous(),
        "mean": mean,
        "lam": torch.ones(k, dtype=torch.float32, device=device),
    }


def residual_apply(x: torch.Tensor, basis: torch.Tensor, mean: torch.Tensor,
                   lam: torch.Tensor) -> torch.Tensor:
    """``[..., D] -> [..., D]``: center, project, scale, reproject (f32)."""
    proj = (x.float() - mean) @ basis.t()
    return (proj * lam) @ basis


def load_residual_params(pca_path: str, n_components: int | None = None,
                         device: str | torch.device | None = None) -> dict:
    """Params from a reference-format PCA pickle (``components``, ``mean``).
    Unpickling runs code from the file: load only pickles this project wrote."""
    with open(pca_path, "rb") as f:
        pca = pickle.load(f)
    return init_residual_params(
        np.asarray(pca["components"]), np.asarray(pca["mean"]), n_components, device
    )


def save_residual_params(path: str, params: dict, extra: dict | None = None) -> None:
    """Persist basis/mean/lam in the same pickle schema as the JAX package."""
    blob = {
        "components": params["basis"].detach().cpu().numpy(),
        "mean": params["mean"].detach().cpu().numpy(),
        "lam": params["lam"].detach().cpu().numpy(),
    }
    if extra:
        blob.update(extra)
    with open(path, "wb") as f:
        pickle.dump(blob, f)
