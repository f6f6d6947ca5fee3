"""Mixup helpers, from ``audio_residual_tpu/utils/misc.py`` (the reference's
`utils.py:189-208`). The rest of that module joins the port later."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_mix_lambda", "do_mixup"]


def get_mix_lambda(mixup_alpha: float, batch_size: int,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Beta-sampled mixup coefficients (`utils.py:189-193`)."""
    rng = rng or np.random.default_rng()
    return rng.beta(mixup_alpha, mixup_alpha, batch_size).astype(np.float32)


def do_mixup(x: torch.Tensor, mixup_lambda: torch.Tensor) -> torch.Tensor:
    """Mix each sample with the batch-reversed sample (`utils.py:196-208`):
    ``out = x * lam + flip(x) * (1 - lam)``."""
    lam = mixup_lambda.reshape((-1,) + (1,) * (x.ndim - 1))
    return x * lam + torch.flip(x, dims=(0,)) * (1.0 - lam)
