"""Losses, from ``audio_residual_tpu/training/losses.py``: the linear probe's
``lp_loss`` (the reference's `loss.py:291-306`). The contrastive losses join
the port with the CLAP training runtime."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["lp_loss"]


def lp_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "ce") -> torch.Tensor:
    """Linear-probe losses: ``bce`` (multi-label, on logits), ``ce`` (int
    targets, or soft targets of the logits' shape, as mixup makes them),
    ``mse``."""
    if kind == "ce":
        logp = F.log_softmax(pred, dim=-1)
        if target.ndim == 1:
            return -logp.gather(-1, target.long()[:, None]).mean()
        return (-(target * logp).sum(dim=-1)).mean()
    if kind == "bce":
        z, t = pred, target.to(pred.dtype)
        return (torch.clamp(z, min=0) - z * t + torch.log1p(torch.exp(-z.abs()))).mean()
    if kind == "mse":
        return ((pred - target.to(pred.dtype)) ** 2).mean()
    raise ValueError(kind)
