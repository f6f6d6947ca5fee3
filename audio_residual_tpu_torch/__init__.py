"""PyTorch / CUDA port of ``audio_residual_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module paths
and holds its hand-written CUDA kernels under :mod:`.ops.cuda`. It imports
``torch`` and ``numpy`` only — never ``jax`` nor ``audio_residual_tpu``.

Entry points that build state (:func:`.models.clap.build_clap_audio`) run on
the card unless the caller passes ``device="cpu"``; without a card and
without that argument they raise.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Raises when no card is there: an entry point
    never carries on quietly on the CPU unless the caller asked for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
