"""Audio int16 round-trip quantisation and length normalisation.

Port of ``audio_residual_tpu/ops/quantize.py``: the reference simulates int16
storage of waveforms before embedding (``.to(torch.int16)`` truncates toward
zero), so every eval path quantises first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.utils.profiling import annotate

__all__ = [
    "float32_to_int16",
    "int16_to_float32",
    "quantize_roundtrip",
    "pad_or_truncate",
]


def float32_to_int16(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [-1, 1], scale by 32767, truncate toward zero."""
    return torch.trunc(torch.clamp(x, -1.0, 1.0) * 32767.0).to(torch.int16)


def int16_to_float32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / 32767.0


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """float -> int16 -> float, computed in f32: every truncated value is an
    integer in [-32767, 32767], exact in f32, so skipping the int16 dtype is
    bit-identical."""
    with annotate("quantize"):
        return torch.trunc(torch.clamp(x, -1.0, 1.0) * 32767.0) / 32767.0


def pad_or_truncate(x: torch.Tensor, target_len: int = 480000) -> torch.Tensor:
    """Mono-downmix leading channel dims, then right-pad zeros / truncate."""
    while x.ndim > 1:
        x = x.mean(dim=0)
    n = x.shape[0]
    if n > target_len:
        return x[:target_len]
    if n < target_len:
        return F.pad(x, (0, target_len - n))
    return x
