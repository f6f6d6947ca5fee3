"""SpecAugment-style time/freq stripe masking (train-time only).

Port of ``audio_residual_tpu/ops/spec_augment.py`` (the reference's
torchlibrosa ``SpecAugmentation(time_drop_width=64, time_stripes_num=2,
freq_drop_width=8, freq_stripes_num=2)``). Each function is split in two: the
mask arithmetic, which takes the stripes' ``widths`` and ``starts`` as
tensors (:func:`drop_stripes`, :func:`spec_augment`), and a sampler that
draws them from a ``torch.Generator`` (:func:`sample_stripes`,
:func:`sample_spec_augment`). The JAX package draws them from
``jax.random`` inside the same function; the ranges are the same.
"""

from __future__ import annotations

import torch

__all__ = ["drop_stripes", "sample_stripes", "spec_augment", "sample_spec_augment",
           "SPEC_AUGMENT"]

# the reference's SpecAugmentation arguments (htsat.py:689-690)
SPEC_AUGMENT = dict(time_drop_width=64, time_stripes_num=2, freq_drop_width=8,
                    freq_stripes_num=2)


def drop_stripes(x: torch.Tensor, axis: int, widths: torch.Tensor,
                 starts: torch.Tensor) -> torch.Tensor:
    """Zero, per batch element, the stripes ``[starts, starts + widths)`` of
    ``axis``: ``widths`` and ``starts`` are ``[B, stripes]`` integers."""
    b, dim = x.shape[0], x.shape[axis]
    pos = torch.arange(dim, device=x.device)
    starts, ends = starts.to(x.device), (starts + widths).to(x.device)
    covered = (pos[None, None] >= starts[:, :, None]) & (pos[None, None] < ends[:, :, None])
    keep = ~covered.any(dim=1)  # [B, dim]
    shape = [1] * x.ndim
    shape[0], shape[axis] = b, dim
    return x * keep.to(x.dtype).reshape(shape)


def sample_stripes(generator: torch.Generator | None, b: int, dim: int, drop_width: int,
                   stripes_num: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(widths, starts)`` ``[b, stripes_num]`` int64, drawn on ``device``
    (the generator's by default): widths uniform in ``[0, drop_width)``,
    starts uniform in ``[0, max(dim - width, 1))``, the JAX package's
    ranges."""
    device = device if device is not None else (generator.device if generator is not None
                                                 else None)
    widths = torch.randint(0, drop_width, (b, stripes_num), generator=generator, device=device)
    high = torch.clamp(dim - widths, min=1)
    u = torch.rand((b, stripes_num), generator=generator, device=device, dtype=torch.float64)
    starts = torch.minimum((u * high).floor().long(), high - 1)
    return widths, starts


def spec_augment(x: torch.Tensor, time_stripes: tuple, freq_stripes: tuple) -> torch.Tensor:
    """``x [B, T, F]`` log-mel: the time stripes, then the frequency stripes,
    each a ``(widths, starts)`` pair."""
    x = drop_stripes(x, 1, *time_stripes)
    return drop_stripes(x, 2, *freq_stripes)


def sample_spec_augment(generator: torch.Generator | None, shape, *,
                        time_drop_width: int = 64, time_stripes_num: int = 2,
                        freq_drop_width: int = 8, freq_stripes_num: int = 2,
                        device=None) -> tuple[tuple, tuple]:
    """The time and frequency stripes of :func:`spec_augment` for a
    ``[B, T, F]`` input."""
    b, t, f = shape
    return (sample_stripes(generator, b, t, time_drop_width, time_stripes_num, device),
            sample_stripes(generator, b, f, freq_drop_width, freq_stripes_num, device))
