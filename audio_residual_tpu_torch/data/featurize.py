"""Batched waveform featurization (``get_audio_features`` data contract).

Port of ``audio_residual_tpu/data/featurize.py::featurize_batch``. All clips
of a batch share one length, so one branch serves the batch:

  * too long: ``rand_trunc`` crops ``max_len`` samples (``longer=True``).
    Crop starts come from ``starts`` or from a ``torch.Generator``; the JAX
    package draws them from ``jax.random``, so tests pass the starts.
  * too short: ``repeatpad`` tiles ``max_len // T`` times then zero-pads,
    ``pad`` zero-pads, ``repeat`` tiles then truncates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["featurize_batch"]


def featurize_batch(
    wav: torch.Tensor,
    max_len: int = 480000,
    *,
    data_truncating: str = "rand_trunc",
    data_filling: str = "repeatpad",
    starts: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict:
    """``[B, T] -> {"waveform": [B, max_len], "longer": [B] bool}``."""
    b, t = wav.shape
    if t > max_len:
        longer = torch.ones(b, dtype=torch.bool, device=wav.device)
        if data_truncating != "rand_trunc":
            raise NotImplementedError(f"batched data_truncating={data_truncating!r}")
        if starts is None:
            starts = torch.randint(0, t - max_len + 1, (b,), generator=generator)
        idx = starts.to(wav.device)[:, None] + torch.arange(max_len, device=wav.device)[None, :]
        wav = torch.gather(wav, 1, idx)
    elif t < max_len:
        longer = torch.zeros(b, dtype=torch.bool, device=wav.device)
        if data_filling == "repeatpad":
            wav = wav.repeat(1, max_len // t)
            wav = F.pad(wav, (0, max_len - wav.shape[1]))
        elif data_filling == "pad":
            wav = F.pad(wav, (0, max_len - t))
        elif data_filling == "repeat":
            wav = wav.repeat(1, max_len // t + 1)[:, :max_len]
        else:
            raise NotImplementedError(f"data_filling {data_filling!r}")
    else:
        longer = torch.zeros(b, dtype=torch.bool, device=wav.device)
    return {"waveform": wav, "longer": longer}
