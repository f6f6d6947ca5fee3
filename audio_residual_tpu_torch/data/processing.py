"""Audio processing toolbox: ``audio_residual_tpu/data/processing.py``.

Reference: `data_processing/processing.py:11-188` (``AudioProcessing``):
load, to_channels, to_sample_rate, to_length (random-position pad),
time_shift, MelSpectrogram + AmplitudeToDB, SpecAugment-style masking and
two plot helpers.

The host steps stay numpy and give the JAX package's values under the same
``np.random.Generator`` (``to_sample_rate`` through the port's polyphase
:func:`~audio_residual_tpu_torch.data.datasets.resample_poly`, within 1e-5
of the JAX direct form). :meth:`AudioProcessing.mel_spectrogram` runs K1
(``ops/cuda/frontend.py::fused_logmel``, golden f32) on ``device``, the
card unless ``device="cpu"``, with torchaudio's semantics (HTK mel, no
filterbank norm, ``fmax = sr / 2``, ``hop = n_fft // 2``); K1 has no
``top_db``, so the floor comes after it, as the JAX ``power_to_db`` takes
it: one max over the whole output. :meth:`AudioProcessing.spectro_augment`
draws its stripes from a ``torch.Generator`` (the port's rule for
SpecAugment), the same function of the same draws as the JAX package's
``jax.random`` ones.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.data.datasets import load_wav, resample_poly
from audio_residual_tpu_torch.ops import frontend
from audio_residual_tpu_torch.ops.cuda.frontend import fused_logmel
from audio_residual_tpu_torch.ops.spec_augment import drop_stripes, sample_stripes

__all__ = ["AudioProcessing"]


class AudioProcessing:
    """Static-method toolbox mirroring the reference class."""

    @staticmethod
    def load(path: str):
        return load_wav(path)

    @staticmethod
    def to_channels(wav: np.ndarray, channels: int) -> np.ndarray:
        """Mono <-> multi-channel (`processing.py:30-43`)."""
        if wav.ndim == 1:
            wav = wav[None]
        if wav.shape[0] == channels:
            return wav
        if channels == 1:
            return wav.mean(0, keepdims=True)
        return np.broadcast_to(wav[:1], (channels, wav.shape[1])).copy()

    @staticmethod
    def to_sample_rate(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
        return resample_poly(wav, sr, target_sr)

    @staticmethod
    def to_length(wav: np.ndarray, target_len: int, rng=None) -> np.ndarray:
        """Pad at a random position / truncate (`processing.py:60-80`)."""
        rng = rng or np.random.default_rng()
        n = wav.shape[-1]
        if n > target_len:
            start = int(rng.integers(0, n - target_len + 1))
            return wav[..., start: start + target_len]
        if n < target_len:
            pad = target_len - n
            left = int(rng.integers(0, pad + 1))
            return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(left, pad - left)])
        return wav

    @staticmethod
    def time_shift(wav: np.ndarray, max_shift_pct: float = 0.4, rng=None) -> np.ndarray:
        """Circular time-shift augmentation (`processing.py:83-90`)."""
        rng = rng or np.random.default_rng()
        shift = int(rng.integers(0, int(wav.shape[-1] * max_shift_pct) + 1))
        return np.roll(wav, shift, axis=-1)

    @staticmethod
    def frontend_config(sr: int = 44100, n_fft: int = 1024, hop_length: int | None = None,
                        n_mels: int = 64) -> frontend.FrontendConfig:
        """torchaudio's ``MelSpectrogram`` of `processing.py:102-120` (HTK,
        no norm, ``fmax = sr / 2``), without ``top_db``."""
        return frontend.FrontendConfig(
            sample_rate=sr, n_fft=n_fft, hop_length=hop_length or n_fft // 2, win_length=n_fft,
            n_mels=n_mels, fmin=0.0, fmax=sr / 2, mel_scale="htk", mel_norm=None)

    @staticmethod
    def mel_spectrogram(wav, sr: int = 44100, n_fft: int = 1024, hop_length: int | None = None,
                        n_mels: int = 64, top_db: float | None = 80.0,
                        device: str | torch.device | None = None) -> torch.Tensor:
        """Log-mel ``[..., frames, n_mels]`` f32 on ``device`` of a ``[...,
        T]`` waveform (numpy or tensor; 1-D is one clip): K1, then the
        ``top_db`` floor below the whole output's max (`processing.py:102-120`)."""
        x = torch.as_tensor(wav, dtype=torch.float32, device=resolve_device(device))
        x = x[None] if x.ndim == 1 else x
        cfg = AudioProcessing.frontend_config(sr, n_fft, hop_length, n_mels)
        out = fused_logmel(x.reshape(-1, x.shape[-1]), cfg, dft_mode="f32")
        out = out.reshape(*x.shape[:-1], *out.shape[1:])
        if top_db is not None:
            out = torch.maximum(out, out.max() - top_db)
        return out

    @staticmethod
    def spectro_augment(spec, max_mask_pct: float = 0.1, n_freq_masks: int = 1,
                        n_time_masks: int = 1, seed: int = 0,
                        generator: torch.Generator | None = None) -> torch.Tensor:
        """Time/freq stripe masking (`processing.py:123-150`) of ``spec``
        ``[B, T, F]`` (numpy or tensor; made 3-D as ``np.atleast_3d`` does):
        ``n_time_masks`` stripes of width ``U[0, max(1, T pct))`` along T,
        then ``n_freq_masks`` along F, per row, drawn from ``generator`` (a
        CPU one seeded with ``seed`` when not given)."""
        x = torch.as_tensor(spec, dtype=torch.float32)
        x = x.reshape(1, -1, 1) if x.ndim <= 1 else x[..., None] if x.ndim == 2 else x
        gen = generator if generator is not None else torch.Generator().manual_seed(seed)
        b, t, f = x.shape
        for axis, dim, n in ((1, t, n_time_masks), (2, f, n_freq_masks)):
            widths, starts = sample_stripes(gen, b, dim, max(1, int(dim * max_mask_pct)), n)
            x = drop_stripes(x, axis, widths, starts)
        return x

    @staticmethod
    def plot_waveform(wav: np.ndarray, sr: int, ax=None):
        """Waveform plot (`processing.py:153-170`); needs matplotlib."""
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        t = np.arange(wav.shape[-1]) / sr
        ax.plot(t, np.atleast_2d(wav)[0])
        ax.set_xlabel("time [s]")
        return ax

    @staticmethod
    def plot_spectrogram(spec, ax=None):
        import matplotlib.pyplot as plt

        ax = ax or plt.gca()
        ax.imshow(np.atleast_2d(np.asarray(torch.as_tensor(spec).cpu())).T, origin="lower",
                  aspect="auto")
        return ax
