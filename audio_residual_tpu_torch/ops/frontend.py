"""Audio DSP frontend: STFT -> mel -> log (torchlibrosa semantics).

Port of ``audio_residual_tpu/ops/frontend.py``. The constant builders are
re-written here in numpy (the port never imports the JAX package) and are
tested equal to the JAX ones. ``stft_power`` / ``power_to_db`` / ``logmel``
are the FFT formulation; the fused kernel's own plain version, the
DFT-as-GEMM over the mel-active bins, sits beside the kernel in
:mod:`audio_residual_tpu_torch.ops.cuda.frontend`.

Semantics: periodic hann window, ``center=True`` reflect padding of
``n_fft // 2``, power spectrum, Slaney (or HTK) mel filterbank,
``10 log10(max(x, amin)) - 10 log10(max(amin, ref))``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "FrontendConfig",
    "hann_window",
    "mel_frequencies",
    "mel_filterbank",
    "mel_active_bins",
    "stft_power",
    "power_to_db",
    "logmel",
    "batch_norm_mel",
    "batch_norm_mel_train",
]


@dataclass(frozen=True)
class FrontendConfig:
    """Static DSP parameters (defaults = HTSAT-tiny audio_cfg)."""

    sample_rate: int = 48000
    n_fft: int = 1024
    hop_length: int = 480
    win_length: int = 1024
    n_mels: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    ref: float = 1.0
    amin: float = 1e-10
    top_db: float | None = None
    mel_scale: str = "slaney"
    mel_norm: str | None = "slaney"

    def num_frames(self, num_samples: int) -> int:
        return (num_samples + 2 * (self.n_fft // 2) - self.n_fft) // self.hop_length + 1


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic hann window (scipy ``get_window('hann', n, fftbins=True)``)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(freq, scale: str) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if scale == "slaney":
        min_log_mel = _MIN_LOG_HZ / _F_SP
        mel = freq / _F_SP
        return np.where(
            freq >= _MIN_LOG_HZ,
            min_log_mel + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
            mel,
        )
    raise ValueError(f"unknown mel scale {scale!r}")


def _mel_to_hz(mel, scale: str) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    if scale == "slaney":
        min_log_mel = _MIN_LOG_HZ / _F_SP
        hz = mel * _F_SP
        return np.where(
            mel >= min_log_mel, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - min_log_mel)), hz
        )
    raise ValueError(f"unknown mel scale {scale!r}")


def mel_frequencies(n_mels: int, fmin: float, fmax: float, scale: str) -> np.ndarray:
    """``n_mels`` band-center frequencies evenly spaced on the mel scale."""
    mels = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale), n_mels)
    return _mel_to_hz(mels, scale)


@functools.lru_cache(maxsize=8)
def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """Triangular mel filterbank ``[n_fft // 2 + 1, n_mels]`` (librosa
    ``filters.mel(...).T`` for Slaney, torchaudio ``MelScale`` for HTK).
    Cached: callers must not write into the returned array."""
    n_freqs = cfg.n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_freqs)
    pts = mel_frequencies(cfg.n_mels + 2, cfg.fmin, cfg.fmax, cfg.mel_scale)
    fdiff = np.diff(pts)
    ramps = pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if cfg.mel_norm == "slaney":
        enorm = 2.0 / (pts[2 : cfg.n_mels + 2] - pts[: cfg.n_mels])
        weights = weights * enorm.reshape(-1, 1)
    elif cfg.mel_norm is not None:
        raise ValueError(f"unknown mel norm {cfg.mel_norm!r}")
    return weights.T.astype(np.float32)


def mel_active_bins(cfg: FrontendConfig) -> tuple[int, int]:
    """``[lo, hi)`` FFT-bin range with any nonzero mel weight: bins outside
    it carry exactly-zero weights, so the DFT may skip them."""
    nz = np.flatnonzero(mel_filterbank(cfg).any(axis=1))
    return int(nz[0]), int(nz[-1]) + 1


@functools.lru_cache(maxsize=8)
def _dft_bases(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases ``cos, sin`` ``[n_fft, n_fft//2+1]``.
    Cached: callers must not write into the returned arrays."""
    window = hann_window(win_length, dtype=np.float64)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = np.pad(window, (pad, n_fft - win_length - pad))
    n = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_fft // 2 + 1).reshape(1, -1)
    ang = 2.0 * np.pi * n * k / n_fft
    cos = (np.cos(ang) * window.reshape(-1, 1)).astype(np.float32)
    sin = (np.sin(ang) * window.reshape(-1, 1)).astype(np.float32)
    return cos, sin


def reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    """``[B, T] -> [B, T + 2 pad]``, ``center=True`` reflect padding."""
    return F.pad(wav[:, None, :], (pad, pad), mode="reflect")[:, 0]


def stft_power(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Power spectrogram ``[B, T] -> [B, frames, n_fft//2+1]`` (torchlibrosa
    ``Spectrogram(power=2.0, center=True, pad_mode='reflect')``)."""
    x = reflect_pad(wav, cfg.n_fft // 2)
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)
    window = hann_window(cfg.win_length)
    if cfg.win_length < cfg.n_fft:
        lo = (cfg.n_fft - cfg.win_length) // 2
        window = np.pad(window, (lo, cfg.n_fft - cfg.win_length - lo))
    spec = torch.fft.rfft(frames * torch.from_numpy(window).to(wav.device), dim=-1)
    return spec.real**2 + spec.imag**2


def power_to_db(power: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """``10 log10(max(x, amin)) - 10 log10(max(amin, ref))`` (+ optional top_db)."""
    log_spec = 10.0 * torch.log10(torch.clamp(power, min=cfg.amin))
    log_spec = log_spec - 10.0 * float(np.log10(max(cfg.amin, cfg.ref)))
    if cfg.top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - cfg.top_db)
    return log_spec


def logmel(wav: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Waveform ``[B, T]`` -> log-mel ``[B, frames, n_mels]``."""
    power = stft_power(wav, cfg)
    mel = power @ torch.from_numpy(mel_filterbank(cfg)).to(wav.device)
    return power_to_db(mel, cfg)


def batch_norm_mel(x: torch.Tensor, scale, bias, mean, var, eps: float = 1e-5) -> torch.Tensor:
    """The reference's ``bn0`` with eval statistics: per-mel-bin affine
    normalisation of the last axis of ``[B, frames, n_mels]``."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def batch_norm_mel_train(x: torch.Tensor, scale, bias, mean, var, *, eps: float = 1e-5,
                         momentum: float = 0.1, group=None) -> tuple:
    """``bn0`` in training (``audio_residual_tpu/ops/frontend.py::
    batch_norm_mel(train=True)``): normalise with the batch statistics of
    every axis but the last (the biased variance, two-pass), and return
    ``(y, new_mean, new_var)``, the running statistics updated with
    ``momentum`` and the unbiased variance. In f32 whatever the caller's
    AMP mode. ``group``, a ``torch.distributed`` process group, takes the
    statistics over the batch of every rank (the JAX package's global batch
    under its data mesh) through differentiable all-reduces."""
    x = x.float()
    axes = tuple(range(x.ndim - 1))
    n = x.numel() // x.shape[-1]
    if group is None:
        batch_mean = x.mean(dim=axes)
        batch_var = ((x - batch_mean) ** 2).mean(dim=axes)
    else:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        n = n * dist.get_world_size(group)
        batch_mean = all_reduce(x.sum(dim=axes), group=group) / n
        batch_var = all_reduce(((x - batch_mean) ** 2).sum(dim=axes), group=group) / n
    unbiased = batch_var.detach() * (n / max(n - 1, 1))
    new_mean = (1 - momentum) * mean + momentum * batch_mean.detach()
    new_var = (1 - momentum) * var + momentum * unbiased
    y = (x - batch_mean) * torch.rsqrt(batch_var + eps) * scale + bias
    return y, new_mean, new_var
