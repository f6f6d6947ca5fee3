"""K1 ``fused_logmel``: waveform -> log-mel in one kernel (``csrc/logmel.cu``).

Replaces ``audio_residual_tpu/ops/pallas/frontend.py::fused_logmel``. The
reflect pad stays in PyTorch (it stays in XLA on the TPU); the kernel frames
the padded signal itself and never writes frames or power to memory.

``dft_mode``: ``"f32"`` (golden, the default) or ``"bf16"`` (AMP: frames and
DFT basis rounded to bf16, f32 accumulate, f32 mel product). The TPU-only
``"bf16x3"`` split dot is not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audio_residual_tpu_torch.ops import frontend as fe
from audio_residual_tpu_torch.ops.common import mxu_round
from audio_residual_tpu_torch.ops.cuda import build, launch_counts

__all__ = ["fused_logmel", "logmel_plain"]

DFT_MODES = {"f32": None, "bf16": torch.bfloat16}


@functools.lru_cache(maxsize=8)
def _constants(cfg: fe.FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """``basis [n_fft, 2*nbins]`` (cos | sin of the mel-active bins) and
    ``melw [nbins, n_mels]``."""
    lo, hi = fe.mel_active_bins(cfg)
    cos, sin = fe._dft_bases(cfg.n_fft, cfg.win_length)
    basis = np.ascontiguousarray(np.concatenate([cos[:, lo:hi], sin[:, lo:hi]], axis=1))
    return basis, np.ascontiguousarray(fe.mel_filterbank(cfg)[lo:hi])


def _db_offset(cfg: fe.FrontendConfig) -> float:
    return float(10.0 * np.log10(max(cfg.amin, cfg.ref)))


def logmel_plain(wav: torch.Tensor, cfg: fe.FrontendConfig, dft_mode: str = "f32") -> torch.Tensor:
    """Plain version of the kernel: the DFT as a GEMM over the mel-active
    bins, ``[B, T] -> [B, frames, n_mels]`` f32."""
    md = DFT_MODES[dft_mode]
    basis, melw = (torch.from_numpy(c).to(wav.device) for c in _constants(cfg))
    nbins = melw.shape[0]
    frames = fe.reflect_pad(wav.float(), cfg.n_fft // 2).unfold(-1, cfg.n_fft, cfg.hop_length)
    d = mxu_round(frames, md) @ mxu_round(basis, md)
    re, im = d[..., :nbins], d[..., nbins:]
    return fe.power_to_db((re * re + im * im) @ melw, cfg)


@functools.lru_cache(maxsize=8)
def _device_constants(cfg: fe.FrontendConfig, device: torch.device):
    return tuple(torch.from_numpy(c).to(device) for c in _constants(cfg))


def fused_logmel(wav: torch.Tensor, cfg: fe.FrontendConfig, dft_mode: str | None = None) -> torch.Tensor:
    """``[B, T]`` f32 -> ``[B, frames, n_mels]`` f32 (``top_db`` unsupported:
    HTSAT uses None). CPU tensors take :func:`logmel_plain`."""
    mode = dft_mode or "f32"
    if mode not in DFT_MODES:
        raise ValueError(f"dft_mode {mode!r}: expected one of {sorted(DFT_MODES)}")
    if cfg.top_db is not None:
        raise ValueError("fused_logmel: top_db is not supported")
    if wav.device.type == "cpu":
        return logmel_plain(wav, cfg, mode)
    build.check_cuda_inputs("fused_logmel", {"wav": wav}, float_only=("wav",))
    if wav.ndim != 2:
        raise ValueError(f"fused_logmel: wav must be [B, T], got {tuple(wav.shape)}")
    if cfg.n_mels > 64:
        raise ValueError("fused_logmel: the kernel takes at most 64 mel bands")
    b = wav.shape[0]
    xp = fe.reflect_pad(wav, cfg.n_fft // 2).contiguous()
    nf = (xp.shape[1] - cfg.n_fft) // cfg.hop_length + 1
    basis, melw = _device_constants(cfg, wav.device)
    out = torch.empty(b, nf, cfg.n_mels, device=wav.device, dtype=torch.float32)
    fn = build.bind("logmel", "arpu_fused_logmel", "ppiiiiipipiffip")
    rc = fn(xp.data_ptr(), out.data_ptr(), b, xp.shape[1], nf, cfg.n_fft, cfg.hop_length,
            basis.data_ptr(), melw.shape[0], melw.data_ptr(), cfg.n_mels, cfg.amin,
            _db_offset(cfg), int(mode == "bf16"), build.stream_of(wav))
    build.check("logmel", rc, "fused_logmel")
    launch_counts["fused_logmel"] += 1
    return out
