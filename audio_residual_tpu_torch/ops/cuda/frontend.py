"""K1 ``fused_logmel``: waveform -> log-mel in one kernel (``csrc/logmel.cu``).

Replaces ``audio_residual_tpu/ops/pallas/frontend.py::fused_logmel``. The
reflect pad stays in PyTorch (it stays in XLA on the TPU); the kernel frames
the padded signal itself and never writes frames or power to memory.

``dft_mode``: ``"f32"`` (golden, the default) or ``"bf16"`` (AMP: frames and
DFT basis rounded to bf16, f32 accumulate, f32 power and mel product). The
two modes run one design on ``wgmma`` in two operand modes, one kernel
each: ``"bf16"`` ``logmel_wgmma_kernel``, on the signal in bf16 and the
basis as :func:`tc_constants` lays it out; ``"f32"``
``logmel_tf32x3_kernel``, on the f32 signal and that basis in f32, split
for 3xTF32 (:func:`tf32x3_constants`), whose products keep about f32's
accuracy, as the TPU's ``Precision.HIGHEST`` DFT. The TPU-only ``"bf16x3"``
split dot is not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops import frontend as fe
from audio_residual_tpu_torch.ops.common import mxu_round
from audio_residual_tpu_torch.ops.cuda import build, launch_counts
from audio_residual_tpu_torch.ops.cuda.tf32x3 import split_tf32

__all__ = ["fused_logmel", "logmel_plain", "check_tc_config", "tc_constants",
           "tf32x3_constants", "bf16_signal", "f32_signal"]

DFT_MODES = {"f32": None, "bf16": torch.bfloat16}
TC_TILE_N = 128  # basis rows (64 bins, cos|sin interleaved) per tile of the kernels
TC_MELS = 64  # width of the kernels' mel accumulator
TC_MAX_FFT = 1536  # the frame maps of at most 1536 samples a frame
# samples of a K step (one 128-byte row) and of a 16-byte TMA stride, per mode
TC_K_STEP = {"bf16": 64, "f32": 32}
TC_ALIGN = {"bf16": 8, "f32": 4}


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


def check_tc_config(cfg: fe.FrontendConfig, dft_mode: str = "bf16") -> None:
    """The kernels' rule, else ``ValueError``: frame ``f`` starts at sample
    ``f * hop`` of the padded signal and the kernel loads it in rows of 128
    bytes from 16-byte boundaries, so ``hop`` must be a multiple of 8
    samples (bf16) or 4 (f32) and ``n_fft`` one of 64 (bf16) or 32 (f32),
    at most 1536; at most 64 mel bands."""
    align, step = TC_ALIGN[dft_mode], TC_K_STEP[dft_mode]
    if (cfg.hop_length % align or cfg.n_fft % step or cfg.n_fft > TC_MAX_FFT
            or cfg.n_mels > TC_MELS):
        raise ValueError(
            f"fused_logmel {dft_mode}: hop_length={cfg.hop_length} must be a multiple of "
            f"{align}, n_fft={cfg.n_fft} a multiple of {step} and at most {TC_MAX_FFT}, "
            f"n_mels={cfg.n_mels} at most {TC_MELS}")


@functools.lru_cache(maxsize=8)
def _tc_layout(cfg: fe.FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """``basis [n_pad, n_fft]`` f32, K-major, row ``2j`` the windowed cos and
    ``2j + 1`` the sin of mel-active bin ``j``, zero rows up to ``n_pad`` (a
    multiple of 128); ``melw [n_pad / 2, 64]`` f32, zero beyond the active
    bins and ``n_mels``."""
    basis, melw = _constants(cfg)
    nbins = melw.shape[0]
    n_pad = -(-2 * nbins // TC_TILE_N) * TC_TILE_N
    bt = np.zeros((n_pad, cfg.n_fft), np.float32)
    bt[0 : 2 * nbins : 2] = basis[:, :nbins].T
    bt[1 : 2 * nbins : 2] = basis[:, nbins:].T
    mw = np.zeros((n_pad // 2, TC_MELS), np.float32)
    mw[:nbins, : cfg.n_mels] = melw
    return bt, mw


@functools.lru_cache(maxsize=8)
def tc_constants(cfg: fe.FrontendConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The AMP kernel's constants: the basis of :func:`_tc_layout` in bf16,
    and ``melw``."""
    bt, mw = _tc_layout(cfg)
    return torch.from_numpy(bt).to(device, torch.bfloat16), torch.from_numpy(mw).to(device)


@functools.lru_cache(maxsize=8)
def tf32x3_constants(cfg: fe.FrontendConfig, device: torch.device) -> tuple:
    """The golden kernel's constants: the basis of :func:`_tc_layout` split
    for 3xTF32, ``(hi, lo)`` f32 with ``hi + lo`` the f32 basis, made once
    per config and device; and ``melw``."""
    bt, mw = _tc_layout(cfg)
    hi, lo = split_tf32(torch.from_numpy(bt).to(device))
    return hi, lo, torch.from_numpy(mw).to(device)


def bf16_signal(wav: torch.Tensor, cfg: fe.FrontendConfig) -> torch.Tensor:
    """``[B, T]`` -> ``[B, row]`` bf16: cast, then the reflect pad of
    ``n_fft // 2`` (the pad commutes with the cast, so this is the padded
    signal rounded to bf16, at half the bytes), then zeros to a multiple of
    8 samples a row."""
    x = fe.reflect_pad(wav.to(torch.bfloat16), cfg.n_fft // 2)
    tail = -x.shape[1] % 8
    return F.pad(x, (0, tail)) if tail else x


def f32_signal(wav: torch.Tensor, cfg: fe.FrontendConfig) -> torch.Tensor:
    """``[B, T]`` -> ``[B, row]`` f32: the reflect pad of ``n_fft // 2``,
    then zeros to a multiple of 4 samples a row (16-byte TMA rows)."""
    x = fe.reflect_pad(wav.float(), cfg.n_fft // 2)
    tail = -x.shape[1] % TC_ALIGN["f32"]
    return (F.pad(x, (0, tail)) if tail else x).contiguous()


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
    check_tc_config(cfg, mode)
    b = wav.shape[0]
    nf = cfg.num_frames(wav.shape[1])
    out = torch.empty(b, nf, cfg.n_mels, device=wav.device, dtype=torch.float32)
    if mode == "bf16":
        xp = bf16_signal(wav, cfg)
        basis, melw = tc_constants(cfg, wav.device)
        fn = build.bind("logmel", "arpu_fused_logmel_bf16", "ppiiiiipipiffp")
        rc = fn(xp.data_ptr(), out.data_ptr(), b, xp.shape[1], nf, cfg.n_fft, cfg.hop_length,
                basis.data_ptr(), basis.shape[0], melw.data_ptr(), cfg.n_mels, cfg.amin,
                _db_offset(cfg), build.stream_of(wav))
    else:
        xp = f32_signal(wav, cfg)
        hi, lo, melw = tf32x3_constants(cfg, wav.device)
        fn = build.bind("logmel", "arpu_fused_logmel", "ppiiiiippipiffp")
        rc = fn(xp.data_ptr(), out.data_ptr(), b, xp.shape[1], nf, cfg.n_fft, cfg.hop_length,
                hi.data_ptr(), lo.data_ptr(), hi.shape[0], melw.data_ptr(), cfg.n_mels,
                cfg.amin, _db_offset(cfg), build.stream_of(wav))
    build.check("logmel", rc, "fused_logmel")
    launch_counts["fused_logmel"] += 1
    return out
