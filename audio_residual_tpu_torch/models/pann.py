"""PANN CNN audio encoders (Cnn6 / Cnn10 / Cnn14) with every fusion type.

Port of ``audio_residual_tpu/models/pann.py`` (the reference's
``pann_model.py``), in PyTorch's NCHW idiom: the log-mel ``[B, T, F]``
becomes a one-channel image ``[B, 1, T, F]`` (H = time, W = mel bins).

  * Cnn6:  4 x ConvBlock5x5 (conv5x5 + BN + ReLU), fc1 512;
  * Cnn10: 5 x ConvBlock (2 x (conv3x3 + BN + ReLU)), fc1 1024;
  * Cnn14: 6 x ConvBlock, fc1 2048, its last block unpooled.

Each block ends in a 2x2 average pool (VALID, floor); the convolutions have
no bias and "same" padding. After the blocks: the mean over the mel axis,
then the latent path (max pool + average pool over time, k3 s1 p1, the
average dividing by 3 including the padding, then fc1 + ReLU, repeated to
frames) and the clip path (max + mean over time, fc1 + ReLU, the embedding;
``fc_audioset`` + sigmoid, the clipwise output).

The frontend is K1 (``fused_logmel``) on its golden route whatever the
caller's AMP mode: the JAX package passes no ``dft_mode`` here
(``pann.py:225-228``) and ``clap_apply`` no ``compute_dtype``, so a PANN
tower runs f32, its convolutions in full f32 (cuDNN with TF32 off,
``ops/common.py::golden_convs``). bn0 uses its eval statistics even in
training (``pann.py:231,234``). The convolutions are XLA convolutions in
the JAX package, not Pallas kernels: here ``F.conv2d``.

Fusion (``enable_fusion``): ``{"mel_fusion": [B, 4, T, F], "longer": [B]}``
after bn0; the ``*_1d`` types fuse the local chunks into the global mel
through ``mel_conv1d`` as HTSAT does; the ``*_2d`` types run the global
channel through ``conv_block1`` and the local ones through ``mel_conv2d``
(conv 5x5 stride (6, 2) pad 2 + BN + ReLU), concatenated on time, padded or
trimmed to the global block's output and fused by DAF/AFF/iAFF;
``channel_map`` feeds all four channels to a 4-channel ``conv_block1``.

Training (``train=True`` with a ``generator``): SpecAugment on the input,
dropout 0.2 before each block after the first and after the last, 0.5 on
the pooled clip vector and on the embedding, drawn in that order; the
masks are sampled apart from their arithmetic (:func:`sample_dropout`,
:func:`dropout`), so a test can feed the JAX package's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch.ops import frontend, interpolate
from audio_residual_tpu_torch.ops.common import dropout, golden_convs
from audio_residual_tpu_torch.ops.cuda.frontend import fused_logmel
from audio_residual_tpu_torch.ops.fusion import (EvalBatchNorm, batch_norm_eval, fusion_kind,
                                                 make_fusion)
from audio_residual_tpu_torch.ops.spec_augment import sample_spec_augment, spec_augment
from audio_residual_tpu_torch.models.htsat import BatchNormMel, fuse_1d

__all__ = ["PANNConfig", "PANN_VARIANTS", "PANN", "pann_apply", "dropout", "sample_dropout"]

PANN_VARIANTS = {
    "Cnn6": dict(channels=(64, 128, 256, 512), block="5x5", fc=512, interp=16, pool_last=True),
    "Cnn10": dict(channels=(64, 128, 256, 512, 1024), block="3x3", fc=1024, interp=32,
                  pool_last=True),
    "Cnn14": dict(channels=(64, 128, 256, 512, 1024, 2048), block="3x3x2", fc=2048, interp=32,
                  pool_last=False),
}


@dataclass(frozen=True)
class PANNConfig:
    model_name: str = "Cnn14"
    sample_rate: int = 48000
    clip_samples: int = 480000
    n_fft: int = 1024
    hop_size: int = 480
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    num_classes: int = 527
    enable_fusion: bool = False
    fusion_type: str = "None"

    @property
    def variant(self) -> dict:
        return PANN_VARIANTS[self.model_name]

    @property
    def embed_dim(self) -> int:
        return self.variant["fc"]

    @property
    def fusion(self) -> str | None:
        """``"1d"``, ``"2d"``, ``"channel_map"`` or None (no fusion)."""
        return fusion_kind(self.enable_fusion, self.fusion_type)

    @property
    def frontend_config(self) -> frontend.FrontendConfig:
        return frontend.FrontendConfig(
            sample_rate=self.sample_rate, n_fft=self.n_fft, hop_length=self.hop_size,
            win_length=self.n_fft, n_mels=self.mel_bins, fmin=self.fmin, fmax=self.fmax)


def _xavier(m: nn.Module, gen: torch.Generator) -> None:
    """Xavier-uniform weight (the JAX init), zero bias."""
    w = m.weight
    fan = w.shape[1] * w[0, 0].numel() + w.shape[0] * w[0, 0].numel()
    lim = math.sqrt(6.0 / fan)
    with torch.no_grad():
        nn.init.uniform_(w, -lim, lim, generator=gen)
        if getattr(m, "bias", None) is not None:
            m.bias.zero_()


class ConvBlock(nn.Module):
    """``conv1`` + ``bn1`` (+ ``conv2`` + ``bn2``), each conv + BN + ReLU."""

    def __init__(self, c_in: int, c_out: int, k: int, double: bool, gen: torch.Generator):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, k, padding=k // 2, bias=False)
        self.bn1 = EvalBatchNorm(c_out)
        _xavier(self.conv1, gen)
        if double:
            self.conv2 = nn.Conv2d(c_out, c_out, k, padding=k // 2, bias=False)
            self.bn2 = EvalBatchNorm(c_out)
            _xavier(self.conv2, gen)


class PANN(nn.Module):
    """Parameters of a PANN tower, the reference's keys (``bn0``,
    ``conv_block{i}``, ``fc1``, ``fc_audioset``; with fusion
    ``mel_conv1d`` / ``mel_conv2d`` and ``fusion_model``), initialised as
    the JAX package initialises them, from ``generator``. The forward is
    :func:`pann_apply`."""

    def __init__(self, cfg: PANNConfig = PANNConfig(), generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        v = cfg.variant
        self.bn0 = BatchNormMel(cfg.mel_bins)
        c_in = 4 if cfg.fusion == "channel_map" else 1
        k, double = (5, False) if v["block"] == "5x5" else (3, True)
        for i, c_out in enumerate(v["channels"]):
            setattr(self, f"conv_block{i + 1}",
                    ConvBlock(c_in if i == 0 else v["channels"][i - 1], c_out, k, double, gen))
        self.fc1 = nn.Linear(v["fc"], v["fc"])
        self.fc_audioset = nn.Linear(v["fc"], cfg.num_classes)
        _xavier(self.fc1, gen)
        _xavier(self.fc_audioset, gen)
        m = cfg.mel_bins
        if cfg.fusion == "1d":
            self.mel_conv1d = nn.Sequential(nn.Conv1d(m, m, 5, stride=3, padding=2),
                                            EvalBatchNorm(m))
            _xavier(self.mel_conv1d[0], gen)
            self.fusion_model = make_fusion(cfg.fusion_type, m, gen)
        elif cfg.fusion == "2d":
            self.mel_conv2d = nn.Sequential(nn.Conv2d(1, 64, 5, stride=(6, 2), padding=2),
                                            EvalBatchNorm(64), nn.ReLU())
            _xavier(self.mel_conv2d[0], gen)
            self.fusion_model = make_fusion(cfg.fusion_type, 64, gen)

    @property
    def blocks(self) -> list[ConvBlock]:
        n = len(self.cfg.variant["channels"])
        return [getattr(self, f"conv_block{i + 1}") for i in range(n)]


def sample_dropout(generator: torch.Generator | None, shape, rate: float, device=None):
    """A keep mask of ``shape`` (one in ``1 - rate`` kept), or None without a
    generator."""
    if generator is None:
        return None
    return torch.rand(shape, generator=generator,
                      device=device if device is not None else generator.device) < 1.0 - rate


def _conv_block(blk: ConvBlock, x: torch.Tensor, pool: bool = True) -> torch.Tensor:
    x = torch.relu(batch_norm_eval(blk.bn1, F.conv2d(x, blk.conv1.weight, None, 1,
                                                      blk.conv1.padding)))
    if hasattr(blk, "conv2"):
        x = torch.relu(batch_norm_eval(blk.bn2, F.conv2d(x, blk.conv2.weight, None, 1,
                                                          blk.conv2.padding)))
    return F.avg_pool2d(x, 2) if pool else x


def _fuse_2d(model: PANN, x: torch.Tensor, longer) -> torch.Tensor:
    """The 2-D fusion of the first block (``pann.py:250-266``)."""
    b, _, t, f = x.shape
    global_x = _conv_block(model.conv_block1, x[:, 0:1])
    th, tw = global_x.shape[2:]
    conv, bn, _ = model.mel_conv2d
    ly = F.conv2d(x[:, 1:].reshape(b * 3, 1, t, f), conv.weight, conv.bias, conv.stride,
                  conv.padding)
    ly = torch.relu(batch_norm_eval(bn, ly))
    c, lh, lw = ly.shape[1:]
    # time-concat of the three chunks on H
    ly = ly.reshape(b, 3, c, lh, lw).permute(0, 2, 1, 3, 4).reshape(b, c, 3 * lh, lw)
    ly = F.pad(ly, (0, 0, 0, max(th - 3 * lh, 0)))[:, :, :th, :tw]
    fused = model.fusion_model(global_x, ly)
    return fused if longer is None else torch.where(longer[:, None, None, None], fused, global_x)


def pann_apply(model: PANN, batch, *, train: bool = False,
               generator: torch.Generator | None = None) -> dict:
    """PANN forward (`pann_model.py:223-330`): ``clipwise_output``,
    ``embedding`` and ``fine_grained_embedding``, f32.

    ``batch``: ``{"waveform": [B, T]}`` or a bare ``[B, T]`` tensor; a
    fusion model takes ``{"mel_fusion": [B, 4, T, F], "longer": [B]}``.
    ``train`` with a ``generator`` draws SpecAugment and the dropouts from
    it (module docstring); without one nothing random happens."""
    cfg = model.cfg
    gen = generator if train else None
    with golden_convs():
        if isinstance(batch, dict) and "mel_fusion" in batch:
            mel = model.bn0(batch["mel_fusion"].float())
            longer = batch.get("longer")
            if cfg.fusion == "1d":
                x = fuse_1d(model.mel_conv1d, model.fusion_model, mel, longer)[:, None]
            else:
                x = mel
        else:
            if cfg.fusion in ("2d", "channel_map"):
                raise ValueError(f"a {cfg.fusion_type} fusion model takes {{'mel_fusion', "
                                 "'longer'}, not a waveform")
            longer = None
            wav = batch["waveform"] if isinstance(batch, dict) else batch
            x = model.bn0(fused_logmel(wav.float().contiguous(), cfg.frontend_config,
                                       dft_mode="f32"))[:, None]
        if gen is not None:
            # on [B, T, F * C], channels innermost, as the JAX package's NHWC
            b, c, t, f = x.shape
            flat = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
            flat = spec_augment(flat, *sample_spec_augment(gen, flat.shape, device=x.device))
            x = flat.reshape(b, t, f, c).permute(0, 3, 1, 2)

        blocks = model.blocks
        x = _fuse_2d(model, x, longer) if cfg.fusion == "2d" else _conv_block(blocks[0], x)
        for i in range(1, len(blocks)):
            x = dropout(x, sample_dropout(gen, x.shape, 0.2, x.device), 0.2)
            x = _conv_block(blocks[i], x, i < len(blocks) - 1 or cfg.variant["pool_last"])
        x = dropout(x, sample_dropout(gen, x.shape, 0.2, x.device), 0.2)

        x = x.mean(dim=3)  # the mel axis -> [B, C, T']
        latent = F.max_pool1d(x, 3, 1, 1) + F.avg_pool1d(x, 3, 1, 1)
        latent = torch.relu(model.fc1(latent.transpose(1, 2)))
        x = x.amax(dim=2) + x.mean(dim=2)
        x = dropout(x, sample_dropout(gen, x.shape, 0.5, x.device), 0.5)
        x = torch.relu(model.fc1(x))
        embedding = dropout(x, sample_dropout(gen, x.shape, 0.5, x.device), 0.5)
        clipwise = torch.sigmoid(model.fc_audioset(x))
    return {"clipwise_output": clipwise, "embedding": embedding,
            "fine_grained_embedding": interpolate.repeat_frames(latent, cfg.variant["interp"])}
