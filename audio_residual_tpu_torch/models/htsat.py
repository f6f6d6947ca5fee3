"""HTSAT (Hierarchical Token-Semantic Audio Transformer).

Port of ``audio_residual_tpu/models/htsat.py`` with its split points, its
representation taps, its training mode and every mel-fusion type. Module
attribute names give the reference LAION-CLAP ``state_dict`` keys
(``layers.{i}.blocks.{j}.attn.qkv.weight``, ...), the layout
``audio_residual_tpu/models/convert.py`` writes.

Mel fusion (``enable_fusion`` with a ``fusion_type``, ``htsat.py:525-608,
682-750``) takes ``{"mel_fusion": [B, 4, T, F], "longer": [B]}`` (channel
0 the global mel, 1-3 the local chunks: ``data/featurize.py::
get_audio_features(data_truncating="fusion")``). bn0 normalises it with its
eval statistics; the AMP cast comes after bn0, as for a waveform. The
``*_1d`` types fuse the chunks into the global mel before the image
(``mel_conv1d``: Conv1d k5 s3 p2 + BN, chunks concatenated on time, padded or
trimmed to T, DAF/AFF/iAFF over the mel bins); the ``*_2d`` types fold all
four channels to images and fuse in the patch embedding (the global channel
on the patch GEMM, the local ones through ``patch_embed.mel_conv2d``,
kernel (P, 3P) stride (S, 3S), concatenated on the width, padded or trimmed
to the global width); ``channel_map`` embeds the four channels with a
4-channel ``proj``. Clips with ``longer`` False keep the global channel
alone. The fusion internals run in f32; the Swin layers run K4, K2 and K3
as for a waveform. A 2-D fusion or ``channel_map`` model needs the fusion
input (a waveform raises); a non-fusion model given it uses the global
channel.

Kernel routing: every block of a layer with several windows per image runs
``fused_swin_block`` (K4); a layer whose window covers the whole image (one
window per image: layer 3) runs the split plan -- LN1,
``fused_window_attention``, then ``fused_residual_ffn`` (K3). Both
attention entry points send C >= 1024 to K5 (``wide_window_attention``), as
the JAX package sends those widths to its weight-streaming kernel: the two
blocks of HTSAT-base layer 3 (C=1024) run LN1, K5, K3; HTSAT-large layer 2
(C=1024, four windows) does the same inside ``fused_swin_block``. On the
CPU each kernel wrapper takes its plain version.

Routing under taps (``taps=("residual",)`` and/or ``("attention",)``), the
JAX package's (``htsat.py:803-806``): K4 runs in no block. Every block runs
the split plan -- LN1, the window attention, K3 -- so the attention output
``a`` can be read between the halves. With the residual tap alone the
attention is K2 (K5 from C >= 1024); the attention tap needs the
probabilities, which no kernel returns, so there the attention half is the
model's own :func:`window_attention` (``htsat.py:311``) and the FFN half
still K3.

Training mode (``train=True``, ``htsat.py:301-308,380-384,423-462,
704-707``): bn0 normalises with the batch statistics and returns the
updated running statistics as ``bn0_state``; with a ``generator``,
SpecAugment masks the normalised log-mel and drop-path drops whole samples
of each block's two branches, block ``k`` at rate ``dpr[k] =
linspace(0, drop_path_rate, sum(depths))[k]``. Without a generator nothing
random happens (the JAX package's ``rng=None``). The kernel routing follows
the JAX package's: K4 runs only in a block where ``not (train and dpr >
0)`` (block 0 at the default rate 0.1); every other block runs LN1 in
PyTorch, K2 (K5 from C >= 1024), drop-path, then the FFN in plain PyTorch,
so K3 runs in no such block. Random draws are split from the mask
arithmetic (:func:`drop_path` takes its mask, :func:`sample_drop_path`
draws it), so a test can feed the JAX package's masks.

Shapes for HTSAT-tiny on a 10 s / 48 kHz clip: wav [B, 480000] -> logmel
[B, 1001, 64] -> image [B, 256, 256, 1] -> tokens 4096@96 -> 1024@192 ->
256@384 -> 64@768 -> embedding [B, 768].
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch.ops import frontend, interpolate, windows
from audio_residual_tpu_torch.ops.common import golden_convs, layer_norm
from audio_residual_tpu_torch.ops.fusion import (EvalBatchNorm, batch_norm_eval, fusion_kind,
                                                 make_fusion)
from audio_residual_tpu_torch.ops.cuda.frontend import fused_logmel
from audio_residual_tpu_torch.ops.cuda.swin_block import fused_swin_block, split_block
from audio_residual_tpu_torch.ops.cuda.window_attention import fused_window_attention
from audio_residual_tpu_torch.ops.spec_augment import sample_spec_augment, spec_augment
from audio_residual_tpu_torch.residual.module import residual_apply

__all__ = ["HTSATConfig", "HTSAT_VARIANTS", "HTSAT", "reshape_wav2img", "window_attention",
           "TAPS", "drop_path", "sample_drop_path", "drop_path_rates", "fuse_1d"]

TAPS = ("attention", "residual")


@dataclass(frozen=True)
class HTSATConfig:
    """Static architecture + DSP config (HTSAT-tiny defaults)."""

    spec_size: int = 256
    patch_size: int = 4
    patch_stride: tuple[int, int] = (4, 4)
    in_chans: int = 1
    num_classes: int = 527
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_path_rate: float = 0.1
    patch_norm: bool = True
    sample_rate: int = 48000
    clip_samples: int = 480000
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    n_fft: int = 1024
    hop_size: int = 480
    enable_fusion: bool = False
    fusion_type: str = "None"
    # the frontend DFT's mode: None follows compute_dtype ("bf16" under AMP,
    # else "f32"); "f32" or "bf16" override it. The JAX package's "bf16x3"
    # split dot is a TPU-only workaround and is not carried over.
    dft_mode: str | None = None

    @property
    def fusion(self) -> str | None:
        """``"1d"``, ``"2d"``, ``"channel_map"`` or None (no fusion)."""
        return fusion_kind(self.enable_fusion, self.fusion_type)

    @property
    def freq_ratio(self) -> int:
        return self.spec_size // self.mel_bins

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patches_resolution(self) -> tuple[int, int]:
        g = self.spec_size // self.patch_stride[0]
        return (g, g)

    def layer_resolution(self, i: int) -> tuple[int, int]:
        g = self.patches_resolution
        return (g[0] // (2**i), g[1] // (2**i))

    def layer_dim(self, i: int) -> int:
        return int(self.embed_dim * 2**i)

    @property
    def frontend_config(self) -> frontend.FrontendConfig:
        return frontend.FrontendConfig(
            sample_rate=self.sample_rate, n_fft=self.n_fft, hop_length=self.hop_size,
            win_length=self.n_fft, n_mels=self.mel_bins, fmin=self.fmin, fmax=self.fmax,
        )

    @property
    def tscam_sf(self) -> int:
        return (
            self.spec_size // (2 ** (self.num_layers - 1)) // self.patch_stride[0] // self.freq_ratio
        )


HTSAT_VARIANTS = {
    "tiny": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(4, 8, 16, 32)),
    "base": dict(embed_dim=128, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
    "large": dict(embed_dim=256, depths=(2, 2, 12, 2), num_heads=(4, 8, 16, 32)),
}


# ---------------------------------------------------------------------------
# modules (parameters only; the forward is functional below)
# ---------------------------------------------------------------------------


def _trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02) -> None:
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


def _linear(d_in: int, d_out: int, gen: torch.Generator, bias: bool = True) -> nn.Linear:
    m = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        _trunc_normal_(m.weight, gen)
        if bias:
            m.bias.zero_()
    return m


class BatchNormMel(nn.Module):
    """``bn0``: BatchNorm over the mel axis, eval statistics in ``forward``,
    batch statistics in :meth:`train_forward`. The reference's
    ``num_batches_tracked`` buffer is not kept (the converter drops it)."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return frontend.batch_norm_mel(x, self.weight, self.bias, self.running_mean,
                                       self.running_var)

    def train_forward(self, x: torch.Tensor, group=None) -> tuple:
        """``(y, {"mean", "var"})``: normalised with the batch statistics,
        and the running statistics they update (not written here: the train
        step merges them, as the JAX package's does)."""
        y, mean, var = frontend.batch_norm_mel_train(x, self.weight, self.bias,
                                                     self.running_mean, self.running_var,
                                                     group=group)
        return y, {"mean": mean, "var": var}


def _patch_padding(cfg: HTSATConfig) -> tuple[int, int]:
    return ((cfg.patch_size - cfg.patch_stride[0]) // 2,
            (cfg.patch_size - cfg.patch_stride[1]) // 2)


def _uniform_conv(conv: nn.Module, gen: torch.Generator) -> None:
    """U(-1, 1) * sqrt(1 / fan_in) weight, zero bias (the JAX init)."""
    fan_in = conv.weight[0].numel()
    with torch.no_grad():
        nn.init.uniform_(conv.weight, -1.0, 1.0, generator=gen)
        conv.weight.mul_(math.sqrt(1.0 / fan_in))
        conv.bias.zero_()


class PatchEmbed(nn.Module):
    """``proj`` (4 input channels under ``channel_map``) and ``norm``; the
    2-D fusion types add ``mel_conv2d`` and ``fusion_model``
    (:meth:`add_fusion`)."""

    def __init__(self, cfg: HTSATConfig, gen: torch.Generator):
        super().__init__()
        in_ch = cfg.in_chans * (4 if cfg.fusion == "channel_map" else 1)
        self.proj = nn.Conv2d(in_ch, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_stride,
                              padding=_patch_padding(cfg))
        _uniform_conv(self.proj, gen)
        self.norm = nn.LayerNorm(cfg.embed_dim) if cfg.patch_norm else None

    def add_fusion(self, cfg: HTSATConfig, gen: torch.Generator) -> None:
        p, s = cfg.patch_size, cfg.patch_stride
        self.mel_conv2d = nn.Conv2d(cfg.in_chans, cfg.embed_dim, (p, 3 * p),
                                    stride=(s[0], 3 * s[1]), padding=_patch_padding(cfg))
        _uniform_conv(self.mel_conv2d, gen)
        self.fusion_model = make_fusion(cfg.fusion_type, cfg.embed_dim, gen)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, nh: int, window: int, qkv_bias: bool, gen: torch.Generator):
        super().__init__()
        self.qkv = _linear(dim, 3 * dim, gen, bias=qkv_bias)
        self.proj = _linear(dim, dim, gen)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * window - 1) ** 2, nh))
        with torch.no_grad():
            _trunc_normal_(self.relative_position_bias_table, gen)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = _linear(dim, hidden, gen)
        self.fc2 = _linear(hidden, dim, gen)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, nh: int, cfg: HTSATConfig, gen: torch.Generator):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, nh, cfg.window_size, cfg.qkv_bias, gen)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), gen)

    def flat_params(self) -> tuple:
        """The kernels' parameter tuple (``fused_swin_block`` order)."""
        return (self.norm1.weight, self.norm1.bias, self.attn.qkv.weight, self.attn.qkv.bias,
                self.attn.proj.weight, self.attn.proj.bias, self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight, self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                self.attn.relative_position_bias_table)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, gen: torch.Generator):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = _linear(4 * dim, 2 * dim, gen, bias=False)


class BasicLayer(nn.Module):
    def __init__(self, i: int, cfg: HTSATConfig, gen: torch.Generator):
        super().__init__()
        dim = cfg.layer_dim(i)
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, cfg.num_heads[i], cfg, gen) for _ in range(cfg.depths[i])]
        )
        self.downsample = PatchMerging(dim, gen) if i < cfg.num_layers - 1 else None


class HTSAT(nn.Module):
    """Parameters of the HTSAT audio branch, initialised as the JAX package
    initialises them (trunc-normal linears, unit LN), from ``generator``.
    The forward is :func:`htsat_apply`."""

    def __init__(self, cfg: HTSATConfig = HTSATConfig(), generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.bn0 = BatchNormMel(cfg.mel_bins)
        self.patch_embed = PatchEmbed(cfg, gen)
        self.layers = nn.ModuleList([BasicLayer(i, cfg, gen) for i in range(cfg.num_layers)])
        self.norm = nn.LayerNorm(cfg.num_features)
        self.tscam_conv = nn.Conv2d(cfg.num_features, cfg.num_classes,
                                    kernel_size=(cfg.tscam_sf, 3), padding=(0, 1))
        fan_in = cfg.num_features * cfg.tscam_sf * 3
        with torch.no_grad():
            nn.init.uniform_(self.tscam_conv.weight, -1.0, 1.0, generator=gen)
            self.tscam_conv.weight.mul_(math.sqrt(1.0 / fan_in))
            self.tscam_conv.bias.zero_()
        self.head = _linear(cfg.num_classes, cfg.num_classes, gen)
        # the fusion modules draw last, so the rest is a non-fusion model's
        if cfg.fusion == "1d":
            m = cfg.mel_bins
            self.mel_conv1d = nn.Sequential(nn.Conv1d(m, m, 5, stride=3, padding=2),
                                            EvalBatchNorm(m))
            _uniform_conv(self.mel_conv1d[0], gen)
            self.fusion_model = make_fusion(cfg.fusion_type, m, gen)
        elif cfg.fusion == "2d":
            self.patch_embed.add_fusion(cfg, gen)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _ln(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, m.weight, m.bias)


def reshape_wav2img(x: torch.Tensor, cfg: HTSATConfig) -> torch.Tensor:
    """Log-mel ``[B, T, F]`` -> Swin image ``[B, spec_size, spec_size, 1]``:
    bicubic stretch of T to ``spec_size * freq_ratio``, then time folded into
    ``freq_ratio`` chunks stacked along the frequency axis, chunk-major."""
    b = x.shape[0]
    target_t = cfg.spec_size * cfg.freq_ratio
    target_f = cfg.spec_size // cfg.freq_ratio
    x = interpolate.resize_bicubic_align_corners(x, target_t, target_f)
    x = x.transpose(1, 2).reshape(b, target_f, cfg.freq_ratio, target_t // cfg.freq_ratio)
    x = x.permute(0, 2, 1, 3).reshape(b, cfg.freq_ratio * target_f, target_t // cfg.freq_ratio)
    return x[..., None]


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with its stride and padding on NHWC ``x``, the weight in
    ``x``'s dtype and the bias added after (promoting, as the JAX package's
    f32 bias does)."""
    with golden_convs():
        y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), None, conv.stride,
                     conv.padding)
    return y.permute(0, 2, 3, 1) + conv.bias


def _proj_conv(conv: nn.Conv2d, x: torch.Tensor, cfg: HTSATConfig) -> torch.Tensor:
    """The patch conv (NHWC in and out): non-overlapping patches (every
    shipped config) as reshape + one GEMM, overlapping ones as a padded
    strided convolution."""
    ph, pw = cfg.patch_stride
    b, h, w, cin = x.shape
    if not (cfg.patch_size == ph == pw and h % ph == 0 and w % pw == 0):
        return _conv_nhwc(conv, x)
    patches = (
        x.reshape(b, h // ph, ph, w // pw, pw, cin)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(b * (h // ph) * (w // pw), ph * pw * cin)
    )
    kernel = conv.weight.permute(2, 3, 1, 0).reshape(ph * pw * cin, -1).to(x.dtype)
    y = patches @ kernel + conv.bias
    return y.reshape(b, h // ph, w // pw, -1)


def _nchw_fuse(fusion: nn.Module, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A fusion module on NHWC (or NWC) tensors: channels first and back."""
    perm = (0, x.ndim - 1, *range(1, x.ndim - 1))
    inv = (0, *range(2, x.ndim), 1)
    return fusion(x.permute(perm), y.permute(perm)).permute(inv)


def _patch_embed(pe: PatchEmbed, x: torch.Tensor, cfg: HTSATConfig, longer=None) -> torch.Tensor:
    """Patch conv -> ``[B, N, C]`` -> LN; the 2-D fusion types fuse the local
    channels' ``mel_conv2d`` patches into the global channel's where
    ``longer`` is set (``htsat.py:525-573``)."""
    if cfg.fusion != "2d":
        y = _proj_conv(pe.proj, x, cfg)
    else:
        b = x.shape[0]
        global_y = _proj_conv(pe.proj, x[..., 0:1], cfg)
        ww = global_y.shape[2]
        local = x[..., 1:].permute(0, 3, 1, 2).reshape(b * 3, *x.shape[1:3], 1)
        ly = _conv_nhwc(pe.mel_conv2d, local)
        _, lh, lw, lc = ly.shape
        # chunk-concat along the width
        ly = ly.reshape(b, 3, lh, lw, lc).permute(0, 2, 1, 3, 4).reshape(b, lh, 3 * lw, lc)
        ly = F.pad(ly, (0, 0, 0, ww - 3 * lw)) if 3 * lw < ww else ly[:, :, :ww]
        fused = _nchw_fuse(pe.fusion_model, global_y, ly)
        y = fused if longer is None else torch.where(longer[:, None, None, None], fused,
                                                     global_y)
    b, h, w, c = y.shape
    y = y.reshape(b, h * w, c)
    return _ln(pe.norm, y) if pe.norm is not None else y


def fuse_1d(mel_conv1d: nn.Sequential, fusion: nn.Module, mel: torch.Tensor, longer
            ) -> torch.Tensor:
    """1-D fusion of ``mel [B, 4, T, F]`` (``htsat.py:576-608``, PANN's
    ``pann.py`` twin): the local chunks through ``mel_conv1d`` (Conv1d k5
    s3 p2 + BN), concatenated on time, padded or trimmed to T, fused into
    the global mel over the mel bins where ``longer`` is set; returned in
    ``mel``'s dtype (the fusion itself runs in f32)."""
    b, _, t, f = mel.shape
    global_mel = mel[:, 0]
    local = mel[:, 1:].reshape(b * 3, t, f).transpose(1, 2)  # [3B, F, T]
    conv, bn = mel_conv1d
    with golden_convs():
        ly = F.conv1d(local, conv.weight.to(mel.dtype), None, conv.stride, conv.padding)
    ly = batch_norm_eval(bn, ly + conv.bias[:, None])
    tp = ly.shape[-1]
    ly = ly.reshape(b, 3, f, tp).permute(0, 1, 3, 2).reshape(b, 3 * tp, f)
    ly = F.pad(ly, (0, 0, 0, t - 3 * tp)) if 3 * tp < t else ly[:, :t]
    fused = _nchw_fuse(fusion, global_mel, ly)
    if longer is not None:
        fused = torch.where(longer[:, None, None], fused, global_mel)
    return fused.to(mel.dtype)


def _patch_merge(pm: PatchMerging, x: torch.Tensor, resolution) -> torch.Tensor:
    """2x2 neighbourhood concat -> LN -> linear, computed in f32."""
    h, w = resolution
    b, _, c = x.shape
    x = x.float().reshape(b, h, w, c)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
    x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
    return F.linear(_ln(pm.norm, x), pm.reduction.weight)


def window_attention(attn: WindowAttention, x: torch.Tensor, nh: int, window: int,
                     mask: torch.Tensor | None = None, compute_dtype=None) -> tuple:
    """W-MSA with relative position bias, the attention tap's model-level
    function (``audio_residual_tpu/models/htsat.py::window_attention``):
    ``x [B_, N, C]`` windows -> ``(out [B_, N, C] in x's dtype, probs
    [B_, nH, N, N] f32)``. Under AMP the qkv product and its output are in
    ``compute_dtype``, scores and softmax in f32, the probabilities rounded
    to ``compute_dtype`` for the product with v (f32 accumulate), the
    projection in f32, as the JAX function computes them."""
    b_, n, c = x.shape
    hd = c // nh
    in_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    qkv = F.linear(x, attn.qkv.weight.to(x.dtype),
                   attn.qkv.bias.to(x.dtype) if attn.qkv.bias is not None else None)
    qkv = qkv.reshape(b_, n, 3, nh, hd)
    q = qkv[:, :, 0].transpose(1, 2) * hd**-0.5
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores + windows.gather_relative_bias(
        attn.relative_position_bias_table.float(), window, window)[None]
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.reshape(b_ // nw, nw, nh, n, n) + mask[None, :, None]).reshape(
            b_, nh, n, n)
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype).float() @ v.float()
    out = out.transpose(1, 2).reshape(b_, n, c)
    out = F.linear(out, attn.proj.weight.float(), attn.proj.bias.float())
    return out.to(in_dtype), probs


def drop_path_rates(cfg: HTSATConfig) -> np.ndarray:
    """Each block's drop-path rate, in block order over the layers
    (``htsat.py:773``)."""
    return np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))


def drop_path(x: torch.Tensor, mask: torch.Tensor | None, rate: float) -> torch.Tensor:
    """Stochastic depth per sample (``htsat.py:301-308``): ``x / (1 - rate)
    * mask``, ``mask [B]`` of zeros and ones; ``mask=None`` is the
    identity."""
    if mask is None or rate == 0.0:
        return x
    return x / (1.0 - rate) * mask.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))


def sample_drop_path(generator: torch.Generator, b: int, rate: float, device=None
                     ) -> torch.Tensor:
    """A drop-path mask ``[B]``: ``floor(1 - rate + U[0, 1))``, one in
    ``1 - rate`` of the samples kept."""
    u = torch.rand(b, generator=generator,
                   device=device if device is not None else generator.device)
    return torch.floor((1.0 - rate) + u)


def _mlp(mlp: Mlp, x: torch.Tensor) -> torch.Tensor:
    return F.linear(F.gelu(F.linear(x, mlp.fc1.weight, mlp.fc1.bias)), mlp.fc2.weight,
                    mlp.fc2.bias)


def _train_block(blk: SwinBlock, x: torch.Tensor, *, resolution, nh: int, window: int,
                 shift: int, rate: float, masks, residual_params, double_ffn_compat,
                 compute_dtype) -> torch.Tensor:
    """A block with drop-path in training (``htsat.py:423-462``): LN1 in
    PyTorch, the window attention kernel (K2, K5 from C >= 1024), drop-path,
    the ResiDual when one is given, then the FFN in plain PyTorch. The
    arithmetic follows the JAX package's dtypes: LN1's f32 parameters
    promote its output to f32, so the attention gives f32 and the FFN runs
    in f32 under AMP too."""
    h, w = resolution
    b, n, c = x.shape
    shortcut = x
    y = layer_norm(x.float(), blk.norm1.weight, blk.norm1.bias).reshape(b, h, w, c)
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    wins = windows.window_partition(y, window).contiguous()
    attn = blk.attn
    a = fused_window_attention(wins, attn.qkv.weight, attn.qkv.bias, attn.proj.weight,
                               attn.proj.bias, attn.relative_position_bias_table, nh, window,
                               (h // window) * (w // window), shift, (h, w), compute_dtype)
    y = windows.window_reverse(a, window, h, w)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    y = y.reshape(b, n, c)
    m1, m2 = masks if masks is not None else (None, None)
    residual_x = drop_path(y, m1, rate)
    if residual_params is not None:
        residual_x = residual_apply(residual_x, residual_params["basis"],
                                    residual_params["mean"], residual_params["lam"])

    def ffn(t):
        return _mlp(blk.mlp, layer_norm(t, blk.norm2.weight, blk.norm2.bias))

    x = shortcut + residual_x
    x = x + drop_path(ffn(x), m2, rate)
    if residual_params is not None and double_ffn_compat:
        # the ResiDual-patched forward's quirk (src/residual.py:95-96)
        x = shortcut + drop_path(x, m2, rate)
        x = x + drop_path(ffn(x), m2, rate)
    return x


def swin_block(blk: SwinBlock, x: torch.Tensor, *, resolution, nh: int, window: int, shift: int,
               residual_params: dict | None = None, double_ffn_compat: bool = True,
               compute_dtype=None, taps=(), drop_path_rate: float = 0.0, train: bool = False,
               drop_masks=None) -> tuple:
    """One Swin block on tokens ``[B, H*W, C]``, with the ResiDual epilogue
    when ``residual_params`` is given. A window at least the resolution means
    shift 0 (the reference's rule).

    Returns ``(x, probs, residual_x)``: with the ``"attention"`` tap
    ``probs [B*nW, nH, N, N]``, with the ``"residual"`` tap the
    post-attention residual ``residual_x [B, H*W, C]``, taken after the
    ResiDual when one is injected (the patched forward's ``residual_fn``);
    None otherwise. Both are f32 in either mode, as the JAX package's tapped
    forward gives them. Under AMP the residual tap carries the attention
    output's store rounding: where the block input is bf16 (layers 0-2) K2
    stores ``a`` in bf16, where the JAX package's attention gives it in f32
    from an f32 LN1, so the tap is bf16-precise there. Taps route every
    block through the split plan (module docstring).

    ``train`` with ``drop_path_rate > 0`` runs the training block (LN1, the
    window attention kernel, drop-path with ``drop_masks``, a ``(mask1,
    mask2)`` pair of ``[B]`` masks or None, and the FFN in PyTorch), as the
    JAX package's block does where its block kernel is not taken."""
    h, w = resolution
    b, n, c = x.shape
    if min(h, w) <= window:
        shift = 0
        window = min(h, w)
    if train and drop_path_rate > 0.0:
        return _train_block(blk, x, resolution=resolution, nh=nh, window=window, shift=shift,
                            rate=drop_path_rate, masks=drop_masks,
                            residual_params=residual_params,
                            double_ffn_compat=double_ffn_compat,
                            compute_dtype=compute_dtype), None, None
    y = x.reshape(b, h, w, c)
    if shift > 0:
        y = torch.roll(y, (-shift, -shift), dims=(1, 2))
    wins = windows.window_partition(y, window).contiguous()
    nw_img = (h // window) * (w // window)
    use_res = residual_params is not None
    flat = blk.flat_params()
    if use_res:
        flat = flat + (residual_params["basis"], residual_params["mean"], residual_params["lam"])
    args = (wins, flat, nh, window, nw_img, shift, (h, w), use_res, double_ffn_compat,
            compute_dtype)
    probs = residual_x = None
    if taps or nw_img == 1:
        attention = None
        if "attention" in taps:
            mask = (torch.from_numpy(windows.shift_window_mask(h, w, window, shift)).to(x.device)
                    if shift > 0 else None)

            def attention(t):
                nonlocal probs
                out, probs = window_attention(blk.attn, t, nh, window, mask, compute_dtype)
                return out

        out, a = split_block(*args, attention=attention)
        if "residual" in taps:
            a = windows.window_reverse(a, window, h, w)
            if shift > 0:
                a = torch.roll(a, (shift, shift), dims=(1, 2))
            residual_x = a.reshape(b, n, c).float()
            if use_res:
                residual_x = residual_apply(residual_x, residual_params["basis"],
                                            residual_params["mean"], residual_params["lam"])
    else:
        out = fused_swin_block(*args)
    y = windows.window_reverse(out, window, h, w)
    if shift > 0:
        y = torch.roll(y, (shift, shift), dims=(1, 2))
    return y.reshape(b, n, c), probs, residual_x


def htsat_apply(model: HTSAT, batch, *, train: bool = False,
                generator: torch.Generator | None = None, bn_group=None, taps=(),
                residual: dict | None = None, double_ffn_compat: bool = True,
                compute_dtype=None, start_layer: int = 0, stop_at_layer: int | None = None,
                stop_at_image: bool = False) -> dict:
    """HTSAT forward; returns ``framewise_output``, ``clipwise_output``,
    ``fine_grained_embedding`` and ``embedding``, and with ``taps``:
    ``layers_attention`` (``"attention"``: per layer the mean over its blocks
    of the probabilities ``[B*nW, nH, N, N]``) and ``layers_residuals``
    (``"residual"``: per layer its blocks' post-attention residuals
    ``[B, L, C]`` concatenated on the token axis, each taken after the
    ResiDual when one is injected). Taps change the kernels' routing, not
    the function (module docstring).

    ``batch``: ``{"waveform": [B, T]}`` or a bare ``[B, T]`` tensor, the
    fusion input ``{"mel_fusion": [B, 4, T, F], "longer": [B]}`` (module
    docstring), or a cached prefix to resume from: ``{"image": [B, H, W,
    1]}`` (always from layer 0) or ``{"tokens": [B, L, C]}`` (from
    ``start_layer``).

    Split points for frozen-prefix caching
    (``audio_residual_tpu/models/htsat.py::htsat_apply``): ``stop_at_image``
    returns ``{"image": ...}`` right after ``reshape_wav2img``, in the dtype
    the path made it (bf16 under AMP); ``stop_at_layer=l`` runs the layers
    below ``l`` and returns ``{"tokens": x}``. A resume runs the same
    operations as the uncached forward from that point, so it gives the
    same bits.

    ``residual``: ``{layer_idx: {"basis": [K, D], "mean": [D], "lam": [K]}}``,
    applied in every block of the layer. ``compute_dtype=torch.bfloat16`` is
    the AMP path: bf16 operands with f32 accumulate from the bn0 output on,
    the frontend's DFT in bf16, LN/softmax/ResiDual in f32. ``cfg.dft_mode``
    ("f32" or "bf16"), when set, picks the DFT's mode whatever
    ``compute_dtype`` is (``audio_residual_tpu/models/htsat.py:698-700``).

    ``train=True`` is the training forward (module docstring): bn0's batch
    statistics (over every rank of ``bn_group``, a ``torch.distributed``
    process group, when one is given), ``bn0_state`` in the output for a
    waveform input, and with ``generator`` SpecAugment and drop-path drawn
    from it on its device, in that order. Taps are eval-time outputs and
    are not taken in training.
    """
    cfg = model.cfg
    if train and taps:
        raise ValueError("taps are eval-time outputs; the training forward takes none")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
    taps = tuple(taps)
    if set(taps) - set(TAPS):
        raise ValueError(f"unknown taps {sorted(set(taps) - set(TAPS))}; the forward taps {TAPS}")
    if isinstance(batch, dict) and ("tokens" in batch or "image" in batch):
        if stop_at_image:
            raise ValueError("stop_at_image needs a waveform input")
        if "image" in batch:
            if start_layer != 0:
                raise ValueError("image input always resumes at layer 0")
            x = batch["image"]
            if compute_dtype is not None:
                x = x.to(compute_dtype)
            frames_num = x.shape[1]
            x = _patch_embed(model.patch_embed, x, cfg)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
        else:
            # in the dtype they were cached in: under AMP the port's
            # PatchMerging hands the next layer f32 (the JAX package casts
            # here, where its PatchMerging already gave bf16)
            x = batch["tokens"]
            frames_num = cfg.spec_size
        return _layers_and_head(model, x, frames_num, taps=taps, residual=residual,
                                double_ffn_compat=double_ffn_compat,
                                compute_dtype=compute_dtype,
                                start_layer=start_layer if "tokens" in batch else 0,
                                stop_at_layer=stop_at_layer, train=train, generator=generator)

    if isinstance(batch, dict) and "mel_fusion" in batch:
        if stop_at_image:
            raise ValueError("stop_at_image supports non-fusion waveforms only")
        x = _fusion_image(model, batch, train=train, generator=generator,
                          compute_dtype=compute_dtype)
        frames_num = x.shape[1]
        x = _patch_embed(model.patch_embed, x, cfg, longer=batch.get("longer"))
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return _layers_and_head(model, x, frames_num, taps=taps, residual=residual,
                                double_ffn_compat=double_ffn_compat,
                                compute_dtype=compute_dtype, start_layer=0,
                                stop_at_layer=stop_at_layer, train=train, generator=generator)
    if cfg.fusion in ("2d", "channel_map"):
        raise ValueError(f"a {cfg.fusion_type} fusion model takes {{'mel_fusion', 'longer'}} "
                         "(data/featurize.py::get_audio_features(data_truncating='fusion')), "
                         "not a waveform")
    wav = batch["waveform"] if isinstance(batch, dict) else batch
    # the frontend's DFT follows the AMP mode (single-pass bf16 under AMP)
    # unless the config names one
    dft = cfg.dft_mode or ("bf16" if compute_dtype == torch.bfloat16 else "f32")
    if dft == "bf16x3":
        raise ValueError("dft_mode 'bf16x3': the split dot is a TPU-only workaround (Mosaic has "
                         "no Precision.HIGH) and is not carried over; use 'f32' or 'bf16'")
    x = fused_logmel(wav.float().contiguous(), cfg.frontend_config, dft_mode=dft)
    bn0_state = None
    if train:
        # batch statistics in f32 over [B, T, F], then SpecAugment, before
        # the AMP cast (htsat.py:704-707)
        x, bn0_state = model.bn0.train_forward(x, group=bn_group)
        if generator is not None:
            x = spec_augment(x, *sample_spec_augment(generator, x.shape, device=x.device))
    else:
        x = model.bn0(x)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    x = reshape_wav2img(x, cfg)
    if stop_at_image:
        return {"image": x}
    frames_num = x.shape[1]
    x = _patch_embed(model.patch_embed, x, cfg)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    out = _layers_and_head(model, x, frames_num, taps=taps, residual=residual,
                           double_ffn_compat=double_ffn_compat, compute_dtype=compute_dtype,
                           start_layer=0, stop_at_layer=stop_at_layer, train=train,
                           generator=generator)
    if bn0_state is not None and stop_at_layer is None:
        out["bn0_state"] = bn0_state
    return out


def _fusion_image(model: HTSAT, batch: dict, *, train: bool, generator, compute_dtype
                  ) -> torch.Tensor:
    """The fusion input -> the Swin image (``htsat.py:729-750``): bn0 with
    its eval statistics, the AMP cast, then the 1-D fusion and one image, or
    the four channels folded to a 4-channel image (2-D types,
    ``channel_map``), or, for a model without fusion, the global channel.
    In training with a ``generator``, SpecAugment on the fused mel (1-D) or
    on each channel (the others)."""
    cfg = model.cfg
    mel = model.bn0(batch["mel_fusion"].float())
    if compute_dtype is not None:
        mel = mel.to(compute_dtype)
    if cfg.fusion == "1d":
        x1d = fuse_1d(model.mel_conv1d, model.fusion_model, mel, batch.get("longer"))
        if train and generator is not None:
            x1d = spec_augment(x1d, *sample_spec_augment(generator, x1d.shape,
                                                         device=x1d.device))
        return reshape_wav2img(x1d, cfg)
    if cfg.fusion is None:
        return reshape_wav2img(mel[:, 0], cfg)
    b, c, t, f = mel.shape
    if train and generator is not None:
        flat = mel.reshape(b * c, t, f)
        mel = spec_augment(flat, *sample_spec_augment(generator, flat.shape,
                                                      device=mel.device)).reshape(mel.shape)
    x = reshape_wav2img(mel.reshape(b * c, t, f), cfg)
    return x[..., 0].reshape(b, c, *x.shape[1:3]).permute(0, 2, 3, 1)


def _layers_and_head(model: HTSAT, x: torch.Tensor, frames_num: int, *, taps=(), residual,
                     double_ffn_compat, compute_dtype, start_layer: int,
                     stop_at_layer: int | None, train: bool = False,
                     generator: torch.Generator | None = None) -> dict:
    """Swin layers ``start_layer .. stop_at_layer`` (or the end) on tokens
    ``x``, then the head (``htsat.py::_htsat_layers_and_head``), with the
    taps and the training mode of :func:`htsat_apply`."""
    cfg = model.cfg
    tap_attn, tap_res = [], []
    end_layer = stop_at_layer if stop_at_layer is not None else cfg.num_layers
    dpr = drop_path_rates(cfg)
    blk_idx = sum(cfg.depths[:start_layer])
    for i in range(start_layer, end_layer):
        layer = model.layers[i]
        res_i = residual.get(i) if residual is not None else None
        resolution = cfg.layer_resolution(i)
        layer_attns, layer_residuals = [], []
        for j, blk in enumerate(layer.blocks):
            rate = float(dpr[blk_idx])
            masks = None
            if train and generator is not None and rate > 0.0:
                masks = tuple(sample_drop_path(generator, x.shape[0], rate, x.device)
                              for _ in range(2))
            x, probs, res_x = swin_block(
                blk, x, resolution=resolution, nh=cfg.num_heads[i], window=cfg.window_size,
                shift=0 if j % 2 == 0 else cfg.window_size // 2, residual_params=res_i,
                double_ffn_compat=double_ffn_compat, compute_dtype=compute_dtype, taps=taps,
                drop_path_rate=rate, train=train, drop_masks=masks,
            )
            blk_idx += 1
            if "attention" in taps:
                layer_attns.append(probs)
            if "residual" in taps:
                layer_residuals.append(res_x)
        if layer.downsample is not None:
            x = _patch_merge(layer.downsample, x, resolution)
        if "attention" in taps:
            tap_attn.append(torch.stack(layer_attns).mean(dim=0))
        if "residual" in taps:
            tap_res.append(torch.cat(layer_residuals, dim=1))
    if stop_at_layer is not None:
        return {"tokens": x}

    x = _ln(model.norm, x.float())
    b, _, c = x.shape
    nl = cfg.num_layers
    sf = frames_num // (2 ** (nl - 1)) // cfg.patch_stride[0]
    st = frames_num // (2 ** (nl - 1)) // cfg.patch_stride[1]
    c_freq_bin = sf // cfg.freq_ratio
    # regroup the chunk-folded frequency axis back into (freq, time)
    x = x.reshape(b, cfg.freq_ratio, c_freq_bin, st, c)
    x = x.permute(0, 2, 1, 3, 4).reshape(b, c_freq_bin, cfg.freq_ratio * st, c)

    fine_grained = interpolate.repeat_frames(x.mean(dim=1), 8 * cfg.patch_stride[1])
    latent = x.mean(dim=(1, 2))
    with golden_convs():  # an f32 conv in both modes, as in JAX (`htsat.py:843-849`)
        logits_map = model.tscam_conv(x.permute(0, 3, 1, 2))  # [B, classes, 1, T']
    logits_map = logits_map[:, :, 0].transpose(1, 2)  # [B, T', classes]
    fpx = interpolate.repeat_frames(torch.sigmoid(logits_map), 8 * cfg.patch_stride[1])
    out = {
        "framewise_output": fpx,
        "clipwise_output": torch.sigmoid(logits_map.mean(dim=1)),
        "fine_grained_embedding": fine_grained,
        "embedding": latent,
    }
    if "attention" in taps:
        out["layers_attention"] = tap_attn
    if "residual" in taps:
        out["layers_residuals"] = tap_res
    return out
