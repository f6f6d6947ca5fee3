"""Feature fusion: DAF, AFF and iAFF in 1-D and 2-D.

Port of ``audio_residual_tpu/ops/fusion.py`` (the reference's
``feature_fusion.py``, from "Attentional Feature Fusion", WACV 2021). They
merge the global shrunk mel with the local mel chunks of a clip longer than
the model's input: the 1-D kind on ``[B, C, T]`` before the patch embedding
(HTSAT ``*_1d``, PANN ``*_1d``), the 2-D kind on ``[B, C, H, W]`` after it
(HTSAT's ``PatchEmbed``, PANN's first conv block).

  * DAF: ``x + y``.
  * AFF: ``m = sigmoid(local_att(x + y) + global_att(mean_hw(x + y)))``,
    out ``2 x m + 2 y (1 - m)``.
  * iAFF: a first AFF stage weights ``x`` and ``y`` into ``xi``; the second
    stage's branches (``local_att2``, ``global_att2``) on ``xi`` give the
    weights of the output ``x m2 + y (1 - m2)``.

Each branch is conv1 (C -> C/r, kernel 1) -> BN -> ReLU -> conv2 (C/r -> C)
-> BN, BN with its eval statistics and eps 1e-5 (the fusion models run in
inference). Module names give the reference keys: ``local_att.{0,1,3,4}``
and, behind the reference's pooling layer at index 0,
``global_att.{1,2,4,5}``. The convolutions are ``F.conv1d`` / ``F.conv2d``:
XLA convolutions in the JAX package, not Pallas kernels. The internals run
in full f32 (TF32 off, :func:`golden_convs`) whatever the inputs' dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch.ops.common import golden_convs

__all__ = ["DAF", "AFF", "IAFF", "make_fusion", "batch_norm_eval", "EvalBatchNorm",
           "FUSION_TYPES", "fusion_kind"]

FUSION_1D = ("daf_1d", "aff_1d", "iaff_1d")
FUSION_2D = ("daf_2d", "aff_2d", "iaff_2d")
FUSION_TYPES = ("None", *FUSION_1D, *FUSION_2D, "channel_map")


def fusion_kind(enable_fusion: bool, fusion_type: str) -> str | None:
    """``"1d"``, ``"2d"``, ``"channel_map"`` or None (no fusion: disabled,
    or ``fusion_type`` "None") of a tower's config; an unknown type raises."""
    if fusion_type not in FUSION_TYPES:
        raise ValueError(f"fusion_type {fusion_type!r}: expected one of {FUSION_TYPES}")
    if not enable_fusion or fusion_type == "None":
        return None
    if fusion_type == "channel_map":
        return "channel_map"
    return "1d" if fusion_type in FUSION_1D else "2d"


def batch_norm_eval(bn: nn.Module, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` over axis 1 of ``x``
    (the JAX package's eval BatchNorm)."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - bn.running_mean.reshape(shape)) * torch.rsqrt(bn.running_var.reshape(shape) + eps)
            * bn.weight.reshape(shape) + bn.bias.reshape(shape))


def _conv(kind: str, c_in: int, c_out: int, gen: torch.Generator) -> nn.Module:
    conv = (nn.Conv2d if kind == "2D" else nn.Conv1d)(c_in, c_out, kernel_size=1)
    lim = 1.0 / math.sqrt(c_in)
    with torch.no_grad():
        nn.init.uniform_(conv.weight, -lim, lim, generator=gen)
        conv.bias.zero_()
    return conv


class EvalBatchNorm(nn.Module):
    """A BatchNorm over axis 1 with its eval statistics: ``weight``,
    ``bias``, ``running_mean``, ``running_var`` (the reference's keys; its
    ``num_batches_tracked`` step count is not kept, the converter drops it,
    as ``bn0``'s is not)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm_eval(self, x)


def _branch(kind: str, channels: int, r: int, gen: torch.Generator, pooled: bool) -> nn.Sequential:
    inter = channels // r
    layers = [_conv(kind, channels, inter, gen), EvalBatchNorm(inter), nn.ReLU(),
              _conv(kind, inter, channels, gen), EvalBatchNorm(channels)]
    if pooled:
        layers.insert(0, (nn.AdaptiveAvgPool2d if kind == "2D" else nn.AdaptiveAvgPool1d)(1))
    return nn.Sequential(*layers)


def _att(branch: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """conv1 -> BN -> ReLU -> conv2 -> BN; a pooled branch on the mean over
    the spatial axes."""
    layers = list(branch)
    if isinstance(layers[0], (nn.AdaptiveAvgPool1d, nn.AdaptiveAvgPool2d)):
        x = x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)
        layers = layers[1:]
    conv1, bn1, _, conv2, bn2 = layers
    conv = F.conv2d if x.ndim == 4 else F.conv1d
    with golden_convs():
        h = torch.relu(batch_norm_eval(bn1, conv(x, conv1.weight, conv1.bias)))
        return batch_norm_eval(bn2, conv(h, conv2.weight, conv2.bias))


class DAF(nn.Module):
    """Direct add fusion (no parameters)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return x + y


class AFF(nn.Module):
    """Attentional feature fusion on ``[B, C, T]`` (``kind="1D"``) or
    ``[B, C, H, W]`` (``"2D"``)."""

    def __init__(self, channels: int, r: int = 4, kind: str = "2D",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.local_att = _branch(kind, channels, r, gen, pooled=False)
        self.global_att = _branch(kind, channels, r, gen, pooled=True)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = x.float(), y.float()
        xa = x + y
        m = torch.sigmoid(_att(self.local_att, xa) + _att(self.global_att, xa))
        return 2 * x * m + 2 * y * (1 - m)


class IAFF(nn.Module):
    """Iterative AFF: a first stage refines the fusion weights, the second
    (``local_att2``, ``global_att2``) applies them."""

    def __init__(self, channels: int, r: int = 4, kind: str = "2D",
                 generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.local_att = _branch(kind, channels, r, gen, pooled=False)
        self.global_att = _branch(kind, channels, r, gen, pooled=True)
        self.local_att2 = _branch(kind, channels, r, gen, pooled=False)
        self.global_att2 = _branch(kind, channels, r, gen, pooled=True)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x, y = x.float(), y.float()
        xa = x + y
        m1 = torch.sigmoid(_att(self.local_att, xa) + _att(self.global_att, xa))
        xi = x * m1 + y * (1 - m1)
        m2 = torch.sigmoid(_att(self.local_att2, xi) + _att(self.global_att2, xi))
        return x * m2 + y * (1 - m2)


def make_fusion(fusion_type: str, channels: int, generator: torch.Generator) -> nn.Module:
    """The fusion module of a ``fusion_type`` (``daf_1d`` ... ``iaff_2d``)."""
    kind = "1D" if fusion_type.endswith("_1d") else "2D"
    name = fusion_type.split("_")[0]
    if name == "daf":
        return DAF()
    if name == "aff":
        return AFF(channels, kind=kind, generator=generator)
    if name == "iaff":
        return IAFF(channels, kind=kind, generator=generator)
    raise ValueError(f"unknown fusion_type {fusion_type!r}")
