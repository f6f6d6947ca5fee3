"""CLIP-legacy vision towers: ``audio_residual_tpu/models/vision.py``.

The reference carries three vision towers from its open_clip ancestry
(`clap_module/model.py:153-241` ModifiedResNet, `model.py:305-372`
VisualTransformer, `clap_module/timm_model.py:20-106` the timm adapter);
the JAX package rebuilds them as NHWC pytrees, the port as ``nn.Module``s
in NCHW with open_clip's parameter names, so a published CLIP
checkpoint's ``visual.*`` keys load into :class:`ModifiedResNet` and
:class:`VisualTransformer` (BatchNorm's step count aside, a derived key):

- :class:`ModifiedResNet`: ``conv1..3``/``bn1..3`` (the 3-conv stem, then a
  2x2 average pool), ``layer{1..4}.{j}`` anti-aliased :class:`Bottleneck`
  (all convolutions stride 1; a stride-s average pool after ``conv2`` and
  in front of ``downsample.0``), ``attnpool`` (:class:`AttentionPool2d`:
  the mean token queries, softmax in f32);
- :class:`VisualTransformer`: ``conv1`` (a stride-``patch`` convolution,
  which equals the JAX package's reshape-plus-matmul ``_patchify``),
  ``class_embedding``, ``positional_embedding``, ``ln_pre``,
  ``transformer.resblocks.{i}`` (the CLIP text tower's blocks, no mask;
  the reference's own class names them ``text_branch``), ``ln_post``,
  ``proj``;
- :class:`TimmModel`: the JAX package's stand-in for timm, a registry of
  those two trunks (``_TRUNKS``) under ``trunk`` with the adapter's pool
  (``avg``, ``''``, ``abs_attn`` as ``head.pool``) and projection
  (``linear`` as ``head.proj``, ``mlp`` as ``head.mlp.fc1/fc2``, ``''``);
  ``rot_attn`` raises as in JAX.

BatchNorm runs on its stored statistics (:class:`~audio_residual_tpu_torch.
ops.fusion.EvalBatchNorm`), as in JAX: the reference never trains these
towers inside CLAP. Golden f32: the forward runs under
``ops/common.py::golden_convs`` (cuDNN and cuBLAS without TF32), as the
JAX package runs them in f32 XLA. No TPU kernel is on this path.
``lock`` / :func:`vision_freeze_mask` freeze by ``requires_grad`` and give
the JAX package's mask by parameter name.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch.data.transforms import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from audio_residual_tpu_torch.models.clip_text import Transformer, resblocks_apply
from audio_residual_tpu_torch.ops.common import golden_convs, layer_norm
from audio_residual_tpu_torch.ops.fusion import EvalBatchNorm

__all__ = ["VisionCfg", "VisualTransformer", "ModifiedResNet", "Bottleneck", "AttentionPool2d",
           "TimmModel", "create_vision_tower", "vision_freeze_mask", "lock",
           "OPENAI_DATASET_MEAN", "OPENAI_DATASET_STD"]


@dataclass(frozen=True)
class VisionCfg:
    """The reference ``CLAPVisionCfg`` (`model.py:375-392`): a tuple
    ``layers`` is a ModifiedResNet's stage depths, an int a ViT's depth."""

    layers: tuple | int = 12
    width: int = 768
    patch_size: int = 16
    image_size: int = 224
    timm_model_name: str | None = None
    timm_pool: str = "avg"
    timm_proj: str = "linear"
    quick_gelu: bool = False


def _conv(c_in: int, c_out: int, k: int, gen: torch.Generator, stride: int = 1,
          padding: int | None = None) -> nn.Conv2d:
    """A bias-free conv, by default with ``(k-1)//2`` symmetric padding (the
    JAX package's explicit padding), U(+-sqrt(1/fan_in)) like torch's
    default init."""
    conv = nn.Conv2d(c_in, c_out, k, stride=stride,
                     padding=(k - 1) // 2 if padding is None else padding, bias=False)
    bound = math.sqrt(1.0 / (c_in * k * k))
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=gen)
    return conv


def _linear(d_in: int, d_out: int, gen: torch.Generator, std: float | None = None) -> nn.Linear:
    """``std``: normal weights, zero bias (CLIP's attention-pool init);
    otherwise U(+-sqrt(1/d_in)) for both, torch's default."""
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        if std is None:
            bound = math.sqrt(1.0 / d_in)
            lin.weight.uniform_(-bound, bound, generator=gen)
            lin.bias.uniform_(-bound, bound, generator=gen)
        else:
            lin.weight.normal_(0.0, std, generator=gen)
            lin.bias.zero_()
    return lin


def _normal(shape, std: float, gen: torch.Generator) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).normal_(0.0, std, generator=gen))


# ---------------------------------------------------------------------------
# VisualTransformer (`model.py:305-372`)
# ---------------------------------------------------------------------------


class VisualTransformer(nn.Module):
    """``images [B, 3, H, W]`` (normalized) -> ``[B, output_dim]``; without
    ``output_dim`` (a timm trunk) there is no ``proj``."""

    def __init__(self, cfg: VisionCfg, output_dim: int | None, generator: torch.Generator):
        super().__init__()
        w, p = cfg.width, cfg.patch_size
        grid = cfg.image_size // p
        scale = w**-0.5
        self.cfg = cfg
        self.conv1 = _conv(3, w, p, generator, stride=p, padding=0)
        self.class_embedding = _normal((w,), scale, generator)
        self.positional_embedding = _normal((grid * grid + 1, w), scale, generator)
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(cfg, generator)
        self.ln_post = nn.LayerNorm(w)
        self.proj = _normal((w, output_dim), scale, generator) if output_dim else None

    def tokens(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, 1 + grid^2, width]`` after the blocks, before ``ln_post``."""
        x = self.conv1(images).flatten(2).transpose(1, 2)  # [B, grid^2, w], row-major patches
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = layer_norm(x, self.ln_pre.weight, self.ln_pre.bias)
        return resblocks_apply(self.transformer, x, max(self.cfg.width // 64, 1),
                               self.cfg.quick_gelu)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.tokens(images)[:, 0]
        return layer_norm(x, self.ln_post.weight, self.ln_post.bias) @ self.proj


# ---------------------------------------------------------------------------
# ModifiedResNet (`model.py:47-241`)
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (`model.py:47-103`)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, gen: torch.Generator):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1, self.bn1 = _conv(inplanes, planes, 1, gen), EvalBatchNorm(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, gen), EvalBatchNorm(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1, gen), EvalBatchNorm(out)
        with torch.no_grad():
            self.bn3.weight.zero_()  # `model.py:209-212`
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)), ("0", _conv(inplanes, out, 1, gen)),
                ("1", EvalBatchNorm(out))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out))
        idn = x if self.downsample is None else self.downsample(x)
        return F.relu(out + idn)


class AttentionPool2d(nn.Module):
    """QKV attention pool (`model.py:106-150`): ``[B, C, H, W] -> [B, out]``,
    the mean token prepended as the query, softmax in f32."""

    def __init__(self, spacial: int, embed: int, heads: int, out: int, gen: torch.Generator):
        super().__init__()
        std = embed**-0.5
        self.heads = heads
        self.positional_embedding = _normal((spacial * spacial + 1, embed), std, gen)
        self.q_proj = _linear(embed, embed, gen, std)
        self.k_proj = _linear(embed, embed, gen, std)
        self.v_proj = _linear(embed, embed, gen, std)
        self.c_proj = _linear(embed, out, gen, std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        t = x.flatten(2).transpose(1, 2)  # [B, HW, C], row-major as JAX's NHWC reshape
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1) + self.positional_embedding
        nh, hd = self.heads, c // self.heads

        def heads(y):
            return y.reshape(b, -1, nh, hd).transpose(1, 2)

        q = heads(self.q_proj(t[:, :1])) / math.sqrt(hd)
        k, v = heads(self.k_proj(t)), heads(self.v_proj(t))
        p = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(v.dtype)
        return self.c_proj((p @ v).transpose(1, 2).reshape(b, c))


class ModifiedResNet(nn.Module):
    """``images [B, 3, H, W] -> [B, output_dim]`` (`model.py:153-241`);
    without ``output_dim`` (a timm trunk) no ``attnpool``, and
    :meth:`feature_map` is the output."""

    def __init__(self, cfg: VisionCfg, output_dim: int | None, generator: torch.Generator):
        super().__init__()
        w, gen = cfg.width, generator
        self.cfg = cfg
        self.conv1, self.bn1 = _conv(3, w // 2, 3, gen, stride=2), EvalBatchNorm(w // 2)
        self.conv2, self.bn2 = _conv(w // 2, w // 2, 3, gen), EvalBatchNorm(w // 2)
        self.conv3, self.bn3 = _conv(w // 2, w, 3, gen), EvalBatchNorm(w)
        inplanes = w
        for i, (blocks, planes) in enumerate(zip(cfg.layers, (w, 2 * w, 4 * w, 8 * w))):
            stage = []
            for j in range(blocks):
                stage.append(Bottleneck(inplanes, planes, 2 if i > 0 and j == 0 else 1, gen))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))
        self.attnpool = (AttentionPool2d(cfg.image_size // 32, 32 * w, 32 * w // 64, output_dim,
                                         gen) if output_dim else None)

    def feature_map(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, 32 width, H/32, W/32]``."""
        x = F.relu(self.bn1(self.conv1(images)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for i in range(len(self.cfg.layers)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.attnpool(self.feature_map(images))


# ---------------------------------------------------------------------------
# the timm adapter's stand-in (`timm_model.py:20-106`)
# ---------------------------------------------------------------------------

# name -> (cfg overrides, kind, num_features): the JAX package's registry
_TRUNKS: dict[str, tuple[dict, str, int]] = {
    "vit_base_patch16_224": ({"layers": 12, "width": 768, "patch_size": 16}, "vit", 768),
    "vit_base_patch32_224": ({"layers": 12, "width": 768, "patch_size": 32}, "vit", 768),
    "vit_large_patch14_224": ({"layers": 24, "width": 1024, "patch_size": 14}, "vit", 1024),
    "resnet50": ({"layers": (3, 4, 6, 3), "width": 64}, "resnet", 2048),
}


class _Mlp(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, d_out: int, gen: torch.Generator):
        super().__init__()
        self.fc1, self.fc2 = _linear(d_in, d_hidden, gen), _linear(d_hidden, d_out, gen)


def trunk_spec(cfg: VisionCfg) -> tuple[VisionCfg, str, int]:
    """``(trunk config, "vit" | "resnet", num_features)`` of a timm config,
    with the JAX package's checks in its order."""
    name = cfg.timm_model_name
    if name not in _TRUNKS:
        raise RuntimeError(
            f"unknown vision trunk {name!r}: the port replaces timm with a trunk registry "
            f"({sorted(_TRUNKS)}); add the trunk there (reference raises when timm is "
            "missing, timm_model.py:35-36)")
    overrides, kind, num_features = _TRUNKS[name]
    pool, proj = cfg.timm_pool, cfg.timm_proj
    if pool == "rot_attn":
        raise NotImplementedError("rot_attn (timm rotary attention pool) is not carried to the "
                                  "TPU build; use 'abs_attn' or 'avg' (timm_model.py:56-57)")
    if pool == "abs_attn" and kind != "resnet":
        raise ValueError("abs_attn needs a 2d feature map trunk (timm_model.py:42-43)")
    if pool not in ("abs_attn", "avg", ""):
        raise ValueError(f"unknown timm_pool {pool!r}")
    if pool != "abs_attn" and proj not in ("linear", "mlp"):
        raise ValueError("projection layer needed if non-attention pooling is used")
    return VisionCfg(image_size=cfg.image_size, **overrides), kind, num_features


class TimmModel(nn.Module):
    """``trunk`` (a CLIP tower without its head) -> the adapter's pool
    (``avg``: the mean of the patch tokens or of the feature map; ``''``:
    the class token, or the feature map's mean; ``abs_attn``: ``head.pool``)
    -> its projection (``head.proj``; ``head.mlp``: fc1 -> GELU -> fc2 at
    twice ``embed_dim``; none after ``abs_attn`` with ``timm_proj=''``).
    The reference builds the projection after ``abs_attn`` too when
    ``timm_proj`` is set (`timm_model.py:62-67`), and so does this."""

    def __init__(self, embed_dim: int, cfg: VisionCfg, generator: torch.Generator):
        super().__init__()
        trunk_cfg, self.kind, num_features = trunk_spec(cfg)
        self.cfg, self.trunk_cfg = cfg, trunk_cfg
        self.trunk = (VisualTransformer if self.kind == "vit" else ModifiedResNet)(
            trunk_cfg, None, generator)
        head, prev = nn.Module(), num_features
        if cfg.timm_pool == "abs_attn":
            feat = 32 * trunk_cfg.width
            head.pool = AttentionPool2d(cfg.image_size // 32, feat, feat // 64, embed_dim,
                                        generator)
            prev = embed_dim
        if cfg.timm_proj == "linear":
            head.proj = _linear(prev, embed_dim, generator)
        elif cfg.timm_proj == "mlp":
            head.mlp = _Mlp(prev, 2 * embed_dim, embed_dim, generator)
        self.head = head

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        pool = self.cfg.timm_pool
        if self.kind == "vit":
            x = self.trunk.tokens(images)
            x = layer_norm(x, self.trunk.ln_post.weight, self.trunk.ln_post.bias)
            feats = x[:, 1:].mean(dim=1) if pool == "avg" else x[:, 0]
        else:
            fmap = self.trunk.feature_map(images)
            feats = self.head.pool(fmap) if pool == "abs_attn" else fmap.mean(dim=(2, 3))
        if hasattr(self.head, "proj"):
            return self.head.proj(feats)
        if hasattr(self.head, "mlp"):
            return self.head.mlp.fc2(F.gelu(self.head.mlp.fc1(feats)))
        return feats


def create_vision_tower(embed_dim: int, cfg: VisionCfg,
                        generator: torch.Generator | None = None) -> nn.Module:
    """The tower of ``cfg`` (the reference's dispatch): ``timm_model_name``
    -> :class:`TimmModel`, a tuple ``layers`` -> :class:`ModifiedResNet`, an
    int -> :class:`VisualTransformer`; random from ``generator`` (seed 0
    without one). Call :func:`vision_forward` on it."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    if cfg.timm_model_name:
        return TimmModel(embed_dim, cfg, gen)
    if isinstance(cfg.layers, (tuple, list)):
        return ModifiedResNet(cfg, embed_dim, gen)
    return VisualTransformer(cfg, embed_dim, gen)


def vision_forward(tower: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """``images [B, 3, H, W]`` (normalized, on the tower's device) ->
    ``[B, embed_dim]`` f32: every convolution and product without TF32."""
    with golden_convs():
        return tower(images.float())


# ---------------------------------------------------------------------------
# lock() (`model.py:214-221,339-344`, `timm_model.py:71-101`)
# ---------------------------------------------------------------------------


def vision_freeze_mask(tower: nn.Module, unlocked_groups: int = 0) -> dict[str, bool]:
    """``{parameter name: frozen}``, the JAX package's mask by name: all
    frozen, except with ``unlocked_groups`` the last n transformer blocks
    (with ``ln_post`` and ``proj``) or ResNet stages, and a timm head."""
    trunk = "trunk." if isinstance(tower, TimmModel) else ""
    body = tower.trunk if trunk else tower
    unlocked: list[str] = []
    if unlocked_groups:
        if isinstance(body, VisualTransformer):
            n = len(body.transformer.resblocks)
            unlocked = [f"{trunk}transformer.resblocks.{i}."
                        for i in range(max(n - unlocked_groups, 0), n)]
            unlocked += [f"{trunk}ln_post.", f"{trunk}proj"]
        else:
            n = len(body.cfg.layers)
            unlocked = [f"{trunk}layer{i + 1}." for i in range(max(n - unlocked_groups, 0), n)]
        unlocked.append("head.")
    return {name: not any(name == u or (u.endswith(".") and name.startswith(u))
                          for u in unlocked)
            for name, _ in tower.named_parameters()}


def lock(tower: nn.Module, unlocked_groups: int = 0) -> dict[str, bool]:
    """Freeze ``tower`` by :func:`vision_freeze_mask` (``requires_grad``);
    returns the mask."""
    mask = vision_freeze_mask(tower, unlocked_groups)
    for name, p in tower.named_parameters():
        p.requires_grad_(not mask[name])
    return mask
