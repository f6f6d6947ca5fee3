"""The CLIP dual tower of the vision model configs: ``audio_residual_tpu/models/clip.py``.

The reference ships ten CLIP-legacy vision configs (RN50, ViT-B-16, ...)
whose registry filter never admits them (`clap_module/factory.py:41`); the
JAX package builds them, and so does the port: a vision tower from
:mod:`.vision` and the CLIP BPE text tower of :mod:`.clip_text`, in the
OpenAI CLIP layout (``visual.*``, ``token_embedding``,
``positional_embedding``, ``transformer.resblocks.{i}``, ``ln_final``,
``text_projection`` ``[width, embed_dim]``, ``logit_scale``), so a
published CLIP checkpoint's keys are the model's.

Image features are the tower's output, text features the EOT token's
feature times ``text_projection``, both L2-normalised, with
``exp(logit_scale)``. Images are NCHW (the JAX package takes NHWC).
Golden f32 throughout: no TF32 in the convolutions and products.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.models.clip_text import (ClipTextConfig, Transformer,
                                                       add_text_embeddings, clip_text_apply)
from audio_residual_tpu_torch.models.vision import VisionCfg, create_vision_tower, vision_forward
from audio_residual_tpu_torch.ops.common import golden_convs

__all__ = ["CLIPConfig", "CLIP", "build_clip", "clip_encode_image", "clip_encode_text",
           "clip_apply"]


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int
    vision: VisionCfg
    text: ClipTextConfig


class CLIP(nn.Module):
    """Random from ``generator``: the vision tower, the text tower (CLIP
    init), ``text_projection`` (std ``width^-0.5``), ``logit_scale``
    ``log(1/0.07)``."""

    def __init__(self, cfg: CLIPConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.visual = create_vision_tower(cfg.embed_dim, cfg.vision, generator)
        add_text_embeddings(self, cfg.text, generator)
        self.transformer = Transformer(cfg.text, generator)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.text.width, cfg.embed_dim).normal_(0.0, cfg.text.width**-0.5,
                                                               generator=generator))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))


def build_clip(cfg: CLIPConfig, *, seed: int = 0,
               device: str | torch.device | None = None) -> CLIP:
    """Random-init CLIP from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), in eval mode with frozen parameters."""
    dev = resolve_device(device)
    return CLIP(cfg, torch.Generator().manual_seed(seed)).to(dev).eval().requires_grad_(False)


def _l2(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def clip_encode_image(model: CLIP, images, *, normalize: bool = True) -> torch.Tensor:
    """``images [B, 3, H, W]`` (normalized pixels) -> ``[B, embed_dim]``."""
    dev = model.logit_scale.device
    x = vision_forward(model.visual, torch.as_tensor(images, device=dev))
    return _l2(x) if normalize else x


def clip_encode_text(model: CLIP, tokens, *, normalize: bool = True) -> torch.Tensor:
    """``tokens [B, context]`` (the CLIP BPE ids) -> ``[B, embed_dim]``."""
    with golden_convs():
        x = clip_text_apply(model.transformer, model, tokens, model.cfg.text) @ \
            model.text_projection
    return _l2(x) if normalize else x


def clip_apply(model: CLIP, images, tokens) -> tuple:
    """``(image_features, text_features, logit_scale)``: normalized features
    and ``exp(logit_scale)``, open_clip's forward contract."""
    return (clip_encode_image(model, images), clip_encode_text(model, tokens),
            model.logit_scale.exp())
