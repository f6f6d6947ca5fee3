"""OpenAI CLIP checkpoint text-tower loader.

Port of ``audio_residual_tpu/models/openai.py``: CLAP with
``tmodel="transformer"`` can reuse the text transformer of an OpenAI CLIP
checkpoint (`clap_module/openai.py:23-129`,
``build_model_from_openai_state_dict``, `model.py:851-893`). The text
tensors of such a state dict load into :class:`ClipText` as they are; the
vision tower is out of scope.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.models.clip_text import ClipText, ClipTextConfig

__all__ = ["list_openai_models", "text_config_from_state_dict", "load_openai_text_tower"]

# public OpenAI CLIP model names whose text towers are CLAP-compatible
OPENAI_MODELS = ["RN50", "RN101", "RN50x4", "RN50x16", "ViT-B-32", "ViT-B-16", "ViT-L-14"]


def list_openai_models() -> list[str]:
    return list(OPENAI_MODELS)


def text_config_from_state_dict(sd: Mapping) -> ClipTextConfig:
    """The text tower's architecture (`model.py:858-871`): widths from the
    embeddings, the layer count from ``transformer.resblocks.*``, 64-wide
    heads, QuickGELU (OpenAI checkpoints use it)."""
    vocab_size, width = tuple(sd["token_embedding.weight"].shape)
    context_length = tuple(sd["positional_embedding"].shape)[0]
    layers = len({m.group(1) for k in sd
                  if (m := re.match(r"transformer\.resblocks\.(\d+)\.", k))})
    return ClipTextConfig(vocab_size=vocab_size, width=width, heads=width // 64, layers=layers,
                          context_length=context_length, quick_gelu=True)


def load_openai_text_tower(sd: Mapping, *, device: str | torch.device | None = None
                           ) -> tuple[ClipText, ClipTextConfig]:
    """An OpenAI CLIP state dict (numpy arrays or tensors) -> ``(ClipText,
    config)`` on ``device`` (the card unless ``device="cpu"``), in eval mode
    with frozen parameters. Keys outside the text tower are ignored; every
    key of the tower must be there."""
    dev = resolve_device(device)
    cfg = text_config_from_state_dict(sd)
    model = ClipText(cfg)
    want = model.state_dict()
    text = {k: torch.from_numpy(np.array(sd[k], dtype=np.float32)) for k in want if k in sd}
    model.load_state_dict(text, strict=True)
    return model.to(dev).eval().requires_grad_(False), cfg
