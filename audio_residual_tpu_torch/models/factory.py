"""Model registry: the audio half of ``audio_residual_tpu/models/factory.py``.

The registry scans the JSON model configs under ``configs/model_configs/``
at the root of the checkout (data shared with the JAX package, not one of
its modules) with the same rule and order, so :func:`list_models` and
:func:`get_model_config` give what the JAX registry gives.
:func:`create_audio_model` builds the CLAP audio side (HTSAT + projection)
of a registered config by name, from a seed or a reference checkpoint. PANN
towers, fusion and the vision configs are ROADMAP slice 6.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import torch

from audio_residual_tpu_torch.models.clap import CLAPAudio, CLAPConfig, build_clap_audio
from audio_residual_tpu_torch.models.convert import load_audio_checkpoint
from audio_residual_tpu_torch.models.htsat import HTSAT_VARIANTS, HTSATConfig

__all__ = ["list_models", "get_model_config", "add_model_config", "create_audio_model"]

_CONFIG_DIRS = [Path(__file__).resolve().parents[2] / "configs" / "model_configs"]
_MODEL_CONFIGS: dict[str, dict] = {}


def _natural_key(s):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def _rescan() -> None:
    """(Re)scan the config dirs: a config registers when it has
    ``embed_dim``, ``text_cfg`` and an audio or a vision tower."""
    _MODEL_CONFIGS.clear()
    for d in _CONFIG_DIRS:
        if not d.is_dir():
            continue
        for f in d.glob("*.json"):
            with open(f) as fh:
                cfg = json.load(fh)
            if "embed_dim" in cfg and "text_cfg" in cfg and (
                "audio_cfg" in cfg or "vision_cfg" in cfg
            ):
                _MODEL_CONFIGS[f.stem] = cfg
    for k in sorted(_MODEL_CONFIGS, key=_natural_key):
        _MODEL_CONFIGS[k] = _MODEL_CONFIGS.pop(k)


def list_models() -> list[str]:
    if not _MODEL_CONFIGS:
        _rescan()
    return list(_MODEL_CONFIGS)


def get_model_config(name: str) -> dict:
    """A deep copy of the registered config ``name``."""
    if not _MODEL_CONFIGS:
        _rescan()
    if name not in _MODEL_CONFIGS:
        raise RuntimeError(f"Model config for {name} not found; available: {list_models()}")
    return json.loads(json.dumps(_MODEL_CONFIGS[name]))


def add_model_config(path: str) -> None:
    """Register an extra config file, or every config in a directory."""
    p = Path(path)
    _CONFIG_DIRS.append(p if p.is_dir() else p.parent)
    _rescan()


def _amodel_to_config(model_cfg: dict, enable_fusion: bool = False) -> HTSATConfig:
    """The audio tower's config of a registered model config (HTSAT,
    non-fusion)."""
    a = model_cfg["audio_cfg"]
    if a["model_type"] != "HTSAT":
        raise NotImplementedError(
            f"{a['model_type']} audio towers are not ported yet (ROADMAP, slice 6)")
    if enable_fusion:
        raise NotImplementedError("fusion is not ported yet (ROADMAP, slice 6)")
    return HTSATConfig(
        num_classes=a["class_num"],
        sample_rate=a["sample_rate"],
        clip_samples=a["clip_samples"],
        mel_bins=a["mel_bins"],
        fmin=a["fmin"],
        fmax=a["fmax"],
        n_fft=a["window_size"],
        hop_size=a["hop_size"],
        **HTSAT_VARIANTS[a["model_name"]],
    )


def create_audio_model(name: str, pretrained: str = "", *, seed: int = 0,
                       device: str | torch.device | None = None
                       ) -> tuple[CLAPAudio, CLAPConfig, dict]:
    """``(model, cfg, model_cfg)`` for the registered config ``name`` (``/``
    may stand for ``-``): the audio side in eval mode on ``device`` (the card
    unless ``device="cpu"``), random from ``seed``, then loaded from the
    reference checkpoint ``pretrained`` when one is given.
    ``cfg.embed_dim`` is the config's ``embed_dim``, the tower's output width."""
    model_cfg = get_model_config(name.replace("/", "-"))
    if "audio_cfg" not in model_cfg:
        raise NotImplementedError(
            f"{name} is a vision config; the CLIP towers are not ported yet (ROADMAP, slice 6)")
    cfg = CLAPConfig(embed_dim=model_cfg["embed_dim"], audio=_amodel_to_config(model_cfg))
    model = build_clap_audio(cfg, seed=seed, device=device)
    if pretrained:
        load_audio_checkpoint(model, pretrained)
    return model, cfg, model_cfg
