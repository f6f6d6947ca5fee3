"""Model registry: ``audio_residual_tpu/models/factory.py``.

The registry scans the JSON model configs under ``configs/model_configs/``
at the root of the checkout (data shared with the JAX package, not one of
its modules) with the same rule and order, so :func:`list_models` and
:func:`get_model_config` give what the JAX registry gives.
:func:`create_model` builds the full CLAP (HTSAT + a text tower) of a
registered config by name, :func:`create_audio_model` its audio side alone
(what the bench path needs: no 125M-parameter text tower), each from a seed
or a reference checkpoint; HTSAT and PANN towers (:func:`create_model` also
with ``enable_fusion`` and a ``fusion_type``). The vision configs are ROADMAP
slice 7.
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path

import torch

from audio_residual_tpu_torch.models.bart import BartConfig
from audio_residual_tpu_torch.models.clap import (CLAP, CLAPAudio, CLAPConfig, build_clap,
                                                  build_clap_audio)
from audio_residual_tpu_torch.models.clip_text import ClipTextConfig
from audio_residual_tpu_torch.models.convert import (DERIVED_KEYS, load_audio_checkpoint,
                                                     load_clap_checkpoint, load_torch_checkpoint)
from audio_residual_tpu_torch.models.htsat import HTSAT_VARIANTS, HTSATConfig
from audio_residual_tpu_torch.models.pann import PANNConfig
from audio_residual_tpu_torch.models.roberta import RobertaConfig

__all__ = ["list_models", "get_model_config", "add_model_config", "create_audio_model",
           "create_model", "load_checkpoint", "load_audio_tower"]

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


def _amodel_to_config(model_cfg: dict, enable_fusion: bool = False,
                      fusion_type: str = "None") -> HTSATConfig | PANNConfig:
    """The audio tower's config of a registered model config (HTSAT or
    PANN, ``factory.py:86-116``)."""
    a = model_cfg["audio_cfg"]
    common = dict(num_classes=a["class_num"], sample_rate=a["sample_rate"],
                  clip_samples=a["clip_samples"], mel_bins=a["mel_bins"], fmin=a["fmin"],
                  fmax=a["fmax"], n_fft=a["window_size"], hop_size=a["hop_size"],
                  enable_fusion=enable_fusion, fusion_type=fusion_type)
    if a["model_type"] == "HTSAT":
        return HTSATConfig(**common, **HTSAT_VARIANTS[a["model_name"]])
    if a["model_type"] == "PANN":
        return PANNConfig(model_name=a["model_name"], **common)
    raise RuntimeError(f"Model config for {a['model_type']} not found")


def _clap_config(model_cfg: dict, enable_fusion: bool, fusion_type: str, **text) -> CLAPConfig:
    return CLAPConfig(embed_dim=model_cfg["embed_dim"],
                      audio=_amodel_to_config(model_cfg, enable_fusion, fusion_type),
                      audio_model_type=model_cfg["audio_cfg"]["model_type"], **text)


def _tmodel_to_config(tmodel_name: str, text_cfg_json: dict, *, quick_gelu: bool = False):
    """The text tower's config (`model.py:494-527`): roberta-base,
    bert-base-uncased, the model config's CLIP transformer, bart-base.
    ``quick_gelu`` reaches the CLIP transformer alone."""
    if tmodel_name == "roberta":
        return RobertaConfig()
    if tmodel_name == "bert":
        return RobertaConfig(vocab_size=30522, max_position_embeddings=512, type_vocab_size=2,
                             pad_token_id=0, style="bert")
    if tmodel_name == "transformer":
        return ClipTextConfig(vocab_size=text_cfg_json["vocab_size"],
                              width=text_cfg_json["width"], heads=text_cfg_json["heads"],
                              layers=text_cfg_json["layers"],
                              context_length=text_cfg_json["context_length"],
                              quick_gelu=quick_gelu)
    if tmodel_name == "bart":
        return BartConfig()
    raise RuntimeError(f"Model config for {tmodel_name} not found.")


def create_model(amodel_name: str, tmodel_name: str = "roberta", pretrained: str = "", *,
                 enable_fusion: bool = False, fusion_type: str = "None", seed: int = 0,
                 device: str | torch.device | None = None, pretrained_audio: str = "",
                 pretrained_text: str = "", force_quick_gelu: bool = False
                 ) -> tuple[CLAP, CLAPConfig, dict]:
    """``(model, cfg, model_cfg)``: the full CLAP of the registered config
    ``amodel_name`` (an HTSAT or a PANN tower; ``enable_fusion`` with a
    ``fusion_type`` for mel fusion) with the text tower ``tmodel_name``
    ("roberta", the published checkpoints' tower; "bert"; "transformer", the
    config's ``text_cfg``; "bart"), in eval mode on ``device`` (the card unless
    ``device="cpu"``), random from ``seed``. ``pretrained``: a reference
    checkpoint, full (:func:`load_checkpoint`) or audio-only;
    ``pretrained_audio``: a tower-only one (:func:`load_audio_tower`).
    ``pretrained_text`` is accepted and ignored with a warning, as the
    reference's factory takes it and never reads it."""
    model_cfg = get_model_config(amodel_name.replace("/", "-"))
    if force_quick_gelu:
        model_cfg = {**model_cfg, "quick_gelu": True}
    if "audio_cfg" not in model_cfg:
        raise NotImplementedError(f"{amodel_name} is a vision config; the CLIP towers are not "
                                  "ported yet (ROADMAP, slice 7)")
    cfg = _clap_config(model_cfg, enable_fusion, fusion_type,
                       text=_tmodel_to_config(tmodel_name, model_cfg["text_cfg"],
                                              quick_gelu=bool(model_cfg.get("quick_gelu", False))),
                       text_model_type=tmodel_name)
    model = build_clap(cfg, seed=seed, device=device)
    if pretrained:
        load_checkpoint(model, pretrained)
    if pretrained_audio:
        load_audio_tower(model, pretrained_audio)
    if pretrained_text:
        logging.warning("pretrained_text is accepted for script compatibility; the "
                        "reference's factory takes it and never reads it. Load full "
                        "checkpoints through pretrained instead.")
    return model, cfg, model_cfg


def load_checkpoint(model: CLAP, path: str) -> CLAP:
    """A reference checkpoint into a full CLAP: a whole one (it has
    ``text_branch.`` keys) through :func:`load_clap_checkpoint`, else the
    audio side (``sed_model.`` read as ``audio_branch.``) over the model as
    built."""
    if any(k.startswith("text_branch.") for k in load_torch_checkpoint(path)):
        return load_clap_checkpoint(model, path)
    return load_audio_checkpoint(model, path)


def load_audio_tower(model: CLAPAudio, path: str) -> CLAPAudio:
    """``pretrained_audio``: an HTSAT tower-only checkpoint, dispatched on its
    file name as the reference does (`factory.py:166-217`): the official
    ``HTSAT_AudioSet_Saved`` or a basename starting with ``HTSAT`` or
    ``finetuned``; ``sed_model.`` keys read as ``audio_branch.``. Only
    ``audio_branch`` is loaded, strictly."""
    base = Path(path).name
    if not ("HTSAT_AudioSet_Saved" in path or base.startswith(("HTSAT", "finetuned"))):
        raise ValueError("Unknown audio checkpoint")
    pre = "audio_branch."
    sd = {k.replace("sed_model.", pre): v for k, v in load_torch_checkpoint(path).items()}
    tower = {k[len(pre):]: v for k, v in sd.items()
             if k.startswith(pre) and not any(p in k for p in DERIVED_KEYS)}
    model.audio_branch.load_state_dict(tower, strict=True)
    return model


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
            f"{name} is a vision config; the CLIP towers are not ported yet (ROADMAP, slice 7)")
    cfg = _clap_config(model_cfg, False, "None")
    model = build_clap_audio(cfg, seed=seed, device=device)
    if pretrained:
        load_audio_checkpoint(model, pretrained)
    return model, cfg, model_cfg
