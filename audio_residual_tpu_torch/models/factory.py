"""Model registry: ``audio_residual_tpu/models/factory.py``.

The registry scans the JSON model configs under ``configs/model_configs/``
at the root of the checkout (data shared with the JAX package, not one of
its modules) with the same rule and order, so :func:`list_models` and
:func:`get_model_config` give what the JAX registry gives.
:func:`create_model` builds the full CLAP (HTSAT + a text tower) of a
registered config by name, :func:`create_audio_model` its audio side alone
(what the bench path needs: no 125M-parameter text tower), each from a seed
or a reference checkpoint; HTSAT and PANN towers (:func:`create_model` also
with ``enable_fusion`` and a ``fusion_type``). A vision config (RN50,
ViT-B-16, ...) builds the CLIP dual tower of :mod:`.clip` through
:func:`create_model` with ``tmodel_name="transformer"``, as in the JAX
package (the reference's registry never admits them, `factory.py:41`).
:func:`convert_weights_to_bf16` returns a bf16 copy of a state dict; the
port's AMP does not cast the model (its kernels keep bf16 copies a weight
version), so nothing here calls it.
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
from audio_residual_tpu_torch.models.clip import CLIP, CLIPConfig, build_clip
from audio_residual_tpu_torch.models.clip_text import ClipTextConfig
from audio_residual_tpu_torch.models.convert import (DERIVED_KEYS, load_audio_checkpoint,
                                                     load_clap_checkpoint, load_torch_checkpoint)
from audio_residual_tpu_torch.models.htsat import HTSAT_VARIANTS, HTSATConfig
from audio_residual_tpu_torch.models.pann import PANNConfig
from audio_residual_tpu_torch.models.roberta import RobertaConfig
from audio_residual_tpu_torch.models.vision import VisionCfg

__all__ = ["list_models", "get_model_config", "add_model_config", "create_audio_model",
           "create_model", "create_model_and_transforms", "load_checkpoint", "load_audio_tower",
           "convert_weights_to_bf16"]

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
                 ) -> tuple[CLAP | CLIP, CLAPConfig | CLIPConfig, dict]:
    """``(model, cfg, model_cfg)``: the full CLAP of the registered config
    ``amodel_name`` (an HTSAT or a PANN tower; ``enable_fusion`` with a
    ``fusion_type`` for mel fusion) with the text tower ``tmodel_name``
    ("roberta", the published checkpoints' tower; "bert"; "transformer", the
    config's ``text_cfg``; "bart"), in eval mode on ``device`` (the card unless
    ``device="cpu"``), random from ``seed``. ``pretrained``: a reference
    checkpoint, full (:func:`load_checkpoint`) or audio-only;
    ``pretrained_audio``: a tower-only one (:func:`load_audio_tower`).
    ``pretrained_text`` is accepted and ignored with a warning, as the
    reference's factory takes it and never reads it. A vision config builds
    a :class:`~audio_residual_tpu_torch.models.clip.CLIP` (``tmodel_name``
    must be "transformer"; the checkpoint arguments are not read, as in the
    JAX package). ``force_quick_gelu`` sets the config's ``quick_gelu``,
    which the CLIP towers read."""
    model_cfg = get_model_config(amodel_name.replace("/", "-"))
    if force_quick_gelu:
        model_cfg = {**model_cfg, "quick_gelu": True}
    if "audio_cfg" not in model_cfg:
        return _create_clip_model(model_cfg, tmodel_name, seed=seed, device=device)
    cfg = _clap_config(model_cfg, enable_fusion, fusion_type,
                       text=_tmodel_to_config(tmodel_name, model_cfg["text_cfg"],
                                              quick_gelu=bool(model_cfg.get("quick_gelu", False))),
                       text_model_type=tmodel_name)
    model = build_clap(cfg, seed=seed, device=device)
    if pretrained:
        load_checkpoint(model, pretrained)
    if pretrained_audio:
        load_audio_tower(model, pretrained_audio, amodel_name.replace("/", "-"))
    if pretrained_text:
        logging.warning("pretrained_text is accepted for script compatibility; the "
                        "reference's factory takes it and never reads it. Load full "
                        "checkpoints through pretrained instead.")
    return model, cfg, model_cfg


def clip_config(model_cfg: dict) -> CLIPConfig:
    """The CLIP config of a vision model config (``factory.py:224-258`` of
    the JAX package): the ``vision_cfg`` tower (a null ``patch_size`` is 16)
    and the ``text_cfg`` CLIP text tower, both with the config's
    ``quick_gelu``."""
    v, t = model_cfg["vision_cfg"], model_cfg["text_cfg"]
    quick = bool(model_cfg.get("quick_gelu", False))
    layers = tuple(v["layers"]) if isinstance(v["layers"], list) else v["layers"]
    vision = VisionCfg(layers=layers, width=v["width"], patch_size=v["patch_size"] or 16,
                       image_size=v["image_size"], quick_gelu=quick)
    text = ClipTextConfig(vocab_size=t["vocab_size"], width=t["width"], heads=t["heads"],
                          layers=t["layers"], context_length=t["context_length"],
                          quick_gelu=quick)
    return CLIPConfig(embed_dim=model_cfg["embed_dim"], vision=vision, text=text)


def _create_clip_model(model_cfg: dict, tmodel_name: str, *, seed: int = 0,
                       device: str | torch.device | None = None
                       ) -> tuple[CLIP, CLIPConfig, dict]:
    if tmodel_name != "transformer":
        raise RuntimeError(f"vision model configs pair with the CLIP text tower "
                           f'(tmodel_name="transformer"), got {tmodel_name!r}')
    cfg = clip_config(model_cfg)
    return build_clip(cfg, seed=seed, device=device), cfg, model_cfg


def create_model_and_transforms(*args, **kwargs) -> tuple:
    """``(model, cfg, model_cfg, preprocess)``: :func:`create_model`, and
    for a vision config its eval image transform
    (``data/transforms.py::image_transform``), for an audio config the
    featurization of a ``[B, T]`` batch of waveforms onto the model's device
    (``data/featurize.py::featurize_batch`` at the config's clip length)
    (`factory.py:230-240`)."""
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.data.transforms import image_transform

    model, cfg, model_cfg = create_model(*args, **kwargs)
    if "audio_cfg" not in model_cfg:
        return model, cfg, model_cfg, image_transform(model_cfg["vision_cfg"]["image_size"],
                                                      is_train=False)
    clip_samples, dev = model_cfg["audio_cfg"]["clip_samples"], next(model.parameters()).device

    def preprocess(wav) -> dict:
        return featurize_batch(torch.as_tensor(wav, dtype=torch.float32, device=dev),
                               clip_samples)

    return model, cfg, model_cfg, preprocess


def convert_weights_to_bf16(state_dict: dict) -> dict:
    """A copy of ``state_dict`` with every floating-point tensor of two or
    more dimensions in bfloat16 and the rest (biases, norms, buffers) as
    they are: the JAX package's ``convert_weights_to_bf16``
    (``factory.py:338``, the reference's fp16 cast, `model.py:826-848`).
    The model it came from is untouched."""
    return {k: (v.detach().to(torch.bfloat16) if v.is_floating_point() and v.ndim >= 2
                else v.detach().clone()) for k, v in state_dict.items()}


def load_checkpoint(model: CLAP, path: str) -> CLAP:
    """A reference checkpoint into a full CLAP: a whole one (it has
    ``text_branch.`` keys) through :func:`load_clap_checkpoint`, else the
    audio side (``sed_model.`` read as ``audio_branch.``) over the model as
    built."""
    if any(k.startswith("text_branch.") for k in load_torch_checkpoint(path)):
        return load_clap_checkpoint(model, path)
    return load_audio_checkpoint(model, path)


def load_audio_tower(model: CLAPAudio, path: str, amodel_name: str | None = None) -> CLAPAudio:
    """``pretrained_audio``: a tower-only checkpoint, dispatched on the
    model's name (``amodel_name``; the tower's type when not given) and the
    file's name as the reference does (`factory.py:166-217`):

    * PANN: ``Cnn14_mAP`` in the path (the official file, weights under
      ``model``), or a basename starting with ``PANN`` or ``finetuned``
      (``sed_model.`` keys read as ``audio_branch.``);
    * HTSAT: the official ``HTSAT_AudioSet_Saved``, or a basename starting
      with ``HTSAT`` or ``finetuned`` (``sed_model.`` read the same way);
    * any other file raises ``ValueError("Unknown audio checkpoint")``, any
      other model the JAX package's message.

    Only ``audio_branch`` is loaded, strictly; derived buffers (the DSP
    extractors, BatchNorm's step count, the Swin index and masks) are
    skipped."""
    amodel = amodel_name or model.cfg.audio_model_type
    base = Path(path).name
    pre = "audio_branch."
    if amodel.startswith("PANN"):
        if "Cnn14_mAP" in path:
            sd = {pre + k: v for k, v in
                  torch.load(path, map_location="cpu", weights_only=True)["model"].items()}
        elif base.startswith(("PANN", "finetuned")):
            sd = {k.replace("sed_model.", pre): v for k, v in load_torch_checkpoint(path).items()}
        else:
            raise ValueError("Unknown audio checkpoint")
    elif amodel.startswith("HTSAT"):
        if not ("HTSAT_AudioSet_Saved" in path or base.startswith(("HTSAT", "finetuned"))):
            raise ValueError("Unknown audio checkpoint")
        sd = {k.replace("sed_model.", pre): v for k, v in load_torch_checkpoint(path).items()}
    else:
        raise ValueError("this audio encoder pretrained checkpoint is not support")
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
        raise ValueError(f"{name} is a vision config: it has no audio tower; build its CLIP "
                         "with create_model(name, 'transformer')")
    cfg = _clap_config(model_cfg, False, "None")
    model = build_clap_audio(cfg, seed=seed, device=device)
    if pretrained:
        load_audio_checkpoint(model, pretrained)
    return model, cfg, model_cfg
