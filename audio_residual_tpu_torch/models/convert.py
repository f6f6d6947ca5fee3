"""Weights into the port's modules: reference checkpoints and the JAX bridge.

:func:`load_audio_checkpoint` loads the audio side of a reference torch
checkpoint, :func:`load_clap_checkpoint` a whole one (the port's modules use
its ``state_dict`` layout).

:func:`load_jax_params` is the counterpart of
``audio_residual_tpu/models/convert.py::clap_params_to_state_dict``, kept
here so the port imports nothing of the JAX package, and extended to every
text tower: the JAX package has the roberta/bert mapping one way each
(``convert_roberta_state_dict`` and its inverse
``roberta_params_to_state_dict``), and bart and the CLIP transformer only
from a checkpoint (``convert_bart_state_dict``,
``models/openai.py::convert_openai_text_tower``); :func:`bart_state_dict`
and :func:`clip_text_state_dict` are their inverses; and to the CLIP
models of the vision configs (:func:`vision_state_dict`,
:func:`clip_state_dict`: the JAX suite's own mapping to open_clip's names,
``tests/test_vision.py``). Input is a JAX param pytree as nested
dicts/lists of numpy arrays. Linear kernels ``[in,
out]`` are transposed to ``[out, in]``; HWIO convolution kernels become
OIHW.

The audio side also carries what neither JAX exporter maps: the PANN towers
(the inverse of ``convert_pann_state_dict``: ``conv_block{i}.conv{1,2}``,
``bn{1,2}``, ``bn0``, ``fc1``, ``fc_audioset``) and the mel-fusion
parameters of both towers. The fusion keys follow the reference modules
that the JAX package's fusion code cites (``feature_fusion.py``, the fusion
branches of ``htsat.py`` and ``pann_model.py``); no reference checkpoint of
a fusion model is in the repository, so this naming is the reference code's
as those comments describe it, not checked against a published file:
``mel_conv1d.{0,1}`` (Conv1d, BatchNorm1d) at the tower's root;
HTSAT's ``patch_embed.mel_conv2d`` (a Conv2d) and
``patch_embed.fusion_model``; PANN's ``mel_conv2d.{0,1}`` (Conv2d,
BatchNorm2d; the ReLU at 2) and ``fusion_model`` at the root; in a fusion
model ``local_att{,2}.{0,1,3,4}`` and ``global_att{,2}.{1,2,4,5}`` (conv,
BN, ReLU, conv, BN, behind the global branch's pooling layer at 0).
"""

from __future__ import annotations

import numpy as np
import torch

from audio_residual_tpu_torch.models.clap import CLAP
from audio_residual_tpu_torch.models.clip import CLIP, CLIPConfig
from audio_residual_tpu_torch.models.vision import VisionCfg, trunk_spec

__all__ = ["clap_audio_state_dict", "pann_state_dict", "roberta_state_dict", "bart_state_dict",
           "clip_text_state_dict", "clap_state_dict", "vision_state_dict", "clip_state_dict",
           "load_jax_params", "load_torch_checkpoint", "load_audio_checkpoint",
           "load_clap_checkpoint"]

# keys of a reference checkpoint that the audio side does not load: the text
# side (a CLIP tower's embeddings and ln_final sit on the root), the
# training-only transform heads, and buffers the port derives (DSP
# extractors, BatchNorm's step count, the Swin relative-position index and
# shift masks)
_NOT_AUDIO = ("text_branch.", "text_projection.", "logit_scale", "audio_transform.",
              "text_transform.", "token_embedding.", "positional_embedding", "ln_final.")
DERIVED_KEYS = ("position_ids", "spectrogram_extractor.", "logmel_extractor.",
                "num_batches_tracked", "relative_position_index", "attn_mask")


def _lin(sd: dict, dst: str, p: dict) -> None:
    sd[dst + ".weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[dst + ".bias"] = np.asarray(p["bias"])


def _ln(sd: dict, dst: str, p: dict) -> None:
    sd[dst + ".weight"] = np.asarray(p["scale"])
    sd[dst + ".bias"] = np.asarray(p["bias"])


def _conv(x) -> np.ndarray:  # HWIO -> OIHW
    return np.transpose(np.asarray(x), (3, 2, 0, 1))


def _bn(sd: dict, dst: str, p: dict) -> None:
    sd[dst + ".weight"] = np.asarray(p["scale"])
    sd[dst + ".bias"] = np.asarray(p["bias"])
    sd[dst + ".running_mean"] = np.asarray(p["mean"])
    sd[dst + ".running_var"] = np.asarray(p["var"])


def _conv1d(x) -> np.ndarray:  # WIO -> OIW
    return np.transpose(np.asarray(x), (2, 1, 0))


def _fusion(sd: dict, dst: str, p: dict) -> None:
    """An AFF / iAFF param tree -> ``{dst}.local_att.0`` ... keys."""
    for name, branch in p.items():
        first = 1 if name.startswith("global") else 0
        for k, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
            kernel = np.asarray(branch[conv]["kernel"])
            i = first + 3 * k
            sd[f"{dst}.{name}.{i}.weight"] = (_conv(kernel) if kernel.ndim == 4
                                              else _conv1d(kernel))
            sd[f"{dst}.{name}.{i}.bias"] = np.asarray(branch[conv]["bias"])
            _bn(sd, f"{dst}.{name}.{i + 1}", branch[bn])


def _mel_conv1d(sd: dict, pre: str, hp: dict) -> None:
    if "mel_conv1d" in hp:
        sd[pre + "mel_conv1d.0.weight"] = _conv1d(hp["mel_conv1d"]["conv"]["kernel"])
        sd[pre + "mel_conv1d.0.bias"] = np.asarray(hp["mel_conv1d"]["conv"]["bias"])
        _bn(sd, pre + "mel_conv1d.1", hp["mel_conv1d"]["bn"])


def pann_state_dict(hp: dict, pre: str = "audio_branch.") -> dict[str, np.ndarray]:
    """A JAX PANN pytree -> reference names (the inverse of the JAX
    package's ``convert_pann_state_dict``, with the fusion keys)."""
    sd: dict = {}
    _bn(sd, pre + "bn0", hp["bn0"])
    for i, blk in enumerate(hp["conv_blocks"]):
        b = f"{pre}conv_block{i + 1}."
        for k in (1, 2):
            if f"conv{k}" in blk:
                sd[f"{b}conv{k}.weight"] = _conv(blk[f"conv{k}"]["kernel"])
                _bn(sd, f"{b}bn{k}", blk[f"bn{k}"])
    _lin(sd, pre + "fc1", hp["fc1"])
    _lin(sd, pre + "fc_audioset", hp["fc_audioset"])
    _mel_conv1d(sd, pre, hp)
    if "mel_conv2d" in hp:
        sd[pre + "mel_conv2d.0.weight"] = _conv(hp["mel_conv2d"]["conv"]["kernel"])
        sd[pre + "mel_conv2d.0.bias"] = np.asarray(hp["mel_conv2d"]["conv"]["bias"])
        _bn(sd, pre + "mel_conv2d.1", hp["mel_conv2d"]["bn"])
    if "fusion_model" in hp:
        _fusion(sd, pre + "fusion_model", hp["fusion_model"])
    return sd


def clap_audio_state_dict(params: dict) -> dict[str, np.ndarray]:
    """Reference state-dict names -> numpy arrays, audio side only (HTSAT or
    PANN, with their fusion parameters)."""
    hp, pre = params["audio_branch"], "audio_branch."
    if "conv_blocks" in hp:
        sd = pann_state_dict(hp, pre)
        _lin(sd, "audio_projection.0", params["audio_projection"]["fc1"])
        _lin(sd, "audio_projection.2", params["audio_projection"]["fc2"])
        return sd
    sd: dict = {
        pre + "bn0.weight": np.asarray(hp["bn0"]["scale"]),
        pre + "bn0.bias": np.asarray(hp["bn0"]["bias"]),
        pre + "bn0.running_mean": np.asarray(hp["bn0"]["mean"]),
        pre + "bn0.running_var": np.asarray(hp["bn0"]["var"]),
        pre + "patch_embed.proj.weight": _conv(hp["patch_embed"]["proj"]["kernel"]),
        pre + "patch_embed.proj.bias": np.asarray(hp["patch_embed"]["proj"]["bias"]),
        pre + "tscam_conv.weight": _conv(hp["tscam_conv"]["kernel"]),
        pre + "tscam_conv.bias": np.asarray(hp["tscam_conv"]["bias"]),
    }
    if hp["patch_embed"].get("norm") is not None:
        _ln(sd, pre + "patch_embed.norm", hp["patch_embed"]["norm"])
    if "mel_conv2d" in hp["patch_embed"]:
        sd[pre + "patch_embed.mel_conv2d.weight"] = _conv(
            hp["patch_embed"]["mel_conv2d"]["kernel"])
        sd[pre + "patch_embed.mel_conv2d.bias"] = np.asarray(
            hp["patch_embed"]["mel_conv2d"]["bias"])
    if "fusion_model" in hp["patch_embed"]:
        _fusion(sd, pre + "patch_embed.fusion_model", hp["patch_embed"]["fusion_model"])
    _mel_conv1d(sd, pre, hp)
    if "fusion_model" in hp:
        _fusion(sd, pre + "fusion_model", hp["fusion_model"])
    for i, layer in enumerate(hp["layers"]):
        for j, blk in enumerate(layer["blocks"]):
            bp = f"{pre}layers.{i}.blocks.{j}."
            _ln(sd, bp + "norm1", blk["norm1"])
            _lin(sd, bp + "attn.qkv", blk["attn"]["qkv"])
            _lin(sd, bp + "attn.proj", blk["attn"]["proj"])
            sd[bp + "attn.relative_position_bias_table"] = np.asarray(blk["attn"]["rel_bias_table"])
            _ln(sd, bp + "norm2", blk["norm2"])
            _lin(sd, bp + "mlp.fc1", blk["mlp"]["fc1"])
            _lin(sd, bp + "mlp.fc2", blk["mlp"]["fc2"])
        if "downsample" in layer:
            dp = f"{pre}layers.{i}.downsample."
            _ln(sd, dp + "norm", layer["downsample"]["norm"])
            _lin(sd, dp + "reduction", layer["downsample"]["reduction"])
    _ln(sd, pre + "norm", hp["norm"])
    _lin(sd, pre + "head", hp["head"])
    _lin(sd, "audio_projection.0", params["audio_projection"]["fc1"])
    _lin(sd, "audio_projection.2", params["audio_projection"]["fc2"])
    return sd


def roberta_state_dict(params: dict, prefix: str = "text_branch.") -> dict[str, np.ndarray]:
    """A JAX roberta/bert pytree -> HF names (the JAX package's
    ``roberta_params_to_state_dict``)."""
    sd: dict = {}
    emb = params["embeddings"]
    sd[prefix + "embeddings.word_embeddings.weight"] = np.asarray(emb["word"])
    sd[prefix + "embeddings.position_embeddings.weight"] = np.asarray(emb["position"])
    sd[prefix + "embeddings.token_type_embeddings.weight"] = np.asarray(emb["token_type"])
    _ln(sd, prefix + "embeddings.LayerNorm", emb["ln"])
    for i, lp in enumerate(params["layers"]):
        b = f"{prefix}encoder.layer.{i}."
        for name, key in (("attention.self.query", "q"), ("attention.self.key", "k"),
                          ("attention.self.value", "v"), ("attention.output.dense", "out")):
            _lin(sd, b + name, lp["attn"][key])
        _ln(sd, b + "attention.output.LayerNorm", lp["ln1"])
        _lin(sd, b + "intermediate.dense", lp["mlp"]["fc1"])
        _lin(sd, b + "output.dense", lp["mlp"]["fc2"])
        _ln(sd, b + "output.LayerNorm", lp["ln2"])
    _lin(sd, prefix + "pooler.dense", params["pooler"])
    return sd


def bart_state_dict(params: dict, prefix: str = "text_branch.") -> dict[str, np.ndarray]:
    """A JAX bart pytree -> HF ``BartModel`` encoder names (the inverse of
    the JAX package's ``convert_bart_state_dict``)."""
    e = prefix + "encoder."
    sd: dict = {e + "embed_tokens.weight": np.asarray(params["embed_tokens"]),
                e + "embed_positions.weight": np.asarray(params["embed_positions"])}
    _ln(sd, e + "layernorm_embedding", params["ln_emb"])
    for i, lp in enumerate(params["layers"]):
        b = f"{e}layers.{i}."
        for key in ("q", "k", "v", "out"):
            _lin(sd, f"{b}self_attn.{key}_proj", lp["attn"][key])
        _ln(sd, b + "self_attn_layer_norm", lp["ln1"])
        _lin(sd, b + "fc1", lp["fc1"])
        _lin(sd, b + "fc2", lp["fc2"])
        _ln(sd, b + "final_layer_norm", lp["ln2"])
    return sd


def clip_text_state_dict(params: dict, blocks: str = "text_branch.",
                         root: str = "") -> dict[str, np.ndarray]:
    """A JAX clip_text pytree -> reference names: the blocks under
    ``blocks`` (``text_branch.`` in a CLAP checkpoint, ``transformer.`` in
    an OpenAI one), the embeddings and ``ln_final`` under ``root`` (the
    inverse of ``models/openai.py::convert_openai_text_tower``)."""
    sd: dict = {root + "token_embedding.weight": np.asarray(params["token_embedding"]),
                root + "positional_embedding": np.asarray(params["positional_embedding"])}
    _ln(sd, root + "ln_final", params["ln_final"])
    _resblocks(sd, blocks, params["blocks"])
    return sd


def _resblocks(sd: dict, pre: str, blocks: list) -> None:
    """CLIP residual blocks (text and ViT) -> ``{pre}resblocks.{i}.*``."""
    for i, bp in enumerate(blocks):
        b = f"{pre}resblocks.{i}."
        _ln(sd, b + "ln_1", bp["ln1"])
        sd[b + "attn.in_proj_weight"] = np.asarray(bp["attn"]["in_proj"]["kernel"]).T
        sd[b + "attn.in_proj_bias"] = np.asarray(bp["attn"]["in_proj"]["bias"])
        _lin(sd, b + "attn.out_proj", bp["attn"]["out_proj"])
        _ln(sd, b + "ln_2", bp["ln2"])
        _lin(sd, b + "mlp.c_fc", bp["mlp"]["c_fc"])
        _lin(sd, b + "mlp.c_proj", bp["mlp"]["c_proj"])


def _vit(sd: dict, pre: str, p: dict, patch: int) -> None:
    w = np.asarray(p["class_embedding"]).shape[0]
    # the [p*p*3, w] patch matmul's rows are (row, column, channel)-major
    sd[pre + "conv1.weight"] = np.asarray(p["patch_embed"]["kernel"]).reshape(
        patch, patch, 3, w).transpose(3, 2, 0, 1)
    sd[pre + "class_embedding"] = np.asarray(p["class_embedding"])
    sd[pre + "positional_embedding"] = np.asarray(p["positional_embedding"])
    _ln(sd, pre + "ln_pre", p["ln_pre"])
    _resblocks(sd, pre + "transformer.", p["blocks"])
    _ln(sd, pre + "ln_post", p["ln_post"])
    if "proj" in p:
        sd[pre + "proj"] = np.asarray(p["proj"])


def _attnpool(sd: dict, pre: str, p: dict) -> None:
    sd[pre + "positional_embedding"] = np.asarray(p["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _lin(sd, pre + name, p[name])


def _resnet(sd: dict, pre: str, p: dict) -> None:
    for k in (1, 2, 3):
        sd[f"{pre}conv{k}.weight"] = _conv(p[f"conv{k}"]["kernel"])
        _bn(sd, f"{pre}bn{k}", p[f"bn{k}"])
    for stage in sorted(k for k in p if k.startswith("layer")):
        for j, blk in enumerate(p[stage]):
            b = f"{pre}{stage}.{j}."
            for k in (1, 2, 3):
                sd[f"{b}conv{k}.weight"] = _conv(blk[f"conv{k}"]["kernel"])
                _bn(sd, f"{b}bn{k}", blk[f"bn{k}"])
            if "downsample" in blk:
                sd[b + "downsample.0.weight"] = _conv(blk["downsample"]["conv"]["kernel"])
                _bn(sd, b + "downsample.1", blk["downsample"]["bn"])
    if "attnpool" in p:
        _attnpool(sd, pre + "attnpool.", p["attnpool"])


def vision_state_dict(params: dict, cfg: VisionCfg, prefix: str = "") -> dict[str, np.ndarray]:
    """A JAX vision-tower pytree (``models/vision.py``: ViT, ModifiedResNet
    or the timm adapter's ``trunk``/``pool``/``head``) of the tower config
    ``cfg`` -> the port's open_clip names under ``prefix``: HWIO kernels to
    OIHW, the ViT's patch matmul to ``conv1``, linear kernels transposed,
    ``proj`` as it is (``x @ proj``). The JAX suite's own mapping
    (``tests/test_vision.py``), kept here."""
    sd: dict = {}
    if "trunk" in params:
        trunk_cfg, kind, _ = trunk_spec(cfg)
        if kind == "vit":
            _vit(sd, prefix + "trunk.", params["trunk"], trunk_cfg.patch_size)
        else:
            _resnet(sd, prefix + "trunk.", params["trunk"])
        if "pool" in params:
            _attnpool(sd, prefix + "head.pool.", params["pool"])
        head = params.get("head", {})
        if "proj" in head:
            _lin(sd, prefix + "head.proj", head["proj"])
        if "fc1" in head:
            _lin(sd, prefix + "head.mlp.fc1", head["fc1"])
            _lin(sd, prefix + "head.mlp.fc2", head["fc2"])
    elif "patch_embed" in params:
        _vit(sd, prefix, params, cfg.patch_size)
    else:
        _resnet(sd, prefix, params)
    return sd


def clip_state_dict(params: dict, cfg: CLIPConfig) -> dict[str, np.ndarray]:
    """A JAX CLIP pytree (``models/clip.py``) of ``cfg`` -> the OpenAI CLIP
    layout of :class:`~audio_residual_tpu_torch.models.clip.CLIP`."""
    sd = vision_state_dict(params["visual"], cfg.vision, "visual.")
    sd.update(clip_text_state_dict(params["text_branch"], blocks="transformer."))
    sd["text_projection"] = np.asarray(params["text_projection"])
    sd["logit_scale"] = np.asarray(params["logit_scale"])
    return sd


def clap_state_dict(params: dict, text_model_type: str = "roberta") -> dict[str, np.ndarray]:
    """A full JAX CLAP pytree -> the reference CLAP checkpoint's names."""
    sd = clap_audio_state_dict(params)
    if text_model_type in ("roberta", "bert"):
        sd.update(roberta_state_dict(params["text_branch"]))
    elif text_model_type == "bart":
        sd.update(bart_state_dict(params["text_branch"]))
    elif text_model_type == "transformer":
        sd.update(clip_text_state_dict(params["text_branch"]))
    else:
        raise RuntimeError(f"Model type {text_model_type} not found.")
    # nn.Sequential(Linear, act, Linear) -> 0 / 2; MLPLayers -> sequential.0 / .3
    _lin(sd, "text_projection.0", params["text_projection"]["fc1"])
    _lin(sd, "text_projection.2", params["text_projection"]["fc2"])
    for side in ("audio", "text"):
        _lin(sd, f"{side}_transform.sequential.0", params[f"{side}_transform"]["fc1"])
        _lin(sd, f"{side}_transform.sequential.3", params[f"{side}_transform"]["fc2"])
    sd["logit_scale_a"] = np.asarray(params["logit_scale_a"])
    sd["logit_scale_t"] = np.asarray(params["logit_scale_t"])
    return sd


def load_jax_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load a JAX param pytree (numpy leaves), strictly: a CLAP's into a
    :class:`~audio_residual_tpu_torch.models.clap.CLAP` (every key) or a
    :class:`~audio_residual_tpu_torch.models.clap.CLAPAudio` (the audio
    side); a CLIP's into a :class:`~audio_residual_tpu_torch.models.clip.CLIP`;
    a vision tower's into the port's tower (its ``cfg``)."""
    if isinstance(model, CLIP):
        sd = clip_state_dict(params, model.cfg)
    elif isinstance(getattr(model, "cfg", None), VisionCfg):
        sd = vision_state_dict(params, model.cfg)
    elif isinstance(model, CLAP):
        sd = clap_state_dict(params, model.cfg.text_model_type)
    else:
        sd = clap_audio_state_dict(params)
    model.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                           for k, v in sd.items()}, strict=True)
    return model


def load_torch_checkpoint(path) -> dict[str, torch.Tensor]:
    """A reference checkpoint file -> ``{name: tensor}`` on the CPU: its
    ``state_dict`` when it holds one, ``module.`` prefixes stripped
    (``audio_residual_tpu/models/convert.py::load_torch_checkpoint``).
    Read with ``weights_only=True``: tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module."): v for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def load_audio_checkpoint(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load the audio side of a reference checkpoint into a
    :class:`~audio_residual_tpu_torch.models.clap.CLAPAudio` (or the audio
    side of a :class:`~audio_residual_tpu_torch.models.clap.CLAP`, whose
    text side stays as built).

    ``sed_model.`` (HTS-AT codebase) keys are read as ``audio_branch.``; the
    text side, the transform heads and derived buffers are skipped; every
    other key must match the model's, and every audio-branch key must be
    there. A tower-only
    checkpoint (no ``audio_projection.`` keys) leaves the projection as
    built, as the JAX loader keeps its fresh one."""
    sd = load_torch_checkpoint(path)
    sd = {k.replace("sed_model.", "audio_branch."): v for k, v in sd.items()
          if not k.startswith(_NOT_AUDIO) and not any(p in k for p in DERIVED_KEYS)}
    tower_only = not any(k.startswith("audio_projection.") for k in sd)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.startswith(_NOT_AUDIO)
               and not (tower_only and k.startswith("audio_projection."))]
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {path} does not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    return model


# keys of a full reference checkpoint that no module of the port holds: the
# BART decoder and its shared embedding, which CLAP never runs
# (`model.py:637-645` reads the encoder's output only)
_BART_DECODER = ("text_branch.decoder.", "text_branch.shared.")


def load_clap_checkpoint(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a whole reference CLAP checkpoint into a
    :class:`~audio_residual_tpu_torch.models.clap.CLAP`: ``module.``
    prefixes stripped, derived buffers (``text_branch.embeddings.position_ids``,
    the DSP extractors, BatchNorm's step count, the Swin relative-position
    index and masks) and a BART decoder skipped; every other key must match
    the model's, and every key of the model must be there."""
    sd = {k: v for k, v in load_torch_checkpoint(path).items()
          if not k.startswith(_BART_DECODER) and not any(p in k for p in DERIVED_KEYS)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {path} does not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    return model
