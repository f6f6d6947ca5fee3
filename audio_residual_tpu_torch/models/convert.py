"""Weights into the port's modules: reference checkpoints and the JAX bridge.

:func:`load_audio_checkpoint` loads the audio side of a reference torch
checkpoint (the port's modules use its ``state_dict`` layout).

:func:`load_jax_params` is the counterpart of the audio side of
``audio_residual_tpu/models/convert.py::clap_params_to_state_dict``, kept
here so the port imports nothing of the JAX package. Input is the JAX CLAP
param pytree as nested dicts/lists of numpy arrays (``audio_branch``,
``audio_projection``; other keys are ignored). Linear kernels ``[in, out]``
are transposed to ``[out, in]``; HWIO convolution kernels become OIHW.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["clap_audio_state_dict", "load_jax_params", "load_torch_checkpoint",
           "load_audio_checkpoint"]

# keys of a reference checkpoint that the audio side does not load: the text
# side, the training-only transform heads, and buffers the port derives (DSP
# extractors, BatchNorm's step count, the Swin relative-position index and
# shift masks)
_NOT_AUDIO = ("text_branch.", "text_projection.", "logit_scale", "audio_transform.",
              "text_transform.")
_DERIVED = ("position_ids", "spectrogram_extractor.", "logmel_extractor.",
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


def clap_audio_state_dict(params: dict) -> dict[str, np.ndarray]:
    """Reference state-dict names -> numpy arrays, audio side only."""
    hp, pre = params["audio_branch"], "audio_branch."
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


def load_jax_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Load a JAX CLAP param pytree (numpy leaves) into a
    :class:`~audio_residual_tpu_torch.models.clap.CLAPAudio`, strictly."""
    sd = {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in clap_audio_state_dict(params).items()
    }
    model.load_state_dict(sd, strict=True)
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
    :class:`~audio_residual_tpu_torch.models.clap.CLAPAudio`.

    ``sed_model.`` (HTS-AT codebase) keys are read as ``audio_branch.``; the
    text side, the transform heads and derived buffers are skipped; every
    other key must match the model's, and every audio-branch key must be
    there. A tower-only
    checkpoint (no ``audio_projection.`` keys) leaves the projection as
    built, as the JAX loader keeps its fresh one."""
    sd = load_torch_checkpoint(path)
    sd = {k.replace("sed_model.", "audio_branch."): v for k, v in sd.items()
          if not k.startswith(_NOT_AUDIO) and not any(p in k for p in _DERIVED)}
    tower_only = not any(k.startswith("audio_projection.") for k in sd)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not (tower_only and k.startswith("audio_projection."))]
    if missing or unexpected:
        raise RuntimeError(f"checkpoint {path} does not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    return model
