"""Weight bridge: the JAX package's param pytree -> the port's modules.

The counterpart of the audio side of
``audio_residual_tpu/models/convert.py::clap_params_to_state_dict``, kept
here so the port imports nothing of the JAX package. Input is the JAX CLAP
param pytree as nested dicts/lists of numpy arrays (``audio_branch``,
``audio_projection``; other keys are ignored). Linear kernels ``[in, out]``
are transposed to ``[out, in]``; HWIO convolution kernels become OIHW.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["clap_audio_state_dict", "load_jax_params"]


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
