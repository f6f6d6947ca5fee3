"""The system under test, as the benchmark reaches it: the port's model
built from a configuration file, with weights that the benchmark made,
loaded through ``load_state_dict`` as a reference checkpoint is loaded.
Only the drivers and this module import the port.
"""

from __future__ import annotations

import torch

from benchmark.core import ROOT

__all__ = ["use_build_dir", "clap_config", "build_model"]

BUILD_DIR = ROOT / "build" / "kernels"


def use_build_dir() -> None:
    """The port builds and loads its kernels in the checkout's fixed
    ``build/kernels``, so only a checkout's first run compiles."""
    from audio_residual_tpu_torch.ops.cuda import build

    build.set_build_dir(BUILD_DIR)


def clap_config(cfg: dict):
    from audio_residual_tpu_torch.models.clap import CLAPConfig
    from audio_residual_tpu_torch.models.htsat import HTSATConfig

    a = dict(cfg["audio"])
    for key in ("patch_stride", "depths", "num_heads"):
        a[key] = tuple(a[key])
    return CLAPConfig(embed_dim=cfg["tower_width"], joint_embed_shape=cfg["joint_embed_dim"],
                      mlp_act=cfg["mlp_act"], audio=HTSATConfig(**a), audio_model_type="HTSAT")


def build_model(cfg: dict, state_dict: dict, device):
    """The port's ``CLAPAudio`` of ``cfg`` on ``device``, holding
    ``state_dict`` (strictly: every key, no other), in eval mode with frozen
    weights, as ``build_clap_audio`` leaves a model. Its modules are made on
    the meta device, so nothing is initialised on the host."""
    from audio_residual_tpu_torch.models.clap import CLAPAudio

    with torch.device("meta"):
        model = CLAPAudio(clap_config(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(state_dict, strict=True)
    return model.eval().requires_grad_(False)
