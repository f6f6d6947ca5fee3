"""CLAP audio side: HTSAT branch + two-layer MLP projection into the joint
space, and the L2 normalisation.

Port of the audio half of ``audio_residual_tpu/models/clap.py``
(``CLAPConfig`` audio fields, ``apply_projection``, ``l2_normalize``,
``encode_audio``). The text towers are a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.models.htsat import HTSAT, HTSATConfig, htsat_apply

__all__ = ["CLAPConfig", "CLAPAudio", "build_clap_audio", "apply_projection", "l2_normalize",
           "encode_audio"]


@dataclass(frozen=True)
class CLAPConfig:
    """Audio fields of the CLAP config (HTSAT-tiny defaults)."""

    embed_dim: int = 768  # audio tower output width
    joint_embed_shape: int = 512
    mlp_act: str = "relu"
    audio: HTSATConfig = field(default_factory=HTSATConfig)


class CLAPAudio(nn.Module):
    """``audio_branch`` (HTSAT) + ``audio_projection`` (Linear, act, Linear);
    state-dict keys are the audio side of the reference CLAP checkpoint."""

    def __init__(self, cfg: CLAPConfig = CLAPConfig(), generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        if cfg.mlp_act not in ("relu", "gelu"):
            raise ValueError(cfg.mlp_act)
        self.cfg = cfg
        self.audio_branch = HTSAT(cfg.audio, gen)
        j = cfg.joint_embed_shape
        act = nn.ReLU() if cfg.mlp_act == "relu" else nn.GELU()
        self.audio_projection = nn.Sequential(nn.Linear(cfg.embed_dim, j), act, nn.Linear(j, j))
        with torch.no_grad():
            for lin in (self.audio_projection[0], self.audio_projection[2]):
                lim = 1.0 / lin.in_features**0.5
                nn.init.uniform_(lin.weight, -lim, lim, generator=gen)
                lin.bias.zero_()


def build_clap_audio(cfg: CLAPConfig = CLAPConfig(), *, seed: int = 0,
                     device: str | torch.device | None = None) -> CLAPAudio:
    """Random-init audio model from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), in eval mode with frozen parameters."""
    dev = resolve_device(device)
    model = CLAPAudio(cfg, torch.Generator().manual_seed(seed))
    return model.to(dev).eval().requires_grad_(False)


def apply_projection(model: CLAPAudio, x: torch.Tensor) -> torch.Tensor:
    """Linear -> act -> Linear."""
    return model.audio_projection(x)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x * rsqrt(max(sum(x^2), eps^2))`` (torch ``F.normalize`` semantics)."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def encode_audio(model: CLAPAudio, batch, *, taps=(), residual: dict | None = None,
                 double_ffn_compat: bool = True, compute_dtype=None, start_layer: int = 0,
                 stop_at_layer: int | None = None, stop_at_image: bool = False) -> dict:
    """Audio branch forward -> output dict, plus ``projected`` and
    ``normalized``. ``batch`` is ``{"waveform": [B, T]}`` or a ``[B, T]``
    tensor on the model's device, or a cached prefix (``{"image"}``,
    ``{"tokens"}``); ``stop_at_image`` / ``stop_at_layer`` return the prefix
    (``{"image"}`` / ``{"tokens"}``) untouched. ``taps`` (``"attention"``,
    ``"residual"``) add ``layers_attention`` / ``layers_residuals``. See
    :func:`htsat_apply`.

    The model's weights are frozen, so a forward builds an autograd graph
    only where a ResiDual ``lam`` requires grad (λ-training); callers that
    only embed need no ``torch.no_grad()``, though it saves the check."""
    out = htsat_apply(model.audio_branch, batch, taps=taps, residual=residual,
                      double_ffn_compat=double_ffn_compat, compute_dtype=compute_dtype,
                      start_layer=start_layer, stop_at_layer=stop_at_layer,
                      stop_at_image=stop_at_image)
    if stop_at_layer is not None or stop_at_image:
        return out
    proj = apply_projection(model, out["embedding"])
    out["projected"] = proj
    out["normalized"] = l2_normalize(proj)
    return out
