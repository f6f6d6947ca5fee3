"""CLAP dual-tower model: HTSAT or PANN audio branch + a text branch (RoBERTa, BERT,
BART or the CLIP transformer), two-layer MLP projections into the joint
space, the MLP "transform" heads and the learnable logit scales.

Port of ``audio_residual_tpu/models/clap.py``. :class:`CLAPAudio` is the
audio half (what the bench, λ-training and the analysis path build, through
:func:`build_clap_audio`); :class:`CLAP` adds the text half on top of it,
so every caller of the audio half also takes a full model.
:func:`clap_apply` is the reference ``forward`` contract (`model.py:650-693`),
in eval and in training mode. Training draws its randomness from one
``torch.Generator``, split into the audio tower's, the audio transform's and
the text transform's streams (:func:`split_generator`), where the JAX package
splits a ``jax.random`` key three ways; the text towers have no training
mode (the JAX package's neither: ``encode_text`` takes no ``train``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.models.bart import Bart, bart_apply
from audio_residual_tpu_torch.models.clip_text import (Transformer, add_text_embeddings,
                                                       clip_text_apply)
from audio_residual_tpu_torch.models.htsat import HTSAT, HTSATConfig, htsat_apply
from audio_residual_tpu_torch.models.pann import PANN, pann_apply
from audio_residual_tpu_torch.models.roberta import Roberta, RobertaConfig, roberta_apply

__all__ = ["CLAPConfig", "CLAPAudio", "CLAP", "build_clap_audio", "build_clap",
           "text_tower_width", "apply_projection", "apply_transform", "l2_normalize",
           "encode_audio", "encode_text", "clap_apply", "split_generator"]

TEXT_MODEL_TYPES = ("roberta", "bert", "transformer", "bart")


@dataclass(frozen=True)
class CLAPConfig:
    """The CLAP config (HTSAT-tiny + roberta defaults, `HTSAT-tiny.json`).
    ``text`` is a ``RobertaConfig`` (roberta, bert), a ``ClipTextConfig``
    (transformer) or a ``BartConfig`` (bart), matching
    ``text_model_type``. ``audio`` is an ``HTSATConfig`` or, with
    ``audio_model_type="PANN"``, a ``PANNConfig``; ``embed_dim`` is the
    tower's output width (PANN: 512, 1024, 2048)."""

    embed_dim: int = 768  # audio tower output width
    joint_embed_shape: int = 512
    mlp_act: str = "relu"
    audio: HTSATConfig = field(default_factory=HTSATConfig)
    text: Any = field(default_factory=RobertaConfig)
    text_model_type: str = "roberta"  # roberta | bert | transformer | bart
    audio_model_type: str = "HTSAT"
    context_length: int = 77


def text_tower_width(cfg: CLAPConfig) -> int:
    """Input width of the text projection: the CLIP tower's ``width``, the
    HF towers' ``hidden_size`` / ``d_model`` (`model.py:486-527`)."""
    t = cfg.text_model_type
    if t == "transformer":
        return cfg.text.width
    if t in ("roberta", "bert"):
        return cfg.text.hidden_size
    if t == "bart":
        return cfg.text.d_model
    raise RuntimeError(f"Model config for {t} not found.")


def _mlp(d_in: int, j: int, act: nn.Module, gen: torch.Generator) -> nn.Sequential:
    """Linear -> act -> Linear, weights U(+-1/sqrt(fan_in)), biases 0."""
    seq = nn.Sequential(nn.Linear(d_in, j), act, nn.Linear(j, j))
    with torch.no_grad():
        for lin in (seq[0], seq[2]):
            lim = 1.0 / lin.in_features**0.5
            nn.init.uniform_(lin.weight, -lim, lim, generator=gen)
            lin.bias.zero_()
    return seq


class CLAPAudio(nn.Module):
    """``audio_branch`` (HTSAT or PANN) + ``audio_projection`` (Linear, act,
    Linear); state-dict keys are the audio side of the reference CLAP
    checkpoint."""

    def __init__(self, cfg: CLAPConfig = CLAPConfig(), generator: torch.Generator | None = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        if cfg.mlp_act not in ("relu", "gelu"):
            raise ValueError(cfg.mlp_act)
        self.cfg = cfg
        if cfg.audio_model_type == "HTSAT":
            self.audio_branch = HTSAT(cfg.audio, gen)
        elif cfg.audio_model_type == "PANN":
            self.audio_branch = PANN(cfg.audio, gen)
        else:
            raise RuntimeError(f"Model config for {cfg.audio_model_type} not found")
        act = nn.ReLU() if cfg.mlp_act == "relu" else nn.GELU()
        self.audio_projection = _mlp(cfg.embed_dim, cfg.joint_embed_shape, act, gen)


class _MLPLayers(nn.Module):
    """The reference's ``MLPLayers([j, j, j], dropout=0.1)``: ``sequential`` =
    Linear, ReLU, Dropout, Linear (`model.py:27-44`, the trailing ReLU and
    Dropout stripped), keys ``sequential.0`` / ``.3``."""

    def __init__(self, j: int, gen: torch.Generator):
        super().__init__()
        mlp = _mlp(j, j, nn.ReLU(), gen)
        self.sequential = nn.Sequential(mlp[0], mlp[1], nn.Dropout(0.1), mlp[2])


class CLAP(CLAPAudio):
    """The full model: :class:`CLAPAudio` plus ``text_branch``,
    ``text_projection``, ``audio_transform``, ``text_transform`` and
    ``logit_scale_a`` / ``logit_scale_t`` (``log(1/0.07)``), the reference
    checkpoint's keys. A ``transformer`` text tower also puts
    ``token_embedding``, ``positional_embedding`` and ``ln_final`` on the
    root, as the reference does. The audio half draws from ``generator``
    first, so a seed gives the audio weights :class:`CLAPAudio` gives."""

    def __init__(self, cfg: CLAPConfig = CLAPConfig(), generator: torch.Generator | None = None):
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        super().__init__(cfg, gen)
        t = cfg.text_model_type
        if t in ("roberta", "bert"):
            self.text_branch = Roberta(cfg.text, gen)
        elif t == "transformer":
            self.text_branch = Transformer(cfg.text, gen)
            add_text_embeddings(self, cfg.text, gen)
        elif t == "bart":
            self.text_branch = Bart(cfg.text, gen)
        else:
            raise RuntimeError(f"Model config for {t} not found.")
        j = cfg.joint_embed_shape
        act = nn.ReLU() if cfg.mlp_act == "relu" else nn.GELU()
        self.text_projection = _mlp(text_tower_width(cfg), j, act, gen)
        self.audio_transform = _MLPLayers(j, gen)
        self.text_transform = _MLPLayers(j, gen)
        self.logit_scale_a = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.logit_scale_t = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def forward(self, audio_batch, input_ids, attention_mask=None, **kw) -> dict:
        """:func:`clap_apply` of this model. The train step and validation
        call the model rather than ``clap_apply``, so that the hooks of a
        sharded model (``parallel/fsdp.py``) gather its weights around the
        call."""
        return clap_apply(self, audio_batch, input_ids, attention_mask, **kw)


def build_clap_audio(cfg: CLAPConfig = CLAPConfig(), *, seed: int = 0,
                     device: str | torch.device | None = None) -> CLAPAudio:
    """Random-init audio model from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), in eval mode with frozen parameters."""
    dev = resolve_device(device)
    model = CLAPAudio(cfg, torch.Generator().manual_seed(seed))
    return model.to(dev).eval().requires_grad_(False)


def build_clap(cfg: CLAPConfig = CLAPConfig(), *, seed: int = 0,
               device: str | torch.device | None = None) -> CLAP:
    """Random-init full model from ``seed`` on ``device`` (the card unless
    ``device="cpu"``), in eval mode with frozen parameters."""
    dev = resolve_device(device)
    model = CLAP(cfg, torch.Generator().manual_seed(seed))
    return model.to(dev).eval().requires_grad_(False)


def apply_projection(model: CLAPAudio, x: torch.Tensor) -> torch.Tensor:
    """The audio projection: Linear -> act -> Linear."""
    return model.audio_projection(x)


def apply_transform(transform: nn.Module, x: torch.Tensor, *, train: bool = False,
                    generator: torch.Generator | None = None, drop: float = 0.1
                    ) -> torch.Tensor:
    """An :class:`_MLPLayers` head (``model.audio_transform`` /
    ``model.text_transform``): Linear -> ReLU -> Dropout -> Linear, dropout
    only in training with a ``generator`` (the JAX package's ``train and
    rng is not None``), its mask drawn on the generator's device."""
    seq = transform.sequential
    h = F.relu(seq[0](x))
    if train and generator is not None and drop > 0:
        keep = torch.rand(h.shape, generator=generator, device=generator.device)
        h = h * (keep.to(h.device) < 1 - drop) / (1 - drop)
    return seq[3](h)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x * rsqrt(max(sum(x^2), eps^2))`` (torch ``F.normalize`` semantics)."""
    sq = (x * x).sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def encode_audio(model: CLAPAudio, batch, *, train: bool = False,
                 generator: torch.Generator | None = None, bn_group=None, taps=(),
                 residual: dict | None = None, double_ffn_compat: bool = True,
                 compute_dtype=None, start_layer: int = 0, stop_at_layer: int | None = None,
                 stop_at_image: bool = False) -> dict:
    """Audio branch forward -> output dict, plus ``projected`` and
    ``normalized``. ``batch`` is ``{"waveform": [B, T]}`` or a ``[B, T]``
    tensor on the model's device, or a cached prefix (``{"image"}``,
    ``{"tokens"}``); ``stop_at_image`` / ``stop_at_layer`` return the prefix
    (``{"image"}`` / ``{"tokens"}``) untouched. ``taps`` (``"attention"``,
    ``"residual"``) add ``layers_attention`` / ``layers_residuals``;
    ``train``, ``generator`` and ``bn_group`` select the training forward.
    See :func:`htsat_apply`. A PANN tower (:func:`~audio_residual_tpu_torch.
    models.pann.pann_apply`) takes no taps, ResiDual or split points (a
    ``ValueError``, as in the JAX package, ``clap.py:175-179``) and runs
    f32 whatever ``compute_dtype`` is.

    Built models hold frozen weights, so a forward builds an autograd graph
    only where a ResiDual ``lam`` requires grad (λ-training) or the caller
    made the weights trainable (``training/train_clap.py``); callers that
    only embed need no ``torch.no_grad()``, though it saves the check."""
    if model.cfg.audio_model_type == "PANN":
        if taps or residual or start_layer or stop_at_layer is not None or stop_at_image:
            raise ValueError("taps/residual/start_layer/stop_at_layer are HTSAT-only")
        out = pann_apply(model.audio_branch, batch, train=train, generator=generator)
    else:
        out = htsat_apply(model.audio_branch, batch, train=train, generator=generator,
                          bn_group=bn_group, taps=taps, residual=residual,
                          double_ffn_compat=double_ffn_compat, compute_dtype=compute_dtype,
                          start_layer=start_layer, stop_at_layer=stop_at_layer,
                          stop_at_image=stop_at_image)
    if stop_at_layer is not None or stop_at_image:
        return out
    proj = apply_projection(model, out["embedding"])
    out["projected"] = proj
    out["normalized"] = l2_normalize(proj)
    return out


def encode_text(model: CLAP, input_ids, attention_mask=None, *, normalize: bool = True,
                compute_dtype=None) -> torch.Tensor:
    """Text branch -> tower feature -> projection (-> L2 normalise),
    dispatched on ``cfg.text_model_type`` (`model.py:602-648`): roberta /
    bert take the pooler output, transformer the EOT token's feature, bart
    the **unmasked** mean over all positions (the reference averages the
    padding too). ``compute_dtype`` reaches the roberta / bert tower only;
    the others run f32 whatever it is."""
    cfg = model.cfg
    t = cfg.text_model_type
    if t in ("roberta", "bert"):
        pooled = roberta_apply(model.text_branch, input_ids, attention_mask,
                               compute_dtype=compute_dtype)["pooler_output"]
    elif t == "transformer":
        pooled = clip_text_apply(model.text_branch, model, input_ids, cfg.text)
    elif t == "bart":
        hidden = bart_apply(model.text_branch, input_ids,
                            attention_mask)["encoder_last_hidden_state"]
        pooled = hidden.mean(dim=1)
    else:
        raise RuntimeError(f"Model type {t} not found.")
    x = model.text_projection(pooled)
    return l2_normalize(x) if normalize else x


def split_generator(generator: torch.Generator, n: int, device=None) -> list:
    """``n`` generators on ``device`` (the generator's by default), seeded
    from ``n`` draws of ``generator``: the counterpart of
    ``jax.random.split``."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    dev = torch.device(device) if device is not None else generator.device
    return [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds.tolist()]


def clap_apply(model: CLAP, audio_batch, input_ids, attention_mask=None, *,
               train: bool = False, generator: torch.Generator | None = None, bn_group=None,
               compute_dtype=None) -> dict:
    """The contrastive forward (`model.py:650-693`): normalised audio and
    text features, their MLP-transformed variants and the exp'd logit
    scales, the inputs of the CLIP loss.

    ``train=True`` runs the audio tower's training forward and adds
    ``bn0_state``, bn0's updated running statistics, for the train step to
    merge; with ``generator`` it also draws SpecAugment, drop-path and the
    transform heads' dropout from it, split three ways on the model's
    device. Without one nothing random happens (the JAX package's
    ``rng=None``). ``bn_group`` takes bn0's statistics over every rank of a
    ``torch.distributed`` process group."""
    g_audio = g_at = g_tt = None
    if train and generator is not None:
        g_audio, g_at, g_tt = split_generator(generator, 3, model.logit_scale_a.device)
    audio_out = encode_audio(model, audio_batch, train=train, generator=g_audio,
                             bn_group=bn_group, compute_dtype=compute_dtype)
    audio_features = audio_out["normalized"]
    text_features = encode_text(model, input_ids, attention_mask, compute_dtype=compute_dtype)
    extra = {"bn0_state": audio_out["bn0_state"]} if train and "bn0_state" in audio_out else {}
    return {
        **extra,
        "audio_features": audio_features,
        "text_features": text_features,
        "audio_features_mlp": apply_transform(model.audio_transform, audio_features,
                                              train=train, generator=g_at),
        "text_features_mlp": apply_transform(model.text_transform, text_features,
                                             train=train, generator=g_tt),
        "logit_scale_a": torch.exp(model.logit_scale_a),
        "logit_scale_t": torch.exp(model.logit_scale_t),
    }
