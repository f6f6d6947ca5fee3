"""User-facing wrapper, the ``CLAP_Module`` of `hook.py:21-218`.

Port of ``audio_residual_tpu/module.py``. Differences by design:
  * no power-of-two batch bucketing: the JAX package pads batches to bound
    jit recompilation, and rows are independent in eval mode, so the port
    embeds the batch as given;
  * ``load_ckpt`` reads a local file only (the port fetches nothing);
  * crops of clips longer than the model's input come from a seeded
    ``torch.Generator`` (``jax.random`` in the JAX package);
  * a fusion module (``enable_fusion=True``, ``aff_2d``) embeds audio as the
    reference hook does (`hook.py:121-191`): each clip's ``mel_fusion`` and
    ``longer`` from ``get_audio_features(data_truncating="fusion")`` (its
    chunks drawn from a ``np.random.Generator`` seeded with ``seed``), the
    mel on K1 one clip at a time. The JAX package sends a fusion model the
    waveform alone (``module.py:123-129,158-173``), which a 2-D fusion
    model cannot embed (ROADMAP Queue 3).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from audio_residual_tpu_torch.data.featurize import (featurize_batch, fusion_batch,
                                                     get_audio_features)
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.models.clap import encode_audio, encode_text
from audio_residual_tpu_torch.models.pretrained import get_pretrained_url
from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
from audio_residual_tpu_torch.utils.tokenizer import load_default_tokenizer

__all__ = ["CLAPModule", "DOWNLOAD_NAMES", "audio_infer"]

DOWNLOAD_NAMES = [
    "630k-best.pt",
    "630k-audioset-best.pt",
    "630k-fusion-best.pt",
    "630k-audioset-fusion-best.pt",
]


class CLAPModule:
    """``CLAPModule(enable_fusion=False, amodel='HTSAT-tiny', tmodel='roberta')``
    (`hook.py:21-62`), on ``device`` (the card unless ``device="cpu"``).
    Non-fusion models take fusion_type ``None``, fusion models ``aff_2d``.

    ``compute_dtype=torch.bfloat16`` runs the audio side in AMP. The text
    side stays f32 whatever it is: ``get_text_embedding`` calls
    ``encode_text`` without it, as the JAX package does
    (``module.py:186-191``)."""

    def __init__(self, enable_fusion: bool = False, amodel: str = "HTSAT-tiny",
                 tmodel: str = "roberta", *, seed: int = 0, tokenizer=None, compute_dtype=None,
                 device: str | torch.device | None = None):
        self.enable_fusion = enable_fusion
        self.model, self.cfg, self.model_cfg = factory.create_model(
            amodel, tmodel, enable_fusion=enable_fusion,
            fusion_type="aff_2d" if enable_fusion else "None", seed=seed, device=device)
        self.device = self.model.logit_scale_a.device
        self.amodel = amodel
        self.tokenize = tokenizer or load_default_tokenizer(self.cfg.context_length)
        self.compute_dtype = compute_dtype
        self._crops = torch.Generator().manual_seed(seed)
        self._chunks = np.random.default_rng(seed)

    def tokenizer(self, text):
        """`hook.py:64-73` contract: dict with input_ids/attention_mask."""
        return self.tokenize(text)

    # -- checkpoints --------------------------------------------------------

    def load_ckpt(self, ckpt: str | None = None, model_id: int = -1, verbose: bool = True):
        """Load a reference checkpoint (`hook.py:75-119`). ``ckpt=None``
        looks for the published checkpoint of this model next to this
        package and raises :class:`FileNotFoundError` with the path and the
        URL when it is not there."""
        if ckpt is None:
            if model_id == -1:
                model_id = 3 if self.enable_fusion else 1
            name = DOWNLOAD_NAMES[model_id]
            ckpt = os.path.join(os.path.dirname(os.path.realpath(__file__)), name)
            if not os.path.exists(ckpt):
                url = get_pretrained_url(name.removesuffix(".pt"))
                raise FileNotFoundError(f"checkpoint {name} not found at {ckpt}; the port "
                                        f"downloads nothing: fetch {url} and place it there, "
                                        "or pass ckpt=")
        logging.info("Load checkpoint %s", ckpt)
        factory.load_checkpoint(self.model, ckpt)
        if verbose:
            logging.info("Loaded checkpoint into %s", self.amodel)
        return self

    # -- embedding ----------------------------------------------------------

    def fusion_batch(self, clips) -> dict:
        """``{"mel_fusion": [N, 4, T, F], "longer": [N]}`` on the module's
        device from ``N`` 1-D clips (numpy or tensors on any device, any
        lengths): each clip's ``get_audio_features(data_truncating="fusion",
        data_filling="repeatpad")``, as the reference hook builds it."""
        return fusion_batch([_host_clip(c) for c in clips], self.cfg.audio.clip_samples,
                            self.model_cfg["audio_cfg"], self._chunks, self.device)

    def _audio(self, x, *, quantize: bool, taps=(), residual=None) -> dict:
        if self.enable_fusion:
            clips = [_host_clip(c) for c in x]
            if quantize:
                clips = [quantize_roundtrip(torch.from_numpy(c)).numpy() for c in clips]
            batch = self.fusion_batch(clips)
        else:
            wav = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            if quantize:
                wav = quantize_roundtrip(wav)
            batch = featurize_batch(wav, self.cfg.audio.clip_samples, generator=self._crops)
        return encode_audio(self.model, batch, taps=taps, residual=residual,
                            compute_dtype=self.compute_dtype)

    def get_audio_embedding_from_data(self, x, use_tensor: bool = False):
        """`hook.py:158-191`: ``(N, T)`` waveforms -> ``(N, 512)`` normalised
        embeddings. ``use_tensor=False`` applies the int16 round trip and
        returns numpy; ``use_tensor=True`` keeps tensors (no round trip). A
        fusion module builds each clip's ``mel_fusion`` (:meth:`fusion_batch`)."""
        if use_tensor:
            return self._audio(x, quantize=False)["normalized"]
        with torch.no_grad():
            return self._audio(x, quantize=True)["normalized"].float().cpu().numpy()

    def get_audio_embedding_from_filelist(self, x: list[str], use_tensor: bool = False):
        """`hook.py:121-156`: decode each file at the model's rate
        (``data/datasets.py::load_wav``), then
        :meth:`get_audio_embedding_from_data`: a fusion module embeds the
        ``mel_fusion`` stack of the clips as decoded (any lengths);
        otherwise each is cropped at random or repeat-padded to the model's
        input first, as the JAX package does."""
        from audio_residual_tpu_torch.data.datasets import load_wav

        sr = self.cfg.audio.sample_rate
        wavs = [load_wav(f, target_sr=sr)[0] for f in x]
        if self.enable_fusion:
            return self.get_audio_embedding_from_data(wavs, use_tensor=use_tensor)
        clips = [get_audio_features({}, w, self.cfg.audio.clip_samples,
                                    data_truncating="rand_trunc", data_filling="repeatpad",
                                    audio_cfg=self.model_cfg["audio_cfg"],
                                    rng=self._chunks)["waveform"] for w in wavs]
        return self.get_audio_embedding_from_data(np.stack(clips), use_tensor=use_tensor)

    def get_audio_output_dict(self, x, taps=("attention", "residual"), residual=None) -> dict:
        """The audio branch's whole output dict after the int16 round trip,
        with ``layers_attention`` / ``layers_residuals`` for the taps
        (`model.py:745-762`)."""
        with torch.no_grad():
            return self._audio(x, quantize=True, taps=taps, residual=residual)

    def get_text_embedding(self, x, tokenizer=None, use_tensor: bool = False):
        """`hook.py:194-218`: texts -> ``(N, 512)`` normalised embeddings,
        f32 (see the class docstring)."""
        enc = (tokenizer or self.tokenize)(x)
        if use_tensor:
            return encode_text(self.model, enc["input_ids"], enc["attention_mask"])
        with torch.no_grad():
            return encode_text(self.model, enc["input_ids"],
                               enc["attention_mask"]).cpu().numpy()


def _host_clip(c) -> np.ndarray:
    """A clip as f32 numpy on the host, whether a tensor on any device or
    array-like: fusion featurization chunks it on the host."""
    if isinstance(c, torch.Tensor):
        return c.detach().to("cpu", torch.float32).numpy()
    return np.asarray(c, np.float32)


def audio_infer(module: CLAPModule, audio: np.ndarray, hopsize: int | None = None,
                key: str = "embedding") -> dict:
    """Sliding-window inference over one long clip (``CLAP.audio_infer``,
    `model.py:766-818`, in the JAX package's working form): repeat short
    audio to the clip length, slide windows ``hopsize`` apart over long
    audio, and stack the windows' ``key`` outputs."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim != 1:
        raise ValueError(f"audio_infer takes a single 1-D clip, got shape {audio.shape}")
    clip = module.cfg.audio.clip_samples
    n = len(audio)
    k = clip // max(n, 1)
    if k > 1:
        audio = np.tile(audio, k)
        n = len(audio)
    hopsize = min(hopsize or clip // 2, n)
    if n > clip:
        starts = list(range(0, n - clip, hopsize))
        windows = np.stack([audio[p: p + clip] for p in starts] + [audio[-clip:]])
    else:
        windows = audio[None]
    out = module.get_audio_output_dict(windows, taps=())
    return {key: (out[key] if key in out else out["normalized"]).float().cpu().numpy()}
