"""Waveform featurization (``get_audio_features`` data contract).

Port of ``audio_residual_tpu/data/featurize.py``. :func:`featurize_batch`
is the batched form: all clips of a batch share one length, so one branch
serves the batch:

  * too long: ``rand_trunc`` crops ``max_len`` samples (``longer=True``).
    Crop starts come from ``starts`` or from a ``torch.Generator``; the JAX
    package draws them from ``jax.random``, so tests pass the starts.
  * too short: ``repeatpad`` tiles ``max_len // T`` times then zero-pads,
    ``pad`` zero-pads, ``repeat`` tiles then truncates.

:func:`get_audio_features` is the per-clip form, with the fusion mel stack
(``data_truncating="fusion"``): a clip longer than ``max_len`` gives the
global mel shrunk to the chunk length and three random chunks,
``[4, chunk_frames, n_mels]`` (:func:`fusion_mel`); a shorter one its mel
four times. Its random draws (chunks, crop start) come from the caller's
``np.random.Generator`` in the JAX package's order, so the same seed picks
the same chunks. :func:`get_mel` is the log-mel with torchaudio semantics
(HTK mel scale, no filterbank norm): the function K1 computes with that
filterbank, so on the card it runs through K1's golden route
(``fused_logmel``), one launch a clip.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audio_residual_tpu_torch import resolve_device
from audio_residual_tpu_torch.ops import frontend, interpolate
from audio_residual_tpu_torch.ops.cuda.frontend import fused_logmel

__all__ = ["featurize_batch", "fusion_frontend_config", "get_mel", "fusion_mel",
           "get_audio_features", "fusion_batch", "mel_audio_cfg", "DEFAULT_AUDIO_CFG"]

DEFAULT_AUDIO_CFG = dict(sample_rate=48000, window_size=1024, hop_size=480, mel_bins=64,
                         fmin=50, fmax=14000)


def featurize_batch(
    wav: torch.Tensor,
    max_len: int = 480000,
    *,
    data_truncating: str = "rand_trunc",
    data_filling: str = "repeatpad",
    starts: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict:
    """``[B, T] -> {"waveform": [B, max_len], "longer": [B] bool}``."""
    b, t = wav.shape
    if t > max_len:
        longer = torch.ones(b, dtype=torch.bool, device=wav.device)
        if data_truncating != "rand_trunc":
            raise NotImplementedError(f"batched data_truncating={data_truncating!r}")
        if starts is None:
            starts = torch.randint(0, t - max_len + 1, (b,), generator=generator)
        idx = starts.to(wav.device)[:, None] + torch.arange(max_len, device=wav.device)[None, :]
        wav = torch.gather(wav, 1, idx)
    elif t < max_len:
        longer = torch.zeros(b, dtype=torch.bool, device=wav.device)
        if data_filling == "repeatpad":
            wav = wav.repeat(1, max_len // t)
            wav = F.pad(wav, (0, max_len - wav.shape[1]))
        elif data_filling == "pad":
            wav = F.pad(wav, (0, max_len - t))
        elif data_filling == "repeat":
            wav = wav.repeat(1, max_len // t + 1)[:, :max_len]
        else:
            raise NotImplementedError(f"data_filling {data_filling!r}")
    else:
        longer = torch.zeros(b, dtype=torch.bool, device=wav.device)
    return {"waveform": wav, "longer": longer}


def fusion_frontend_config(audio_cfg: dict) -> frontend.FrontendConfig:
    """The fusion mel's frontend (`data.py:363-399`): torchaudio's
    ``MelSpectrogram`` semantics, HTK mel scale, no filterbank norm."""
    return frontend.FrontendConfig(
        sample_rate=audio_cfg["sample_rate"], n_fft=audio_cfg["window_size"],
        hop_length=audio_cfg["hop_size"], win_length=audio_cfg["window_size"],
        n_mels=audio_cfg["mel_bins"], fmin=audio_cfg["fmin"], fmax=audio_cfg["fmax"],
        mel_scale="htk", mel_norm=None)


def get_mel(audio_data, audio_cfg: dict, device: str | torch.device | None = None
            ) -> torch.Tensor:
    """``[T]`` -> ``[frames, n_mels]`` f32 log-mel on ``device`` (the card
    unless ``device="cpu"``): K1's golden route with the HTK filterbank."""
    dev = resolve_device(device)
    wav = torch.as_tensor(np.asarray(audio_data, np.float32)).to(dev)
    return fused_logmel(wav[None], fusion_frontend_config(audio_cfg), dft_mode="f32")[0]


def fusion_mel(audio_data, max_len: int, audio_cfg: dict, rng: np.random.Generator,
               device: str | torch.device | None = None) -> tuple[torch.Tensor, bool]:
    """The fusion mel stack of one long clip (`data.py:420-460`):
    ``([4, chunk_frames, n_mels]`` on ``device``, ``longer)``: the whole
    clip's mel shrunk (antialiased bilinear) to ``chunk_frames`` and three
    chunks, one from each third of the start range, drawn from ``rng``; a
    clip of exactly ``chunk_frames`` frames gives its mel four times and
    ``longer=False``."""
    mel = get_mel(audio_data, audio_cfg, device)
    chunk_frames = max_len // audio_cfg["hop_size"] + 1
    total_frames = mel.shape[0]
    if chunk_frames == total_frames:
        return torch.stack([mel] * 4), False
    ranges = np.array_split(list(range(0, total_frames - chunk_frames + 1)), 3)
    if len(ranges[1]) == 0:
        ranges[1] = np.array([0])
    if len(ranges[2]) == 0:
        ranges[2] = np.array([0])
    starts = [int(rng.choice(r)) for r in ranges]
    chunks = [mel[i: i + chunk_frames] for i in starts]
    shrink = interpolate.resize_bilinear_antialias(mel, chunk_frames, audio_cfg["mel_bins"])
    return torch.stack([shrink, *chunks]), True


def get_audio_features(sample: dict, audio_data, max_len: int = 480000,
                       data_truncating: str = "rand_trunc", data_filling: str = "repeatpad",
                       audio_cfg: dict | None = None, rng: np.random.Generator | None = None,
                       device: str | torch.device | None = None) -> dict:
    """One clip's features (`data.py:402-506`): sets and returns ``sample``'s
    ``waveform`` (numpy f32 ``[max_len]``) and ``longer`` (bool), and with
    ``data_truncating="fusion"`` its ``mel_fusion`` (a ``[4, chunk_frames,
    n_mels]`` tensor on ``device``, the card unless ``device="cpu"``). A
    clip longer than ``max_len`` is cropped at a start drawn from ``rng``
    after the fusion chunks."""
    rng = rng or np.random.default_rng()
    audio_data = np.asarray(audio_data, dtype=np.float32)
    audio_cfg = audio_cfg or DEFAULT_AUDIO_CFG
    n = len(audio_data)
    longer = False
    if n > max_len:
        if data_truncating == "rand_trunc":
            longer = True
        elif data_truncating == "fusion":
            sample["mel_fusion"], longer = fusion_mel(audio_data, max_len, audio_cfg, rng, device)
        else:
            raise NotImplementedError(f"data_truncating {data_truncating!r}")
        start = int(rng.integers(0, n - max_len + 1))
        audio_data = audio_data[start: start + max_len]
    else:
        if n < max_len:
            if data_filling == "repeatpad":
                audio_data = np.tile(audio_data, max_len // n)
                audio_data = np.pad(audio_data, (0, max_len - len(audio_data)))
            elif data_filling == "pad":
                audio_data = np.pad(audio_data, (0, max_len - n))
            elif data_filling == "repeat":
                audio_data = np.tile(audio_data, max_len // n + 1)[:max_len]
            else:
                raise NotImplementedError(f"data_filling {data_filling!r}")
        if data_truncating == "fusion":
            sample["mel_fusion"] = torch.stack([get_mel(audio_data, audio_cfg, device)] * 4)
    sample["longer"] = longer
    sample["waveform"] = audio_data.astype(np.float32)
    return sample


def fusion_batch(clips, max_len: int, audio_cfg: dict, rng: np.random.Generator,
                 device: str | torch.device | None = None) -> dict:
    """``{"mel_fusion": [N, 4, T, F], "longer": [N]}`` on ``device`` from
    ``N`` 1-D numpy clips of any lengths: each clip's
    ``get_audio_features(data_truncating="fusion", data_filling="repeatpad")``
    with its chunks from ``rng``, as the reference hook builds a fusion
    model's input (`hook.py:121-191`)."""
    feats = [get_audio_features({}, c, max_len, data_truncating="fusion",
                                data_filling="repeatpad", audio_cfg=audio_cfg, rng=rng,
                                device=device) for c in clips]
    mel = torch.stack([f["mel_fusion"] for f in feats])
    return {"mel_fusion": mel,
            "longer": torch.tensor([f["longer"] for f in feats], device=mel.device)}


def mel_audio_cfg(audio) -> dict:
    """The fusion mel's ``audio_cfg`` keys of a tower config (HTSAT or PANN)."""
    return dict(sample_rate=audio.sample_rate, window_size=audio.n_fft, hop_size=audio.hop_size,
                mel_bins=audio.mel_bins, fmin=audio.fmin, fmax=audio.fmax)
