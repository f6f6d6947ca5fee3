"""Pretrained checkpoint registry.

Port of the registry of ``audio_residual_tpu/models/pretrained.py``
(`clap_module/pretrained.py:8-147`, `hook.py:91-119`): the published CLAP
checkpoints by name and URL. The port fetches nothing: where the JAX package
downloads, :func:`pretrained_path` looks for the file in a local directory
and raises :class:`FileNotFoundError` with the path and the URL to fetch it
from.
"""

from __future__ import annotations

import hashlib
import os

__all__ = ["list_pretrained", "get_pretrained_url", "pretrained_path", "register"]

_HF_BASE = "https://huggingface.co/lukewys/laion_clap/resolve/main/"

# name -> (url, sha256 or None)
_PRETRAINED: dict[str, tuple[str, str | None]] = {
    "630k-best": (_HF_BASE + "630k-best.pt", None),
    "630k-audioset-best": (_HF_BASE + "630k-audioset-best.pt", None),
    "630k-fusion-best": (_HF_BASE + "630k-fusion-best.pt", None),
    "630k-audioset-fusion-best": (_HF_BASE + "630k-audioset-fusion-best.pt", None),
    "music_speech_audioset_epoch_15_esc_89.98": (
        _HF_BASE + "music_speech_audioset_epoch_15_esc_89.98.pt", None),
    "music_audioset_epoch_15_esc_90.14": (
        _HF_BASE + "music_audioset_epoch_15_esc_90.14.pt", None),
    "music_speech_epoch_15_esc_89.25": (
        _HF_BASE + "music_speech_epoch_15_esc_89.25.pt", None),
}


def register(name: str, url: str, sha256: str | None = None) -> None:
    _PRETRAINED[name] = (url, sha256)


def list_pretrained() -> list[str]:
    return list(_PRETRAINED)


def get_pretrained_url(name: str) -> str:
    return _PRETRAINED[name][0]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def pretrained_path(name: str, cache_dir: str) -> str:
    """The checkpoint ``name`` in ``cache_dir`` under its URL's file name,
    checked against its sha256 where one is registered. Raises
    :class:`FileNotFoundError` naming the path and the URL when it is not
    there, and :class:`RuntimeError` on a checksum mismatch."""
    url, expected = _PRETRAINED[name]
    target = os.path.join(os.path.expanduser(cache_dir), os.path.basename(url))
    if not os.path.exists(target):
        raise FileNotFoundError(f"checkpoint {name} not found at {target}; the port downloads "
                                f"nothing: fetch {url} and place it there")
    if expected is not None and _sha256(target) != expected:
        raise RuntimeError(f"{name}: sha256 mismatch for {target}")
    return target
