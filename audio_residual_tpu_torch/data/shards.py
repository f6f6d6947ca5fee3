"""Sharded tar input: ``audio_residual_tpu/data/shards.py``.

Reference: `training/data.py:629-787` (``get_wds_dataset``: shard list ->
detshuffle -> split_by_node -> split_by_worker -> tarfile_to_samples ->
shuffle -> decode -> batched), `clap_module/utils.py:113-151` (tar paths
from ``sizes.json``), `data.py:321-324` (``log_and_continue``) and
`data.py:728-742` (every rank sees the same number of batches).

Plain ``tarfile`` + ``wave`` on the host, as in the JAX package (webdataset
is not a dependency); FLAC needs ``soundfile``. The randomness is numpy's
``default_rng`` with the JAX package's seeds (``seed + epoch`` for the
shard order, ``seed * 1000 + epoch`` for crops, fusion chunks and caption
picks), so the port yields the JAX package's batches bit for bit. Each
clip's features come from :func:`~audio_residual_tpu_torch.data.featurize.
get_audio_features`; with ``data_truncating="fusion"`` its ``mel_fusion``
runs K1 on ``device`` (the card unless ``device="cpu"``), one launch a
clip, and the batch carries the stacked ``mel_fusion`` as well (the JAX
package computes it and drops it).
"""

from __future__ import annotations

import io
import json
import logging
import os
import tarfile
import wave
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch

from audio_residual_tpu_torch.data.featurize import get_audio_features

__all__ = [
    "resolve_tar_paths",
    "sample_prop",
    "iter_tar_samples",
    "log_and_continue",
    "select_text",
    "ShardedAudioText",
]


def select_text(json_dict_raw: dict, text_augment_selection: str | None,
                *, text_field: str = "text"):
    """Augmented-text selection (`training/data.py:509-530` semantics).

    - ``None``/``"none"``: the raw text.
    - ``"all"``: ``text_augment_all`` when the shard carries it, else raw.
    - ``"augment_only"``: when ``text_augment_all`` is present, take
      ``text_augment_t5`` unless it is None (then raw); shards without
      augmentation fall back to raw.
    - anything else raises ``NotImplementedError`` like the reference.

    ``text_field`` generalises the raw-text key ("text" in the reference;
    this pipeline also accepts "caption" shards).
    """
    def raw():
        return json_dict_raw.get(text_field) or json_dict_raw.get("caption") or ""

    if text_augment_selection is None or text_augment_selection == "none":
        return raw()
    if text_augment_selection == "all":
        if "text_augment_all" in json_dict_raw:
            return json_dict_raw["text_augment_all"]
        return raw()
    if text_augment_selection == "augment_only":
        if "text_augment_all" in json_dict_raw:
            if json_dict_raw.get("text_augment_t5") is None:
                return raw()
            return json_dict_raw["text_augment_t5"]
        return raw()
    raise NotImplementedError(
        f"text_augment_selection {text_augment_selection} not implemented"
    )


def log_and_continue(exn: Exception) -> bool:
    """Swallow decode errors, keep the pipeline alive (`data.py:321-324`)."""
    logging.warning("Handling dataset error (%r). Ignoring.", exn)
    return True


def resolve_tar_paths(
    root: str, dataset_names: list[str], split: str, *, sizes_file: str = "sizes.json"
) -> tuple[list[str], dict[str, int]]:
    """Shard discovery from per-dataset ``sizes.json``
    (`clap_module/utils.py:113-151`): returns tar paths + sample counts."""
    paths, sizes = [], {}
    for name in dataset_names:
        d = os.path.join(root, name, split)
        sj = os.path.join(d, sizes_file)
        if os.path.exists(sj):
            with open(sj) as f:
                size_map = json.load(f)
            for tar, n in size_map.items():
                p = os.path.join(d, tar)
                paths.append(p)
                sizes[p] = int(n)
        elif os.path.isdir(d):
            for tar in sorted(os.listdir(d)):
                if tar.endswith(".tar"):
                    p = os.path.join(d, tar)
                    paths.append(p)
                    sizes[p] = -1
    return paths, sizes


def sample_prop(paths: list[str], sizes: dict[str, int], proportion: float, seed: int = 0):
    """Subsample shards to a proportion of the dataset (`data.py:333-360`)."""
    if proportion >= 1.0:
        return paths, sum(max(sizes.get(p, 0), 0) for p in paths)
    rng = np.random.default_rng(seed)
    k = max(1, int(round(len(paths) * proportion)))
    chosen = list(rng.choice(paths, k, replace=False))
    return chosen, sum(max(sizes.get(p, 0), 0) for p in chosen)


def _decode_audio(name: str, data: bytes) -> np.ndarray:
    if name.endswith(".wav"):
        with wave.open(io.BytesIO(data), "rb") as w:
            raw = w.readframes(w.getnframes())
            width = w.getsampwidth()
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
            x = np.frombuffer(raw, dtype=dtype).reshape(-1, w.getnchannels())
            if width == 1:
                return ((x.astype(np.float32) - 128.0) / 128.0).mean(-1)
            return (x.astype(np.float32) / np.iinfo(dtype).max).mean(-1)
    if name.endswith(".flac"):
        try:
            import soundfile as sf

            data_arr, _ = sf.read(io.BytesIO(data), dtype="float32", always_2d=True)
            return data_arr.mean(-1)
        except ImportError as e:
            raise RuntimeError("FLAC decode requires soundfile") from e
    raise ValueError(f"unsupported audio extension: {name}")


def iter_tar_samples(tar_path: str, handler: Callable = log_and_continue) -> Iterator[dict]:
    """Group tar members by key prefix into {audio, json} samples
    (tarfile_to_samples + decode)."""
    try:
        tf = tarfile.open(tar_path)
    except Exception as e:  # corrupt tar
        if handler(e):
            return
        raise
    current_key, parts = None, {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            key, _, ext = base.partition(".")
            if current_key is not None and key != current_key and parts:
                yield from _emit(parts, handler)
                parts = {}
            current_key = key
            parts["." + ext] = tf.extractfile(member).read()
            parts["__key__"] = key
        if parts:
            yield from _emit(parts, handler)
    finally:
        tf.close()


def _emit(parts: dict, handler: Callable) -> Iterator[dict]:
    try:
        audio_bytes = None
        audio_name = None
        for ext in (".flac", ".wav"):
            if ext in parts:
                audio_bytes, audio_name = parts[ext], ext
                break
        if audio_bytes is None:
            return
        sample = {
            "__key__": parts.get("__key__", ""),
            "audio": _decode_audio(audio_name, audio_bytes),
        }
        if ".json" in parts:
            sample["json"] = json.loads(parts[".json"])
        yield sample
    except Exception as e:
        if not handler(e):
            raise


@dataclass
class ShardedAudioText:
    """Sharded audio-text pipeline -> fixed-shape batches: ``waveform``
    ``[B, max_len]`` f32, ``longer`` ``[B]``, ``text``, ``input_ids`` (and
    ``attention_mask``) as numpy; with fusion ``mel_fusion`` ``[B, 4,
    frames, n_mels]`` on ``device``.

    One instance per (node, worker); ``num_nodes``/``node_rank`` stride-split
    the shard list (split_by_node), ``batches_per_epoch`` equalises the
    ranks (``with_epoch``) and drops the last partial batch.
    """

    tar_paths: list[str]
    tokenize: Callable
    batch_size: int = 32
    max_len: int = 480000
    data_truncating: str = "rand_trunc"
    data_filling: str = "pad"
    audio_cfg: dict | None = None
    num_nodes: int = 1
    node_rank: int = 0
    seed: int = 0
    batches_per_epoch: int | None = None
    text_field: str = "text"
    # `--text-augment-selection` (`params.py:547-550`): None/"none"/"all"/
    # "augment_only"; honored per-sample via :func:`select_text`
    text_augment_selection: str | None = None
    device: str | torch.device | None = None  # where a fusion mel runs

    def _node_shards(self, epoch: int) -> list[str]:
        rng = np.random.default_rng(self.seed + epoch)  # detshuffle
        order = list(rng.permutation(self.tar_paths))
        return order[self.node_rank :: self.num_nodes]

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed * 1000 + epoch)
        buf_wav, buf_long, buf_text, buf_mel = [], [], [], []
        emitted = 0
        for tar in self._node_shards(epoch):
            for sample in iter_tar_samples(tar):
                s = get_audio_features(
                    {}, sample["audio"], max_len=self.max_len,
                    data_truncating=self.data_truncating,
                    data_filling=self.data_filling,
                    audio_cfg=self.audio_cfg, rng=rng, device=self.device,
                )
                text = ""
                if "json" in sample:
                    text = select_text(
                        sample["json"], self.text_augment_selection,
                        text_field=self.text_field,
                    )
                    if isinstance(text, list):
                        text = text[int(rng.integers(len(text)))] if text else ""
                buf_wav.append(s["waveform"])
                buf_long.append(s["longer"])
                buf_text.append(text)
                if "mel_fusion" in s:
                    buf_mel.append(s["mel_fusion"])
                if len(buf_wav) == self.batch_size:
                    yield self._collate(buf_wav, buf_long, buf_text, buf_mel)
                    emitted += 1
                    buf_wav, buf_long, buf_text, buf_mel = [], [], [], []
                    if self.batches_per_epoch and emitted >= self.batches_per_epoch:
                        return
        if buf_wav and not self.batches_per_epoch:
            yield self._collate(buf_wav, buf_long, buf_text, buf_mel)

    def _collate(self, wavs, longs, texts, mels) -> dict:
        enc = self.tokenize(texts)
        batch = {
            "waveform": np.stack(wavs),
            "longer": np.asarray(longs),
            "text": list(texts),
        }
        if mels:
            batch["mel_fusion"] = torch.stack(mels)
        if isinstance(enc, dict):
            batch["input_ids"] = np.asarray(enc["input_ids"])
            batch["attention_mask"] = np.asarray(enc["attention_mask"])
        else:
            batch["input_ids"] = np.asarray(enc)
        return batch
