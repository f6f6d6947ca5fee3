"""Dataset registry, local archives, WAV decode, resampling and K-fold splits.

Port of ``audio_residual_tpu/data/datasets.py`` (the reference's
``download_utils.py`` and ``audio_dataset.py:58-106``). Batches are numpy
``(wav [B, T], label [B])`` pairs, variable lengths right-padded to the
batch's longest clip (``pad_collate``); featurization happens in the
embedding step. Fold order, shuffles (``np.random.default_rng(fold)``) and
batches are the JAX package's.

Differences by design:
  * the metadata CSV is read with :mod:`csv` (no pandas): a frame is a dict
    of columns, ``filename`` (list), ``target`` and ``fold`` (int arrays);
  * :func:`download_dataset` downloads nothing: it extracts an archive that
    is already on disk, and otherwise raises :class:`FileNotFoundError`
    naming the path and the URL;
  * :func:`load_wav` decodes PCM WAV with :mod:`wave` and the port's C
    decoder (:mod:`audio_residual_tpu_torch.native`; 8-bit in numpy), not
    soundfile or librosa;
  * :func:`resample_poly` computes the JAX package's function (zero-stuff by
    ``up``, the same windowed-sinc ``h``, ``np.convolve(mode="same")``,
    keep every ``down``-th sample) in polyphase form: only the nonzero
    stuffed samples and the kept outputs are summed. The direct form costs
    about 140 s of CPU time for one 5 s ESC-50 clip at 44.1 -> 48 kHz
    (up = 160, 10 241 taps over 160x the samples).
"""

from __future__ import annotations

import csv
import os
import tarfile
import wave
import zipfile
from typing import Callable, Iterator

import numpy as np

from audio_residual_tpu_torch import native

__all__ = ["DATASETS", "download_dataset", "get_dataframe", "load_wav", "resample_poly",
           "AudioDataset", "get_fold_batches", "get_fold_loaders", "pad_collate",
           "class_prompts"]

ESC_50_CLASS_LABELS = [
    "dog", "rooster", "pig", "cow", "frog", "cat", "hen", "insects",
    "sheep", "crow", "rain", "sea_waves", "crackling_fire", "crickets",
    "chirping_birds", "water_drops", "wind", "pouring_water", "toilet_flush",
    "thunderstorm", "crying_baby", "sneezing", "clapping", "breathing",
    "coughing", "footsteps", "laughing", "brushing_teeth", "snoring",
    "drinking_sipping", "door_wood_knock", "mouse_click", "keyboard_typing",
    "door_wood_creaks", "can_opening", "washing_machine", "vacuum_cleaner",
    "clock_alarm", "clock_tick", "glass_breaking", "helicopter", "chainsaw",
    "siren", "car_horn", "engine", "train", "church_bells", "airplane",
    "fireworks", "hand_saw",
]

URBAN_SOUND_CLASS_LABELS = [
    "air_conditioner", "car_horn", "children_playing", "dog_bark", "drilling",
    "engine_idling", "gun_shot", "jackhammer", "siren", "street_music",
]

DATASETS = {
    "ESC50": {
        "url": "https://github.com/karoldvl/ESC-50/archive/master.zip",
        "out_dir": "data/esc50.zip",
        "audio_dir": "data/esc50/ESC-50-master/audio/",
        "csv_path": "data/esc50/ESC-50-master/meta/esc50.csv",
        "columns": {"file_column": "filename", "label_column": "target", "fold_column": "fold"},
        "class_labels": ESC_50_CLASS_LABELS,
        "n_folds": 5,
        "audio_len": 5,
    },
    "UrbanSound8K": {
        "url": "https://zenodo.org/record/1203745/files/UrbanSound8K.tar.gz",
        "out_dir": "data/urbansound.tar.gz",
        "audio_dir": "data/urbansound/UrbanSound8K/audio/",
        "csv_path": "data/urbansound/UrbanSound8K/metadata/UrbanSound8K.csv",
        "columns": {"file_column": "slice_file_name", "label_column": "classID",
                    "fold_column": "fold"},
        "class_labels": URBAN_SOUND_CLASS_LABELS,
        "n_folds": 10,
        "audio_len": (1, 4),
    },
}


def class_prompts(dataset: str, template: str = "This is a sound of {}.") -> list[str]:
    """Zero-shot prompts, underscores read as spaces."""
    return [template.format(c.replace("_", " ")) for c in DATASETS[dataset]["class_labels"]]


def download_dataset(url: str, dest_path: str) -> str:
    """The extracted directory of the archive ``dest_path``
    (`download_utils.py:49-93`), extracting it when it is on disk; raises
    :class:`FileNotFoundError` with the path and ``url`` when it is not (the
    port downloads nothing)."""
    if dest_path.endswith(".zip"):
        extract_path = os.path.splitext(dest_path)[0]
    elif dest_path.endswith((".tar.gz", ".tgz")):
        extract_path = dest_path.rsplit(".tar.gz", 1)[0].rsplit(".tgz", 1)[0]
    else:
        extract_path = dest_path
    if os.path.isdir(extract_path) and extract_path != dest_path:
        return extract_path
    if not os.path.exists(dest_path):
        raise FileNotFoundError(f"{dest_path} not found; the port downloads nothing: fetch "
                                f"{url} and place it there")
    if dest_path.endswith(".zip"):
        with zipfile.ZipFile(dest_path) as z:
            z.extractall(extract_path)
    elif extract_path != dest_path:
        with tarfile.open(dest_path) as t:
            t.extractall(extract_path)
    return extract_path


def get_dataframe(dataset: str, root: str = ".") -> dict:
    """``{"filename": [...], "target": int array, "fold": int array}`` from
    the dataset's metadata CSV (`download_utils.py:96-130`), extracting the
    archive first when only it is there. UrbanSound8K's files live in
    ``fold{n}/``."""
    spec = DATASETS[dataset]
    csv_path = os.path.join(root, spec["csv_path"])
    if not os.path.exists(csv_path):
        download_dataset(spec["url"], os.path.join(root, spec["out_dir"]))
    cols = spec["columns"]
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    out = {"filename": [r[cols["file_column"]] for r in rows],
           "target": np.array([int(r[cols["label_column"]]) for r in rows], np.int64),
           "fold": np.array([int(r[cols["fold_column"]]) for r in rows], np.int64)}
    if dataset == "UrbanSound8K":
        out["filename"] = [f"fold{k}/{name}" for k, name in zip(out["fold"], out["filename"])]
    return out


def load_wav(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """A PCM WAV file -> ``(mono f32 [T], sample rate)``, resampled to
    ``target_sr`` when it is given: 16- and 32-bit through the C decoder
    (``sample / 2**15`` or ``/ 2**31``), 8-bit as ``(sample - 128) / 128``;
    the mean over channels."""
    with wave.open(path, "rb") as w:
        sr, ch, width = w.getframerate(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        wav_data = native.pcm16_to_float32_mono(raw, ch)
    elif width == 4:
        wav_data = native.pcm32_to_float32_mono(raw, ch)
    elif width == 1:
        x = np.frombuffer(raw, dtype=np.uint8).reshape(-1, ch)
        wav_data = ((x.astype(np.float32) - 128.0) / 128.0).mean(axis=1)
    else:
        raise ValueError(f"{path}: {8 * width}-bit PCM is not supported")
    if target_sr is not None and target_sr != sr:
        wav_data = resample_poly(wav_data, sr, target_sr)
        sr = target_sr
    return wav_data.astype(np.float32), sr


def _resample_filter(up: int, down: int) -> np.ndarray:
    """The JAX package's windowed sinc: ``64 max(up, down)`` taps (+1),
    cutoff ``0.5 / max(up, down)``, Hamming window, gain ``up``."""
    n_taps = 64 * max(up, down)
    cutoff = 0.5 / max(up, down)
    t = np.arange(-n_taps // 2, n_taps // 2 + 1)
    return 2 * cutoff * np.sinc(2 * cutoff * t) * np.hamming(len(t)) * up


RESAMPLE_CHUNK = 16384  # outputs summed at a time: a [chunk, taps / up] float64 gather


def resample_poly(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Resample ``x [T]`` from ``sr_in`` to ``sr_out``: the JAX package's
    function (module docstring) in float64, summed in polyphase form,
    ``RESAMPLE_CHUNK`` outputs at a time; f32 out."""
    if sr_in == sr_out:
        return x
    g = np.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    h = _resample_filter(up, down)
    taps = len(h)
    n_up = len(x) * up
    # np.convolve(mode="same") keeps max(M, L) samples of the full
    # convolution from (min(M, L) - 1) // 2 on; keep every down-th of those
    off = (min(n_up, taps) - 1) // 2
    m = np.arange(0, max(n_up, taps), down) + off
    width = -(-taps // up)  # nonzero stuffed samples under the filter, at most
    hp = np.zeros((up, width))
    for q in range(up):
        hp[q, : len(h[q::up])] = h[q::up]
    xp = np.concatenate([np.zeros(width), np.asarray(x, np.float64), np.zeros(2 * width)])
    out = np.empty(len(m), np.float64)
    t = np.arange(width)
    for s in range(0, len(m), RESAMPLE_CHUNK):
        mr = m[s: s + RESAMPLE_CHUNK]
        base, q = mr // up, mr % up
        # out[r] = sum_t h[q + up t] x[base - t]; x outside [0, T) is 0
        out[s: s + RESAMPLE_CHUNK] = (hp[q] * xp[width + base[:, None] - t[None, :]]).sum(-1)
    return out.astype(np.float32)


class AudioDataset:
    """Raw waveforms over a frame of :func:`get_dataframe`'s layout
    (`audio_dataset.py:8-54`): item ``i`` is ``(wav, target)``."""

    def __init__(self, df: dict, audio_dir: str, target_sr: int | None = None):
        self.df = df
        self.audio_dir = audio_dir
        self.target_sr = target_sr

    def __len__(self) -> int:
        return len(self.df["filename"])

    def __getitem__(self, i: int) -> tuple[np.ndarray, int]:
        wav_data, _ = load_wav(os.path.join(self.audio_dir, self.df["filename"][i]),
                               self.target_sr)
        return wav_data, int(self.df["target"][i])


def _rows(df: dict, keep: np.ndarray) -> dict:
    idx = np.flatnonzero(keep)
    return {"filename": [df["filename"][i] for i in idx], "target": df["target"][idx],
            "fold": df["fold"][idx]}


def pad_collate(batch: list[tuple[np.ndarray, int]]) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad to the batch's longest clip (`audio_dataset.py:89-106`)."""
    max_len = max(len(w) for w, _ in batch)
    wav_data = np.zeros((len(batch), max_len), np.float32)
    labels = np.empty((len(batch),), np.int64)
    for i, (w, y) in enumerate(batch):
        wav_data[i, : len(w)] = w
        labels[i] = y
    return wav_data, labels


def get_fold_batches(dataset: AudioDataset, batch_size: int = 8, *, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = False) -> Callable[[], Iterator]:
    """A batch generator factory, re-iterable each epoch; the shuffle is
    ``np.random.default_rng(seed)``'s, as in the JAX package."""

    def gen():
        rng = np.random.default_rng(seed)
        idx = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(idx)
        end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        for i in range(0, end, batch_size):
            yield pad_collate([dataset[j] for j in idx[i: i + batch_size]])

    return gen


def get_fold_loaders(dataset_name: str, root: str = ".", batch_size: int = 8,
                     target_sr: int = 48000) -> list[tuple[Callable, Callable]]:
    """Per fold ``(train_batches, val_batches)`` over the dataset's own fold
    column (`audio_dataset.py:58-87`); train shuffled with the fold number as
    the seed."""
    spec = DATASETS[dataset_name]
    df = get_dataframe(dataset_name, root)
    audio_dir = os.path.join(root, spec["audio_dir"])
    out = []
    for f in sorted(set(df["fold"].tolist())):
        train_ds = AudioDataset(_rows(df, df["fold"] != f), audio_dir, target_sr)
        val_ds = AudioDataset(_rows(df, df["fold"] == f), audio_dir, target_sr)
        out.append((get_fold_batches(train_ds, batch_size, shuffle=True, seed=int(f)),
                    get_fold_batches(val_ds, batch_size, shuffle=False)))
    return out
