"""Misc utilities, from ``audio_residual_tpu/utils/misc.py`` (the reference's
`clap_module/utils.py`): mixup (`:189-208`), class-label loading
(`:348-362`), the dataset-split registry (`:14-59`) and the training loop's
batch prefetch, the log re-parser (`:265-300`) and the BatchNorm freeze
mask (`:62-100`). The JAX package's optax optimizer mux is
:mod:`audio_residual_tpu_torch.training.train_clap`'s ``make_optimizer``
here."""

from __future__ import annotations

import json
import pickle
import re

import numpy as np
import torch

__all__ = ["get_mix_lambda", "do_mixup", "load_class_label", "dataset_split",
           "prefetch_batches", "get_data_from_log", "bn_freeze_mask"]


def prefetch_batches(iterable, depth: int | None):
    """Batches of ``iterable`` produced ``depth`` ahead by a background
    thread (``--prefetch-factor``), in order; an exception of the producer
    re-raises in the consumer. ``depth`` None or <= 0 yields the iterable
    unchanged."""
    if not depth or depth <= 0:
        yield from iterable
        return
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    end, err = object(), object()

    def produce():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 -- re-raised by the consumer
            q.put((err, e))
            return
        q.put(end)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, tuple) and len(item) == 2 and item[0] is err:
            raise item[1]
        yield item


# webdataset split registry (`clap_module/utils.py:14-59`): dataset name ->
# its split names
dataset_split = {
    "audiocaps": ["train", "valid", "test"],
    "audioset": ["balanced_train", "unbalanced_train", "eval"],
    "BBCSoundEffects": ["train", "test"],
    "Clotho": ["train", "test", "valid"],
    "free_to_use_sounds": ["train", "test"],
    "paramount_motion": ["train", "test"],
    "sonniss_game_effects": ["train", "test"],
    "wesoundeffects": ["train", "test"],
    "MACS": ["train", "test"],
    "freesound": ["train", "test"],
    "FSD50K": ["train", "test", "valid"],
    "fsd50k_class_label": ["train", "test", "valid"],
    "esc50": ["train", "test"],
    "ESC50_1": ["train", "test"],
    "ESC50_2": ["train", "test"],
    "ESC50_3": ["train", "test"],
    "ESC50_4": ["train", "test"],
    "ESC50_5": ["train", "test"],
    "audiostock": ["train", "test"],
    "freesound_no_overlap_noesc50": ["train", "test"],
    "epidemic_sound_effects": ["train", "test"],
    "VGGSound": ["train", "test"],
    "urbansound8k_class_label": ["train", "test"],
    "audioset_t5": ["balanced_train", "unbalanced_train", "eval"],
    "epidemic_sound_effects_t5": ["train", "test"],
    "WavText5K": ["train", "test"],
    "esc50_no_overlap": ["train", "test"],
    "usd8k_no_overlap": ["train", "test"],
    "fsd50k_200_class_label": ["train", "test", "valid"],
}


def get_mix_lambda(mixup_alpha: float, batch_size: int,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Beta-sampled mixup coefficients (`utils.py:189-193`)."""
    rng = rng or np.random.default_rng()
    return rng.beta(mixup_alpha, mixup_alpha, batch_size).astype(np.float32)


def do_mixup(x: torch.Tensor, mixup_lambda: torch.Tensor) -> torch.Tensor:
    """Mix each sample with the batch-reversed sample (`utils.py:196-208`):
    ``out = x * lam + flip(x) * (1 - lam)``."""
    lam = mixup_lambda.reshape((-1,) + (1,) * (x.ndim - 1))
    return x * lam + torch.flip(x, dims=(0,)) * (1.0 - lam)


def load_class_label(path: str | None):
    """Class-label index loader (`utils.py:348-362`): pkl / json / npy / csv
    -> a ``{name: idx}`` dict or an array. A pickle is read only from a
    path the caller names (``--class-label-path``)."""
    if path is None:
        return None
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            return pickle.load(f)
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith((".npy", ".npz")):
        return np.load(path, allow_pickle=True)
    if path.endswith(".csv"):
        import pandas as pd

        return pd.read_csv(path)
    raise ValueError(f"unsupported class-label file {path}")


def get_data_from_log(txt_path: str) -> dict:
    """Train and eval metrics parsed back out of a log file
    (`utils.py:265-300`): ``{key: {epoch: value}}`` from the ``key: value``
    pairs of each line, the epoch from the last ``Epoch N`` seen."""
    out: dict = {}
    epoch = None
    with open(txt_path) as f:
        for line in f:
            m = re.search(r"[Ee]poch[:\s]+(\d+)", line)
            if m:
                epoch = int(m.group(1))
            for key, val in re.findall(r"(\w[\w@/-]*):\s*(-?\d+\.?\d*(?:e-?\d+)?)", line):
                if key.lower() == "epoch":
                    continue
                out.setdefault(key, {})[epoch] = float(val)
    return out


def bn_freeze_mask(model: torch.nn.Module) -> dict[str, bool]:
    """``{parameter name: trainable}`` over ``model.named_parameters()``,
    ``False`` for the scale and shift of every BatchNorm (a module with
    ``running_mean`` and ``running_var``): the counterpart of
    ``freeze_batch_norm_2d`` (`clap_module/utils.py:62-100`). Apply it with
    ``requires_grad_`` or as a zero-lr group; eval statistics are already
    what the port's BatchNorms use outside training."""
    frozen = {f"{name}.{p}" if name else p
              for name, m in model.named_modules()
              if hasattr(m, "running_mean") and hasattr(m, "running_var")
              for p, _ in m.named_parameters(recurse=False)}
    return {name: name not in frozen for name, _ in model.named_parameters()}
