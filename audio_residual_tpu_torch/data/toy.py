"""ToyDataset: h5py-backed AudioSet-style fixture with class-balanced queue,
from ``audio_residual_tpu/data/toy.py`` (numpy and h5py only; h5py is
imported where a file is read or written).

Reference: `training/data.py:112-250` — the de-facto test fixture selectable
via ``--dataset-type toy``: reads waveform/target pairs from an h5 file,
regenerates a class-balanced sample queue each epoch, and synthesises text
prompts from the AudioSet label map ("The sounds of <label1>, <label2>...").

Includes :func:`make_toy_h5` to synthesise the fixture files themselves (the
reference assumed pre-existing AudioSet h5 dumps).
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_toy_h5", "ToyDataset"]


def make_toy_h5(
    path: str,
    *,
    num_samples: int = 64,
    num_classes: int = 10,
    clip_samples: int = 24000,
    seed: int = 0,
) -> str:
    import h5py

    rng = np.random.default_rng(seed)
    targets = np.zeros((num_samples, num_classes), np.bool_)
    for i in range(num_samples):
        k = rng.integers(1, 3)
        targets[i, rng.choice(num_classes, k, replace=False)] = True
    with h5py.File(path, "w") as f:
        f.create_dataset(
            "waveform", data=(rng.standard_normal((num_samples, clip_samples)) * 0.1).astype(np.float32)
        )
        f.create_dataset("target", data=targets)
        f.create_dataset(
            "audio_name", data=np.array([f"clip_{i}.wav".encode() for i in range(num_samples)])
        )
    return path


class ToyDataset:
    """Class-balanced sampler over an h5 fixture (`data.py:112-250`).

    ``eval_mode=False`` regenerates a balanced queue per epoch: one random
    clip per class, cycling classes (`generate_queue`, `data.py:146-170`).
    """

    def __init__(self, h5_path: str, *, class_names: list[str] | None = None,
                 eval_mode: bool = False, seed: int = 0,
                 ipc_path: str | None = None):
        import h5py

        self.fp = h5py.File(h5_path, "r")
        self.waveforms = self.fp["waveform"]
        self.targets = np.asarray(self.fp["target"])
        self.num_classes = self.targets.shape[1]
        self.class_names = class_names or [f"class {i}" for i in range(self.num_classes)]
        self.eval_mode = eval_mode
        self.rng = np.random.default_rng(seed)
        self.total_size = len(self.waveforms)
        # `--train-ipc`/`--val-ipc` (`params.py:40-50`, consumed at
        # `data.py:129`): npy of per-class sample-index arrays driving the
        # balanced queue. Default None derives the same structure from the
        # h5 targets (the npy the reference ships is exactly that).
        self.ipc = (
            np.load(ipc_path, allow_pickle=True) if ipc_path is not None else None
        )
        self.queue: list[int] = []
        self.generate_queue()

    def generate_queue(self):
        if self.eval_mode:
            self.queue = list(range(self.total_size))
            return
        per_class = (
            [np.asarray(c, dtype=np.int64) for c in self.ipc]
            if self.ipc is not None
            else [np.flatnonzero(self.targets[:, c]) for c in range(self.num_classes)]
        )
        self.queue = []
        while len(self.queue) < self.total_size:
            order = self.rng.permutation(len(per_class))
            for c in order:
                if len(per_class[c]) and len(self.queue) < self.total_size:
                    self.queue.append(int(self.rng.choice(per_class[c])))

    def text_for(self, idx: int) -> str:
        labels = [self.class_names[c] for c in np.flatnonzero(self.targets[idx])]
        return "The sounds of " + ", ".join(labels)

    def __len__(self):
        return self.total_size

    def __getitem__(self, i: int) -> dict:
        idx = self.queue[i]
        return {
            "waveform": np.asarray(self.waveforms[idx], np.float32),
            "target": self.targets[idx].astype(np.float32),
            "text": self.text_for(idx),
            "audio_name": f"clip_{idx}.wav",
        }

    def batches(self, batch_size: int):
        for i in range(0, len(self), batch_size):
            items = [self[j] for j in range(i, min(i + batch_size, len(self)))]
            yield {
                "waveform": np.stack([it["waveform"] for it in items]),
                "target": np.stack([it["target"] for it in items]),
                "text": [it["text"] for it in items],
            }
