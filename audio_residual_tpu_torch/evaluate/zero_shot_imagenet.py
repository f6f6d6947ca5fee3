"""ImageNet zero-shot evaluation (open_clip lineage).

Port of ``audio_residual_tpu/evaluate/zero_shot_imagenet.py``.

Reference: `training/zero_shot.py:13-91` and the 1000-class / 80-template
tables of `training/imagenet_zeroshot_data.py` (dead code there: "currently
not supported for CLAP"); the JAX package rebuilds it for any text tower,
and so does the port. Numpy over the caller's encoders:

- the classifier embeds all templates of a class in one ``encode_text``
  call (``list[str] -> [N, D]``, e.g. ``CLAPModule.get_text_embedding`` or
  a CLIP's tokenizer + ``clip_encode_text``);
- :func:`run_zero_shot` takes any iterable of ``(images, labels)`` batches
  and an ``encode_image`` callable (NCHW images for the port's towers);
- the tables are data, ``class_labels/imagenet_zeroshot.json`` at the root
  of the checkout (public OpenAI CLIP constants).
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch

__all__ = [
    "load_imagenet_zeroshot_data",
    "zero_shot_classifier",
    "accuracy",
    "run_zero_shot",
    "zero_shot_eval",
]

_DATA_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "class_labels",
    "imagenet_zeroshot.json",
)


def _host(x) -> np.ndarray:
    """An encoder's output (numpy, or a tensor on any device) as f32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def load_imagenet_zeroshot_data(path: str | None = None) -> tuple[list[str], list[str]]:
    """-> (1000 classnames, 80 prompt templates with a ``{}`` slot)."""
    with open(path or _DATA_PATH) as f:
        d = json.load(f)
    return d["classnames"], d["templates"]


def zero_shot_classifier(
    encode_text,
    classnames: list[str],
    templates: list[str],
) -> np.ndarray:
    """Prompt-ensembled classifier (`zero_shot.py:13-27`): for each class,
    embed every template, L2-normalise, average, re-normalise. Returns
    ``[embed_dim, n_classes]`` (the reference's column-stacked layout).

    ``encode_text(list[str]) -> [N, D]`` does its own tokenisation — the
    package's ``CLAPModule.get_text_embedding`` fits directly.
    """
    weights = []
    for classname in classnames:
        texts = [t.format(classname) for t in templates]
        emb = _host(encode_text(texts))  # [T, D]
        emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        mean = emb.mean(axis=0)
        weights.append(mean / np.linalg.norm(mean))
    return np.stack(weights, axis=1)


def accuracy(logits: np.ndarray, target: np.ndarray, topk=(1,)) -> list[float]:
    """Top-k correct COUNTS (`zero_shot.py:30-33` returns sums, not rates)."""
    logits = np.asarray(logits)
    target = np.asarray(target)
    order = np.argsort(-logits, axis=-1)
    return [float((order[:, :k] == target[:, None]).any(axis=-1).sum()) for k in topk]


def run_zero_shot(encode_image, classifier: np.ndarray, batches) -> tuple[float, float]:
    """-> (top1, top5) rates over ``batches`` of (images, labels)
    (`zero_shot.py:36-61`; logits scaled by 100 like the reference)."""
    top1 = top5 = n = 0.0
    for images, target in batches:
        feats = _host(encode_image(images))
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        logits = 100.0 * feats @ classifier
        a1, a5 = accuracy(logits, target, topk=(1, 5))
        top1 += a1
        top5 += a5
        n += len(np.asarray(target))
    return top1 / n, top5 / n


def zero_shot_eval(
    encode_image,
    encode_text,
    data: dict,
    epoch: int,
    *,
    zeroshot_frequency: int = 1,
    epochs: int = 1,
    classnames: list[str] | None = None,
    templates: list[str] | None = None,
) -> dict:
    """Epoch-gated evaluation (`zero_shot.py:64-91`): runs on ``imagenet-val`` /
    ``imagenet-v2`` keys when the epoch matches the cadence."""
    if "imagenet-val" not in data and "imagenet-v2" not in data:
        return {}
    if zeroshot_frequency == 0:
        return {}
    if (epoch % zeroshot_frequency) != 0 and epoch != epochs:
        return {}
    if classnames is None or templates is None:
        classnames, templates = load_imagenet_zeroshot_data()
    logging.info("Starting zero-shot imagenet.")
    classifier = zero_shot_classifier(encode_text, classnames, templates)
    results = {}
    if "imagenet-val" in data:
        top1, top5 = run_zero_shot(encode_image, classifier, data["imagenet-val"])
        results["imagenet-zeroshot-val-top1"] = top1
        results["imagenet-zeroshot-val-top5"] = top5
    if "imagenet-v2" in data:
        top1, top5 = run_zero_shot(encode_image, classifier, data["imagenet-v2"])
        results["imagenetv2-zeroshot-val-top1"] = top1
        results["imagenetv2-zeroshot-val-top5"] = top5
    logging.info("Finished zero-shot imagenet.")
    return results
