"""Image pre-processing for the vision towers: ``audio_residual_tpu/data/transforms.py``.

Reference: `clap_module/transform.py:9-30`, torchvision's Compose of
(RandomResizedCrop | Resize + CenterCrop) + RGB + ToTensor + Normalize with
the OpenAI CLIP statistics. torchvision's transforms are PIL-backed and
torchvision is not a dependency, so this is the JAX package's PIL version
(bicubic resampling, the train crop drawn from a ``np.random.Generator``),
returning what ToTensor + Normalize return: a ``[3, H, W]`` f32 tensor
(the JAX package returns the HWC array the NHWC towers take; the same
values transposed).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

__all__ = ["image_transform", "OPENAI_DATASET_MEAN", "OPENAI_DATASET_STD"]

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def _to_pil(image):
    """PIL passthrough; uint8 arrays as-is; float arrays are 0-1 normalized
    by contract (no magnitude guessing — a 0-255-scale float image must be
    converted by the caller)."""
    from PIL import Image

    if isinstance(image, Image.Image):
        return image
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    return Image.fromarray(arr)


def _resize_short_side(img, size: int):
    """torchvision ``Resize(int)``: scale so the SHORT side == size."""
    from PIL import Image

    w, h = img.size
    if min(w, h) == size:
        return img
    if w < h:
        new = (size, int(round(h * size / w)))
    else:
        new = (int(round(w * size / h)), size)
    return img.resize(new, Image.BICUBIC)


def _center_crop(img, size: int):
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def _random_resized_crop(img, size: int, scale, ratio, rng: np.random.Generator):
    """torchvision ``RandomResizedCrop.get_params``: 10 attempts at a random
    area/log-ratio box, else center-crop fallback."""
    from PIL import Image

    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            box = (left, top, left + cw, top + ch)
            return img.resize((size, size), Image.BICUBIC, box=box)
    # fallback: center crop to the in-range aspect closest to the image's
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left = (w - cw) // 2
    top = (h - ch) // 2
    return img.resize((size, size), Image.BICUBIC, box=(left, top, left + cw, top + ch))


def image_transform(
    image_size: int,
    is_train: bool,
    mean: tuple = OPENAI_DATASET_MEAN,
    std: tuple = OPENAI_DATASET_STD,
) -> Callable:
    """-> ``transform(image, rng=None) -> f32 tensor [3, image_size, image_size]``.

    Train: RandomResizedCrop(scale=(0.9, 1.0), bicubic); eval: short-side
    Resize + CenterCrop (`transform.py:15-30`). ``rng`` is only consulted
    for the train crop (a fresh ``default_rng`` if omitted)."""
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)

    def transform(image, rng: np.random.Generator | None = None) -> torch.Tensor:
        img = _to_pil(image).convert("RGB")
        if is_train:
            img = _random_resized_crop(
                img, image_size, (0.9, 1.0), (3.0 / 4.0, 4.0 / 3.0),
                rng if rng is not None else np.random.default_rng(),
            )
        else:
            img = _resize_short_side(img, image_size)
            img = _center_crop(img, image_size)
        arr = np.asarray(img, np.float32) / 255.0  # ToTensor's scaling
        return torch.from_numpy(np.ascontiguousarray(((arr - mean_a) / std_a).transpose(2, 0, 1)))

    return transform
