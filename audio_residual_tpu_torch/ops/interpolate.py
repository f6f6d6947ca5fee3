"""Resize / frame-interpolation ops with torch's own semantics.

Port of ``audio_residual_tpu/ops/interpolate.py``: the bicubic
``align_corners=True`` stretch of ``reshape_wav2img`` as a fixed ``[out, in]``
matrix applied by a matmul, the antialiased bilinear shrink of the fusion
mel (``featurize.py::fusion_mel``) the same way, and the reference's
frame-repeat upsampling.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["bicubic_matrix", "resize_bicubic_align_corners", "bilinear_matrix",
           "resize_bilinear_antialias", "repeat_frames"]


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel used by torch (Keys, a = -0.75)."""
    at = np.abs(t)
    at2, at3 = at * at, at * at * at
    return np.where(
        at <= 1.0,
        (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=32)
def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense ``[out_size, in_size]`` 1-D cubic resize, ``align_corners=True``,
    border-replicate clamping (torch ``upsample_bicubic2d`` along one axis).
    Cached: callers must not write into the returned array."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m.astype(np.float32)
    scale = (in_size - 1) / (out_size - 1)
    for o in range(out_size):
        x = o * scale
        x0 = int(np.floor(x))
        t = x - x0
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), in_size - 1)
            m[o, idx] += _cubic_kernel(np.array(k - t))
    return m.astype(np.float32)


def resize_bicubic_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[..., H, W] -> [..., out_h, out_w]``, separable; unchanged axes skip.

    Follows the input dtype: a bf16 input (the AMP path) multiplies in bf16
    and returns bf16, an f32 input stays f32."""
    h, w = x.shape[-2], x.shape[-1]
    if h != out_h:
        x = torch.matmul(_device_matrix(h, out_h, x.device, x.dtype), x)
    if w != out_w:
        x = torch.matmul(x, _device_matrix(w, out_w, x.device, x.dtype).t())
    return x


@functools.lru_cache(maxsize=16)
def _device_matrix(n_in: int, n_out: int, device: torch.device, dtype) -> torch.Tensor:
    # made once per device: a copy from pageable host memory synchronises the stream
    return torch.from_numpy(bicubic_matrix(n_in, n_out)).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=32)
def bilinear_matrix(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """Dense ``[out_size, in_size]`` 1-D bilinear resize, ``align_corners=False``;
    with ``antialias`` the triangle filter widens by the scale factor when
    shrinking (torch ``F.interpolate(..., antialias=True)``, torchvision
    ``Resize``). Cached: callers must not write into the returned array."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    support = max(scale, 1.0) if antialias else 1.0
    for o in range(out_size):
        center = (o + 0.5) * scale
        lo = int(np.floor(center - support - 0.5)) + 1
        hi = int(np.ceil(center + support - 0.5)) + 1
        idx = np.arange(lo, hi)
        t = (idx + 0.5 - center) / (scale if antialias and scale > 1 else 1.0)
        w = np.maximum(0.0, 1.0 - np.abs(t))
        keep = w > 0
        idx, w = np.clip(idx[keep], 0, in_size - 1), w[keep]
        if w.sum() > 0:
            w = w / w.sum()
        np.add.at(m[o], idx, w)
    return m.astype(np.float32)


def resize_bilinear_antialias(x: torch.Tensor, out_h: int, out_w: int,
                              antialias: bool = True) -> torch.Tensor:
    """``[..., H, W] -> [..., out_h, out_w]`` f32, separable; unchanged axes
    skip."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.float()
    if h != out_h:
        m = torch.from_numpy(bilinear_matrix(h, out_h, antialias)).to(x.device)
        x = torch.matmul(m, x)
    if w != out_w:
        m = torch.from_numpy(bilinear_matrix(w, out_w, antialias)).to(x.device)
        x = torch.matmul(x, m.t())
    return x


def repeat_frames(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """``[B, T, C] -> [B, T*ratio, C]``, each frame repeated ``ratio`` times."""
    return torch.repeat_interleave(x, ratio, dim=1)
