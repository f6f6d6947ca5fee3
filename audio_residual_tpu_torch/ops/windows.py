"""Swin window ops: partition/reverse, SW-MSA mask, relative-position bias.

Port of ``audio_residual_tpu/ops/windows.py``; the static masks and indices
are built in numpy exactly as the reference builds them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "window_partition",
    "window_reverse",
    "shift_window_mask",
    "relative_position_index",
    "gather_relative_bias",
]


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """``[B, H, W, C] -> [B * nWindows, window*window, C]`` (row-major windows)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * (h // window) * (w // window), window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`: ``[B*nW, window*window, C] -> [B, H, W, C]``."""
    nw = (h // window) * (w // window)
    b = windows.shape[0] // nw
    c = windows.shape[-1]
    x = windows.reshape(b, h // window, w // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@functools.lru_cache(maxsize=32)
def shift_window_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask ``[nWindows, window^2, window^2]`` (0 / -100).
    Cached: callers must not write into the returned array."""
    img = np.zeros((h, w), dtype=np.int32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // window, window, w // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=8)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """``[wh*ww, wh*ww]`` indices into the ``[(2wh-1)*(2ww-1), nH]`` bias table.
    Cached: callers must not write into the returned array."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=16)
def _device_index(wh: int, ww: int, device: torch.device) -> torch.Tensor:
    # made once per device: a copy from pageable host memory synchronises the
    # stream, which would stall every Swin block of a forward
    return torch.from_numpy(relative_position_index(wh, ww).reshape(-1)).to(device)


def gather_relative_bias(table: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """``table [(2wh-1)*(2ww-1), nH] -> bias [nH, wh*ww, wh*ww]`` (contiguous)."""
    idx = _device_index(wh, ww, table.device)
    n = wh * ww
    return table.index_select(0, idx).reshape(n, n, -1).permute(2, 0, 1).contiguous()
