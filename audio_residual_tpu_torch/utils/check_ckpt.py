"""Checkpoint diff tool, from ``audio_residual_tpu/utils/check_ckpt.py`` (the
reference's `CLAP/src/tests/check_ckpt.py:3-28`): list two checkpoints' keys
and their per-key max-abs differences under include and exclude filters, the
tool for "did training change what I froze" and checkpoint compatibility.

It reads the port's ``.pt`` checkpoints (``training/checkpoints.py``, whose
``state_dict`` it compares), reference ``.pt`` files, state dicts (flat or
nested) and ``nn.Module``\\ s (a sharded parameter counts in full). A
directory, the JAX package's orbax checkpoint, is refused: the port writes
none, and the JAX package's own tool reads them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from audio_residual_tpu_torch.models.convert import load_torch_checkpoint

__all__ = ["keys_in_state_dict", "check_ckpt_diff", "flatten_params"]


def _array(t) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _load_any(ckpt) -> dict[str, np.ndarray]:
    if isinstance(ckpt, nn.Module):
        return flatten_params(ckpt.state_dict())
    if isinstance(ckpt, dict):
        sd = ckpt["state_dict"] if isinstance(ckpt.get("state_dict"), dict) else ckpt
        return flatten_params({k.removeprefix("module."): v for k, v in sd.items()})
    if isinstance(ckpt, (str, os.PathLike)):
        if os.path.isdir(ckpt):
            raise ValueError(f"{ckpt} is a directory, an orbax checkpoint of the JAX package; "
                             "the port writes none: compare it with "
                             "audio_residual_tpu.utils.check_ckpt")
        return {k: _array(v) for k, v in load_torch_checkpoint(ckpt).items()}
    raise TypeError(type(ckpt))


def flatten_params(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A (nested) dict or list of tensors or arrays -> ``{dotted name:
    array}``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix[:-1]] = _array(tree)
    return out


def keys_in_state_dict(ckpt, key_include: str = "", key_exclude: str = "") -> list[str]:
    """The checkpoint's keys with substring filters (`check_ckpt.py:3`)."""
    keys = list(_load_any(ckpt))
    if key_include:
        keys = [k for k in keys if key_include in k]
    if key_exclude:
        keys = [k for k in keys if key_exclude not in k]
    return keys


def check_ckpt_diff(ckpt_a, ckpt_b, key_include: str = "", key_exclude: str = "", *,
                    verbose: bool = True) -> dict[str, float]:
    """Per-key max-abs difference between two checkpoints (`check_ckpt.py:11-28`),
    in float64; a key in only one of them, or of two shapes, gives ``inf``."""
    a, b = _load_any(ckpt_a), _load_any(ckpt_b)
    keys = set(a) | set(b)
    if key_include:
        keys = {k for k in keys if key_include in k}
    if key_exclude:
        keys = {k for k in keys if key_exclude not in k}
    diffs = {}
    for k in sorted(keys):
        if k not in a or k not in b or a[k].shape != b[k].shape:
            diffs[k] = float("inf")
        elif a[k].size:
            diffs[k] = float(np.max(np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))))
        else:
            diffs[k] = 0.0
        if verbose and diffs[k] != 0.0:
            print(f"{k}: {diffs[k]:.3e}")
    return diffs
