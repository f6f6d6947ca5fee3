"""Host-side data kernels in C (``wavio.c``), loaded with ctypes.

Port of ``audio_residual_tpu/native/``, with its own copy of ``wavio.c``:
PCM16 / PCM32 WAV decode with the mono downmix (the JAX copy's int16 round
trip and pad-or-truncate are left out: ``ops/quantize.py`` does that job on
the port's path). The source builds with ``gcc -O3 -shared -fPIC`` at first
use into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), named by the hash of the source; a failed build raises
with the compiler's output (the JAX package falls back to numpy quietly,
the port does not). The ``*_plain`` functions are the numpy versions, the
same arithmetic in the same order, that the tests hold the C against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["library", "pcm16_to_float32_mono", "pcm32_to_float32_mono",
           "pcm16_to_float32_mono_plain", "pcm32_to_float32_mono_plain"]

SOURCE = Path(__file__).resolve().with_name("wavio.c")
BUILD_DIR = SOURCE.parents[2] / "build" / "native"
CFLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)


def _target() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"wavio-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, ptr in (("wav_pcm16_to_float32_mono", ctypes.c_int16),
                      ("wav_pcm32_to_float32_mono", ctypes.c_int32)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.POINTER(ptr), ctypes.c_long, ctypes.c_int, _F32P]
    return lib


def library() -> ctypes.CDLL:
    """The loaded ``wavio`` library, compiled first when stale; raises with
    gcc's output when the build fails."""
    target = _target()
    with _lock:
        if not target.exists():
            gcc = shutil.which("gcc") or shutil.which("cc")
            if gcc is None:
                raise RuntimeError("native/wavio.c: no C compiler (gcc or cc) on PATH")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([gcc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                               capture_output=True, text=True, timeout=120)
            if r.returncode != 0:
                raise RuntimeError(f"native/wavio.c failed to build (rc={r.returncode}):\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, target)
    return _load(str(target))


def _decode(name: str, raw: bytes, channels: int, dtype) -> np.ndarray:
    data = np.frombuffer(raw, dtype=dtype)
    n_frames = len(data) // channels
    out = np.empty(n_frames, np.float32)
    ctype = ctypes.c_int16 if dtype == np.int16 else ctypes.c_int32
    getattr(library(), name)(data.ctypes.data_as(ctypes.POINTER(ctype)), n_frames, channels,
                             out.ctypes.data_as(_F32P))
    return out


def pcm16_to_float32_mono(raw: bytes, channels: int) -> np.ndarray:
    """Interleaved int16 frames -> mono f32 (``sample / 32768``, the mean
    over channels)."""
    return _decode("wav_pcm16_to_float32_mono", raw, channels, np.int16)


def pcm32_to_float32_mono(raw: bytes, channels: int) -> np.ndarray:
    """Interleaved int32 frames -> mono f32 (``sample / 2**31``, the mean
    over channels)."""
    return _decode("wav_pcm32_to_float32_mono", raw, channels, np.int32)


def pcm16_to_float32_mono_plain(raw: bytes, channels: int) -> np.ndarray:
    x = np.frombuffer(raw, dtype=np.int16).reshape(-1, channels).astype(np.float32)
    scale = np.float32(1.0 / 32768.0)
    if channels == 1:
        return x[:, 0] * scale
    acc = np.zeros(len(x), np.float32)
    for c in range(channels):
        acc = acc + x[:, c]
    return acc * scale * (np.float32(1.0) / np.float32(channels))


def pcm32_to_float32_mono_plain(raw: bytes, channels: int) -> np.ndarray:
    x = np.frombuffer(raw, dtype=np.int32).reshape(-1, channels)
    scale = np.float32(1.0 / 2147483648.0)
    acc = np.zeros(len(x), np.float32)
    for c in range(channels):
        acc = acc + x[:, c].astype(np.float32) * scale
    return acc * (np.float32(1.0) / np.float32(channels))
