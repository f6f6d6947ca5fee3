"""The kernels' build cache, from ``audio_residual_tpu/utils/cache.py``.

The JAX package points XLA's persistent compile cache at a directory. Here
what is compiled is the CUDA sources, once each by ``nvcc``
(``ops/cuda/build.py``), and the cache is the directory of the built
libraries. Their names are hashes of the sources and flags, so checkouts
can share one directory. The JAX function's ``min_compile_secs`` has no
counterpart: every source is cached.
"""

from __future__ import annotations

import os

from audio_residual_tpu_torch.ops.cuda import build

__all__ = ["enable_compile_cache"]


def enable_compile_cache(cache_dir: str | None = None) -> str:
    """Build and load the kernels in ``cache_dir`` (default: the
    ``ART_COMPILE_CACHE`` variable, else
    ``~/.cache/audio_residual_tpu_torch/kernels``) and return it. Call it
    before the first kernel loads: :func:`build.set_build_dir` raises once a
    library is loaded from another directory."""
    cache_dir = cache_dir or os.environ.get(
        "ART_COMPILE_CACHE", os.path.expanduser("~/.cache/audio_residual_tpu_torch/kernels"))
    os.makedirs(cache_dir, exist_ok=True)
    build.set_build_dir(cache_dir)
    return cache_dir
