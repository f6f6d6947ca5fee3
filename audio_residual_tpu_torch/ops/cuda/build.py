"""Build the CUDA sources with ``nvcc`` at first use and bind them with
ctypes; the card-facing helpers every kernel wrapper shares.

Each ``csrc/*.cu`` becomes its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), compiled for ``sm_90a``;
``csrc/*.cuh`` are the headers they share.
All sources build in parallel, one ``nvcc`` each, into ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``); a library is named by
the hash of its sources and flags, so an unchanged source is not rebuilt.

Beside the build: the card's facts (:data:`SMEM_LIMIT`, :data:`H100_SMS`,
:func:`sm_count`), the launch helpers (:func:`stream_of`, :func:`ptr`,
:func:`check_cuda_inputs`) and the per-weight cache of derived tensors
(:func:`derived`: the bf16 copies of :func:`mxu_weights`, the TMA maps of
:func:`weight_map`, the 3xTF32 splits, the padded biases). This module is
the bottom of ``ops/cuda``: it imports none of the kernel modules.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

__all__ = ["build_all", "library", "bind", "check", "stream_of", "ptr",
           "check_cuda_inputs", "set_build_dir", "SMEM_LIMIT", "H100_SMS", "sm_count",
           "store_dtype", "derived", "mxu_weights", "weight_map"]

CSRC = Path(__file__).resolve().with_name("csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

SMEM_LIMIT = 232448  # shared memory a block may use on the H100
H100_SMS = 132

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


BUILD_DIR = CSRC.parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, float]:
    """Compile every stale source, all ``nvcc`` processes started together.
    Returns seconds per built source; raises with the compiler's output."""
    targets = {src.stem: _target(src.stem) for src in sorted(CSRC.glob("*.cu"))}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, started = {}, {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = time.perf_counter()
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    seconds, failures = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - started[name]
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc={proc.returncode})\n{log}")
            continue
        if log.strip():
            print(f"nvcc {name}.cu:\n{log}", flush=True)
        os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def set_build_dir(path) -> None:
    """Build and load the libraries in ``path`` from now on. Raises when a
    library is already loaded from another directory: the process would
    run kernels from two places."""
    global BUILD_DIR
    path = Path(path).resolve()
    with _lock:
        if _libs and path != BUILD_DIR.resolve():
            raise RuntimeError(f"kernels already loaded from {BUILD_DIR}; set the build "
                               "directory before the first kernel runs")
        BUILD_DIR = path


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build_all()
            lib = ctypes.CDLL(str(_target(name)))
            lib.arpu_error_string.argtypes = [ctypes.c_int]
            lib.arpu_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


@functools.lru_cache(maxsize=None)
def bind(lib_name: str, fn_name: str, argspec: str, restype=ctypes.c_int):
    """``argspec``: one letter an argument -- p pointer, i int, f float."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = [_CTYPES[c] for c in argspec]
    fn.restype = restype
    return fn


def check(lib_name: str, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = library(lib_name).arpu_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# the current stream's handle without a Stream object (about 0.1 µs a call
# against 4 on the H100's host); CPU builds of PyTorch lack it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s card."""
    if _raw_stream is not None:
        return _raw_stream(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def check_cuda_inputs(what: str, tensors: dict, float_only: tuple[str, ...] = (),
                      dtypes: tuple[torch.dtype, ...] = (torch.float32, torch.bfloat16)) -> None:
    """Device, dtype, contiguity and autograd checks shared by the wrappers:
    each tensor of ``dtypes``, those named in ``float_only`` float32. A
    sharded tensor (``DTensor``) is refused: its ``data_ptr()`` is this
    rank's shard, not the whole weight."""
    sharded = [name for name, t in tensors.items() if isinstance(t, DTensor)]
    if sharded:
        raise ValueError(f"{what}: {', '.join(sharded)} DTensor; the kernel needs whole "
                         "tensors (run a sharded model through its forward, where FSDP "
                         "gathers its weights)")
    device = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel needs CUDA tensors")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, others on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        allowed = (torch.float32,) if name in float_only else dtypes
        if t.dtype not in allowed:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, expected one of {allowed}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"{what}: {name} requires grad; a kernel entry builds no graph (the wrappers "
                "of K2-K5 and the bf16 GEMM route such inputs through Recompute; K1 has no "
                "backward)"
            )


@functools.lru_cache(maxsize=8)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def store_dtype(x: torch.Tensor, mxu_dtype) -> torch.dtype:
    if mxu_dtype not in (None, torch.bfloat16):
        raise ValueError(f"mxu_dtype must be None or torch.bfloat16, got {mxu_dtype}")
    return x.dtype if mxu_dtype is not None else torch.float32


# (id(tensor), what) -> (weakref to the tensor, its stamp, the derived value)
_derived: dict = {}


def _stamp(t: torch.Tensor) -> tuple:
    return (t._version, t.data_ptr(), t.device, t.dtype, tuple(t.shape), t.stride())


def derived(t: torch.Tensor, what, make):
    """``make(t)``, made once per state of ``t`` and kept while ``t`` lives:
    the kernels' bf16 weight copies and gathered relative-position biases,
    which would otherwise cost every call host time and launches.

    The state is ``t``'s version counter (an in-place update of ``t`` bumps
    it) with its storage address, device, dtype, shape and strides (a
    ``p.data = new`` swap or a move changes them). Not seen: an in-place
    write through ``p.data`` (``p.data.copy_(...)``), which bumps the
    counter of a separate view only. An inference tensor tracks no version,
    and a tensor that requires grad is a weight in training: for both the
    value is made at every call. (In grad mode such a value carries its
    graph; outside it, an optimizer may still update the weight without a
    version bump: ``torch.optim.AdamW(fused=True)`` bumps none, where the
    foreach update does.)"""
    if t.is_inference() or t.requires_grad:
        return make(t)
    key = (id(t), what)
    stamp = _stamp(t)
    hit = _derived.get(key)
    if hit is not None and hit[0]() is t and hit[1] == stamp:
        return hit[2]
    # the entry goes when the tensor does, so a reused id never finds it
    ref = weakref.ref(t, lambda _, key=key, cache=_derived: cache.pop(key, None))
    value = make(t)
    _derived[key] = (ref, stamp, value)
    return value


def mxu_weights(mxu_dtype, *weights) -> tuple:
    """The GEMM weights as the kernels take them: under AMP bf16 copies, made
    once per weight version, so no kernel converts a weight tile and no call
    casts again; otherwise the f32 tensors. (The JAX wrappers cast once per
    call, ``swin_block.py:264-266``.)"""
    if mxu_dtype is None:
        return weights
    return tuple(derived(w, mxu_dtype, lambda t: t.to(mxu_dtype)) for w in weights)


def weight_map(w: torch.Tensor, box_rows: int) -> ctypes.Array:
    """The TMA map of the bf16 weight ``w`` in boxes of ``[box_rows, 64]``,
    made once per state of ``w`` (kept beside it, as :func:`mxu_weights`
    keeps the copy): the AMP kernels of K2-K5 read their weights by TMA."""
    def make(t):
        m = ctypes.create_string_buffer(128)  # a CUtensorMap
        fn = bind("gemm", "arpu_weight_map", "piiip")
        check("gemm", fn(t.data_ptr(), t.shape[0], t.shape[1], box_rows, m), "TMA weight map")
        return m

    return derived(w, ("tma_map", box_rows), make)
