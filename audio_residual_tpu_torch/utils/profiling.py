"""Profiling, tracing and timing, from ``audio_residual_tpu/utils/profiling.py``.

The JAX package traces with the XLA profiler and times a jitted scan at two
lengths, since a call through its device relay does not wait for the
device. Here :func:`trace` records a ``torch.profiler`` Chrome trace,
:func:`annotate` names a region in it (the port's spans, free while no
profiler records), and :func:`measure_seconds` times calls by CUDA events
on the card (the host's clock on the CPU) at two lengths, the per-call time
taken from the difference, with the JAX package's noise guard.
:func:`time_ms`, :func:`device_events`, :func:`device_profile`,
:func:`profile_until` and :func:`device_busy_ms` are the card's timing
helpers ``chip_smoke.py`` and the tools use;
:func:`htsat_flops_per_clip` and :func:`text_tower_flops_per_sample` count
the forward's operations.
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._pytree import tree_leaves

from audio_residual_tpu_torch.ops.frontend import mel_active_bins

__all__ = ["trace", "annotate", "device_events", "measure_seconds", "measure_throughput",
           "htsat_flops_per_clip", "text_tower_flops_per_sample", "TimingUnreliableError",
           "MIN_SECONDS_PER_CALL", "time_ms", "kernel_group", "device_profile",
           "profile_until", "device_busy_ms"]

# No call of work on the card takes less than a kernel launch (a few
# microseconds); a shorter time per call is the timing loop's own cost.
MIN_SECONDS_PER_CALL = 1e-6


class TimingUnreliableError(RuntimeError):
    """The two-length timing difference never cleared the rep-to-rep
    jitter, or came out below :data:`MIN_SECONDS_PER_CALL`: the workload is
    too small or the machine too noisy for a number to be trusted."""


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (CPU, and the card's
    kernels where there is one) and write it to ``log_dir`` as a Chrome
    trace, ``trace_<pid>_<ns>.json``: ``with trace("/tmp/trace"): step()``.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{time.time_ns()}.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str, index: int | None = None):
    """A named region of the profiler's timeline: a ``record_function``,
    which lands as a ``user_annotation`` on the calling thread, beside the
    kernels it launches. ``index``, when given, is appended to the name.

    While no profiler records (``torch.profiler.profile`` or the autograd
    profiler, both of which set the flag read here on entry), this reads
    one flag and returns a shared no-op context: no ``record_function``, no
    string, so a span site on the hot path costs a flag read."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _autograd_profiler.record_function(name if index is None else f"{name}{index}")


def device_events(prof) -> list:
    """A profiler's device work: its kernels, memcpys and memsets. A span
    recorded with CUDA activity also comes back as a device event over its
    kernels, named as the span on the host; those are left out."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = {e.name for e in events if e.device_type != cuda and e.is_user_annotation}
    return [e for e in events if e.device_type == cuda and e.name not in spans]


def measure_seconds(fn, args, *, iters: int = 10, reps: int = 3,
                    record: list | None = None) -> float:
    """Seconds per call of ``fn(*args)``.

    Each rep times ``n`` calls in a row, by CUDA events when an argument
    (or a leaf of one) lies on the card and by the host's clock otherwise,
    at two lengths (``n = iters`` and ``2 * iters``); the per-call time is
    the difference over ``n``, so what a timing costs once (the events, a
    synchronisation, the first launch's wait) cancels. Each length takes the
    fastest of ``reps`` reps, after one untimed run: a stall (the host's
    process held up, which leaves the card idle behind it) only ever adds
    time, and where it lands in most of the reps of one length, a median
    moves the difference by the stall's whole length. (The JAX function
    takes the median: its scan runs on the device with nothing to wait
    for.) Noise guard: a difference inside the rep-to-rep spread, or under
    :data:`MIN_SECONDS_PER_CALL` a call, is retried at four times the
    length, twice; then :class:`TimingUnreliableError` is raised, never a
    number. ``record``, a list, gets each attempt's length, the two lengths'
    reps and their fastest in seconds (``{"n", "reps_n", "t_n", "reps_2n",
    "t_2n"}``), for a caller that logs how the number came about. (The JAX
    function's ``const_args`` keep weights out of its jitted scan's carry;
    eager calls need no such split.)"""
    cuda = any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(args))

    def run(n: int) -> float:
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        return time.perf_counter() - t0

    def timed(n: int) -> list[float]:
        run(n)
        return [run(n) for _ in range(reps)]

    n = iters
    for _ in range(3):
        reps2, reps1 = timed(2 * n), timed(n)
        t2, t1 = min(reps2), min(reps1)
        spread2, spread1 = max(reps2) - t2, max(reps1) - t1
        delta = t2 - t1
        if record is not None:
            record.append({"n": n, "reps_n": reps1, "t_n": t1, "reps_2n": reps2, "t_2n": t2})
        if delta > max(spread1, spread2) and delta >= n * MIN_SECONDS_PER_CALL:
            return delta / n
        last_n = n
        n *= 4
    raise TimingUnreliableError(
        f"measure_seconds: timing difference {delta * 1e6:.1f}us at {last_n}/{2 * last_n} "
        f"calls did not clear the rep jitter ({spread1 * 1e6:.1f}/{spread2 * 1e6:.1f}us) "
        f"or {MIN_SECONDS_PER_CALL * 1e6:.0f}us a call: workload too small or machine too "
        "noisy for a trustworthy number")


def measure_throughput(forward, example, *, iters: int = 10, batch_axis: int = 0) -> dict:
    """Steady-state timing of ``forward(example)`` by :func:`measure_seconds`:
    ``{seconds_per_iter, items_per_sec}``."""
    dt = measure_seconds(forward, (example,), iters=iters)
    return {"seconds_per_iter": dt, "items_per_sec": example.shape[batch_axis] / dt}


def htsat_flops_per_clip(cfg, clip_samples: int | None = None, *,
                         pallas_frontend: bool = True) -> float:
    """Forward FLOPs of one clip through the zero-shot path (frontend, HTSAT,
    audio projection), a multiply-add counted as 2: every matmul and conv,
    the bicubic time-stretch as a dense matmul; norms, GELU and softmax are
    left out (under 2%), so this is a slight lower bound.
    ``pallas_frontend`` (named as in the JAX package: the fused log-mel
    kernel, K1) counts only the mel-active FFT bins the kernel computes
    (:func:`~audio_residual_tpu_torch.ops.frontend.mel_active_bins`); False
    counts every bin of the plain DFT."""
    t = clip_samples if clip_samples is not None else cfg.clip_samples
    n_fft, hop = cfg.n_fft, cfg.hop_size
    frames = (t + 2 * (n_fft // 2) - n_fft) // hop + 1
    if pallas_frontend:
        lo, hi = mel_active_bins(cfg.frontend_config)
        bins = hi - lo
    else:
        bins = n_fft // 2 + 1
    f = 0.0
    f += frames * 2 * 2 * n_fft * bins  # the STFT as two dense [n_fft -> bins] matmuls
    f += frames * 2 * bins * cfg.mel_bins  # the mel projection
    if frames != cfg.spec_size * cfg.freq_ratio:
        # the bicubic time-stretch: a [target_T, frames] matmul over the mel width
        f += 2 * (cfg.spec_size * cfg.freq_ratio) * frames * cfg.mel_bins
    grid = cfg.spec_size // cfg.patch_stride[0]
    in_ch = 4 if getattr(cfg, "enable_fusion", False) and "2d" in str(
        getattr(cfg, "fusion_type", "")) else 1
    f += 2 * grid * grid * cfg.embed_dim * cfg.patch_size * cfg.patch_size * in_ch
    window_tokens = cfg.window_size * cfg.window_size
    for i, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2 ** i
        n = (grid // 2 ** i) ** 2
        per_block = (2 * n * c * 3 * c  # qkv
                     + 2 * 2 * n * window_tokens * c  # scores + attn @ v
                     + 2 * n * c * c  # proj
                     + 2 * 2 * n * c * int(cfg.mlp_ratio * c))  # fc1 + fc2
        f += depth * per_block
        if i < len(cfg.depths) - 1:  # patch merging
            f += 2 * (n // 4) * (4 * c) * (2 * c)
    c_final = cfg.embed_dim * 2 ** (len(cfg.depths) - 1)
    n_final = (grid // 2 ** (len(cfg.depths) - 1)) ** 2
    f += 2 * n_final * c_final * cfg.num_classes * 3  # the tscam head's (SF, 3) conv
    f += 2 * (c_final * 512 + 512 * 512)  # the audio projection 768 -> 512 -> 512
    return float(f)


def text_tower_flops_per_sample(cfg, seq_len: int = 77) -> float:
    """Forward FLOPs of one text of ``seq_len`` tokens through a BERT-style
    tower (RoBERTa, BERT), a multiply-add counted as 2."""
    d, i, t = cfg.hidden_size, cfg.intermediate_size, seq_len
    per_layer = (2 * t * d * d * 4  # q, k, v, out
                 + 2 * 2 * t * t * d  # scores + probs @ v
                 + 2 * 2 * t * d * i)  # fc1 + fc2
    return float(cfg.num_layers * per_layer + 2 * d * d)  # + the pooler (CLS row)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after ``warmup``
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def kernel_group(name: str) -> str:
    """The port's kernels by role; everything else is PyTorch's."""
    for key, group in (("gemm_kernel<", "bf16 GEMM (TMA + wgmma)"),
                       ("gemm_tf32x3_kernel",
                        "3xTF32 GEMM (golden qkv, proj, fc1, fc2; ResiDual)"),
                       ("attention_core_kernel", "attention core (golden)"),
                       ("window_attention_wgmma", "K2/K4/K5 qkv + attention, AMP (TMA + wgmma)"),
                       ("add_layernorm_kernel", "LayerNorm"),
                       ("ffn_cluster_kernel", "K3 FFN, AMP (clustered TMA + wgmma)"),
                       ("logmel_wgmma_kernel", "K1 log-mel, AMP (wgmma)"),
                       ("logmel_tf32x3_kernel", "K1 log-mel, golden (3xTF32 wgmma)")):
        if key in name:
            return group
    return "PyTorch (glue, casts)"


def device_profile(fn):
    """One ``torch.profiler`` window over ``fn()``: ({kernel group: device
    ms}, {kernel name: device ms}, busy ms, span ms, {kernel name: launches}),
    or None when the trace holds no device time. Busy is the union of kernel
    intervals, span the first kernel start to the last kernel end."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in device_events(prof))
    if not spans:
        return None
    groups, names, counts = collections.Counter(), collections.Counter(), collections.Counter()
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, name in spans:
        groups[kernel_group(name)] += (end - start) / 1e3
        names[name] += (end - start) / 1e3
        counts[name] += 1
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return groups, names, busy / 1e3, (cur_end - spans[0][0]) / 1e3, counts


def profile_until(fn, done, label: str):
    """Up to three :func:`device_profile` windows over ``fn()`` until
    ``done(window)`` holds (a window now and then drops kernel records): the
    last window that held device time. Raises when none did, so a census
    that measured nothing fails."""
    prof = None
    for _ in range(3):
        window = device_profile(fn)
        if window is None:
            continue
        prof = window
        if done(prof):
            break
    if prof is None:
        raise AssertionError(f"{label}: three profiler windows held no device time")
    return prof


def device_busy_ms(fn, reps: int = 5) -> float | None:
    """Device time of one ``fn()``, the mean of ``reps`` in one profiler
    window; None when the trace holds no device time."""
    fn()
    for _ in range(3):  # a window now and then comes back without device events
        prof = device_profile(lambda: [fn() for _ in range(reps)])
        if prof is not None:
            return prof[2] / reps
    return None
