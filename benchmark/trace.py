"""Reading a ``torch.profiler`` window of the card: kernels and their device
times, the spans that launched them, the device's busy time and its idle
gaps by what the host was doing.

The profiler's Chrome trace links each kernel (``cat`` ``kernel``,
``gpu_memcpy``, ``gpu_memset``) to the runtime call that launched it by
``args.correlation``; a kernel belongs to a span (a ``record_function``
range, ``cat`` ``user_annotation``, or a CPU op such as the autograd
engine's ``evaluate_function``) when that call lies inside the span on the
same host thread. Busy time is the union of the kernels' intervals inside
the window, as the program's ``utils/profiling.py::device_busy_ms`` takes
it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile

import torch

__all__ = ["Trace", "profiled"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
BREAKDOWN_ENTRIES = 10


class _Intervals:
    """The ranges of one name, per host thread, for containment queries."""

    def __init__(self):
        self.by_tid = collections.defaultdict(list)

    def add(self, tid, start, end):
        self.by_tid[tid].append((start, end))

    def freeze(self):
        """Sort each thread's ranges and merge those that overlap (a nested
        autograd call nests ranges of one name), so a point lies in the
        name's ranges iff it lies in the merged range that starts last
        before it."""
        for tid, ranges in self.by_tid.items():
            merged = []
            for s, e in sorted(ranges):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self.by_tid[tid] = ([r[0] for r in merged], [r[1] for r in merged])

    def contains(self, tid, t) -> bool:
        if tid not in self.by_tid:
            return False
        starts, ends = self.by_tid[tid]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]


class Trace:
    """A parsed profiler window.

    ``kernels``: ``(name, start_us, end_us, launch_tid, launch_ts)``;
    ``spans``: name -> :class:`_Intervals` of every ``user_annotation`` and
    of the CPU ops whose names start with one of ``op_prefixes``;
    ``cpu_ops``: ``(start, end, tid, name)`` for labelling idle gaps."""

    def __init__(self, events: list, op_prefixes=()):
        self.kernels = []
        self.spans = collections.defaultdict(_Intervals)
        self.window = None
        self.main_tid = None
        launches = {}
        self.cpu_ops = []
        annotations = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                annotations.append((e["name"], e.get("tid"), ts, ts + dur))
            elif cat == "cpu_op":
                self.cpu_ops.append((ts, ts + dur, e.get("tid"), e["name"]))
                for p in op_prefixes:
                    if e["name"].startswith(p):
                        self.spans[p].add(e.get("tid"), ts, ts + dur)
        for name, tid, start, end in annotations:
            self.spans[name].add(tid, start, end)
            if name == WINDOW:
                self.window, self.main_tid = (start, end), tid
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                ts = float(e["ts"])
                corr = e.get("args", {}).get("correlation")
                tid, launch_ts = launches.get(corr, (None, None))
                self.kernels.append((e["name"], ts, ts + float(e.get("dur", 0.0)), tid,
                                     launch_ts))
        for iv in self.spans.values():
            iv.freeze()
        self.kernels.sort(key=lambda k: k[1])

    # -- the window ---------------------------------------------------------
    def window_s(self) -> float | None:
        return None if self.window is None else (self.window[1] - self.window[0]) / 1e6

    def _in_window(self):
        lo, hi = self.window
        for k in self.kernels:
            if k[2] > lo and k[1] < hi:
                yield k

    def busy_intervals(self) -> list:
        lo, hi = self.window
        merged = []
        for _, s, e, _, _ in self._in_window():
            s, e = max(s, lo), min(e, hi)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float | None:
        if self.window is None:
            return None
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    # -- spans --------------------------------------------------------------
    def device_ms(self, inside: str, outside: tuple = ()) -> float | None:
        """Device ms of the kernels launched inside span ``inside`` and
        inside no span whose name starts with one of ``outside``."""
        iv = self.spans.get(inside)
        if iv is None:
            return None
        others = [v for n, v in self.spans.items() if n.startswith(tuple(outside))] \
            if outside else []
        total = sum(e - s for _, s, e, tid, t in self.kernels
                    if t is not None and iv.contains(tid, t)
                    and not any(o.contains(tid, t) for o in others))
        return total / 1e3 if total > 0 else None

    def span_count(self, name: str) -> int:
        iv = self.spans.get(name)
        return 0 if iv is None else sum(len(s) for s, _ in iv.by_tid.values())

    # -- the breakdown ------------------------------------------------------
    def device_ops(self) -> list:
        by_name = collections.Counter()
        for name, s, e, _, _ in self._in_window():
            by_name[name] += (e - s) / 1e6
        return [[n, v] for n, v in by_name.most_common(BREAKDOWN_ENTRIES)]

    def idle_gaps(self) -> list:
        """Device idle time inside the window (its 200 longest gaps),
        summed by what the host was doing when each gap began: the main
        thread's innermost ``bench.`` span and its innermost CPU op, or,
        where the main thread ran none (it waits in ``backward``), the
        innermost CPU op of another thread."""
        lo, hi = self.window
        busy = self.busy_intervals()
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        spans = sorted((s, e, n) for n, iv in self.spans.items() if n.startswith("bench.")
                       for s, e in zip(*iv.by_tid.get(self.main_tid, ([], []))))
        ops = sorted((s, e, n) for s, e, tid, n in self.cpu_ops if tid == self.main_tid)
        others = sorted((s, e, n) for s, e, tid, n in self.cpu_ops if tid != self.main_tid)

        def innermost(ranges, t, reach: int = 4000):
            # the latest-started range that still holds t; ranges nest
            i = bisect.bisect_right(ranges, (t, float("inf"), "")) - 1
            for j in range(i, max(i - reach, -1), -1):
                if ranges[j][1] >= t:
                    return ranges[j][2]
            return None

        by_label = collections.Counter()
        longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:200]
        for s, e in longest:
            span = innermost(spans, s) or "outside spans"
            op = innermost(ops, s) or innermost(others, s) or "host, no op"
            by_label[f"{span} | {op}"[:160]] += (e - s) / 1e6
        return [[n, v] for n, v in by_label.most_common(BREAKDOWN_ENTRIES)]


@contextlib.contextmanager
def profiled(out: dict, op_prefixes=()):
    """Profile the block (CPU and CUDA activity); on exit ``out["trace"]``
    holds the parsed :class:`Trace`. The Chrome trace goes through a
    temporary file in ``TMPDIR``, removed after reading."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out["trace"] = Trace(events, op_prefixes)
