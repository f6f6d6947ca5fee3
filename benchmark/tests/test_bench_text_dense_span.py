"""The reader of ``text_dense_ms.contrastive`` fed a small synthetic Chrome
trace laid out as ``torch.profiler`` writes it: the device ms a step of the
kernels launched inside ``kernel.linear_tf32x3`` on the main thread or
``kernel.linear_tf32x3.backward`` on the autograd engine's thread, by hand,
and None on a trace with neither span, as a program whose text tower runs
``F.linear`` leaves."""

from __future__ import annotations

import types

import pytest

from benchmark import core
from benchmark.trace import Trace

MAIN, ENGINE = 1, 2


def _steps(spans: bool) -> list:
    """Two steps: each a forward on the main thread with two linears (a
    split and a product each) and a LayerNorm outside them, and a backward
    on the engine's thread with one linear's gradients (three kernels) and
    an elementwise kernel outside it; times in µs."""
    events, corr = [], 0

    def span(name, tid, start, end):
        events.append({"ph": "X", "cat": "user_annotation", "name": name, "tid": tid,
                       "ts": start, "dur": end - start})

    def launch(tid, at, dur):
        nonlocal corr
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                       "ts": at, "dur": 1, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7, "ts": at + 1,
                       "dur": dur, "args": {"correlation": corr}})

    span("bench.window", MAIN, 0, 4000)
    for o in (0, 2000):
        for start in (100, 300):
            if spans:
                span("kernel.linear_tf32x3", MAIN, o + start, o + start + 150)
            launch(MAIN, o + start + 10, 5)
            launch(MAIN, o + start + 60, 40)
        launch(MAIN, o + 500, 20)
        if spans:
            span("kernel.linear_tf32x3.backward", ENGINE, o + 1000, o + 1400)
        for at, dur in ((1010, 30), (1100, 60), (1300, 8)):
            launch(ENGINE, o + at, dur)
        launch(ENGINE, o + 1500, 25)
    return events


def _read(events):
    ctx = types.SimpleNamespace(trace=Trace(events), split=None, counters={"trace_steps": 2})
    reader = core.load_module(core.HERE / "metrics" / "text_dense_ms.contrastive.py",
                              "benchmark_metric_text_dense_ms_contrastive")
    return reader.read(ctx)


def test_reader_reads_the_linear_spans_a_step():
    assert _read(_steps(spans=True)) == pytest.approx((2 * (5 + 40) + 30 + 60 + 8) / 1e3)


def test_reader_reads_none_without_the_linear_spans():
    assert _read(_steps(spans=False)) is None
