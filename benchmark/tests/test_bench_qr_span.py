"""The reader of ``qr_ms.analysis`` fed a small synthetic Chrome trace laid
out as ``torch.profiler`` writes it: the device ms of the kernels launched
inside ``kernel.householder_qr`` a job, by hand, and None on a trace whose
finalize has no such span, as a program without the blocked QR leaves."""

from __future__ import annotations

import types

import pytest

from benchmark import core
from benchmark.trace import Trace


def _job(qr_spans: bool) -> list:
    """Two jobs' finalizes, each with two QR calls of a panel kernel and a
    product, and an eigensolve outside them; times in µs."""
    events, corr = [], 0

    def span(name, start, end):
        events.append({"ph": "X", "cat": "user_annotation", "name": name, "tid": 1,
                       "ts": start, "dur": end - start})

    def launch(at, dur):
        nonlocal corr
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
                       "ts": at, "dur": 1, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": 7, "ts": at + 1,
                       "dur": dur, "args": {"correlation": corr}})

    span("bench.window", 0, 2000)
    for o in (0, 1000):
        span("pca.finalize", o + 100, o + 900)
        for start in (200, 400):
            if qr_spans:
                span("kernel.householder_qr", o + start, o + start + 150)
            launch(o + start + 10, 30)
            launch(o + start + 60, 50)
        launch(o + 700, 100)
    return events


def _read(events):
    ctx = types.SimpleNamespace(trace=Trace(events), split=None, counters={})
    reader = core.load_module(core.HERE / "metrics" / "qr_ms.analysis.py",
                              "benchmark_metric_qr_ms_analysis")
    return reader.read(ctx)


def test_reader_reads_the_qr_span_a_job():
    assert _read(_job(qr_spans=True)) == pytest.approx(2 * (30 + 50) / 1e3)


def test_reader_reads_none_without_the_qr_span():
    assert _read(_job(qr_spans=False)) is None
