"""The readers of the metrics that read the port's own spans, fed small
synthetic Chrome traces laid out as ``torch.profiler`` writes them: each
reader's number by hand, and None on a trace that holds only the
harness's ``bench.`` spans, as a program without the port's spans leaves."""

from __future__ import annotations

import json
import types

import pytest

from benchmark import core
from benchmark.trace import Trace

MAIN, AUTOGRAD = 1, 2
BACKWARD = "autograd::engine::evaluate_function"


class _Events:
    """A Chrome trace built up event by event; times in µs."""

    def __init__(self):
        self.events, self._corr = [], 0

    def span(self, name, start, end, tid=MAIN, cat="user_annotation"):
        self.events.append({"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": start,
                            "dur": end - start})

    def launch(self, at, dur, tid=MAIN, cat="kernel"):
        """A launch at host time ``at`` whose kernel runs ``dur`` from ``at + 1``."""
        self._corr += 1
        self.events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                            "tid": tid, "ts": at, "dur": 1, "args": {"correlation": self._corr}})
        self.events.append({"ph": "X", "cat": cat, "name": f"k{self._corr}", "tid": 7,
                            "ts": at + 1, "dur": dur, "args": {"correlation": self._corr}})


def _embed_events() -> list:
    """Two batches, 500 µs apart; in each, kernels of 5-60 µs launched inside
    the port's spans, and a copy back outside them."""
    ev = _Events()
    ev.span("bench.window", 0, 1000)
    for o in (0, 500):
        ev.span("bench.batch", o, o + 498)  # apart: the trace merges touching ranges
        for name, start, end in (("quantize", 10, 20), ("featurize", 20, 30),
                                 ("encode_audio", 30, 480), ("htsat.frontend", 30, 100),
                                 ("kernel.fused_logmel", 44, 90),
                                 ("htsat.patch_embed", 100, 120), ("htsat.layer0", 120, 250),
                                 ("kernel.fused_swin_block", 148, 215),
                                 ("htsat.merge0", 220, 240), ("htsat.layer1", 250, 400),
                                 ("kernel.fused_window_attention", 265, 305),
                                 ("kernel.fused_residual_ffn", 315, 375),
                                 ("htsat.head", 400, 470)):
            ev.span(name, o + start, o + end)
        for at, dur in ((12, 5), (22, 5), (35, 5), (45, 40), (105, 10), (125, 20), (150, 60),
                        (225, 10), (255, 5), (270, 30), (320, 50), (410, 15)):
            ev.launch(o + at, dur)
        ev.launch(o + 490, 5, cat="gpu_memcpy")  # the harness's copy back
    return ev.events


def _lambda_events() -> list:
    """Two steps of 500 µs: the forward on the main thread, the backward's
    recompute on the autograd thread inside the engine's op, Adam after."""
    ev = _Events()
    ev.span("bench.window", 0, 1000)
    for o in (0, 500):
        ev.span("bench.step", o, o + 500)
        ev.span("train.forward", o + 10, o + 100)
        ev.span("kernel.fused_swin_block", o + 20, o + 60)
        ev.launch(o + 30, 20)
        ev.launch(o + 70, 10)
        ev.span("train.backward", o + 110, o + 400)
        ev.launch(o + 115, 2)
        ev.span(BACKWARD, o + 120, o + 380, tid=AUTOGRAD, cat="cpu_op")
        ev.span("recompute.fused_swin_block", o + 130, o + 300, tid=AUTOGRAD)
        ev.launch(o + 140, 50, tid=AUTOGRAD)
        ev.launch(o + 200, 30, tid=AUTOGRAD)
        ev.launch(o + 350, 10, tid=AUTOGRAD)
        ev.span("Optimizer.step#Adam.step", o + 410, o + 450)
        ev.launch(o + 420, 5)
    return ev.events


def _analysis_events() -> list:
    """One job: two batches (encode, update), then the finalize."""
    ev = _Events()
    ev.span("bench.window", 0, 1000)
    for o in (0, 200):
        ev.span("bench.encode", o, o + 100)
        ev.span("pca.encode", o, o + 100)
        ev.launch(o + 10, 20)
        ev.launch(o + 50, 20)
        ev.span("pca.update", o + 100, o + 150)
        ev.launch(o + 110, 10)
    ev.span("pca.finalize", 400, 900)
    for at, dur in ((410, 100), (600, 50), (700, 25)):
        ev.launch(at, dur)
    return ev.events


CELLS = {
    "embed": (_embed_events, (), {"swin_bound_ms": 0.0925, "layers": 2}),
    "lambda": (_lambda_events, (BACKWARD,), {"trace_steps": 2}),
    "analysis": (_analysis_events, (), {}),
}

# per batch (embed), step (λ) or job (analysis); device times in ms
EXPECTED = {
    "frontend_span_ms.embed": ("embed", (5 + 5 + 5 + 40) / 1e3),
    "swin_span_ms.embed": ("embed", (10 + 20 + 60 + 10 + 5 + 30 + 50) / 1e3),
    "swin_span_roofline.embed": ("embed", 100.0 * 0.0925 / 0.185),
    "glue_ms.embed": ("embed", (10 + 20 + 10 + 5) / 1e3),
    "merge_ms.embed": ("embed", 10 / 1e3),
    "launches.embed": ("embed", 12.0),
    # the gaps that begin inside quantize, featurize or encode_audio
    "port_idle_ms.embed": ("embed", (5 + 8 + 5 + 20 + 10 + 5 + 15 + 20 + 10 + 20 + 40 + 65) / 1e3),
    "forward_span_ms.train": ("lambda", (20 + 10) / 1e3),
    "recompute_ms.train": ("lambda", (50 + 30) / 1e3),
    "launches.train": ("lambda", 6.0),
    "tapped_span_ms.analysis": ("analysis", 40 / 1e3),
    "moments_ms.analysis": ("analysis", 10 / 1e3),
    "finalize_span_ms.analysis": ("analysis", 175 / 1e3),
}


def _read(metric: str, events: list, cell: str):
    _, prefixes, counters = CELLS[cell]
    ctx = types.SimpleNamespace(trace=Trace(events, prefixes), split=None, counters=counters)
    reader = core.load_module(core.HERE / "metrics" / f"{metric}.py",
                              "benchmark_metric_" + metric.replace(".", "_"))
    return reader.read(ctx)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_the_port_spans(metric):
    cell, want = EXPECTED[metric]
    assert _read(metric, CELLS[cell][0](), cell) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_finds_no_port_span_and_reads_none(metric):
    cell, _ = EXPECTED[metric]
    harness_only = [e for e in CELLS[cell][0]()
                    if e["cat"] != "user_annotation" or e["name"].startswith("bench.")]
    assert _read(metric, harness_only, cell) is None


def test_glue_and_the_kernel_spans_make_up_the_swin_layers():
    trace = Trace(_embed_events())
    kernels = sum(trace.device_ms(n) for n in trace.spans if n.startswith("kernel.")
                  and n != "kernel.fused_logmel") / trace.span_count("bench.batch")
    glue, swin = (_read(m, _embed_events(), "embed") for m in ("glue_ms.embed",
                                                                "swin_span_ms.embed"))
    assert glue + kernels == pytest.approx(swin)


def test_every_reader_has_an_entry_with_its_cells():
    spec = {m["name"]: m
            for m in json.loads((core.ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    family = {"embed": "embed.", "lambda": "lambda.", "analysis": "analysis."}
    for metric, (cell, _) in EXPECTED.items():
        assert spec[metric]["workloads"]
        assert all(w.startswith(family[cell]) for w in spec[metric]["workloads"]), metric
