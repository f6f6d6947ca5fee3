"""The representation analysis as ``examples/analyze_clap_attention.py``
runs it: one job is one validation fold, streamed in batches through
``residual/analyze.py::run_pca`` with that script's closure
(``quantize_roundtrip`` -> ``featurize_batch`` -> ``encode_audio(taps=
("attention",))``, golden f32), per-(layer, head) moments of the flattened
attention maps, and the randomized float64 finalize. Jobs run back to back
over the folds of a seeded pool; the window is made of whole jobs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.core import PEAK_FLOPS
from benchmark.counts import attention_pca
from benchmark.reference import htsat as ref
from benchmark.reference.pca import Moments, top_spectrum
from benchmark.trace import WINDOW, profiled


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.t = run.cell.config, run.cell.traffic
        self.dev = run.device
        self.jobs = []  # (fold, {(layer, head): (explained_variance, total_variance, rows)})
        self.finalize_ms = []
        self.annotate = False

    def setup(self) -> None:
        from audio_residual_tpu_torch.data.featurize import featurize_batch
        from audio_residual_tpu_torch.models.clap import encode_audio
        from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip
        from audio_residual_tpu_torch.residual import analyze

        seed, dev, t = self.run.seed, self.dev, self.t
        self.model = program.build_model(self.cfg, inputs.weights(self.cfg, seed, dev), dev)
        self.pool = inputs.clips(seed, t["folds"] * t["fold_clips"], t["clip_samples"],
                                 t["gain_db"], dev)
        max_len = self.cfg["audio"]["clip_samples"]

        def encode(wav):
            if self.annotate:
                from torch.profiler import record_function

                with record_function("bench.encode"):
                    return encode_audio(self.model, featurize_batch(quantize_roundtrip(wav),
                                                                    max_len),
                                        taps=("attention",))
            return encode_audio(self.model, featurize_batch(quantize_roundtrip(wav), max_len),
                                taps=("attention",))

        self.encode, self.run_pca = encode, analyze.run_pca
        self._job(0, keep=False)

    def _fold(self, f: int):
        n, b = self.t["fold_clips"], self.t["batch"]
        clips = self.pool[f * n:(f + 1) * n]
        return [clips[i:i + b] for i in range(0, n, b)]

    def _job(self, f: int, keep: bool = True) -> None:
        a = self.cfg["audio"]
        marks = {}

        def batches():
            yield from self._fold(f)
            marks["drained"] = time.perf_counter()

        result = self.run_pca(self.encode, batches(), num_layers=len(a["depths"]),
                              num_heads=a["num_heads"], window=a["window_size"],
                              device=self.dev)
        self.finalize_ms.append(1e3 * (time.perf_counter() - marks["drained"]))
        if keep:
            self.jobs.append((f, {key: (np.asarray(r["explained_variance"]),
                                        float(r["total_variance"]), int(r["num_samples"]))
                                  for key, r in result.items()}))

    def _loop(self, seconds: float) -> dict:
        jobs, failed = 0, 0
        self.finalize_ms = []
        start = time.perf_counter()
        while True:
            self._job((len(self.jobs) + 1) % self.t["folds"])
            jobs += 1
            spectra = self.jobs[-1][1].values()
            failed += not all(np.isfinite(ev).all() for ev, _, _ in spectra)
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                return {"jobs": jobs, "seconds": elapsed, "failed": failed}

    def window(self, seconds: float) -> tuple[dict, int, int]:
        w = self._loop(seconds)
        clips = w["jobs"] * self.t["fold_clips"]
        self.run.note(f"window: {w['jobs']} jobs in {w['seconds']:.3f} s")
        return {"analysis_clips_per_s": clips / w["seconds"]}, w["jobs"], w["failed"]

    def traced(self, host_seconds: float):
        from torch.profiler import record_function

        w = self._loop(host_seconds)
        ops = attention_pca.job_ops(self.cfg, self.t["fold_clips"])
        counters = {"finalize_ms": float(np.mean(self.finalize_ms)),
                    "mfu": 100.0 * ops * w["jobs"] / (w["seconds"] * PEAK_FLOPS)}
        main = {}
        self.annotate = True
        with profiled(main):
            with record_function(WINDOW):
                self._job((len(self.jobs) + 1) % self.t["folds"])
        self.annotate = False
        return main["trace"], None, counters, w["jobs"], w["failed"]

    def release(self) -> None:
        del self.model, self.encode, self.run_pca

    def _reference(self, f: int, prec: str) -> dict:
        """The reference's ``{layer: (eigenvalues [heads, top], trace
        [heads], rows)}`` of fold ``f``."""
        a = self.cfg["audio"]
        sd = inputs.weights(self.cfg, self.run.seed, self.dev)
        p = ref.Precision(prec)
        n = (self.cfg["audio"]["window_size"] ** 2) ** 2
        moments = [Moments(h, n, self.dev, p) for h in a["num_heads"]]
        for wav in self._fold(f):
            with torch.no_grad():
                taps = ref.encode(wav, sd, self.cfg, prec=p, quantize=True, taps=True)
            for m, probs in zip(moments, taps["attention"]):
                m.update(probs)
            del taps
        g = inputs.generator(self.run.seed, "residual", self.dev)
        out = {}
        for layer, m in enumerate(moments):
            ev, tr = top_spectrum(m, self.t["check_top"], g)
            out[layer] = (ev.cpu().numpy(), tr.cpu().numpy(), m.n)
            moments[layer] = None
        return out

    def _chosen(self) -> int:
        return int(np.random.default_rng(self.run.seed).integers(len(self.jobs)))

    def substitute(self, prec: str) -> None:
        """The control: the reference at ``prec`` in the port's place."""
        c = self._chosen()
        f = self.jobs[c][0]
        r = self._reference(f, prec)
        self.jobs[c] = (f, {(layer, h): (ev[h], float(tr[h]), rows)
                            for layer, (ev, tr, rows) in r.items() for h in range(len(tr))})

    def check(self) -> dict:
        """Over every (layer, head) of one seeded job of the window: the
        largest gap of a leading eigenvalue as a share of the head's first,
        the largest relative gap of the total variance, and the rows
        counted."""
        f, got = self.jobs[self._chosen()]
        r = self._reference(f, "f32")
        top = self.t["check_top"]
        spectrum_gap = trace_gap = rows_gap = 0.0
        for layer, (ev, tr, rows) in r.items():
            for h in range(len(tr)):
                p_ev, p_tr, p_rows = got[(layer, h)]
                spectrum_gap = max(spectrum_gap, float(np.abs(p_ev[:top] - ev[h]).max() / ev[h][0]))
                trace_gap = max(trace_gap, abs(p_tr - float(tr[h])) / float(tr[h]))
                rows_gap = max(rows_gap, float(abs(p_rows - rows)))
        return {"spectrum_gap": spectrum_gap, "trace_gap": trace_gap, "rows_gap": rows_gap}
