"""Zero-shot embedding: a closed loop, one client, one batch in flight.

Each batch takes the next ``batch`` clips of a seeded pool resident on the
device and runs the port's zero-shot program as ``bench.py`` runs it:
``quantize_roundtrip`` -> ``featurize_batch`` (repeat-pad to the clip
length) -> ``encode_audio`` with the ResiDual at one layer -> similarities
against the class texts -> argmax. A batch ends when its predictions and
normalised embeddings are in host memory.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.core import PEAK_BYTES_S, PEAK_FLOPS
from benchmark.counts import htsat_forward
from benchmark.reference import htsat as ref
from benchmark.trace import WINDOW, profiled

DTYPES = {"bf16": torch.bfloat16, "f32": None}


class GcPauses:
    """The garbage collector's passes while active: ms each (as
    ``chip_smoke.py::gc_pauses`` records them)."""

    def __init__(self):
        self.ms, self._start = [], None

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.ms.append((time.perf_counter() - self._start) * 1e3)

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.t = run.cell.config, run.cell.traffic
        self.dev = run.device
        self.dtype = DTYPES[self.t["compute_dtype"]]
        a = self.cfg["audio"]
        r = self.t["residual"]
        self.layer = r["layer"]
        self.k = a["embed_dim"] << self.layer if r["k"] == "C" else int(r["k"])
        self.outputs = []

    # -- set-up -------------------------------------------------------------
    def _inputs(self):
        seed, dev, t, a = self.run.seed, self.dev, self.t, self.cfg["audio"]
        r = t["residual"]
        c = a["embed_dim"] << self.layer
        res = inputs.residual(seed, c, self.k, r["lam_std"], r["mean_std"], dev)
        text = inputs.text(seed, t["classes"], self.cfg["joint_embed_dim"], dev)
        return {self.layer: res}, text

    def setup(self) -> None:
        from audio_residual_tpu_torch.data.featurize import featurize_batch
        from audio_residual_tpu_torch.models.clap import encode_audio
        from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip

        seed, dev, t = self.run.seed, self.dev, self.t
        self.model = program.build_model(self.cfg, inputs.weights(self.cfg, seed, dev), dev)
        self.pool = inputs.clips(seed, t["pool_clips"], t["clip_samples"], t["gain_db"], dev)
        self.residual, self.text = self._inputs()
        max_len = self.cfg["audio"]["clip_samples"]
        self.featurize = lambda wav: featurize_batch(quantize_roundtrip(wav), max_len)
        self.encode = lambda batch, **kw: encode_audio(self.model, batch,
                                                       residual=self.residual,
                                                       compute_dtype=self.dtype, **kw)
        for i in range(t["warmup_batches"]):
            self._batch(i)

    def _clips(self, i: int) -> torch.Tensor:
        b, n = self.t["batch"], self.t["pool_clips"]
        start = (i * b) % n
        return self.pool[start:start + b]

    def _batch(self, i: int):
        """One batch: ``(embeddings, predictions, t0, t_return, t_host)``."""
        wav = self._clips(i)
        t0 = time.perf_counter()
        emb = self.encode(self.featurize(wav))["normalized"]
        t1 = time.perf_counter()
        pred = (emb @ self.text.t()).argmax(-1)
        emb_h = emb.cpu()
        pred_h = pred.cpu()
        return emb_h, pred_h, t0, t1, time.perf_counter()

    # -- the window ---------------------------------------------------------
    def _loop(self, seconds: float, first: int, keep: bool) -> dict:
        lat, host, failed = [], [], 0
        i = first
        start = time.perf_counter()
        while True:
            emb, pred, t0, t1, t2 = self._batch(i)
            lat.append(t2 - t0)
            host.append(t1 - t0)
            # numpy, single-threaded: a CPU tensor op here wakes PyTorch's
            # intra-op thread pool, whose spinning threads then hold up the
            # launching thread (stalls of tens of ms)
            if not np.isfinite(emb.numpy()).all():
                failed += 1
            if keep:
                self.outputs.append((i, emb.numpy(), pred.numpy()))
            i += 1
            if t2 - start >= seconds:
                break
        return {"batches": len(lat), "seconds": t2 - start, "latencies": lat, "host": host,
                "failed": failed, "next": i}

    def window(self, seconds: float) -> tuple[dict, int, int]:
        w = self._loop(seconds, self.t["warmup_batches"], keep=True)
        b = self.t["batch"]
        lat = sorted(w["latencies"])
        p95 = float(np.percentile(np.array(lat) * 1e3, 95))
        self.run.note(f"window: {w['batches']} batches in {w['seconds']:.3f} s, "
                      f"{sum(lat):.3f} s of them inside batches; embed_p95_ms over "
                      f"{len(lat)} batch latencies, median {1e3 * lat[len(lat) // 2]:.3f} ms")
        metrics = {"embed_clips_per_s": w["batches"] * b / w["seconds"], "embed_p95_ms": p95}
        return metrics, w["batches"] * b, w["failed"] * b

    # -- the traced run -----------------------------------------------------
    def split_pass(self, batches: int) -> None:
        """The batches through the port's split points, each call in a span."""
        from torch.profiler import record_function

        layers = len(self.cfg["audio"]["depths"])
        for i in range(batches):
            wav = self._clips(i)
            with record_function("bench.frontend"):
                image = self.encode(self.featurize(wav), stop_at_image=True)["image"]
            with record_function("bench.layer0"):
                x = self.encode({"image": image}, stop_at_layer=1)["tokens"]
            for li in range(1, layers):
                with record_function(f"bench.layer{li}"):
                    x = self.encode({"tokens": x}, start_layer=li, stop_at_layer=li + 1)["tokens"]
            with record_function("bench.head"):
                emb = self.encode({"tokens": x}, start_layer=layers)["normalized"]
                (emb @ self.text.t()).argmax(-1).cpu()

    def traced(self, host_seconds: float):
        """Per-layer readings: an untraced stretch (host time, GC passes,
        the work rate), a profiled stretch of the loop (idle share,
        breakdown), then the split-point pass under the profiler."""
        b = self.t["batch"]
        with GcPauses() as pauses:
            w = self._loop(host_seconds, self.t["warmup_batches"], keep=True)
        ops_clip = htsat_forward.forward_ops(self.cfg, residual={self.layer: self.k},
                                             classes=self.t["classes"])
        counters = {"batches": w["batches"], "host_ms": 1e3 * float(np.mean(w["host"])),
                    "gc_ms_per_batch": sum(pauses.ms) / w["batches"],
                    "mfu": 100.0 * ops_clip * w["batches"] * b / (w["seconds"] * PEAK_FLOPS)}
        from torch.profiler import record_function

        main = {}
        with profiled(main):
            with record_function(WINDOW):
                for i in range(w["next"], w["next"] + self.t["trace_batches"]):
                    with record_function("bench.batch"):
                        self._batch(i)
        split = {}
        n = self.t["split_batches"]
        self.split_pass(1)  # the split points' first calls, outside the profile
        with profiled(split):
            self.split_pass(n)
        stages = htsat_forward.stage_ops(self.cfg, residual={self.layer: self.k},
                                         classes=self.t["classes"])
        layers = len(self.cfg["audio"]["depths"])
        act = 2 if self.dtype is not None else 4
        swin_ops = b * sum(stages[f"layer{i}"] for i in range(layers))
        swin_bytes = htsat_forward.swin_bytes(self.cfg, b, act_bytes=act, weight_bytes=act)
        counters.update(split_batches=n, layers=layers,
                        swin_bound_ms=1e3 * max(swin_ops / PEAK_FLOPS, swin_bytes / PEAK_BYTES_S))
        return main["trace"], split["trace"], counters, w["batches"] * b, w["failed"] * b

    # -- the check ----------------------------------------------------------
    def release(self) -> None:
        del self.model, self.encode, self.featurize, self.residual

    def _chosen(self) -> list:
        rng = np.random.default_rng(self.run.seed)
        n = min(self.t["check_batches"], len(self.outputs))
        return sorted(rng.choice(len(self.outputs), size=n, replace=False).tolist())

    def _reference(self, i: int, prec: str):
        """The reference's embeddings and similarities of batch ``i``, in
        blocks of ``check_block`` clips."""
        sd, residual, text = self._ref_inputs
        wav, step = self._clips(i), self.t["check_block"]
        embs = []
        for s in range(0, wav.shape[0], step):
            with torch.no_grad():
                embs.append(ref.encode(wav[s:s + step], sd, self.cfg, residual=residual,
                                       prec=ref.Precision(prec), quantize=True)["normalized"])
        e = torch.cat(embs)
        return e, e @ text.t()

    def substitute(self, prec: str) -> None:
        """The control: the reference at ``prec`` in the port's place, for
        the batches the check compares."""
        self._ref_inputs = (inputs.weights(self.cfg, self.run.seed, self.dev), *self._inputs())
        for c in self._chosen():
            i = self.outputs[c][0]
            e, sims = self._reference(i, prec)
            self.outputs[c] = (i, e.cpu().numpy(), sims.argmax(-1).cpu().numpy())

    def check(self) -> dict:
        """The largest distance, over a seeded sample of the window's
        batches, between the port's unit embeddings and the reference's.
        The predictions are the harness's argmax over these embeddings'
        similarities, so the embeddings carry all that the program
        produced."""
        self._ref_inputs = (inputs.weights(self.cfg, self.run.seed, self.dev), *self._inputs())
        emb_gap = 0.0
        for c in self._chosen():
            i, emb, _ = self.outputs[c]
            e, _ = self._reference(i, "f32")
            got = torch.from_numpy(emb).to(self.dev)
            emb_gap = max(emb_gap, float((got - e).norm(dim=-1).max()))
        return {"embed_gap": emb_gap}
