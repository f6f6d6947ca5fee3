"""ResiDual λ-training on cached images, as the port's ``train_residual``
runs it: set-up caches the training clips' post-frontend images
(``cache_prefix_images``, in batches), builds λ and its Adam, and the
window runs ``make_zero_shot_step(..., image_input=True)``'s step over the
cached batches in order, epoch after epoch, reading each step's loss and
count of correct predictions to the host as ``train_residual`` does.

The step object is built once. Set-up drives its first steps through the
window's own call on the first batches; the check holds those steps'
losses, the first gradient as Adam received it and λ's change after them
against the plain reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs, program
from benchmark.core import PEAK_FLOPS
from benchmark.counts import lambda_step
from benchmark.reference import htsat as ref
from benchmark.reference.residual_train import train_steps
from benchmark.trace import WINDOW, profiled

DTYPES = {"bf16": torch.bfloat16, "f32": None}
BACKWARD = "autograd::engine::evaluate_function"


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.t = run.cell.config, run.cell.traffic
        self.dev = run.device
        r = self.t["residual"]
        self.layer = r["layer"]
        c = self.cfg["audio"]["embed_dim"] << self.layer
        self.c, self.k = c, c if r["k"] == "C" else int(r["k"])
        self.step_index = 0

    def _data(self):
        seed, dev, t = self.run.seed, self.dev, self.t
        r = t["residual"]
        res = {self.layer: inputs.residual(seed, self.c, self.k, r["lam_std"], r["mean_std"],
                                           dev)}
        text = inputs.text(seed, t["classes"], self.cfg["joint_embed_dim"], dev)
        clips = inputs.clips(seed, t["train_clips"], t["clip_samples"], t["gain_db"], dev)
        labels = inputs.balanced_labels(seed, t["train_clips"], t["classes"], dev)
        b = t["batch"]
        batches = [(clips[i:i + b], labels[i:i + b]) for i in range(0, t["train_clips"], b)]
        return res, text, batches

    def setup(self) -> None:
        from audio_residual_tpu_torch.training import train_residual as tr

        seed, dev, t = self.run.seed, self.dev, self.t
        self.model = program.build_model(self.cfg, inputs.weights(self.cfg, seed, dev), dev)
        residual, text, batches = self._data()
        max_len = self.cfg["audio"]["clip_samples"]
        self.images = tr.cache_prefix_images(self.model, batches, max_len=max_len)
        self.lam = {l: r["lam"].detach().clone().requires_grad_(True)
                    for l, r in residual.items()}
        frozen = {l: {"basis": r["basis"], "mean": r["mean"]} for l, r in residual.items()}
        self.lam0 = self.lam[self.layer].detach().clone()
        self.optimizer = tr.adam(self.lam, t["lr"])
        self.step, _ = tr.make_zero_shot_step(self.model, text, frozen, self.optimizer,
                                              max_len=max_len,
                                              compute_dtype=DTYPES[t["compute_dtype"]],
                                              image_input=True)
        self.losses, self.first_grad = [], None
        for _ in range(t["checked_steps"]):
            loss, _ = self._one()
            self.losses.append(loss)
            if self.first_grad is None:
                # Adam's first moment after one step is (1 - β1) g
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                state = self.optimizer.state[self.lam[self.layer]]
                m = state.get("exp_avg", torch.zeros_like(self.lam0))
                self.first_grad = (m / (1 - beta1)).detach().clone()
        self.change = (self.lam[self.layer].detach() - self.lam0).clone()

    def _one(self) -> tuple[float, int]:
        """The window's call: one step on the next cached batch, its loss and
        count of correct predictions read to the host."""
        x, y = self.images[self.step_index % len(self.images)]
        self.step_index += 1
        loss, correct = self.step(self.lam, x, y)
        return float(loss), int(correct)

    def _loop(self, seconds: float) -> dict:
        steps, failed = 0, 0
        start = time.perf_counter()
        while True:
            loss, _ = self._one()
            steps += 1
            failed += not np.isfinite(loss)
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                return {"steps": steps, "seconds": elapsed, "failed": failed}

    def window(self, seconds: float) -> tuple[dict, int, int]:
        w = self._loop(seconds)
        b = self.t["batch"]
        self.run.note(f"window: {w['steps']} steps in {w['seconds']:.3f} s")
        return {"train_clips_per_s": w["steps"] * b / w["seconds"]}, w["steps"], w["failed"]

    def traced(self, host_seconds: float):
        from torch.profiler import record_function

        w = self._loop(host_seconds)
        b = self.t["batch"]
        ops = lambda_step.step_ops(self.cfg, layer=self.layer, k=self.k,
                                   classes=self.t["classes"])
        counters = {"mfu": 100.0 * ops * b * w["steps"] / (w["seconds"] * PEAK_FLOPS)}
        main = {}
        n = self.t["trace_steps"]
        with profiled(main, op_prefixes=(BACKWARD,)):
            with record_function(WINDOW):
                for _ in range(n):
                    with record_function("bench.step"):
                        self._one()
        counters["trace_steps"] = n
        return main["trace"], None, counters, w["steps"], w["failed"]

    def release(self) -> None:
        del self.model, self.step, self.optimizer, self.images

    def check(self) -> dict:
        """Relative gaps against the reference's first steps: the worst
        step's loss, the first gradient's norm, λ's change's norm.

        λ's change leaves out the components whose reference gradient, in
        any of the steps, is under a thousandth of that step's median
        component's: Adam's step ``lr m / (sqrt(v) + eps)`` turns a
        gradient near ``eps`` into a full-sized move set by round-off
        alone, in the program and the reference alike."""
        t = self.t
        residual, text, batches = self._data()
        sd = inputs.weights(self.cfg, self.run.seed, self.dev)
        r = train_steps(batches[:t["checked_steps"]], sd, self.cfg, residual, self.layer, text,
                        t["lr"], ref.Precision("f32"))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, r["losses"]))
        g_ref = float(r["grads"][0].norm())
        grad_gap = abs(float(self.first_grad.norm()) - g_ref) / g_ref
        mags = torch.stack([g.abs() for g in r["grads"]])
        moved = (mags >= 1e-3 * mags.median(dim=1, keepdim=True).values).all(0)
        self.run.note(f"λ's change over {int(moved.sum())} of {moved.numel()} components")
        d_ref = float((r["lams"][-1] - residual[self.layer]["lam"])[moved].norm())
        change_gap = abs(float(self.change[moved].norm()) - d_ref) / d_ref
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}

    def substitute(self, prec: str, fault: str | None = None) -> None:
        """The control: the reference at ``prec`` in the port's place; with
        ``fault="half"`` each step's loss taken over the first half of its
        batch only."""
        t = self.t
        residual, text, batches = self._data()
        batches = batches[:t["checked_steps"]]
        if fault == "half":
            batches = [(w[:len(w) // 2], y[:len(y) // 2]) for w, y in batches]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        sd = inputs.weights(self.cfg, self.run.seed, self.dev)
        r = train_steps(batches, sd, self.cfg, residual, self.layer, text, t["lr"],
                        ref.Precision(prec))
        self.losses, self.first_grad = r["losses"], r["grads"][0]
        self.change = r["lams"][-1] - residual[self.layer]["lam"]
