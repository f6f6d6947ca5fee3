"""Contrastive training of the whole CLAP model, as the port's
``training/main.py`` runs it on one rank: the model from the factory's
``create_model`` holding the seeded weights (``load_state_dict``), AdamW
from ``make_optimizer``, and each step through ``make_train_step``'s step
on the next batch of a pool of clips and captions resident on the device,
cycled, its towers' seed drawn from one CPU generator of the run
(``epoch_generator``), its loss read to the host as ``train_one_epoch``
logs it. The schedule starts at ``start_step``.

The step object is built once. Set-up drives its first steps through the
window's own call; the check holds those steps' losses, each tower's first
gradient as AdamW received it and the parameters' change after them
against the plain reference (:mod:`benchmark.reference.clap_train`), fed
the same batches, rates and draws: the masks are drawn again from each
step's seed through the port's public samplers, in the program's order.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from benchmark import clap_inputs, inputs, program
from benchmark.core import PEAK_BYTES_S, PEAK_FLOPS
from benchmark.counts import contrastive_step, roberta_forward
from benchmark.counts.htsat_forward import frames
from benchmark.reference import clap_train
from benchmark.reference import htsat as ref
from benchmark.trace import WINDOW, profiled

BACKWARD = "autograd::engine::evaluate_function"
AUDIO = ("audio_branch.", "audio_projection.")
TEXT = ("text_branch.", "text_projection.")
# a projection's ReLU input within this share of the RMS of its inputs is
# taken on the program's side (_resolve)
KINK_BAND = 1e-4
# a component whose reference gradient is at most this share of the RMS of
# the step's whole gradient, in some checked step, is left out of the
# change (check())
NEAR_ZERO = 1e-3


def _text_config(t: dict) -> dict:
    """The configuration's text group in the port's ``RobertaConfig`` names."""
    return dict(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                intermediate_size=t["intermediate_size"],
                max_position_embeddings=t["max_position_embeddings"],
                type_vocab_size=t["type_vocab_size"], pad_token_id=t["pad_token_id"],
                layer_norm_eps=t["layer_norm_eps"])


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.t = run.cell.config, run.cell.traffic
        self.dev = run.device
        self.b = self.t["batch"]
        self.step_index = 0
        self.want = None  # the reference's steps, once computed

    def _data(self) -> tuple:
        seed, dev, t = self.run.seed, self.dev, self.t
        wav = inputs.clips(seed, t["pool_clips"], t["clip_samples"], t["gain_db"], dev)
        ids, mask = clap_inputs.captions(seed, t["pool_clips"], self.cfg, t, dev)
        return wav, ids, mask

    def _batch(self, i: int) -> dict:
        lo = (i * self.b) % self.t["pool_clips"]
        return {"waveform": self.wav[lo:lo + self.b], "input_ids": self.ids[lo:lo + self.b],
                "attention_mask": self.mask[lo:lo + self.b]}

    def _model(self):
        """The factory's model, checked against the configuration's widths,
        holding the seeded weights."""
        from audio_residual_tpu_torch.models import factory, roberta

        model, mcfg, _ = factory.create_model(self.t["amodel"], self.t["tmodel"], device=self.dev)
        want = program.clap_config(self.cfg)
        text = _text_config(self.cfg["text"])
        if ({k: getattr(mcfg.audio, k) for k in self.cfg["audio"]}
                != {k: getattr(want.audio, k) for k in self.cfg["audio"]}
                or {k: getattr(mcfg.text, k) for k in text} != text
                or (mcfg.embed_dim, mcfg.joint_embed_shape, mcfg.mlp_act)
                != (want.embed_dim, want.joint_embed_shape, want.mlp_act)
                or roberta.DROPOUT != self.cfg["text"]["hidden_dropout_prob"]):
            raise SystemExit(f"{self.t['amodel']} + {self.t['tmodel']} of the factory is not "
                             f"the configuration {self.cfg['name']}")
        model.load_state_dict(clap_inputs.weights(self.cfg, self.run.seed, self.dev),
                              strict=True)
        return model, mcfg

    def setup(self) -> None:
        # the samplers the check draws the masks with: a program without the
        # text tower's training mode stops here, before any work
        from audio_residual_tpu_torch.models.roberta import sample_dropout  # noqa: F401
        from audio_residual_tpu_torch.training.main import epoch_generator
        from audio_residual_tpu_torch.training.train_clap import (init_train_state,
                                                                  make_optimizer,
                                                                  make_train_step)

        t, o = self.t, self.t["optimizer"]
        self.model, self.mcfg = self._model()
        self.wav, self.ids, self.mask = self._data()
        optimizer = make_optimizer(self.model, lr=o["lr"], beta1=o["betas"][0],
                                   beta2=o["betas"][1], eps=o["eps"],
                                   weight_decay=o["weight_decay"], warmup=o["warmup"],
                                   total_steps=o["total_steps"], name=o["name"])
        self.state = init_train_state(self.model, optimizer)
        self.state["step"] = t["start_step"]
        self.step = make_train_step(self.model, optimizer, compute_dtype=None)
        self.generator = epoch_generator(self.run.seed, 0)
        self.losses, self.first_grad, self.kink_grads = [], None, []
        for _ in range(t["checked_steps"]):
            self.losses.append(self._one())
            if self.first_grad is None:
                self.first_grad = {n: p.grad.detach().clone()
                                   for n, p in self.model.named_parameters()
                                   if n.startswith(AUDIO + TEXT)}
            self.kink_grads.append({s: getattr(self.model, f"{s}_projection")[0].bias.grad.clone()
                                    for s in ("audio", "text")})
        self.after = {n: p.detach().clone() for n, p in self.model.named_parameters()}

    def _one(self) -> float:
        """The window's call: one step on the next batch, its loss read to
        the host."""
        batch = self._batch(self.step_index)
        self.step_index += 1
        self.state, metrics = self.step(self.state, batch, self.generator)
        return float(metrics["loss"])

    def _loop(self, seconds: float) -> dict:
        steps, failed = 0, 0
        start = time.perf_counter()
        while True:
            loss = self._one()
            steps += 1
            failed += not np.isfinite(loss)
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                return {"steps": steps, "seconds": elapsed, "failed": failed}

    def window(self, seconds: float) -> tuple[dict, int, int]:
        w = self._loop(seconds)
        self.run.note(f"window: {w['steps']} steps in {w['seconds']:.3f} s")
        return {"train_clips_per_s": w["steps"] * self.b / w["seconds"]}, w["steps"], w["failed"]

    def traced(self, host_seconds: float):
        from torch.profiler import record_function

        w = self._loop(host_seconds)
        ctx = self.t["context"]
        ops = contrastive_step.step_ops(self.cfg, self.b, ctx)
        text_s = max(roberta_forward.span_ops(self.cfg, self.b, ctx) / PEAK_FLOPS,
                     roberta_forward.span_bytes(self.cfg, self.b, ctx) / PEAK_BYTES_S)
        counters = {"mfu": 100.0 * ops * w["steps"] / (w["seconds"] * PEAK_FLOPS),
                    "text_bound_ms": 1e3 * text_s}
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
        del self.model, self.step, self.state, self.wav, self.ids, self.mask

    def _draws(self) -> list:
        """Each checked step's masks, drawn again from its seed through the
        port's samplers in the program's order: the step's seed from the CPU
        generator, the towers' generator on the device, ``clap_apply``'s
        split (audio, its transform, the text transform, then the text
        tower), SpecAugment and the blocks' drop-path from the audio stream,
        RoBERTa's dropout from the text stream."""
        from audio_residual_tpu_torch.models.clap import split_generator
        from audio_residual_tpu_torch.models.htsat import drop_path_rates, sample_drop_path
        from audio_residual_tpu_torch.models.roberta import sample_dropout
        from audio_residual_tpu_torch.ops.spec_augment import sample_spec_augment
        from audio_residual_tpu_torch.training.main import epoch_generator

        dev, b, a = self.dev, self.b, self.cfg["audio"]
        cpu = epoch_generator(self.run.seed, 0)
        out = []
        for _ in range(self.t["checked_steps"]):
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=cpu, device=cpu.device))
            g = torch.Generator(device=dev).manual_seed(seed)
            g_audio, _, _ = split_generator(g, 3, dev)
            (g_text,) = split_generator(g, 1, dev)
            spec = sample_spec_augment(g_audio, (b, frames(a), a["mel_bins"]), device=dev)
            drop = [tuple(sample_drop_path(g_audio, b, float(r), dev) for _ in range(2))
                    if r > 0 else None for r in drop_path_rates(self.mcfg.audio)]
            text = sample_dropout(g_text, self.mcfg.text, b, self.t["context"])
            out.append({"spec": spec, "drop_path": drop, "text": text})
        return out

    def _resolve(self, t: int, z: dict, dh: dict) -> dict | None:
        """The projections' ReLU slopes of the program at step ``t`` where the
        reference's input lies within :data:`KINK_BAND` of 0 (the two
        computations' round-off, ~1e-5 of the RMS at most, may put such an
        entry on either side; flipping one moves a step's gradient by
        ~0.5%, which Adam's first steps turn into sign changes): each such
        entry's slope is the one of 0 and 1 that brings the reference's
        gradient of the projection's first bias closest to the program's
        for its unit. None where every such entry keeps the reference's own
        slope; elsewhere the reference's own slopes stand."""
        out, moved = {}, 0
        for side in z:
            zs, g = z[side], dh[side]
            slopes = (zs > 0).float()
            band = zs.abs() < KINK_BAND * zs.square().mean().sqrt()
            want = self.kink_grads[t][side] - (slopes * g).sum(0)
            for u in band.any(0).nonzero().flatten().tolist():
                rows = band[:, u].nonzero().flatten()[:12].tolist()
                best, pick = None, None
                for bits in itertools.product((0.0, 1.0), repeat=len(rows)):
                    d = sum((b - float(slopes[r, u])) * float(g[r, u]) for b, r in zip(bits, rows))
                    err = abs(float(want[u]) - d)
                    if best is None or err < best:
                        best, pick = err, bits
                for b, r in zip(pick, rows):
                    moved += b != float(slopes[r, u])
                    slopes[r, u] = b
            out[side] = slopes
        self.run.note(f"step {t + 1}: {moved} ReLU input(s) within round-off of 0 taken on "
                      "the program's side")
        return out if moved else None

    def _reference(self, prec: str, fault: str | None, resolve=None) -> dict:
        """The reference's checked steps at ``prec`` from the seeded weights,
        on the same batches with the same draws (a ``fault`` of
        :meth:`substitute` planted)."""
        wav, ids, mask = self._data()
        draws = self._draws()
        h = self.b // 2 if fault == "half" else self.b
        batches = []
        for i, d in enumerate(draws):
            lo = (i * self.b) % self.t["pool_clips"]
            batches.append({"waveform": wav[lo:lo + h], "input_ids": ids[lo:lo + h],
                            "attention_mask": mask[lo:lo + h]})
            if fault == "half":
                (tw, ts), (fw, fs) = d["spec"]
                d["spec"] = ((tw[:h], ts[:h]), (fw[:h], fs[:h]))
                d["drop_path"] = [None if m is None else (m[0][:h], m[1][:h])
                                  for m in d["drop_path"]]
                x = d["text"]
                d["text"] = {"rate": x["rate"], "embed": x["embed"][:h],
                             "layers": [tuple(k[:h] for k in ks) for ks in x["layers"]]}
            if fault == "text_eval":
                d["text"] = None
        del wav, ids, mask
        sd = clap_inputs.weights(self.cfg, self.run.seed, self.dev)
        return clap_train.train_steps(batches, sd, self.cfg, draws, self.t["optimizer"],
                                      self.t["start_step"], ref.Precision(prec), resolve)

    def check(self) -> dict:
        """Relative gaps against the reference's first steps: the worst
        step's loss; the L2 error of the first gradient of each side (the
        tower and its projection) over the reference's norm; the same of
        the parameters' change after the checked steps.

        The change leaves out the components whose reference gradient, in
        any of the steps, is at most a thousandth of the RMS of that step's
        whole gradient: AdamW's step ``lr m / (sqrt(v) + eps)`` turns a
        gradient near round-off into a full-sized move of either sign, in
        the program and the reference alike. Such gradients are those whose
        true value is 0 (the key projections' biases: softmax takes no
        notice of a row's constant; the embedding rows of tokens outside the
        batch) or near it; a tensor's own RMS would keep a key bias, whose
        every component is round-off, and a median would be 0 in an
        embedding table."""
        if self.want is None:
            self.want = self._reference("f32", None, self._resolve)
        want = self.want
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(self.losses, want["losses"]))

        def grad_gap(prefix):
            keys = [k for k in want["grads"][0] if k.startswith(prefix)]
            err = sum(float((self.first_grad[k] - want["grads"][0][k]).double().square().sum())
                      for k in keys)
            norm = sum(float(want["grads"][0][k].double().square().sum()) for k in keys)
            return (err / norm) ** 0.5

        sd = clap_inputs.weights(self.cfg, self.run.seed, self.dev)
        floors = []
        for g in want["grads"]:
            sq = sum(float(v.double().square().sum()) for v in g.values())
            floors.append(NEAR_ZERO * (sq / sum(v.numel() for v in g.values())) ** 0.5)
        err = norm = 0.0
        moved = total = 0
        for k, p in want["params"].items():
            keep = torch.ones_like(p, dtype=torch.bool)
            for g, floor in zip(want["grads"], floors):
                keep &= g[k].abs() > floor
            d_ref = (p - sd[k])[keep].double()
            d = (self.after[k] - sd[k])[keep].double()
            err += float((d - d_ref).square().sum())
            norm += float(d_ref.square().sum())
            moved, total = moved + int(keep.sum()), total + keep.numel()
        self.run.note(f"the change over {moved} of {total} components")
        return {"loss_gap": loss_gap, "audio_grad_gap": grad_gap(AUDIO),
                "text_grad_gap": grad_gap(TEXT), "change_gap": (err / norm) ** 0.5}

    def substitute(self, prec: str, fault: str | None = None) -> None:
        """The control: the reference at ``prec`` in the port's place; with
        ``fault="half"`` each step's loss taken over the first half of its
        batch, with ``fault="text_eval"`` RoBERTa without its dropout."""
        if fault not in (None, "half", "text_eval"):
            raise ValueError(f"unknown fault {fault!r}")
        r = self._reference(prec, fault)
        self.losses, self.after = r["losses"], r["params"]
        self.first_grad = {k: g for k, g in r["grads"][0].items() if k.startswith(AUDIO + TEXT)}
