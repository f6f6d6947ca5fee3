"""A whole run of each cell at a tiny size on the CPU (the look for a chip
skipped), with the timed path broken underneath: ``correct`` comes out
false for each fault the cell can have. (No cell spans chips, so no
exchange between chips can be left out.)"""

from __future__ import annotations

import torch

from benchmark import run as bench_run
from benchmark.tests import bench_tiny as tiny

CPU = torch.device("cpu")


def _correct(name: str) -> bool:
    line, _ = bench_run.run_cell(tiny.cell(name), 2 ** 33 + 5, 0.2, False, CPU, t_start=0.0)
    return line["correct"]


def test_sound_runs_are_correct():
    for name in ("embed.tiny.amp", "lambda.tiny.f32", "analysis.tiny.f32"):
        assert _correct(name), name


def test_embedding_altered_where_produced(monkeypatch):
    from audio_residual_tpu_torch.models import clap

    real = clap.l2_normalize

    def altered(x, eps=1e-12):
        y = real(x, eps)
        return torch.cat([y[1:2], y[1:]])  # the first clip answers with the second's embedding

    monkeypatch.setattr(clap, "l2_normalize", altered)
    assert not _correct("embed.tiny.amp")


def test_step_returns_its_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not _correct("lambda.tiny.f32")


def test_step_leaves_out_half_the_batch(monkeypatch):
    from audio_residual_tpu_torch.training import train_residual as tr

    real = tr.make_zero_shot_step

    def halved(*args, **kw):
        step, loss_fn = real(*args, **kw)

        def half_step(lam, x, labels, generator=None):
            h = x.shape[0] // 2
            return step(lam, x[:h], labels[:h], generator)

        return half_step, loss_fn

    monkeypatch.setattr(tr, "make_zero_shot_step", halved)
    assert not _correct("lambda.tiny.f32")


def test_spectrum_altered_where_produced(monkeypatch):
    from audio_residual_tpu_torch.residual import analyze

    real = analyze.AttentionPCA.finalize

    def altered(self, *args, **kw):
        out = real(self, *args, **kw)
        r = out[(0, 0)]
        out[(0, 0)] = {**r, "explained_variance": r["explained_variance"] * 1.01}
        return out

    monkeypatch.setattr(analyze.AttentionPCA, "finalize", altered)
    assert not _correct("analysis.tiny.f32")


def test_moments_leave_out_half_the_batch(monkeypatch):
    from audio_residual_tpu_torch.residual import analyze

    real = analyze.AttentionPCA.update

    def halved(self, layers_attention):
        return real(self, [a[: a.shape[0] // 2] for a in layers_attention])

    monkeypatch.setattr(analyze.AttentionPCA, "update", halved)
    assert not _correct("analysis.tiny.f32")
