"""The port's ``data/processing.py`` held against the JAX package's
``AudioProcessing`` on the CPU.

The numpy steps are equal under the same ``np.random.Generator``;
``to_sample_rate`` (polyphase against JAX's direct form) within 1e-5;
``mel_spectrogram`` (K1's plain version here) within 2e-3 dB, the K1 tests'
log-mel tolerance, with its ``top_db`` floor taken over the whole output;
``spectro_augment`` (a ``torch.Generator``'s draws, where JAX draws from
``jax.random``) by its stripes: counts, widths and the same result again
from the same seed.
"""

import numpy as np
import pytest
import torch

from audio_residual_tpu.data.processing import AudioProcessing as J
from audio_residual_tpu_torch.data.processing import AudioProcessing as T

DB = 2e-3


@pytest.mark.parametrize("shape,channels", [((400,), 1), ((400,), 2), ((2, 400), 1),
                                            ((2, 400), 2), ((3, 400), 2)])
def test_to_channels_equals_jax(shape, channels):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(T.to_channels(x, channels), J.to_channels(x, channels))


@pytest.mark.parametrize("n,target", [(300, 500), (500, 300), (400, 400)])
def test_to_length_and_time_shift_equal_jax(n, target):
    x = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    for seed in (0, 1, 2):
        np.testing.assert_array_equal(T.to_length(x, target, np.random.default_rng(seed)),
                                      J.to_length(x, target, np.random.default_rng(seed)))
        np.testing.assert_array_equal(T.time_shift(x, 0.3, np.random.default_rng(seed)),
                                      J.time_shift(x, 0.3, np.random.default_rng(seed)))


def test_to_sample_rate_matches_jax():
    x = (np.random.default_rng(2).standard_normal(400) * 0.3).astype(np.float32)
    got, want = T.to_sample_rate(x, 16000, 48000), J.to_sample_rate(x, 16000, 48000)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _clips():
    """A loud clip and one 100 dB quieter, 0.25 s at 8 kHz: a floor 80 dB
    under the whole batch's max clips the quiet one, a per-clip floor
    would not."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2000)).astype(np.float32)
    x[1] *= 1e-5
    return x


@pytest.mark.parametrize("top_db", [None, 80.0])
def test_mel_spectrogram_matches_jax(top_db):
    """``mel_spectrogram`` of two clips (and of one 1-D clip) at the
    defaults but 8 kHz / n_fft 256, with and without ``top_db``."""
    x = _clips()
    kw = dict(sr=8000, n_fft=256, n_mels=32, top_db=top_db)
    got = T.mel_spectrogram(x, device="cpu", **kw)
    want = J.mel_spectrogram(x, **kw)
    assert got.shape == want.shape == (2, 2000 // 128 + 1, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=DB, rtol=0)
    one = T.mel_spectrogram(x[0], device="cpu", **kw)
    np.testing.assert_allclose(one.numpy(), J.mel_spectrogram(x[0], **kw), atol=DB, rtol=0)
    if top_db is not None:
        floor = float(got.max()) - top_db
        assert float(got[1].min()) == pytest.approx(floor)  # the quiet clip hits the floor
        per_clip = T.mel_spectrogram(x[1], device="cpu", **kw)
        assert float(per_clip.min()) < floor - 10  # its own floor lies far lower


def test_mel_spectrogram_defaults_fit_k1():
    """The defaults (44.1 kHz, n_fft 1024, hop 512, 64 mels) pass K1's
    golden rule, as the card's path needs."""
    from audio_residual_tpu_torch.ops.cuda.frontend import check_tc_config

    cfg = T.frontend_config()
    assert (cfg.sample_rate, cfg.n_fft, cfg.hop_length, cfg.n_mels, cfg.fmax) == (
        44100, 1024, 512, 64, 22050.0)
    check_tc_config(cfg, "f32")


def _stripes(mask: np.ndarray) -> list[int]:
    """Lengths of the runs of True in a 1-D mask."""
    runs, n = [], 0
    for m in list(mask) + [False]:
        if m:
            n += 1
        elif n:
            runs.append(n)
            n = 0
    return runs


@pytest.mark.parametrize("n_time,n_freq", [(1, 1), (2, 3)])
def test_spectro_augment_stripes(n_time, n_freq):
    """Each row: at most ``n_time`` zeroed time stripes (whole columns),
    ``n_freq`` zeroed frequency stripes, each narrower than its drop width
    (``max(1, int(dim * pct))``), as in the JAX package's output; the same
    seed gives the same result, another seed another."""
    spec = 1.0 + np.random.default_rng(4).random((3, 60, 40)).astype(np.float32)
    kw = dict(max_mask_pct=0.2, n_time_masks=n_time, n_freq_masks=n_freq)
    got = T.spectro_augment(spec, seed=5, **kw)
    assert torch.equal(got, T.spectro_augment(spec, seed=5, **kw))
    assert not torch.equal(got, T.spectro_augment(spec, seed=6, **kw))
    assert torch.equal(got, T.spectro_augment(torch.from_numpy(spec), **kw,
                                              generator=torch.Generator().manual_seed(5)))
    outs = [got.numpy()] + ([np.asarray(J.spectro_augment(spec, seed=5, **kw))]
                            if n_time == 2 else [])
    for out in outs:
        assert out.shape == spec.shape
        for row, ref in zip(out, spec):
            zero = row == 0
            cols, rows = zero.all(axis=1), zero.all(axis=0)
            assert np.array_equal(zero, cols[:, None] | rows[None, :])
            # stripes may overlap: at most n runs, n * (width - 1) zeros
            assert len(_stripes(cols)) <= n_time and cols.sum() <= n_time * 11
            assert len(_stripes(rows)) <= n_freq and rows.sum() <= n_freq * 7
            np.testing.assert_array_equal(row[~zero], ref[~zero])


def test_spectro_augment_takes_a_2d_spec_as_jax_does():
    """A 2-D ``[T, F]`` spec is made ``[T, F, 1]`` (``np.atleast_3d``, as
    the JAX package does)."""
    spec = np.ones((5, 30), np.float32)
    assert T.spectro_augment(spec).shape == np.atleast_3d(spec).shape == (5, 30, 1)


def test_plot_helpers_draw():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (a, b) = plt.subplots(2)
    x = _clips()[0]
    assert T.plot_waveform(x, 8000, a) is a and len(a.lines) == 1
    assert T.plot_spectrogram(T.mel_spectrogram(x, 8000, 256, device="cpu")[0], b) is b
    assert len(b.images) == 1
    plt.close(fig)
