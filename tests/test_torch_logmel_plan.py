"""The plan of K1's AMP kernel (``csrc/logmel.cu::logmel_wgmma_kernel``),
held on the CPU against ``logmel_plain(..., "bf16")`` and the JAX Pallas
kernel.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
what it is given and how it splits the work are checked here: the bf16
signal (cast, then reflect pad), the interleaved zero-padded bf16 basis, the
mel weights by bin chunk, and the alignment rule of its wrapper. The JAX
kernel runs in Pallas interpret mode, as ``tests/test_torch_kernels.py``
runs it, at that file's log-mel tolerance (``atol=2e-3`` dB).
"""

import functools
import json
import unittest.mock as mock
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audio_residual_tpu.ops import frontend as j_fe
from audio_residual_tpu.ops.pallas import frontend as j_k1
from audio_residual_tpu_torch.data.featurize import fusion_frontend_config
from audio_residual_tpu_torch.models.clap import CLAPConfig
from audio_residual_tpu_torch.ops import frontend as t_fe
from audio_residual_tpu_torch.ops.cuda import frontend as k1

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs" / "model_configs"
CPU = torch.device("cpu")


def _audio_configs() -> dict:
    """``{file stem: audio_cfg}`` of every HTSAT or PANN model config."""
    out = {}
    for path in sorted(CONFIG_DIR.glob("*.json")):
        a = json.loads(path.read_text()).get("audio_cfg")
        if a and a.get("model_type") in ("HTSAT", "PANN"):
            out[path.stem] = a
    return out


def _frontend(a: dict) -> t_fe.FrontendConfig:
    return t_fe.FrontendConfig(sample_rate=a["sample_rate"], n_fft=a["window_size"],
                               hop_length=a["hop_size"], win_length=a["window_size"],
                               n_mels=a["mel_bins"], fmin=a["fmin"], fmax=a["fmax"])


FRONTENDS = {"CLAPConfig": CLAPConfig().audio.frontend_config,
             "HTSAT-tiny-win-1536": _frontend(_audio_configs()["HTSAT-tiny-win-1536"]),
             # the fusion mel (data/featurize.py::get_mel): HTK scale, no norm
             "fusion-htk": fusion_frontend_config(_audio_configs()["HTSAT-tiny"])}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_tc_basis_holds_the_constants(name):
    """Row 2j is cos and row 2j + 1 sin of active bin j, rounded to bf16;
    zero rows pad to a multiple of the 128-row tile; the mel weights pad
    with zeros to [n_pad / 2, 64]."""
    cfg = FRONTENDS[name]
    basis, melw = k1._constants(cfg)
    nb = melw.shape[0]
    bt, mw = k1.tc_constants(cfg, CPU)
    n_pad = bt.shape[0]
    assert bt.dtype == torch.bfloat16 and mw.dtype == torch.float32
    assert bt.shape == (n_pad, cfg.n_fft) and n_pad % 128 == 0 and 2 * nb <= n_pad < 2 * nb + 128
    cos = torch.from_numpy(np.ascontiguousarray(basis[:, :nb].T)).bfloat16()
    sin = torch.from_numpy(np.ascontiguousarray(basis[:, nb:].T)).bfloat16()
    np.testing.assert_array_equal(_bits(bt[0 : 2 * nb : 2]), _bits(cos))
    np.testing.assert_array_equal(_bits(bt[1 : 2 * nb : 2]), _bits(sin))
    assert not bt[2 * nb :].float().any()
    assert mw.shape == (n_pad // 2, 64)
    np.testing.assert_array_equal(mw[:nb, : cfg.n_mels].numpy(), melw)
    assert not mw[nb:].any() and not mw[:, cfg.n_mels :].any()


@pytest.mark.parametrize("t", [24000, 24003])
def test_cast_then_pad_equals_pad_then_cast(rng, t):
    """The wrapper casts before the reflect pad, as the JAX kernel does:
    bit for bit the padded f32 signal rounded to bf16, then zeros up to a
    multiple of 8 samples a row."""
    cfg = t_fe.FrontendConfig()
    wav = (rng.standard_normal((3, t)) * 0.1).astype(np.float32)
    got = k1.bf16_signal(torch.from_numpy(wav), cfg)
    padded = t_fe.reflect_pad(torch.from_numpy(wav), cfg.n_fft // 2).bfloat16()
    assert got.dtype == torch.bfloat16 and got.shape[1] % 8 == 0
    assert got.shape[1] - padded.shape[1] == -padded.shape[1] % 8
    np.testing.assert_array_equal(_bits(got[:, : padded.shape[1]]), _bits(padded))
    assert not got[:, padded.shape[1] :].float().any()
    pad = cfg.n_fft // 2
    jax_padded = jnp.pad(jnp.asarray(wav).astype(jnp.bfloat16), [(0, 0), (pad, pad)],
                         mode="reflect")
    np.testing.assert_array_equal(np.asarray(jax_padded).view(np.int16), _bits(padded))


def _plan(wav: torch.Tensor, cfg: t_fe.FrontendConfig) -> torch.Tensor:
    """The kernel's plan in plain torch: frames at f * hop of the bf16
    signal, the DFT against the interleaved basis with f32 sums, power from
    column pairs, the mel fold by chunks of 64 bins into an f32 sum."""
    x = k1.bf16_signal(wav, cfg).float()
    nf = cfg.num_frames(wav.shape[1])
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :nf]
    bt, mw = k1.tc_constants(cfg, CPU)
    d = frames @ bt.float().t()
    power = d[..., 0::2] ** 2 + d[..., 1::2] ** 2
    mel = torch.zeros(*power.shape[:2], mw.shape[1])
    for n0 in range(0, power.shape[-1], 64):
        mel = mel + power[..., n0 : n0 + 64] @ mw[n0 : n0 + 64]
    db = 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin)) - k1._db_offset(cfg)
    return db[..., : cfg.n_mels]


@pytest.mark.parametrize("name", sorted(FRONTENDS))
@pytest.mark.parametrize("b,t", [(1, 24000), (3, 100000)])
def test_plan_matches_plain_bf16(rng, name, b, t):
    """Within 1e-3 dB of ``logmel_plain(..., "bf16")``: both take the same
    bf16 products, and only the order of the f32 sums differs."""
    cfg = FRONTENDS[name]
    wav = torch.from_numpy((rng.standard_normal((b, t)) * 0.1).astype(np.float32))
    got, ref = _plan(wav, cfg), k1.logmel_plain(wav, cfg, "bf16")
    assert got.shape == ref.shape == (b, cfg.num_frames(t), cfg.n_mels)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-3)


def test_plan_gives_the_floor_on_silence():
    cfg = FRONTENDS["CLAPConfig"]
    wav = torch.zeros(2, 24000)
    floor = 10.0 * np.log10(cfg.amin) - k1._db_offset(cfg)
    np.testing.assert_allclose(_plan(wav, cfg).numpy(), floor, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_plan_matches_jax_kernel_bf16(rng, name):
    cfg = FRONTENDS[name]
    jcfg = j_fe.FrontendConfig(n_fft=cfg.n_fft, win_length=cfg.win_length,
                               mel_scale=cfg.mel_scale, mel_norm=cfg.mel_norm)
    wav = (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k1.fused_logmel(jnp.asarray(wav), jcfg, dft_mode="bf16"))
    got = _plan(torch.from_numpy(wav), cfg)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)


@pytest.mark.parametrize("name", sorted(_audio_configs()))
def test_shipped_audio_configs_meet_the_alignment_rule(name):
    k1.check_tc_config(_frontend(_audio_configs()[name]))


@pytest.mark.parametrize("change", [dict(hop_length=476), dict(n_fft=1000, win_length=1000),
                                    dict(n_fft=2048, win_length=2048), dict(n_mels=80)])
def test_a_config_that_breaks_the_rule_raises(change):
    cfg = t_fe.FrontendConfig(**change)
    with pytest.raises(ValueError, match="fused_logmel bf16"):
        k1.check_tc_config(cfg)


@pytest.mark.parametrize("name", sorted(_audio_configs()) + ["fusion-htk"])
def test_every_audio_frontend_fits_both_routes(name):
    """Every HTSAT and PANN config, and the fusion mel, passes both routes'
    rule (the golden route runs the PANN towers and the fusion mel), and
    the golden layout holds the mel-active bins: the basis rows cover
    exactly the bins with a nonzero weight, whose first bin moves with the
    HTK filterbank's support at the low end."""
    cfg = FRONTENDS["fusion-htk"] if name == "fusion-htk" else _frontend(_audio_configs()[name])
    k1.check_tc_config(cfg, "bf16")
    k1.check_tc_config(cfg, "f32")
    lo, hi = t_fe.mel_active_bins(cfg)
    fb = t_fe.mel_filterbank(cfg)
    assert fb[lo].any() and fb[hi - 1].any() and not fb[:lo].any() and not fb[hi:].any()
    bt, mw = k1._tc_layout(cfg)
    assert bt.shape[0] % 128 == 0 and bt.shape[0] >= 2 * (hi - lo)
    np.testing.assert_array_equal(mw[: hi - lo, : cfg.n_mels], fb[lo:hi])
    assert not mw[hi - lo:].any() and not bt[2 * (hi - lo):].any()


def test_htk_plan_has_the_slaney_bins_and_its_own_weights():
    """At HTSAT's 50 Hz - 14 kHz the HTK filterbank is nonzero on the same
    FFT bins as the Slaney one (2 to 298), so the golden plan has the same
    shape; its mel weights (no area norm) are its own, cached per config."""
    slaney, htk = FRONTENDS["CLAPConfig"], FRONTENDS["fusion-htk"]
    assert (htk.mel_scale, htk.mel_norm) == ("htk", None)
    assert t_fe.mel_active_bins(htk) == t_fe.mel_active_bins(slaney) == (2, 299)
    (bt_h, mw_h), (bt_s, mw_s) = k1._tc_layout(htk), k1._tc_layout(slaney)
    np.testing.assert_array_equal(bt_h, bt_s)
    assert mw_h.shape == mw_s.shape and not np.allclose(mw_h, mw_s)
