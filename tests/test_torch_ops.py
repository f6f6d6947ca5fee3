"""The PyTorch port's plain ops held against the JAX package on the CPU.

Constant builders must be equal; the int16 round-trip bit-exact; f32 ops
agree to float32 rounding of differently ordered sums (tolerances stated
per test).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.data import featurize as j_feat
from audio_residual_tpu.ops import frontend as j_fe
from audio_residual_tpu.ops import interpolate as j_interp
from audio_residual_tpu.ops import quantize as j_quant
from audio_residual_tpu.ops import windows as j_win
from audio_residual_tpu.residual import module as j_res
from audio_residual_tpu_torch.data import featurize as t_feat
from audio_residual_tpu_torch.ops import frontend as t_fe
from audio_residual_tpu_torch.ops import interpolate as t_interp
from audio_residual_tpu_torch.ops import quantize as t_quant
from audio_residual_tpu_torch.ops import windows as t_win
from audio_residual_tpu_torch.residual import module as t_res

HTK = dict(mel_scale="htk", mel_norm=None)


def _fe_cfgs(mod):
    return {
        "default": mod.FrontendConfig(),
        "htk": mod.FrontendConfig(**HTK),
        "tiny": mod.FrontendConfig(n_mels=16),
        "pann": mod.FrontendConfig(n_fft=1536, win_length=1536, fmax=18000.0),
    }


@pytest.mark.parametrize("name", ["default", "htk", "tiny", "pann"])
def test_mel_constants_equal_jax(name):
    """Same numpy code on both sides: exact equality."""
    jc, tc = _fe_cfgs(j_fe)[name], _fe_cfgs(t_fe)[name]
    np.testing.assert_array_equal(t_fe.mel_filterbank(tc), j_fe.mel_filterbank(jc))
    assert t_fe.mel_active_bins(tc) == j_fe.mel_active_bins(jc)
    for a, b in zip(t_fe._dft_bases(tc.n_fft, tc.win_length),
                    j_fe._dft_bases(jc.n_fft, jc.win_length)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_fe.hann_window(tc.win_length), j_fe.hann_window(jc.win_length))
    assert tc.num_frames(240000) == jc.num_frames(240000)


@pytest.mark.parametrize("in_size,out_size", [(1001, 1024), (51, 256), (64, 64), (1, 8), (300, 64)])
def test_bicubic_matrix_equals_jax(in_size, out_size):
    np.testing.assert_array_equal(
        t_interp.bicubic_matrix(in_size, out_size), j_interp.bicubic_matrix(in_size, out_size)
    )


@pytest.mark.parametrize("h,w,window,shift", [(16, 16, 8, 4), (64, 64, 8, 4), (32, 32, 8, 4)])
def test_window_constants_equal_jax(h, w, window, shift):
    np.testing.assert_array_equal(
        t_win.shift_window_mask(h, w, window, shift), j_win.shift_window_mask(h, w, window, shift)
    )
    np.testing.assert_array_equal(
        t_win.relative_position_index(window, window), j_win.relative_position_index(window, window)
    )


def test_quantize_bit_exact(rng):
    x = (rng.standard_normal((4, 5000)) * 0.7).astype(np.float32)  # some |x| > 1: clamps
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(t_quant.quantize_roundtrip(tx).numpy(),
                                  np.asarray(j_quant.quantize_roundtrip(jnp.asarray(x))))
    i16 = t_quant.float32_to_int16(tx)
    assert i16.dtype == torch.int16
    np.testing.assert_array_equal(i16.numpy(), np.asarray(j_quant.float32_to_int16(jnp.asarray(x))))
    np.testing.assert_array_equal(
        t_quant.int16_to_float32(i16).numpy(),
        np.asarray(j_quant.int16_to_float32(jnp.asarray(i16.numpy()))),
    )


@pytest.mark.parametrize("shape,target", [((2, 300), 500), ((700,), 500), ((500,), 500)])
def test_pad_or_truncate_matches_jax(rng, shape, target):
    x = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(  # stereo mean: f32 sum order, 1 ulp
        t_quant.pad_or_truncate(torch.from_numpy(x), target).numpy(),
        np.asarray(j_quant.pad_or_truncate(jnp.asarray(x), target)), rtol=1e-6, atol=1e-7,
    )


@pytest.mark.parametrize(
    "t,filling", [(300, "repeatpad"), (300, "pad"), (300, "repeat"), (700, "repeat"), (1000, "pad")]
)
def test_featurize_filling_matches_jax(rng, t, filling):
    wav = rng.standard_normal((3, t)).astype(np.float32)
    got = t_feat.featurize_batch(torch.from_numpy(wav), 1000, data_filling=filling)
    ref = j_feat.featurize_batch(jnp.asarray(wav), 1000, data_filling=filling)
    np.testing.assert_array_equal(got["waveform"].numpy(), np.asarray(ref["waveform"]))
    np.testing.assert_array_equal(got["longer"].numpy(), np.asarray(ref["longer"]))


def test_featurize_rand_trunc_with_injected_starts(rng):
    """The JAX crops come from jax.random: hand its starts to the port."""
    wav = rng.standard_normal((3, 1300)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    starts = np.array(jax.random.randint(key, (3,), 0, 1300 - 1000 + 1))
    ref = j_feat.featurize_batch(jnp.asarray(wav), 1000, rng=key)
    got = t_feat.featurize_batch(torch.from_numpy(wav), 1000, starts=torch.from_numpy(starts))
    np.testing.assert_array_equal(got["waveform"].numpy(), np.asarray(ref["waveform"]))
    assert got["longer"].all()
    g = torch.Generator().manual_seed(3)
    crop = t_feat.featurize_batch(torch.from_numpy(wav), 1000, generator=g)["waveform"]
    assert crop.shape == (3, 1000)


@pytest.mark.parametrize("name", ["default", "htk", "tiny"])
def test_logmel_matches_jax(rng, name):
    """Both sides: rfft power, f32 mel product. 1e-3 dB covers f32 FFT
    rounding over the ~100 dB range of noise log-mels."""
    jc, tc = _fe_cfgs(j_fe)[name], _fe_cfgs(t_fe)[name]
    wav = (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32)
    got = t_fe.logmel(torch.from_numpy(wav), tc).numpy()
    ref = np.asarray(j_fe.logmel(jnp.asarray(wav), jc))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_batch_norm_mel_eval_matches_jax(rng):
    x = rng.standard_normal((2, 51, 16)).astype(np.float32)
    p = {k: rng.standard_normal(16).astype(np.float32) for k in ("scale", "bias", "mean")}
    p["var"] = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    ref, _ = j_fe.batch_norm_mel(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got = t_fe.batch_norm_mel(torch.from_numpy(x), *(torch.from_numpy(p[k])
                                                    for k in ("scale", "bias", "mean", "var")))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,out", [((2, 1001, 64), (1024, 64)), ((2, 51, 16), (256, 16)),
                                       ((1, 40, 30), (64, 48))])
def test_resize_bicubic_matches_jax(rng, shape, out):
    """f32 matmul with a constant matrix; sums of <= 4 taps: 1e-5."""
    x = rng.standard_normal(shape).astype(np.float32)
    got = t_interp.resize_bicubic_align_corners(torch.from_numpy(x), *out).numpy()
    ref = np.asarray(j_interp.resize_bicubic_align_corners(jnp.asarray(x), *out))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    r = rng.standard_normal((2, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(t_interp.repeat_frames(torch.from_numpy(r), 4).numpy(),
                                  np.asarray(j_interp.repeat_frames(jnp.asarray(r), 4)))


def test_window_ops_match_jax(rng):
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    wins = t_win.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(j_win.window_partition(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(t_win.window_reverse(wins, 8, 16, 16).numpy(), x)
    table = rng.standard_normal((225, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        t_win.gather_relative_bias(torch.from_numpy(table), 8, 8).numpy(),
        np.asarray(j_win.gather_relative_bias(jnp.asarray(table), 8, 8)),
    )


def test_residual_apply_and_pickle_match_jax(rng, tmp_path):
    """f32 products of 96-wide vectors: 1e-5."""
    c = 96
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    mean = rng.standard_normal(c).astype(np.float32) * 0.01
    x = rng.standard_normal((64, c)).astype(np.float32)
    jp = j_res.init_residual_params(q, mean, n_components=48)
    tp = t_res.init_residual_params(q, mean, n_components=48, device="cpu")
    lam = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    jp["lam"], tp["lam"] = jnp.asarray(lam), torch.from_numpy(lam)
    ref = j_res.residual_apply(jnp.asarray(x), jp["basis"], jp["mean"], jp["lam"])
    got = t_res.residual_apply(torch.from_numpy(x), tp["basis"], tp["mean"], tp["lam"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    # same pickle schema both ways
    path = tmp_path / "res.pkl"
    t_res.save_residual_params(str(path), tp, extra={"layer": 0})
    back = j_res.load_residual_params(str(path))
    np.testing.assert_array_equal(np.asarray(back["basis"]), tp["basis"].numpy())
    with open(path, "rb") as f:
        assert pickle.load(f)["layer"] == 0
    j_res.save_residual_params(str(path), jp)
    again = t_res.load_residual_params(str(path), n_components=16, device="cpu")
    np.testing.assert_array_equal(again["basis"].numpy(), np.asarray(jp["basis"])[:16])
    np.testing.assert_array_equal(again["lam"].numpy(), np.ones(16, np.float32))
