"""The port's data layer, native decoder and fold entry points held against
the JAX package on the CPU: the polyphase ``resample_poly`` against the
JAX package's direct form (0.01-0.05 s inputs, within 1e-5), ``load_wav``
on 8/16/32-bit mono and stereo PCM, the C decoder bit for bit against its
numpy version, the registry and the CSV reader, ``get_fold_loaders`` on a
temporary ESC-50-shaped tree, and the linear-probe and zero-shot CLIs
(``training/lp_main.py``, ``evaluate/eval_zeroshot_classification.py``) on
the fixture's narrow model against the JAX package's.
"""

import json
import unittest.mock as mock
import wave
import zipfile

import jax
import numpy as np
import pytest
import torch

from audio_residual_tpu import module as j_module
from audio_residual_tpu.data import datasets as j_ds
from audio_residual_tpu.evaluate import eval_zeroshot_classification as j_eval
from audio_residual_tpu.models import convert as j_convert
from audio_residual_tpu.models import factory as j_factory
from audio_residual_tpu.training import linear_probe as j_lp
from audio_residual_tpu.training import lp_main as j_lp_main
from audio_residual_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from audio_residual_tpu_torch import native
from audio_residual_tpu_torch.data import datasets as t_ds
from audio_residual_tpu_torch.evaluate import eval_zeroshot_classification as t_eval
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models.convert import load_jax_params
from audio_residual_tpu_torch.training import linear_probe as t_lp
from audio_residual_tpu_torch.training import lp_main as t_lp_main
from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

# (sr_in, sr_out, seconds): the direct form costs ~0.03 s of CPU a
# millisecond of 44.1 kHz input, so that rate takes the shorter inputs
RESAMPLES = [(44100, 48000, 0.01), (44100, 48000, 0.02), (22050, 48000, 0.01),
             (22050, 48000, 0.03), (16000, 48000, 0.01), (16000, 48000, 0.05),
             (48000, 32000, 0.01), (48000, 32000, 0.05)]


def _write_wav(path, samples: np.ndarray, sr: int, width: int) -> None:
    """``samples [T, channels]`` in [-1, 1) as PCM of ``width`` bytes."""
    if width == 1:
        data = np.clip(samples * 128 + 128, 0, 255).astype(np.uint8)
    else:
        dtype = {2: np.int16, 4: np.int32}[width]
        data = (samples * np.iinfo(dtype).max).astype(dtype)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(samples.shape[1])
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())


@pytest.mark.parametrize("sr_in,sr_out,seconds", RESAMPLES)
def test_resample_poly_matches_jax(rng, sr_in, sr_out, seconds):
    x = (rng.standard_normal(int(sr_in * seconds)) * 0.3).astype(np.float32)
    got = t_ds.resample_poly(x, sr_in, sr_out)
    want = j_ds.resample_poly(x, sr_in, sr_out)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resample_poly_short_input_and_same_rate(rng):
    """An input shorter than the filter (np.convolve's "same" then keeps the
    filter's length) and the identity."""
    x = rng.standard_normal(3).astype(np.float32)
    np.testing.assert_allclose(t_ds.resample_poly(x, 8000, 48000),
                               j_ds.resample_poly(x, 8000, 48000), atol=1e-5)
    assert t_ds.resample_poly(x, 48000, 48000) is x


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_load_wav_matches_jax(rng, tmp_path, width, channels):
    path = tmp_path / "clip.wav"
    _write_wav(path, rng.uniform(-0.9, 0.9, (800, channels)), 16000, width)
    got, sr = t_ds.load_wav(str(path))
    want, j_sr = j_ds.load_wav(str(path))
    assert sr == j_sr == 16000 and got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    got, sr = t_ds.load_wav(str(path), target_sr=48000)
    want, _ = j_ds.load_wav(str(path), target_sr=48000)
    assert sr == 48000
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("bits", [16, 32])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_native_decode_bit_equal_to_numpy(rng, bits, channels):
    dtype = np.int16 if bits == 16 else np.int32
    info = np.iinfo(dtype)
    raw = rng.integers(info.min, info.max, 4000 * channels, endpoint=True).astype(dtype).tobytes()
    c, plain = ((native.pcm16_to_float32_mono, native.pcm16_to_float32_mono_plain) if bits == 16
                else (native.pcm32_to_float32_mono, native.pcm32_to_float32_mono_plain))
    got, want = c(raw, channels), plain(raw, channels)
    assert got.dtype == want.dtype == np.float32 and got.shape == (4000,)
    np.testing.assert_array_equal(got, want)


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile raises with gcc's message; nothing
    falls back to numpy."""
    bad = tmp_path / "wavio.c"
    bad.write_text("this is not C;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed to build") as e:
        native.pcm16_to_float32_mono(b"\0\0", 1)
    assert "error" in str(e.value)


def test_registry_and_prompts_match_jax():
    assert json.dumps(t_ds.DATASETS, sort_keys=True) == json.dumps(j_ds.DATASETS, sort_keys=True)
    for name in t_ds.DATASETS:
        assert t_ds.class_prompts(name) == j_ds.class_prompts(name)


def _esc50_tree(root, rng, folds: int = 2, per_fold: int = 8, sr: int = 16000) -> list:
    """An ESC-50-shaped tree under ``root``: ``esc50.csv`` in the dataset's
    layout and seeded PCM16 WAVs of 0.05-0.2 s, stereo and mono."""
    spec = t_ds.DATASETS["ESC50"]
    audio = root / spec["audio_dir"]
    audio.mkdir(parents=True)
    (root / spec["csv_path"]).parent.mkdir(parents=True)
    rows = []
    for i in range(folds * per_fold):
        name = f"{1 + i % folds}-{100 + i}-A-{i % 50}.wav"
        n = int(sr * rng.uniform(0.05, 0.2))
        _write_wav(audio / name, rng.uniform(-0.5, 0.5, (n, 1 + i % 2)), sr, 2)
        rows.append(f"{name},{1 + i % folds},{int(rng.integers(0, 50))},cat,False,{100 + i},A")
    (root / spec["csv_path"]).write_text(
        "filename,fold,target,category,esc10,src_file,take\n" + "\n".join(rows) + "\n")
    return rows


def test_get_dataframe_and_fold_loaders_match_jax(rng, tmp_path):
    _esc50_tree(tmp_path, rng)
    df = t_ds.get_dataframe("ESC50", str(tmp_path))
    jdf = j_ds.get_dataframe("ESC50", str(tmp_path))
    assert df["filename"] == list(jdf["filename"])
    np.testing.assert_array_equal(df["target"], jdf["target"])
    np.testing.assert_array_equal(df["fold"], jdf["fold"])
    got = t_ds.get_fold_loaders("ESC50", str(tmp_path), batch_size=3)
    want = j_ds.get_fold_loaders("ESC50", str(tmp_path), batch_size=3)
    assert len(got) == len(want) == 2
    for (gt, gv), (wt, wv) in zip(got, want):
        for g, w in ((gt, wt), (gv, wv)):
            gb, wb = list(g()), list(w())
            assert len(gb) == len(wb)
            for (gw, gy), (ww, wy) in zip(gb, wb):
                np.testing.assert_array_equal(gy, wy)
                assert gw.shape == ww.shape
                np.testing.assert_allclose(gw, ww, rtol=0, atol=1e-5)
        assert [len(y) for _, y in gt()] == [3, 3, 2]


def test_urbansound_frame_and_archives(tmp_path):
    """UrbanSound8K's files live in ``fold{n}/``; a missing tree names the
    archive's path and URL and downloads nothing; an archive on disk is
    extracted."""
    spec = t_ds.DATASETS["UrbanSound8K"]
    with pytest.raises(FileNotFoundError, match="zenodo.org"):
        t_ds.get_dataframe("UrbanSound8K", str(tmp_path))
    csv_path = tmp_path / spec["csv_path"]
    csv_path.parent.mkdir(parents=True)
    csv_path.write_text("slice_file_name,fsID,start,end,salience,fold,classID,class\n"
                        "a.wav,1,0,1,1,3,7,jackhammer\nb.wav,2,0,1,1,10,2,drilling\n")
    df = t_ds.get_dataframe("UrbanSound8K", str(tmp_path))
    jdf = j_ds.get_dataframe("UrbanSound8K", str(tmp_path))
    assert df["filename"] == list(jdf["filename"]) == ["fold3/a.wav", "fold10/b.wav"]
    archive = tmp_path / "data" / "esc50.zip"
    with pytest.raises(FileNotFoundError, match=str(archive)):
        t_ds.download_dataset(t_ds.DATASETS["ESC50"]["url"], str(archive))
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("ESC-50-master/meta/esc50.csv", "filename,fold,target\nx.wav,1,4\n")
    out = t_ds.download_dataset("unused", str(archive))
    assert out == str(tmp_path / "data" / "esc50")
    assert t_ds.get_dataframe("ESC50", str(tmp_path))["target"].tolist() == [4]


# -- the CLIs on the fixture's narrow model ------------------------------------


def test_lp_main_matches_jax(rng, tmp_path, monkeypatch):
    """Two folds of an ESC-50-shaped tree through both packages' linear-probe
    CLIs: the fixture's narrow model (``create_model`` swapped in both), the
    heads from the JAX package's initial head, per-fold metrics and their
    aggregate."""
    _esc50_tree(tmp_path / "ds", rng)
    params, cfg = fx.jax_params(), fx.jax_config()
    monkeypatch.setattr(j_factory, "create_model", lambda *a, **k: (params, cfg, {}))
    port_cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW), **fx.CLAP_KW)
    port = load_jax_params(t_clap.build_clap_audio(port_cfg, device="cpu"),
                           {k: params[k] for k in ("audio_branch", "audio_projection")})
    monkeypatch.setattr(t_factory, "create_model", lambda *a, **k: (port, port_cfg, {}))
    monkeypatch.setattr(t_lp, "init_linear_head", lambda seed, in_dim=512, n_classes=50,
                        mlp=False, device=None: {
        k: {p: torch.tensor(np.asarray(v)) for p, v in layer.items()}
        for k, layer in j_lp.init_linear_head(jax.random.PRNGKey(seed), in_dim, n_classes,
                                              mlp=mlp).items()})
    argv = ["--datasetpath", str(tmp_path / "ds"), "--batch-size", "4", "--epochs", "3",
            "--lp-lr", "1e-2", "--lp-loss", "ce", "--lp-metrics", "acc,map,mauc", "--seed",
            "3"]
    got = t_lp_main.main(argv + ["--logs", str(tmp_path / "port")], device="cpu")
    want = j_lp_main.main(argv + ["--logs", str(tmp_path / "jax")])
    assert [m["fold"] for m in got["per_fold"]] == [0, 1]
    for g, w in zip(got["per_fold"], want["per_fold"]):
        assert g["acc"] == w["acc"]
        np.testing.assert_allclose([g["map"], g["mauc"]], [w["map"], w["mauc"]], rtol=1e-5,
                                   equal_nan=True)
    np.testing.assert_allclose(list(got["aggregate"].values()), list(want["aggregate"].values()),
                               rtol=1e-5, equal_nan=True)
    assert (tmp_path / "port" / "lp_run" / "results.jsonl").exists()


def test_eval_zeroshot_classification_matches_jax(rng, tmp_path, monkeypatch):
    """Both packages' zero-shot CLIs on the CLAP fixture's narrow model over
    every fold's clips: the same metrics. (The JAX package's CLI runs
    non-fusion models only: its CLAPModule sends a fusion model the
    waveform, ``test_torch_fusion.py``.)"""
    _esc50_tree(tmp_path, rng)
    jcfg = fx.jax_clap_config("roberta")
    jparams = j_convert.convert_clap_state_dict(fx.clap_weights("roberta"), fx.AUDIO_KW["depths"])
    monkeypatch.setattr(j_factory, "create_model", lambda *a, **k: (jparams, jcfg, {}))
    monkeypatch.setattr(j_module, "load_default_tokenizer", lambda n: JHashTokenizer(
        vocab_size=1000, context_length=fx.CLAP_CONTEXT))
    cfg = fx.port_clap_config("roberta")
    model = t_clap.build_clap(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in fx.clap_weights("roberta").items()})
    model_cfg = t_factory.get_model_config("HTSAT-tiny")
    argv = ["--datasetpath", str(tmp_path), "--batch-size", "4"]
    with mock.patch.object(t_factory, "create_model", lambda *a, **k: (model, cfg, model_cfg)):
        got = t_eval.main(argv + ["--out", str(tmp_path / "port.json")], device="cpu",
                          tokenizer=HashTokenizer(vocab_size=1000,
                                                  context_length=fx.CLAP_CONTEXT))["init"]
    want = j_eval.main(argv)["init"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    assert json.loads((tmp_path / "port.json").read_text())["init"].keys() == got.keys()
