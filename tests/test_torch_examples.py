"""The port's experiment drivers (``audio_residual_tpu_torch/examples/``) held
against the JAX package's scripts (``examples/``) on the CPU, on the same
seeds and weights:

  * ``full_workflow --size tiny`` at reduced sizes, the port on the JAX
    script's tiny weights and the JAX probe heads: the PCA pickles (mean
    and spectrum to 1e-5; each component the data determines up to its sign,
    to 1e-5 scaled by its eigengap: ``_pca_close``), the trained λ of those
    components and the loss history to 1e-5, the ``.npz`` predictions equal
    and their similarities to 1e-5 (a ResiDual's to 2e-4:
    ``RESIDUAL_SIMS``), the ``checks`` equal;
  * the three notebook drivers on a seeded ESC-50-layout tree (2 folds, 8
    clips of 0.25 s at 48 kHz)
    through a narrow ``CLAPModule`` (HTSAT with 4x4 windows, so the
    attention PCA is 256 wide and takes the dense finalize in both
    packages): the CSV (spectra to 1e-5), the PCA pickles, the npz and
    ``ESC50_table.json`` (to 1e-5);
  * ``esc50_api``'s metric arithmetic against the JAX script's, run as a
    script with ``CLAPModule`` swapped for seeded embeddings, and its file
    path on WAV files (one at 44.1 kHz: the port's resample);
  * ``perf_breakdown`` at B = 2 on the tiny config: the stage keys, every
    value positive;
  * every ``examples/launch/*.sh`` counterpart's flags through the port's
    parsers.
"""

import contextlib
import glob
import importlib
import importlib.util
import io
import json
import os
import pickle
import re
import runpy
import shlex
import sys
import time
import wave

import jax
import numpy as np
import pytest
import torch

from audio_residual_tpu import module as j_module
from audio_residual_tpu.models import convert as j_convert
from audio_residual_tpu.models import factory as j_factory
from audio_residual_tpu.models import htsat as j_htsat
from audio_residual_tpu.training import linear_probe as j_lp
from audio_residual_tpu.training import train_residual as j_tr
from audio_residual_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from audio_residual_tpu_torch import module as t_module
from audio_residual_tpu_torch.examples import analyze_clap_attention as t_d1
from audio_residual_tpu_torch.examples import apply_residual_to_clap as t_d2
from audio_residual_tpu_torch.examples import esc50_api as t_esc
from audio_residual_tpu_torch.examples import evaluate_and_compare as t_d3
from audio_residual_tpu_torch.examples import full_workflow as t_fw
from audio_residual_tpu_torch.examples import perf_breakdown as t_pb
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models.convert import load_jax_params
from audio_residual_tpu_torch.ops.cuda import build
from audio_residual_tpu_torch.training import linear_probe as t_lp
from audio_residual_tpu_torch.training import train_residual as t_tr
from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
WORKFLOW_ARGV = ["--size", "tiny", "--per-split", "8", "--epochs", "4", "--folds", "2"]
# the notebook drivers' narrow model: the CLAP fixture's, with 4x4 windows
AUDIO_KW = {**fx.AUDIO_KW, "window_size": 4}
ESC50 = os.path.join("data", "esc50", "ESC-50-master")
CLIPS, FOLDS, SR = 8, 2, 48000
CLIP_LEN = AUDIO_KW["clip_samples"] // 2


def _jax_script(name: str):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


@pytest.fixture(autouse=True)
def build_cache(tmp_path, monkeypatch):
    """The drivers call ``enable_compile_cache()``: point it into the test's
    directory and restore the build directory afterwards."""
    monkeypatch.setenv("ART_COMPILE_CACHE", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)


@pytest.fixture
def jax_heads(monkeypatch):
    """The port's probe draws its initial head from a ``torch.Generator``:
    give it the JAX package's heads (``tests/test_torch_harness.py``)."""
    def init(seed, in_dim=512, n_classes=50, mlp=False, device=None):
        head = j_lp.init_linear_head(jax.random.PRNGKey(seed), in_dim, n_classes, mlp=mlp)
        return {k: {p: torch.tensor(np.asarray(v), device=device) for p, v in layer.items()}
                for k, layer in head.items()}

    monkeypatch.setattr(t_lp, "init_linear_head", init)


def _spy(monkeypatch, module, name: str, record: list):
    fn = getattr(module, name)

    def spy(*a, **k):
        out = fn(*a, **k)
        record.append(out)
        return out

    monkeypatch.setattr(module, name, spy)


def _pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _pca_close(got: dict, want: dict) -> None:
    """A PCA pickle: the mean to 1e-5, the spectrum to 1e-5 of its largest
    eigenvalue, and each component up to its sign to ``1e-5 * ev[0] /
    gap``, ``gap`` its eigenvalue's distance to its neighbours': a
    covariance that differs by ``e`` turns an eigenvector by up to about
    ``e / gap`` (Davis-Kahan), and the JAX package forms the covariance in
    f32. Components with a gap under 1e-3 of ``ev[0]`` (past the data's
    rank, where the spectrum is flat at 0) are not determined by the data
    and are not compared one by one; both sets are orthonormal, so the
    compared ones fix the span of the rest."""
    np.testing.assert_allclose(got["mean"], want["mean"], **TOL)
    ev = np.asarray(want["explained_variance"], np.float64)
    np.testing.assert_allclose(got["explained_variance"], ev, rtol=0, atol=1e-5 * ev[0])
    g, w = np.asarray(got["components"]), np.asarray(want["components"])
    assert g.shape == w.shape
    np.testing.assert_allclose(g @ g.T, np.eye(len(g)), atol=1e-4)
    gap = np.minimum(np.abs(np.diff(ev, prepend=np.inf)), np.abs(np.diff(ev, append=-np.inf)))
    resolved = np.flatnonzero(gap >= 1e-3 * ev[0])
    assert len(resolved) >= 2
    sign = np.sign((g * w).sum(-1, keepdims=True))
    err = np.abs(g * sign - w).max(-1)
    bound = 1e-5 * ev[0] / gap[resolved]
    assert (err[resolved] <= bound).all(), (err, gap / ev[0])
    return resolved, bound


def _lam_close(got, want, resolved, bound) -> None:
    """Trained λ of the resolved components within their components'
    bound. The others' gradients are rounding noise that Adam's
    normalisation turns into full steps of either sign."""
    got, want = np.asarray(got)[resolved], np.asarray(want)[resolved]
    assert (np.abs(got - want) <= np.maximum(bound, TOL["atol"])).all(), (got, want)


# A ResiDual eval's similarities: the λ of the unresolved components
# (``_lam_close``) differ by whole Adam steps between the packages, and the
# held-out clips' residual stream is not null along them, which moves the
# similarities by up to 2.4e-4 (measured). The eval itself is held to 1e-5
# on the JAX package's trained ResiDual (``test_full_workflow_matches_jax``).
RESIDUAL_SIMS = dict(rtol=0, atol=1e-3)


def _residual_of(path) -> dict:
    """A trained ResiDual pickle (components, mean, λ) as the port's params."""
    blob = _pickle(path)
    return {"basis": torch.from_numpy(np.asarray(blob["components"], np.float32)),
            "mean": torch.from_numpy(np.asarray(blob["mean"], np.float32)),
            "lam": torch.from_numpy(np.asarray(blob["lam"], np.float32))}


def _npz_close(got_path, want_path) -> None:
    got, want = np.load(got_path), np.load(want_path)
    np.testing.assert_array_equal(got["targets"], want["targets"])
    np.testing.assert_array_equal(got["predictions"], want["predictions"])
    tol = RESIDUAL_SIMS if "ResiDual" in str(got_path) else TOL
    np.testing.assert_allclose(got["similarities"], want["similarities"], **tol)


def _files(root) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_full_workflow_matches_jax(tmp_path, monkeypatch, jax_heads):
    j_fw = _jax_script("full_workflow")
    j_hist, t_hist = [], []
    _spy(monkeypatch, j_tr, "train_and_evaluate_residual", j_hist)
    _spy(monkeypatch, t_tr, "train_and_evaluate_residual", t_hist)
    want = j_fw.main(WORKFLOW_ARGV + ["--out-dir", str(tmp_path / "jax")])

    params, _, _ = j_fw.build_model("tiny", 0, None)
    model, _, _ = t_fw.build_model("tiny", 0, None, "cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    got = t_fw.main(WORKFLOW_ARGV + ["--out-dir", str(tmp_path / "port")], model=model)

    assert got["checks"] == want["checks"] and got["ok"] == want["ok"]
    max_len = model.cfg.audio.clip_samples
    folds, templates = t_fw.synth_folds(5, 2, 8, max_len // 2, 0)
    text = t_fw.anchored_text_embeds(model, templates, max_len, wav_noise=0.05,
                                     anchor_noise=1.2, seed=0)
    assert got["inject_layers"] == want["inject_layers"] == [1]
    for key in ("baseline_acc", "residual_acc", "linear_acc"):
        assert got[key] == want[key], key
    assert got["artifacts"]["npz"] == want["artifacts"]["npz"]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for fold in range(2):
        name = f"pca/SYNTH/layer_1_evalfold_{fold}"
        resolved = _pca_close(_pickle(tmp_path / "port" / name), _pickle(tmp_path / "jax" / name))
        res = f"eval/SYNTH/ResiDual/lambda_layer1_evalfold_{fold}.pkl"
        _lam_close(_pickle(tmp_path / "port" / res)["lam"], _pickle(tmp_path / "jax" / res)["lam"],
                   *resolved)
        for run_t, run_j in zip(t_hist[0][fold]["history"], j_hist[0][fold]["history"]):
            assert run_t["train_loss"] == pytest.approx(run_j["train_loss"], rel=1e-5, abs=1e-5)
            assert run_t["train_acc"] == run_j["train_acc"]
        # the port's eval of the JAX package's trained ResiDual: to 1e-5
        want_npz = np.load(tmp_path / "jax" / f"eval/SYNTH/ResiDual/layers_1_evalfold_{fold}.npz")
        preds, targets, sims = t_tr.evaluate_zero_shot(
            model, folds[fold][1](), text, max_len=max_len,
            residual={1: _residual_of(tmp_path / "jax" / res)})
        np.testing.assert_array_equal(preds, want_npz["predictions"])
        np.testing.assert_array_equal(targets, want_npz["targets"])
        np.testing.assert_allclose(sims, want_npz["similarities"], **TOL)
        for npz in (f"eval/SYNTH/ResiDual/layers_1_evalfold_{fold}.npz",
                    f"eval/SYNTH/Baseline/evalfold_{fold}.npz",
                    f"eval/SYNTH/Linear/evalfold_{fold}.npz"):
            _npz_close(tmp_path / "port" / npz, tmp_path / "jax" / npz)


def test_full_workflow_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib the two figures are skipped: their artifacts are
    null and the reason is printed; the rest of the run is unchanged."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    s = t_fw.main(["--size", "tiny", "--per-split", "4", "--epochs", "1", "--folds", "2",
                   "--out-dir", str(tmp_path)], device="cpu")
    assert s["artifacts"]["confusion_fig"] is None and s["artifacts"]["lambda_fig"] is None
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not list(tmp_path.glob("eval/*.png"))
    assert s["checks"]["loss_finite"] and s["lambda_moved"]


# ---- the notebook drivers on a seeded ESC-50 tree ---------------------------


def _write_wav(path, x: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1 - 2**-15) * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def esc50_tree(tmp_path_factory):
    """ESC-50's layout (``DATASETS["ESC50"]``): the csv and the audio
    directory, 2 folds of 4 clips of two classes, seeded tones in noise
    (every fold a driver runs compiles its JAX functions anew), at 48 kHz:
    the JAX package's direct-form resample of even a 0.01 s clip takes
    minutes of CPU under the suite's parallel workers. The resample path is
    ``test_esc50_api_reads_wav_files``'s and ``test_torch_datasets.py``'s."""
    root = tmp_path_factory.mktemp("esc50")
    audio = root / ESC50 / "audio"
    os.makedirs(audio)
    os.makedirs(root / ESC50 / "meta")
    rng = np.random.default_rng(5)
    rows = []
    for i in range(CLIPS):
        fold, target = 1 + i % FOLDS, 7 * ((i // FOLDS) % 2)
        name = f"{fold}-{1000 + i}-A-{target}.wav"
        tone = np.sin(2 * np.pi * (200 + 40 * target) * np.arange(CLIP_LEN) / SR)
        _write_wav(audio / name, 0.3 * tone + 0.05 * rng.standard_normal(tone.shape), SR)
        rows.append(f"{name},{fold},{target},c{target},False,{1000 + i},A")
    (root / ESC50 / "meta" / "esc50.csv").write_text(
        "filename,fold,target,category,esc10,src_file,take\n" + "\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def narrow_modules():
    """Factories of a port and a JAX ``CLAPModule`` on the same seeded narrow
    weights (the CLAP fixture's roberta model with 4x4 windows)."""
    cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**AUDIO_KW),
                            text=fx.port_clap_config("roberta").text,
                            context_length=fx.CLAP_CONTEXT, **fx.CLAP_KW)
    sd = fx._seeded_weights(t_clap.build_clap(cfg, device="cpu"), fx.CLAP_SEED)
    jcfg = fx.jax_clap_config("roberta")
    jcfg = type(jcfg)(audio=j_htsat.HTSATConfig(**AUDIO_KW), text=jcfg.text,
                      context_length=fx.CLAP_CONTEXT, **fx.CLAP_KW)
    params = j_convert.convert_clap_state_dict(sd, AUDIO_KW["depths"])
    model_cfg = t_factory.get_model_config("HTSAT-tiny")

    def port(**kw):
        model = t_clap.build_clap(cfg, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_factory, "create_model", lambda *a, **k: (model, cfg, model_cfg))
            return t_module.CLAPModule(device="cpu", tokenizer=HashTokenizer(
                vocab_size=1000, context_length=fx.CLAP_CONTEXT))

    def jax_module(**kw):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_factory, "create_model", lambda *a, **k: (params, jcfg, model_cfg))
            return j_module.CLAPModule(tokenizer=JHashTokenizer(
                vocab_size=1000, context_length=fx.CLAP_CONTEXT))

    return port, jax_module, sd


def _run_driver(monkeypatch, name: str, port_mod, narrow, argv_of, tmp_path):
    """The JAX script and the port's driver, each with its narrow module;
    ``argv_of(out)`` gives the arguments writing under ``out``."""
    port, jax_module, _ = narrow
    j_mod = _jax_script(name)
    monkeypatch.setattr(j_mod, "CLAPModule", jax_module)
    monkeypatch.setattr(port_mod, "CLAPModule", port)
    want = j_mod.main(argv_of(tmp_path / "jax"))
    got = port_mod.main(argv_of(tmp_path / "port"), device="cpu")
    return got, want


def _csv_rows(path):
    with open(path) as f:
        return [line.split(",") for line in f.read().splitlines()[1:]]


def test_analyze_clap_attention_matches_jax(tmp_path, monkeypatch, esc50_tree, narrow_modules):
    got, _ = _run_driver(
        monkeypatch, "1_analyze_clap_attention", t_d1, narrow_modules,
        lambda out: ["--root", str(esc50_tree), "--batch-size", "2", "--max-batches", "2",
                     "--save-dir", str(out)], tmp_path)
    rows_t = _csv_rows(tmp_path / "port" / "ESC50-fold0.csv")
    rows_j = _csv_rows(tmp_path / "jax" / "ESC50-fold0.csv")
    assert got["csv"] == str(tmp_path / "port" / "ESC50-fold0.csv")
    heads = AUDIO_KW["num_heads"]
    assert len(rows_t) == len(rows_j) == sum(heads) * AUDIO_KW["window_size"] ** 4
    assert set(got["heads"]) == {(i, h) for i in range(2) for h in range(heads[i])}
    for rt, rj in zip(rows_t, rows_j):
        assert rt[:3] == rj[:3]
        ev_max = float(rows_j[0][3])
        np.testing.assert_allclose(float(rt[3]), float(rj[3]), rtol=1e-5, atol=1e-6 * ev_max)
        np.testing.assert_allclose(float(rt[4]), float(rj[4]), rtol=1e-5, atol=1e-6)
        if rj[5]:
            np.testing.assert_allclose(float(rt[5]), float(rj[5]), rtol=1e-5)
            assert rt[6] == rj[6]


def test_apply_residual_and_evaluate_match_jax(tmp_path, monkeypatch, esc50_tree,
                                               narrow_modules, jax_heads):
    """Driver 2 (layer 0, 2 epochs) writes the PCA bases driver 3 (2 epochs)
    injects: the pickles, the three variants' npz and the table."""
    def d2_argv(out):
        return ["--root", str(esc50_tree), "--batch-size", "2", "--layers", "0", "--epochs",
                "2", "--pca-path", str(out / "pca")]

    got, _ = _run_driver(monkeypatch, "2_apply_residual_to_clap", t_d2, narrow_modules, d2_argv,
                         tmp_path)
    assert len(got["pca"]) == FOLDS and got["runs"][0]["config"]["inject_layers"] == [0]
    resolved = {}
    for fold in range(FOLDS):
        name = f"pca/ESC50/layer_0_evalfold_{fold}"
        resolved[str(fold)] = _pca_close(_pickle(tmp_path / "port" / name),
                                         _pickle(tmp_path / "jax" / name))

    def d3_argv(out):
        return ["--root", str(esc50_tree), "--batch-size", "2", "--epochs", "2",
                "--pca-path", str(out / "pca"), "--save-dir", str(out / "eval")]

    got, _ = _run_driver(monkeypatch, "3_evaluate_and_compare", t_d3, narrow_modules, d3_argv,
                         tmp_path)
    assert set(got) == {"baseline", "residual", "linear", "table"}
    assert _files(tmp_path / "port" / "eval") == _files(tmp_path / "jax" / "eval")
    for name in _files(tmp_path / "jax" / "eval"):
        if name.endswith(".npz"):
            _npz_close(tmp_path / "port" / "eval" / name, tmp_path / "jax" / "eval" / name)
        elif name.endswith(".pkl"):
            fold = name.rsplit("_", 1)[-1].removesuffix(".pkl")
            _lam_close(_pickle(tmp_path / "port" / "eval" / name)["lam"],
                       _pickle(tmp_path / "jax" / "eval" / name)["lam"], *resolved[fold])
    table_t = json.loads((tmp_path / "port" / "eval" / "ESC50_table.json").read_text())
    table_j = json.loads((tmp_path / "jax" / "eval" / "ESC50_table.json").read_text())
    assert set(table_t) == set(table_j) == {"Baseline", "ResiDual", "Linear"}
    for variant in table_j:
        assert set(table_t[variant]) == set(table_j[variant])
        for k, v in table_j[variant].items():
            assert table_t[variant][k] == pytest.approx(v, rel=1e-5, abs=1e-5), (variant, k)


# ---- esc50_api ---------------------------------------------------------------


class _Embeddings:
    """A ``CLAPModule`` stand-in that returns given embeddings."""

    def __init__(self, audio, text):
        self.audio, self.text = audio, text

    def __call__(self, **kw):
        return self

    def load_ckpt(self, ckpt=None, **kw):
        return self

    def get_text_embedding(self, texts):
        assert len(texts) == len(self.text)
        return self.text

    def get_audio_embedding_from_filelist(self, x):
        assert len(x) == len(self.audio)
        return self.audio


def _esc50_shards(root, names: list[str], tags: list[str], ext: str) -> str:
    """``root/test/<shard>/<name>.{ext,json}`` (the shards' layout, three
    shards in the names' order), the audio empty: the glob the script
    takes."""
    for i, (name, tag) in enumerate(zip(names, tags)):
        d = root / "test" / str(3 * i // len(names))
        os.makedirs(d, exist_ok=True)
        (d / f"{name}.json").write_text(json.dumps({"tag": [tag], "text": ""}))
        if ext:
            (d / f"{name}.{ext}").write_bytes(b"")
    return str(root / "test") + "/*/"


def _jax_esc50_api(monkeypatch, argv, stand_in) -> str:
    monkeypatch.setattr(j_module, "CLAPModule", stand_in)
    monkeypatch.setattr(sys, "argv", ["esc50_api.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(REPO, "examples", "esc50_api.py"), run_name="__main__")
    return out.getvalue().strip().splitlines()[-1]


@pytest.mark.parametrize("seed", [0, 1])
def test_esc50_api_metrics_match_jax(tmp_path, monkeypatch, capsys, seed):
    """Seeded embeddings of 40 clips over the 50 class prompts: the JAX
    script's printed metrics equal the port's, and
    ``retrieval_metrics`` returns them."""
    labels = json.loads(open(os.path.join(
        REPO, "class_labels", "ESC50_class_labels_indices_space.json")).read())
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((40, 16)).astype(np.float32)
    text = rng.standard_normal((len(labels), 16)).astype(np.float32)
    tags = [list(labels)[i] for i in rng.integers(0, len(labels), 40)]
    names = [f"clip{i:03d}" for i in range(40)]
    glob_dir = _esc50_shards(tmp_path, names, tags, "flac")
    stand_in = _Embeddings(audio, text)
    label_path = os.path.join(REPO, "class_labels", "ESC50_class_labels_indices_space.json")
    want = _jax_esc50_api(monkeypatch, [glob_dir, label_path], stand_in)
    monkeypatch.setattr(t_esc, "CLAPModule", stand_in)
    capsys.readouterr()
    got = t_esc.main([glob_dir, label_path])
    assert capsys.readouterr().out.strip() == want
    truth = np.array([labels[t] for t in tags])[:, None]
    assert t_esc.retrieval_metrics(audio, text, truth) == got
    assert got["R@1"] <= got["R@5"] <= got["R@10"] and 1 <= got["mean_rank"] <= len(labels)


def test_esc50_api_reads_wav_files(tmp_path, monkeypatch, narrow_modules):
    """The port's file path on seeded WAV shards (the script's FLAC glob
    redirected to them: the port decodes WAV only; one clip at 44.1 kHz,
    resampled to the model's 48) with
    a checkpoint of the narrow model: the metrics are the JAX script's
    arithmetic on the port's embeddings of those files."""
    port, _, sd = narrow_modules
    labels = {"dog": 0, "rooster": 1, "rain": 2}
    tags = ["dog", "rain", "rooster", "rain", "dog", "dog"]
    names = [f"clip{i}" for i in range(len(tags))]
    glob_dir = _esc50_shards(tmp_path, names, tags, "flac")
    rng = np.random.default_rng(2)
    for i, name in enumerate(names):
        sr = 44100 if i == 0 else SR  # decoded through the port's resample
        _write_wav(tmp_path / "test" / str(3 * i // len(names)) / f"{name}.wav",
                   0.2 * rng.standard_normal(CLIP_LEN * sr // SR), sr)
    label_path = tmp_path / "labels.json"
    label_path.write_text(json.dumps(labels))
    ckpt = tmp_path / "narrow.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    monkeypatch.setattr(t_esc, "CLAPModule", port)
    real_glob = glob.glob
    with monkeypatch.context() as m:
        m.setattr(t_esc.glob, "glob",
                  lambda p, **kw: real_glob(p.replace("*.flac", "*.wav"), **kw))
        got = t_esc.main([glob_dir, str(label_path), str(ckpt)], device="cpu")
    m = port()
    wavs = sorted(str(p) for p in tmp_path.glob("test/*/*.wav"))
    audio = m.get_audio_embedding_from_filelist(wavs)
    text = m.get_text_embedding(["This is a sound of " + t for t in labels])
    want = _jax_esc50_api(monkeypatch, [glob_dir, str(label_path)], _Embeddings(audio, text))
    values = [float(v) for v in re.findall(r": (-?[\d.]+)", want)]
    np.testing.assert_allclose([round(float(v), 4) for v in got.values()], values, atol=1e-12)


def test_esc50_api_refuses_a_missing_checkpoint(tmp_path, monkeypatch, narrow_modules):
    """No checkpoint given and none next to the package: the port downloads
    nothing and says where to put it."""
    monkeypatch.setattr(t_esc, "CLAPModule", narrow_modules[0])
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        t_esc.main([str(tmp_path) + "/", os.path.join(
            REPO, "class_labels", "ESC50_class_labels_indices_space.json")], device="cpu")


# ---- perf_breakdown ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_perf_breakdown_stages(monkeypatch, capsys, dtype):
    """Every stage runs and is timed. One call each by the host clock:
    ``measure_seconds`` (tests/test_torch_utils.py) retries at 4x and 16x
    the loop while a CPU's jitter hides the difference, which makes this
    test's time depend on the machine's load."""
    monkeypatch.setenv("BENCH_DTYPE", dtype)
    monkeypatch.setenv("BENCH_BATCH", "2")

    def once(fn, args):
        t0 = time.perf_counter()
        fn(*args)
        return (time.perf_counter() - t0) * 1e6

    monkeypatch.setattr(t_pb, "measure", once)
    model, _ = fx._port_with_residual(fx.load(), "cpu")
    s = t_pb.main([], model=model)
    keys = {"featurize", "logmel_only", "frontend_patch", "layer_0", "layer_1",
            "layer_3+head+sims", "total", "total_residual"}
    assert set(s["us_per_clip"]) == keys
    assert all(v > 0 for v in s["us_per_clip"].values()), s
    assert s["batch"] == 2 and s["dtype"] == dtype and s["device"] == "cpu"
    assert set(s["share"]) == keys - {"total", "total_residual"}
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line.removeprefix("PERF_BREAKDOWN ")) == s


# ---- launch scripts ------------------------------------------------------------

LAUNCH = os.path.join(REPO, "audio_residual_tpu_torch", "examples", "launch")


def _launch_command(path: str) -> tuple[str, list[str]]:
    """The ``python -m <module>`` or ``torchrun ... -m <module>`` command of a
    launch script: ``(module, its arguments)``."""
    text = open(path).read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines()
                if re.search(r"\b(torchrun|python)\b.*\s-m\s", ln))
    words = shlex.split(line.replace('"$@"', "ckpt.pt"))
    i = words.index("-m")
    return words[i + 1], words[i + 2:]


def _parse(module: str, argv: list[str]):
    from audio_residual_tpu_torch.evaluate import eval_retrieval_main, eval_zeroshot_classification
    from audio_residual_tpu_torch.training import params

    parsers = {
        "audio_residual_tpu_torch.training.main": params.parse_args,
        "audio_residual_tpu_torch.training.lp_main": params.parse_args,
        "audio_residual_tpu_torch.evaluate.eval_zeroshot_classification":
            eval_zeroshot_classification.parse_args,
        "audio_residual_tpu_torch.evaluate.eval_retrieval_main": eval_retrieval_main.parse_args,
    }
    return parsers[module](argv)


JAX_LAUNCH = sorted(os.listdir(os.path.join(REPO, "examples", "launch")))
# The JAX retrieval launch's flags that its own module does not take: its
# parser refuses these seven (training/params.py's flags), and --pretrained
# names a run's checkpoint directory where the parser wants one checkpoint.
# The port's launch passes --split and --ckpt-dir in their place.
JAX_RETRIEVAL_REFUSED = ("--dataset-type", "--precision", "--datasetinfos", "--seed", "--logs",
                         "--data-filling", "--data-truncating")
JAX_LAUNCH_DEFECTS = {"eval_retrieval_freesound-tpu.sh": {*JAX_RETRIEVAL_REFUSED, "--pretrained"}}


@pytest.mark.parametrize("name", JAX_LAUNCH)
def test_launch_script_flags_parse(name):
    """Each JAX launch script has a counterpart (``-tpu`` dropped) whose
    command runs a port module under ``torchrun`` or ``python`` with the
    same flags (less those the JAX module itself does not take), and the
    port's parser takes every one of them."""
    port_name = name.replace("-tpu.sh", ".sh")
    path = os.path.join(LAUNCH, port_name)
    module, argv = _launch_command(path)
    j_module_name, j_argv = _launch_command(os.path.join(REPO, "examples", "launch", name))
    assert module == j_module_name.replace("audio_residual_tpu.", "audio_residual_tpu_torch.")
    flags = lambda a: [w for w in a if w.startswith("--")]  # noqa: E731
    want = set(flags(j_argv)) - JAX_LAUNCH_DEFECTS.get(name, set())
    assert want <= set(flags(argv)), want - set(flags(argv))
    with contextlib.redirect_stderr(io.StringIO()) as err:
        try:
            args = _parse(module, argv)
        except SystemExit:
            pytest.fail(f"{port_name}: the parser refused {argv}: {err.getvalue()}")
    assert args is not None
    launcher = open(path).read().replace("\\\n", " ")
    assert not re.search(r"^\s*srun\b", launcher, re.M)


@pytest.mark.parametrize("flag", JAX_RETRIEVAL_REFUSED)
def test_jax_retrieval_launch_flags_refused(flag):
    """Each flag the port's retrieval launch leaves out is one that the JAX
    launch passes and the JAX module's parser refuses (a defect of the
    reference's launch); the port's parser refuses it too."""
    from audio_residual_tpu.evaluate import eval_retrieval_main as j_erm
    from audio_residual_tpu_torch.evaluate import eval_retrieval_main as t_erm

    _, j_argv = _launch_command(
        os.path.join(REPO, "examples", "launch", "eval_retrieval_freesound-tpu.sh"))
    i = j_argv.index(flag)
    argv = ["--datasetpath", "shards", *j_argv[i:i + 2]]
    for parse in (j_erm.main, t_erm.parse_args):
        with contextlib.redirect_stderr(io.StringIO()) as err, pytest.raises(SystemExit):
            parse(argv)
        assert "unrecognized arguments" in err.getvalue() and flag in err.getvalue()
    _, port_argv = _launch_command(os.path.join(LAUNCH, "eval_retrieval_freesound.sh"))
    assert flag not in port_argv
