"""The port's evaluation harness (``evaluate/harness.py``) held against the
JAX package's on the CPU, on the same ``.npz`` and pickle files written by
the test: every function's result equal (floats to 1e-12; the harness is
numpy on the host in both packages). The linear-probe sweep runs the
fixture model with the JAX package's initial heads (see
``tests/test_torch_linear_probe.py``): accuracies equal.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from audio_residual_tpu.evaluate import harness as j_h
from audio_residual_tpu.training import linear_probe as j_lp
from audio_residual_tpu_torch.evaluate import harness as t_h
from audio_residual_tpu_torch.training import linear_probe as t_lp

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

N_CLASSES, FOLDS = 6, 3


def _write_npz(path, rng, n=20):
    sims = rng.standard_normal((n, N_CLASSES)).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, n)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, similarities=sims, predictions=sims.argmax(-1), targets=targets)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A results tree of the three variants (the K-fold harnesses' names)
    and DCASE embedding pickles (1:1 and the 5-caption layout)."""
    root = tmp_path_factory.mktemp("harness")
    rng = np.random.default_rng(8)
    for i in range(FOLDS):
        _write_npz(str(root / "ESC50/ResiDual" / f"layers_0_1_evalfold_{i}.npz"), rng)
        _write_npz(str(root / "ESC50/Baseline" / f"evalfold_{i}.npz"), rng)
        _write_npz(str(root / "ESC50/Linear" / f"evalfold_{i}.npz"), rng)
    os.makedirs(root / "dcase")
    for name, rows in (("epoch_1.pkl", 12), ("epoch_2.pkl", 60), ("epoch_3.pkl", 12)):
        blob = {"audio_features": rng.standard_normal((12, 8)).astype(np.float32),
                "text_features": rng.standard_normal((rows, 8)).astype(np.float32),
                "logit_scale_a": 10.0}
        with open(root / "dcase" / name, "wb") as f:
            pickle.dump(blob, f)
    return root


def _equal(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple, np.ndarray)) and not isinstance(want, str):
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), rtol=1e-12,
                                   atol=0, err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=0), path
    else:
        assert got == want, path


CALLS = {
    "visualize_eval_metrics": lambda h, r: h.visualize_eval_metrics(
        str(r / "ESC50/ResiDual"), "ESC50", FOLDS, inject_layers=(0, 1)),
    "visualize_eval_metrics_baseline": lambda h, r: h.visualize_eval_metrics(
        str(r / "ESC50/Baseline"), "ESC50", FOLDS, k_top=3),
    "aggregate_eval_metrics": lambda h, r: h.aggregate_eval_metrics(str(r / "ESC50/Linear")),
    "compare_variants": lambda h, r: h.compare_variants(str(r), "ESC50"),
    "eval_dcase_pairs": lambda h, r: h.eval_dcase(str(r / "dcase/epoch_1.pkl")),
    "eval_dcase_clotho": lambda h, r: h.eval_dcase(str(r / "dcase/epoch_2.pkl")),
    "eval_dcase_sweep": lambda h, r: h.eval_dcase_sweep(str(r / "dcase")),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_harness_matches_jax(artifacts, name):
    _equal(CALLS[name](t_h, artifacts), CALLS[name](j_h, artifacts))


@pytest.mark.parametrize("name", ["visualize_eval_metrics", "plot_lambda_histogram"])
def test_figures_are_written(artifacts, tmp_path, name):
    for tag, h in (("port", t_h), ("jax", j_h)):
        fig = str(tmp_path / f"{tag}.png")
        if name == "plot_lambda_histogram":
            lam = np.random.default_rng(1).standard_normal(96) * 0.1 + 1
            assert h.plot_lambda_histogram(lam, fig) == fig
        else:
            out = h.visualize_eval_metrics(str(artifacts / "ESC50/Baseline"), "ESC50", FOLDS,
                                           class_names=[f"c{i}" for i in range(N_CLASSES)],
                                           fig_path=fig)
            assert out["figure"] == fig
        assert os.path.getsize(fig) > 1000


def test_harness_refusals_match_jax(tmp_path):
    for h in (t_h, j_h):
        with pytest.raises(FileNotFoundError):
            h.aggregate_eval_metrics(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            h.eval_dcase_sweep(str(tmp_path))
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump({"audio_features": np.ones((4, 3)), "text_features": np.ones((7, 3))}, f)
    for h in (t_h, j_h):
        with pytest.raises(ValueError, match="5x"):
            h.eval_dcase(str(tmp_path / "bad.pkl"))


def test_eval_linear_probe_sweep_matches_jax(monkeypatch, tmp_path):
    """Two "checkpoints" (the fixture model, and the same model with its
    projection scaled) through the probe sweep: per-checkpoint accuracy and
    the best, against the JAX package's on the same weights."""
    def init(seed, in_dim=512, n_classes=50, mlp=False, device=None):
        head = j_lp.init_linear_head(jax.random.PRNGKey(seed), in_dim, n_classes, mlp=mlp)
        return {k: {p: torch.tensor(np.asarray(v)) for p, v in layer.items()}
                for k, layer in head.items()}

    monkeypatch.setattr(t_lp, "init_linear_head", init)
    model, _ = fx._port_with_residual(fx.load(), "cpu")
    scaled, _ = fx._port_with_residual(fx.load(), "cpu")
    with torch.no_grad():
        scaled.audio_projection[2].weight.mul_(-1.0)
    params = fx.jax_params()
    proj = params["audio_projection"]
    j_scaled = {**params, "audio_projection": {
        **proj, "fc2": {**proj["fc2"], "kernel": -proj["fc2"]["kernel"]}}}
    inputs = fx.train_inputs()

    def batches(b):
        return lambda: iter([(inputs["wav"][b], inputs["labels"][b])])

    folds = [(batches(0), batches(1))]
    kw = dict(epochs=3, lr=1e-2)
    got = t_h.eval_linear_probe_sweep({"a": model, "b": scaled}, folds, fx.TRAIN_CLASSES,
                                      str(tmp_path / "port"), **kw)
    want = j_h.eval_linear_probe_sweep({"a": params, "b": j_scaled}, fx.jax_config(), folds,
                                       fx.TRAIN_CLASSES, str(tmp_path / "jax"), **kw)
    assert got == want
    assert os.path.exists(tmp_path / "port/probe_b/Linear/evalfold_0.npz")
