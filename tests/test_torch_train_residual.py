"""The port's ResiDual λ-training and its evaluation held against the JAX
package on the CPU (``training/train_residual.py``, ``evaluate/metrics.py``).

Config: the depth-(2, 2) fixture config (``tests/torch_port_fixture.py``),
weights through the converter, inputs from seeded numpy. Tolerances: the
λ-gradient within 1e-4 max|g| and cosine > 0.99999; λ after Adam steps
atol 1e-4; losses rtol 1e-4; eval similarities atol 2e-3 (the slice's
parity bound, ``test_torch_htsat.py``). Under AMP (``compute_dtype=
bfloat16``) the λ-gradient is held to the JAX package's AMP gradient with
cosine > 0.9999 and within 1e-2 max|g|, the loss rtol 1e-3: both round the
same operands to bf16, but sum in other orders, so a few bf16 roundings go
the other way (measured: cosine 0.9999976, 3.4e-3 max|g|, the loss 1.5e-4
apart).
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.evaluate import metrics as j_metrics
from audio_residual_tpu.training import train_residual as j_tr
from audio_residual_tpu_torch.evaluate import metrics as t_metrics
from audio_residual_tpu_torch.residual.module import load_residual_params
from audio_residual_tpu_torch.training import train_residual as t_tr

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

MAX_LEN = fx.AUDIO_KW["clip_samples"]
TOL = {"loss": dict(rtol=1e-4, atol=0), "step_loss": dict(rtol=1e-4, atol=0),
       "lam": dict(rtol=0, atol=1e-4), "sims": dict(rtol=0, atol=2e-3)}


@pytest.fixture(scope="module")
def fresh():
    return fx.build_train()


@pytest.fixture(scope="module")
def port_out(fresh):
    return fx.run_port_train(fresh, "cpu")


@pytest.fixture(scope="module")
def models():
    """``(JAX params, port model)`` with the same weights."""
    model, _ = fx._port_with_residual(fx.load(), "cpu")
    return fx.jax_params(), model


def _batches(inputs, which=(0, 1)):
    return lambda: ((inputs["wav"][b], inputs["labels"][b]) for b in which)


def _jax_residual(inputs, layer=0):
    return {layer: {k: jnp.asarray(inputs[f"residual/{k}"]) for k in ("basis", "mean", "lam")}}


def _port_residual(inputs, layer=0):
    return {layer: {k: torch.tensor(inputs[f"residual/{k}"]) for k in ("basis", "mean", "lam")}}


def test_committed_train_fixture_is_current(fresh):
    """Regenerated from the JAX package == the committed file: inputs and
    params exactly, outputs to 1e-5 (the same f32 program run again)."""
    committed = fx.load(fx.TRAIN_PATH)
    assert set(committed) == set(fresh)
    assert str(committed["config"]) == str(fresh["config"])
    for k in fresh:
        if k.startswith("out/"):
            np.testing.assert_allclose(committed[k], fresh[k], rtol=1e-5, atol=1e-7, err_msg=k)
        elif k != "config":
            np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    assert fx.TRAIN_PATH.stat().st_size < 1 << 20


def test_lambda_gradient_matches_jax(fresh, port_out):
    """λ's gradient of the zero-shot loss against ``jax.grad`` of the JAX
    ``make_zero_shot_step`` loss."""
    ref, got = fresh["out/grad"], port_out["grad"]
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos > 0.99999, cos


def test_amp_lambda_gradient_matches_jax(fresh):
    """λ's gradient under AMP against ``jax.grad`` of the JAX
    ``make_zero_shot_step(..., compute_dtype=bfloat16)`` loss (module
    docstring for the bounds)."""
    got = fx.run_port_train_amp(fresh, "cpu")
    ref, g = fresh["out/grad_bf16"], got["grad_bf16"]
    assert g.shape == ref.shape
    assert np.abs(g - ref).max() <= 1e-2 * np.abs(ref).max()
    cos = (g * ref).sum() / (np.linalg.norm(g) * np.linalg.norm(ref))
    assert cos > 0.9999, cos
    np.testing.assert_allclose(got["loss_bf16"], fresh["out/loss_bf16"], rtol=1e-3)


@pytest.mark.parametrize("key", ["loss", "step_loss", "lam", "sims"])
def test_train_step_matches_jax(fresh, port_out, key):
    """The loss, the loss of each of three Adam steps, λ after them, and the
    eval similarities with that λ."""
    ref, got = fresh[f"out/{key}"], port_out[key]
    assert got.shape == ref.shape, key
    np.testing.assert_allclose(got, ref, **TOL[key])


@pytest.fixture(scope="module")
def trained_both(models):
    """JAX and port ``train_residual``: three epochs of one batch (three
    Adam steps at lr 0.01), auto-cached through the image."""
    params, model = models
    inputs = fx.train_inputs()
    kw = dict(epochs=3, lr=fx.TRAIN_LR, max_len=MAX_LEN)
    j = j_tr.train_residual(params, fx.jax_config(), _batches(inputs, (0,)),
                            jnp.asarray(inputs["text"]), _jax_residual(inputs), **kw)
    t = t_tr.train_residual(model, _batches(inputs, (0,)), inputs["text"],
                            _port_residual(inputs), **kw)
    return j, t


def test_train_residual_lambda_matches_jax(trained_both):
    (j_res, _), (t_res, _) = trained_both
    np.testing.assert_allclose(t_res[0]["lam"].numpy(), np.asarray(j_res[0]["lam"]), atol=1e-4,
                               rtol=0)


def test_train_residual_history_matches_jax(trained_both):
    (_, j_hist), (_, t_hist) = trained_both
    assert [h["epoch"] for h in t_hist] == [h["epoch"] for h in j_hist] == [0, 1, 2]
    np.testing.assert_allclose([h["train_loss"] for h in t_hist],
                               [h["train_loss"] for h in j_hist], rtol=1e-4)
    assert [h["train_acc"] for h in t_hist] == [h["train_acc"] for h in j_hist]


def test_train_residual_updates_only_lambda(models):
    """As the JAX package's ``test_train_residual_updates_only_lambda``: λ
    moves, basis and mean stay, the caller's λ is left as it was, the
    weights are untouched and λ comes back detached."""
    _, model = models
    inputs = fx.train_inputs()
    residual = _port_residual(inputs)
    before = {k: v.clone() for k, v in residual[0].items()}
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    trained, history = t_tr.train_residual(model, _batches(inputs), inputs["text"], residual,
                                           epochs=2, lr=0.05, max_len=MAX_LEN)
    assert len(history) == 2 and np.isfinite(history[-1]["train_loss"])
    assert not torch.allclose(trained[0]["lam"], before["lam"])
    assert not trained[0]["lam"].requires_grad
    for k in ("basis", "mean"):
        assert torch.equal(trained[0][k], before[k])
    for k, v in before.items():
        assert torch.equal(residual[0][k], v)
    for k, v in model.state_dict().items():
        assert torch.equal(v, weights[k]), k


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(t_tr, name)

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(t_tr, name, spy)
    return calls


def _layer1_residual():
    """A seeded QR ResiDual for layer 1 (C = 64), as numpy arrays."""
    c = 2 * fx.AUDIO_KW["embed_dim"]
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    return {"basis": q.astype(np.float32),
            "mean": (rng.standard_normal(c) * 0.01).astype(np.float32),
            "lam": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)}


def test_auto_cache_layer0_uses_image_cache(models, monkeypatch):
    """Layer 0 injected: the auto path caches the image, never tokens, and
    trains to the uncached run's λ."""
    _, model = models
    inputs = fx.train_inputs()
    monkeypatch.setattr(t_tr, "cache_prefix_tokens",
                        lambda *a, **kw: pytest.fail("a layer-0 run must not cache tokens"))
    images = _spy(monkeypatch, "cache_prefix_images")
    kw = dict(epochs=2, lr=0.05, max_len=MAX_LEN)
    r_auto, h_auto = t_tr.train_residual(model, _batches(inputs), inputs["text"],
                                         _port_residual(inputs), **kw)
    assert len(images) == 1
    r_off, h_off = t_tr.train_residual(model, _batches(inputs), inputs["text"],
                                       _port_residual(inputs), cache_prefix=False, **kw)
    assert len(images) == 1  # False never caches
    np.testing.assert_allclose(r_auto[0]["lam"], r_off[0]["lam"], atol=1e-5, rtol=1e-4)
    for ha, ho in zip(h_auto, h_off):
        np.testing.assert_allclose(ha["train_loss"], ho["train_loss"], rtol=1e-5)


def test_auto_cache_layer1_uses_token_cache(models, monkeypatch):
    """Layer 1 injected: the auto path caches the tokens below layer 1,
    never the image, and trains to the uncached run's λ."""
    _, model = models
    inputs = fx.train_inputs()
    res = {1: {k: torch.tensor(v) for k, v in _layer1_residual().items()}}
    monkeypatch.setattr(t_tr, "cache_prefix_images",
                        lambda *a, **kw: pytest.fail("a layer-1 run must not cache the image"))
    tokens = _spy(monkeypatch, "cache_prefix_tokens")
    kw = dict(epochs=2, lr=0.05, max_len=MAX_LEN)
    r_auto, h_auto = t_tr.train_residual(model, _batches(inputs), inputs["text"], res, **kw)
    assert len(tokens) == 1 and "exact_only" not in tokens[0]
    r_off, h_off = t_tr.train_residual(model, _batches(inputs), inputs["text"], res,
                                       cache_prefix=False, **kw)
    assert len(tokens) == 1
    np.testing.assert_allclose(r_auto[1]["lam"], r_off[1]["lam"], atol=1e-5, rtol=1e-4)
    for ha, ho in zip(h_auto, h_off):
        np.testing.assert_allclose(ha["train_loss"], ho["train_loss"], rtol=1e-5)


def test_cache_prefix_exact_only_bails_on_long_clips(models):
    _, model = models
    long = [(np.zeros((1, MAX_LEN + 1), np.float32), np.zeros(1, np.int64))]
    assert t_tr.cache_prefix_tokens(model, iter(long), 1, max_len=MAX_LEN,
                                    exact_only=True) is None


@pytest.mark.parametrize("cut", ["image", "tokens"])
def test_evaluate_zero_shot_cached_matches_jax(models, cut):
    """``evaluate_zero_shot`` from quantized prefix caches (the image with a
    layer-0 ResiDual, or the tokens below layer 1 with a layer-1 ResiDual)
    against the JAX package's; the port's cached eval equals its uncached
    eval bit for bit."""
    params, model = models
    inputs = fx.train_inputs()
    batches = _batches(inputs)
    if cut == "image":
        kw = dict(image_input=True)
        res = {0: {k: inputs[f"residual/{k}"] for k in ("basis", "mean", "lam")}}
        j_cache = j_tr.cache_prefix_images(params, fx.jax_config(), batches(), max_len=MAX_LEN,
                                           quantize=True)
        t_cache = t_tr.cache_prefix_images(model, batches(), max_len=MAX_LEN, quantize=True)
    else:
        kw = dict(start_layer=1)
        res = {1: _layer1_residual()}
        j_cache = j_tr.cache_prefix_tokens(params, fx.jax_config(), batches(), 1,
                                           max_len=MAX_LEN, quantize=True)
        t_cache = t_tr.cache_prefix_tokens(model, batches(), 1, max_len=MAX_LEN, quantize=True)
    j_res = {l: {k: jnp.asarray(v) for k, v in r.items()} for l, r in res.items()}
    t_res = {l: {k: torch.tensor(v) for k, v in r.items()} for l, r in res.items()}
    j_pred, j_tgt, j_sims = j_tr.evaluate_zero_shot(
        params, fx.jax_config(), iter(j_cache), jnp.asarray(inputs["text"]), residual=j_res,
        max_len=MAX_LEN, **kw)
    t_pred, t_tgt, t_sims = t_tr.evaluate_zero_shot(
        model, iter(t_cache), inputs["text"], residual=t_res, max_len=MAX_LEN, **kw)
    np.testing.assert_allclose(t_sims, np.asarray(j_sims), atol=2e-3, rtol=0)
    np.testing.assert_array_equal(t_tgt, np.asarray(j_tgt))
    _, _, uncached = t_tr.evaluate_zero_shot(model, batches(), inputs["text"], residual=t_res,
                                             max_len=MAX_LEN)
    np.testing.assert_array_equal(t_sims, uncached)


def _write_pca(root, dataset, layers, folds, dim):
    rng = np.random.default_rng(5)
    for layer in layers:
        for i in range(folds):
            q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
            os.makedirs(os.path.join(root, dataset), exist_ok=True)
            with open(os.path.join(root, dataset, f"layer_{layer}_evalfold_{i}"), "wb") as f:
                pickle.dump({"components": q.astype(np.float32),
                             "mean": (rng.standard_normal(dim) * 0.01).astype(np.float32)}, f)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_kfold_harness_writes_what_jax_writes(models, tmp_path):
    """``train_and_evaluate_residual`` and ``evaluate_baseline_clap``: the
    same file names and ``.npz`` keys as the JAX package, from PCA pickles
    written here; the port's similarities within the eval tolerance of
    JAX's, and its λ pickles load back."""
    params, model = models
    inputs = fx.train_inputs()
    _write_pca(tmp_path / "pca", "ESC50", (0,), 2, fx.AUDIO_KW["embed_dim"])
    folds = [(_batches(inputs, (0,)), _batches(inputs, (1,))),
             (_batches(inputs, (1,)), _batches(inputs, (0,)))]
    text = inputs["text"]
    kw = dict(epochs=1, lr=fx.TRAIN_LR)
    j_res = j_tr.train_and_evaluate_residual(params, fx.jax_config(), "ESC50", folds,
                                             jnp.asarray(text), str(tmp_path / "pca"),
                                             str(tmp_path / "jax"), **kw)
    t_res = t_tr.train_and_evaluate_residual(model, "ESC50", folds, text,
                                             str(tmp_path / "pca"), str(tmp_path / "port"), **kw)
    j_tr.evaluate_baseline_clap(params, fx.jax_config(), "ESC50", folds, jnp.asarray(text),
                                str(tmp_path / "jax"))
    t_tr.evaluate_baseline_clap(model, "ESC50", folds, text, str(tmp_path / "port"))
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    assert "ESC50/ResiDual/layers_0_evalfold_1.npz" in files
    assert "ESC50/ResiDual/lambda_layer0_evalfold_0.pkl" in files
    assert "ESC50/Baseline/evalfold_0.npz" in files
    for f in files:
        if f.endswith(".npz"):
            with np.load(tmp_path / "port" / f) as t, np.load(tmp_path / "jax" / f) as j:
                assert sorted(t.files) == sorted(j.files) == ["predictions", "similarities",
                                                              "targets"]
                np.testing.assert_allclose(t["similarities"], j["similarities"], atol=2e-3)
                np.testing.assert_array_equal(t["targets"], j["targets"])
    assert [r["fold"] for r in t_res] == [r["fold"] for r in j_res]
    lam = load_residual_params(str(tmp_path / "port/ESC50/ResiDual/lambda_layer0_evalfold_0.pkl"),
                               device="cpu")
    with open(tmp_path / "port/ESC50/ResiDual/lambda_layer0_evalfold_0.pkl", "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved) == ["components", "lam", "mean"]
    assert lam["basis"].shape == (fx.AUDIO_KW["embed_dim"],) * 2


def test_train_with_config_matches_jax(models, tmp_path):
    """One sweep run at layer 0 (image-cached train and val): λ and the
    per-epoch losses against the JAX package's."""
    params, model = models
    inputs = fx.train_inputs()
    _write_pca(tmp_path, "ESC50", (0,), 1, fx.AUDIO_KW["embed_dim"])
    folds = [(_batches(inputs, (0,)), _batches(inputs, (1,)))]
    config = {"lr": fx.TRAIN_LR, "epochs": 2, "inject_layers": [0], "eval_fold": 0}
    j = j_tr.train_with_config(config, params, fx.jax_config(), "ESC50", folds,
                               jnp.asarray(inputs["text"]), str(tmp_path))
    t = t_tr.train_with_config(config, model, "ESC50", folds, inputs["text"], str(tmp_path))
    np.testing.assert_allclose(t["residual"][0]["lam"].numpy(),
                               np.asarray(j["residual"][0]["lam"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose([h["train_loss"] for h in t["history"]],
                               [h["train_loss"] for h in j["history"]], rtol=1e-4)
    assert t["best_val_acc"] == j["best_val_acc"]
    assert [h["val_acc"] for h in t["history"]] == [h["val_acc"] for h in j["history"]]


def _metric_inputs():
    rng = np.random.default_rng(4)
    sims = rng.standard_normal((40, 7)).astype(np.float32)
    targets = rng.integers(0, 7, 40)
    return sims, targets


@pytest.mark.parametrize("name", ["classification_metrics", "topk_accuracy", "confusion_matrix",
                                  "retrieval_metrics", "clap_val_metrics"])
def test_metrics_equal_jax(name):
    sims, targets = _metric_inputs()
    args = {
        "classification_metrics": lambda m: m.classification_metrics(sims, targets),
        "topk_accuracy": lambda m: m.topk_accuracy(sims, targets, k=3),
        "confusion_matrix": lambda m: m.confusion_matrix(sims.argmax(-1), targets, 7),
        "retrieval_metrics": lambda m: m.retrieval_metrics(sims[:7], sims[7:14]),
        "clap_val_metrics": lambda m: m.clap_val_metrics(sims[:7], sims[7:14], 2.0),
    }[name]
    got, ref = args(t_metrics), args(j_metrics)
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    else:
        np.testing.assert_array_equal(got, ref)
