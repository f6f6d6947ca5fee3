"""The port's streaming PCA and representation analysis
(``ops/pca.py``, ``residual/analyze.py``) held against the JAX package on
the CPU.

Tolerances: the moment updates and the dense finalize rtol 1e-6 (the dense
finalize fed the same moments: the same float64 numpy on the host); the
randomized finalize against the JAX package's on a spectrum with clear
gaps, eigenvalues rtol 1e-4 and each component's |dot| > 0.999 (the port
iterates in float64 from another starting block, the JAX package in f32);
against the dense finalize at the bounds of ``tests/test_pca.py``
(subspace norm > 0.99, eigenvalues rtol 0.02 on its nearly flat
spectrum). Pickles and CSVs cross between the packages both ways, and the
PCA of the fixture model's residual tap feeds the port's λ-training.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.data.featurize import featurize_batch as j_featurize
from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu.ops import pca as j_pca
from audio_residual_tpu.residual import analyze as j_an
from audio_residual_tpu.residual.module import load_residual_params as j_load_residual
from audio_residual_tpu_torch.data.featurize import featurize_batch as t_featurize
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.ops import pca as t_pca
from audio_residual_tpu_torch.residual import analyze as t_an
from audio_residual_tpu_torch.residual.module import load_residual_params as t_load_residual
from audio_residual_tpu_torch.training import train_residual as t_tr

from . import torch_port_fixture as fx

KEYS = ("components", "mean", "explained_variance", "explained_variance_ratio",
        "total_variance", "num_samples")


def _chunks(batched: bool):
    """Five chunks of rows as the analysis feeds them: attention rows
    (softmax probabilities, [heads, rows, N²]) or residual rows with an
    offset ([rows, D])."""
    rng = np.random.default_rng(0)
    if batched:
        x = np.exp(rng.standard_normal((5, 3, 40, 64))).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return (1.0 + 0.3 * rng.standard_normal((5, 60, 24))).astype(np.float32)


def _states(batched: bool):
    x = _chunks(batched)
    if batched:
        js, ts = j_pca.batched_pca_init((3,), 64), t_pca.batched_pca_init((3,), 64, device="cpu")
        j_up, t_up = j_pca.batched_pca_update, t_pca.batched_pca_update
    else:
        js, ts = j_pca.pca_init(24), t_pca.pca_init(24, device="cpu")
        j_up, t_up = j_pca.pca_update, t_pca.pca_update
    for c in x:
        js, ts = j_up(js, jnp.asarray(c)), t_up(ts, torch.tensor(c))
    return js, ts


def _t_state(js) -> t_pca.PCAState:
    return t_pca.PCAState(*(torch.tensor(np.asarray(v)) for v in js))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_updates_match_jax(batched):
    js, ts = _states(batched)
    for name, got, want in zip(("n", "sum", "outer"), ts, js):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_dense_finalize_matches_jax(batched):
    js, _ = _states(batched)
    got = t_pca.pca_finalize(_t_state(js), method="dense")
    want = j_pca.pca_finalize(js, method="dense")
    assert set(got) == set(want)
    for k in ("n_components", "input_dim"):
        assert got[k] == want[k]
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12, err_msg=k)


def _gapped_state(rng, d=1024, heads=()):
    """Moments of a covariance with geometric top eigenvalues (ratio 0.8:
    clear gaps) over a small flat floor, and a nonzero mean; f32 as the
    updates leave them."""
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.concatenate([50 * 0.8 ** np.arange(32), 0.01 * rng.random(d - 32)])
    cov = (q * lam) @ q.T
    mean = rng.standard_normal(d) * 0.1
    n = float(d)
    outer = (cov * (n - 1) + n * np.outer(mean, mean)).astype(np.float32)
    s = (mean * n).astype(np.float32)
    return (j_pca.PCAState(n=jnp.asarray(n), sum=jnp.asarray(s), outer=jnp.asarray(outer)),
            t_pca.PCAState(n=torch.tensor(n), sum=torch.tensor(s), outer=torch.tensor(outer)),
            lam)


def test_randomized_finalize_matches_jax_randomized(rng):
    k = 16
    js, ts, _ = _gapped_state(rng)
    got = t_pca.pca_finalize(ts, k, method="randomized")
    want = j_pca.pca_finalize(js, k, method="randomized")
    assert set(got) == set(want) and got["n_components"] == want["n_components"] == k
    np.testing.assert_allclose(got["explained_variance"], want["explained_variance"], rtol=1e-4)
    np.testing.assert_allclose(got["explained_variance_ratio"],
                               want["explained_variance_ratio"], rtol=1e-4)
    np.testing.assert_allclose(got["total_variance"], want["total_variance"], rtol=1e-4)
    np.testing.assert_allclose(got["mean"], want["mean"], atol=1e-6)
    dots = np.abs(np.sum(got["components"] * want["components"], axis=-1))
    assert dots.min() > 0.999, dots


def test_randomized_components_span_the_dense_ones(rng, monkeypatch):
    """``tests/test_pca.py``'s check on the port, its data: on a strongly
    decaying spectrum the top-k components lie in the exact top-k span
    (norm > 0.99). The randomized path never pulls the [D, D] moments to the
    host."""
    d, k = 1024, 16
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.concatenate([np.linspace(50, 1, 64), 0.01 * rng.random(d - 64)])
    cov = (q * lam) @ q.T
    state = t_pca.PCAState(n=torch.tensor(float(d)), sum=torch.zeros(d),
                           outer=torch.tensor((cov * (d - 1)).astype(np.float32)))
    pulled = []
    to_host = t_pca._to_host
    monkeypatch.setattr(t_pca, "_to_host", lambda t, dt: pulled.append(t.numel()) or
                        to_host(t, dt))
    res = t_pca.pca_finalize(state, n_components=k)
    assert 0 < max(pulled) < d * d
    top = np.linalg.eigh(cov)[1][:, ::-1][:, :k]
    assert np.linalg.norm(res["components"] @ top, axis=1).min() > 0.99
    np.testing.assert_allclose(res["total_variance"], np.trace(cov), rtol=1e-3)


def test_batched_randomized_matches_dense(rng):
    """``tests/test_pca.py``'s batched check on the port, its data: the
    randomized spectrum of each head against the dense one (rtol 0.02) on a
    nearly flat spectrum, the worst case of subspace iteration."""
    d, h, n = 1024, 3, 400
    x = (rng.standard_normal((h, n, d)) * np.linspace(3, 0.05, d)).astype(np.float32)
    state = t_pca.batched_pca_update(t_pca.batched_pca_init((h,), d, device="cpu"),
                                     torch.tensor(x))
    rnd = t_pca.pca_finalize(state, n_components=8, method="randomized")
    dense = t_pca.pca_finalize(state, n_components=8, method="dense")
    for key in ("explained_variance", "explained_variance_ratio"):
        np.testing.assert_allclose(rnd[key], dense[key], rtol=0.02)
    np.testing.assert_allclose(rnd["total_variance"], dense["total_variance"], rtol=1e-3)
    np.testing.assert_allclose(rnd["mean"], dense["mean"], atol=1e-4)


def test_randomized_finalize_resolves_a_wide_spectrum(rng):
    """Eigenvalues over five decades (10^(-i/8), i < 40): the port's top 32
    against the dense finalize of the same moments (rtol 1e-6). The JAX
    package's gram whitening clamps the gram matrix at 1e-6 of its largest
    eigenvalue, so its randomized finalize gives every eigenvalue under
    1e-3 of the first too small (measured here: 3.6e-4 for 1e-3, 2.4e-8
    for 1.3e-4); the port's QR does not."""
    d, k = 1024, 32
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.concatenate([10.0 ** (-np.arange(40) / 8), np.zeros(d - 40)])
    cov = (q * lam) @ q.T
    state = t_pca.PCAState(n=torch.tensor(float(d)), sum=torch.zeros(d),
                           outer=torch.tensor((cov * (d - 1)).astype(np.float32)))
    got = t_pca.pca_finalize(state, k, method="randomized")
    want = t_pca.pca_finalize(state, k, method="dense")
    np.testing.assert_allclose(got["explained_variance"], want["explained_variance"], rtol=1e-6)
    np.testing.assert_allclose(got["explained_variance"], lam[:k], rtol=1e-2)
    dots = np.abs(np.sum(got["components"] * want["components"], axis=-1))
    assert dots.min() > 0.999, dots
    jax_ev = j_pca.pca_finalize(j_pca.PCAState(*(jnp.asarray(t.numpy()) for t in state)), k,
                                method="randomized")["explained_variance"]
    assert jax_ev[31] < 1e-3 * lam[31]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pickles_cross_packages(tmp_path, writer):
    js, _ = _states(False)
    path = str(tmp_path / "layer_0_evalfold_0")
    if writer == "port":
        t_pca.pca_save(path, t_pca.pca_finalize(_t_state(js)))
    else:
        j_pca.pca_save(path, j_pca.pca_finalize(js))
    loaded = {"port": t_pca.pca_load(path), "jax": j_pca.pca_load(path)}
    assert loaded["port"].keys() == loaded["jax"].keys() >= set(KEYS)
    t_res = t_load_residual(path, n_components=8, device="cpu")
    j_res = j_load_residual(path, n_components=8)
    for k in ("basis", "mean", "lam"):
        np.testing.assert_array_equal(t_res[k].numpy(), np.asarray(j_res[k]), err_msg=k)
    assert t_res["basis"].shape == (8, 24)


def test_csv_crosses_packages(tmp_path):
    """The port's CSV reads back through the JAX package's reader as the
    port's reader reads it; the metrics are the JAX package's."""
    js, _ = _states(True)
    results = {}
    for layer, (jst, tst) in enumerate([(js, _t_state(js))] * 2):
        res = t_pca.pca_finalize(tst, 12, method="dense")
        for head in range(3):
            results[(layer, head)] = {k: v[head] if isinstance(v, np.ndarray) and v.ndim else v
                                      for k, v in res.items()}
    path = t_an.save_pca_results_on_file(str(tmp_path), "ESC50", 0, results)
    assert os.path.basename(path) == "ESC50-fold0.csv"
    t_back, j_back = t_an.load_pca_csv_results(path), j_an.load_pca_csv_results(path)
    assert t_back == j_back and set(t_back) == set(results)
    for key, res in results.items():
        ratio = res["explained_variance_ratio"]
        assert t_back[key]["intrinsic_dim"] == j_an.intrinsic_dim(ratio) == t_an.intrinsic_dim(
            ratio)
        np.testing.assert_allclose(t_back[key]["participation_ratio"],
                                   j_an.participation_ratio(res["explained_variance"]),
                                   rtol=1e-12)
        np.testing.assert_allclose(t_back[key]["explained_variance"],
                                   res["explained_variance"], rtol=1e-12)


@pytest.fixture(scope="module")
def fixture_models():
    model, _ = fx._port_with_residual(fx.load(), "cpu")
    return fx.jax_params(), model


def _wav_batches(n=2, seed=21):
    rng = np.random.default_rng(seed)
    t = fx.AUDIO_KW["clip_samples"] // 2
    return [(rng.standard_normal((2, t)) * 0.1).astype(np.float32) for _ in range(n)]


def test_run_pca_matches_jax(fixture_models):
    """The attention PCA of the fixture model (two layers, 2 and 4 heads of
    64-token windows: 4096-wide rows, the randomized finalize): its moments
    against the JAX package's ``AttentionPCA``'s (rtol 1e-5: the two
    packages' probabilities agree to 1e-8), and ``run_pca``'s spectrum
    against a float64 eigh of the same moments (head 0 of each layer, up to
    its rank: layer 1's heads see 4 rows; rtol 1e-6 down to 1e-9 of the
    first eigenvalue; the trace rtol 1e-9). The spectra of the two
    packages are not compared: these probabilities are near uniform, so the
    covariance is a 1e-3 remainder of the f32 second moments, and the JAX
    package forms it in f32."""
    params, model = fixture_models
    max_len = fx.AUDIO_KW["clip_samples"]
    wavs = _wav_batches()
    heads = fx.AUDIO_KW["num_heads"]

    def t_encode(w):
        return t_clap.encode_audio(model, t_featurize(w, max_len), taps=("attention",))

    t_ap, j_ap = t_an.AttentionPCA(heads, device="cpu"), j_an.AttentionPCA(heads)
    for w in wavs:
        with torch.no_grad():
            t_ap.update(t_encode(torch.tensor(w))["layers_attention"])
        j_ap.update(j_clap.encode_audio(params, j_featurize(jnp.asarray(w), max_len),
                                        fx.jax_config(), taps=("attention",))["layers_attention"])
    for t_state, j_state in zip(t_ap.states, j_ap.states):
        for got, want in zip(t_state, j_state):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-12)

    got = t_an.run_pca(t_encode, wavs, 2, heads, n_components=8, device="cpu")
    assert set(got) == {(i, h) for i in range(2) for h in range(heads[i])}
    for (layer, head), res in got.items():
        assert res["components"] is None and res["n_components"] == 8
        assert int(res["num_samples"]) == int(j_ap.states[layer].n[head])
    for layer, state in enumerate(t_ap.states):
        n = state.n[0].double()
        mean = state.sum[0].double() / n
        cov = (state.outer[0].double() - n * torch.outer(mean, mean)) / (n - 1)
        ev = torch.linalg.eigvalsh(cov).flip(-1).numpy()
        res = got[(layer, 0)]
        rank = min(8, int(n) - 1)
        np.testing.assert_allclose(res["explained_variance"][:rank], ev[:rank], rtol=1e-6,
                                   atol=1e-9 * ev[0])
        # past the rank: the f32 moments' rounding, a flat floor the iteration
        # only samples
        assert (res["explained_variance"][rank:] <= ev[rank:8] * (1 + 1e-6)).all()
        np.testing.assert_allclose(res["total_variance"], float(torch.trace(cov)), rtol=1e-9)


def test_compute_pca_components_feeds_lambda_training(fixture_models, tmp_path):
    """compute_pca_components on the fixture model's layer-0 residual tap:
    its result against the JAX package's (dense: mean atol 1e-5, spectrum
    rtol 1e-3, the leading components' |dot| > 0.999), pickled per fold
    where ``train_and_evaluate_residual`` reads it, which then trains and
    evaluates from it."""
    params, model = fixture_models
    max_len = fx.AUDIO_KW["clip_samples"]
    wavs = _wav_batches(3)
    c = fx.AUDIO_KW["embed_dim"]

    def t_encode(w):
        return t_clap.encode_audio(model, t_featurize(w, max_len), taps=("residual",))

    def j_encode(w):
        return j_clap.encode_audio(params, j_featurize(w, max_len), fx.jax_config(),
                                   taps=("residual",))

    pca_dir = tmp_path / "pca"
    for fold in range(2):
        train = [w for i, w in enumerate(wavs) if i != fold]
        got = t_an.compute_pca_components(
            t_encode, train, 0, c, device="cpu",
            save_path=str(pca_dir / "ESC50" / f"layer_0_evalfold_{fold}"))
        want = j_an.compute_pca_components(j_encode, train, 0, c)
        np.testing.assert_allclose(got["mean"], want["mean"], atol=1e-5)
        # the spectrum below the first eigenvalue sits 4 orders under it, where
        # the two packages' f32 moments (sums in other orders) differ at 1e-3
        ev = want["explained_variance"]
        np.testing.assert_allclose(got["explained_variance"][:8], ev[:8], rtol=1e-3,
                                   atol=1e-6 * ev[0])
        dots = np.abs(np.sum(got["components"][:4] * want["components"][:4], axis=-1))
        assert dots.min() > 0.999, dots
        assert int(got["num_samples"]) == int(want["num_samples"])
    inputs = fx.train_inputs()

    def batches(b):
        return lambda: iter([(inputs["wav"][b], inputs["labels"][b])])

    folds = [(batches(0), batches(1)), (batches(1), batches(0))]
    res = t_tr.train_and_evaluate_residual(model, "ESC50", folds, inputs["text"], str(pca_dir),
                                           str(tmp_path / "out"), epochs=1, lr=fx.TRAIN_LR)
    assert [r["fold"] for r in res] == [0, 1]
    assert all(np.isfinite(r["history"][0]["train_loss"]) for r in res)
    with open(tmp_path / "out/ESC50/ResiDual/lambda_layer0_evalfold_1.pkl", "rb") as f:
        saved = pickle.load(f)
    with open(pca_dir / "ESC50" / "layer_0_evalfold_1", "rb") as f:
        basis = pickle.load(f)["components"]
    np.testing.assert_allclose(saved["components"], basis.astype(np.float32))


def test_entry_points_without_device_need_a_card(monkeypatch):
    """The moments are made on the card unless the caller names a device;
    without a card the entry points raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: t_pca.pca_init(8), lambda: t_pca.batched_pca_init((2,), 8),
                 lambda: t_an.ResidualPCA(8), lambda: t_an.AttentionPCA((2,), n=4),
                 lambda: t_an.compute_pca_components(lambda w: {}, [], 0, 8),
                 lambda: t_an.run_pca(lambda w: {}, [], 1, (2,), window=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert t_pca.pca_init(8, device="cpu").outer.device.type == "cpu"
