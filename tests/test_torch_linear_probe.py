"""The port's linear probe (``training/linear_probe.py``, with ``lp_loss``
and the mixup helpers) held against the JAX package on the CPU.

Heads start from the JAX package's initial head (the port's
``init_linear_head`` is monkeypatched to return it: the two packages draw
from different generators), so training is compared step for step: losses
rtol 1e-5 and the trained head atol 1e-5 (AdamW's decoupled decay is
``optax.adamw``'s; shuffles and mixup coefficients come from the same numpy
generator). Head outputs and losses rtol 1e-6. The K-fold harness's
``.npz`` against the JAX package's on the fixture model: targets and
predictions equal, similarities atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.training import linear_probe as j_lp
from audio_residual_tpu.training.losses import lp_loss as j_lp_loss
from audio_residual_tpu.utils.misc import do_mixup as j_do_mixup
from audio_residual_tpu.utils.misc import get_mix_lambda as j_get_mix_lambda
from audio_residual_tpu_torch.training import linear_probe as t_lp
from audio_residual_tpu_torch.training.losses import lp_loss as t_lp_loss
from audio_residual_tpu_torch.utils.misc import do_mixup as t_do_mixup
from audio_residual_tpu_torch.utils.misc import get_mix_lambda as t_get_mix_lambda

from . import torch_port_fixture as fx

ACTS = ["None", "relu", "elu", "softmax", "sigmoid"]


def _t_head(head) -> dict:
    return {k: {p: torch.tensor(np.asarray(v)) for p, v in layer.items()}
            for k, layer in head.items()}


def _feats(n=40, d=16, classes=5, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True), rng.integers(0, classes, n)


@pytest.mark.parametrize("mlp", [False, True], ids=["linear", "mlp"])
@pytest.mark.parametrize("act", ACTS)
def test_head_apply_matches_jax(act, mlp):
    head = j_lp.init_linear_head(jax.random.PRNGKey(1), 16, 5, mlp=mlp)
    x, _ = _feats()
    got = t_lp.head_apply(_t_head(head), torch.tensor(x), act)
    want = j_lp.head_apply(head, jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("act,error", [("prelu", NotImplementedError), ("tanh", ValueError)])
def test_head_apply_refusals_match_jax(act, error):
    head = j_lp.init_linear_head(jax.random.PRNGKey(1), 16, 5)
    x, _ = _feats()
    with pytest.raises(error):
        j_lp.head_apply(head, jnp.asarray(x), act)
    with pytest.raises(error):
        t_lp.head_apply(_t_head(head), torch.tensor(x), act)


def test_init_linear_head_layout(monkeypatch):
    """The JAX package's layout and kaiming-normal scale (std sqrt(2/in)),
    zero biases, on the device asked for; without one, the card."""
    for mlp in (False, True):
        got = t_lp.init_linear_head(3, 512, 50, mlp=mlp, device="cpu")
        want = j_lp.init_linear_head(jax.random.PRNGKey(3), 512, 50, mlp=mlp)
        assert {k: {p: tuple(v.shape) for p, v in layer.items()} for k, layer in got.items()} \
            == {k: {p: v.shape for p, v in layer.items()} for k, layer in want.items()}
        assert abs(float(got["out"]["kernel"].std()) - np.sqrt(2 / 512)) < 2e-3
        assert not got["out"]["bias"].any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lp.init_linear_head(3)


@pytest.mark.parametrize("kind,soft", [("ce", False), ("ce", True), ("bce", True),
                                       ("mse", True)])
def test_lp_loss_matches_jax(kind, soft):
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((12, 5)).astype(np.float32) * 3
    if soft:
        target = rng.random((12, 5)).astype(np.float32)
        target = target / target.sum(-1, keepdims=True) if kind == "ce" else target
    else:
        target = rng.integers(0, 5, 12)
    got = t_lp_loss(torch.tensor(pred), torch.tensor(target), kind)
    want = j_lp_loss(jnp.asarray(pred), jnp.asarray(target), kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        t_lp_loss(torch.tensor(pred), torch.tensor(target), "hinge")


def test_mixup_helpers_match_jax():
    lam = t_get_mix_lambda(0.5, 6, np.random.default_rng(5))
    np.testing.assert_array_equal(lam, j_get_mix_lambda(0.5, 6, np.random.default_rng(5)))
    x = np.random.default_rng(6).standard_normal((6, 3, 2)).astype(np.float32)
    np.testing.assert_allclose(t_do_mixup(torch.tensor(x), torch.tensor(lam)).numpy(),
                               np.asarray(j_do_mixup(jnp.asarray(x), jnp.asarray(lam))),
                               rtol=1e-6, atol=1e-7)


def _jax_init(monkeypatch):
    """The port's ``init_linear_head`` returns the JAX package's initial head
    for the same seed (as a key)."""
    def init(seed, in_dim=512, n_classes=50, mlp=False, device=None):
        return _t_head(j_lp.init_linear_head(jax.random.PRNGKey(seed), in_dim, n_classes,
                                             mlp=mlp))

    monkeypatch.setattr(t_lp, "init_linear_head", init)


@pytest.mark.parametrize("mixup", [0.0, 0.5], ids=["plain", "mixup"])
@pytest.mark.parametrize("mlp", [False, True], ids=["linear", "mlp"])
def test_train_linear_head_matches_jax(monkeypatch, mlp, mixup):
    _jax_init(monkeypatch)
    x, y = _feats()
    kw = dict(epochs=4, lr=1e-2, batch_size=16, mlp=mlp, mixup_alpha=mixup)
    t_head, t_hist = t_lp.train_linear_head(7, x, y, 5, device="cpu", **kw)
    j_head, j_hist = j_lp.train_linear_head(jax.random.PRNGKey(7), x, y, 5, **kw)
    assert [h["epoch"] for h in t_hist] == [h["epoch"] for h in j_hist] == list(range(4))
    np.testing.assert_allclose([h["train_loss"] for h in t_hist],
                               [h["train_loss"] for h in j_hist], rtol=1e-5)
    for k, layer in j_head.items():
        for p, v in layer.items():
            assert not t_head[k][p].requires_grad
            np.testing.assert_allclose(t_head[k][p].numpy(), np.asarray(v), atol=1e-5,
                                       err_msg=f"{k}/{p}")
    got = t_lp.eval_linear_head(t_head, x, y)
    want = j_lp.eval_linear_head(j_head, x, y)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


def test_train_and_eval_linear_head_writes_what_jax_writes(monkeypatch, tmp_path):
    """Two folds of the training fixture's clips through the fixture model:
    ``{save_dir}/{dataset}/Linear/evalfold_{i}.npz`` against the JAX
    package's, and the per-fold results."""
    _jax_init(monkeypatch)
    model, _ = fx._port_with_residual(fx.load(), "cpu")
    inputs = fx.train_inputs()

    def batches(b):
        return lambda: iter([(inputs["wav"][b], inputs["labels"][b])])

    folds = [(batches(0), batches(1)), (batches(1), batches(0))]
    kw = dict(epochs=3, lr=1e-2, seed=4)
    t_res = t_lp.train_and_eval_linear_head(model, "ESC50", folds, fx.TRAIN_CLASSES,
                                            str(tmp_path / "port"), **kw)
    j_res = j_lp.train_and_eval_linear_head(fx.jax_params(), fx.jax_config(), "ESC50", folds,
                                            fx.TRAIN_CLASSES, str(tmp_path / "jax"), **kw)
    assert [r["fold"] for r in t_res] == [r["fold"] for r in j_res] == [0, 1]
    assert [r["accuracy"] for r in t_res] == [r["accuracy"] for r in j_res]
    for i in range(2):
        name = f"ESC50/Linear/evalfold_{i}.npz"
        with np.load(tmp_path / "port" / name) as t, np.load(tmp_path / "jax" / name) as j:
            assert sorted(t.files) == sorted(j.files) == ["predictions", "similarities",
                                                          "targets"]
            np.testing.assert_array_equal(t["targets"], j["targets"])
            np.testing.assert_array_equal(t["predictions"], j["predictions"])
            np.testing.assert_allclose(t["similarities"], j["similarities"], atol=1e-5)


def test_embed_dataset_builds_the_fusion_input_of_clap_module():
    """A 2-D fusion model (``aff_2d``) through ``embed_dataset``: each clip's
    ``mel_fusion`` (chunks from ``default_rng(0)``), so the embeddings equal
    ``CLAPModule(enable_fusion=True, seed=0)``'s on the same clips, clips
    longer than the model's input and shorter ones. (The JAX function sends
    the waveform, which this model cannot take.)"""
    import unittest.mock as mock

    from audio_residual_tpu_torch import module as t_module
    from audio_residual_tpu_torch.data.featurize import mel_audio_cfg
    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.models import factory as t_factory
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    cfg = fx.fusion_port_config("aff_2d")
    full = t_clap.CLAPConfig(audio=cfg.audio, text=fx.port_clap_config("roberta").text,
                             context_length=fx.CLAP_CONTEXT, **fx.CLAP_KW)
    model = t_clap.build_clap(full, seed=0, device="cpu")
    clip = fx.AUDIO_KW["clip_samples"]
    rng = np.random.default_rng(6)
    batches = [((rng.standard_normal((2, n)) * 0.1).astype(np.float32), np.array([1, 0]))
               for n in (2 * clip + 500, clip // 3)]
    feats, labels = t_lp.embed_dataset(model, batches, max_len=clip)
    model_cfg = {"audio_cfg": {**mel_audio_cfg(cfg.audio), "clip_samples": clip}}
    with mock.patch.object(t_factory, "create_model", lambda *a, **k: (model, full, model_cfg)):
        module = t_module.CLAPModule(enable_fusion=True, seed=0, device="cpu",
                                     tokenizer=HashTokenizer(vocab_size=1000, context_length=16))
    want = np.concatenate([module.get_audio_embedding_from_data(list(w)) for w, _ in batches])
    np.testing.assert_array_equal(feats, want)
    np.testing.assert_array_equal(labels, [1, 0, 1, 0])
