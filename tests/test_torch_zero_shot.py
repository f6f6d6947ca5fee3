"""The port's ``CLAPModule`` (``audio_residual_tpu_torch/module.py``) and its
zero-shot and retrieval evaluations held against the JAX package's on the
CPU, both modules on the same weights: the CLAP fixture's seeded roberta
model at narrow widths (``tests/torch_port_fixture.py``), tokenised by
``HashTokenizer``.

Tolerances: text embeddings f32 ``atol=1e-5, rtol=1e-4``; audio embeddings
the slice's (``atol=2e-3, rtol=1e-3``, cosine > 0.99999, as
``tests/test_torch_htsat.py``); metrics equal to 1e-6.
"""

import json
import unittest.mock as mock

import numpy as np
import pytest
import torch

from audio_residual_tpu import module as j_module
from audio_residual_tpu.evaluate import retrieval as j_retrieval
from audio_residual_tpu.evaluate import zero_shot as j_zero_shot
from audio_residual_tpu.models import convert as j_convert
from audio_residual_tpu.models import factory as j_factory
from audio_residual_tpu.models import pretrained as j_pretrained
from audio_residual_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from audio_residual_tpu_torch import module as t_module
from audio_residual_tpu_torch.evaluate import retrieval as t_retrieval
from audio_residual_tpu_torch.evaluate import zero_shot as t_zero_shot
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models import pretrained as t_pretrained
from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

from . import torch_port_fixture as fx

F32 = dict(atol=1e-5, rtol=1e-4)
SLICE = dict(atol=2e-3, rtol=1e-3)
REPO_LABELS = fx.PATH.parents[2] / "class_labels" / "ESC50_class_labels_indices_space.json"
CLASSES = list(json.loads(REPO_LABELS.read_text()))[:5]
T = fx.AUDIO_KW["clip_samples"] // 2  # ESC-50's ratio: half the model's input, repeat-padded


def _port_module(seed: int = fx.CLAP_SEED, **kw) -> t_module.CLAPModule:
    """A port CLAPModule on the CLAP fixture's roberta weights (or, for
    another ``seed``, on other random weights)."""
    cfg = fx.port_clap_config("roberta")
    model = t_clap.build_clap(cfg, seed=seed, device="cpu")
    if seed == fx.CLAP_SEED:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in fx.clap_weights("roberta").items()})
    model_cfg = t_factory.get_model_config("HTSAT-tiny")
    with mock.patch.object(t_factory, "create_model", lambda *a, **k: (model, cfg, model_cfg)):
        return t_module.CLAPModule(device="cpu", tokenizer=HashTokenizer(
            vocab_size=1000, context_length=fx.CLAP_CONTEXT), **kw)


@pytest.fixture(scope="module")
def modules():
    cfg = fx.jax_clap_config("roberta")
    params = j_convert.convert_clap_state_dict(fx.clap_weights("roberta"), fx.AUDIO_KW["depths"])
    model_cfg = j_factory.get_model_config("HTSAT-tiny")
    with mock.patch.object(j_factory, "create_model", lambda *a, **k: (params, cfg, model_cfg)):
        jm = j_module.CLAPModule(tokenizer=JHashTokenizer(vocab_size=1000,
                                                          context_length=fx.CLAP_CONTEXT))
    return jm, _port_module()


def _wav(n: int, seed: int, t: int = T) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((n, t)) * 0.1).astype(np.float32)


def _audio_close(got, ref) -> None:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **SLICE)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() > 0.99999


def test_text_embedding_matches_jax(modules):
    jm, tm = modules
    prompts = [t_zero_shot.PROMPT_TEMPLATES["default"].format(c) for c in CLASSES]
    ref = jm.get_text_embedding(prompts)
    got = tm.get_text_embedding(prompts)
    assert isinstance(got, np.ndarray) and got.shape == (5, fx.CLAP_KW["joint_embed_shape"])
    np.testing.assert_allclose(got, ref, **F32)
    as_tensor = tm.get_text_embedding(prompts, use_tensor=True)
    assert isinstance(as_tensor, torch.Tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), got)


@pytest.mark.parametrize("use_tensor", [False, True])
def test_audio_embedding_matches_jax(modules, use_tensor):
    """``use_tensor=False`` takes the int16 round trip, ``True`` does not."""
    jm, tm = modules
    wav = _wav(2, 11)
    got = tm.get_audio_embedding_from_data(wav, use_tensor=use_tensor)
    assert isinstance(got, torch.Tensor if use_tensor else np.ndarray)
    _audio_close(got.detach() if use_tensor else got,
                 jm.get_audio_embedding_from_data(wav, use_tensor=use_tensor))


def test_audio_output_dict_matches_jax(modules):
    jm, tm = modules
    wav = _wav(2, 12)
    ref, got = jm.get_audio_output_dict(wav), tm.get_audio_output_dict(wav)
    assert set(got) == set(ref)
    _audio_close(got["normalized"], ref["normalized"])
    for i, (g, r) in enumerate(zip(got["layers_residuals"], ref["layers_residuals"])):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), err_msg=str(i), **SLICE)


def test_amp_module_keeps_its_text_side_f32(modules):
    """``get_text_embedding`` calls ``encode_text`` without
    ``compute_dtype`` (the JAX quirk): an AMP module's text embeddings are
    the golden module's; its audio embeddings hold the bench guard."""
    _, tm = modules
    amp = _port_module(compute_dtype=torch.bfloat16)
    texts = ["a dog barking", "rain falling on a roof"]
    np.testing.assert_array_equal(amp.get_text_embedding(texts), tm.get_text_embedding(texts))
    wav = _wav(2, 13)
    cos = (amp.get_audio_embedding_from_data(wav) * tm.get_audio_embedding_from_data(wav)).sum(-1)
    assert cos.min() > 0.999


def _metrics_equal(got: dict, ref: dict) -> None:
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(v, np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_evaluate_zeroshot_matches_jax(modules):
    jm, tm = modules
    assert t_zero_shot.PROMPT_TEMPLATES == j_zero_shot.PROMPT_TEMPLATES
    np.testing.assert_allclose(t_zero_shot.build_text_classifier(tm, CLASSES, "GTZAN"),
                               j_zero_shot.build_text_classifier(jm, CLASSES, "GTZAN"), **F32)
    batches = [(_wav(2, 20 + i), np.array([i, 4 - i])) for i in range(2)]
    ref = j_zero_shot.evaluate_zeroshot(jm, batches, CLASSES, topk=3)
    got = t_zero_shot.evaluate_zeroshot(tm, batches, CLASSES, topk=3)
    _metrics_equal(got, ref)


def test_evaluate_retrieval_matches_jax(modules):
    jm, tm = modules
    batches = [(_wav(2, 30 + i), [f"a sound of {CLASSES[i]}", f"{CLASSES[4 - i]} nearby"])
               for i in range(2)]
    _metrics_equal(t_retrieval.evaluate_retrieval(tm, batches, logit_scale=2.0),
                   j_retrieval.evaluate_retrieval(jm, batches, logit_scale=2.0))


def test_evaluate_multicaption_and_top_metric_match_jax():
    rng = np.random.default_rng(40)
    audio, text = rng.standard_normal((6, 8)), rng.standard_normal((30, 8))
    got = t_retrieval.evaluate_multicaption(audio, text, 5)
    assert got == j_retrieval.evaluate_multicaption(audio, text, 5)
    history = [got, {**got, "text_to_audio_mAP@10": 2.0}, {"other": 1.0}]
    assert t_retrieval.select_top_metric(history) == j_retrieval.select_top_metric(history)
    with pytest.raises(ValueError, match="captions"):
        t_retrieval.evaluate_multicaption(audio, text[:29], 5)


def test_audio_infer_matches_jax(modules):
    """A clip 1.5 model inputs long: two windows, the last one flush right."""
    jm, tm = modules
    clip = _wav(1, 50, t=3 * fx.AUDIO_KW["clip_samples"] // 2)[0]
    ref = j_module.audio_infer(jm, clip)["embedding"]
    got = t_module.audio_infer(tm, clip)["embedding"]
    assert got.shape == ref.shape == (2, fx.CLAP_KW["embed_dim"])
    np.testing.assert_allclose(got, ref, **SLICE)
    short = t_module.audio_infer(tm, clip[:T // 2], key="normalized")["normalized"]
    assert short.shape == (1, fx.CLAP_KW["joint_embed_shape"])


def test_load_ckpt_reads_a_local_file_only(modules, tmp_path):
    """A module on other weights, then ``load_ckpt`` of the fixture's: the
    JAX module's text embeddings. Without a path it names the file and the
    URL it would need."""
    jm, _ = modules
    other = _port_module(seed=9)
    path = tmp_path / "clap.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in fx.clap_weights("roberta").items()}}, path)
    texts = ["a dog barking", "thunder"]
    assert not np.allclose(other.get_text_embedding(texts), jm.get_text_embedding(texts), **F32)
    assert other.load_ckpt(str(path), verbose=False) is other
    np.testing.assert_allclose(other.get_text_embedding(texts), jm.get_text_embedding(texts),
                               **F32)
    with pytest.raises(FileNotFoundError, match="630k-audioset-best.pt"):
        other.load_ckpt()
    with pytest.raises(FileNotFoundError):
        other.get_audio_embedding_from_filelist([str(tmp_path / "a.wav")])


def test_pretrained_registry_matches_jax_and_fetches_nothing(tmp_path, monkeypatch):
    assert t_pretrained.list_pretrained() == j_pretrained.list_pretrained()
    for name in t_pretrained.list_pretrained():
        assert t_pretrained.get_pretrained_url(name) == j_pretrained.get_pretrained_url(name)
    with pytest.raises(FileNotFoundError, match="huggingface.co"):
        t_pretrained.pretrained_path("630k-best", str(tmp_path))
    (tmp_path / "630k-best.pt").write_bytes(b"x")
    found = t_pretrained.pretrained_path("630k-best", str(tmp_path))
    assert found == str(tmp_path / "630k-best.pt")
    monkeypatch.setitem(t_pretrained._PRETRAINED, "local-test",
                        ("https://example.invalid/local-test.pt", "0" * 64))
    (tmp_path / "local-test.pt").write_bytes(b"x")
    with pytest.raises(RuntimeError, match="sha256"):
        t_pretrained.pretrained_path("local-test", str(tmp_path))
