"""The port's full CLAP (``models/clap.py``, ``convert.py``, ``factory.py``)
held against the JAX package on the CPU, for every ``text_model_type``.

The CLAP fixture (``tests/data/torch_port_clap.npz``, made by
``tests/torch_port_fixture.py``) holds JAX's ``clap_apply`` outputs on seeded
reference-layout weights; a test regenerates it, so it cannot drift.
Tolerances: f32 ``atol=1e-5, rtol=1e-4`` (the same f32 program, sums in
another order); roberta's AMP text features against JAX's
``compute_dtype=bfloat16``: max rel err <= 2e-2 and cosine > 0.99999.
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu.models import convert as j_convert
from audio_residual_tpu.models import factory as j_factory
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models.convert import (clap_state_dict, load_clap_checkpoint,
                                                     load_jax_params)

from . import torch_port_fixture as fx

F32 = dict(atol=1e-5, rtol=1e-4)
TMODELS = tuple(fx.CLAP_TEXT_KW)


@pytest.fixture(scope="module")
def committed():
    return fx.load(fx.CLAP_PATH)


def test_committed_clap_fixture_is_current(committed):
    """Regenerated from the JAX package == the committed file: config and
    inputs exactly, outputs to 1e-5 (the same f32 program, run again)."""
    fresh = fx.build_clap()
    assert set(committed) == set(fresh)
    assert str(committed["config"]) == str(fresh["config"])
    for k in fresh:
        if k.startswith("out/"):
            np.testing.assert_allclose(committed[k], fresh[k], rtol=1e-5, atol=1e-6, err_msg=k)
        elif k != "config":
            np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    assert fx.CLAP_PATH.stat().st_size < 1 << 20


@pytest.mark.parametrize("tmodel", TMODELS)
def test_clap_apply_matches_jax_fixture(committed, tmodel):
    got = fx.run_port_clap(committed, tmodel, "cpu")
    for key in fx.CLAP_APPLY_KEYS:
        ref = committed[f"out/{tmodel}/{key}"]
        assert got[key].shape == ref.shape, key
        np.testing.assert_allclose(got[key], ref, err_msg=key, **F32)
    np.testing.assert_allclose(got["logit_scale_a"], committed[f"out/{tmodel}/logit_scale_a"],
                               rtol=1e-6)


def test_roberta_amp_text_matches_jax_fixture(committed):
    got = fx.run_port_clap(committed, "roberta", "cpu", torch.bfloat16)["text_features"]
    ref = committed["out/roberta/text_features_bf16"]
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 2e-2
    assert (got * ref).sum(-1).min() > 0.99999


@pytest.mark.parametrize("tmodel", TMODELS)
def test_encode_text_and_transforms_match_jax(tmodel):
    """JAX params from a key -> the port through ``load_jax_params``:
    ``encode_text`` (normalised and not) and both transform heads."""
    jcfg = fx.jax_clap_config(tmodel)
    params = jax.tree.map(np.asarray, j_clap.init_clap_params(jax.random.PRNGKey(4), jcfg))
    model = load_jax_params(t_clap.build_clap(fx.port_clap_config(tmodel), device="cpu"), params)
    text = fx.text_inputs(tmodel)
    ids, mask = text["input_ids"], text["attention_mask"]
    for normalize in (True, False):
        ref = j_clap.encode_text(params, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                                 normalize=normalize)
        got = t_clap.encode_text(model, ids, mask, normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    x = np.array(ref)
    for side in ("audio", "text"):
        ref = j_clap.apply_transform(jcfg, params[f"{side}_transform"], jnp.asarray(x))
        got = t_clap.apply_transform(getattr(model, f"{side}_transform"), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_clap_state_dict_equals_the_jax_exporter():
    """roberta, the tower the JAX package exports: keys and values equal
    ``clap_params_to_state_dict``'s."""
    params = jax.tree.map(np.asarray, j_clap.init_clap_params(jax.random.PRNGKey(4),
                                                              fx.jax_clap_config("roberta")))
    ref = j_convert.clap_params_to_state_dict(params)
    got = clap_state_dict(params, "roberta")
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def test_build_clap_keeps_the_audio_weights_of_build_clap_audio():
    """One seed, one audio half: the text half draws after it."""
    cfg = fx.port_clap_config("roberta")
    full = t_clap.build_clap(cfg, seed=3, device="cpu").state_dict()
    for k, v in t_clap.build_clap_audio(cfg, seed=3, device="cpu").state_dict().items():
        assert torch.equal(full[k], v), k


def test_apply_transform_drops_out_in_training_only():
    model = t_clap.build_clap(fx.port_clap_config("bart"), device="cpu")
    x = torch.randn(64, fx.CLAP_KW["joint_embed_shape"], generator=torch.Generator().manual_seed(0))
    head = model.text_transform
    eval_out = t_clap.apply_transform(head, x)
    a = t_clap.apply_transform(head, x, train=True, generator=torch.Generator().manual_seed(1))
    b = t_clap.apply_transform(head, x, train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.allclose(a, eval_out)
    seq = head.sequential
    keep = torch.rand((64, seq[0].out_features), generator=torch.Generator().manual_seed(1)) < 0.9
    ref = seq[3](torch.relu(seq[0](x)) * keep / 0.9)
    torch.testing.assert_close(a, ref)
    assert 0.8 < keep.float().mean() < 0.97


def test_clap_apply_has_no_train_mode_yet(committed):
    """The text side has no training mode (the JAX package's neither):
    ``clap_apply(train=True)`` without a generator gives eval's text
    features, its transforms without dropout, and adds ``bn0_state``."""
    model = t_clap.build_clap(fx.port_clap_config("roberta"), device="cpu")
    wav = torch.from_numpy(committed["wav"][:, :24000])
    ids = committed["text/roberta/input_ids"][:2]
    ev = t_clap.clap_apply(model, wav, ids)
    tr = t_clap.clap_apply(model, wav, ids, train=True)
    assert torch.equal(tr["text_features"], ev["text_features"])
    assert torch.equal(tr["text_features_mlp"], ev["text_features_mlp"])
    assert "bn0_state" in tr and "bn0_state" not in ev


def _fields_equal(t, j) -> None:
    """Dataclass fields of the port's config equal the JAX config's (nested
    configs field by field; JAX's text configs may also carry ``dtype``)."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            _fields_equal(tv, jv)
        else:
            assert tv == jv, f.name


def test_clap_config_defaults_match_jax():
    _fields_equal(t_clap.CLAPConfig(), j_clap.CLAPConfig())
    for tmodel in TMODELS:
        assert t_clap.text_tower_width(fx.port_clap_config(tmodel)) == \
            j_clap.text_tower_width(fx.jax_clap_config(tmodel))


@pytest.mark.parametrize("tmodel", TMODELS)
def test_create_model_matches_jax(tmodel):
    """Config field by field, and every parameter's name and shape against
    the JAX tree of ``factory.create_model`` through the port's mapping
    (shapes only: JAX by ``eval_shape``, the port on the meta device)."""
    init = j_clap.init_clap_params
    with mock.patch.object(j_clap, "init_clap_params",
                           lambda key, cfg: jax.eval_shape(init, key, cfg)):
        shapes, jcfg, jmodel_cfg = j_factory.create_model("HTSAT-tiny", tmodel)
    with torch.device("meta"):
        model, tcfg, tmodel_cfg = t_factory.create_model("HTSAT-tiny", tmodel, device="meta")
    assert tmodel_cfg == jmodel_cfg and model.cfg == tcfg
    _fields_equal(tcfg, jcfg)
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    ref = {k: v.shape for k, v in clap_state_dict(zeros, tmodel).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == ref
    assert not any(p.requires_grad for p in model.parameters())


def test_create_model_quick_gelu_and_unported_configs(caplog):
    with torch.device("meta"):
        _, cfg, _ = t_factory.create_model("HTSAT-tiny", "transformer", device="meta",
                                           force_quick_gelu=True)
        assert cfg.text.quick_gelu
        _, cfg, _ = t_factory.create_model("HTSAT-tiny", "roberta", device="meta",
                                           pretrained_text="roberta.pt")
    assert "pretrained_text" in caplog.text
    # PANN towers, fusion and the vision configs' CLIPs are ported: they build
    with torch.device("meta"):
        model, cfg, _ = t_factory.create_model("PANN-14", device="meta")
        assert cfg.audio_model_type == "PANN" and cfg.embed_dim == 2048
        _, cfg, _ = t_factory.create_model("HTSAT-tiny", enable_fusion=True,
                                           fusion_type="aff_2d", device="meta")
        assert cfg.audio.fusion == "2d"
        _, cfg, _ = t_factory.create_model("RN50", "transformer", device="meta",
                                           force_quick_gelu=True)
        assert cfg.vision.layers == (3, 4, 6, 3) and cfg.vision.quick_gelu
    with pytest.raises(RuntimeError, match="not found"):
        t_factory.create_model("HTSAT-tiny", "gpt", device="cpu")


def _write_checkpoint(path, sd: dict) -> None:
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": torch.from_numpy(np.array(v))
                                           for k, v in sd.items()}}, path)


@pytest.mark.parametrize("tmodel", TMODELS)
def test_load_clap_checkpoint_round_trips_through_jax(tmp_path, committed, tmodel):
    """A reference-layout ``.pt`` (``module.`` prefixes, HF's derived
    ``position_ids`` buffer, a BART decoder key) -> the port, and -> JAX
    through ``convert_clap_state_dict``: the same weights, the same
    ``clap_apply``."""
    sd = fx.clap_weights(tmodel)
    extra = {"text_branch.embeddings.position_ids": np.arange(18)[None],
             "text_branch.decoder.layers.0.fc1.weight": np.ones((2, 2), np.float32)}
    path = tmp_path / f"{tmodel}.pt"
    _write_checkpoint(path, {**sd, **extra})
    model = load_clap_checkpoint(t_clap.build_clap(fx.port_clap_config(tmodel), seed=9,
                                                   device="cpu"), path)
    got_sd = model.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)
    params = j_convert.convert_clap_state_dict(j_convert.load_torch_checkpoint(str(path)),
                                               fx.AUDIO_KW["depths"])
    text = fx.text_inputs(tmodel)
    ref = j_clap.encode_text(params, jnp.asarray(text["input_ids"]),
                             jnp.asarray(text["attention_mask"]), fx.jax_clap_config(tmodel))
    got = t_clap.encode_text(model, text["input_ids"], text["attention_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    np.testing.assert_allclose(got.numpy(), committed[f"out/{tmodel}/text_features"], **F32)


def test_load_clap_checkpoint_is_strict(tmp_path):
    sd = fx.clap_weights("roberta")
    model = t_clap.build_clap(fx.port_clap_config("roberta"), device="cpu")
    missing = dict(sd)
    missing.pop("text_projection.0.weight")
    _write_checkpoint(tmp_path / "a.pt", missing)
    with pytest.raises(RuntimeError, match="missing"):
        load_clap_checkpoint(model, tmp_path / "a.pt")
    _write_checkpoint(tmp_path / "b.pt", {**sd, "text_branch.extra.weight": np.ones(2)})
    with pytest.raises(RuntimeError, match="unexpected"):
        load_clap_checkpoint(model, tmp_path / "b.pt")


def test_factory_loads_full_audio_and_tower_checkpoints(tmp_path):
    """``load_checkpoint`` takes a whole checkpoint or an audio-only one (the
    text side stays as built); ``load_audio_tower`` an HTSAT tower by file
    name, ``sed_model.`` keys read as ``audio_branch.``."""
    sd = fx.clap_weights("roberta")
    cfg = fx.port_clap_config("roberta")
    _write_checkpoint(tmp_path / "full.pt", sd)
    model = t_factory.load_checkpoint(t_clap.build_clap(cfg, seed=5, device="cpu"),
                                      str(tmp_path / "full.pt"))
    assert torch.equal(model.text_projection[0].weight,
                       torch.from_numpy(sd["text_projection.0.weight"]))
    audio = {k: v for k, v in sd.items() if k.startswith(("audio_branch.", "audio_projection."))}
    _write_checkpoint(tmp_path / "audio.pt", audio)
    fresh = t_clap.build_clap(cfg, seed=5, device="cpu")
    before = fresh.text_projection[0].weight.clone()
    t_factory.load_checkpoint(fresh, str(tmp_path / "audio.pt"))
    assert torch.equal(fresh.text_projection[0].weight, before)
    assert torch.equal(fresh.audio_projection[0].weight,
                       torch.from_numpy(sd["audio_projection.0.weight"]))
    tower = {k.replace("audio_branch.", "sed_model."): v for k, v in audio.items()
             if k.startswith("audio_branch.")}
    _write_checkpoint(tmp_path / "HTSAT_tower.ckpt", tower)
    tuned = t_factory.load_audio_tower(t_clap.build_clap(cfg, seed=6, device="cpu"),
                                       str(tmp_path / "HTSAT_tower.ckpt"))
    assert torch.equal(tuned.audio_branch.head.weight,
                       torch.from_numpy(sd["audio_branch.head.weight"]))
    with pytest.raises(ValueError, match="Unknown audio checkpoint"):
        t_factory.load_audio_tower(tuned, str(tmp_path / "audio.pt"))
