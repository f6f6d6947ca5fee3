"""The port's model registry and checkpoint loader held against the JAX
package's (``audio_residual_tpu/models/factory.py``, ``convert.py``).

Configs come from the same ``configs/model_configs/`` files. Checkpoints are
written by the tests into ``tmp_path`` from the JAX exporter
(``clap_params_to_state_dict``) of the tiny fixture's params; the loaded
port is compared with the JAX outputs stored in
``tests/data/torch_port_tiny.npz`` at the slice's tolerance (``atol=2e-3,
rtol=1e-3``, embedding cosine > 0.99999).
"""

import dataclasses
import json
import unittest.mock as mock

import numpy as np
import pytest
import torch

from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu.models import convert as j_convert
from audio_residual_tpu.models import factory as j_factory
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models.convert import load_audio_checkpoint

from . import torch_port_fixture as fx

HTSAT_NAMES = ["HTSAT-tiny", "HTSAT-base", "HTSAT-large", "HTSAT-tiny-win-1536"]


def test_list_models_equals_jax_registry():
    assert t_factory.list_models() == j_factory.list_models()


@pytest.mark.parametrize("name", j_factory.list_models())
def test_get_model_config_equals_jax(name):
    assert t_factory.get_model_config(name) == j_factory.get_model_config(name)


@pytest.mark.parametrize("name", HTSAT_NAMES)
def test_clap_config_equals_jax_create_model(name):
    """Field by field: the CLAP fields the port has, and every audio field
    both configs have. Neither side builds weights here."""
    with mock.patch.object(j_clap, "init_clap_params", lambda key, cfg: {}):
        _, jcfg, jmodel_cfg = j_factory.create_model(name)
    with mock.patch.object(t_factory, "build_clap_audio", lambda cfg, **kw: None):
        _, tcfg, tmodel_cfg = t_factory.create_audio_model(name.replace("-", "/", 1))
    assert tmodel_cfg == jmodel_cfg
    for f in dataclasses.fields(tcfg):
        if f.name == "text":  # the text tower's config: each package its own class
            for g in dataclasses.fields(tcfg.text):
                assert getattr(tcfg.text, g.name) == getattr(jcfg.text, g.name), g.name
        elif f.name != "audio":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    shared = {f.name for f in dataclasses.fields(tcfg.audio)} & {
        f.name for f in dataclasses.fields(jcfg.audio)}
    assert len(shared) == len(dataclasses.fields(tcfg.audio))
    for field in shared:
        assert getattr(tcfg.audio, field) == getattr(jcfg.audio, field), field
    assert tcfg.embed_dim == tcfg.audio.num_features == jmodel_cfg["embed_dim"]


def test_create_audio_model_builds_htsat_tiny_on_cpu():
    model, cfg, model_cfg = t_factory.create_audio_model("HTSAT-tiny", seed=3, device="cpu")
    assert model.cfg == cfg and cfg.audio.depths == (2, 2, 6, 2)
    assert model.audio_projection[0].in_features == model_cfg["embed_dim"] == 768
    assert not any(p.requires_grad for p in model.parameters())
    again, _, _ = t_factory.create_audio_model("HTSAT-tiny", seed=3, device="cpu")
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


def test_create_audio_model_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_factory.create_audio_model("HTSAT-tiny")


@pytest.mark.parametrize("name,match", [("PANN-14", "slice 6"), ("RN50", "vision config")])
def test_unported_towers_raise(name, match):
    """The vision configs raise; the PANN towers and fusion, which raised
    naming slice 6 until they were ported, now build."""
    if match == "slice 6":
        with torch.device("meta"):
            model, cfg, _ = t_factory.create_audio_model(name, device="meta")
        assert cfg.audio_model_type == "PANN" and cfg.audio.model_name == "Cnn14"
        audio = t_factory._amodel_to_config(t_factory.get_model_config("HTSAT-tiny"),
                                            enable_fusion=True, fusion_type="iaff_1d")
        assert audio.fusion == "1d"
        return
    with pytest.raises(NotImplementedError, match=match):
        t_factory.create_audio_model(name, device="cpu")


def test_add_model_config_registers_a_file(tmp_path):
    cfg = t_factory.get_model_config("HTSAT-base")
    (tmp_path / "HTSAT-base-copy.json").write_text(json.dumps(cfg))
    try:
        with mock.patch.object(t_factory, "_CONFIG_DIRS", list(t_factory._CONFIG_DIRS)):
            t_factory.add_model_config(str(tmp_path / "HTSAT-base-copy.json"))
            assert "HTSAT-base-copy" in t_factory.list_models()
            assert t_factory.get_model_config("HTSAT-base-copy") == cfg
    finally:
        t_factory._rescan()
    assert "HTSAT-base-copy" not in t_factory.list_models()


def _fixture_model(seed=0):
    cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW), **fx.CLAP_KW)
    return t_clap.build_clap_audio(cfg, seed=seed, device="cpu")


def _reference_checkpoint(prefix: str, tower_only: bool) -> dict:
    """The fixture's params as a reference checkpoint: the JAX exporter's
    keys (text side and transform heads included) under ``prefix``, plus the
    extractor buffers, BatchNorm's step count and the text position ids a
    published checkpoint carries."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          j_convert.clap_params_to_state_dict(fx.jax_params()).items()}
    sd["audio_branch.bn0.num_batches_tracked"] = torch.tensor(100)
    sd["audio_branch.spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1, 1024)
    sd["audio_branch.logmel_extractor.melW"] = torch.zeros(1024, 64)
    sd["text_branch.embeddings.position_ids"] = torch.arange(77)[None]
    if tower_only:
        sd = {k.replace("audio_branch.", "sed_model."): v for k, v in sd.items()
              if k.startswith("audio_branch.")}
    return {"state_dict": {prefix + k: v for k, v in sd.items()}, "epoch": 3}


def _assert_matches_jax(got: dict, keys):
    ref = fx.load()
    for key in keys:
        np.testing.assert_allclose(got[key], ref[f"out/{key}"], atol=2e-3, rtol=1e-3,
                                   err_msg=key)
        if key in ("embedding", "normalized"):
            g, r = got[key], ref[f"out/{key}"]
            cos = (g * r).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(r, axis=-1))
            assert cos.min() > 0.99999, (key, cos)


def _run(model):
    """The fixture's input through ``model`` (the fixture's own program)."""
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip

    arrays = fx.load()
    res = {k[len("residual/"):]: torch.tensor(v) for k, v in arrays.items()
           if k.startswith("residual/")}
    batch = featurize_batch(quantize_roundtrip(torch.tensor(arrays["wav"])),
                            model.cfg.audio.clip_samples)
    out = t_clap.encode_audio(model, batch, residual={0: res}, double_ffn_compat=True)
    return {k: v.numpy() for k, v in out.items() if k in fx.OUTPUT_KEYS}


def test_load_audio_checkpoint_matches_jax(tmp_path):
    """A full CLAP checkpoint with DDP ``module.`` prefixes."""
    path = tmp_path / "clap.pt"
    torch.save(_reference_checkpoint("module.", tower_only=False), path)
    model = load_audio_checkpoint(_fixture_model(seed=5), path)
    _assert_matches_jax(_run(model), fx.OUTPUT_KEYS)


def test_load_tower_only_sed_model_checkpoint(tmp_path):
    """An HTS-AT codebase checkpoint: ``sed_model.`` keys, no projection. The
    tower matches the JAX outputs; the projection stays as built."""
    path = tmp_path / "HTSAT_tower.ckpt"
    torch.save(_reference_checkpoint("", tower_only=True), path)
    model = _fixture_model(seed=5)
    proj = {k: v.clone() for k, v in model.audio_projection.state_dict().items()}
    load_audio_checkpoint(model, path)
    for k, v in model.audio_projection.state_dict().items():
        assert torch.equal(v, proj[k]), k
    _assert_matches_jax(_run(model), [k for k in fx.OUTPUT_KEYS
                                      if k not in ("normalized",)])


def test_load_audio_checkpoint_refuses_what_does_not_fit(tmp_path):
    ckpt = _reference_checkpoint("", tower_only=False)
    del ckpt["state_dict"]["audio_branch.norm.weight"]
    torch.save(ckpt, tmp_path / "missing.pt")
    with pytest.raises(RuntimeError, match="missing.*audio_branch.norm.weight"):
        load_audio_checkpoint(_fixture_model(), tmp_path / "missing.pt")
    ckpt = _reference_checkpoint("", tower_only=False)
    ckpt["state_dict"]["audio_branch.extra.weight"] = torch.zeros(3)
    torch.save(ckpt, tmp_path / "extra.pt")
    with pytest.raises(RuntimeError, match="unexpected.*audio_branch.extra.weight"):
        load_audio_checkpoint(_fixture_model(), tmp_path / "extra.pt")
