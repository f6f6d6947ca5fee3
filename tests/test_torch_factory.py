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

import jax
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
    """The PANN towers and fusion, which raised naming slice 6 until they
    were ported, build; a vision config, which raised until its CLIP was
    ported, has no audio tower: ``create_audio_model`` refuses it with a
    ``ValueError`` that says so (``create_model`` builds its CLIP,
    ``tests/test_torch_vision.py``)."""
    if match == "slice 6":
        with torch.device("meta"):
            model, cfg, _ = t_factory.create_audio_model(name, device="meta")
        assert cfg.audio_model_type == "PANN" and cfg.audio.model_name == "Cnn14"
        audio = t_factory._amodel_to_config(t_factory.get_model_config("HTSAT-tiny"),
                                            enable_fusion=True, fusion_type="iaff_1d")
        assert audio.fusion == "1d"
        return
    with pytest.raises(ValueError, match=f"{match}: it has no audio tower"):
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


def _tower_file(path, sd: dict, form: str) -> None:
    """``sd`` (``audio_branch.*`` keys) written as a tower-only file: the
    official PANN layout (``{"model": ...}``, no prefix, the DSP extractor
    buffers too), or an HTS-AT codebase one (``state_dict``, ``sed_model.``)."""
    t = {k: torch.from_numpy(v) for k, v in sd.items() if k.startswith("audio_branch.")}
    if form == "model":
        t = {k[len("audio_branch."):]: v for k, v in t.items()}
        t["spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(3, 1, 4)
        torch.save({"model": t, "iteration": 7}, path)
    else:
        torch.save({"state_dict": {k.replace("audio_branch.", "sed_model."): v
                                   for k, v in t.items()}}, path)


@pytest.mark.parametrize("name,amodel,form", [("Cnn14_mAP.pth", "PANN-6", "model"),
                                              ("PANN_cnn6.ckpt", "PANN-6", "state_dict"),
                                              ("finetuned_cnn6.ckpt", "PANN-6", "state_dict"),
                                              ("finetuned_tiny.ckpt", "HTSAT-tiny", "state_dict")])
def test_load_audio_tower_equals_jax(tmp_path, name, amodel, form):
    """``load_audio_tower`` on each tower-only file the JAX
    ``load_audio_tower_params`` takes: the loaded tower equals JAX's result
    carried across by name."""
    from audio_residual_tpu_torch.models.convert import clap_audio_state_dict, pann_state_dict

    pann = amodel.startswith("PANN")
    cfg = (fx.pann_port_config("", model_name="Cnn6") if pann
           else t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW), **fx.CLAP_KW))
    sd = fx.port_weights(cfg, 4)
    path = str(tmp_path / name)
    _tower_file(path, sd, form)
    model = t_factory.load_audio_tower(fx._seeded_model(cfg, 0, "cpu"), path, amodel)
    jcfg = fx.pann_jax_config("", model_name="Cnn6") if pann else fx.jax_config()
    hp = j_factory.load_audio_tower_params(path, amodel, jcfg)
    if pann:
        want = pann_state_dict(hp, "")
    else:
        proj = fx.jax_audio_params(sd, "HTSAT", fx.AUDIO_KW["depths"])["audio_projection"]
        want = {k[len("audio_branch."):]: v for k, v in clap_audio_state_dict(
            {"audio_branch": hp, "audio_projection": proj}).items()
            if k.startswith("audio_branch.")}
    got = model.audio_branch.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_load_audio_tower_refuses_like_jax(tmp_path):
    cfg = fx.pann_port_config("", model_name="Cnn6")
    path = str(tmp_path / "other.ckpt")
    _tower_file(path, fx.port_weights(cfg, 4), "state_dict")
    model = fx._seeded_model(cfg, 0, "cpu")
    for amodel, match in (("PANN-6", "Unknown audio checkpoint"),
                          ("HTSAT-tiny", "Unknown audio checkpoint"),
                          ("MyTower", "not support")):
        with pytest.raises(ValueError, match=match):
            j_factory.load_audio_tower_params(path, amodel, None)
        with pytest.raises(ValueError, match=match):
            t_factory.load_audio_tower(model, path, amodel)


def test_create_model_and_transforms_equals_jax():
    """An audio config's ``preprocess`` (the batch featurization at the
    config's clip length) and a vision config's (the eval image transform)
    against the JAX package's, ``create_model`` stubbed in both."""
    import dataclasses as dc

    from audio_residual_tpu.models import clip as j_clip

    wav = np.random.default_rng(1).standard_normal((2, 9000)).astype(np.float32)
    model_cfg = {"audio_cfg": {"clip_samples": 24000}}
    port_model = fx._seeded_model(t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW),
                                                    **fx.CLAP_KW), 0, "cpu")
    with mock.patch.object(t_factory, "create_model", lambda *a, **k: (port_model, None,
                                                                       model_cfg)), \
            mock.patch.object(j_factory, "create_model", lambda *a, **k: ({}, None, model_cfg)):
        got = t_factory.create_model_and_transforms("HTSAT-tiny")[3](wav)
        want = j_factory.create_model_and_transforms("HTSAT-tiny")[3](wav)
    for k in ("waveform", "longer"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    with torch.device("meta"):
        model, cfg, _, pre = t_factory.create_model_and_transforms(
            "ViT-B-32-quickgelu", "transformer", device="meta")
    with mock.patch.object(j_clip, "init_clip_params", lambda key, cfg: {}):
        _, jcfg, _, jpre = j_factory.create_model_and_transforms("ViT-B-32-quickgelu",
                                                                 "transformer")
    assert cfg.vision.quick_gelu and cfg.text.quick_gelu
    assert dc.asdict(cfg.vision) == dc.asdict(jcfg.vision)
    img = np.random.default_rng(2).integers(0, 256, (300, 260, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pre(img).numpy(), jpre(img).transpose(2, 0, 1))


def test_convert_weights_to_bf16_equals_jax():
    """The same entries cast (floating, two or more axes) as the JAX
    function on the same arrays, the same values; the model untouched."""
    model = fx._seeded_model(fx.pann_port_config("", model_name="Cnn6", enable_fusion=True,
                                                 fusion_type="aff_2d"), 0, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = t_factory.convert_weights_to_bf16(model.state_dict())
    want = j_factory.convert_weights_to_bf16({k: np.asarray(v) for k, v in before.items()})
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert (v.dtype == torch.bfloat16) == (w.dtype.name == "bfloat16"), k
        np.testing.assert_array_equal(v.float().numpy(), w.astype(np.float32), err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) and v.dtype == before[k].dtype, k


def test_get_data_from_log_equals_jax(tmp_path):
    from audio_residual_tpu.utils.misc import get_data_from_log as j_get
    from audio_residual_tpu_torch.utils.misc import get_data_from_log as t_get

    log = tmp_path / "out.log"
    log.write_text("x | INFO | Eval Epoch: 0 all/loss: 0.5 mAP@10: 1e-3\n"
                   "Train Epoch: 1 [3/10] loss: -1.25 scale: 14.2857\n"
                   "no numbers here\nEval Epoch: 2 all/R@1: 0.75 epoch: 2\n")
    assert t_get(str(log)) == j_get(str(log))
    assert t_get(str(log))["all/loss"] == {0: 0.5}


@pytest.mark.parametrize("tower", ["PANN", "HTSAT"])
def test_bn_freeze_mask_equals_jax(tower):
    """``bn_freeze_mask``: every BatchNorm's scale and shift frozen (bn0,
    PANN's block BNs, the fusion branches' and mel convolutions' BNs), the
    JAX mask's leaves carried to names through the weight converter."""
    from audio_residual_tpu.utils.misc import bn_freeze_mask as j_mask
    from audio_residual_tpu_torch.models.convert import clap_audio_state_dict
    from audio_residual_tpu_torch.utils.misc import bn_freeze_mask as t_mask

    if tower == "PANN":
        cfg = fx.pann_port_config("", model_name="Cnn6", enable_fusion=True,
                                  fusion_type="aff_2d")
    else:
        cfg = fx.fusion_port_config("iaff_1d")
    sd = fx.port_weights(cfg, 1)
    params = fx.jax_audio_params(sd, tower, fx.AUDIO_KW["depths"])
    filled = jax.tree.map(lambda m, p: np.full(np.shape(p), m), j_mask(params), params)
    want = clap_audio_state_dict(filled)
    with torch.device("meta"):
        model = t_clap.CLAPAudio(cfg)
    got = t_mask(model)
    assert set(got) == {k for k, _ in model.named_parameters()} and set(got) <= set(want)
    assert got == {k: bool(want[k].all()) for k in got}
    assert all(want[k].all() == want[k].any() for k in got)
    assert not got["audio_branch.bn0.weight"] and got["audio_projection.0.weight"]
