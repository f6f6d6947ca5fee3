"""The port's PANN towers held against the JAX package on the CPU.

Seeded weights in the reference ``state_dict`` layout
(``tests/torch_port_fixture.py::seeded_state_dict``) reach the JAX package
through its ``convert_pann_state_dict`` (plus the fusion keys), on 0.5 s
clips: Cnn6 with every fusion type, Cnn10 and Cnn14 without fusion and with
``aff_2d``, at the JAX parity suite's tolerance (``atol=2e-3, rtol=1e-3``,
embedding cosine > 0.99999); a training forward on the JAX package's own
draws; ``encode_audio`` of ``PANN-6``; the committed fixture
``tests/data/torch_port_pann.npz``; the registry and the weight bridge.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu.models import pann as j_pann
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import convert as t_convert
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models import pann as t_pann

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

GOLDEN = dict(atol=2e-3, rtol=1e-3)
KEYS = ("clipwise_output", "embedding", "fine_grained_embedding")
CASES = ([("Cnn6", ft) for ft in ("None", *fx.FUSION_TYPES)]
         + [(m, ft) for m in ("Cnn10", "Cnn14") for ft in ("None", "aff_2d")])


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))).min())


def _inputs(fusion: bool) -> tuple[dict, dict]:
    """(port batch, JAX batch): 2 clips of 0.5 s, or their fusion stack."""
    if fusion:
        arrays = fx.fusion_inputs(8, 64, fx.PANN_CLIP // 480 + 1)
    else:
        rng = np.random.default_rng(8)
        arrays = {"waveform": (rng.standard_normal((2, fx.PANN_CLIP)) * 0.1).astype(np.float32)}
    return ({k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def _pair(model_name: str, fusion_type: str, seed: int = 1):
    """(port PANN tower, JAX params, JAX PANNConfig) on the same seeded weights."""
    kw = dict(model_name=model_name, enable_fusion=fusion_type != "None",
              fusion_type=fusion_type)
    cfg = fx.pann_port_config("", **kw)
    model = fx._seeded_model(cfg, seed, "cpu")
    params = fx.jax_audio_params(fx.port_weights(cfg, seed), "PANN")
    return model, params, fx.pann_jax_config("", **kw)


@pytest.mark.parametrize("model_name,fusion_type", CASES)
def test_pann_matches_jax(model_name, fusion_type):
    model, params, jcfg = _pair(model_name, fusion_type)
    batch, jbatch = _inputs(fusion_type != "None")
    got = t_pann.pann_apply(model.audio_branch, batch)
    want = jax.jit(functools.partial(j_pann.pann_apply, cfg=jcfg.audio))(
        params["audio_branch"], jbatch)
    for key in KEYS:
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == np.float32, key
        np.testing.assert_allclose(g, w, err_msg=key, **GOLDEN)
        if key == "embedding":
            assert _cos(g, w) > 0.99999


@pytest.fixture(scope="module")
def fresh():
    return fx.build_pann()


def test_committed_pann_fixture_is_current(fresh):
    committed = fx.load(fx.PANN_PATH)
    assert set(committed) == set(fresh)
    assert str(committed["config"]) == str(fresh["config"])
    for k in fresh:
        if k.startswith("out/"):
            np.testing.assert_allclose(committed[k], fresh[k], rtol=1e-5, atol=1e-6, err_msg=k)
        elif k != "config":
            np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    assert fx.PANN_PATH.stat().st_size < 1 << 20


def test_pann_fixture_matches_the_port(fresh):
    got = fx.run_port_pann(fresh, "cpu")
    for name in fx.PANN_MODELS:
        for key in fx.PANN_OUTPUT_KEYS:
            ref = fresh[f"out/{name}/{key}"]
            np.testing.assert_allclose(got[name][key], ref, err_msg=f"{name} {key}", **GOLDEN)
            if key != "clipwise_output":
                assert _cos(got[name][key], ref) > 0.99999


def _jax_spec_draws(key, b: int, t: int, f: int):
    """``(rng, stripes)``: the JAX package's first split of its training key
    and the SpecAugment stripes it draws from the other half (time over
    ``t`` frames, frequency over ``f`` columns)."""
    rng, arng = jax.random.split(key)
    k1, k2 = jax.random.split(arng)

    def stripes(k, dim, width):
        ka, kb = jax.random.split(k)
        w = jax.random.randint(ka, (b, 2), 0, width)
        s = jax.random.randint(kb, (b, 2), 0, jnp.maximum(dim - w, 1))
        return torch.from_numpy(np.array(w)).long(), torch.from_numpy(np.array(s)).long()

    return rng, (stripes(k1, t, 64), stripes(k2, f, 8))


def test_training_forward_on_jax_draws(monkeypatch):
    """Cnn6, ``train=True``: SpecAugment and the dropouts on the masks the
    JAX package draws from its key, fed to the port's samplers in the same
    order; bn0 stays in eval mode."""
    model, params, jcfg = _pair("Cnn6", "None")
    batch, jbatch = _inputs(False)
    key = jax.random.PRNGKey(11)
    want = j_pann.pann_apply(params["audio_branch"], jbatch, jcfg.audio, train=True, rng=key)
    frames = jcfg.audio.frontend_config.num_frames(fx.PANN_CLIP)
    rng, spec = _jax_spec_draws(key, 2, frames, 64)
    masks = []

    def sample_dropout(generator, shape, rate, device=None):
        nonlocal rng
        shape = tuple(shape)
        if len(shape) == 4:  # NCHW -> the JAX package's NHWC draw
            nhwc = (shape[0], shape[2], shape[3], shape[1])
        else:
            nhwc = shape
        if len(masks) < 5:
            rng, drng = jax.random.split(rng)
        else:
            drng = rng
        m = np.array(jax.random.bernoulli(drng, 1 - rate, nhwc))
        if len(shape) == 4:
            m = m.transpose(0, 3, 1, 2)
        masks.append(m)
        return torch.from_numpy(m)

    monkeypatch.setattr(t_pann, "sample_spec_augment", lambda *a, **k: spec)
    monkeypatch.setattr(t_pann, "sample_dropout", sample_dropout)
    got = t_pann.pann_apply(model.audio_branch, batch, train=True,
                            generator=torch.Generator().manual_seed(0))
    assert len(masks) == 3 + 1 + 2  # blocks 2-4, after the last, clip vector, embedding
    for key_ in KEYS:
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]), err_msg=key_,
                                   **GOLDEN)
    # without a generator nothing random happens: the eval forward
    plain = t_pann.pann_apply(model.audio_branch, batch, train=True)
    assert torch.equal(plain["embedding"], t_pann.pann_apply(model.audio_branch,
                                                              batch)["embedding"])


def test_encode_audio_pann6_matches_jax():
    """``PANN-6``'s config (short clip) through ``encode_audio`` with the
    projection; taps, a ResiDual and split points raise in both packages;
    ``compute_dtype`` leaves a PANN tower in f32."""
    model_cfg = t_factory.get_model_config("PANN-6")
    cfg = t_factory._clap_config(model_cfg, False, "None")
    assert cfg.audio_model_type == "PANN" and cfg.embed_dim == 512
    cfg = t_clap.CLAPConfig(**{**cfg.__dict__, "joint_embed_shape": 32,
                               "audio": t_pann.PANNConfig(**{**cfg.audio.__dict__,
                                                             "clip_samples": fx.PANN_CLIP})})
    model = fx._seeded_model(cfg, 2, "cpu")
    params = fx.jax_audio_params(fx.port_weights(cfg, 2), "PANN")
    jcfg = fx.pann_jax_config("", model_name="Cnn6")
    batch, jbatch = _inputs(False)
    got = t_clap.encode_audio(model, batch)
    want = j_clap.encode_audio(params, jbatch, jcfg)
    for key in ("embedding", "projected", "normalized"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key,
                                   **GOLDEN)
    assert _cos(got["normalized"].numpy(), np.asarray(want["normalized"])) > 0.99999
    amp = t_clap.encode_audio(model, batch, compute_dtype=torch.bfloat16)
    assert torch.equal(amp["normalized"], got["normalized"])
    for kw in (dict(taps=("residual",)), dict(stop_at_layer=1), dict(stop_at_image=True),
               dict(residual={0: {}})):
        with pytest.raises(ValueError, match="HTSAT-only"):
            t_clap.encode_audio(model, batch, **kw)
        with pytest.raises(ValueError, match="HTSAT-only"):
            j_clap.encode_audio(params, jbatch, jcfg, **kw)


@pytest.mark.parametrize("name", ["PANN-6", "PANN-10", "PANN-14", "PANN-14-fmax-18k",
                                  "PANN-14-fmax-8k-20s", "PANN-14-tiny-transformer",
                                  "PANN-14-win-1536"])
def test_create_model_builds_every_pann_config(name):
    """Every PANN config by name, its tower and widths the JAX factory's."""
    from audio_residual_tpu.models import factory as j_factory

    with torch.device("meta"):
        model, cfg, _ = t_factory.create_model(name, device="meta")
    jcfg = j_factory._amodel_to_config(j_factory.get_model_config(name), False, "None")
    for field in ("model_name", "sample_rate", "clip_samples", "n_fft", "hop_size", "mel_bins",
                  "fmin", "fmax", "num_classes", "enable_fusion", "fusion_type"):
        assert getattr(cfg.audio, field) == getattr(jcfg, field), field
    assert isinstance(model.audio_branch, t_pann.PANN)
    assert model.audio_projection[0].in_features == cfg.embed_dim == jcfg.embed_dim


@pytest.mark.parametrize("model_name,fusion_type", [("Cnn6", "aff_1d"), ("Cnn6", "iaff_2d"),
                                                    ("Cnn6", "channel_map"), ("Cnn14", "None")])
def test_state_dict_bridge_round_trips(model_name, fusion_type):
    """The port's ``clap_audio_state_dict`` of the JAX pytree gives back the
    seeded reference-layout weights key for key; the JAX package's own init
    has the same tree."""
    cfg = fx.pann_port_config("", model_name=model_name, enable_fusion=fusion_type != "None",
                              fusion_type=fusion_type)
    sd = fx.port_weights(cfg, 3)
    back = t_convert.clap_audio_state_dict(fx.jax_audio_params(sd, "PANN"))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jcfg = fx.pann_jax_config("", model_name=model_name, enable_fusion=fusion_type != "None",
                              fusion_type=fusion_type)
    init = jax.tree.map(np.shape, j_pann.init_pann_params(jax.random.PRNGKey(0), jcfg.audio))
    assert init == jax.tree.map(np.shape, fx.jax_audio_params(sd, "PANN")["audio_branch"])


def test_checkpoint_loaders_take_pann_and_fusion_keys(tmp_path):
    """A reference-layout file with ``module.`` prefixes, BatchNorm step
    counts and DSP buffers: the audio side of a PANN fusion model, and a
    whole fusion CLAP."""
    from audio_residual_tpu_torch.models.convert import (load_audio_checkpoint,
                                                         load_clap_checkpoint)

    cfg = fx.pann_port_config("", model_name="Cnn6", enable_fusion=True, fusion_type="iaff_2d")
    sd = fx.port_weights(cfg, 5)
    extra = {"audio_branch.bn0.num_batches_tracked": np.zeros((), np.int64),
             "audio_branch.spectrogram_extractor.stft.conv_real.weight": np.zeros((3, 1, 4)),
             "audio_branch.fusion_model.local_att.1.num_batches_tracked": np.zeros((), np.int64)}
    path = tmp_path / "pann.pt"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in {**sd, **extra}.items()}}, path)
    model = t_clap.build_clap_audio(cfg, seed=9, device="cpu")
    load_audio_checkpoint(model, path)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    full = t_clap.CLAPConfig(audio=fx.fusion_port_config("aff_1d").audio,
                             text=fx.port_clap_config("roberta").text,
                             context_length=fx.CLAP_CONTEXT, **fx.CLAP_KW)
    clap = t_clap.build_clap(full, seed=1, device="cpu")
    csd = fx.seeded_state_dict({k: tuple(v.shape) for k, v in clap.state_dict().items()}, 6)
    assert any(".fusion_model.global_att.5." in k for k in csd)
    path = tmp_path / "clap.pt"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in csd.items()}}, path)
    load_clap_checkpoint(clap, path)
    for k, v in clap.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), csd[k], err_msg=k)
