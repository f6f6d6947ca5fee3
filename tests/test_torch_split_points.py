"""The port's split points (``htsat_apply`` / ``encode_audio``:
``stop_at_image``, ``stop_at_layer``, ``start_layer``) on the CPU.

A resume runs the same operations as the uncached forward from the cut on,
so it gives the same bits, golden and AMP (the JAX package's claim,
``audio_residual_tpu/models/htsat.py:716-719``). The split forward matches
the JAX package's at the slice's tolerance, ``atol=2e-3, rtol=1e-3``.
Configs: ``tests/tiny.py`` (depth 1 a layer) and the fixture's depth-(2, 2)
config, so a shifted block runs on either side of the cut; weights through
the converter, inputs from seeded numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.data.featurize import featurize_batch as j_featurize
from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu_torch.data.featurize import featurize_batch as t_featurize
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models.convert import load_jax_params

from . import torch_port_fixture as fx
from .tiny import TINY_CLAP
from .torch_threads import one_cpu_thread  # noqa: F401

CONFIGS = {"tiny": TINY_CLAP, "depth2": fx.jax_config()}
MODES = {"golden": None, "amp": torch.bfloat16}
OUTPUT_KEYS = ("embedding", "clipwise_output", "framewise_output", "fine_grained_embedding",
               "normalized")


@pytest.fixture(scope="module")
def setups():
    """name -> (JAX cfg, JAX params, port model, featurized JAX and port
    batches, ResiDual at layers 0 and 1 as numpy)."""
    out = {}
    for name, cfg in CONFIGS.items():
        params = j_clap.init_clap_params(jax.random.PRNGKey(0), cfg)
        a = cfg.audio
        port_cfg = t_clap.CLAPConfig(
            embed_dim=cfg.embed_dim, joint_embed_shape=cfg.joint_embed_shape,
            audio=t_htsat.HTSATConfig(spec_size=a.spec_size, mel_bins=a.mel_bins,
                                      embed_dim=a.embed_dim, depths=a.depths,
                                      num_heads=a.num_heads, clip_samples=a.clip_samples,
                                      num_classes=a.num_classes))
        model = t_clap.build_clap_audio(port_cfg, device="cpu")
        load_jax_params(model, jax.tree.map(np.asarray, params))
        rng = np.random.default_rng(3)
        wav = (rng.standard_normal((2, a.clip_samples // 2)) * 0.1).astype(np.float32)
        residual = {}
        for layer in (0, 1):
            c = a.embed_dim * 2**layer
            q, _ = np.linalg.qr(rng.standard_normal((c, c)))
            residual[layer] = {"basis": q.astype(np.float32),
                               "mean": (rng.standard_normal(c) * 0.01).astype(np.float32),
                               "lam": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)}
        out[name] = (cfg, params, model, j_featurize(jnp.asarray(wav), a.clip_samples),
                     t_featurize(torch.tensor(wav), a.clip_samples), residual)
    return out


def _t_res(residual):
    return {l: {k: torch.tensor(v) for k, v in r.items()} for l, r in residual.items()}


def _j_res(residual):
    return {l: {k: jnp.asarray(v) for k, v in r.items()} for l, r in residual.items()}


CUTS = {"image": (dict(stop_at_image=True), "image", {}),
        "tokens": (dict(stop_at_layer=1), "tokens", dict(start_layer=1))}


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_resume_is_bit_equal_to_the_uncached_forward(setups, config, mode, cut):
    _, _, model, _, batch, residual = setups[config]
    stop, key, start = CUTS[cut]
    kw = dict(residual=_t_res(residual), compute_dtype=MODES[mode])
    full = t_clap.encode_audio(model, batch, **kw)
    prefix = t_clap.encode_audio(model, batch, **stop, **kw)
    assert list(prefix) == [key]
    resumed = t_clap.encode_audio(model, prefix, **start, **kw)
    for k in OUTPUT_KEYS:
        assert torch.equal(resumed[k], full[k]), k


@pytest.mark.parametrize("cut", list(CUTS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_split_encode_audio_matches_jax(setups, config, cut):
    """The prefix and the resumed outputs against the JAX package's, golden."""
    cfg, params, model, j_batch, t_batch, residual = setups[config]
    stop, key, start = CUTS[cut]
    j_prefix = j_clap.encode_audio(params, j_batch, cfg, residual=_j_res(residual), **stop)
    t_prefix = t_clap.encode_audio(model, t_batch, residual=_t_res(residual), **stop)
    np.testing.assert_allclose(t_prefix[key].numpy(), np.asarray(j_prefix[key]), atol=2e-3,
                               rtol=1e-3)
    j_out = j_clap.encode_audio(params, j_prefix, cfg, residual=_j_res(residual), **start)
    t_out = t_clap.encode_audio(model, t_prefix, residual=_t_res(residual), **start)
    for k in OUTPUT_KEYS:
        np.testing.assert_allclose(t_out[k].numpy(), np.asarray(j_out[k]), atol=2e-3, rtol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_stop_at_image_keeps_the_path_dtype(setups, mode):
    """The image in the dtype the path made it: f32 golden, bf16 under AMP."""
    cfg, _, model, _, batch, _ = setups["tiny"]
    image = t_clap.encode_audio(model, batch, stop_at_image=True,
                                compute_dtype=MODES[mode])["image"]
    assert image.dtype == (MODES[mode] or torch.float32)
    assert tuple(image.shape) == (2, cfg.audio.spec_size, cfg.audio.spec_size, 1)


@pytest.mark.parametrize("batch_key,kw,match", [
    ("image", dict(stop_at_image=True), "stop_at_image needs a waveform input"),
    ("tokens", dict(stop_at_image=True), "stop_at_image needs a waveform input"),
    ("image", dict(start_layer=1), "image input always resumes at layer 0"),
])
def test_split_refusals_match_jax(setups, batch_key, kw, match):
    cfg, params, model, _, _, _ = setups["tiny"]
    with pytest.raises(ValueError, match=match):
        j_clap.encode_audio(params, {batch_key: jnp.zeros((1, 64, 64, 1))}, cfg, **kw)
    with pytest.raises(ValueError, match=match):
        t_clap.encode_audio(model, {batch_key: torch.zeros(1, 64, 64, 1)}, **kw)
