"""The port's training forward held against the JAX package on the CPU:
SpecAugment and drop-path on the JAX package's own draws, the samplers'
ranges, bn0's batch statistics, and HTSAT and ``clap_apply`` with
``train=True`` and no generator against JAX's ``rng=None`` (batch statistics,
nothing random) at drop-path rates 0 and 0.1.

Tolerances: the mask arithmetic exactly (the same f32 operations on the
same draws); bn0 ``rtol=1e-5, atol=1e-6`` (the same f32 sums in another
order); the forwards, golden f32, ``atol=1e-4, rtol=1e-3`` with the
embedding's cosine > 0.99999; AMP against JAX's AMP, cosine > 0.9999 (the
JAX package's plain CPU path rounds other intermediates to bf16 than the
port's kernels' plain versions).
"""

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu.models import htsat as j_htsat
from audio_residual_tpu.ops import frontend as j_fe
from audio_residual_tpu.ops import spec_augment as j_sa
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models.convert import load_jax_params
from audio_residual_tpu_torch.ops import frontend as t_fe
from audio_residual_tpu_torch.ops import spec_augment as t_sa

from . import torch_port_fixture as fx

F32 = dict(atol=1e-4, rtol=1e-3)
HTSAT_KEYS = ("embedding", "clipwise_output", "framewise_output", "fine_grained_embedding")


def _jax_stripes(key, b, dim, drop_width, stripes_num):
    """The widths and starts ``j_sa.drop_stripes`` draws from ``key``."""
    k1, k2 = jax.random.split(key)
    widths = jax.random.randint(k1, (b, stripes_num), 0, drop_width)
    starts = jax.random.randint(k2, (b, stripes_num), 0, jnp.maximum(dim - widths, 1))
    return torch.from_numpy(np.array(widths)).long(), torch.from_numpy(np.array(starts)).long()


@pytest.mark.parametrize("axis,drop_width", [(1, 64), (2, 8), (1, 3)])
def test_drop_stripes_on_jax_draws_exactly(rng, axis, drop_width):
    x = rng.standard_normal((6, 101, 16)).astype(np.float32)
    key = jax.random.PRNGKey(axis * 10 + drop_width)
    ref = np.asarray(j_sa.drop_stripes(key, jnp.asarray(x), axis, drop_width, 2))
    widths, starts = _jax_stripes(key, 6, x.shape[axis], drop_width, 2)
    got = t_sa.drop_stripes(torch.from_numpy(x), axis, widths, starts).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == 0).any()


def test_spec_augment_on_jax_draws_exactly(rng):
    x = rng.standard_normal((4, 201, 64)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(j_sa.spec_augment(key, jnp.asarray(x)))
    k1, k2 = jax.random.split(key)
    time = _jax_stripes(k1, 4, 201, 64, 2)
    freq = _jax_stripes(k2, 4, 64, 8, 2)
    got = t_sa.spec_augment(torch.from_numpy(x), time, freq).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_on_jax_mask_exactly(rng, rate):
    x = rng.standard_normal((16, 12, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(j_htsat._drop_path(jnp.asarray(x), rate, True, key))
    u = jax.random.uniform(key, (16, 1, 1), jnp.float32)
    mask = torch.from_numpy(np.array(jnp.floor(1.0 - rate + u))).reshape(16)
    got = t_htsat.drop_path(torch.from_numpy(x), mask, rate).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(t_htsat.drop_path(torch.from_numpy(x), None, rate).numpy(), x)


@pytest.mark.parametrize("dim,drop_width", [(101, 64), (16, 8), (5, 8), (1001, 64)])
def test_stripe_sampler_ranges_match_jax_bounds(dim, drop_width):
    """Every draw inside JAX's bounds (width in [0, drop_width), start in
    [0, max(dim - width, 1))), and both ends of each range reached."""
    gen = torch.Generator().manual_seed(dim)
    widths, starts = t_sa.sample_stripes(gen, 4000, dim, drop_width, 2)
    jw, js = _jax_stripes(jax.random.PRNGKey(dim), 4000, dim, drop_width, 2)
    for w, s in ((widths, starts), (jw, js)):
        high = torch.clamp(dim - w, min=1)
        assert int(w.min()) == 0 and int(w.max()) == drop_width - 1
        assert bool((s >= 0).all() and (s < high).all())
        assert bool((s == high - 1).any()) and bool((s == 0).any())


def test_drop_path_sampler_keeps_one_minus_rate():
    gen = torch.Generator().manual_seed(0)
    mask = t_htsat.sample_drop_path(gen, 20000, 0.25)
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    assert abs(float(mask.mean()) - 0.75) < 0.02
    ju = jax.random.uniform(jax.random.PRNGKey(0), (20000,))
    assert abs(float(jnp.floor(0.75 + ju).mean()) - 0.75) < 0.02


def test_spec_augment_sampler_shapes_and_determinism():
    a = t_sa.sample_spec_augment(torch.Generator().manual_seed(1), (3, 100, 16))
    b = t_sa.sample_spec_augment(torch.Generator().manual_seed(1), (3, 100, 16))
    for (wa, sa), (wb, sb) in zip(a, b):
        assert wa.shape == sa.shape == (3, 2)
        assert torch.equal(wa, wb) and torch.equal(sa, sb)


def test_bn0_batch_statistics_match_jax(rng):
    x = (rng.standard_normal((3, 50, 16)) * 2 + 1).astype(np.float32)
    p = {k: rng.standard_normal(16).astype(np.float32) for k in ("scale", "bias", "mean")}
    p["var"] = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    y_ref, state = j_fe.batch_norm_mel(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                       train=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    y, mean, var = t_fe.batch_norm_mel_train(torch.from_numpy(x), t["scale"], t["bias"],
                                             t["mean"], t["var"])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(state["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(state["var"]), rtol=1e-5, atol=1e-6)
    # AMP input: the statistics stay f32
    y16, mean16, _ = t_fe.batch_norm_mel_train(torch.from_numpy(x).bfloat16(), t["scale"],
                                               t["bias"], t["mean"], t["var"])
    assert y16.dtype == mean16.dtype == torch.float32


def _audio_pair(rate: float, seed: int = 0):
    """A JAX CLAP config and params (bn0's running statistics perturbed) at
    drop-path ``rate``, and the port's model holding the same weights."""
    jcfg = fx.jax_clap_config("roberta")
    jcfg = dataclasses.replace(jcfg, audio=dataclasses.replace(jcfg.audio, drop_path_rate=rate))
    params = jax.tree.map(np.asarray, j_clap.init_clap_params(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)
    bn0 = params["audio_branch"]["bn0"]
    bn0["mean"] = r.standard_normal(bn0["mean"].shape).astype(np.float32)
    bn0["var"] = r.uniform(0.5, 2.0, bn0["var"].shape).astype(np.float32)
    tcfg = fx.port_clap_config("roberta")
    tcfg = dataclasses.replace(tcfg, audio=dataclasses.replace(tcfg.audio, drop_path_rate=rate))
    model = load_jax_params(t_clap.build_clap(tcfg, device="cpu"), params)
    return jcfg, params, model


def _wav(seed: int = 2, b: int = 3):
    r = np.random.default_rng(seed)
    return (0.1 * r.standard_normal((b, fx.AUDIO_KW["clip_samples"]))).astype(np.float32)


def _cos(a, b):
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_htsat_train_without_generator_matches_jax_rng_none(rate):
    jcfg, params, model = _audio_pair(rate)
    wav = _wav()
    ref = j_htsat.htsat_apply(params["audio_branch"], {"waveform": jnp.asarray(wav)}, jcfg.audio,
                              train=True, rng=None)
    got = t_htsat.htsat_apply(model.audio_branch, {"waveform": torch.from_numpy(wav)},
                              train=True)
    for key in HTSAT_KEYS:
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **F32)
    assert _cos(got["embedding"].detach().numpy(), np.asarray(ref["embedding"])).min() > 0.99999
    for k in ("mean", "var"):
        np.testing.assert_allclose(got["bn0_state"][k].numpy(), np.asarray(ref["bn0_state"][k]),
                                   rtol=1e-5, atol=1e-6)
    # batch statistics change the forward: eval differs from train
    ev = t_htsat.htsat_apply(model.audio_branch, torch.from_numpy(wav))
    assert "bn0_state" not in ev
    assert not np.allclose(ev["embedding"].numpy(), got["embedding"].detach().numpy(), atol=1e-3)


def test_htsat_amp_train_matches_jax_amp():
    jcfg, params, model = _audio_pair(0.1)
    wav = _wav()
    ref = j_htsat.htsat_apply(params["audio_branch"], {"waveform": jnp.asarray(wav)}, jcfg.audio,
                              train=True, rng=None, compute_dtype=jnp.bfloat16)
    got = t_htsat.htsat_apply(model.audio_branch, torch.from_numpy(wav), train=True,
                              compute_dtype=torch.bfloat16)
    cos = _cos(got["embedding"].float().numpy(), np.asarray(ref["embedding"], np.float32))
    assert cos.min() > 0.9999


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_clap_apply_train_without_generator_matches_jax_rng_none(rate):
    jcfg, params, model = _audio_pair(rate, seed=1)
    wav = _wav(3)
    text = fx.text_inputs("roberta", batch=3)
    ref = j_clap.clap_apply(params, {"waveform": jnp.asarray(wav)},
                            jnp.asarray(text["input_ids"]), jnp.asarray(text["attention_mask"]),
                            jcfg, train=True, rng=None)
    got = t_clap.clap_apply(model, {"waveform": torch.from_numpy(wav)}, text["input_ids"],
                            text["attention_mask"], train=True)
    for key in fx.CLAP_APPLY_KEYS:
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(ref[key]),
                                   err_msg=key, **F32)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got["bn0_state"][k].numpy(), np.asarray(ref["bn0_state"][k]),
                                   rtol=1e-5, atol=1e-6)


def test_train_generator_draws_masks_and_is_reproducible():
    """With a generator the forward is random (SpecAugment, drop-path, the
    transform dropout) and the same seed gives the same bits."""
    _, _, model = _audio_pair(0.5)
    wav = torch.from_numpy(_wav())
    text = fx.text_inputs("roberta", batch=3)

    def run(seed):
        return t_clap.clap_apply(model, wav, text["input_ids"], text["attention_mask"],
                                 train=True, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    det = t_clap.clap_apply(model, wav, text["input_ids"], text["attention_mask"], train=True)
    for key in ("audio_features", "audio_features_mlp", "text_features_mlp"):
        assert torch.equal(a[key], b[key]), key
        assert not torch.allclose(a[key], c[key]), key
        assert not torch.allclose(a[key], det[key]), key
    # the text tower has no train mode (the JAX package's neither)
    assert torch.equal(a["text_features"], det["text_features"])


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_train_routing_follows_jax_dispatch(rate):
    """The kernel wrappers a training forward calls, counted on the CPU
    through mocks: K4 only where ``not (train and dpr > 0)``, K2 in every
    other block, K3 only in the split plan of a dpr = 0 block; the counts
    :func:`torch_port_fixture.expected_launches` gives."""
    _, _, model = _audio_pair(rate)
    calls = {}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    from audio_residual_tpu_torch.ops.cuda import swin_block as k4

    with mock.patch.object(t_htsat, "fused_logmel", counting("fused_logmel", t_htsat.fused_logmel)), \
            mock.patch.object(t_htsat, "fused_swin_block",
                              counting("fused_swin_block", t_htsat.fused_swin_block)), \
            mock.patch.object(t_htsat, "fused_window_attention",
                              counting("fused_window_attention", t_htsat.fused_window_attention)), \
            mock.patch.object(k4, "fused_window_attention",
                              counting("fused_window_attention", k4.fused_window_attention)), \
            mock.patch.object(k4, "fused_residual_ffn",
                              counting("fused_residual_ffn", k4.fused_residual_ffn)):
        t_htsat.htsat_apply(model.audio_branch, torch.from_numpy(_wav()), train=True)
    want = fx.expected_launches(model.cfg.audio, train=True)
    assert calls == {k: v for k, v in want.items() if v}
    if rate == 0.0:
        assert calls == {k: v for k, v in fx.expected_launches(model.cfg.audio).items() if v}


def test_expected_launches_of_the_card_configs():
    tiny = t_htsat.HTSATConfig()
    assert fx.expected_launches(tiny, train=True) == {
        "fused_logmel": 1, "fused_swin_block": 1, "fused_window_attention": 11,
        "fused_residual_ffn": 0, "wide_window_attention": 0}
    assert fx.expected_launches(tiny) == {
        "fused_logmel": 1, "fused_swin_block": 10, "fused_window_attention": 2,
        "fused_residual_ffn": 2, "wide_window_attention": 0}
    base = t_htsat.HTSATConfig(**t_htsat.HTSAT_VARIANTS["base"])
    assert fx.expected_launches(base, train=True) == {
        "fused_logmel": 1, "fused_swin_block": 1, "fused_window_attention": 15,
        "fused_residual_ffn": 0, "wide_window_attention": 2}


def test_train_forward_refuses_taps():
    _, _, model = _audio_pair(0.1)
    with pytest.raises(ValueError, match="taps"):
        t_htsat.htsat_apply(model.audio_branch, torch.from_numpy(_wav()), train=True,
                            taps=("residual",))
