"""Mel fusion in the port held against the JAX package on the CPU: DAF /
AFF / iAFF, the bilinear shrink, the HTK log-mel, the fusion mel stack and
``get_audio_features``, HTSAT with every fusion type (the committed fixture
``tests/data/torch_port_fusion.npz``), the AMP fusion forward,
``CLAPModule(enable_fusion=True)``, and the overlapping patch embedding.

Tolerances: golden forwards the JAX parity suite's (``atol=2e-3,
rtol=1e-3``, embedding cosine > 0.99999); AMP against the JAX package's AMP
forward at the guard's cosine > 0.999; the fusion ops and the resize at
f32 (``atol=1e-5``); log-mels within 2e-3 dB (the FFT against the port's
DFT GEMM). Random draws (chunk starts, crops) are bit-equal from the same
``np.random.default_rng`` seed.
"""

import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.data import featurize as j_feat
from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu.models import htsat as j_htsat
from audio_residual_tpu.ops import frontend as j_fe
from audio_residual_tpu.ops import fusion as j_fusion
from audio_residual_tpu.ops import interpolate as j_interp
from audio_residual_tpu.ops.quantize import quantize_roundtrip as j_quantize
from audio_residual_tpu_torch import module as t_module
from audio_residual_tpu_torch.data import featurize as t_feat
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import factory as t_factory
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.models import pann as t_pann
from audio_residual_tpu_torch.ops import fusion as t_fusion
from audio_residual_tpu_torch.ops import interpolate as t_interp
from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

from . import torch_port_fixture as fx

GOLDEN = dict(atol=2e-3, rtol=1e-3)
AUDIO_CFG = dict(sample_rate=48000, window_size=1024, hop_size=480, mel_bins=64, fmin=50,
                 fmax=14000)
TINY_AUDIO_CFG = {**AUDIO_CFG, "mel_bins": fx.AUDIO_KW["mel_bins"],
                  "clip_samples": fx.AUDIO_KW["clip_samples"]}


def _cos(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))).min())


def _golden_close(got, ref, cos: bool = True) -> None:
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **GOLDEN)
    if cos:
        assert _cos(got, ref) > 0.99999


# -- the fusion ops ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["1D", "2D"])
@pytest.mark.parametrize("op", ["daf", "aff", "iaff"])
def test_fusion_op_matches_jax(rng, op, kind):
    """Seeded weights (BN statistics away from identity) through both
    packages; the port's NCHW / NCW against the JAX package's channels-last."""
    shape = (2, 8, 6, 5) if kind == "2D" else (2, 8, 11)
    x = rng.standard_normal(shape).astype(np.float32)
    y = rng.standard_normal(shape).astype(np.float32)
    module = t_fusion.make_fusion(f"{op}_{kind.lower()}", 8, torch.Generator().manual_seed(0))
    sd = fx.seeded_state_dict({k: tuple(v.shape) for k, v in module.state_dict().items()}, 3)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = module(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    last = lambda a: np.moveaxis(a, 1, -1)  # noqa: E731
    if op == "daf":
        want = j_fusion.daf(jnp.asarray(last(x)), jnp.asarray(last(y)))
    else:
        params = fx.jax_fusion_params({"fusion_model." + k: v for k, v in sd.items()},
                                      "")["fusion_model"]
        want = getattr(j_fusion, op)(params, jnp.asarray(last(x)), jnp.asarray(last(y)),
                                     kind=kind)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 1), atol=1e-5, rtol=1e-5)


def test_fusion_module_keys_are_the_reference_layout():
    m = t_fusion.make_fusion("iaff_2d", 8, torch.Generator().manual_seed(0))
    keys = {k.rsplit(".", 1)[0] for k in m.state_dict()}
    assert keys == {f"{b}.{i}" for b in ("local_att", "local_att2") for i in (0, 1, 3, 4)} | {
        f"{b}.{i}" for b in ("global_att", "global_att2") for i in (1, 2, 4, 5)}
    with pytest.raises(ValueError, match="fusion_type"):
        t_fusion.make_fusion("sum_2d", 8, torch.Generator())
    for cls, cfg in ((t_htsat.HTSAT, t_htsat.HTSATConfig(**fx.AUDIO_KW, enable_fusion=True,
                                                          fusion_type="sum_2d")),
                     (t_pann.PANN, t_pann.PANNConfig(model_name="Cnn6", enable_fusion=True,
                                                     fusion_type="sum_2d"))):
        with pytest.raises(ValueError, match="fusion_type"):
            cls(cfg)
    assert t_htsat.HTSATConfig(enable_fusion=True).fusion is None  # fusion_type "None"


@pytest.mark.parametrize("n_in,n_out", [(1001, 1001), (3001, 1001), (701, 1001), (64, 64),
                                        (17, 5), (5, 17)])
@pytest.mark.parametrize("antialias", [True, False])
def test_bilinear_matrix_matches_jax(n_in, n_out, antialias):
    np.testing.assert_array_equal(t_interp.bilinear_matrix(n_in, n_out, antialias),
                                  j_interp.bilinear_matrix(n_in, n_out, antialias))


def test_resize_bilinear_antialias_matches_jax(rng):
    x = rng.standard_normal((2, 301, 64)).astype(np.float32)
    got = t_interp.resize_bilinear_antialias(torch.from_numpy(x), 101, 32).numpy()
    want = np.asarray(j_interp.resize_bilinear_antialias(jnp.asarray(x), 101, 32))
    np.testing.assert_allclose(got, want, atol=1e-5)


# -- the fusion mel ------------------------------------------------------------


def test_htk_filterbank_matches_jax():
    cfg = t_feat.fusion_frontend_config(AUDIO_CFG)
    assert (cfg.mel_scale, cfg.mel_norm) == ("htk", None)
    np.testing.assert_allclose(t_feat.frontend.mel_filterbank(cfg),
                               j_fe.mel_filterbank(j_feat._fusion_frontend_cfg(AUDIO_CFG)),
                               rtol=1e-6, atol=1e-7)


def test_get_mel_matches_jax(rng):
    audio = (rng.standard_normal(30000) * 0.1).astype(np.float32)
    got = t_feat.get_mel(audio, AUDIO_CFG, device="cpu")
    want = np.asarray(j_feat.get_mel(jnp.asarray(audio), AUDIO_CFG))
    assert got.shape == want.shape == (30000 // 480 + 1, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def _chunk_starts(seed: int, total: int, chunk: int) -> list[int]:
    rng = np.random.default_rng(seed)
    ranges = np.array_split(list(range(0, total - chunk + 1)), 3)
    ranges = [r if len(r) else np.array([0]) for r in ranges]
    return [int(rng.choice(r)) for r in ranges]


@pytest.mark.parametrize("n", [24000 + 9600, 24000 * 4 + 77])
def test_fusion_mel_matches_jax(rng, n):
    """Same chunk starts from the same seed (each chunk a bit-equal slice of
    its package's mel at the replayed starts; the generators left in the same
    state), values within the log-mel tolerance."""
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    max_len = 24000
    g_t, g_j = np.random.default_rng(5), np.random.default_rng(5)
    got, longer = t_feat.fusion_mel(audio, max_len, AUDIO_CFG, g_t, device="cpu")
    want, j_longer = j_feat.fusion_mel(audio, max_len, AUDIO_CFG, g_j)
    assert longer is j_longer is True
    assert got.shape == want.shape == (4, max_len // 480 + 1, 64)
    mel_t = t_feat.get_mel(audio, AUDIO_CFG, device="cpu")
    mel_j = np.asarray(j_feat.get_mel(jnp.asarray(audio), AUDIO_CFG))
    chunk = max_len // 480 + 1
    for k, s in enumerate(_chunk_starts(5, mel_t.shape[0], chunk)):
        assert torch.equal(got[k + 1], mel_t[s: s + chunk]), k
        np.testing.assert_array_equal(want[k + 1], mel_j[s: s + chunk], err_msg=str(k))
    assert g_t.integers(0, 1 << 30) == g_j.integers(0, 1 << 30)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


@pytest.mark.parametrize("n", [24000 * 3 + 5, 24000, 9000, 24100])
@pytest.mark.parametrize("truncating", ["fusion", "rand_trunc"])
def test_get_audio_features_matches_jax(rng, n, truncating):
    """Long (crop and chunks), exact, short (repeat-pad, the mel 4x) and just
    over (one frame more: the whole mel 4x, ``longer`` False) clips:
    waveform and ``longer`` bit-equal, ``mel_fusion`` within the log-mel
    tolerance."""
    audio = (rng.standard_normal(n) * 0.1).astype(np.float32)
    got = t_feat.get_audio_features({}, audio, 24000, truncating, "repeatpad", AUDIO_CFG,
                                    np.random.default_rng(2), device="cpu")
    want = j_feat.get_audio_features({}, audio, 24000, truncating, "repeatpad", AUDIO_CFG,
                                     np.random.default_rng(2))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["waveform"], want["waveform"])
    assert got["longer"] == want["longer"]
    if truncating == "fusion":
        mel = got["mel_fusion"]
        assert isinstance(mel, torch.Tensor)
        np.testing.assert_allclose(mel.numpy(), want["mel_fusion"], atol=2e-3)
        if n <= 24000:
            assert all(torch.equal(mel[0], mel[i]) for i in (1, 2, 3))


def test_get_mel_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_feat.get_mel(np.zeros(4800, np.float32), AUDIO_CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_feat.get_audio_features({}, np.zeros(4800, np.float32), 24000, "fusion",
                                  audio_cfg=AUDIO_CFG)


# -- HTSAT with fusion ---------------------------------------------------------


@pytest.fixture(scope="module")
def fresh():
    return fx.build_fusion()


@pytest.fixture(scope="module")
def port_out(fresh):
    return fx.run_port_fusion(fresh, "cpu")


def test_committed_fusion_fixture_is_current(fresh):
    committed = fx.load(fx.FUSION_PATH)
    assert set(committed) == set(fresh)
    assert str(committed["config"]) == str(fresh["config"])
    for k in fresh:
        if k.startswith("out/"):
            np.testing.assert_allclose(committed[k], fresh[k], rtol=1e-5, atol=1e-6, err_msg=k)
        elif k != "config":
            np.testing.assert_array_equal(committed[k], fresh[k], err_msg=k)
    assert fx.FUSION_PATH.stat().st_size < 1 << 20


@pytest.mark.parametrize("fusion_type", fx.FUSION_TYPES)
def test_htsat_fusion_matches_jax(fresh, port_out, fusion_type):
    """Every fusion type on a batch with ``longer`` both ways, golden."""
    for key in fx.FUSION_OUTPUT_KEYS:
        _golden_close(port_out[fusion_type][key], fresh[f"out/{fusion_type}/{key}"],
                      cos=key != "clipwise_output")


@pytest.mark.parametrize("fusion_type", ["aff_1d", "iaff_2d", "channel_map"])
def test_htsat_fusion_amp_matches_jax_amp(fresh, fusion_type):
    """The AMP fusion forward (cast after bn0, fusion internals f32) against
    the JAX package's ``compute_dtype=bfloat16``: the guard's cosine."""
    got = fx.run_port_fusion(fresh, "cpu", compute_dtype=torch.bfloat16)[fusion_type]
    params = fx.jax_audio_params(fx.port_weights(fx.fusion_port_config(fusion_type),
                                                 fx.FUSION_SEED), "HTSAT", fx.AUDIO_KW["depths"])
    batch = {k: jnp.asarray(fresh[k]) for k in ("mel_fusion", "longer")}
    want = j_clap.encode_audio(params, batch, fx.fusion_jax_config(fusion_type),
                               compute_dtype=jnp.bfloat16)
    assert _cos(got["normalized"], np.asarray(want["normalized"], np.float32)) > 0.999
    assert _cos(got["embedding"], fresh[f"out/{fusion_type}/embedding"]) > 0.999


def test_shorter_clips_keep_the_global_channel():
    """Where ``longer`` is False the local channels are not read."""
    model = fx._seeded_model(fx.fusion_port_config("aff_2d"), 0, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in fx.fusion_inputs(1, 16, 51).items()}
    batch["longer"] = torch.tensor([False, False])
    trashed = {**batch, "mel_fusion": batch["mel_fusion"].clone()}
    trashed["mel_fusion"][:, 1:] = 999.0
    a, b = (t_clap.encode_audio(model, x)["embedding"] for x in (batch, trashed))
    assert torch.equal(a, b)
    batch["longer"] = trashed["longer"] = torch.tensor([True, True])
    a, b = (t_clap.encode_audio(model, x)["embedding"] for x in (batch, trashed))
    assert (a - b).abs().max() > 1e-4


@pytest.mark.parametrize("fusion_type", ["aff_2d", "channel_map"])
def test_jax_htsat_cannot_embed_a_waveform_with_2d_fusion(fusion_type):
    """The JAX package's ``CLAPModule`` sends a fusion model the waveform
    alone (``module.py:123-129``): a 2-D fusion model breaks on it (a
    reshape for ``aff_2d``, the CLAPModule default; a broadcast for
    ``channel_map``). The port raises a ValueError that names the input it
    needs."""
    cfg = j_htsat.HTSATConfig(**fx.AUDIO_KW, enable_fusion=True, fusion_type=fusion_type)
    params = j_htsat.init_htsat_params(jax.random.PRNGKey(0), cfg)
    wav = jnp.zeros((2, fx.AUDIO_KW["clip_samples"]))
    with pytest.raises((TypeError, ValueError)):
        j_htsat.htsat_apply(params, {"waveform": wav}, cfg)
    model = fx._seeded_model(fx.fusion_port_config(fusion_type), 0, "cpu")
    with pytest.raises(ValueError, match="mel_fusion"):
        t_clap.encode_audio(model, {"waveform": torch.zeros(2, fx.AUDIO_KW["clip_samples"])})


def test_non_fusion_model_takes_the_global_channel(fresh):
    """A model without fusion given the fusion input embeds channel 0, as
    the JAX package does."""
    model = fx._seeded_model(t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW),
                                               **fx.CLAP_KW), 0, "cpu")
    mel = torch.from_numpy(fresh["mel_fusion"])
    a = t_clap.encode_audio(model, {"mel_fusion": mel, "longer": torch.tensor([True, False])})
    b = t_clap.encode_audio(model, {"mel_fusion": mel[:, :1].repeat(1, 4, 1, 1)})
    assert torch.equal(a["embedding"], b["embedding"])


# -- the fusion CLAPModule -----------------------------------------------------


def _tiny_fusion_module():
    """``(CLAPModule(enable_fusion=True, seed=3), port weights)`` at the
    fixture's tiny aff_2d widths on the CPU."""
    cfg = fx.fusion_port_config("aff_2d")
    full = t_clap.CLAPConfig(audio=cfg.audio, text=fx.port_clap_config("roberta").text,
                             context_length=fx.CLAP_CONTEXT, **fx.CLAP_KW)
    model = t_clap.build_clap(full, device="cpu")
    sd = fx.port_weights(cfg, 4)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    model_cfg = {"audio_cfg": TINY_AUDIO_CFG}
    with mock.patch.object(t_factory, "create_model",
                           lambda *a, **k: (model, full, model_cfg)):
        module = t_module.CLAPModule(enable_fusion=True, seed=3, device="cpu",
                                     tokenizer=HashTokenizer(vocab_size=1000, context_length=16))
    return module, sd


def _jax_fusion_embedding(sd, clips) -> np.ndarray:
    """The JAX package's ``encode_audio`` on the ``mel_fusion`` its own
    ``get_audio_features`` builds from the clips with seed 3 (a clip is
    ``longer`` when it has more than 24000 samples)."""
    g = np.random.default_rng(3)
    feats = [j_feat.get_audio_features({}, c, 24000, "fusion", "repeatpad", TINY_AUDIO_CFG, g)
             for c in clips]
    assert [f["longer"] for f in feats] == [len(c) > 24000 for c in clips]
    batch = {"mel_fusion": jnp.asarray(np.stack([f["mel_fusion"] for f in feats])),
             "longer": jnp.asarray([f["longer"] for f in feats])}
    return np.asarray(j_clap.encode_audio(fx.jax_audio_params(sd, "HTSAT", fx.AUDIO_KW["depths"]),
                                          batch, fx.fusion_jax_config("aff_2d"))["normalized"])


def test_fusion_module_matches_jax_encode_audio(rng):
    """``CLAPModule(enable_fusion=True)`` (aff_2d) embeds through each clip's
    ``mel_fusion``: one long clip (chunks), one short (the mel 4x); against
    the JAX package's ``encode_audio`` on the ``mel_fusion`` its own
    ``get_audio_features`` builds from the same seed, after the same int16
    round trip."""
    module, sd = _tiny_fusion_module()
    clips = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (60000, 10000)]
    got = module.get_audio_embedding_from_data(clips)
    want = _jax_fusion_embedding(sd, [np.asarray(j_quantize(jnp.asarray(c))) for c in clips])
    _golden_close(got, want)


@pytest.mark.parametrize("form", ["list", "rows"])
def test_fusion_module_takes_tensors(rng, form):
    """``use_tensor=True`` on tensors (a list of clips of any lengths, or the
    rows of one ``[N, T]`` tensor): a tensor out, no int16 round trip,
    against the JAX package on the same clips."""
    module, sd = _tiny_fusion_module()
    if form == "list":
        x = [torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
             for n in (60000, 10000)]
    else:
        x = torch.from_numpy((rng.standard_normal((2, 30000)) * 0.1).astype(np.float32))
    got = module.get_audio_embedding_from_data(x, use_tensor=True)
    assert isinstance(got, torch.Tensor)
    want = _jax_fusion_embedding(sd, [c.numpy() for c in x])
    _golden_close(got.detach().numpy(), want)


# -- the overlapping patch embedding -------------------------------------------


def test_overlapping_patch_embed_matches_jax(rng):
    """``patch_stride=(2, 2)`` with 4x4 patches: the padded strided conv
    (the JAX package's ``conv_general_dilated`` path)."""
    kw = {**fx.AUDIO_KW, "patch_stride": (2, 2)}
    cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**kw), **fx.CLAP_KW)
    sd = fx.port_weights(cfg, 6)
    model = fx._seeded_model(cfg, 6, "cpu")
    wav = (rng.standard_normal((2, kw["clip_samples"])) * 0.1).astype(np.float32)
    got = t_clap.encode_audio(model, {"waveform": torch.from_numpy(wav)})
    jcfg = j_clap.CLAPConfig(audio=j_htsat.HTSATConfig(**kw), text=fx.jax_config().text,
                             **fx.CLAP_KW)
    f = jax.jit(functools.partial(j_clap.encode_audio, cfg=jcfg))
    want = f(fx.jax_audio_params(sd, "HTSAT", kw["depths"]), {"waveform": jnp.asarray(wav)})
    for key in ("embedding", "normalized", "clipwise_output"):
        _golden_close(got[key].numpy(), np.asarray(want[key]), cos=key != "clipwise_output")
