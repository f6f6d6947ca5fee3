"""The port's representation taps (``encode_audio(..., taps=...)``) held
against the JAX package on the CPU.

Config: the depth-(2, 2) fixture config (``tests/torch_port_fixture.py``:
layer 0 has four windows a clip and a shifted block, layer 1 one window),
weights through the converter, inputs from seeded numpy, with and without
a layer-0 ResiDual. Tolerances, golden: the residual taps and the
embedding at the slice's ``atol=2e-3, rtol=1e-3``, the attention
probabilities at ``atol=1e-5``. Under AMP the attention's products run
in ``compute_dtype`` and the taps come out f32, as the JAX package's (the
residual tap carries the bf16 store of the attention output where the
block input is bf16, where the JAX package's is f32); they are held to its
AMP taps by cosine (> 0.999, the bench guard's bound).
Taps change the routing, not the function: on the CPU the tapped forward
gives the untapped one's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_residual_tpu.data.featurize import featurize_batch as j_featurize
from audio_residual_tpu.models import clap as j_clap
from audio_residual_tpu_torch.data.featurize import featurize_batch as t_featurize
from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.ops.cuda import swin_block as t_k4

from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

TAPS = {"residual": ("residual",), "attention": ("attention",),
        "both": ("attention", "residual")}
TAP_KEYS = {"attention": "layers_attention", "residual": "layers_residuals"}
OUTPUT_KEYS = ("embedding", "clipwise_output", "framewise_output", "fine_grained_embedding",
               "normalized")


@pytest.fixture(scope="module")
def setup():
    """(JAX params, port model, JAX and port batches, ResiDual for both)."""
    model, res = fx._port_with_residual(fx.load(), "cpu")
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((2, fx.AUDIO_KW["clip_samples"] // 2)) * 0.1).astype(np.float32)
    max_len = fx.AUDIO_KW["clip_samples"]
    j_res = {0: {k: jnp.asarray(v.numpy()) for k, v in res.items()}}
    return (fx.jax_params(), model, j_featurize(jnp.asarray(wav), max_len),
            t_featurize(torch.tensor(wav), max_len), j_res, {0: res})


@pytest.fixture(scope="module")
def jax_taps(setup):
    """The JAX package's both-tap outputs, golden and AMP, with and without
    the ResiDual."""
    params, _, jb, _, j_res, _ = setup
    return {(res, amp): j_clap.encode_audio(
        params, jb, fx.jax_config(), taps=TAPS["both"], residual=j_res if res else None,
        compute_dtype=jnp.bfloat16 if amp else None)
        for res in (False, True) for amp in (False, True)}


def _port(setup, taps, res, compute_dtype=None):
    _, model, _, tb, _, t_res = setup
    with torch.no_grad():
        return t_clap.encode_audio(model, tb, taps=taps, residual=t_res if res else None,
                                   compute_dtype=compute_dtype)


@pytest.mark.parametrize("res", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("which", list(TAPS))
def test_taps_match_jax(setup, jax_taps, which, res):
    out = _port(setup, TAPS[which], res)
    ref = jax_taps[(res, False)]
    assert set(k for k in out if k.startswith("layers_")) == {TAP_KEYS[t] for t in TAPS[which]}
    for tap in TAPS[which]:
        key = TAP_KEYS[tap]
        assert len(out[key]) == len(ref[key]) == len(fx.AUDIO_KW["depths"])
        for i, (got, want) in enumerate(zip(out[key], ref[key])):
            assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, (key, i)
            tol = dict(atol=1e-5, rtol=0) if tap == "attention" else dict(atol=2e-3, rtol=1e-3)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                       err_msg=f"{key}[{i}]")
    np.testing.assert_allclose(out["embedding"].numpy(), np.asarray(ref["embedding"]),
                               atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("res", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("which", list(TAPS))
def test_tapped_forward_gives_the_untapped_outputs(setup, which, res):
    tapped = _port(setup, TAPS[which], res)
    plain = _port(setup, (), res)
    assert not any(k.startswith("layers_") for k in plain)
    for key in OUTPUT_KEYS:
        assert torch.equal(tapped[key], plain[key]), key


@pytest.mark.parametrize("which", list(TAPS))
def test_taps_route_around_k4_and_the_attention_tap_around_k2(setup, which, monkeypatch):
    """No block runs K4 under any tap; the attention tap runs no K2; every
    block runs K3 once."""
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} called under taps={TAPS[which]}")
        return f

    monkeypatch.setattr(t_htsat, "fused_swin_block", refuse("fused_swin_block"))
    if "attention" in TAPS[which]:
        monkeypatch.setattr(t_k4, "fused_window_attention", refuse("fused_window_attention"))
    calls = []
    k3 = t_k4.fused_residual_ffn
    monkeypatch.setattr(t_k4, "fused_residual_ffn",
                        lambda *a, **k: calls.append(1) or k3(*a, **k))
    out = _port(setup, TAPS[which], True)
    assert len(calls) == sum(fx.AUDIO_KW["depths"])
    assert all(k in out for k in (TAP_KEYS[t] for t in TAPS[which]))


@pytest.mark.parametrize("res", [False, True], ids=["plain", "residual"])
def test_amp_taps_match_jax(setup, jax_taps, res):
    out = _port(setup, TAPS["both"], res, torch.bfloat16)
    ref = jax_taps[(res, True)]
    for key in TAP_KEYS.values():
        for i, (got, want) in enumerate(zip(out[key], ref[key])):
            assert got.dtype == torch.float32 and str(want.dtype) == "float32", (key, i)
            a, b = got.numpy().ravel(), np.asarray(want).ravel()
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 0.999, (key, i, cos)


def test_unknown_tap_raises(setup):
    with pytest.raises(ValueError, match="unknown taps"):
        _port(setup, ("residuals",), False)


def test_taps_stop_with_the_prefix(setup):
    """A forward cut at ``stop_at_layer`` returns the tokens only, taps or
    not, as the JAX package does."""
    _, model, _, tb, _, _ = setup
    with torch.no_grad():
        cut = t_clap.encode_audio(model, tb, taps=TAPS["both"], stop_at_layer=1)
        plain = t_clap.encode_audio(model, tb, stop_at_layer=1)
    assert list(cut) == ["tokens"]
    assert torch.equal(cut["tokens"], plain["tokens"])
