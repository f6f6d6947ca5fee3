"""K5 (``wide_window_attention``) held against the JAX package's weight-streaming
``_wide_attention``, its routing, and the wide fixture.

On the CPU the wrapper runs its plain version; the JAX kernel runs in Pallas
interpret mode, patched as ``tests/test_pallas.py`` does. At C >= 1024 the
JAX ``fused_window_attention`` finds no standard plan (``pick_group`` is
None) and takes ``_wide_attention``. Tolerances are the JAX suite's at these
widths: ``atol=2e-4, rtol=1e-3`` (``test_pallas.py:357``) and, for AMP
against f32, relative error < 3e-2 (``test_pallas.py:592``).

The kernel against its plain version on the card is in
``tests/test_torch_cuda.py``.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audio_residual_tpu.models import htsat as j_htsat
from audio_residual_tpu.ops.pallas import swin_block as j_k4
from audio_residual_tpu.ops.pallas import window_attention as j_fwa
from audio_residual_tpu_torch.ops.cuda import swin_block as t_k4
from audio_residual_tpu_torch.ops.cuda import wide_attention as t_k5
from audio_residual_tpu_torch.ops.cuda import window_attention as t_k2

from . import torch_port_fixture as fx

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
TOL = dict(atol=2e-4, rtol=1e-3)
C = 1024


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _attention_params(rng, c, nh):
    """JAX-layout (``[in, out]``) attention weights as numpy."""
    n = lambda *s, sc: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return {"wqkv": n(c, 3 * c, sc=0.02), "bqkv": n(3 * c, sc=0.02),
            "wproj": n(c, c, sc=0.02), "bproj": n(c, sc=0.02), "table": n(225, nh, sc=0.02)}


def _port_args(p):
    return (_t(p["wqkv"].T), _t(p["bqkv"]), _t(p["wproj"].T), _t(p["bproj"]), _t(p["table"]))


@pytest.mark.parametrize("nh", [16, 32])  # hd 64 (HTSAT-large), 32 (HTSAT-base)
@pytest.mark.parametrize("shift", [0, 4])
def test_wide_attention_matches_jax_wide_kernel(rng, nh, shift):
    nw, res = 4, (16, 16)
    assert j_fwa.pick_group(nw, 64, C, nh) is None  # the JAX side takes _wide_attention
    p = _attention_params(rng, C, nh)
    x = (rng.standard_normal((nw, 64, C)) * 0.5).astype(np.float32)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_fwa.fused_window_attention(
            jnp.asarray(x), p["wqkv"], p["bqkv"], p["wproj"], p["bproj"], p["table"],
            nh, 8, nw, shift, res))
    args = (torch.from_numpy(x), *_port_args(p), nh, 8, nw, shift, res)
    got = t_k5.wide_window_attention(*args)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the port's K2 entry point sends this width to K5, as the JAX one does
    np.testing.assert_array_equal(t_k2.fused_window_attention(*args).numpy(), got.numpy())


def test_wide_attention_amp_dtype_contract(rng):
    """Under AMP the output keeps the caller's dtype (``test_pallas.py:643-668``)
    and stays within 3e-2 of the f32 result, relative to its largest value."""
    nh, nw, res = 16, 4, (16, 16)
    p = _attention_params(rng, C, nh)
    x = torch.from_numpy((rng.standard_normal((nw, 64, C)) * 0.5).astype(np.float32))
    rest = (nh, 8, nw, 4, res)
    f32 = t_k5.wide_window_attention(x, *_port_args(p), *rest)
    assert f32.dtype == torch.float32
    for xin in (x, x.bfloat16()):
        amp = t_k5.wide_window_attention(xin, *_port_args(p), *rest, torch.bfloat16)
        assert amp.dtype == xin.dtype
        rel = float((amp.float() - f32).abs().max() / f32.abs().max())
        assert rel < 3e-2, rel


def test_wide_swin_block_matches_jax_split_block(rng):
    """HTSAT-large layer 2 (C=1024, 16 heads, four windows, shift 4) with a
    ResiDual and the double FFN: the port's ``fused_swin_block`` runs LN1,
    K5, K3 where the JAX one runs ``_split_block`` through ``_wide_attention``."""
    nh, nw, res, hidden = 16, 4, (16, 16), 4 * C
    p = _attention_params(rng, C, nh)
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    ln = {"n1s": 1 + n(C, sc=0.1), "n1b": n(C, sc=0.1), "n2s": 1 + n(C, sc=0.1),
          "n2b": n(C, sc=0.1)}
    mlp = {"wfc1": n(C, hidden, sc=0.02), "bfc1": n(hidden, sc=0.02),
           "wfc2": n(hidden, C, sc=0.02), "bfc2": n(C, sc=0.02)}
    q, _ = np.linalg.qr(rng.standard_normal((C, C)))
    res_p = {"basis": q[:64].astype(np.float32), "mean": n(C, sc=0.01),
             "lam": (1 + n(64, sc=0.1)).astype(np.float32)}
    jflat = (ln["n1s"], ln["n1b"], p["wqkv"], p["bqkv"], p["wproj"], p["bproj"], ln["n2s"],
             ln["n2b"], mlp["wfc1"], mlp["bfc1"], mlp["wfc2"], mlp["bfc2"], p["table"],
             res_p["basis"], res_p["mean"], res_p["lam"])
    # the four weight matrices go to the port in nn.Linear layout
    tflat = tuple(_t(a.T) if i in (2, 4, 8, 10) else _t(a) for i, a in enumerate(jflat))
    x = (rng.standard_normal((nw, 64, C)) * 0.5).astype(np.float32)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k4.fused_swin_block(jnp.asarray(x), tuple(map(jnp.asarray, jflat)),
                                               nh, 8, nw, 4, res, True, True))
    got = t_k4.fused_swin_block(torch.from_numpy(x), tflat, nh, 8, nw, 4, res, True, True)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("variant", ["tiny", "base", "large"])
def test_port_routes_to_k5_where_jax_takes_the_wide_kernel(variant):
    """Every layer of every shipped HTSAT: the port's rule (C >= WIDE_MIN_C)
    picks K5 exactly where the JAX package's ``pick_group`` finds no plan."""
    cfg = j_htsat.HTSATConfig(**j_htsat.HTSAT_VARIANTS[variant])
    wide = []
    for i in range(cfg.num_layers):
        res = min(cfg.layer_resolution(i))
        window = min(cfg.window_size, res)
        nw = (res // window) ** 2
        c = cfg.embed_dim * 2**i
        jax_wide = j_fwa.pick_group(nw, window * window, c, cfg.num_heads[i]) is None
        assert jax_wide == (c >= t_k2.WIDE_MIN_C), (variant, i, c, nw)
        wide.append(jax_wide)
    assert wide == {"tiny": [False] * 4, "base": [False] * 3 + [True],
                    "large": [False, False, True, True]}[variant]


@pytest.fixture(scope="module")
def wide_fresh():
    return fx.build_wide()


def test_committed_wide_fixture_is_current(wide_fresh):
    """Regenerated from the JAX package == the committed file: config, input
    and ResiDual exactly; outputs to 1e-5 (same f32 program, XLA CPU run
    again)."""
    committed = fx.load(fx.WIDE_PATH)
    assert set(committed) == set(wide_fresh)
    assert str(committed["config"]) == str(wide_fresh["config"])
    for k in wide_fresh:
        if k.startswith("out/"):
            np.testing.assert_allclose(committed[k], wide_fresh[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        elif k != "config":
            np.testing.assert_array_equal(committed[k], wide_fresh[k], err_msg=k)
    assert fx.WIDE_PATH.stat().st_size < 1 << 20


@pytest.fixture(scope="module")
def wide_port_out():
    return fx.run_port(fx.load(fx.WIDE_PATH), "cpu")


@pytest.mark.parametrize("key", fx.WIDE_OUTPUT_KEYS)
def test_wide_fixture_matches_jax(wide_port_out, key):
    """The slice's tolerance (``test_torch_htsat.py``): ``atol=2e-3,
    rtol=1e-3``, embedding cosine > 0.99999."""
    ref, got = fx.load(fx.WIDE_PATH)[f"out/{key}"], wide_port_out[key]
    assert got.shape == ref.shape, key
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-3)
    if key in ("embedding", "normalized"):
        cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
        assert cos.min() > 0.99999, cos
