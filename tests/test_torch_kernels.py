"""The port's four kernel wrappers held against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernel runs
in Pallas interpret mode, patched as ``tests/test_pallas.py`` does. f32
tolerances are the JAX suite's own: window attention / FFN / block
``atol=5e-5, rtol=1e-3`` (``test_pallas.py:276,304``), log-mel ``atol=2e-3``
dB (``test_pallas.py:468``). Weights go to the port in ``nn.Linear``
layout (transposed from the JAX ``[in, out]`` kernels).

The CUDA kernels against their plain versions on the card are in
``tests/test_torch_cuda.py``.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audio_residual_tpu.ops import frontend as j_fe
from audio_residual_tpu.ops.pallas import frontend as j_k1
from audio_residual_tpu.ops.pallas import ln_mlp as j_k3
from audio_residual_tpu.ops.pallas import swin_block as j_k4
from audio_residual_tpu.ops.pallas import window_attention as j_k2
from audio_residual_tpu_torch.ops import frontend as t_fe
from audio_residual_tpu_torch.ops.cuda import launch_counts
from audio_residual_tpu_torch.ops.cuda import frontend as t_k1
from audio_residual_tpu_torch.ops.cuda import ln_mlp as t_k3
from audio_residual_tpu_torch.ops.cuda import swin_block as t_k4
from audio_residual_tpu_torch.ops.cuda import window_attention as t_k2

from .torch_threads import one_cpu_thread  # noqa: F401

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
TOL = dict(atol=5e-5, rtol=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _block(rng, c, nh, hidden):
    """JAX-layout block params (numpy) and the port's flat tuple."""
    n = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    p = {
        "n1s": 1 + n(c, sc=0.1), "n1b": n(c, sc=0.1),
        "wqkv": n(c, 3 * c, sc=0.05), "bqkv": n(3 * c, sc=0.02),
        "wproj": n(c, c, sc=0.05), "bproj": n(c, sc=0.02),
        "n2s": 1 + n(c, sc=0.1), "n2b": n(c, sc=0.1),
        "wfc1": n(c, hidden, sc=0.05), "bfc1": n(hidden, sc=0.02),
        "wfc2": n(hidden, c, sc=0.05), "bfc2": n(c, sc=0.02),
        "table": n(225, nh, sc=0.02),
    }
    order = ("n1s", "n1b", "wqkv", "bqkv", "wproj", "bproj", "n2s", "n2b", "wfc1", "bfc1",
             "wfc2", "bfc2", "table")
    jflat = tuple(jnp.asarray(p[k]) for k in order)
    tflat = tuple(_t(p[k].T) if k.startswith("w") else _t(p[k]) for k in order)
    return p, jflat, tflat


def _residual(rng, c):
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    r = {"basis": q.astype(np.float32),
         "mean": (rng.standard_normal(c) * 0.01).astype(np.float32),
         "lam": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in r.items()}, {k: _t(v) for k, v in r.items()})


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_fused_logmel_matches_jax_kernel(rng, mode):
    """bf16: both round frames and basis to bf16 and accumulate in f32, so
    only the summation order differs -- the f32 tolerance still holds."""
    wav = (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k1.fused_logmel(jnp.asarray(wav), j_fe.FrontendConfig(), dft_mode=mode))
    got = t_k1.fused_logmel(torch.from_numpy(wav), t_fe.FrontendConfig(), dft_mode=mode)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)


def test_fused_logmel_tiny_config_matches_rfft_logmel(rng):
    """The kernel's DFT-GEMM over active bins == the FFT log-mel (the bins it
    drops carry zero mel weight)."""
    cfg = t_fe.FrontendConfig(n_mels=16)
    wav = torch.from_numpy((rng.standard_normal((2, 24000)) * 0.1).astype(np.float32))
    np.testing.assert_allclose(t_k1.fused_logmel(wav, cfg).numpy(),
                               t_fe.logmel(wav, cfg).numpy(), atol=2e-3)


@pytest.mark.parametrize("c,nh", [(96, 4), (32, 2)])  # hd 24 (main path), 16 (test configs)
@pytest.mark.parametrize("shift", [0, 4])
def test_fused_window_attention_matches_jax_kernel(rng, c, nh, shift):
    p, _, _ = _block(rng, c, nh, 4 * c)
    g, res = 4, (16, 16)
    x = (rng.standard_normal((2 * g, 64, c)) * 0.5).astype(np.float32)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = j_k2.fused_window_attention(
            jnp.asarray(x), p["wqkv"], p["bqkv"], p["wproj"], p["bproj"], p["table"],
            nh, 8, g, shift, res)
    got = t_k2.fused_window_attention(
        torch.from_numpy(x), _t(p["wqkv"].T), _t(p["bqkv"]), _t(p["wproj"].T), _t(p["bproj"]),
        _t(p["table"]), nh, 8, g, shift, res)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_res,dffn", [(False, False), (True, False), (True, True)])
def test_fused_residual_ffn_matches_jax_kernel(rng, use_res, dffn):
    c, hidden, rows = 96, 384, 128
    p, _, _ = _block(rng, c, 4, hidden)
    x = (rng.standard_normal((rows, c)) * 0.5).astype(np.float32)
    a = (rng.standard_normal((rows, c)) * 0.1).astype(np.float32)
    jr, tr = _residual(rng, c)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = j_k3.fused_residual_ffn(
            jnp.asarray(x), jnp.asarray(a), p["n2s"], p["n2b"], p["wfc1"], p["bfc1"],
            p["wfc2"], p["bfc2"], jr if use_res else None, double_ffn=dffn)
    got = t_k3.fused_residual_ffn(
        torch.from_numpy(x), torch.from_numpy(a), _t(p["n2s"]), _t(p["n2b"]), _t(p["wfc1"].T),
        _t(p["bfc1"]), _t(p["wfc2"].T), _t(p["bfc2"]), tr if use_res else None, double_ffn=dffn)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize(
    # (False, True): double_ffn_compat must be a no-op without a ResiDual
    "use_res,dffn", [(False, False), (False, True), (True, False), (True, True)],
)
def test_fused_swin_block_matches_jax_kernel(rng, shift, use_res, dffn):
    c, nh, g = 32, 2, 4
    _, jflat, tflat = _block(rng, c, nh, 4 * c)
    jr, tr = _residual(rng, c)
    x = (rng.standard_normal((2 * g, 64, c)) * 0.5).astype(np.float32)
    jfp = jflat + ((jr["basis"], jr["mean"], jr["lam"]) if use_res else ())
    tfp = tflat + ((tr["basis"], tr["mean"], tr["lam"]) if use_res else ())
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = j_k4.fused_swin_block(jnp.asarray(x), jfp, nh, 8, g, shift, (16, 16), use_res, dffn)
    got = t_k4.fused_swin_block(torch.from_numpy(x), tfp, nh, 8, g, shift, (16, 16), use_res, dffn)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fused_swin_block_main_path_head_dim(rng):
    """hd = 24 (HTSAT-tiny layer 0 width) with ResiDual + double-FFN."""
    c, nh, g = 96, 4, 4
    _, jflat, tflat = _block(rng, c, nh, 4 * c)
    jr, tr = _residual(rng, c)
    x = (rng.standard_normal((g, 64, c)) * 0.5).astype(np.float32)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = j_k4.fused_swin_block(jnp.asarray(x), jflat + tuple(jr.values()), nh, 8, g, 4,
                                    (16, 16), True, True)
    got = t_k4.fused_swin_block(torch.from_numpy(x), tflat + tuple(tr.values()), nh, 8, g, 4,
                                (16, 16), True, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_amp_store_dtype_and_bf16_semantics(rng):
    """AMP contract of the plain versions: caller's dtype out (bf16 in, bf16
    out; f32 in, f32 out), within bf16 rounding of the f32 result. 3e-2
    relative = a few bf16 ulps through a block's chain of products."""
    c, nh, g = 32, 2, 4
    _, _, tflat = _block(rng, c, nh, 4 * c)
    x = torch.from_numpy((rng.standard_normal((g, 64, c)) * 0.5).astype(np.float32))
    f32 = t_k4.fused_swin_block(x, tflat, nh, 8, g, 4, (16, 16), False, False)
    for xin in (x, x.bfloat16()):
        amp = t_k4.fused_swin_block(xin, tflat, nh, 8, g, 4, (16, 16), False, False,
                                    torch.bfloat16)
        assert amp.dtype == xin.dtype
        rel = float((amp.float() - f32).abs().max() / f32.abs().max())
        assert rel < 3e-2, rel
    a = t_k2.fused_window_attention(x.bfloat16(), *tflat[2:6], tflat[12], nh, 8, g, 0,
                                    (16, 16), torch.bfloat16)
    assert a.dtype == torch.bfloat16
    assert t_k3.fused_residual_ffn(x.reshape(-1, c), a.reshape(-1, c).float(), *tflat[6:12]
                                   ).dtype == torch.float32


def test_cpu_wrappers_count_no_launches(rng):
    """The counters count kernel launches on the card only."""
    launch_counts.clear()
    wav = torch.from_numpy((rng.standard_normal((1, 4800)) * 0.1).astype(np.float32))
    t_k1.fused_logmel(wav, t_fe.FrontendConfig())
    assert sum(launch_counts.values()) == 0
