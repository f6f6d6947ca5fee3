"""The backward of the kernels' autograd entries (``ops/cuda/autograd.py``)
on the CPU, where each entry's forward is the plain version.

On the card the forward is the kernel and the backward re-runs the plain
version; here both are the plain version, so the entry's grads must equal
autograd through the plain version exactly (the same operations on the
same inputs): for x, K3's ``a`` and λ, ResiDual on and off, the double FFN
on and off, golden and AMP. This is the only run of the backward's wiring
where there is no card.
"""

import numpy as np
import pytest
import torch

from audio_residual_tpu_torch.models import clap as t_clap
from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.ops.cuda import autograd
from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
from audio_residual_tpu_torch.ops.cuda import swin_block as k4
from audio_residual_tpu_torch.ops.cuda import wide_attention as k5
from audio_residual_tpu_torch.ops.cuda import window_attention as k2

MODES = {"golden": None, "amp": torch.bfloat16}
VARIANTS = {"plain": (False, False), "residual": (True, False), "double-ffn": (True, True)}


def _t(rng, *shape, scale=1.0, offset=0.0):
    return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))


def _block(c, nh, window, seed=0):
    rng = np.random.default_rng(seed)
    h = 4 * c
    flat = (_t(rng, c, scale=0.1, offset=1.0), _t(rng, c, scale=0.1),
            _t(rng, 3 * c, c, scale=c ** -0.5), _t(rng, 3 * c, scale=0.02),
            _t(rng, c, c, scale=c ** -0.5), _t(rng, c, scale=0.02),
            _t(rng, c, scale=0.1, offset=1.0), _t(rng, c, scale=0.1),
            _t(rng, h, c, scale=c ** -0.5), _t(rng, h, scale=0.02),
            _t(rng, c, h, scale=h ** -0.5), _t(rng, c, scale=0.02),
            _t(rng, (2 * window - 1) ** 2, nh, scale=0.02))
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res = (torch.from_numpy(q.astype(np.float32)), _t(rng, c, scale=0.01),
           _t(rng, c, scale=0.1, offset=1.0))
    return flat, res, rng


def _grads(fn, inputs, cotangent):
    """Grads of ``sum(fn() * cotangent)`` for ``inputs``, with the output."""
    out = fn()
    grads = torch.autograd.grad((out.float() * cotangent).sum(), inputs)
    return out, grads


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


def _assert_same(got, ref):
    (out_g, grads_g), (out_r, grads_r) = got, ref
    assert out_g.dtype == out_r.dtype and torch.equal(out_g, out_r)
    assert out_g.grad_fn is not None
    for g, r in zip(grads_g, grads_r):
        assert g is not None and g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_swin_block_autograd_equals_plain(mode, shift, variant):
    """K4 at window 4 on an 8x8 grid (four windows a clip), two clips; x in
    the store dtype of the path (bf16 under AMP, as at layer 0)."""
    use_res, dffn = VARIANTS[variant]
    md = MODES[mode]
    flat, res, rng = _block(32, 2, 4)
    x = _t(rng, 8, 16, 32, scale=0.5).to(md or torch.float32)
    x, lam = _leaf(x), _leaf(res[2])
    params = flat + ((res[0], res[1], lam) if use_res else ())
    inputs = [x, lam] if use_res else [x]
    args = (2, 4, 4, shift, (8, 8), use_res, dffn, md)
    cot = _t(rng, 8, 16, 32)
    _assert_same(_grads(lambda: k4.swin_block_autograd(x, params, *args), inputs, cot),
                 _grads(lambda: k4.swin_block_plain(x, params, *args), inputs, cot))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mode", list(MODES))
def test_residual_ffn_autograd_equals_plain(mode, variant):
    use_res, dffn = VARIANTS[variant]
    md = MODES[mode]
    flat, res, rng = _block(32, 2, 4, seed=1)
    x = _leaf(_t(rng, 64, 32, scale=0.5))
    a = _leaf(_t(rng, 64, 32, scale=0.1))
    lam = _leaf(res[2])
    rp = {"basis": res[0], "mean": res[1], "lam": lam} if use_res else None
    inputs = [x, a, lam] if use_res else [x, a]
    cot = _t(rng, 64, 32)
    kw = dict(double_ffn=dffn, mxu_dtype=md)
    _assert_same(
        _grads(lambda: k3.residual_ffn_autograd(x, a, *flat[6:12], rp, **kw), inputs, cot),
        _grads(lambda: k3.residual_ffn_plain(x, a, *flat[6:12], rp, **kw), inputs, cot))


@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("mode", list(MODES))
def test_window_attention_autograd_equals_plain(mode, shift):
    md = MODES[mode]
    flat, _, rng = _block(32, 2, 4, seed=2)
    x = _leaf(_t(rng, 8, 16, 32, scale=0.5))
    args = (*flat[2:6], flat[12], 2, 4, 4, shift, (8, 8), md)
    cot = _t(rng, 8, 16, 32)
    _assert_same(_grads(lambda: k2.window_attention_autograd(x, *args), [x], cot),
                 _grads(lambda: k2.window_attention_plain(x, *args), [x], cot))


@pytest.mark.parametrize("mode", list(MODES))
def test_wide_attention_autograd_equals_plain(mode):
    """K5 at C = 1024 (hd 32), two windows of 16 tokens."""
    md = MODES[mode]
    flat, _, rng = _block(1024, 32, 4, seed=3)
    x = _leaf(_t(rng, 2, 16, 1024, scale=0.5))
    args = (*flat[2:6], flat[12], 32, 4, 1, 0, (4, 4), md)
    cot = _t(rng, 2, 16, 1024)
    _assert_same(_grads(lambda: k5.wide_attention_autograd(x, *args), [x], cot),
                 _grads(lambda: k5.wide_attention_plain(x, *args), [x], cot))


def test_frozen_weights_get_grads_when_asked():
    """Every input of K4 requires grad: the entry returns a grad for each,
    equal to the plain version's."""
    flat, res, rng = _block(32, 2, 4, seed=4)
    x = _leaf(_t(rng, 8, 16, 32, scale=0.5))
    params = tuple(_leaf(p) for p in flat + res)
    args = (2, 4, 4, 2, (8, 8), True, True, None)
    cot = _t(rng, 8, 16, 32)
    inputs = [x, *params]
    _assert_same(_grads(lambda: k4.swin_block_autograd(x, params, *args), inputs, cot),
                 _grads(lambda: k4.swin_block_plain(x, params, *args), inputs, cot))


def test_needs_graph():
    x, w = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert autograd.needs_graph(x, None, w)
    assert not autograd.needs_graph(x, None)
    with torch.no_grad():
        assert not autograd.needs_graph(x, w)


@pytest.fixture(scope="module")
def model():
    cfg = t_clap.CLAPConfig(embed_dim=64, joint_embed_shape=32, audio=t_htsat.HTSATConfig(
        spec_size=64, mel_bins=16, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
        clip_samples=24000, num_classes=17))
    return t_clap.build_clap_audio(cfg, device="cpu")


def _residual(lam_requires_grad):
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((32, 32)))
    lam = torch.ones(32, requires_grad=lam_requires_grad)
    return {0: {"basis": torch.tensor(q, dtype=torch.float32), "mean": torch.zeros(32),
                "lam": lam}}


def test_encode_audio_builds_no_graph_without_a_lambda_grad(model):
    """The weights are frozen: with a λ that requires no grad, the forward
    (in grad mode) returns outputs without a ``grad_fn``."""
    wav = torch.from_numpy((np.random.default_rng(6).standard_normal((2, 24000)) * 0.1)
                           .astype(np.float32))
    out = t_clap.encode_audio(model, wav, residual=_residual(False))
    assert all(v.grad_fn is None for v in out.values())


def test_encode_audio_gives_lambda_a_grad(model):
    wav = torch.from_numpy((np.random.default_rng(6).standard_normal((2, 24000)) * 0.1)
                           .astype(np.float32))
    residual = _residual(True)
    out = t_clap.encode_audio(model, wav, residual=residual)
    out["normalized"].sum().backward()
    g = residual[0]["lam"].grad
    assert g is not None and bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert all(p.grad is None for p in model.parameters())
