"""The golden routes of K2, K4 and K5, and the ResiDual of both modes, on
the 3xTF32 GEMM (``csrc/gemm_sm90.cuh::gemm_tf32x3``), on the CPU.

Each golden product -- qkv and proj of the window attention (K2, K4, K5),
the ResiDual's two (K3, K4, golden and AMP), fc1 and fc2 -- runs on that
GEMM. The kernels run only on the card (``tests/test_torch_cuda.py``); here
a replay of their arithmetic (``tests/torch_tf32x3_replay.py``) is held
against the plain versions and the JAX kernels in Pallas interpret mode, at
small widths with inputs from a seed; and the ResiDual's padding of its
component count to a multiple of 8, and the plans of every shipped layer's
products, are checked.

Tolerances: a replay within 1e-4 of the largest output of the plain f32
version (the card's golden tolerance: each 3xTF32 product is off by near
2^-21 of it, the sums stay f32), and within the JAX fixtures' bounds
(``atol=2e-3, rtol=1e-3``) of the JAX kernel, as the plain version is.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audio_residual_tpu.ops import windows as j_win
from audio_residual_tpu.ops.pallas import swin_block as j_k4
from audio_residual_tpu.ops.pallas import window_attention as j_k2
from audio_residual_tpu.residual import module as j_res
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.ops.cuda import swin_block as k4
from audio_residual_tpu_torch.ops.cuda import tf32x3
from audio_residual_tpu_torch.ops.cuda import wide_attention as k5
from audio_residual_tpu_torch.ops.cuda import window_attention as k2
from audio_residual_tpu_torch.residual.module import residual_apply

from .torch_tf32x3_replay import attention_replay, block_replay, layer_gemms, residual_replay
from .torch_threads import one_cpu_thread  # noqa: F401

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
JAX_TOL = dict(atol=2e-3, rtol=1e-3)
GOLDEN_TOL = 1e-4  # max |replay - plain| / max |plain|
SMEM_LIMIT = 232448


def _gen(seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    return rng, t


def _block(seed, c, nh, windows, window=8):
    """K4's flat params, a ResiDual with K = C (QR basis) and x [windows,
    window^2, C]."""
    rng, t = _gen(seed)
    h = 4 * c
    flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=c ** -0.5),
            t(3 * c, scale=0.02), t(c, c, scale=c ** -0.5), t(c, scale=0.02),
            t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(h, c, scale=c ** -0.5),
            t(h, scale=0.02), t(c, h, scale=h ** -0.5), t(c, scale=0.02),
            t((2 * window - 1) ** 2, nh, scale=0.1))
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    rp = {"basis": torch.from_numpy(q.astype(np.float32)), "mean": t(c, scale=0.1),
          "lam": t(c, scale=0.1, offset=1.0)}
    return flat, rp, t(windows, window * window, c, scale=0.5)


def _rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def _j(t):
    return jnp.asarray(t.numpy())


def _bias_mask(table, shift, res, window=8):
    return k2.bias_and_mask(table, window, shift, res)


# ---- (a) the replays against the plain versions and the JAX kernels ----------
@pytest.mark.parametrize("shift", [0, 4])
def test_k2_replay_matches_plain_and_jax_kernel(shift):
    """K2 golden: qkv -> f32 attention core -> proj, both products in
    3xTF32, with and without the shift mask (C = 64, 2 heads of 32, four
    windows a clip on a 16x16 grid, two clips)."""
    flat, _, x = _block(1, 64, 2, 8)
    weights = (*flat[2:6], flat[12])
    args = (x, *weights, 2, 8, 4, shift, (16, 16))
    got = attention_replay(x, *flat[2:6], *_bias_mask(flat[12], shift, (16, 16)), 2)
    plain = k2.window_attention_plain(*args)
    assert _rel(got, plain) < GOLDEN_TOL
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k2.fused_window_attention(
            _j(x), _j(flat[2].t()), _j(flat[3]), _j(flat[4].t()), _j(flat[5]), _j(flat[12]), 2,
            8, 4, shift, (16, 16)))
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), ref, **JAX_TOL)


@pytest.mark.parametrize("kr", [1, 7, 13, 64])
def test_k4_replay_with_residual_matches_plain_and_jax_kernel(kr):
    """K4 golden with a ResiDual of kr components (padded to a multiple of
    8 for its products) and the double FFN, shifted: every product in
    3xTF32 (C = 64, 2 heads)."""
    flat, rp, x = _block(2, 64, 2, 8)
    rp = {"basis": rp["basis"][:kr].contiguous(), "mean": rp["mean"], "lam": rp["lam"][:kr]}
    res = (rp["basis"], rp["mean"], rp["lam"])
    got = block_replay(x, flat, rp, 2, *_bias_mask(flat[12], 4, (16, 16)), True)
    plain = k4.swin_block_plain(x, flat + res, 2, 8, 4, 4, (16, 16), True, True)
    assert _rel(got, plain) < GOLDEN_TOL
    jflat = tuple(_j(p.t() if i in (2, 4, 8, 10) else p) for i, p in enumerate(flat + res))
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k4.fused_swin_block(_j(x), jflat, 2, 8, 4, 4, (16, 16), True, True))
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), ref, **JAX_TOL)


@pytest.mark.parametrize("nh", [4, 2], ids=["hd32", "hd64"])
def test_k5_replay_matches_plain_and_jax_wide_kernel(nh):
    """K5 golden is K2's sequence at its width: against its plain version
    and the JAX weight-streaming ``_wide_attention`` (interpret mode) at
    head dims 32 and 64 (C = 128, the narrowest width its 128-column
    chunks take; one window a clip, two clips)."""
    flat, _, x = _block(3, 128, nh, 2)
    bias, mask = _bias_mask(flat[12], 0, (8, 8))
    got = attention_replay(x, *flat[2:6], bias, mask, nh)
    plain = k5.wide_attention_plain(x, *flat[2:6], flat[12], nh, 8, 1, 0, (8, 8))
    assert _rel(got, plain) < GOLDEN_TOL
    jbias = j_win.gather_relative_bias(_j(flat[12]), 8, 8)
    plan = j_k2.wide_plan(1, 64, 128, nh)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k2._wide_attention(
            _j(x), _j(flat[2].t()), _j(flat[3]), _j(flat[4].t()), _j(flat[5]), jbias,
            jnp.zeros((1, 64, 64), jnp.float32), nw=1, n=64, c=128, nh=nh,
            scale=(128 // nh) ** -0.5, plan=plan, mxu_dtype=None))
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), ref, **JAX_TOL)


# ---- (b) the ResiDual's padding ----------------------------------------------
def _residual_in_k_order(a, basis, mean, lam):
    """The plain formula with every sum run in K order (``torch.cumsum``):
    a library matmul may block a sum of 13 terms otherwise than one of 16,
    this order stays as it was when zero terms are added at the end."""
    proj = torch.cumsum((a - mean)[:, None, :] * basis[None], dim=-1)[..., -1] * lam
    return torch.cumsum(proj[:, :, None] * basis[None], dim=1)[:, -1]


@pytest.mark.parametrize("kr", [1, 5, 13, 60, 64])
def test_residual_padding_changes_nothing(kr):
    """kr zero-padded to a multiple of 8 (:func:`.tf32x3.residual_operands`):
    the plain formula, each sum in K order, on the padded operands gives
    the unpadded bits (a padded component's column is exactly 0, 0 * lam =
    0, and its basis row is 0); the replay of the two products on them is
    within 1e-4 of the largest value of the plain formula, and so within
    1e-5 (rtol 1e-4) of the JAX ``residual_apply``."""
    _, rp, _ = _block(4, 64, 2, 1)
    _, t = _gen(40)
    a = t(96, 64, scale=0.5)
    basis, mean, lam = rp["basis"][:kr].contiguous(), rp["mean"], rp["lam"][:kr]
    r = tf32x3.residual_operands(basis, mean, lam, a.shape[0], 132)
    k8 = r.kr
    basis8 = r.basis.hi + r.basis.lo
    assert k8 % 8 == 0 and 0 <= k8 - kr < 8 and tuple(r.lam.shape) == (k8,)
    assert torch.equal(basis8[:kr], basis) and not basis8[kr:].any() and not r.lam[kr:].any()
    assert torch.equal(r.basis_t.hi + r.basis_t.lo, basis8.t())
    assert torch.equal(_residual_in_k_order(a, basis8, mean, r.lam),
                       _residual_in_k_order(a, basis, mean, lam))
    plain = residual_apply(a, basis, mean, lam)
    got = residual_replay(a, basis, mean, lam)
    assert _rel(got, plain) < GOLDEN_TOL
    ref = np.asarray(j_res.residual_apply(_j(a), _j(basis), _j(mean), _j(lam)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


# ---- (c) every component count plans after padding ---------------------------
@pytest.mark.parametrize("c", [32, 40, 96])
def test_every_component_count_plans_after_padding(c):
    """Every kr from 1 to C takes both products' plans once padded; the plan
    itself still refuses the raw shapes (N = kr no multiple of 8, K = kr no
    multiple of 4) for direct callers."""
    _, t = _gen(c)
    basis, mean, lam = t(c, c), t(c), t(c)
    for kr in range(1, c + 1):
        r = tf32x3.residual_operands(basis[:kr].contiguous(), mean, lam[:kr], 200, 132)
        assert r.kr == tf32x3.padded_components(kr) and r.kr % 8 == 0
        assert r.basis.plan.bn in tf32x3.GEMM_BNS and r.basis_t.plan.bn in tf32x3.GEMM_BNS
        assert tuple(r.basis.hi.shape) == (r.kr, c) and tuple(r.basis_t.hi.shape) == (c, r.kr)
        if kr % 8:
            with pytest.raises(ValueError, match=f"N={kr}"):
                tf32x3.gemm_plan(200, kr, c)
        if kr % 4:
            with pytest.raises(ValueError, match=f"K={kr}"):
                tf32x3.gemm_plan(200, c, kr)


# ---- (d) every shipped layer's products have a plan --------------------------
HTSAT = [n for n in factory.list_models() if n.startswith("HTSAT")]


@pytest.mark.parametrize("name", HTSAT)
def test_every_shipped_layer_product_has_a_plan(name):
    """qkv, proj, fc1, fc2 and the ResiDual's two products (every component
    count, padded) of every Swin layer at B = 1, 3 and 32: an N tile of the
    build, a ring of at least 3 stages in shared memory, every SM busy
    where there are tiles for it."""
    gemms = layer_gemms(name)
    assert {what for what, *_ in gemms} == {"qkv", "proj", "fc1", "fc2", "res1", "res2"}
    for _, n, k, tokens in gemms:
        for b in (1, 3, 32):
            plan = tf32x3.gemm_plan(b * tokens, n, k)
            assert plan.bn in tf32x3.GEMM_BNS and plan.stages >= 3
            assert plan.smem_bytes <= SMEM_LIMIT
            assert plan.tiles == -(-b * tokens // 128) * -(-n // plan.bn)
            assert plan.grid == min(plan.tiles, 132)
