"""The plan of K5's AMP kernel (``csrc/window_attention_tc.cuh::
window_attention_wgmma_kernel``, which K5 shares with K2 and K4), held on
the CPU against the plain version and the JAX Pallas kernel.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
what it is given and how it splits the work are checked here: the launch
plan the wrapper computes for every shipped wide layer, the wrapper's
refusals, the bf16 cast of x it makes before the launch, and the bias and
mask padded to the 64-token tile, replayed in plain torch. The JAX kernel
runs in Pallas interpret mode, as ``tests/test_torch_wide_attention.py``
runs it.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from audio_residual_tpu.ops.pallas import window_attention as j_fwa
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.ops.cuda import build
from audio_residual_tpu_torch.ops.cuda import wide_attention as k5
from audio_residual_tpu_torch.ops.cuda.window_attention import WIDE_MIN_C, q_scale

from .torch_threads import one_cpu_thread  # noqa: F401

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
BF16 = torch.bfloat16


def _wide_layers() -> list:
    """``(config, layer, C, nh, n, windows per clip)`` of every layer with
    C >= WIDE_MIN_C of every registered HTSAT config."""
    out = []
    for name in factory.list_models():
        if not name.startswith("HTSAT"):
            continue
        cfg = factory._amodel_to_config(factory.get_model_config(name))
        for i in range(cfg.num_layers):
            c = cfg.layer_dim(i)
            if c < WIDE_MIN_C:
                continue
            res = min(cfg.layer_resolution(i))
            window = min(cfg.window_size, res)
            out.append((name, i, c, cfg.num_heads[i], window * window, (res // window) ** 2))
    return out


WIDE_LAYERS = _wide_layers()


def test_the_registry_has_the_wide_layers():
    """HTSAT-base layer 3 and HTSAT-large layers 2-3: the layers K5 serves."""
    assert sorted((name, i) for name, i, *_ in WIDE_LAYERS) == [
        ("HTSAT-base", 3), ("HTSAT-large", 2), ("HTSAT-large", 3)]


@pytest.mark.parametrize("layer", WIDE_LAYERS, ids=lambda v: f"{v[0]}-layer{v[1]}")
@pytest.mark.parametrize("batch", [1, 3, 32])
def test_plan_of_every_shipped_wide_layer(layer, batch):
    """N = 192 q|k|v columns a block; C a multiple of the 64-wide K step and
    head group; TMA rows on 16-byte boundaries; the shared memory within the
    H100's 232 448 bytes; every window covered, odd counts too, and no
    block without one."""
    _, _, c, nh, n, nw = layer
    windows = batch * nw
    plan = k5.amp_plan(windows, n, c, nh)
    assert plan.n_cols == 3 * 64 == 192
    assert c % 64 == 0 and plan.grid[1] * 64 == c
    assert plan.heads_per_block * (c // nh) == 64
    assert (2 * c) % 16 == 0 and (2 * n * c) % 16 == 0  # x rows, x windows, wqkv rows in bf16
    assert plan.smem_bytes <= build.SMEM_LIMIT
    covered = plan.grid[0] * plan.windows_per_block
    assert covered >= windows > covered - plan.windows_per_block


@pytest.mark.parametrize("windows,grid_x", [(1, 1), (3, 2), (5, 3), (7, 4), (9, 5)])
def test_plan_covers_odd_window_counts(windows, grid_x):
    """A pair's second window may be missing (its x box arrives all zero,
    and its rows are not stored), never a whole pair."""
    assert k5.amp_plan(windows, 64, 1024, 32).grid == (grid_x, 16)


@pytest.mark.parametrize("args,match", [
    ((4, 100, 1024, 16), "at most 64 tokens"),
    ((0, 64, 1024, 16), "at least one window"),
    ((4, 64, 1024, 64), "head dims"),        # hd 16
    ((4, 64, 1024, 8), "head dims"),         # hd 128
    ((4, 64, 1056, 33), "no multiple of 64"),  # hd 32, but C = 16.5 head groups
])
def test_plan_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        k5.amp_plan(*args)


def _inputs(rng, c, nh, windows, window=8):
    n = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    weights = (n(3 * c, c, sc=0.02), n(3 * c, sc=0.02), n(c, c, sc=0.02), n(c, sc=0.02),
               n((2 * window - 1) ** 2, nh, sc=0.02))
    return weights, n(windows, window * window, c, sc=0.5)


@pytest.mark.parametrize("nh,shift", [(32, 0), (16, 4)])
def test_casting_x_to_bf16_first_changes_nothing(rng, nh, shift):
    """The wrapper hands the kernel bf16 x: bit for bit the AMP function of
    the f32 x, whose products round it so anyway."""
    weights, x = _inputs(rng, 1024, nh, 8)
    rest = (nh, 8, 4, shift, (16, 16), BF16)
    got = k5.wide_attention_plain(x.bfloat16().float(), *weights, *rest)
    ref = k5.wide_attention_plain(x, *weights, *rest)
    assert got.dtype == ref.dtype == torch.float32
    assert torch.equal(got, ref)


def _kernel_plan(x, wqkv, bqkv, wproj, bproj, table, nh, window, nw, shift, resolution):
    """The AMP kernel's plan in plain torch: windows zero-padded to 64 rows,
    bf16 q|k|v with q scaled in the qkv epilogue, scores against the padded
    bias and mask, exact softmax, bf16 P, bf16 attention output, the proj on
    it; rows past n dropped."""
    wn, n, c = x.shape
    hd = c // nh
    xp = F.pad(x.bfloat16().float(), (0, 0, 0, 64 - n))
    qkv = (xp @ wqkv.bfloat16().float().t() + bqkv) * q_scale(c, nh, x.device)
    qkv = qkv.bfloat16().float().reshape(wn, 64, 3, nh, hd)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    bias, mask = k5.padded_bias_and_mask(table, window, shift, resolution)
    s = q @ k.transpose(-1, -2) + bias[None]
    if mask is not None:
        s = (s.reshape(wn // nw, nw, nh, 64, 64) + mask[None, :, None]).reshape(wn, nh, 64, 64)
    p = torch.softmax(s, dim=-1).bfloat16().float()
    att = (p @ v).permute(0, 2, 1, 3)[:, :n].reshape(-1, c).bfloat16().float()
    return (att @ wproj.bfloat16().float().t() + bproj).reshape(wn, n, c)


@pytest.mark.parametrize("nh,windows,window,nw,shift,res", [
    (32, 3, 8, 1, 0, (8, 8)),       # HTSAT-base layer 3, odd window count
    (16, 8, 8, 4, 4, (16, 16)),     # HTSAT-large layer 2, shifted
    (16, 8, 7, 4, 3, (14, 14)),     # 7-wide windows: n = 49, padded keys and rows
])
def test_kernel_plan_matches_plain_amp(rng, nh, windows, window, nw, shift, res):
    """The padding is exact: -inf bias on padded keys gives them p = 0, and
    padded rows are dropped. The plan equals the plain AMP version bit for
    bit on this CPU; the limits leave room for another summation order,
    which may round a stored bf16 value the other way (one bf16 ulp, 2^-8 of
    it, reaching the output through the proj)."""
    weights, x = _inputs(rng, 1024, nh, windows, window)
    args = (x, *weights, nh, window, nw, shift, res)
    got = _kernel_plan(*args)
    ref = k5.wide_attention_plain(*args, BF16)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-3)
    assert float((got - ref).abs().mean()) < 2e-5


@pytest.mark.parametrize("nh", [16, 32])  # hd 64 (HTSAT-large), 32 (HTSAT-base)
@pytest.mark.parametrize("shift", [0, 4])
def test_amp_matches_jax_wide_kernel(rng, nh, shift):
    """Under AMP against the JAX ``_wide_attention(mxu_dtype=bf16)`` (its
    ``_wide_kernel`` in interpret mode), which rounds x, W, q, k, v and p to
    bf16 at the same places, on bf16 x, so that both store bf16 (an f32 x
    the JAX wide route casts to bf16 before its kernel, and its output then
    comes back through bf16, ``window_attention.py:323-340``, where the
    port's keeps f32: ROADMAP Queue 3). XLA and PyTorch sum each product in
    other orders, so a few stored bf16 values round the other way (one bf16
    ulp, 2^-8 of a value) and carry through the proj, as
    ``tests/test_torch_swin_amp_plan.py`` found for K4. Here 1-3% of the
    outputs (up to ~0.2) are one ulp apart, at most 9.8e-4, and the mean gap
    is at most 1.4e-6: limits ``atol=2e-3`` and 5e-6 on the mean."""
    nw, res, c = 4, (16, 16), 1024
    assert j_fwa.pick_group(nw, 64, c, nh) is None  # the JAX side takes _wide_attention
    (wqkv, bqkv, wproj, bproj, table), x = _inputs(rng, c, nh, nw)
    x = x.bfloat16()
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_fwa.fused_window_attention(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), wqkv.t().numpy(), bqkv.numpy(),
            wproj.t().numpy(), bproj.numpy(), table.numpy(), nh, 8, nw, shift, res,
            jnp.bfloat16)).astype(np.float32)
    got = k5.wide_window_attention(x, wqkv, bqkv, wproj, bproj, table, nh, 8, nw, shift, res,
                                   BF16)
    assert got.dtype == BF16 and got.shape == ref.shape
    gap = np.abs(got.float().numpy() - ref)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2e-3)
    assert float(gap.mean()) < 5e-6
