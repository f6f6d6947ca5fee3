"""The plan of the AMP qkv + attention kernel that K2, K4 and K5 share
(``csrc/window_attention_tc.cuh::window_attention_wgmma_kernel``), held on
the CPU against the plain version and the JAX Pallas kernels.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
What it is given and how it splits the work are checked here: the launch
plan the wrappers compute for every shipped K2/K4 layer, its refusals, and
a replay in plain torch of the kernel's decomposition -- window pairs with a
missing second window zero-filled, head groups of two heads (hd 16, 24, 32)
or one (hd 64), 64-wide K steps with the ragged last one zero-filled
(C = 96), q|k|v rounded to bf16 after the bias and q's scale, the padded
bias and mask, rows past n computed and dropped. The replay is held against
the plain AMP version and against the JAX kernels in Pallas interpret mode,
as ``tests/test_torch_kernels.py`` runs them.
"""

import functools
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from audio_residual_tpu.ops.pallas import swin_block as j_k4
from audio_residual_tpu.ops.pallas import window_attention as j_k2
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.ops.cuda import build
from audio_residual_tpu_torch.ops.cuda import swin_block as t_k4
from audio_residual_tpu_torch.ops.cuda import window_attention as k2
from audio_residual_tpu_torch.ops.cuda.window_attention import WIDE_MIN_C, q_scale

from .torch_threads import one_cpu_thread  # noqa: F401

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
BF16 = torch.bfloat16


def _window_layers() -> list:
    """``(config, layer, C, nh, n, windows per clip)`` of every layer below
    WIDE_MIN_C of every registered HTSAT config: the K2 and K4 calls."""
    out = []
    for name in factory.list_models():
        if not name.startswith("HTSAT"):
            continue
        cfg = factory._amodel_to_config(factory.get_model_config(name))
        for i in range(cfg.num_layers):
            c = cfg.layer_dim(i)
            if c >= WIDE_MIN_C:
                continue
            res = min(cfg.layer_resolution(i))
            window = min(cfg.window_size, res)
            out.append((name, i, c, cfg.num_heads[i], window * window, (res // window) ** 2))
    return out


WINDOW_LAYERS = _window_layers()


def test_the_registry_has_the_window_layers():
    """HTSAT-tiny (both frontends) layers 0-3, HTSAT-base layers 0-2 and
    HTSAT-large layers 0-1: hd 24, 32 and 64."""
    got = sorted((name, i, c // nh) for name, i, c, nh, *_ in WINDOW_LAYERS)
    assert got == sorted([("HTSAT-tiny", i, 24) for i in range(4)]
                         + [("HTSAT-tiny-win-1536", i, 24) for i in range(4)]
                         + [("HTSAT-base", i, 32) for i in range(3)]
                         + [("HTSAT-large", i, 64) for i in range(2)])


@pytest.mark.parametrize("layer", WINDOW_LAYERS, ids=lambda v: f"{v[0]}-layer{v[1]}")
@pytest.mark.parametrize("batch", [1, 32])
def test_plan_of_every_shipped_window_layer(layer, batch):
    """Two heads a unit (one at hd 64), so N = 6 hd q|k|v columns: 144 at
    hd 24, 192 at hd 32 and 64; weight boxes of N/3 rows keep the swizzle's
    1 KB atoms; TMA rows on 16-byte boundaries; the ring as deep as the
    H100's 232 448 bytes of shared memory allow; every window covered, odd
    counts too; one block an SM and none without a unit."""
    _, _, c, nh, n, nw = layer
    hd, windows = c // nh, batch * nw
    plan = k2.amp_plan(windows, n, c, nh)
    nq = plan.n_cols // 3
    assert plan.heads_per_block == (1 if hd == 64 else 2)
    assert nq == plan.heads_per_block * hd and plan.n_cols == {24: 144, 32: 192, 64: 192}[hd]
    assert plan.grid[1] * nq == c and (nq * 64 * 2) % 1024 == 0
    assert (2 * c) % 16 == 0 and (2 * n * c) % 16 == 0
    assert plan.stages == {144: 5, 192: 4}[plan.n_cols]
    assert plan.smem_bytes <= build.SMEM_LIMIT
    # no room for one more stage (x box, weight box, two barriers)
    assert plan.smem_bytes + 16 * 1024 + plan.n_cols * 64 * 2 + 16 > build.SMEM_LIMIT
    covered = plan.grid[0] * plan.windows_per_block
    assert covered >= windows > covered - plan.windows_per_block
    assert plan.blocks == min(plan.grid[0] * plan.grid[1], 132)


@pytest.mark.parametrize("windows,sms,blocks", [(1, 132, 2), (3, 132, 4), (2048, 132, 132),
                                                (2048, 114, 114)])
def test_plan_runs_one_block_an_sm(windows, sms, blocks):
    """At C = 96 (two head groups) the units are window pairs x 2; a card
    with fewer SMs gets fewer persistent blocks."""
    assert k2.amp_plan(windows, 64, 96, 4, sms).blocks == blocks


@pytest.mark.parametrize("args,match", [
    ((4, 100, 96, 4), "at most 64 tokens"),
    ((0, 64, 96, 4), "at least one window"),
    ((4, 64, 100, 4), "no multiple of 8"),
    ((4, 64, 96, 2), "head dims"),        # hd 48
    ((4, 64, 64, 8), "head dims"),        # hd 8
    ((4, 64, 1024, 8), "head dims"),      # hd 128
    ((4, 64, 72, 3), "no multiple of 48"),  # hd 24, but 1.5 head groups
])
def test_plan_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        k2.amp_plan(*args)


def _inputs(rng, c, nh, windows, window=8):
    n = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    weights = (n(3 * c, c, sc=0.05), n(3 * c, sc=0.02), n(c, c, sc=0.05), n(c, sc=0.02),
               n((2 * window - 1) ** 2, nh, sc=0.02))
    return weights, n(windows, window * window, c, sc=0.5)


def _pad64(t: torch.Tensor, n: int, key_fill: float) -> torch.Tensor:
    out = torch.nn.functional.pad(t, (0, 64 - n, 0, 64 - n))
    out[..., n:] = key_fill
    return out


def _kernel_replay(y, wqkv, bqkv, wproj, bproj, bias, mask, nh, mxu_dtype=BF16):
    """The kernel's work in plain torch, unit by unit in its order, with the
    arguments of ``window_attention.attention_f32`` (bias ``[nh, n, n]``,
    mask ``[nW, n, n]`` or None; window w takes mask w % nW): returns the
    proj output, f32 ``[W, n, C]``."""
    assert mxu_dtype == BF16
    wn, n, c = y.shape
    plan = k2.amp_plan(wn, n, c, nh)
    heads, hd = plan.heads_per_block, c // nh
    nq, pairs, groups = plan.n_cols // 3, plan.grid[0], plan.grid[1]
    kp = -(-c // 64) * 64  # K steps of 64, the last zero-filled past C
    # x as the TMA boxes deliver it: bf16, rows past n and a missing window 0
    x = torch.zeros(2 * pairs, 64, kp)
    x[:wn, :n, :c] = y.to(BF16).float()
    w = torch.zeros(3 * c, kp)
    w[:, :c] = wqkv.to(BF16).float()
    bias64 = _pad64(bias, n, float("-inf"))
    mask64 = _pad64(mask, n, 0.0) if mask is not None else None
    scale = q_scale(c, nh, y.device)
    att = torch.zeros(wn, n, c)
    for u in range(pairs * groups):
        pair, group = divmod(u, groups)
        cols = torch.cat([torch.arange(seg * c + group * nq, seg * c + (group + 1) * nq)
                          for seg in range(3)])  # the unit's q, k, v rows of wqkv
        for window in (2 * pair, 2 * pair + 1):
            acc = torch.zeros(64, 3 * nq)
            for k0 in range(0, kp, 64):
                acc += x[window, :, k0:k0 + 64] @ w[cols, k0:k0 + 64].t()
            qkv = ((acc + bqkv[cols]) * scale[cols]).to(BF16).float()
            for hh in range(heads):
                h = group * heads + hh
                q, k, v = (qkv[:, seg * nq + hh * hd:seg * nq + (hh + 1) * hd] for seg in range(3))
                s = q @ k.t() + bias64[h]
                if mask64 is not None:
                    s = s + mask64[window % mask64.shape[0]]
                p = torch.softmax(s, dim=-1).to(BF16).float()
                if window < wn:
                    att[window, :, h * hd:(h + 1) * hd] = (p @ v)[:n].to(BF16).float()
    proj = att.reshape(-1, c) @ wproj.to(BF16).float().t() + bproj
    return proj.reshape(wn, n, c)


# (C, nh, windows, window, windows per image, shift, resolution)
REPLAY_CASES = {
    "tiny-l0-ragged-K": (96, 4, 8, 8, 4, 4, (16, 16)),     # hd 24, C = 96: K steps 64 + 32
    "tiny-l3-3-windows": (768, 32, 3, 8, 1, 0, (8, 8)),    # hd 24, 16 groups, a pair's window missing
    "tiny-l1-n49": (192, 8, 8, 7, 4, 3, (14, 14)),         # 7-wide windows: n = 49
    "base-l0": (128, 4, 4, 8, 4, 4, (16, 16)),             # hd 32
    "large-l0-odd": (256, 4, 5, 8, 1, 0, (8, 8)),          # hd 64, one head a group
    "test-config-hd16": (32, 2, 8, 8, 4, 4, (16, 16)),     # the test models' width
}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_kernel_replay_matches_plain_amp(rng, case):
    """The decomposition is exact: zero-filled K columns add nothing, -inf
    bias on padded keys gives them p = 0, padded rows and a missing window
    are dropped, and a unit's heads are the plain version's heads. Against
    ``window_attention_plain(..., bf16)``: the kernel sums each product in
    64-wide K steps, the plain version in one, so a stored bf16 q|k|v or
    attention value may round the other way (one bf16 ulp, 2^-8 of it,
    reaching the output through the proj): limits ``atol=2e-3`` and 2e-5 on
    the mean gap, as ``tests/test_torch_wide_plan.py`` holds K5's plan."""
    c, nh, windows, window, nw, shift, res = REPLAY_CASES[case]
    weights, x = _inputs(rng, c, nh, windows, window)
    args = (x, *weights, nh, window, nw, shift, res)
    bias, mask = k2.bias_and_mask(weights[4], window, shift, res)
    got = _kernel_replay(x, *weights[:4], bias, mask, nh)
    ref = k2.window_attention_plain(*args, BF16)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-3)
    assert float((got - ref).abs().mean()) < 2e-5


def test_padded_bias_and_mask_are_the_kernels_tiles(rng):
    """The wrappers' padded tiles equal the replay's: -inf in key columns
    past n, 0 in padded rows elsewhere, the real [n, n] block unchanged."""
    weights, _ = _inputs(rng, 192, 8, 4, 7)
    bias, mask = k2.bias_and_mask(weights[4], 7, 3, (14, 14))
    bias64, mask64 = k2.padded_bias_and_mask(weights[4], 7, 3, (14, 14))
    assert bias64.shape == (8, 64, 64) and mask64.shape == (4, 64, 64)
    assert torch.equal(bias64, _pad64(bias, 49, float("-inf")))
    assert torch.equal(mask64, _pad64(mask, 49, 0.0))
    assert bool(torch.isinf(bias64[:, :, 49:]).all()) and not bool(bias64[:, 49:, :49].any())


def _jax_weights(weights):
    """The port's nn.Linear-layout weights as the JAX kernels take them."""
    wqkv, bqkv, wproj, bproj, table = (t.numpy() for t in weights)
    return wqkv.T, bqkv, wproj.T, bproj, table


# The JAX AMP kernels (interpret mode) round x, the weights, q|k|v and p to
# bf16 at the same places. They run with ARPU_ATTN_HG=1, the JAX package's
# own switch (ops/pallas/common.py::pick_head_group) to its per-head softmax:
# by default, at nh <= 16, its AMP kernels pack 2-4 heads into one softmax
# with a shared max and a 1e-30 floor on the denominator, a TPU-only
# deviation that the port does not carry (measured here: it alone moves the
# mean gap to 6-7e-5 for K2 and 4-7e-4 for K4, the level of an f32 block).
# XLA and PyTorch sum each product in other orders, so a few stored bf16
# values round the other way (one bf16 ulp, 2^-8 of a value) and carry
# through the proj (and K4's chain of products). Measured at these inputs:
# max gap 1.7e-4 (K2) and 2.9e-3 (K4), mean at most 1.3e-6 and 1.3e-5:
# limits atol 1e-3 / 5e-3 and 1e-5 / 5e-5 on the mean, the latter as
# tests/test_torch_swin_amp_plan.py holds K4's AMP plan to the JAX twin.
K2_JAX = dict(atol=1e-3, mean=1e-5)
K4_JAX = dict(atol=5e-3, mean=5e-5)


@pytest.mark.parametrize("c,nh,shift", [(96, 4, 4), (768, 32, 0), (128, 4, 4)],
                         ids=["tiny-l0", "tiny-l3", "base-l0"])
def test_kernel_replay_matches_jax_window_attention(rng, monkeypatch, c, nh, shift):
    """The AMP route against the JAX ``fused_window_attention(mxu_dtype=
    bf16)`` on f32 x, so that both keep the f32 output the comparison
    reads (the products round x to bf16 in both)."""
    monkeypatch.setenv("ARPU_ATTN_HG", "1")
    nw, res = (4, (16, 16)) if shift else (1, (8, 8))
    weights, x = _inputs(rng, c, nh, 2 * nw)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k2.fused_window_attention(
            jnp.asarray(x.numpy()), *_jax_weights(weights), nh, 8, nw, shift, res, jnp.bfloat16))
    bias, mask = k2.bias_and_mask(weights[4], 8, shift, res)
    got = _kernel_replay(x, *weights[:4], bias, mask, nh).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=K2_JAX["atol"])
    assert float(np.abs(got - ref).mean()) < K2_JAX["mean"]


@pytest.mark.parametrize("use_res,dffn", [(False, False), (True, True)])
@pytest.mark.parametrize("shift", [0, 4])
def test_kernel_replay_in_the_block_matches_jax_swin_block(rng, monkeypatch, shift, use_res,
                                                          dffn):
    """K4 under AMP at HTSAT-tiny's layer-0 width with its attention half
    replaced by the kernel's replay, against the JAX ``fused_swin_block(
    mxu_dtype=bf16)``, on an f32 block input (as layers 1-2 get it), so
    that both keep the f32 output the comparison reads."""
    monkeypatch.setenv("ARPU_ATTN_HG", "1")
    c, nh, nw, res = 96, 4, 4, (16, 16)
    weights, x = _inputs(rng, c, nh, 2 * nw)

    def t(*s, sc=1.0, off=0.0):
        return torch.from_numpy((off + rng.standard_normal(s) * sc).astype(np.float32))

    n1s, n1b, n2s, n2b = t(c, sc=0.1, off=1.0), t(c, sc=0.1), t(c, sc=0.1, off=1.0), t(c, sc=0.1)
    wfc1, bfc1, wfc2, bfc2 = t(4 * c, c, sc=0.05), t(4 * c, sc=0.02), t(c, 4 * c, sc=0.05), t(
        c, sc=0.02)
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res_p = (torch.from_numpy(q.astype(np.float32)), t(c, sc=0.01), t(c, sc=0.1, off=1.0))
    wqkv, bqkv, wproj, bproj, table = weights
    flat = (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2, table)
    flat = flat + (res_p if use_res else ())
    jflat = tuple(jnp.asarray(p.numpy().T if p.ndim == 2 and i in (2, 4, 8, 10) else p.numpy())
                  for i, p in enumerate(flat))
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k4.fused_swin_block(jnp.asarray(x.numpy()), jflat, nh, 8, nw, shift,
                                               res, use_res, dffn, jnp.bfloat16))
    with mock.patch.object(t_k4, "attention_f32", _kernel_replay):
        got = t_k4.swin_block_plain(x, flat, nh, 8, nw, shift, res, use_res, dffn, BF16)
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=K4_JAX["atol"])
    assert float(np.abs(got - ref).mean()) < K4_JAX["mean"]
