"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the wrappers' refusals. Skipped without a card.

This file imports neither JAX nor the JAX package, so on a machine with a
card and no JAX it runs alone, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import collections
import dataclasses
import unittest.mock as mock

import numpy as np
import pytest
import torch

from audio_residual_tpu_torch.models import htsat as t_htsat
from audio_residual_tpu_torch.ops import frontend as fe
from audio_residual_tpu_torch.ops.cuda import build, launch_counts
from audio_residual_tpu_torch.ops.cuda import frontend as k1
from audio_residual_tpu_torch.ops.cuda import gemm as kg
from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
from audio_residual_tpu_torch.ops.cuda import swin_block as k4
from audio_residual_tpu_torch.ops.cuda import wide_attention as k5
from audio_residual_tpu_torch.ops.cuda import window_attention as k2
from audio_residual_tpu_torch.utils.profiling import annotate, device_events

from . import torch_f64_reference as f64
from . import torch_port_fixture as fx
from .torch_threads import one_cpu_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, c=96, nh=4, g=4, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    h = 4 * c
    flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=0.05),
            t(3 * c, scale=0.02), t(c, c, scale=0.05), t(c, scale=0.02),
            t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(h, c, scale=0.05), t(h, scale=0.02),
            t(c, h, scale=0.05), t(c, scale=0.02), t(225, nh, scale=0.02))
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res = (torch.from_numpy(q.astype(np.float32)).to(dev), t(c, scale=0.01),
           t(c, scale=0.1, offset=1.0))
    return flat, res, t(2 * g, 64, c, scale=0.5), t(2, 48000, scale=0.1)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("mode,md,tol", [("f32", None, 1e-4), ("bf16", torch.bfloat16, 2e-2)])
def test_kernels_match_plain_on_card(dev, mode, md, tol):
    """max |kernel - plain| / max |plain| within 1e-4 (f32, sums in another
    order) / 2e-2 (bf16: one bf16 ulp is 3.9e-3 of a value, and a flip of
    one stored element reaches that)."""
    flat, res, x, wav = _inputs(dev)
    nh, g, c = 4, 4, x.shape[-1]
    launch_counts.clear()
    with torch.no_grad():
        cfg = fe.FrontendConfig()
        assert _rel(k1.fused_logmel(wav, cfg, mode), k1.logmel_plain(wav, cfg, mode)) < tol
        args = (x, *flat[2:6], flat[12], nh, 8, g, 4, (16, 16), md)
        assert _rel(k2.fused_window_attention(*args), k2.window_attention_plain(*args)) < tol
        ffn = (x.reshape(-1, c), x.reshape(-1, c) * 0.1, *flat[6:12],
               dict(zip(("basis", "mean", "lam"), res)))
        assert _rel(k3.fused_residual_ffn(*ffn, double_ffn=True, mxu_dtype=md),
                    k3.residual_ffn_plain(*ffn, double_ffn=True, mxu_dtype=md)) < tol
        for xin in (x, x.to(md or torch.float32)):
            blk = (xin, flat + res, nh, 8, g, 4, (16, 16), True, True, md)
            out = k4.fused_swin_block(*blk)
            assert out.dtype == (xin.dtype if md is not None else torch.float32)
            assert _rel(out, k4.swin_block_plain(*blk)) < tol
    assert dict(launch_counts) == {"fused_logmel": 1, "fused_window_attention": 1,
                                   "fused_residual_ffn": 1, "fused_swin_block": 2}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    flat, res, x, wav = _inputs(dev, c=32, nh=2)
    blk = (flat, 2, 8, 4, 0, (16, 16), False, False)
    # a raw kernel entry refuses an input that requires grad; the wrapper
    # takes its autograd entry for one
    with pytest.raises(RuntimeError, match="requires grad"):
        k4._kernel(x.clone().requires_grad_(True), *blk, None)
    with pytest.raises(ValueError, match="on cpu"):
        k4.fused_swin_block(x, (flat[0].cpu(),) + flat[1:], *blk[1:])
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_logmel(wav[:, ::2], fe.FrontendConfig())
    with pytest.raises(TypeError, match="dtype"):
        k1.fused_logmel(wav.double(), fe.FrontendConfig())
    with pytest.raises(ValueError, match="windows of at most 64 tokens"):
        k2.fused_window_attention(torch.zeros(4, 100, 32, device=dev), *flat[2:6],
                                  torch.zeros(361, 2, device=dev), 2, 10, 1, 0, (10, 10))


def _ffn_inputs(dev, rows, c, seed=2):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    h = 4 * c
    weights = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(h, c, scale=c ** -0.5),
               t(h, scale=0.02), t(c, h, scale=h ** -0.5), t(c, scale=0.02))
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    rp = {"basis": torch.from_numpy(q.astype(np.float32)).to(dev), "mean": t(c, scale=0.01),
          "lam": t(c, scale=0.1, offset=1.0)}
    return t(rows, c, scale=0.5), t(rows, c, scale=0.1), weights, rp


FFN_VARIANTS = {"plain": (False, False), "residual": (True, False), "double-ffn": (True, True)}


@pytest.mark.parametrize("variant", list(FFN_VARIANTS))
@pytest.mark.parametrize("rows,c", [
    (128, 768), (128, 1024), (128, 2048),  # HTSAT-tiny, -base, -large layer 3 at B=2
    (512, 1024),                           # HTSAT-large layer 2 at B=2
    (64, 768), (192, 1024),                # ragged: half a 128-row tile, one and a half
    (512, 96), (128, 64),                  # the test widths: clusters of one
])
def test_residual_ffn_amp_matches_plain_on_card(dev, rows, c, variant):
    """K3's AMP kernel (one clustered launch per FFN pass) against its plain
    version, f32 and bf16 x (a in the same dtype, as K2 and K5 hand it):
    max |kernel - plain| / max |plain| within 2e-2 (a bf16 output's ulp is
    3.9e-3 of a value; the sums run in another order)."""
    use_res, dffn = FFN_VARIANTS[variant]
    x, a, weights, rp = _ffn_inputs(dev, rows, c)
    launch_counts.clear()
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            args = (x.to(dt), a.to(dt), *weights, rp if use_res else None)
            got = k3.fused_residual_ffn(*args, double_ffn=dffn, mxu_dtype=torch.bfloat16)
            ref = k3.residual_ffn_plain(*args, double_ffn=dffn, mxu_dtype=torch.bfloat16)
            assert got.dtype == ref.dtype == dt and got.shape == ref.shape
            assert bool(torch.isfinite(got.float()).all())
            assert _rel(got, ref) < 2e-2
    assert dict(launch_counts) == {"fused_residual_ffn": 2}


@pytest.mark.parametrize("variant", list(FFN_VARIANTS))
def test_residual_ffn_amp_is_one_launch_a_pass(dev, variant):
    """By the profiler's kernel names: one ffn_cluster_kernel a pass (two
    with the double FFN), the ResiDual's two products on the 3xTF32 GEMM
    (f32 in both modes) with a ResiDual, and nothing else -- no
    add_layernorm_kernel, no bf16 GEMM."""
    from torch.profiler import ProfilerActivity, profile

    use_res, dffn = FFN_VARIANTS[variant]
    x, a, weights, rp = _ffn_inputs(dev, 256, 768)
    args = (x, a, *weights, rp if use_res else None)
    with torch.no_grad():
        k3.fused_residual_ffn(*args, double_ffn=dffn, mxu_dtype=torch.bfloat16)  # bf16 copies
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            k3.fused_residual_ffn(*args, double_ffn=dffn, mxu_dtype=torch.bfloat16)
            torch.cuda.synchronize()
    names = [e.name for e in device_events(prof)]
    passes = 2 if dffn else 1
    want = {"ffn_cluster_kernel": passes, "gemm_tf32x3_kernel": 2 if use_res else 0}
    assert _port_kernels(names) == +collections.Counter(want), names
    assert len(names) == passes + (2 if use_res else 0), names


def test_device_events_leave_out_the_spans_on_card(dev):
    """A span recorded with CUDA activity comes back as a device event named
    as the span; :func:`device_events` keeps the kernels and drops it, so the
    census and busy time of ``device_profile`` read kernels only."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256, device=dev, dtype=torch.bfloat16)
    kg.gemm(a, a)
    for _ in range(3):  # a window now and then comes back without device events
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with annotate("htsat.layer", 0):
                kg.gemm(a, a)
            torch.cuda.synchronize()
        names = [e.name for e in device_events(prof)]
        if names:
            break
    raw = [(e.name, e.device_type, e.is_user_annotation) for e in prof.events()]
    assert any("gemm_kernel" in n for n in names), raw
    assert not {"htsat.layer0", "kernel.gemm"} & set(names), raw


def test_residual_ffn_amp_gives_equal_bits_twice(dev):
    """The reduction order is fixed: two calls give the same bits."""
    x, a, weights, rp = _ffn_inputs(dev, 192, 1024)
    with torch.no_grad():
        for args in ((x, a, *weights, None), (x.bfloat16(), a.bfloat16(), *weights, rp)):
            one = k3.fused_residual_ffn(*args, double_ffn=True, mxu_dtype=torch.bfloat16)
            two = k3.fused_residual_ffn(*args, double_ffn=True, mxu_dtype=torch.bfloat16)
            assert torch.equal(one, two)


def test_residual_ffn_amp_refuses_a_shape_without_a_plan(dev):
    x, a, weights, _ = _ffn_inputs(dev, 128, 32)
    with pytest.raises(ValueError, match="no AMP plan"):
        k3.fused_residual_ffn(x, a, *weights, mxu_dtype=torch.bfloat16)
    # the golden route takes it
    with torch.no_grad():
        assert _rel(k3.fused_residual_ffn(x, a, *weights),
                    k3.residual_ffn_plain(x, a, *weights)) < 1e-4


def _wide_inputs(dev, c, nh, windows, seed=1, window=8):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    weights = (t(3 * c, c, scale=0.02), t(3 * c, scale=0.02), t(c, c, scale=0.02),
               t(c, scale=0.02), t((2 * window - 1) ** 2, nh, scale=0.02))
    return weights, t(windows, window * window, c, scale=0.5)


@pytest.mark.parametrize("mode,md,tol", [("f32", None, 1e-4), ("bf16", torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("c,nh,nw,shift,res,windows,window", [
    (1024, 16, 4, 4, (16, 16), 8, 8),   # HTSAT-large layer 2: hd 64, SW-MSA mask
    (1024, 32, 1, 0, (8, 8), 2, 8),     # HTSAT-base layer 3: hd 32, one window per clip
    (2048, 32, 1, 0, (8, 8), 2, 8),     # HTSAT-large layer 3: C=2048, hd 64
    (1024, 32, 1, 0, (8, 8), 3, 8),     # odd window counts: a pair's second window
    (1024, 16, 1, 0, (8, 8), 5, 8),     # missing
    (1024, 16, 4, 3, (14, 14), 8, 7),   # 7-wide windows: n = 49 < 64, shifted
], ids=["large-l2", "base-l3", "large-l3", "3-windows", "5-windows", "n49"])
def test_wide_attention_matches_plain_on_card(dev, mode, md, tol, c, nh, nw, shift, res,
                                              windows, window):
    """K5 against its plain version, f32 and bf16 inputs; the K2 entry
    point sends C >= 1024 to K5."""
    weights, x = _wide_inputs(dev, c, nh, windows, window=window)
    launch_counts.clear()
    with torch.no_grad():
        for xin in (x, x.to(md or torch.float32)):
            args = (xin, *weights, nh, window, nw, shift, res, md)
            out = k5.wide_window_attention(*args)
            assert out.dtype == (xin.dtype if md is not None else torch.float32)
            assert _rel(out, k5.wide_attention_plain(*args)) < tol
        assert _rel(k2.fused_window_attention(*args), k5.wide_attention_plain(*args)) < tol
    assert dict(launch_counts) == {"wide_window_attention": 3}


def test_wide_wrapper_refuses_what_the_kernel_does_not_take(dev):
    weights, x = _wide_inputs(dev, 1024, 16, 4)
    rest = (16, 8, 4, 0, (16, 16))
    with pytest.raises(ValueError, match="on cpu"):
        k5.wide_window_attention(x, weights[0].cpu(), *weights[1:], *rest)
    with pytest.raises(ValueError, match="contiguous"):
        k5.wide_window_attention(x.transpose(0, 1).contiguous().transpose(0, 1), *weights,
                                 *rest)
    with pytest.raises(ValueError, match="hd <= 64"):
        k5.wide_window_attention(x, *weights[:4], torch.zeros(225, 8, device=dev), 8,
                                 *rest[1:])
    # C = 1056 with 33 heads of 32: the golden kernel takes it, the AMP one
    # (64-column head groups) does not
    weights, x = _wide_inputs(dev, 1056, 33, 2)
    with pytest.raises(ValueError, match="no multiple of 64"):
        k5.wide_window_attention(x, *weights, 33, 8, 1, 0, (8, 8), torch.bfloat16)


# (M, N, K) of the AMP GEMMs on the main paths at B=2 (M ragged against the
# 128-row tile where the path's R is a multiple of it): K4 qkv/proj/fc1/fc2
# at HTSAT-tiny C=96 and HTSAT-base C=128, 384 and 512; K2 qkv at C=768;
# K5's proj at 1024; and fc1/fc2 products at C=768 and 1024 (N and K up to
# 4096).
GEMM_SHAPES = [(8192 - 64, 288, 96), (8192 - 64, 96, 96), (8192 - 64, 384, 96),
               (8192 - 64, 96, 384), (8192 - 64, 128, 128), (2048 + 64, 1536, 384),
               (2048 + 64, 384, 1536), (512 + 64, 512, 512), (128 + 64, 2304, 768),
               (128, 3072, 768), (128, 768, 3072), (128, 1024, 1024), (128, 4096, 1024),
               (128, 1024, 4096)]
EPILOGUES = {"qkv": dict(bias=True, col_scale=True, out=torch.bfloat16),
             "fc1": dict(bias=True, gelu=True, out=torch.bfloat16),
             "proj+x": dict(bias=True, r1=torch.bfloat16, out=torch.float32),
             "fc2+h1+x": dict(bias=True, r1=torch.float32, r2=torch.bfloat16,
                              out=torch.float32),
             "fc2+h1 bf16 out": dict(bias=True, r1=torch.float32, out=torch.bfloat16)}


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_matches_plain_on_card(dev, m, n, k, epilogue):
    """The TMA + wgmma GEMM against ``gemm_plain`` (f32 matmul of the same
    bf16 operands): max |kernel - plain| / max |plain| within 1e-2 for a
    bf16 output (one bf16 ulp is 3.9e-3 of a value) and 1e-4 for f32 (sums
    in another order)."""
    e = EPILOGUES[epilogue]
    rng = np.random.default_rng(m + n + k)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    args = dict(bias=t(n, scale=0.1), col_scale=(1 + t(n, scale=0.2)) if "col_scale" in e else None,
                gelu=e.get("gelu", False),
                r1=t(m, n).to(e["r1"]) if "r1" in e else None,
                r2=t(m, n).to(e["r2"]) if "r2" in e else None, out_dtype=e["out"])
    a, w = t(m, k).bfloat16(), t(n, k, scale=k ** -0.5).bfloat16()
    launch_counts.clear()
    with torch.no_grad():
        got = kg.gemm(a, w, **args)
        torch.cuda.synchronize()
    ref = kg.gemm_plain(a, w, **args)
    assert got.dtype == e["out"] and got.shape == (m, n)
    assert _rel(got, ref) < (1e-2 if e["out"] == torch.bfloat16 else 1e-4)
    assert dict(launch_counts) == {"gemm": 1}


def test_gemm_refuses_what_it_does_not_take(dev):
    a = torch.zeros(64, 96, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        kg.gemm(a.float(), a)
    with pytest.raises(ValueError, match="multiples of 8"):
        kg.gemm(a[:, :90].contiguous(), a[:, :90].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kg.gemm(a.t().contiguous().t(), a)


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_amp_matches_plain_on_card(dev, shift):
    """K4 under AMP (bf16 intermediates, TMA + wgmma GEMM) at HTSAT-tiny's
    layer-0 width with ResiDual and the double FFN, bf16 and f32 input."""
    flat, res, x, _ = _inputs(dev)
    launch_counts.clear()
    with torch.no_grad():
        for xin in (x.bfloat16(), x):
            blk = (xin, flat + res, 4, 8, 4, shift, (16, 16), True, True, torch.bfloat16)
            out = k4.fused_swin_block(*blk)
            assert out.dtype == xin.dtype
            assert _rel(out, k4.swin_block_plain(*blk)) < 2e-2
    assert dict(launch_counts) == {"fused_swin_block": 2}


# (C, nh, windows per clip, resolution) of every K2/K4 layer of the shipped
# HTSAT configs: tiny layers 0-3 (hd 24), base layers 0-2 (hd 32), large
# layers 0-1 (hd 64)
WINDOW_LAYERS = {"tiny-l0": (96, 4, 64, (64, 64)), "tiny-l1": (192, 8, 16, (32, 32)),
                 "tiny-l2": (384, 16, 4, (16, 16)), "tiny-l3": (768, 32, 1, (8, 8)),
                 "base-l0": (128, 4, 64, (64, 64)), "base-l1": (256, 8, 16, (32, 32)),
                 "base-l2": (512, 16, 4, (16, 16)), "large-l0": (256, 4, 64, (64, 64)),
                 "large-l1": (512, 8, 16, (32, 32))}


def _block_of(dev, c, nh, windows, window=8, seed=5):
    """K4's flat params with a ResiDual, and x [windows, window^2, C]."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        a = (offset + scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    h = 4 * c
    flat = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(3 * c, c, scale=0.05),
            t(3 * c, scale=0.02), t(c, c, scale=0.05), t(c, scale=0.02),
            t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(h, c, scale=0.05), t(h, scale=0.02),
            t(c, h, scale=0.05), t(c, scale=0.02), t((2 * window - 1) ** 2, nh, scale=0.02))
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res = (torch.from_numpy(q.astype(np.float32)).to(dev), t(c, scale=0.01),
           t(c, scale=0.1, offset=1.0))
    return flat, res, t(windows, window * window, c, scale=0.5)


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("layer", list(WINDOW_LAYERS))
def test_window_attention_amp_matches_plain_on_card(dev, layer, shift):
    """K2 and K4 under AMP (the qkv + attention kernel, then the proj GEMM)
    against their plain versions at every shipped K2/K4 shape, B = 2, bf16
    and f32 input, K4 without and with ResiDual + the double FFN: max
    |kernel - plain| / max |plain| within 2e-2 (one bf16 ulp is 3.9e-3 of a
    value, and a flip of one stored element reaches that)."""
    c, nh, nw, res = WINDOW_LAYERS[layer]
    flat, rp, x = _block_of(dev, c, nh, 2 * nw)
    launch_counts.clear()
    with torch.no_grad():
        for xin in (x, x.bfloat16()):
            args = (xin, *flat[2:6], flat[12], nh, 8, nw, shift, res, torch.bfloat16)
            out = k2.fused_window_attention(*args)
            assert out.dtype == xin.dtype and bool(torch.isfinite(out.float()).all())
            assert _rel(out, k2.window_attention_plain(*args)) < 2e-2
            for use_res in (False, True):
                blk = (xin, flat + (rp if use_res else ()), nh, 8, nw, shift, res, use_res,
                       use_res, torch.bfloat16)
                out = k4.fused_swin_block(*blk)
                assert out.dtype == xin.dtype and bool(torch.isfinite(out.float()).all())
                assert _rel(out, k4.swin_block_plain(*blk)) < 2e-2
    assert dict(launch_counts) == {"fused_window_attention": 2, "fused_swin_block": 4}


@pytest.mark.parametrize("c,nh,windows,window,nw,shift,res", [
    (96, 4, 8, 7, 4, 3, (14, 14)),     # 7-wide windows: n = 49 < 64, shifted, hd 24
    (768, 32, 3, 8, 1, 0, (8, 8)),     # 3 windows: a pair's second window missing
    (128, 4, 5, 8, 1, 0, (8, 8)),      # 5 windows at hd 32
], ids=["n49", "3-windows", "5-windows"])
def test_window_attention_amp_at_the_edges_on_card(dev, c, nh, windows, window, nw, shift, res):
    """Rows past n are computed and not stored; a missing window is
    zero-filled and not stored."""
    flat, rp, x = _block_of(dev, c, nh, windows, window=window)
    with torch.no_grad():
        args = (x, *flat[2:6], flat[12], nh, window, nw, shift, res, torch.bfloat16)
        assert _rel(k2.fused_window_attention(*args), k2.window_attention_plain(*args)) < 2e-2
        blk = (x, flat + rp, nh, window, nw, shift, res, True, True, torch.bfloat16)
        assert _rel(k4.fused_swin_block(*blk), k4.swin_block_plain(*blk)) < 2e-2


PORT_KERNELS = ("gemm_tf32x3_kernel", "gemm_kernel", "attention_core_kernel",
                "add_layernorm_kernel", "window_attention_wgmma_kernel", "ffn_cluster_kernel",
                "logmel_tf32x3_kernel", "logmel_wgmma_kernel")


def _port_kernels(names) -> collections.Counter:
    """The port's kernels among the profiler's ``names``, by role; any other
    kernel of the port (namespace ``arpu``) under its full name. An exact
    count shows that no other kernel of the port ran."""
    out = collections.Counter()
    for name in names:
        key = next((k for k in PORT_KERNELS if f"{k}<" in name or f"{k}(" in name), None)
        if key is not None or "arpu::" in name:
            out[key or name] += 1
    return out


def _device_kernels(fn, expect=lambda names: True) -> list:
    """The names of the kernels ``fn()`` ran, by the profiler. A window now
    and then drops the records of its first kernels, one or more, so eight
    marker kernels run first -- int16 fills, which no call under test
    launches -- and are left out by their name, recorded or not; and up to
    three windows are taken until one holds device events and meets
    ``expect(names)`` (the test's own assertion then reads that window). A
    kernel the call does not launch is in no window."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1, dtype=torch.int16, device="cuda")
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                marker.fill_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.name) for e in device_events(prof)
                       if "FillFunctor<short>" not in e.name)
        if spans and expect([name for _, name in spans]):
            break
    return [name for _, name in spans]


def test_window_attention_amp_is_one_kernel_and_the_proj_gemm(dev):
    """By the profiler's kernel names: a K2 AMP call on bf16 x is one
    window_attention_wgmma_kernel and one bf16 GEMM (the proj), nothing
    else; K4's AMP call runs the same kernel once; no attention_core_kernel
    under AMP, where the golden route still runs it."""
    c, nh, nw, res = WINDOW_LAYERS["tiny-l3"]
    flat, rp, x = _block_of(dev, c, nh, 2 * nw)
    args = (x.bfloat16(), *flat[2:6], flat[12], nh, 8, nw, 0, res, torch.bfloat16)
    blk = (x.bfloat16(), flat + rp, nh, 8, nw, 0, res, True, True, torch.bfloat16)
    with torch.no_grad():
        k2.fused_window_attention(*args), k4.fused_swin_block(*blk)  # bf16 copies, maps
        names = _device_kernels(lambda: k2.fused_window_attention(*args), lambda n: (
            len(n) == 2 and _port_kernels(n) == {"window_attention_wgmma_kernel": 1,
                                                 "gemm_kernel": 1}))
        assert len(names) == 2, names
        assert sum("window_attention_wgmma_kernel" in n for n in names) == 1, names
        assert sum("gemm_kernel<" in n for n in names) == 1, names
        names = _device_kernels(lambda: k4.fused_swin_block(*blk), lambda n: (
            _port_kernels(n)["window_attention_wgmma_kernel"] == 1
            and _port_kernels(n)["gemm_tf32x3_kernel"] == 2))
        assert sum("window_attention_wgmma_kernel" in n for n in names) == 1, names
        assert not any("attention_core_kernel" in n for n in names), names
        # the ResiDual's two products are f32 under AMP too: 3xTF32
        assert sum("gemm_tf32x3_kernel" in n for n in names) == 2, "\n".join(names)
        golden = _device_kernels(lambda: k2.fused_window_attention(*args[:-1]),
                                 lambda n: _port_kernels(n)["attention_core_kernel"] == 1)
        assert sum("attention_core_kernel" in n for n in golden) == 1, golden
        assert not any("window_attention_wgmma_kernel" in n for n in golden), golden


def test_window_attention_amp_gives_equal_bits_twice(dev):
    """The kernel's reduction order is fixed: two calls give the same bits."""
    c, nh, nw, res = WINDOW_LAYERS["tiny-l0"]
    flat, rp, x = _block_of(dev, c, nh, nw)
    with torch.no_grad():
        args = (x, *flat[2:6], flat[12], nh, 8, nw, 4, res, torch.bfloat16)
        assert torch.equal(k2.fused_window_attention(*args), k2.fused_window_attention(*args))
        blk = (x.bfloat16(), flat + rp, nh, 8, nw, 4, res, True, True, torch.bfloat16)
        assert torch.equal(k4.fused_swin_block(*blk), k4.fused_swin_block(*blk))


def test_window_attention_amp_refuses_a_head_dim_without_a_plan(dev):
    """hd 48 (C = 96, 2 heads): the AMP route raises before any launch; the
    golden route takes it."""
    flat, _, x = _block_of(dev, 96, 2, 4)
    args = (x, *flat[2:6], flat[12], 2, 8, 4, 0, (16, 16))
    launch_counts.clear()
    with torch.no_grad():
        with pytest.raises(ValueError, match="head dims"):
            k2.fused_window_attention(*args, torch.bfloat16)
        with pytest.raises(ValueError, match="head dims"):
            k4.fused_swin_block(x, flat, 2, 8, 4, 0, (16, 16), False, False, torch.bfloat16)
        assert dict(launch_counts) == {}
        assert _rel(k2.fused_window_attention(*args), k2.window_attention_plain(*args)) < 1e-4


WIN_1536 = fe.FrontendConfig(n_fft=1536, win_length=1536)  # HTSAT-tiny-win-1536's frontend


@pytest.mark.parametrize("cfg", [fe.FrontendConfig(), WIN_1536, fe.FrontendConfig(n_mels=16)],
                         ids=["n_fft=1024", "n_fft=1536", "n_mels=16"])
@pytest.mark.parametrize("b,t", [(1, 48000), (3, 100000), (1, 240000), (2, 480000)])
def test_logmel_amp_matches_plain_on_card(dev, cfg, b, t):
    """K1's AMP route (bf16 DFT on wgmma) within 0.05 dB of the plain bf16
    version at ragged frame counts (nf = 209 at 100 000 samples is no
    multiple of the 128-frame tile); n_mels < 64 takes the kernel's masked
    stores (the test models' 16 bands)."""
    wav = torch.from_numpy(
        (np.random.default_rng(t).standard_normal((b, t)) * 0.1).astype(np.float32)).to(dev)
    launch_counts.clear()
    with torch.no_grad():
        got = k1.fused_logmel(wav, cfg, "bf16")
        ref = k1.logmel_plain(wav, cfg, "bf16")
    assert got.shape == ref.shape == (b, cfg.num_frames(t), cfg.n_mels)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 0.05
    assert dict(launch_counts) == {"fused_logmel": 1}


def test_logmel_amp_gives_the_floor_on_silence(dev):
    cfg = fe.FrontendConfig()
    wav = torch.zeros(2, 48000, device=dev)
    with torch.no_grad():
        got, ref = k1.fused_logmel(wav, cfg, "bf16"), k1.logmel_plain(wav, cfg, "bf16")
    assert torch.equal(got, ref)
    assert torch.equal(got, torch.full_like(got, float(ref.flatten()[0])))


def test_logmel_amp_refuses_a_misaligned_config(dev):
    wav = torch.zeros(1, 48000, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        k1.fused_logmel(wav, fe.FrontendConfig(hop_length=476), "bf16")
    with pytest.raises(ValueError, match="multiple of 64"):
        k1.fused_logmel(wav, fe.FrontendConfig(n_fft=1000, win_length=1000), "bf16")


def _forward_logmel(cfg, compute_dtype, dev):
    """``(dft mode, log-mel)`` that one ``htsat_apply`` gave K1 on the card."""
    model = t_htsat.HTSAT(cfg).to(dev)
    wav = np.random.default_rng(0).standard_normal((2, cfg.clip_samples)) * 0.1
    wav = torch.from_numpy(wav.astype(np.float32)).to(dev)
    seen, real = {}, t_htsat.fused_logmel

    def capture(w, fcfg, dft_mode=None):
        seen["mode"], seen["logmel"] = dft_mode, real(w, fcfg, dft_mode)
        return seen["logmel"]

    with mock.patch.object(t_htsat, "fused_logmel", capture), torch.no_grad():
        t_htsat.htsat_apply(model, wav, compute_dtype=compute_dtype)
    return seen["mode"], seen["logmel"]


@pytest.mark.parametrize("dft_mode,compute_dtype,other", [("f32", torch.bfloat16, None),
                                                          ("bf16", None, torch.bfloat16)])
def test_dft_mode_overrides_the_compute_dtype_on_card(dev, dft_mode, compute_dtype, other):
    """``HTSATConfig.dft_mode`` on the card: an AMP forward with the f32 DFT
    takes K1's golden route and gives the golden forward's log-mel; a golden
    forward with the bf16 DFT gives the AMP forward's."""
    cfg = t_htsat.HTSATConfig(**fx.AUDIO_KW)
    mode, got = _forward_logmel(dataclasses.replace(cfg, dft_mode=dft_mode), compute_dtype, dev)
    assert mode == dft_mode
    assert torch.equal(got, _forward_logmel(cfg, other, dev)[1])


# the Swin layers of HTSAT-tiny and HTSAT-base: kernel, C, heads, windows a
# clip, resolution (K4 at layers 0-2; layer 3 is LN1, K2 or K5, then K3)
TRAIN_LAYERS = {
    "tiny-0": ("K4", 96, 4, 64, (64, 64)), "tiny-1": ("K4", 192, 8, 16, (32, 32)),
    "tiny-2": ("K4", 384, 16, 4, (16, 16)), "tiny-3-K2": ("K2", 768, 32, 1, (8, 8)),
    "tiny-3-K3": ("K3", 768, 32, 1, (8, 8)), "base-0": ("K4", 128, 4, 64, (64, 64)),
    "base-1": ("K4", 256, 8, 16, (32, 32)), "base-2": ("K4", 512, 16, 4, (16, 16)),
    "base-3-K5": ("K5", 1024, 32, 1, (8, 8)), "base-3-K3": ("K3", 1024, 32, 1, (8, 8)),
}
TRAIN_KERNELS = {"K2": ("fused_window_attention", k2.fused_window_attention,
                        k2.window_attention_plain),
                 "K3": ("fused_residual_ffn", k3.fused_residual_ffn, k3.residual_ffn_plain),
                 "K4": ("fused_swin_block", k4.fused_swin_block, k4.swin_block_plain),
                 "K5": ("wide_window_attention", k5.wide_window_attention,
                        k5.wide_attention_plain)}


@pytest.mark.parametrize("mode,md,tol", [("f32", None, 1e-4), ("bf16", torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layer", list(TRAIN_LAYERS))
def test_autograd_grads_match_plain_on_card(dev, layer, mode, md, tol):
    """Each kernel's wrapper in grad mode (the autograd entry: kernel
    forward, plain-version backward) against autograd through its plain
    version, at every K2-K5 layer shape of HTSAT-tiny and -base, two clips,
    with a ResiDual (λ requiring grad) where the kernel takes one and the
    double FFN at K4: the output and the grads of x, K3's ``a`` and λ within
    the kernel tests' bounds; the forward launched the kernel once, the
    backward none."""
    kernel, c, nh, nw, res = TRAIN_LAYERS[layer]
    name, wrapper, plain = TRAIN_KERNELS[kernel]
    flat, rp, _, _ = _inputs(dev, c=c, nh=nh)
    rng = np.random.default_rng(7)
    x = torch.from_numpy((0.5 * rng.standard_normal((2 * nw, 64, c))).astype(np.float32)).to(dev)
    if kernel == "K4" and md is not None and c in (96, 128):
        x = x.to(md)  # layer 0 carries bf16 activations under AMP
    x = x.requires_grad_(True)
    lam = rp[2].clone().requires_grad_(True)
    inputs = [x, lam]
    if kernel == "K4":
        def run(f):
            return f(x, flat + (rp[0], rp[1], lam), nh, 8, nw, 4 if nw > 1 else 0, res, True,
                     True, md)
    elif kernel == "K3":
        a = (0.1 * x.detach()).requires_grad_(True)
        inputs = [x, a, lam]

        def run(f):
            return f(x.reshape(-1, c), a.reshape(-1, c), *flat[6:12],
                     {"basis": rp[0], "mean": rp[1], "lam": lam}, double_ffn=True, mxu_dtype=md)
    else:
        inputs = [x]

        def run(f):
            return f(x, *flat[2:6], flat[12], nh, 8, nw, 0, res, md)
    launch_counts.clear()
    out = run(wrapper)
    assert dict(launch_counts) == {name: 1}
    cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32)).to(dev)
    launch_counts.clear()
    grads = torch.autograd.grad((out.float() * cot).sum(), inputs)
    torch.cuda.synchronize()
    assert not launch_counts, dict(launch_counts)
    ref = run(plain)
    ref_grads = torch.autograd.grad((ref.float() * cot).sum(), inputs)
    assert out.dtype == ref.dtype and _rel(out.detach(), ref.detach()) < tol
    for g, r in zip(grads, ref_grads):
        assert g.dtype == r.dtype and bool(torch.isfinite(g.float()).all())
        assert _rel(g, r) < tol


# contrastive training: every weight requires grad. Layer shapes as above:
# C, heads, windows a clip, resolution
WEIGHT_GRAD_LAYERS = {"tiny-0": (96, 4, 64, (64, 64)), "tiny-3": (768, 32, 1, (8, 8)),
                      "base-3": (1024, 32, 1, (8, 8))}


@pytest.mark.parametrize("mode,md,tol", [("f32", None, 1e-4), ("bf16", torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layer", list(WEIGHT_GRAD_LAYERS))
@pytest.mark.parametrize("kernel", ["K2", "K4"])
def test_weight_grads_through_recompute_on_card(dev, kernel, layer, mode, md, tol):
    """K2's and K4's wrappers with every weight requiring grad (qkv, proj,
    the relative-bias table; K4 also LN1, LN2, fc1, fc2) at HTSAT-tiny's
    layers 0 and 3 and HTSAT-base's layer 3 (K5, and K4's split plan there):
    every weight gets a gradient, each within the kernel tests' bounds of
    autograd through the plain version; the forward launches, the backward
    none."""
    c, nh, nw, res = WEIGHT_GRAD_LAYERS[layer]
    flat, _, _, _ = _inputs(dev, c=c, nh=nh)
    weights = [w.clone().requires_grad_(True) for w in flat]
    rng = np.random.default_rng(11)
    x = torch.from_numpy((0.5 * rng.standard_normal((2 * nw, 64, c))).astype(np.float32)).to(dev)
    if kernel == "K4" and md is not None and nw > 1:
        x = x.to(md)  # layer 0 carries bf16 activations under AMP
    x = x.requires_grad_(True)
    shift = 4 if nw > 1 else 0
    if kernel == "K4":
        inputs = [x, *weights]

        def run(f):
            return f(x, tuple(weights), nh, 8, nw, shift, res, False, False, md)
        wrapper, plain = k4.fused_swin_block, k4.swin_block_plain
    else:
        inputs = [x, *weights[2:6], weights[12]]

        def run(f):
            return f(x, *weights[2:6], weights[12], nh, 8, nw, shift, res, md)
        wrapper, plain = k2.fused_window_attention, k2.window_attention_plain
    launch_counts.clear()
    out = run(wrapper)
    assert launch_counts
    cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(np.float32)).to(dev)
    launch_counts.clear()
    grads = torch.autograd.grad((out.float() * cot).sum(), inputs)
    torch.cuda.synchronize()
    assert not launch_counts, dict(launch_counts)
    ref = run(plain)
    ref_grads = torch.autograd.grad((ref.float() * cot).sum(), inputs)
    assert _rel(out.detach(), ref.detach()) < tol
    for i, (g, r) in enumerate(zip(grads, ref_grads)):
        assert g is not None and bool(torch.isfinite(g.float()).all()), i
        assert _rel(g, r) < tol, i


@pytest.mark.parametrize("m,n,k,gelu,out", [(2464, 2304, 768, False, torch.float32),
                                             (2464, 3072, 768, True, torch.bfloat16),
                                             (2464, 768, 3072, False, torch.float32)])
def test_gemm_autograd_gives_the_plain_gradients_on_card(dev, m, n, k, gelu, out):
    """RoBERTa-base's AMP products at 32 texts of 77 tokens, every input
    requiring grad (a, the bf16 weight copy, bias, residual): the autograd
    entry's forward launches the kernel and its backward none; its
    gradients equal autograd's through the plain version (the same
    function of the same inputs: equal up to the order of CUDA's sums,
    max rel err 1e-6)."""
    g = torch.Generator(device=dev).manual_seed(m + n)
    a = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16).requires_grad_(True)
    w = (torch.randn(n, k, device=dev, generator=g) * 0.03).to(torch.bfloat16)
    w.requires_grad_(True)
    bias = (torch.randn(n, device=dev, generator=g) * 0.1).requires_grad_(True)
    r1 = torch.randn(m, n, device=dev, generator=g).requires_grad_(True) if not gelu else None
    inputs = [t for t in (a, w, bias, r1) if t is not None]
    cot = torch.randn(m, n, device=dev, generator=g)
    launch_counts.clear()
    y = kg.gemm(a, w, bias=bias, gelu=gelu, r1=r1, out_dtype=out)
    assert dict(launch_counts) == {"gemm": 1}
    launch_counts.clear()
    grads = torch.autograd.grad((y.float() * cot).sum(), inputs)
    torch.cuda.synchronize()
    assert not launch_counts
    ref = kg.gemm_plain(a, w, bias, None, gelu, r1, None, out)
    ref_grads = torch.autograd.grad((ref.float() * cot).sum(), inputs)
    assert _rel(y.detach(), ref.detach()) < 2e-2
    for gr, rg in zip(grads, ref_grads):
        assert gr.dtype == rg.dtype and _rel(gr, rg) < 1e-6


@pytest.mark.parametrize("wrapper", ["fused_window_attention", "wide_window_attention",
                                     "fused_residual_ffn", "fused_swin_block", "gemm"])
def test_a_graph_request_goes_through_recompute_on_card(dev, wrapper):
    """Each wrapper that ``autograd.route`` routes, golden (the bf16 GEMM in
    bf16): with an input that requires grad, in grad mode, its output comes
    from :class:`Recompute`, whose forward launches the kernel once; without
    one, from the kernel directly, with no graph."""
    flat, res, x, _ = _inputs(dev)
    wide, xw = _wide_inputs(dev, 1024, 32, 2)
    rows = x.reshape(-1, x.shape[-1])
    rp = dict(zip(("basis", "mean", "lam"), res))
    calls = {  # the input that requires grad or not, and the call on it
        "fused_window_attention": (x, lambda t: k2.fused_window_attention(
            t, *flat[2:6], flat[12], 4, 8, 4, 4, (16, 16))),
        "wide_window_attention": (xw, lambda t: k5.wide_window_attention(
            t, *wide, 32, 8, 1, 0, (8, 8))),
        "fused_residual_ffn": (rows, lambda t: k3.fused_residual_ffn(
            t, rows * 0.1, *flat[6:12], rp)),
        "fused_swin_block": (x, lambda t: k4.fused_swin_block(
            t, flat, 4, 8, 4, 4, (16, 16), False, False)),
        "gemm": (rows.to(torch.bfloat16), lambda t: kg.gemm(t, flat[2].to(torch.bfloat16))),
    }
    t, call = calls[wrapper]
    for grad in (False, True):
        launch_counts.clear()
        out = call(t.clone().requires_grad_(True) if grad else t)
        assert dict(launch_counts) == {wrapper: 1}
        if grad:
            assert type(out.grad_fn).__name__ == "RecomputeBackward"
        else:
            assert out.grad_fn is None


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode,md,tol", [("f32", None, 1e-4), ("bf16", torch.bfloat16, 2e-2)])
def test_derived_copies_follow_optimizer_steps_on_card(dev, fused, mode, md, tol):
    """Ten AdamW steps (foreach and fused) on K4's and K2's weights, each
    step through the autograd entry: the kernels' next calls (bf16 copies,
    gathered and padded biases, TMA maps, 3xTF32 splits) agree with the
    plain versions at the new weights, and the derived-copy cache keeps its
    size. The foreach update bumps each weight's version; the fused one
    bumps none, which is why a weight that requires grad is never kept
    (``build.derived``)."""
    c, nh, nw, res = WEIGHT_GRAD_LAYERS["tiny-0"]
    flat, _, _, _ = _inputs(dev, c=c, nh=nh)
    weights = [torch.nn.Parameter(w.clone()) for w in flat]
    opt = torch.optim.AdamW(weights, lr=1e-2, fused=fused)
    rng = np.random.default_rng(12)
    x = torch.from_numpy((0.5 * rng.standard_normal((2 * nw, 64, c))).astype(np.float32)).to(dev)
    cot = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32)).to(dev)
    args4 = (nh, 8, nw, 4, res, False, False, md)
    args2 = (nh, 8, nw, 4, res, md)
    sizes = []
    for _ in range(10):
        with torch.no_grad():
            assert _rel(k4.fused_swin_block(x, tuple(weights), *args4),
                        k4.swin_block_plain(x, tuple(weights), *args4)) < tol
            assert _rel(k2.fused_window_attention(x, *weights[2:6], weights[12], *args2),
                        k2.window_attention_plain(x, *weights[2:6], weights[12], *args2)) < tol
        sizes.append(len(build._derived))
        versions = [w._version for w in weights]
        opt.zero_grad()
        (k4.fused_swin_block(x, tuple(weights), *args4).float() * cot).sum().backward()
        opt.step()
        if not fused:
            assert all(w._version > v for w, v in zip(weights, versions))
    assert sizes == [sizes[0]] * len(sizes), sizes


def test_serving_is_unchanged_without_a_lambda_grad(dev):
    """A λ that requires no grad: an ``encode_audio`` in grad mode launches
    what one under ``torch.no_grad()`` does and returns no ``grad_fn``; a λ
    that requires grad launches the same kernels forward and none backward."""
    from audio_residual_tpu_torch.models import clap as t_clap

    cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(**fx.AUDIO_KW), **fx.CLAP_KW)
    model = t_clap.build_clap_audio(cfg, device=dev)
    rng = np.random.default_rng(8)
    c = fx.AUDIO_KW["embed_dim"]
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, 24000))).astype(np.float32)).to(dev)

    def run(lam_grad, no_grad=False):
        res = {0: {"basis": torch.from_numpy(q.astype(np.float32)).to(dev),
                   "mean": torch.zeros(c, device=dev),
                   "lam": torch.ones(c, device=dev, requires_grad=lam_grad)}}
        launch_counts.clear()
        with torch.set_grad_enabled(not no_grad):
            out = t_clap.encode_audio(model, wav, residual=res)
        return dict(launch_counts), out, res

    served, out, _ = run(False, no_grad=True)
    assert served == {"fused_logmel": 1, "fused_swin_block": 2, "fused_window_attention": 2,
                      "fused_residual_ffn": 2}
    counts, out2, _ = run(False)
    assert counts == served and all(v.grad_fn is None for v in out2.values())
    assert torch.equal(out2["normalized"], out["normalized"])
    counts, out3, res = run(True)
    assert counts == served and torch.equal(out3["normalized"].detach(), out["normalized"])
    launch_counts.clear()
    out3["normalized"].sum().backward()
    torch.cuda.synchronize()
    assert not launch_counts and res[0]["lam"].grad is not None


# ---- the golden routes on 3xTF32 (K1-K5; the ResiDual in both modes) --------
# What they are held to: each kernel's max abs error against a float64
# evaluation of the same function (the same f32 weights and constants) at
# most GOLDEN_F64_RATIO times that of the plain f32 version (cuBLAS, TF32
# off): 3xTF32 keeps about f32's accuracy, so the ratio stays near 1.
GOLDEN_F64_RATIO = 4.0


@pytest.mark.parametrize("n_fft", [1024, 1536])
def test_logmel_golden_error_against_float64(dev, n_fft):
    """K1 golden at the main path's shape ([32, 480000], HTSAT-tiny's
    frontend, and HTSAT-tiny-win-1536's), dB against float64."""
    cfg = fe.FrontendConfig(n_fft=n_fft, win_length=n_fft)
    wav = torch.from_numpy(
        (np.random.default_rng(11).standard_normal((32, 480000)) * 0.1).astype(np.float32)).to(dev)
    with torch.no_grad():
        got, plain = k1.fused_logmel(wav, cfg, "f32"), k1.logmel_plain(wav, cfg, "f32")
        ref = f64.logmel64(wav, cfg)
    assert _rel(got, plain) < 1e-4
    assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO


@pytest.mark.parametrize("variant", list(FFN_VARIANTS))
@pytest.mark.parametrize("rows,c", [(2048, 768), (2048, 1024)])  # tiny and base layer 3, B=32
def test_residual_ffn_golden_error_against_float64(dev, rows, c, variant):
    use_res, dffn = FFN_VARIANTS[variant]
    x, a, weights, rp = _ffn_inputs(dev, rows, c)
    args = (x, a, *weights, rp if use_res else None)
    with torch.no_grad():
        got = k3.fused_residual_ffn(*args, double_ffn=dffn)
        plain = k3.residual_ffn_plain(*args, double_ffn=dffn)
    ref = f64.ffn64(*args, dffn)
    assert _rel(got, plain) < 1e-4
    assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO


# K4 at the main paths' layer shapes, B=32 (layer 0 with ResiDual and the
# double FFN, as the main paths run it)
GOLDEN_BLOCKS = {"tiny-l0": (96, 4, 64, (64, 64), True), "tiny-l1": (192, 8, 16, (32, 32), False),
                 "tiny-l2": (384, 16, 4, (16, 16), False),
                 "base-l0": (128, 4, 64, (64, 64), True), "base-l1": (256, 8, 16, (32, 32), False),
                 "base-l2": (512, 16, 4, (16, 16), False)}


@pytest.mark.parametrize("layer", list(GOLDEN_BLOCKS))
def test_swin_block_golden_error_against_float64(dev, layer):
    """Every product on the 3xTF32 GEMM: as the main path runs the layer,
    and with the ResiDual and the double FFN at every layer."""
    c, nh, nw, res, path_res = GOLDEN_BLOCKS[layer]
    flat, rp, x = _block_of(dev, c, nh, 32 * nw)
    rpd = dict(zip(("basis", "mean", "lam"), rp))
    for use_res in sorted({path_res, True}):
        blk = (x, flat + (rp if use_res else ()), nh, 8, nw, 4, res, use_res, use_res)
        with torch.no_grad():
            got, plain = k4.fused_swin_block(*blk), k4.swin_block_plain(*blk)
            ref = f64.block64(x, flat, rpd if use_res else None, nh, 8, 4, res, use_res)
        assert _rel(got, plain) < 1e-4
        assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO


# K2 and K5 golden at B=32: HTSAT-tiny layer 3 (K2), HTSAT-base layer 3 and
# HTSAT-large layers 2 and 3 (K5): (C, heads, windows a clip, resolution, shift)
GOLDEN_ATTENTION = {"tiny-l3": (768, 32, 1, (8, 8), 0), "base-l3": (1024, 32, 1, (8, 8), 0),
                    "large-l2": (1024, 16, 4, (16, 16), 4), "large-l3": (2048, 32, 1, (8, 8), 0)}


@pytest.mark.parametrize("layer", list(GOLDEN_ATTENTION))
def test_window_attention_golden_error_against_float64(dev, layer):
    """qkv and proj on the 3xTF32 GEMM around the f32 attention core: within
    1e-4 of the plain version, at most GOLDEN_F64_RATIO times its error
    against float64."""
    c, nh, nw, res, shift = GOLDEN_ATTENTION[layer]
    weights, x = _wide_inputs(dev, c, nh, 32 * nw)
    args = (x, *weights, nh, 8, nw, shift, res)
    launch_counts.clear()
    with torch.no_grad():
        got, plain = k2.fused_window_attention(*args), k2.window_attention_plain(*args)
    ref = f64.attention64(x, *weights, nh, 8, shift, res).reshape(x.shape)
    assert _rel(got, plain) < 1e-4
    assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO
    assert dict(launch_counts) == {"wide_window_attention" if c >= k2.WIDE_MIN_C
                                   else "fused_window_attention": 1}


def _residual_alone(dev, rows, c, kr, seed=4):
    """K3's inputs with zero FFN weights, so that its output is h1 = x +
    ResiDual(a) exactly in either mode (GELU(0) = 0): the ResiDual alone,
    through the route that runs it, with ``kr`` of C components."""
    x, a, weights, rp = _ffn_inputs(dev, rows, c, seed)
    zeros = tuple(torch.zeros_like(t) for t in weights[2:])
    rp = {"basis": rp["basis"][:kr].contiguous(), "mean": rp["mean"], "lam": rp["lam"][:kr]}
    return x, a, (*weights[:2], *zeros), rp


@pytest.mark.parametrize("rows,c,kr", [(2048, 768, 13), (8192, 96, 7), (2048, 1024, 100)])
def test_residual_golden_error_against_float64(dev, rows, c, kr):
    """The ResiDual at a component count that is no multiple of 8 (padded
    with zeros to one): golden and AMP (f32 in both) within 1e-4 of the
    plain version, at most GOLDEN_F64_RATIO times its error against
    float64."""
    x, a, weights, rp = _residual_alone(dev, rows, c, kr)
    args = (x, a, *weights, rp)
    ref = f64.ffn64(*args, False)
    for md in (None, torch.bfloat16):
        with torch.no_grad():
            got = k3.fused_residual_ffn(*args, mxu_dtype=md)
            plain = k3.residual_ffn_plain(*args, mxu_dtype=md)
        assert _rel(got, plain) < 1e-4
        assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO


@pytest.mark.parametrize("c,nh", [(32, 2), (40, 2), (96, 4)])
def test_residual_takes_every_component_count(dev, c, nh):
    """Every kr from 1 to C plans (zero-padded to a multiple of 8) and
    agrees with the plain version, K3 and K4, golden and -- where the width
    has an AMP plan -- AMP; C = 40 has a ragged K step (32 + 8)."""
    x, a, weights, rp = _ffn_inputs(dev, 64, c, seed=6)
    flat, rpb, xb = _block_of(dev, c, nh, 2)
    modes = [(None, 1e-4)]
    if c % 8 == 0 and c // nh in k2.AMP_HEAD_DIMS:
        modes.append((torch.bfloat16, 2e-2))
    try:  # K3's clustered AMP kernel plans only some widths
        k3_amp = bool(k3.amp_plan(64, c, 4 * c))
    except ValueError:
        k3_amp = False
    with torch.no_grad():
        for kr in range(1, c + 1):
            sub = {"basis": rp["basis"][:kr].contiguous(), "mean": rp["mean"],
                   "lam": rp["lam"][:kr]}
            blk_res = (rpb[0][:kr].contiguous(), rpb[1], rpb[2][:kr])
            for md, tol in modes:
                blk = (xb, flat + blk_res, nh, 8, 1, 0, (8, 16), True, True, md)
                assert _rel(k4.fused_swin_block(*blk), k4.swin_block_plain(*blk)) < tol
                if md is None or k3_amp:
                    args = (x, a, *weights, sub)
                    assert _rel(k3.fused_residual_ffn(*args, double_ffn=True, mxu_dtype=md),
                                k3.residual_ffn_plain(*args, double_ffn=True,
                                                      mxu_dtype=md)) < tol


def test_gemm_tf32x3_centring_masks_past_k(dev):
    """The prologue a - a_sub at a ragged K (68 = 2 x 32 + 4): a_sub past
    its end holds NaN, which the kernel must not read; the error against
    float64 at most GOLDEN_F64_RATIO times the plain version's."""
    rng = np.random.default_rng(12)
    m, n, k = 300, 104, 68
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((n, k)) * k ** -0.5).astype(np.float32)).to(dev)
    buf = torch.full((k + 60,), float("nan"), device=dev)
    buf[:k] = torch.from_numpy(rng.standard_normal(k).astype(np.float32)).to(dev)
    a_sub, scale = buf[:k], torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    with torch.no_grad():
        got = kg.gemm_tf32x3(a, w, col_scale=scale, a_sub=a_sub)
        plain = kg.gemm_tf32x3_plain(a, w, col_scale=scale, a_sub=a_sub)
    ref = ((a.double() - a_sub.double()) @ w.double().t()) * scale.double()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, plain) < 1e-4
    assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO


@pytest.mark.parametrize("cfg", [fe.FrontendConfig(), WIN_1536, fe.FrontendConfig(n_mels=16)],
                         ids=["n_fft=1024", "n_fft=1536", "n_mels=16"])
@pytest.mark.parametrize("b,t", [(1, 48000), (3, 100000), (1, 100001), (3, 240000)])
def test_logmel_golden_matches_plain_on_card(dev, cfg, b, t):
    """K1 golden at ragged frame counts (nf = 209 at 100 000 samples) and a
    ragged row (100 001 samples: the wrapper pads the row to 4 samples)."""
    wav = torch.from_numpy(
        (np.random.default_rng(t).standard_normal((b, t)) * 0.1).astype(np.float32)).to(dev)
    launch_counts.clear()
    with torch.no_grad():
        got, ref = k1.fused_logmel(wav, cfg), k1.logmel_plain(wav, cfg)
    assert got.shape == ref.shape == (b, cfg.num_frames(t), cfg.n_mels)
    assert bool(torch.isfinite(got).all()) and _rel(got, ref) < 1e-4
    assert dict(launch_counts) == {"fused_logmel": 1}


def test_logmel_golden_gives_the_floor_on_silence(dev):
    wav = torch.zeros(3, 48000, device=dev)
    with torch.no_grad():
        got, ref = k1.fused_logmel(wav, fe.FrontendConfig()), k1.logmel_plain(wav,
                                                                               fe.FrontendConfig())
    assert torch.equal(got, ref)


def test_logmel_golden_refuses_a_misaligned_config(dev):
    wav = torch.zeros(1, 48000, device=dev)
    with pytest.raises(ValueError, match="f32: hop_length=478 must be a multiple of 4"):
        k1.fused_logmel(wav, fe.FrontendConfig(hop_length=478))
    with pytest.raises(ValueError, match="multiple of 32"):
        k1.fused_logmel(wav, fe.FrontendConfig(n_fft=1000, win_length=1000))


@pytest.mark.parametrize("variant", list(FFN_VARIANTS))
@pytest.mark.parametrize("rows,c", [
    (64, 768), (192, 1024),   # ragged: half a 128-row tile, one and a half
    (100, 96), (128, 64),     # the test widths
    (130, 32),                # N = 32, K = 32: one K step
    (200, 40),                # N = 40 against a 32-column tile: a masked edge; ragged K
])
def test_residual_ffn_golden_matches_plain_on_card(dev, rows, c, variant):
    use_res, dffn = FFN_VARIANTS[variant]
    x, a, weights, rp = _ffn_inputs(dev, rows, c)
    launch_counts.clear()
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            args = (x.to(dt), a.to(dt), *weights, rp if use_res else None)
            got = k3.fused_residual_ffn(*args, double_ffn=dffn)
            ref = k3.residual_ffn_plain(*args, double_ffn=dffn)
            assert got.dtype == ref.dtype == torch.float32 and got.shape == ref.shape
            assert _rel(got, ref) < 1e-4
    assert dict(launch_counts) == {"fused_residual_ffn": 2}


@pytest.mark.parametrize("c,nh", [(32, 2), (64, 4), (96, 4), (256, 8)])
def test_swin_block_golden_matches_plain_on_card(dev, c, nh):
    """K4 golden at the test widths (the fixtures' C = 32, 64, 256), bf16
    and f32 x, ResiDual and the double FFN."""
    flat, rp, x = _block_of(dev, c, nh, 6)
    with torch.no_grad():
        for xin in (x, x.bfloat16()):
            blk = (xin, flat + rp, nh, 8, 2, 4, (16, 8), True, True)
            assert _rel(k4.fused_swin_block(*blk), k4.swin_block_plain(*blk)) < 1e-4


TF32X3_SHAPES = [(2048, 3072, 768), (2048, 768, 3072), (2048, 4096, 1024), (2048, 1024, 4096),
                 (8192 - 64, 384, 96), (8192 - 64, 96, 384), (200, 40, 40), (130, 32, 32),
                 (300, 520, 68)]


@pytest.mark.parametrize("m,n,k", TF32X3_SHAPES)
def test_gemm_tf32x3_error_against_float64(dev, m, n, k):
    """The 3xTF32 GEMM alone (bias, GELU, r1 f32, r2 bf16): against its
    plain version within 1e-4, and against float64 at most
    GOLDEN_F64_RATIO times the plain version's error."""
    rng = np.random.default_rng(m + n + k)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    a, w = t(m, k), t(n, k, scale=k ** -0.5)
    epi = dict(bias=t(n, scale=0.1), gelu=True, r1=t(m, n), r2=t(m, n).bfloat16())
    launch_counts.clear()
    with torch.no_grad():
        got = kg.gemm_tf32x3(a, w, **epi)
        plain = kg.gemm_tf32x3_plain(a, w, **epi)
    ref = torch.nn.functional.gelu(a.double() @ w.double().t() + epi["bias"].double())
    ref = ref + epi["r1"].double() + epi["r2"].double()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert _rel(got, plain) < 1e-4
    assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO
    assert dict(launch_counts) == {"gemm_tf32x3": 1}


def test_golden_routes_give_equal_bits_twice(dev):
    """Every sum runs in a fixed order: two calls give the same bits."""
    wav = torch.from_numpy(
        (np.random.default_rng(3).standard_normal((2, 100000)) * 0.1).astype(np.float32)).to(dev)
    x, a, weights, rp = _ffn_inputs(dev, 192, 768)
    flat, rpb, xb = _block_of(dev, 96, 4, 8)
    blk = (xb, flat + rpb, 4, 8, 4, 4, (16, 16), True, True)
    attn = (xb, *flat[2:6], flat[12], 4, 8, 4, 4, (16, 16))
    wide, xw = _wide_inputs(dev, 1024, 32, 2)
    with torch.no_grad():
        for call in (lambda: k1.fused_logmel(wav, fe.FrontendConfig()),
                     lambda: k3.fused_residual_ffn(x, a, *weights, rp, double_ffn=True),
                     lambda: k4.fused_swin_block(*blk),
                     lambda: k2.fused_window_attention(*attn),
                     lambda: k5.wide_window_attention(xw, *wide, 32, 8, 1, 0, (8, 8))):
            assert torch.equal(call(), call())


def test_golden_routes_run_the_3xtf32_kernels(dev):
    """By the profiler's kernel names, exactly the port's kernels of each
    golden call: K1 one logmel_tf32x3_kernel (after the wrapper's pad); K2
    and K5 the qkv and proj products on gemm_tf32x3_kernel around one
    attention_core_kernel; K3 add+LN2 and its fc1 and fc2 on
    gemm_tf32x3_kernel, with a ResiDual its two products there too; K4 all
    of these (qkv, proj, the ResiDual's two, fc1 and fc2 of each FFN pass).
    No other kernel of the port runs: no CUDA-core GEMM, no CUDA-core qkv."""
    wav = torch.zeros(2, 48000, device=dev)
    x, a, weights, rp = _ffn_inputs(dev, 256, 768)
    flat, rpb, xb = _block_of(dev, 96, 4, 8)
    wide, xw = _wide_inputs(dev, 1024, 32, 2)
    tf32x3, core, ln = "gemm_tf32x3_kernel", "attention_core_kernel", "add_layernorm_kernel"
    calls = [
        (lambda: k1.fused_logmel(wav, fe.FrontendConfig()), {"logmel_tf32x3_kernel": 1}),
        (lambda: k2.fused_window_attention(xb, *flat[2:6], flat[12], 4, 8, 4, 4, (16, 16)),
         {tf32x3: 2, core: 1}),
        (lambda: k5.wide_window_attention(xw, *wide, 32, 8, 1, 0, (8, 8)), {tf32x3: 2, core: 1}),
        (lambda: k3.fused_residual_ffn(x, a, *weights), {ln: 1, tf32x3: 2}),
        (lambda: k3.fused_residual_ffn(x, a, *weights, rp, double_ffn=True), {ln: 2, tf32x3: 6}),
        (lambda: k4.fused_swin_block(xb, flat + rpb, 4, 8, 4, 4, (16, 16), True, True),
         {ln: 3, tf32x3: 8, core: 1}),
    ]
    with torch.no_grad():
        for call, want in calls:
            call()  # constants, split weights
            names = _device_kernels(
                call, lambda n, want=want: _port_kernels(n) == collections.Counter(want))
            assert _port_kernels(names) == collections.Counter(want), names


# the tapped forward (encode_audio(..., taps=...)): every block runs the split
# plan, so K2 and K3 meet the layers K4 takes without taps; HTSAT-tiny's
# layers 0-2 at B = 32 (K3: B*4096 rows of 96, B*1024 of 192, B*256 of 384)
TAPPED_LAYERS = {k: WINDOW_LAYERS[k] for k in ("tiny-l0", "tiny-l1", "tiny-l2")}


@pytest.mark.parametrize("mode,md,tol", [("f32", None, 1e-4), ("bf16", torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("layer", list(TAPPED_LAYERS))
def test_tapped_split_plan_matches_plain_at_b32_on_card(dev, layer, shift, mode, md, tol):
    """K2 and K3 at the tapped path's shapes (several windows a clip, B = 32)
    against their plain versions, f32 and bf16 input, K3 without and with
    the ResiDual and the double FFN: max |kernel - plain| / max |plain|
    within 1e-4 (f32) / 2e-2 (bf16)."""
    c, nh, nw, res = TAPPED_LAYERS[layer]
    flat, rp, x = _block_of(dev, c, nh, 32 * nw)
    rparams = dict(zip(("basis", "mean", "lam"), rp))
    launch_counts.clear()
    with torch.no_grad():
        for xin in (x, x.bfloat16()) if md is not None else (x,):
            args = (xin, *flat[2:6], flat[12], nh, 8, nw, shift, res, md)
            a = k2.fused_window_attention(*args)
            assert bool(torch.isfinite(a.float()).all())
            assert _rel(a, k2.window_attention_plain(*args)) < tol
            for use_res in (False, True):
                ffn = (xin.reshape(-1, c), a.reshape(-1, c), *flat[6:12],
                       rparams if use_res else None)
                out = k3.fused_residual_ffn(*ffn, double_ffn=use_res, mxu_dtype=md)
                assert bool(torch.isfinite(out.float()).all())
                assert _rel(out, k3.residual_ffn_plain(*ffn, double_ffn=use_res,
                                                       mxu_dtype=md)) < tol
    n = 2 if md is not None else 1
    assert dict(launch_counts) == {"fused_window_attention": n, "fused_residual_ffn": 2 * n}


@pytest.mark.parametrize("md", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("taps", [("residual",), ("attention",)], ids=["residual", "attention"])
def test_tapped_forward_matches_the_plain_route_on_card(dev, taps, md):
    """HTSAT-tiny at full width, B = 2, a layer-0 ResiDual: the tapped
    forward's taps and embedding against the same forward with the split
    plan's K2 and K3 replaced by their plain versions (golden: atol 2e-3,
    rtol 1e-3, the probabilities atol 1e-5; AMP: max |got - ref| / max |ref|
    within 2e-2 and cosine > 0.99999 for each tap and the embeddings). The
    forward launches K1, K3 in every block, K2 in every block under the
    residual tap only, and no K4."""
    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.residual.module import init_residual_params

    cfg = t_clap.CLAPConfig()
    model = t_clap.build_clap_audio(cfg, seed=0, device=dev)
    rng = np.random.default_rng(12)
    q, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    residual = {0: init_residual_params(q, rng.standard_normal(96) * 0.01, device=dev)}
    wav = torch.from_numpy((0.1 * rng.standard_normal((2, 48000))).astype(np.float32)).to(dev)
    batch = featurize_batch(wav, cfg.audio.clip_samples)
    key = "layers_residuals" if "residual" in taps else "layers_attention"
    blocks = sum(cfg.audio.depths)
    launch_counts.clear()
    with torch.no_grad():
        got = t_clap.encode_audio(model, batch, taps=taps, residual=residual, compute_dtype=md)
        assert dict(launch_counts) == {"fused_logmel": 1, "fused_residual_ffn": blocks,
                                       **({"fused_window_attention": blocks}
                                          if "residual" in taps else {})}
        with mock.patch.object(k4, "fused_window_attention", k2.window_attention_plain), \
                mock.patch.object(k4, "fused_residual_ffn", k3.residual_ffn_plain):
            ref = t_clap.encode_audio(model, batch, taps=taps, residual=residual,
                                      compute_dtype=md)
    assert len(got[key]) == len(ref[key]) == cfg.audio.num_layers
    for i, (g, r) in enumerate([*zip(got[key], ref[key]),
                                (got["normalized"], ref["normalized"])]):
        assert g.dtype == r.dtype == torch.float32 and g.shape == r.shape, i
        assert bool(torch.isfinite(g).all())
        if md is None:
            probs = key == "layers_attention" and i < len(got[key])
            torch.testing.assert_close(g, r, **(dict(atol=1e-5, rtol=0) if probs
                                                 else dict(atol=2e-3, rtol=1e-3)))
        else:
            cos = float((g.flatten() @ r.flatten()) / (g.norm() * r.norm()))
            assert _rel(g, r) <= 2e-2 and cos > 0.99999, (i, _rel(g, r), cos)


def test_pca_updates_against_float64_on_card(dev):
    """The moment updates at the attention PCA's row width (4096) against a
    float64 evaluation, with TF32 allowed around them: they run f32 with
    TF32 off all the same (max rel err 1e-5; TF32 would leave ~1e-3)."""
    from audio_residual_tpu_torch.ops import pca

    rng = np.random.default_rng(14)
    x = torch.softmax(torch.from_numpy(rng.standard_normal((4, 1024, 4096)).astype(np.float32)
                                       ).to(dev), dim=-1)
    r = x[0] * 4096.0 - 1.0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        batched = pca.batched_pca_update(pca.batched_pca_init((4,), 4096, device=dev), x)
        single = pca.pca_update(pca.pca_init(4096, device=dev), r)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    x64, r64 = x.double(), r.double()
    assert _rel(batched.outer, x64.transpose(1, 2) @ x64) < 1e-5
    assert _rel(batched.sum, x64.sum(1)) < 1e-5 and batched.n.tolist() == [1024.0] * 4
    assert _rel(single.outer, r64.t() @ r64) < 1e-5


def test_randomized_finalize_on_card_matches_dense(dev):
    """The randomized finalize on the card (float64, QR) against the dense
    host finalize of the same moments, on eigenvalues over five decades:
    rtol 1e-6, components' |dot| > 0.999."""
    from audio_residual_tpu_torch.ops import pca

    rng = np.random.default_rng(15)
    d, k = 1024, 32
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = np.concatenate([10.0 ** (-np.arange(40) / 8), np.zeros(d - 40)])
    outer = torch.from_numpy((((q * lam) @ q.T) * (d - 1)).astype(np.float32))
    state = pca.PCAState(n=torch.tensor(float(d)), sum=torch.zeros(d), outer=outer)
    card = pca.PCAState(*(t.to(dev) for t in state))
    launch_counts.clear()
    got = pca.pca_finalize(card, k, method="randomized")
    assert launch_counts["householder_qr"] == 7  # iters + 1 blocks orthonormalised
    want = pca.pca_finalize(state, k, method="dense")
    np.testing.assert_allclose(got["explained_variance"], want["explained_variance"], rtol=1e-6)
    assert np.abs(np.sum(got["components"] * want["components"], axis=-1)).min() > 0.999


def _qr_block(dev, shape, seed, rank=None, decades=None):
    """A float64 block on the card: Gaussian; of rank ``rank`` (a product
    through ``rank`` columns); or with singular values spread evenly over
    ``decades`` decades (random orthonormal sides)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, d, m = shape

    def gauss(*s):
        return torch.randn(s, generator=g, dtype=torch.float64, device=dev)

    if rank is not None:
        return gauss(b, d, rank) @ gauss(b, rank, m)
    if decades is not None:
        u, w = torch.linalg.qr(gauss(b, d, m)).Q, torch.linalg.qr(gauss(b, m, m)).Q
        sigma = torch.logspace(0, -decades, m, dtype=torch.float64, device=dev)
        return (u * sigma) @ w.mT
    return gauss(b, d, m)


@pytest.mark.parametrize("shape,rank,decades", [
    ((4, 4096, 784), None, None), ((32, 4096, 784), None, None), ((2, 1024, 24), None, None),
    ((4, 4096, 784), 399, None), ((4, 4096, 784), None, 5), ((1, 8192, 64), None, None),
    ((1, 10000, 44), None, None), ((1, 20736, 24), None, None), ((1, 40000, 24), None, None),
    ((1, 70000, 24), None, None),
], ids=["h4", "h32", "narrow", "rank399", "five_decades", "w16", "w8", "w4", "w2", "w1"])
def test_householder_qr_on_card(dev, shape, rank, decades):
    """The blocked QR against the library's on the card: Q orthonormal
    (max |QᵀQ - I| <= 1e-12) with A in its span (||QQᵀA - A||_F / ||A||_F <=
    1e-12), on Gaussian blocks, a block of rank 399 (layer 3's covariance
    under one window a clip: 400 rows a job) and one whose singular values
    spread over five decades, and past 4096 rows, where the panels narrow
    (16 columns at D = 8192 down to one at D = 70000, the last panel of a
    block cut short at m = 44); on a full-rank block each column the
    library's up to its sign (max 1e-10: the factor's rounding through the
    block's condition number). One count a call."""
    from audio_residual_tpu_torch.ops.cuda import qr

    a = _qr_block(dev, shape, seed=sum(shape) + (rank or 0), rank=rank, decades=decades)
    launch_counts.clear()
    q = qr.householder_qr(a)
    torch.cuda.synchronize()
    assert launch_counts["householder_qr"] == 1
    assert q.shape == a.shape and q.dtype == torch.float64 and q.is_contiguous()
    m = shape[-1]
    eye = torch.eye(m, dtype=torch.float64, device=dev)
    assert float((q.mT @ q - eye).abs().max()) <= 1e-12
    resid = torch.linalg.norm(q @ (q.mT @ a) - a, dim=(-2, -1)) / torch.linalg.norm(a, dim=(-2, -1))
    assert float(resid.max()) <= 1e-12
    if rank is None and decades is None:
        ref = qr.householder_qr_plain(a)
        signs = torch.sign(torch.diagonal(ref.mT @ q, dim1=-2, dim2=-1))
        assert float((q - ref * signs[:, None, :]).abs().max()) <= 1e-10


TEXT_MODELS = ("roberta", "bert", "bart", "transformer")


def _texts(n: int, vocab_size: int) -> dict:
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    words = ("dog", "rain", "sea waves", "crackling fire", "crying baby", "clock tick",
             "helicopter", "chainsaw", "church bells", "keyboard typing")
    return HashTokenizer(vocab_size=vocab_size)(
        [f"This is a sound of {words[i % len(words)]} number {i}." for i in range(n)])


def _cos_min(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


@pytest.mark.parametrize("tmodel", TEXT_MODELS)
def test_text_towers_against_float64_on_card(dev, tmodel):
    """Each text tower at full width (``create_model``, seed 0), golden
    ``encode_text`` on the card against a float64 copy evaluated on the
    card: atol=2e-3, rtol=1e-3, cosine > 0.99999 (golden parity)."""
    import copy

    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.models import factory as t_factory

    model, cfg, _ = t_factory.create_model("HTSAT-tiny", tmodel, device=dev)
    enc = _texts(8, cfg.text.vocab_size)
    with torch.no_grad():
        got = t_clap.encode_text(model, enc["input_ids"], enc["attention_mask"])
        ref = t_clap.encode_text(copy.deepcopy(model).double(), enc["input_ids"],
                                 enc["attention_mask"])
    assert got.dtype == torch.float32 and got.shape == (8, cfg.joint_embed_shape)
    torch.testing.assert_close(got.double(), ref, atol=2e-3, rtol=1e-3)
    assert _cos_min(got, ref) > 0.99999


def test_roberta_amp_runs_the_bf16_gemm_on_card(dev):
    """RoBERTa-base under AMP at 32 texts of 77 tokens: one bf16 GEMM launch
    for each of the 6 dense products of a layer and the pooler, and no plain
    GEMM; the features against the same forward through the plain GEMM
    (max rel err 2e-2; cosine > 0.9999: at 12 layers a change of summation
    order alone moves the AMP features to cosine 0.99999, as f32 against
    f64 accumulation of the same bf16 products shows on the CPU, because
    it flips the bf16 rounding of stored inputs) and against golden (the
    bench guard's cosine > 0.999)."""
    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.models import factory as t_factory
    from audio_residual_tpu_torch.models import roberta as t_roberta

    model, cfg, _ = t_factory.create_model("HTSAT-tiny", "roberta", device=dev)
    enc = _texts(32, cfg.text.vocab_size)
    args = (model, enc["input_ids"], enc["attention_mask"])
    with torch.no_grad():
        golden = t_clap.encode_text(*args)
        launch_counts.clear()
        with mock.patch.object(kg, "gemm_plain", side_effect=AssertionError("plain GEMM")):
            amp = t_clap.encode_text(*args, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert dict(launch_counts) == {"gemm": 6 * cfg.text.num_layers + 1}
        with mock.patch.object(t_roberta, "gemm", kg.gemm_plain):
            plain = t_clap.encode_text(*args, compute_dtype=torch.bfloat16)
    assert _rel(amp, plain) <= 2e-2 and _cos_min(amp, plain) > 0.9999
    assert _cos_min(amp, golden) > 0.999


# RoBERTa-base's dense products: q, k, v and out; fc1; fc2
LINEAR_SHAPES = [(768, 768), (3072, 768), (768, 3072)]


@pytest.mark.parametrize("gelu,bias", [(False, True), (True, True), (False, False)],
                         ids=["bias", "bias-gelu", "no-bias"])
@pytest.mark.parametrize("n,k", LINEAR_SHAPES)
def test_linear_tf32x3_error_against_float64(dev, n, k, gelu, bias):
    """The 3xTF32 linear and its autograd at RoBERTa-base's shapes, 96 texts
    of 77 tokens (M = 7392): the output, dx, dW and db against a float64
    evaluation, each at most GOLDEN_F64_RATIO times the error of
    ``F.linear`` and its autograd in f32; one forward product, one split of
    the weight, and in the backward one product each for dx and dW and one
    split of dW's operand."""
    from audio_residual_tpu_torch.ops.cuda import linear as kl

    m = 96 * 77
    rng = np.random.default_rng(n + 2 * k + gelu)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    leaves = [t(m, k), t(n, k, scale=k ** -0.5)] + ([t(n, scale=0.1)] if bias else [])
    dy = t(m, n)
    outs = {}
    for name, fn, dt in (("x3", kl.linear_tf32x3, torch.float32),
                         ("f32", kl.linear_plain, torch.float32),
                         ("f64", kl.linear_plain, torch.float64)):
        ins = [v.detach().to(dt).requires_grad_() for v in leaves]
        launch_counts.clear()
        y = fn(ins[0], ins[1], ins[2] if bias else None, gelu=gelu)
        outs[name] = (y.detach(), *torch.autograd.grad(y, ins, dy.to(dt)))
        torch.cuda.synchronize()
        if name == "x3":
            assert dict(launch_counts) == {"linear_tf32x3": 1, "linear_tf32x3.dx": 1,
                                           "linear_tf32x3.dw": 1, "split_tf32": 2}
    for what, got, plain, ref in zip(("y", "dx", "dW", "db"), *outs.values()):
        assert got.shape == ref.shape, what
        assert f64.error_ratio(got, plain, ref)[2] <= GOLDEN_F64_RATIO, what


@pytest.mark.parametrize("r,c,ld", [(7392, 768, 7392), (77, 40, 80), (33, 96, 36), (1, 8, 4)])
def test_split_kernel_gives_split_tf32s_bits(dev, r, c, ld):
    """``arpu_split_tf32`` (the linear's one-pass split, plain and
    transposed with zero columns up to ``ld``) gives the bits of
    ``tf32x3.split_tf32``, magnitudes from 1e-30 to 1e30, an infinity, a
    NaN and the largest f32 among them."""
    from audio_residual_tpu_torch.ops.cuda import linear as kl
    from audio_residual_tpu_torch.ops.cuda import tf32x3

    rng = np.random.default_rng(r + c)
    t = rng.standard_normal((r, c)) * 10.0 ** rng.integers(-30, 30, (r, c))
    t.reshape(-1)[:3] = (np.inf, np.nan, -3.4028235e38)
    t = torch.from_numpy(t.astype(np.float32)).to(dev)
    got = kl._split_kernel(t, transposed=True, straight=True, ld=ld)
    padded = torch.cat([t, t.new_zeros(ld - r, c)])
    want = (*tf32x3.split_tf32(t), *tf32x3.split_tf32(padded.t().contiguous()))
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("rows,cols,red,bn,splits", [(768, 768, 7392, 128, 11),
                                                     (200, 40, 100, 32, 2), (136, 96, 68, 64, 2),
                                                     (3072, 768, 7392, 96, 5),
                                                     (128, 128, 4, 128, 1)])
def test_weight_grad_kernel_matches_its_decomposition(dev, rows, cols, red, bn, splits):
    """The weight gradient's GEMM (A read transposed, K in splits) at
    RoBERTa's shapes and at ragged ones: each slab within 1e-4 of the plain
    decomposition's on the CPU, and their sum against float64 at most
    GOLDEN_F64_RATIO times the f32 matmul's error (at K = 4 the f32 sum is
    all but exact: there the limit is 3xTF32's own, 1e-6)."""
    from audio_residual_tpu_torch.ops.cuda import linear as kl
    from audio_residual_tpu_torch.ops.cuda import tf32x3

    rng = np.random.default_rng(rows + cols)
    a = torch.from_numpy(rng.standard_normal((red, rows)).astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.standard_normal((cols, red)) * red ** -0.5)
                         .astype(np.float32)).to(dev)
    hi, lo = tf32x3.split_tf32(b)
    plan = kl.WeightGradPlan(True, rows, cols, red, bn, tf32x3.ring(bn)[0], splits)
    got = kl._parts(a, hi, lo, plan)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), kl._parts(a.cpu(), hi.cpu(), lo.cpu(), plan)) <= 1e-4
    ref = a.double().t() @ b.double().t()
    total = got.sum(0) if splits > 1 else got
    err = float((total.double() - ref).abs().max())
    plain_err = float(((a.t() @ b.t()).double() - ref).abs().max())
    assert err <= max(GOLDEN_F64_RATIO * plain_err, 1e-6 * float(ref.abs().max()))


def _roberta_batch(dev, cfg, b: int, seed: int):
    """``b`` texts of 77 tokens, 12-28 real ones each, and the dropout masks
    of one training forward."""
    from audio_residual_tpu_torch.models import roberta as t_roberta

    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(3, cfg.vocab_size, (b, 77), device=dev, generator=gen)
    lengths = torch.randint(12, 29, (b, 1), device=dev, generator=gen)
    ids = torch.where(torch.arange(77, device=dev) < lengths, ids, cfg.pad_token_id)
    return ids, t_roberta.sample_dropout(gen, cfg, b, 77)


def test_roberta_golden_training_runs_the_3xtf32_linear_on_card(dev):
    """A seeded RoBERTa-base's golden training forward (32 texts, dropout)
    and its backward: the 3xTF32 linear for all 73 dense products (12 layers
    of q, k and v as one product, out, fc1, fc2, and the pooler: 49 calls)
    and never ``F.linear``; each backward one dx and one dW product; in a
    profile of both, the port's GEMM kernel 3 x 49 times and PyTorch's f32
    GEMMs no more than the attention's 6 a layer (2 forward, 4 backward);
    the pooled output and every gradient within 1e-4 of the ``F.linear``
    route's (max |difference| over max |value|, a tensor)."""
    from audio_residual_tpu_torch.models import roberta as t_roberta
    from audio_residual_tpu_torch.utils.profiling import device_profile

    cfg = t_roberta.RobertaConfig()
    model = t_roberta.Roberta(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    ids, masks = _roberta_batch(dev, cfg, 32, 1)
    params = list(model.parameters())
    n_dense = 4 * cfg.num_layers + 1

    def step():
        out = t_roberta.roberta_apply(model, ids, dropout=masks)["pooler_output"]
        return out, torch.autograd.grad(out.square().sum(), params)

    with mock.patch.object(t_roberta, "linear_plain", side_effect=AssertionError("F.linear")):
        launch_counts.clear()
        out = t_roberta.roberta_apply(model, ids, dropout=masks)["pooler_output"]
        torch.cuda.synchronize()
        assert dict(launch_counts) == {"linear_tf32x3": n_dense, "split_tf32": n_dense}
        torch.autograd.grad(out.square().sum(), params)
        torch.cuda.synchronize()
        assert dict(launch_counts) == {"linear_tf32x3": n_dense, "split_tf32": 2 * n_dense,
                                       "linear_tf32x3.dx": n_dense,
                                       "linear_tf32x3.dw": n_dense}
        got, got_grads = step()
        prof = device_profile(step)
    assert prof is not None
    names = prof[4]
    assert sum(c for k, c in names.items() if "gemm_tf32x3_kernel" in k) == 3 * n_dense
    assert sum(c for k, c in names.items()
               if "gemm" in k.lower() and "gemm_tf32x3_kernel" not in k) <= 6 * cfg.num_layers
    with mock.patch.object(t_roberta, "takes", lambda x, w: False):
        ref, ref_grads = step()
    assert _rel(got, ref) <= 1e-4
    # a gradient that is 0 but for rounding (the key bias's: softmax ignores
    # a shift along the keys) is held against the largest gradient's scale
    top = max(float(r.abs().max()) for r in ref_grads)
    for p, g, r in zip(params, got_grads, ref_grads):
        scale = max(float(r.abs().max()), 1e-3 * top)
        assert float((g - r).abs().max()) <= 1e-4 * scale, tuple(p.shape)


def test_training_steps_read_the_updated_text_weights_on_card(dev):
    """Two ``make_train_step`` steps (golden, AdamW's foreach update) of
    CLAPModule's model: after each, the text features on the 3xTF32 linear
    equal the ``F.linear`` route's on the same weights within 1e-4, and
    differ from the features before the step. Then, with the text weights
    frozen (split once a weight version), an in-place foreach update moves
    the features the same way: no split outlives its weight."""
    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.models import roberta as t_roberta
    from audio_residual_tpu_torch.module import CLAPModule
    from audio_residual_tpu_torch.training import train_clap as tc
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    module = CLAPModule(device=dev, seed=0, tokenizer=HashTokenizer())
    model = module.model
    enc = _texts(4, module.cfg.text.vocab_size)
    ids, mask = (torch.as_tensor(enc[k]).to(dev) for k in ("input_ids", "attention_mask"))
    wav = torch.from_numpy((np.random.default_rng(5).standard_normal((4, 480000)) * 0.1)
                           .astype(np.float32)).to(dev)
    optimizer = tc.make_optimizer(model, lr=1e-3, warmup=1, total_steps=10)
    assert all(g.get("foreach") is not False and not g.get("fused") for g in optimizer.param_groups)
    state = tc.init_train_state(model, optimizer)
    step = tc.make_train_step(model, optimizer, compute_dtype=None)
    gen = torch.Generator().manual_seed(3)

    def features():
        with torch.no_grad():
            got = t_clap.encode_text(model, ids, mask)
            with mock.patch.object(t_roberta, "takes", lambda x, w: False):
                ref = t_clap.encode_text(model, ids, mask)
        assert _rel(got, ref) <= 1e-4
        return got

    before = features()
    for _ in range(2):
        state, _ = step(state, {"waveform": wav, "input_ids": ids, "attention_mask": mask}, gen)
        after = features()
        assert _rel(after, before) > 1e-3
        before = after
    text = [p for p in model.text_branch.parameters() if p.ndim == 2]
    for p in text:
        p.requires_grad_(False)
    features()  # the frozen weights' splits, kept for their versions
    with torch.no_grad():
        torch._foreach_add_(text, [torch.randn_like(p) * 0.01 for p in text])
    assert _rel(features(), before) > 1e-3


@pytest.mark.parametrize("tmodel", TEXT_MODELS)
def test_clap_fixture_on_card(dev, tmodel):
    """The JAX CLAP fixture through the port on the card, golden:
    atol=2e-3, rtol=1e-3 (the fixtures' limit on the card)."""
    arrays = fx.load(fx.CLAP_PATH)
    got = fx.run_port_clap(arrays, tmodel, dev)
    for key in fx.CLAP_APPLY_KEYS:
        np.testing.assert_allclose(got[key], arrays[f"out/{tmodel}/{key}"], atol=2e-3, rtol=1e-3,
                                   err_msg=key)


def test_clap_module_on_card(dev):
    """``CLAPModule`` with its defaults on the card: 50 ESC-50 prompts ->
    unit ``[50, 512]`` text embeddings; 4 ESC-50-length clips -> the main
    path's launches (K1 1, K4 10, K2 2, K3 2); an AMP module's text
    embeddings equal the golden module's (the text side stays f32) and its
    audio embeddings hold the bench guard."""
    import json
    from pathlib import Path

    from audio_residual_tpu_torch.module import CLAPModule
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    labels = Path(__file__).resolve().parents[1] / "class_labels" / \
        "ESC50_class_labels_indices_space.json"
    prompts = [f"This is a sound of {c}." for c in json.loads(labels.read_text())]
    golden = CLAPModule(device=dev, tokenizer=HashTokenizer())
    text = golden.get_text_embedding(prompts)
    assert text.shape == (50, 512) and np.isfinite(text).all()
    np.testing.assert_allclose(np.linalg.norm(text, axis=-1), 1.0, atol=1e-5)
    wav = (np.random.default_rng(16).standard_normal((4, 240000)) * 0.1).astype(np.float32)
    launch_counts.clear()
    emb = golden.get_audio_embedding_from_data(wav)
    torch.cuda.synchronize()
    assert dict(launch_counts) == {"fused_logmel": 1, "fused_swin_block": 10,
                                   "fused_window_attention": 2, "fused_residual_ffn": 2}
    amp = CLAPModule(device=dev, tokenizer=HashTokenizer(), compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(amp.get_text_embedding(prompts), text)
    emb16 = amp.get_audio_embedding_from_data(wav)
    assert (emb * emb16).sum(-1).min() > 0.999
    assert ((emb @ text.T).argmax(-1) == (emb16 @ text.T).argmax(-1)).all()


# -- PANN, mel fusion and the native decoder -----------------------------------


def _plain_route():
    """Every kernel of the audio towers on its plain version (K1 in HTSAT,
    PANN and the fusion mel; K4, K2 and K3 in HTSAT's layers)."""
    import contextlib

    from audio_residual_tpu_torch.data import featurize
    from audio_residual_tpu_torch.models import pann as t_pann

    stack = contextlib.ExitStack()
    for target, name, plain in ((t_htsat, "fused_logmel", k1.logmel_plain),
                                (t_pann, "fused_logmel", k1.logmel_plain),
                                (featurize, "fused_logmel", k1.logmel_plain),
                                (t_htsat, "fused_swin_block", k4.swin_block_plain),
                                (t_htsat, "fused_window_attention", k2.window_attention_plain),
                                (k4, "fused_window_attention", k2.window_attention_plain),
                                (k4, "fused_residual_ffn", k3.residual_ffn_plain)):
        stack.enter_context(mock.patch.object(target, name, plain))
    return stack


@pytest.mark.parametrize("n", [240000, 960000])
def test_logmel_htk_golden_matches_plain_and_float64_on_card(dev, n):
    """The fusion mel (HTK filterbank, no norm) on K1's golden route, one
    clip as featurization runs it: within 1e-4 of its plain version and at
    most 4x the plain version's error against float64."""
    from audio_residual_tpu_torch.data.featurize import DEFAULT_AUDIO_CFG, fusion_frontend_config

    cfg = fusion_frontend_config(DEFAULT_AUDIO_CFG)
    wav = torch.from_numpy(
        (np.random.default_rng(n).standard_normal((1, n)) * 0.1).astype(np.float32)).to(dev)
    launch_counts.clear()
    with torch.no_grad():
        got, plain = k1.fused_logmel(wav, cfg), k1.logmel_plain(wav, cfg)
    assert dict(launch_counts) == {"fused_logmel": 1}
    assert got.shape == (1, cfg.num_frames(n), 64) and _rel(got, plain) < 1e-4
    assert f64.error_ratio(got, plain, f64.logmel64(wav, cfg))[2] <= GOLDEN_F64_RATIO


@pytest.mark.parametrize("name", ["PANN-6", "PANN-10", "PANN-14", "PANN-14-fmax-18k",
                                  "PANN-14-fmax-8k-20s", "PANN-14-tiny-transformer",
                                  "PANN-14-win-1536"])
def test_pann_config_frontends_on_card(dev, name):
    """K1's golden route at every PANN config's frontend (hop 360 for the
    20 s config, n_fft 1536, fmax 8k / 18k) against its plain version."""
    from audio_residual_tpu_torch.models.factory import _amodel_to_config, get_model_config

    cfg = _amodel_to_config(get_model_config(name)).frontend_config
    wav = torch.from_numpy(
        (np.random.default_rng(3).standard_normal((2, 96000)) * 0.1).astype(np.float32)).to(dev)
    with torch.no_grad():
        assert _rel(k1.fused_logmel(wav, cfg), k1.logmel_plain(wav, cfg)) < 1e-4


@pytest.mark.parametrize("model_name,fusion_type", [("Cnn6", "None"), ("Cnn14", "None"),
                                                    ("Cnn6", "aff_2d"), ("Cnn10", "iaff_1d")])
def test_pann_forward_matches_the_plain_route_on_card(dev, model_name, fusion_type):
    """A PANN tower at full width, B = 2 clips of 1 s (or their fusion
    stack): the embedding against the plain route at the golden parity; K1
    once for a waveform, no kernel for a fusion input."""
    from audio_residual_tpu_torch.models import clap as t_clap

    cfg = fx.pann_port_config("", clip_samples=48000, model_name=model_name,
                              enable_fusion=fusion_type != "None", fusion_type=fusion_type)
    model = fx._seeded_model(cfg, 0, dev)
    if fusion_type == "None":
        batch = {"waveform": torch.from_numpy((np.random.default_rng(1).standard_normal(
            (2, 48000)) * 0.1).astype(np.float32)).to(dev)}
    else:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in fx.fusion_inputs(1, 64, 101).items()}
    launch_counts.clear()
    with torch.no_grad():
        got = t_clap.encode_audio(model, batch)
        assert dict(launch_counts) == ({"fused_logmel": 1} if fusion_type == "None" else {})
        with _plain_route():
            ref = t_clap.encode_audio(model, batch)
    for key in ("embedding", "normalized", "clipwise_output"):
        torch.testing.assert_close(got[key], ref[key], atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("fusion_type", ["aff_2d", "iaff_1d", "channel_map"])
def test_fusion_forward_matches_the_plain_route_on_card(dev, fusion_type):
    """HTSAT-tiny at full width with fusion, B = 2 (``longer`` both ways):
    K4 10, K2 2, K3 2 a forward; golden against the plain route at the
    golden parity, AMP at max rel err 2e-2 and cosine > 0.99999."""
    from audio_residual_tpu_torch.models import clap as t_clap

    cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(enable_fusion=True,
                                                      fusion_type=fusion_type))
    model = t_clap.build_clap_audio(cfg, seed=0, device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in fx.fusion_inputs(2, 64, 1001).items()}
    for md in (None, torch.bfloat16):
        launch_counts.clear()
        with torch.no_grad():
            got = t_clap.encode_audio(model, batch, compute_dtype=md)["normalized"]
            assert dict(launch_counts) == {"fused_swin_block": 10, "fused_window_attention": 2,
                                           "fused_residual_ffn": 2}
            with _plain_route():
                ref = t_clap.encode_audio(model, batch, compute_dtype=md)["normalized"]
        if md is None:
            torch.testing.assert_close(got, ref, atol=2e-3, rtol=1e-3)
        else:
            cos = float(((got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1))).min())
            assert _rel(got, ref) <= 2e-2 and cos > 0.99999, (_rel(got, ref), cos)


@pytest.mark.parametrize("tower,fusion_type", [("HTSAT", "None"), ("HTSAT", "aff_2d"),
                                               ("HTSAT", "iaff_1d"), ("PANN", "iaff_2d")])
def test_golden_fusion_forward_ignores_cudnn_tf32_on_card(dev, tower, fusion_type):
    """The golden forward runs every convolution in full f32, the fusion
    modules' and the HTSAT head's (``tscam_conv``) too, whatever cuDNN's
    TF32 switch says: with PyTorch's default (on) it gives the same bits as
    with it off, in the embedding and in ``clipwise_output`` and
    ``framewise_output``, which pass through the head."""
    from audio_residual_tpu_torch.models import clap as t_clap

    if tower == "HTSAT" and fusion_type == "None":
        model = t_clap.build_clap_audio(t_clap.CLAPConfig(), seed=0, device=dev)
        wav = np.random.default_rng(3).standard_normal((2, 480000)).astype(np.float32)
        inputs = {"waveform": 0.1 * wav}
    elif tower == "HTSAT":
        cfg = t_clap.CLAPConfig(audio=t_htsat.HTSATConfig(enable_fusion=True,
                                                          fusion_type=fusion_type))
        model = t_clap.build_clap_audio(cfg, seed=0, device=dev)
        inputs = fx.fusion_inputs(2, 64, 1001)
    else:
        cfg = fx.pann_port_config("", clip_samples=48000, model_name="Cnn6", enable_fusion=True,
                                  fusion_type=fusion_type)
        model = fx._seeded_model(cfg, 0, dev)
        inputs = fx.fusion_inputs(1, 64, 101)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
    prev = torch.backends.cudnn.allow_tf32
    outs = []
    try:
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.no_grad():
                outs.append(t_clap.encode_audio(model, batch))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for key in ("normalized", "clipwise_output", "framewise_output"):
        if key in outs[1]:
            assert torch.equal(outs[0][key], outs[1][key]), key
    if tower == "HTSAT":
        assert {"clipwise_output", "framewise_output"} <= set(outs[1])


@pytest.mark.parametrize("form", ["list", "rows"])
def test_fusion_module_takes_card_tensors(dev, form):
    """``CLAPModule(enable_fusion=True).get_audio_embedding_from_data(x,
    use_tensor=True)`` on clips that lie on the card (a list of any lengths,
    or the rows of one tensor): the same embedding as from the same clips in
    numpy, from the same seed."""
    from audio_residual_tpu_torch import module as t_module
    from audio_residual_tpu_torch.models import clap as t_clap
    from audio_residual_tpu_torch.models import factory as t_factory
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    cfg = fx.fusion_port_config("aff_2d")
    full = t_clap.CLAPConfig(audio=cfg.audio, text=fx.port_clap_config("roberta").text,
                             context_length=fx.CLAP_CONTEXT, **fx.CLAP_KW)
    model = t_clap.build_clap(full, seed=0, device=dev)
    audio_cfg = dict(sample_rate=48000, window_size=1024, hop_size=480, fmin=50, fmax=14000,
                     mel_bins=fx.AUDIO_KW["mel_bins"], clip_samples=fx.AUDIO_KW["clip_samples"])

    def make():
        with mock.patch.object(t_factory, "create_model",
                               lambda *a, **k: (model, full, {"audio_cfg": audio_cfg})):
            return t_module.CLAPModule(enable_fusion=True, seed=3, device=dev,
                                       tokenizer=HashTokenizer(vocab_size=1000,
                                                               context_length=16))

    rng = np.random.default_rng(5)
    lengths = (60000, 10000) if form == "list" else (30000, 30000)
    clips = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]
    x = ([torch.from_numpy(c).to(dev) for c in clips] if form == "list"
         else torch.from_numpy(np.stack(clips)).to(dev))
    with torch.no_grad():
        got = make().get_audio_embedding_from_data(x, use_tensor=True)
        want = make().get_audio_embedding_from_data(clips, use_tensor=True)
    assert got.device.type == "cuda" and got.shape == (2, full.joint_embed_shape)
    assert torch.equal(got, want)


def test_pann_and_fusion_fixtures_on_card(dev):
    """The JAX PANN and fusion fixtures through the port on the card, golden
    (atol 2e-3, rtol 1e-3)."""
    arrays = fx.load(fx.PANN_PATH)
    for name, outs in fx.run_port_pann(arrays, dev).items():
        for key, got in outs.items():
            np.testing.assert_allclose(got, arrays[f"out/{name}/{key}"], atol=2e-3, rtol=1e-3,
                                       err_msg=f"{name} {key}")
    arrays = fx.load(fx.FUSION_PATH)
    for ft, outs in fx.run_port_fusion(arrays, dev).items():
        for key, got in outs.items():
            np.testing.assert_allclose(got, arrays[f"out/{ft}/{key}"], atol=2e-3, rtol=1e-3,
                                       err_msg=f"{ft} {key}")


@pytest.mark.parametrize("bits,channels", [(16, 1), (16, 2), (32, 2), (16, 6)])
def test_wavio_matches_numpy_on_card_machine(dev, bits, channels):
    """``native/wavio.c`` builds on the card's machine and decodes bit for
    bit what its numpy version gives."""
    from audio_residual_tpu_torch import native

    dtype = np.int16 if bits == 16 else np.int32
    info = np.iinfo(dtype)
    raw = np.random.default_rng(bits).integers(info.min, info.max, 48000 * channels,
                                               endpoint=True).astype(dtype).tobytes()
    c, plain = ((native.pcm16_to_float32_mono, native.pcm16_to_float32_mono_plain) if bits == 16
                else (native.pcm32_to_float32_mono, native.pcm32_to_float32_mono_plain))
    np.testing.assert_array_equal(c(raw, channels), plain(raw, channels))


def test_mel_spectrogram_runs_k1_on_card(dev):
    """``AudioProcessing.mel_spectrogram`` on the card: one K1 launch, then
    the ``top_db`` floor below the whole batch's max, within 1e-4 (max rel)
    of K1's plain version with the same floor."""
    from audio_residual_tpu_torch.data.processing import AudioProcessing

    rng = np.random.default_rng(11)
    wav = torch.from_numpy((rng.standard_normal((3, 44100)) * np.array([[1.0], [1e-3],
                                                                        [1e-5]])
                            ).astype(np.float32)).to(dev)
    launch_counts.clear()
    got = AudioProcessing.mel_spectrogram(wav, device=dev)
    assert dict(launch_counts) == {"fused_logmel": 1} and got.device.type == "cuda"
    plain = k1.logmel_plain(wav, AudioProcessing.frontend_config(), "f32")
    plain = torch.maximum(plain, plain.max() - 80.0)
    assert _rel(got, plain) < 1e-4
    assert float(got[2].min()) == pytest.approx(float(got.max()) - 80.0)


def test_vision_fixture_on_card_matches_cpu_and_jax(dev):
    """The vision fixture's narrow CLIPs (ModifiedResNet, quick-GELU ViT) on
    the card: within 1e-5 (max rel) of the same models on the CPU, and
    within the golden parity of the JAX outputs stored in the fixture."""
    arrays = fx.load(fx.VISION_PATH)
    card, cpu = fx.run_port_vision(arrays, dev), fx.run_port_vision(arrays, "cpu")
    for name, outs in card.items():
        for key, got in outs.items():
            ref = cpu[name][key]
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), (name, key)
            np.testing.assert_allclose(got, arrays[f"out/{name}/{key}"], atol=2e-3, rtol=1e-3)


def test_shard_batch_featurizes_fusion_on_card(dev, tmp_path):
    """``ShardedAudioText(data_truncating="fusion")`` with ``device`` the
    card: ``mel_fusion`` on the card, one K1 launch a clip, within 1e-4 of
    the same pipe on the CPU; waveforms, ``longer`` and tokens equal."""
    import io
    import tarfile
    import wave

    from audio_residual_tpu_torch.data.shards import ShardedAudioText
    from audio_residual_tpu_torch.utils.tokenizer import HashTokenizer

    rng = np.random.default_rng(12)
    path = str(tmp_path / "000000.tar")
    with tarfile.open(path, "w") as tf:
        for i, n in enumerate((700000, 300000, 480000, 900000)):
            buf = io.BytesIO()
            with wave.open(buf, "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(48000)
                w.writeframes((rng.uniform(-0.3, 0.3, n) * 32767).astype(np.int16).tobytes())
            for name, data in ((f"c{i}.wav", buf.getvalue()),
                               (f"c{i}.json", json_bytes({"text": f"clip {i}"}))):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    audio_cfg = dict(sample_rate=48000, window_size=1024, hop_size=480, mel_bins=64, fmin=50,
                     fmax=14000)

    def batches(device):
        pipe = ShardedAudioText(tar_paths=[path], tokenize=HashTokenizer(), batch_size=4,
                                data_truncating="fusion", data_filling="repeatpad",
                                audio_cfg=audio_cfg, device=device, seed=2)
        return list(pipe.epoch(0))

    launch_counts.clear()
    (got,) = batches(dev)
    assert dict(launch_counts) == {"fused_logmel": 4}
    (ref,) = batches("cpu")
    assert got["mel_fusion"].device.type == "cuda" and got["mel_fusion"].shape == (4, 4, 1001, 64)
    assert _rel(got["mel_fusion"].cpu(), ref["mel_fusion"]) < 1e-4
    assert list(got["longer"]) == [True, False, False, True]
    for k in ("waveform", "longer", "input_ids"):
        np.testing.assert_array_equal(got[k], ref[k])


def json_bytes(obj) -> bytes:
    import json

    return json.dumps(obj).encode()
