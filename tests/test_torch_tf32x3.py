"""The 3xTF32 products of the golden routes on the CPU: the split of an f32
value into TF32 ``hi`` and ``lo``, the launch plans, and a replay of each
kernel's arithmetic -- K1's DFT (``csrc/logmel.cu::logmel_tf32x3_kernel``)
and K3's products (``csrc/gemm_sm90.cuh::gemm_tf32x3``) -- held against the
plain versions and the JAX kernels in Pallas interpret mode (K2, K4 and K5:
``tests/test_torch_golden_gemms.py``).

The replay computes what the tensor core is handed: ``hi`` and ``lo`` of
each activation rounded to TF32 in the kernel (``cvt.rna``, low 13 bits
cleared), the weights' ``lo`` as stored, read as TF32 (the tensor core
reads the top 19 bits of an operand: the low 13 masked off), three products
summed in f32. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import functools
import json
import math
import unittest.mock as mock
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import example, given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from audio_residual_tpu.ops import frontend as j_fe
from audio_residual_tpu.ops.pallas import frontend as j_k1
from audio_residual_tpu.ops.pallas import ln_mlp as j_k3
from audio_residual_tpu_torch.models import factory
from audio_residual_tpu_torch.ops import frontend as t_fe
from audio_residual_tpu_torch.ops.cuda import frontend as k1
from audio_residual_tpu_torch.ops.cuda import gemm as kg
from audio_residual_tpu_torch.ops.cuda import ln_mlp as k3
from audio_residual_tpu_torch.ops.cuda import tf32x3

from .torch_tf32x3_replay import ffn_replay, layer_gemms, tf32x3_matmul

INTERPRET = functools.partial(pl.pallas_call, interpret=True)
CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs" / "model_configs"
SMEM_LIMIT = 232448
FLT_MIN = 2.0 ** -126


# ---- the split ---------------------------------------------------------------
def _f32(bits: int) -> float:
    return float(np.array([bits], dtype=np.uint32).view(np.float32)[0])


def _split_one(x: float) -> tuple[np.float32, np.float32]:
    hi, lo = tf32x3.split_tf32(torch.tensor([x], dtype=torch.float32))
    return np.float32(hi.item()), np.float32(lo.item())


def _bits(v: np.float32) -> int:
    return int(np.array([v], dtype=np.float32).view(np.uint32)[0])


def _nearest_tf32(x: float) -> float:
    """x rounded to TF32 in float64 arithmetic: the grid of 2^-10 of the
    binade (2^-136 below the normal range), to nearest, ties away from 0."""
    a = abs(x)
    step = 2.0 ** (max(math.frexp(a)[1] - 1, -126) - 10) if a else 2.0 ** -136
    down = math.floor(a / step) * step
    r = a - down
    mag = down + step if r > step / 2 or r == step / 2 else down
    return math.copysign(mag, x)


def _ties(bits: int) -> int:
    """The f32 halfway between two TF32 neighbours: low 13 bits 0x1000."""
    return (bits & ~0x1FFF) | 0x1000


FINITE_BITS = st.integers(0, 2 ** 32 - 1).filter(lambda b: b & 0x7F800000 != 0x7F800000)


@settings(max_examples=400, deadline=None)
@given(st.one_of(FINITE_BITS, FINITE_BITS.map(_ties)))
@example(0x00000000)  # +0
@example(0x80000000)  # -0
@example(0x00000001)  # the smallest subnormal
@example(0x00001000)  # a subnormal tie: rounds away, to 2^-136
@example(0x807FFFFF)  # the largest subnormal, negative
@example(0x3F801000)  # 1 + 2^-11: a tie, rounds up
@example(0xBF803000)  # -(1 + 3 * 2^-11): a tie, rounds away from zero
@example(0x7F7FEFFF)  # just below the first value that rounds to infinity
def test_split_of_a_finite_value(bits):
    """hi's low 13 bits are zero, hi + lo == x exactly, hi is x rounded to
    nearest TF32 with ties away from zero, and |lo| <= 2^-11 |x| -- for a
    subnormal x, half the TF32 subnormal step, 2^-11 * 2^-126."""
    x = _f32(bits)
    if abs(x) >= _f32(0x7F7FF000):
        return  # rounds to infinity
    hi, lo = _split_one(x)
    assert _bits(hi) & 0x1FFF == 0
    assert float(hi) + float(lo) == x and np.float32(hi + lo) == np.float32(x)
    assert float(hi) == _nearest_tf32(x)
    assert abs(float(lo)) <= 2.0 ** -11 * max(abs(x), FLT_MIN)
    if (bits & 0x1FFF) == 0x1000:  # a tie goes away from zero
        assert abs(float(hi)) > abs(x)


@pytest.mark.parametrize("x", [float("inf"), float("-inf"), float("nan")])
def test_split_keeps_infinities_and_nan(x):
    hi, lo = _split_one(x)
    assert (np.isnan(hi) if np.isnan(x) else hi == x) and lo == 0


def test_split_of_a_tensor_keeps_shape_and_is_elementwise(rng):
    x = torch.from_numpy((rng.standard_normal((3, 70)) * 10.0 ** rng.integers(-30, 30, (3, 70)))
                         .astype(np.float32))
    hi, lo = tf32x3.split_tf32(x)
    assert hi.shape == lo.shape == x.shape and hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    one_hi, one_lo = tf32x3.split_tf32(x[1, 5:6])
    assert torch.equal(one_hi, hi[1, 5:6]) and torch.equal(one_lo, lo[1, 5:6])
    with pytest.raises(TypeError, match="float32"):
        tf32x3.split_tf32(x.double())


# ---- the replay of the kernels' arithmetic (tests/torch_tf32x3_replay.py) -----
def _ffn_inputs(seed, rows, c, hidden):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32))

    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    rp = {"basis": torch.from_numpy(q.astype(np.float32)), "mean": t(c, scale=0.01),
          "lam": t(c, scale=0.1, offset=1.0)}
    weights = (t(c, scale=0.1, offset=1.0), t(c, scale=0.1), t(hidden, c, scale=c ** -0.5),
               t(hidden, scale=0.02), t(c, hidden, scale=hidden ** -0.5), t(c, scale=0.02))
    return t(rows, c, scale=0.5), t(rows, c, scale=0.1), weights, rp


FFN_VARIANTS = {"plain": (False, False), "residual": (True, False), "double-ffn": (True, True)}


@pytest.mark.parametrize("variant", list(FFN_VARIANTS))
def test_ffn_replay_matches_plain_and_jax_kernel(variant):
    """K3 golden at HTSAT-tiny layer 3's widths (C=768, hidden=3072) on 48
    rows: the replay within 1e-4 of the largest output of the plain f32
    version (the card's golden tolerance: each 3xTF32 product is off by
    near 2^-21 of it, the sums stay f32), and within the fixtures' bounds
    (atol=2e-3, rtol=1e-3) of the JAX kernel in interpret mode, as the
    plain version is."""
    use_res, dffn = FFN_VARIANTS[variant]
    x, a, weights, rp = _ffn_inputs(4, 48, 768, 3072)
    rp = rp if use_res else None
    got = ffn_replay(x, a, *weights, rp, dffn)
    plain = k3.residual_ffn_plain(x, a, *weights, rp, double_ffn=dffn)
    scale = float(plain.abs().max())
    assert float((got - plain).abs().max()) < 1e-4 * scale
    n2s, n2b, w1, b1, w2, b2 = weights
    jr = {k: jnp.asarray(v.numpy()) for k, v in rp.items()} if use_res else None
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k3.fused_residual_ffn(
            jnp.asarray(x.numpy()), jnp.asarray(a.numpy()), n2s.numpy(), n2b.numpy(),
            w1.t().numpy(), b1.numpy(), w2.t().numpy(), b2.numpy(), jr, double_ffn=dffn))
    for out in (got, plain):
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=1e-3)


def test_gemm_wrapper_on_the_cpu_is_its_plain_version(rng):
    a = torch.from_numpy(rng.standard_normal((10, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    b, r2 = torch.ones(16), torch.ones(10, 16).bfloat16()
    got = kg.gemm_tf32x3(a, w, bias=b, gelu=True, r2=r2)
    assert torch.equal(got, F.gelu(a @ w.t() + b) + r2.float())
    hi, lo = tf32x3.split_tf32(w)
    assert float((tf32x3_matmul(a, hi, lo) - a @ w.t()).abs().max()) < 1e-5


def _logmel_replay(wav, cfg):
    """K1 golden: frames of the f32 padded signal, the DFT against the
    interleaved basis in 3xTF32, power from column pairs, the mel fold by
    chunks of 64 bins into an f32 sum."""
    x = k1.f32_signal(wav, cfg)
    nf = cfg.num_frames(wav.shape[1])
    frames = x.unfold(-1, cfg.n_fft, cfg.hop_length)[:, :nf]
    hi, lo, mw = k1.tf32x3_constants(cfg, torch.device("cpu"))
    d = tf32x3_matmul(frames.reshape(-1, cfg.n_fft), hi, lo).reshape(*frames.shape[:2], -1)
    power = d[..., 0::2] ** 2 + d[..., 1::2] ** 2
    mel = torch.zeros(*power.shape[:2], mw.shape[1])
    for n0 in range(0, power.shape[-1], 64):
        mel = mel + power[..., n0 : n0 + 64] @ mw[n0 : n0 + 64]
    db = 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin)) - k1._db_offset(cfg)
    return db[..., : cfg.n_mels]


@pytest.mark.parametrize("n_fft", [1024, 1536])
def test_logmel_replay_matches_plain_and_jax_kernel(rng, n_fft):
    """K1 golden: the replay within 1e-4 of the largest |dB| of the plain f32
    version (the card's golden tolerance) and within the JAX suite's 2e-3
    dB of the JAX kernel (f32 DFT, interpret mode)."""
    cfg = t_fe.FrontendConfig(n_fft=n_fft, win_length=n_fft)
    wav = (rng.standard_normal((2, 24001)) * 0.1).astype(np.float32)
    got = _logmel_replay(torch.from_numpy(wav), cfg)
    plain = k1.logmel_plain(torch.from_numpy(wav), cfg)
    assert got.shape == plain.shape == (2, cfg.num_frames(24001), cfg.n_mels)
    assert float((got - plain).abs().max()) < 1e-4 * float(plain.abs().max())
    jcfg = j_fe.FrontendConfig(n_fft=n_fft, win_length=n_fft)
    with mock.patch.object(pl, "pallas_call", INTERPRET):
        ref = np.asarray(j_k1.fused_logmel(jnp.asarray(wav), jcfg, dft_mode="f32"))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3)


def test_golden_basis_is_the_split_f32_basis():
    """hi + lo is the f32 basis of the AMP layout, hi on the TF32 grid; the
    signal is the f32 reflect pad, zero-padded to 4 samples a row."""
    cfg = t_fe.FrontendConfig()
    hi, lo, mw = k1.tf32x3_constants(cfg, torch.device("cpu"))
    bt, mw_ref = k1._tc_layout(cfg)
    assert torch.equal(hi + lo, torch.from_numpy(bt)) and torch.equal(mw, torch.from_numpy(mw_ref))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    wav = torch.ones(1, 24001)
    xp = k1.f32_signal(wav, cfg)
    assert xp.shape[1] % 4 == 0 and xp.shape[1] - (24001 + cfg.n_fft) == 3
    assert torch.equal(xp[:, : 24001 + cfg.n_fft], t_fe.reflect_pad(wav, cfg.n_fft // 2))
    assert not xp[:, 24001 + cfg.n_fft :].any()


# ---- the plans ---------------------------------------------------------------
def _ffn_shapes(name: str) -> set:
    """``(C, hidden, tokens a clip)`` of every Swin layer of a registered
    HTSAT config: each runs its FFN through run_ffn (K4) or K3."""
    return {(k, n, tokens) for what, n, k, tokens in layer_gemms(name) if what == "fc1"}


HTSAT = [n for n in factory.list_models() if n.startswith("HTSAT")]


@pytest.mark.parametrize("name", HTSAT)
def test_every_shipped_ffn_shape_has_a_plan(name):
    """fc1 [R, C] -> [R, 4C] and fc2 [R, 4C] -> [R, C] at B = 1, 3 and 32:
    an N tile of the build, a ring of at least 3 stages in shared memory,
    every SM busy where there are tiles for it."""
    shapes = _ffn_shapes(name)
    assert shapes
    for c, hidden, tokens in shapes:
        for b in (1, 3, 32):
            rows = b * tokens
            for n, k in ((hidden, c), (c, hidden)):
                plan = tf32x3.gemm_plan(rows, n, k)
                assert plan.bn in tf32x3.GEMM_BNS and plan.stages >= 3
                assert plan.smem_bytes <= SMEM_LIMIT
                assert plan.tiles == -(-rows // 128) * -(-n // plan.bn)
                assert plan.grid == min(plan.tiles, 132)


@pytest.mark.parametrize("c", [32, 40, 64, 96])
def test_the_test_widths_have_a_plan(c):
    for n, k in ((4 * c, c), (c, 4 * c)):
        plan = tf32x3.gemm_plan(200, n, k)
        assert plan.bn in tf32x3.GEMM_BNS and plan.stages >= 3


def test_plan_picks_the_tile_that_fills_the_card():
    """HTSAT-tiny layer 3 at B=32: fc1 (N = 3072) ties at every tile and
    takes 128; fc2 (N = 768) takes 96, 128 tiles in one wave, where 128
    would leave 36 SMs idle and 64 would take two waves."""
    assert tf32x3.gemm_plan(2048, 3072, 768).bn == 128
    assert tf32x3.gemm_plan(2048, 768, 3072).bn == 96
    assert tf32x3.gemm_plan(2048, 40, 64).bn == 32  # masked edge: 40 = 32 + 8


@pytest.mark.parametrize("bn,stages", [(128, 3), (96, 4), (64, 5), (32, 8)])
def test_ring_depth_mirrors_the_build(bn, stages):
    """``Tiles<BN, 2>`` of csrc/gemm_sm90.cuh: a stage is A [128, 32] and
    W's hi and lo [BN, 32] f32; the epilogue's staging [2, 64, BN + 8] f32;
    at most 8 stages."""
    got, smem = tf32x3._ring(bn)
    stage = 128 * 128 + 2 * bn * 128
    assert got == stages
    assert smem == 1024 + stages * stage + 2 * 64 * (bn + 8) * 4 + 16 * stages <= SMEM_LIMIT


@pytest.mark.parametrize("m,n,k,match", [(0, 64, 64, "empty shape"), (128, 100, 64, "N=100"),
                                         (128, 64, 30, "K=30"), (128, 64, -4, "empty")])
def test_plan_refuses_other_shapes(m, n, k, match):
    with pytest.raises(ValueError, match=match):
        tf32x3.gemm_plan(m, n, k)


def _audio_frontends() -> dict:
    out = {}
    for path in sorted(CONFIG_DIR.glob("*.json")):
        a = json.loads(path.read_text()).get("audio_cfg")
        if a and a.get("model_type") in ("HTSAT", "PANN"):
            out[path.stem] = t_fe.FrontendConfig(
                sample_rate=a["sample_rate"], n_fft=a["window_size"], hop_length=a["hop_size"],
                win_length=a["window_size"], n_mels=a["mel_bins"], fmin=a["fmin"],
                fmax=a["fmax"])
    return out


FRONTENDS = _audio_frontends()


def test_there_are_eleven_shipped_audio_configs():
    assert len(FRONTENDS) == 11


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_every_shipped_audio_config_takes_the_golden_kernel(name):
    k1.check_tc_config(FRONTENDS[name], "f32")


@pytest.mark.parametrize("change,match", [
    (dict(hop_length=478), "hop_length=478 must be a multiple of 4"),
    (dict(n_fft=1000, win_length=1000), "n_fft=1000 a multiple of 32"),
    (dict(n_fft=2048, win_length=2048), "at most 1536"),
    (dict(n_mels=80), "n_mels=80 at most 64"),
])
def test_a_config_the_golden_kernel_does_not_take_raises(change, match):
    with pytest.raises(ValueError, match=f"fused_logmel f32: .*{match}"):
        k1.check_tc_config(t_fe.FrontendConfig(**change), "f32")
