"""K4's AMP storage plan (``ops/cuda/csrc/blocks.cuh``) in plain PyTorch.

Under AMP the block kernel stores in bf16 every intermediate whose only
reader is a GEMM or the attention core: y = LN1(x), qkv with q pre-scaled by
hd^-1/2 in the qkv epilogue, the attention output, z = LN2(h) and the fc1 +
GELU output. ``_amp_plan`` below rounds each of them to bf16 where the kernel
stores it, and keeps f32 what the kernel keeps f32 (the proj output, the
ResiDual, h1, y2, LN statistics, softmax).

Bit for bit equal to ``swin_block_plain(..., mxu_dtype=bfloat16)`` (the
function the card's kernel is checked against): each stored bf16 value is
the rounding that the plain version applies to the same f32 value before
its next product, so the storage change leaves the function unchanged.

Against the JAX package's AMP twin (``swin_block.py::_xla_twin(...,
mxu_dtype=jnp.bfloat16)``, which rounds at the same places) within
``atol=5e-3, rtol=0`` on each element and 5e-5 on the mean absolute gap:
XLA and PyTorch sum each product's K terms in other orders, so a few stored
bf16 intermediates round the other way (one bf16 ulp, 2^-8 of the value),
and the flips carry through the block's chain of products. At these inputs
the largest gap is 3.0e-3 on outputs up to 5, the mean gap at most 4.1e-6.
The same block computed in f32 (no bf16 rounding) is 7.6e-4 to 1.3e-3 off
the twin on the mean, so the mean limit tells the AMP plan from an f32 one;
``test_f32_block_fails_the_amp_limit`` keeps that so. The Pallas AMP
kernel's head-group packing is a TPU-only deviation, so the twin is the
reference here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_residual_tpu.ops.pallas import swin_block as j_k4
from audio_residual_tpu_torch.ops.common import layer_norm
from audio_residual_tpu_torch.ops.cuda import swin_block as t_k4
from audio_residual_tpu_torch.ops.cuda.window_attention import bias_and_mask, q_scale
from audio_residual_tpu_torch.residual.module import residual_apply

from .torch_threads import one_cpu_thread  # noqa: F401

BF16 = torch.bfloat16
C, NH, WINDOW, NW, RES = 96, 4, 8, 4, (16, 16)  # HTSAT-tiny layer 0 width, 2x2 windows of 64


def _amp_plan(x, flat, nh, window, nw, shift, resolution, use_res, dffn):
    (n1s, n1b, wqkv, bqkv, wproj, bproj, n2s, n2b, wfc1, bfc1, wfc2, bfc2,
     table, *res) = flat
    wn, n, c = x.shape
    hd = c // nh
    bias, mask = bias_and_mask(table, window, shift, resolution)

    def gemm(a, w):  # the bf16 GEMM: f32 product of bf16 operands
        return a.float() @ w.to(BF16).float().t()

    y = layer_norm(x.float(), n1s, n1b).to(BF16)                    # stored bf16
    qkv = ((gemm(y.reshape(-1, c), wqkv) + bqkv) * q_scale(c, nh, x.device)).to(BF16)
    qkv = qkv.float().reshape(wn, n, 3, nh, hd)
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # q already scaled
    s = q @ k.transpose(-1, -2) + bias[None]
    if mask is not None:
        s = (s.reshape(wn // nw, nw, nh, n, n) + mask[None, :, None]).reshape(wn, nh, n, n)
    p = torch.softmax(s, dim=-1).to(BF16).float()
    att = (p @ v).permute(0, 2, 1, 3).reshape(-1, c).to(BF16)      # stored bf16
    a = gemm(att, wproj) + bproj                                     # f32
    if use_res:
        a = residual_apply(a, *res)
    xf = x.reshape(-1, c).float()
    h1 = xf + a

    def ffn(t):
        z = layer_norm(t, n2s, n2b).to(BF16)                         # stored bf16
        hid = F.gelu(gemm(z, wfc1) + bfc1).to(BF16)                  # stored bf16
        return gemm(hid, wfc2) + bfc2

    out = h1 + ffn(h1)
    if use_res and dffn:
        y2 = xf + out
        out = y2 + ffn(y2)
    return out.reshape(wn, n, c).to(x.dtype)


def _params(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    h = 4 * C
    p = {"n1s": 1 + f(C, sc=0.1), "n1b": f(C, sc=0.1), "wqkv": f(C, 3 * C, sc=0.05),
         "bqkv": f(3 * C, sc=0.02), "wproj": f(C, C, sc=0.05), "bproj": f(C, sc=0.02),
         "n2s": 1 + f(C, sc=0.1), "n2b": f(C, sc=0.1), "wfc1": f(C, h, sc=0.05),
         "bfc1": f(h, sc=0.02), "wfc2": f(h, C, sc=0.05), "bfc2": f(C, sc=0.02),
         "table": f(225, NH, sc=0.02)}
    q, _ = np.linalg.qr(rng.standard_normal((C, C)))
    r = {"basis": q.astype(np.float32), "mean": f(C, sc=0.01), "lam": 1 + f(C, sc=0.1)}
    x = f(2 * NW, 64, C, sc=0.5)
    return p, r, x


def _port_flat(p, r, use_res):
    order = ("n1s", "n1b", "wqkv", "bqkv", "wproj", "bproj", "n2s", "n2b", "wfc1", "bfc1",
             "wfc2", "bfc2", "table")
    flat = tuple(torch.from_numpy(np.ascontiguousarray(p[k].T if k.startswith("w") else p[k]))
                 for k in order)
    return flat + ((tuple(torch.from_numpy(r[k]) for k in ("basis", "mean", "lam")))
                   if use_res else ())


MODES = [(False, False), (True, False), (True, True)]  # ResiDual off / on / on + double FFN


@pytest.mark.parametrize("x_dtype", [torch.float32, BF16])  # layer 0 carries bf16, 1-2 f32
@pytest.mark.parametrize("use_res,dffn", MODES)
@pytest.mark.parametrize("shift", [0, 4])
def test_amp_plan_equals_plain_bit_for_bit(shift, use_res, dffn, x_dtype):
    p, r, x = _params(0)
    args = (torch.from_numpy(x).to(x_dtype), _port_flat(p, r, use_res), NH, WINDOW, NW, shift,
            RES, use_res, dffn)
    plan = _amp_plan(*args)
    plain = t_k4.swin_block_plain(*args, mxu_dtype=BF16)
    assert plan.dtype == plain.dtype == x_dtype
    assert torch.equal(plan, plain)



@pytest.mark.parametrize("use_res,dffn", MODES)
def test_split_block_keeps_attention_output_f32(use_res, dffn):
    """The LN1 -> window attention -> K3 plan (layer 3, and every C from
    ``WIDE_MIN_C``) on an f32 block input under AMP (PatchMerging's output):
    the attention output reaches the ResiDual epilogue in f32, so the plan
    equals the plain block bit for bit."""
    p, r, x = _params(2)
    args = (torch.from_numpy(x), _port_flat(p, r, use_res), NH, WINDOW, NW, 0, RES, use_res,
            dffn)
    got, _ = t_k4.split_block(*args, mxu_dtype=BF16)
    assert got.dtype == torch.float32
    assert torch.equal(got, t_k4.swin_block_plain(*args, mxu_dtype=BF16))

ATOL, MEAN_TOL = 5e-3, 5e-5  # see the module docstring


def _jax_amp_twin(p, r, x, shift, use_res, dffn):
    blk = {"norm1": {"scale": p["n1s"], "bias": p["n1b"]},
           "attn": {"qkv": {"kernel": p["wqkv"], "bias": p["bqkv"]},
                    "proj": {"kernel": p["wproj"], "bias": p["bproj"]},
                    "rel_bias_table": p["table"]},
           "norm2": {"scale": p["n2s"], "bias": p["n2b"]},
           "mlp": {"fc1": {"kernel": p["wfc1"], "bias": p["bfc1"]},
                   "fc2": {"kernel": p["wfc2"], "bias": p["bfc2"]}}}
    blk = {k: {kk: (jnp.asarray(vv) if not isinstance(vv, dict)
                    else {kkk: jnp.asarray(vvv) for kkk, vvv in vv.items()})
               for kk, vv in v.items()} for k, v in blk.items()}
    rparams = {k: jnp.asarray(v) for k, v in r.items()} if use_res else None
    return np.array(j_k4._xla_twin(jnp.asarray(x), blk, rparams, nh=NH, window=WINDOW, nw=NW,
                                   shift=shift, resolution=RES, double_ffn=dffn,
                                   mxu_dtype=jnp.bfloat16))


@pytest.mark.parametrize("use_res,dffn", MODES)
@pytest.mark.parametrize("shift", [0, 4])
def test_amp_plan_matches_jax_amp_twin(shift, use_res, dffn):
    p, r, x = _params(1)
    ref = _jax_amp_twin(p, r, x, shift, use_res, dffn)
    got = _amp_plan(torch.from_numpy(x), _port_flat(p, r, use_res), NH, WINDOW, NW, shift, RES,
                    use_res, dffn).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.abs(got - ref).mean() < MEAN_TOL


@pytest.mark.parametrize("use_res,dffn", MODES)
def test_f32_block_fails_the_amp_limit(use_res, dffn):
    """Control: the block without bf16 rounding misses the mean limit by
    more than 10x, so the comparison above does tell AMP from f32."""
    p, r, x = _params(1)
    ref = _jax_amp_twin(p, r, x, 4, use_res, dffn)
    f32 = t_k4.swin_block_plain(torch.from_numpy(x), _port_flat(p, r, use_res), NH, WINDOW, NW,
                                4, RES, use_res, dffn).numpy()
    assert np.abs(f32 - ref).mean() > 10 * MEAN_TOL
