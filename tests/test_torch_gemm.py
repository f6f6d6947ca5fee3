"""The bf16 GEMM's plain version (``ops/cuda/gemm.py::gemm_plain``), which
the card's TMA + wgmma GEMM is held against in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Here, on the CPU, it is held against the port's own AMP product
(``ops/common.py::linear`` with ``mxu_dtype=bfloat16``) followed by the
epilogue, bit for bit: both are one f32 matmul of the same bf16-rounded
operands. And it is held against the JAX block kernel's product
(``jnp.dot`` of bf16 operands, ``preferred_element_type=f32``,
``audio_residual_tpu/ops/pallas/swin_block.py:105-108``) followed by the
same epilogue, within ``atol=1e-5, rtol=1e-5``: the two frameworks sum the
K products in other orders, a few f32 ulps of the sums here.
"""

import gc
import itertools
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audio_residual_tpu_torch.ops.common import linear
from audio_residual_tpu_torch.ops.cuda import gemm as g
from audio_residual_tpu_torch.ops.cuda import launch_counts
from audio_residual_tpu_torch.ops.cuda.window_attention import mxu_weights

M, N, K = 77, 288, 96  # ragged M (no tile divides it), N = HTSAT-tiny's 3C


def _operands(seed, m=M, n=N, k=K):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return {"a": f(m, k), "w": f(n, k, sc=0.1), "bias": f(n, sc=0.1),
            "col_scale": 1 + f(n, sc=0.2), "r1": f(m, n), "r2": f(m, n)}


# residual types as on the double-FFN fc2: r1 = h1 (f32), r2 = x (bf16 under AMP)
R_DTYPES = {"r1": torch.float32, "r2": torch.bfloat16}


def _epilogue(v, ops, flags):
    """The epilogue in the kernel's order, in f32."""
    bias, scale, gelu, r1, r2 = flags
    if bias:
        v = v + torch.from_numpy(ops["bias"])
    if scale:
        v = v * torch.from_numpy(ops["col_scale"])
    if gelu:
        v = F.gelu(v)
    for on, key in ((r1, "r1"), (r2, "r2")):
        if on:
            v = v + torch.from_numpy(ops[key]).to(R_DTYPES[key]).float()
    return v


def _gemm_args(ops, flags):
    bias, scale, gelu, r1, r2 = flags
    t = torch.from_numpy
    return dict(bias=t(ops["bias"]) if bias else None,
                col_scale=t(ops["col_scale"]) if scale else None, gelu=gelu,
                r1=t(ops["r1"]).to(R_DTYPES["r1"]) if r1 else None,
                r2=t(ops["r2"]).to(R_DTYPES["r2"]) if r2 else None)


FLAGS = list(itertools.product([False, True], repeat=5))  # bias, col_scale, gelu, r1, r2


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join("bsgRr"[i] if on else "-"
                                                                for i, on in enumerate(f)))
def test_gemm_plain_is_linear_then_epilogue(flags, out_dtype):
    """Every epilogue combination, both output types: bit for bit equal to
    the port's AMP ``linear`` followed by the epilogue (same matmul of the
    same bf16-rounded operands)."""
    ops = _operands(1)
    a, w = torch.from_numpy(ops["a"]), torch.from_numpy(ops["w"])
    got = g.gemm(a.bfloat16(), w.bfloat16(), **_gemm_args(ops, flags), out_dtype=out_dtype)
    ref = _epilogue(linear(a, w, None, torch.bfloat16), ops, flags).to(out_dtype)
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("m,n,k", [(M, N, K), (130, 96, 384), (64, 384, 96)])
@pytest.mark.parametrize("flags", [(True, True, False, False, False),   # qkv: bias, q scale
                                   (True, False, True, False, False),   # fc1: bias, GELU
                                   (True, False, False, True, True)])   # fc2: bias, h1, x
def test_gemm_plain_matches_jax_bf16_dot(m, n, k, flags):
    """Against the JAX block kernel's AMP product: ``jnp.dot`` of the bf16
    operands with f32 accumulation, then the same epilogue. Tolerance: f32
    summation order only (the operands are the same bf16 values)."""
    ops = _operands(2, m, n, k)
    jdot = jnp.dot(jnp.asarray(ops["a"]).astype(jnp.bfloat16),
                   jnp.asarray(ops["w"].T).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    ref = _epilogue(torch.from_numpy(np.array(jdot)), ops, flags)
    a, w = torch.from_numpy(ops["a"]), torch.from_numpy(ops["w"])
    got = g.gemm(a.bfloat16(), w.bfloat16(), **_gemm_args(ops, flags))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_gemm_on_cpu_counts_no_launch():
    launch_counts.clear()
    ops = _operands(3)
    g.gemm(torch.from_numpy(ops["a"]).bfloat16(), torch.from_numpy(ops["w"]).bfloat16())
    assert sum(launch_counts.values()) == 0


def test_mxu_weights_cast_once_per_weight_version():
    """The GEMMs' bf16 weights: one copy per weight version, a new one after
    an in-place update, none kept once the weight is gone."""
    w = torch.from_numpy(_operands(4)["w"])
    assert mxu_weights(None, w)[0] is w
    first = mxu_weights(torch.bfloat16, w)[0]
    assert first.dtype == torch.bfloat16 and torch.equal(first, w.bfloat16())
    assert mxu_weights(torch.bfloat16, w)[0] is first
    w.mul_(2)
    second = mxu_weights(torch.bfloat16, w)[0]
    assert second is not first and torch.equal(second, w.bfloat16())
    ref = weakref.ref(second)
    del w, first, second
    gc.collect()
    assert ref() is None


def test_mxu_weights_follow_a_data_swap():
    """A ``p.data = new`` swap keeps the parameter's version counter but not
    its storage: the next call casts the new values."""
    ops = _operands(5)
    p = torch.nn.Parameter(torch.from_numpy(ops["w"]), requires_grad=False)
    first = mxu_weights(torch.bfloat16, p)[0]
    p.data = torch.from_numpy(ops["w"] * 3)
    second = mxu_weights(torch.bfloat16, p)[0]
    assert second is not first and torch.equal(second, p.detach().bfloat16())
